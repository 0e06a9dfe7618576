from tpuflows_torch.flows.core import (
    Bijector,
    Chain,
    Identity,
    Inverted,
    ScannedRepeat,
    inverse,
    with_logabsdet_jacobian,
)
from tpuflows_torch.flows.affine import AffineCoupling, Standardize, Whiten
from tpuflows_torch.flows.build import build_flow
from tpuflows_torch.flows.coupling import RQSCouplingBlock, rqs_coupling_module
from tpuflows_torch.flows.nets import MLP
from tpuflows_torch.flows.train import (
    Adam,
    ClipAdamCosine,
    TrainResult,
    make_reverse_kl_trainer,
    make_train_step,
    mvnormal_negll_flow,
    negll_flow_loss,
    optimize_flow,
    optimize_flow_reverse_kl,
    optimize_flow_sequentially,
    reverse_kl_loss,
    reverse_kl_stl_loss,
)

__all__ = [
    "Bijector", "Chain", "Identity", "Inverted", "ScannedRepeat", "inverse",
    "with_logabsdet_jacobian",
    "AffineCoupling", "Standardize", "Whiten", "build_flow", "MLP",
    "RQSCouplingBlock", "rqs_coupling_module",
    "Adam", "ClipAdamCosine", "TrainResult", "make_reverse_kl_trainer",
    "make_train_step", "mvnormal_negll_flow", "negll_flow_loss",
    "optimize_flow", "optimize_flow_reverse_kl",
    "optimize_flow_sequentially", "reverse_kl_loss", "reverse_kl_stl_loss",
]
