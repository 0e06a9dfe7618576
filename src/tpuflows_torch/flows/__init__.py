from tpuflows_torch.flows.core import (
    Bijector,
    Chain,
    Inverted,
    inverse,
    with_logabsdet_jacobian,
)
from tpuflows_torch.flows.affine import AffineCoupling, Standardize
from tpuflows_torch.flows.build import build_flow
from tpuflows_torch.flows.coupling import RQSCouplingBlock, rqs_coupling_module
from tpuflows_torch.flows.nets import MLP
from tpuflows_torch.flows.train import (
    ClipAdamCosine,
    TrainResult,
    make_reverse_kl_trainer,
    reverse_kl_loss,
    reverse_kl_stl_loss,
)

__all__ = [
    "Bijector", "Chain", "Inverted", "inverse", "with_logabsdet_jacobian",
    "AffineCoupling", "Standardize", "build_flow", "MLP",
    "RQSCouplingBlock", "rqs_coupling_module",
    "ClipAdamCosine", "TrainResult", "make_reverse_kl_trainer",
    "reverse_kl_loss", "reverse_kl_stl_loss",
]
