"""Typed run configuration (port of `tpuflows/config.py`): every knob of a
run in a frozen dataclass, one `RunConfig` per `configs/*.json`, with the
JAX package's fields and defaults.

One departure: `FlowSpec.hidden` is a tuple after `from_dict`, as the JAX
package intends; its own check compares a string annotation with the type
and leaves the JSON list in place.
"""
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class TargetSpec:
    kind: str  # std_normal | diag_normal | correlated | mixture | funnel
    #          | hierarchical | banana | rosenbrock
    dim: int
    # optional per-kind knobs
    separation: float = 4.0
    rho: float = 0.8
    scale: float = 3.0

    def build(self, device="cuda"):
        from tpuflows_torch import targets as T

        k, d = self.kind, self.dim
        if k == "std_normal":
            return T.StandardNormal(dim=d)
        if k == "diag_normal":
            return T.DiagNormal(loc=torch.zeros(d, device=device),
                                scale=torch.ones(d, device=device))
        if k == "correlated":
            return T.CorrelatedGaussian.ar1(dim=d, rho=self.rho,
                                            device=device)
        if k == "mixture":
            # as in the JAX package, the spec's `scale` is not passed
            return T.GaussianMixture.bimodal(dim=d,
                                             separation=self.separation,
                                             device=device)
        if k == "funnel":
            return T.NealsFunnel(dim=d, sigma_v=self.scale)
        if k == "hierarchical":
            return T.HierarchicalGaussian.standard(dim=d, device=device)
        if k == "banana":
            return T.Banana(dim=d)
        if k == "rosenbrock":
            return T.Rosenbrock(dim=d)
        raise ValueError(f"unknown target kind: {k!r}")


@dataclass(frozen=True)
class FlowSpec:
    kind: str = "rqs"  # rqs | arqs | affine
    n_blocks: int = 4
    knots: int = 8
    hidden: Tuple[int, ...] = (64, 64)
    use_pallas: object = "auto"
    # mask/coupling geometry (flows/build.py)
    mask_scheme: str = "alternating"  # alternating | mixed | leading
    n_leading: int = 1
    clamp: float = 4.0


@dataclass(frozen=True)
class TrainSpec:
    loss: str = "forward_kl"  # forward_kl | reverse_kl
    nepochs: int = 100
    nbatches: int = 10
    nsteps: int = 1000  # reverse-KL steps
    batch_size: int = 512
    learning_rate: float = 1e-3
    n_fit_samples: int = 4096


@dataclass(frozen=True)
class NUTSSpec:
    n_chains: int = 64
    num_warmup: int = 500
    num_samples: int = 500
    max_depth: int = 8
    target_accept: float = 0.8
    preconditioned: bool = True
    # "single" or "stan" (doubling Welford windows; mcmc/sample.py)
    warmup_schedule: str = "single"
    # the JAX package's device-program partition; no meaning in eager
    # PyTorch, kept so that every config parses
    chunk_size: int = 256
    # the fused transition (K1, kernels/nuts_cuda.py): "auto" takes it
    # wherever `pack_flow` accepts the flow and the target (every target
    # kind above, at any dim up to 256), "on" requires it, "off" takes the
    # portable NUTS
    fused_kernel: str = "auto"


@dataclass(frozen=True)
class MHSpec:
    """Adaptive random-walk MH / flow-independence MH."""

    n_chains: int = 64
    num_warmup: int = 1000
    num_samples: int = 1000
    target_accept: float = 0.234
    flow_proposal: bool = False  # True: independence MH from the fitted flow


@dataclass(frozen=True)
class PTSpec:
    """Parallel tempering."""

    n_temps: int = 8
    beta_min: float = 0.01
    n_chains: int = 64
    num_warmup: int = 1000
    num_samples: int = 1000
    target_accept: float = 0.234


@dataclass(frozen=True)
class SMCSpec:
    n_particles: int = 4096
    target_rel_ess: float = 0.5
    n_mutation_steps: int = 5
    n_leapfrog: int = 5
    max_stages: int = 200
    latent_mutation: bool = True
    retrain_every: int = 0
    retrain_mode: str = "freeze"  # freeze | reweight
    final_equilibration_stages: int = 0
    # run the sharded stage over `dist.worker_mesh()`: the world that
    # `torchrun` started, or a world of one
    sharded: bool = False
    # bridge-flow pretraining before SMC starts: "none" or "prior"
    # (forward KL on draws from the target's prior)
    pretrain: str = "none"  # none | prior
    pretrain_draws: int = 8192
    pretrain_epochs: int = 60
    pretrain_batches: int = 8
    pretrain_lr: float = 2e-3

    def to_smc_config(self):
        """The sampler's knobs: the fields the JAX package passes, no more
        (`resample_threshold`, the step size's and the retrain's knobs keep
        `SMCConfig`'s defaults)."""
        from tpuflows_torch.smc import SMCConfig

        return SMCConfig(
            n_particles=self.n_particles,
            target_rel_ess=self.target_rel_ess,
            n_mutation_steps=self.n_mutation_steps,
            n_leapfrog=self.n_leapfrog,
            max_stages=self.max_stages,
            latent_mutation=self.latent_mutation,
            retrain_every=self.retrain_every,
            retrain_mode=self.retrain_mode,
            final_equilibration_stages=self.final_equilibration_stages,
        )


@dataclass(frozen=True)
class AdaptiveSpec:
    max_rounds: int = 5
    ess_threshold: float = 400.0
    n_chains: int = 64
    num_warmup: int = 300
    num_samples: int = 300
    train_epochs: int = 60

    def to_adaptive_config(self, flow: "FlowSpec"):
        """The loop's knobs, with the JAX package's choice of what passes
        through: the flow's kind, blocks, knots, widths and tier, but not
        its `mask_scheme` or `clamp` (the loop keeps its own defaults)."""
        from tpuflows_torch.adaptive import AdaptiveConfig

        return AdaptiveConfig(
            max_rounds=self.max_rounds,
            ess_threshold=self.ess_threshold,
            n_chains=self.n_chains,
            num_warmup=self.num_warmup,
            num_samples=self.num_samples,
            flow_kind=flow.kind,
            n_blocks=flow.n_blocks,
            knots=flow.knots,
            hidden=tuple(flow.hidden),
            train_epochs=self.train_epochs,
            use_pallas=flow.use_pallas,
        )


@dataclass(frozen=True)
class RunConfig:
    name: str
    task: str  # fit | vi | adaptive | nuts | smc | mh | pt
    seed: int = 0
    target: TargetSpec = field(
        default_factory=lambda: TargetSpec("std_normal", 2))
    flow: FlowSpec = field(default_factory=FlowSpec)
    train: TrainSpec = field(default_factory=TrainSpec)
    nuts: NUTSSpec = field(default_factory=NUTSSpec)
    smc: SMCSpec = field(default_factory=SMCSpec)
    adaptive: AdaptiveSpec = field(default_factory=AdaptiveSpec)
    mh: MHSpec = field(default_factory=MHSpec)
    pt: PTSpec = field(default_factory=PTSpec)
    output_dir: Optional[str] = None

    @staticmethod
    def from_dict(d: dict) -> "RunConfig":
        def build(cls, sub):
            kwargs = dict(sub)
            for f in dataclasses.fields(cls):
                if f.name in kwargs and f.type == Tuple[int, ...]:
                    kwargs[f.name] = tuple(kwargs[f.name])
            known = {f.name for f in dataclasses.fields(cls)}
            unknown = set(kwargs) - known
            if unknown:
                raise ValueError(f"{cls.__name__}: unknown keys {unknown}")
            return cls(**kwargs)

        d = dict(d)
        for key, cls in [("target", TargetSpec), ("flow", FlowSpec),
                         ("train", TrainSpec), ("nuts", NUTSSpec),
                         ("smc", SMCSpec), ("adaptive", AdaptiveSpec),
                         ("mh", MHSpec), ("pt", PTSpec)]:
            if key in d:
                d[key] = build(cls, d[key])
        return build(RunConfig, d)

    @staticmethod
    def from_json(path: str) -> "RunConfig":
        with open(path) as f:
            return RunConfig.from_dict(json.load(f))
