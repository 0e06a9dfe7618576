"""tpuflows_torch — the PyTorch/CUDA port of `tpuflows` for NVIDIA Hopper.

The package mirrors `tpuflows`' layout module by module. It imports
`torch`, numpy and the standard library only: nothing of JAX and nothing
of the JAX package, which stays the reference the tests compare against.

Conventions carried over from `tpuflows`:
  - `forward` maps data -> base (x -> z), `inverse` base -> data;
  - arrays are `(..., d)`, batch leading, features trailing;
  - all math is float32 (bar the MLP's opt-in bf16 operands). The entry
    points (`build_flow`, `run.run`, `make_reverse_kl_trainer`,
    `NUTSDriver`, `elbo`, ...) take an explicit `device=` that defaults
    to "cuda", and they switch TF32 off
    (`torch.backends.cuda.matmul.allow_tf32 = False`,
    `torch.backends.cudnn.allow_tf32 = False`), so a float32 matmul on the
    card is a float32 matmul.

What is ported so far:
  - the flow core (`flows`): Standardize, Whiten, Identity, Chain,
    ScannedRepeat, the affine and spline couplings, MLPs with silu, tanh,
    relu and gelu and opt-in bf16 operands, `build_flow`;
  - training and VI: forward KL (`optimize_flow`, with `val_frac` early
    stopping, and `optimize_flow_sequentially`), reverse KL with STL and
    annealing, `fit_vi`, the written-out `Adam` and `ClipAdamCosine`;
  - targets: the standard, diagonal and correlated Gaussians, Neal's
    funnel, the mixture, banana and Rosenbrock, the hierarchical
    Gaussian (with its quadrature moments and evidence), the multimodal
    Cauchy, and `Posterior` over an `IndependentPrior` with
    `find_mode`; ESS, R-hat and the moment gates (`diagnostics`);
  - the samplers without a kernel: MH, parallel tempering, the ensemble
    sampler, annealed SMC with flow bridges (`smc`), the adaptive loop
    (`adaptive`), and the evidence estimators (`integration`);
  - NUTS and HMC, both the portable samplers (`mcmc`) and the fused
    transition and window, with the hand-written CUDA kernels K1-K7
    (`kernels`), which take every conditioner the JAX package's kernels
    take (silu, tanh, relu and gelu, float32 and bf16 operands, 1 to 8
    layers) and, in K1-K3, Whiten, and refuse Identity and ScannedRepeat
    as the JAX package's in-kernel flow math does;
  - `util` (shapes, `VariateShape`, `Timer`, `MetricsLogger`, `trace`),
    `io` (checkpoints, per-rank shards that reshard on load), `config` and
    the runner `run`;
  - `dist`, the distributed layer on `torch.distributed`: the
    `WorkerMesh` that stands for the JAX package's `axis_name` (every
    sampler and trainer takes `mesh=`), the collectives, the sharded
    resampler with its ring exchange, data-parallel training, sharded
    NUTS, `heartbeat` and the failure policy; NCCL on the card, gloo for
    CPU worlds.

The runner takes the JAX package's configs, on the card by default:

    PYTHONPATH=src python -m tpuflows_torch.run configs/c2_correlated_rqs.json

It runs every task of the JAX runner (configs c1-c7), c5's SMC sharded
over `dist.worker_mesh()`. `chip_smoke.py` runs both variants of
`bench.py`, the configs and the distributed layer on the card. Every
module of the JAX package is ported; ROADMAP.md lists the reach gaps
left.
"""

__version__ = "0.1.0"
