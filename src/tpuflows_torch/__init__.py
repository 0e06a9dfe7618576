"""tpuflows_torch — the PyTorch/CUDA port of `tpuflows` for NVIDIA Hopper.

The package mirrors `tpuflows`' layout module by module. It imports
`torch`, numpy and the standard library only: nothing of JAX and nothing
of the JAX package, which stays the reference the tests compare against.

Conventions carried over from `tpuflows`:
  - `forward` maps data -> base (x -> z), `inverse` base -> data;
  - arrays are `(..., d)`, batch leading, features trailing;
  - all math is float32. The entry points (`build_flow`,
    `make_reverse_kl_trainer`, `NUTSDriver`, `elbo`, ...) take an explicit
    `device=` that defaults to "cuda", and they switch TF32 off
    (`torch.backends.cuda.matmul.allow_tf32 = False`,
    `torch.backends.cudnn.allow_tf32 = False`), so a float32 matmul on the
    card is a float32 matmul.

What is ported so far: the flow core, the affine and spline couplings,
the reverse-KL/STL fit, Neal's funnel, ESS / R-hat, and NUTS and HMC, both
the portable samplers (`mcmc`) and the fused NUTS transition, with the
CUDA kernels K1 and K3-K7 (`kernels`); it runs both variants of
`bench.py`. ROADMAP.md lists the rest.
"""

__version__ = "0.1.0"
