"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. Importing a module here compiles nothing: a kernel is built with
nvcc on its first launch (see `cuda_build.build`).

`rqs_forward_from_raw` and `rqs_inverse_from_raw` (the spline tier,
`rqs_cuda`) are this package's public names, as in the JAX package's
`tpuflows.kernels`; they load `rqs_cuda` on first use."""

_LAZY = {"rqs_forward_from_raw": "tpuflows_torch.kernels.rqs_cuda",
         "rqs_inverse_from_raw": "tpuflows_torch.kernels.rqs_cuda"}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["rqs_forward_from_raw", "rqs_inverse_from_raw"]
