"""K3 on Hopper: the fused latent log density and its gradient (port of
`tpuflows/kernels/fused_logp.py`, `fused_latent_logp_and_grad`).

`fused_latent_logp_and_grad(target, flow)` returns the `logp_and_grad`
hook of the portable samplers (`mcmc.make_nuts_kernel`, `make_hmc_kernel`,
`NUTSDriver(log_density, logp_and_grad=...)`): z (n, d) -> (lp (n,),
g (n, d)) with

    lp = target.log_density(f^-1(z)) + ladj(z),   g = d lp / dz.

  * the plain PyTorch version is `nuts_cuda.plain_logp_grad` (autograd
    through the flow, or the streamed per-block backward on the p-major
    relayout for flows with splines), the counterpart of the JAX kernel's
    `_reference`;
  * the kernel, `csrc/fused_logp.cu`, is one block per tile of rows that
    share every weight read (`csrc/tile_grad.cuh`), on every flow, the
    affine one included: `nuts_cuda.tile_rows(model)` rows, the weights
    resident in shared memory where they fit, as K1 and K2 take them (at
    the ceiling's affine flow R = 8, resident);
    `chain_logp_grad_warp` runs the per-warp module-list kernel, on no
    path: `chip_smoke.py`'s oracle and yardstick for the tile kernel;
  * the wrapper (`FusedLatentLogpAndGrad.__call__`): a CPU tensor runs the
    plain version; a CUDA tensor launches the kernel, or the wrapper
    raises. `LAUNCHES` counts the kernel's launches.

A hand-written kernel cannot trace an arbitrary log density into its body
as the JAX package's does, so this takes what K1 takes (`nuts_cuda.
pack_flow`): any closed-form target of the port (`nuts_cuda.pack_target`,
its log density and gradient written out in `csrc/targets.cuh`) of the
flow's width d <= 256, and a Chain of Standardize, AffineCoupling and
RQSCouplingBlock modules with 3-layer silu MLPs, or no flow; it raises on
anything else. The JAX package's generic tile kernel
`make_fused_logp_and_grad`, whose body is whatever JAX code it is given,
has no CUDA counterpart: a target whose log density is user code (a
`Posterior`, a `Target` subclass) samples through `logp_and_grad=None`
(autograd).
The library is built with nvcc into `build/kernels/` on first use
(`cuda_build`); nothing is compiled or loaded at import time.
"""
from __future__ import annotations

import ctypes

import torch

from tpuflows_torch.flows.core import Chain
from tpuflows_torch.kernels import nuts_cuda
from tpuflows_torch.kernels.cuda_build import CudaLibrary

# kernel launches since the last reset (the main path's proof of use)
LAUNCHES = 0
# one translation unit per instantiation (d / 32 dims per lane) plus the C
# entry points, compiled in parallel; per DPL a unit of every target and
# one of the funnel's alone (its tile kernel, which the entry point
# launches for a funnel: csrc/targets.cuh)
_UNITS = [("entry", [])] + [
    (f"dpl{k}{f}", [f"-DLATENT_DPL={k}", *flag])
    for k in range(1, nuts_cuda.MAX_DIM // 32 + 1)
    for f, flag in (("", []), ("f", ["-DTARGETS_FUNNEL_ONLY"]))]


def reset_launches():
    global LAUNCHES
    LAUNCHES = 0


def _bind(lib):
    p, i32 = ctypes.c_void_p, ctypes.c_int
    fn = lib.fused_logp_chain_f32
    fn.argtypes = [p] * 4 + [i32] * 7 + [p] * 2 + [i32, i32, p]
    fn.restype = i32
    fn = lib.fused_logp_chain_warp_f32
    fn.argtypes = [p] * 4 + [i32] * 7 + [p] * 3
    fn.restype = i32


LIBRARY = CudaLibrary("fused_logp", "fused_logp.cu", _UNITS,
                      ["latent_grad.cuh", "targets.cuh", "tile_grad.cuh",
                       "rqs_math.cuh"], _bind)


def _call(name, z, args):
    """Entry point `name` of the library with `args` and z's stream, on
    z's card; raises if the launch failed."""
    lib = LIBRARY.load()
    with torch.cuda.device(z.device):
        rc = getattr(lib, name)(
            *args, torch.cuda.current_stream(z.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _launch(z, model: nuts_cuda.PackedFlow, rows=None, resident=None):
    """K3 on the card: the tile kernel on every flow, on tiles of `rows`
    rows, its weights resident where they fit, K1's and K2's rule (the
    wrapper's `tile_rows(model)` and `launch_resident`; `chip_smoke.py`
    times other R and the ring). At the ceiling's post-warmup state R = 8
    with resident weights is K3's fastest mode too (PERF.md §6), though a
    K3 launch serves one gradient a row."""
    global LAUNCHES
    _check(z, model)
    rows = nuts_cuda.launch_rows(model, rows)
    n, d = z.shape
    lp = torch.empty(n, device=z.device, dtype=torch.float32)
    g = torch.empty_like(z)
    _call("fused_logp_chain_f32", z, [
        z.data_ptr(), model.params.data_ptr(),
        *nuts_cuda.module_list_args(model, n), lp.data_ptr(), g.data_ptr(),
        rows, nuts_cuda.launch_resident(model, rows, resident)])
    LAUNCHES += 1
    return lp, g


def _check(z, model: nuts_cuda.PackedFlow):
    nuts_cuda.check_widths(model)
    if any(t.device != z.device for t in (model.params, model.mods,
                                          model.packed_target.params)):
        raise ValueError("the packed flow is on another device than z")


def _yardstick(z, model: nuts_cuda.PackedFlow):
    """Checks of a per-warp kernel's launch; its outputs."""
    if z.device.type != "cuda" or not z.is_contiguous():
        raise ValueError("the per-warp kernels take a contiguous CUDA z")
    _check(z, model)
    n = z.shape[0]
    return torch.empty(n, device=z.device, dtype=torch.float32), \
        torch.empty_like(z)


def chain_logp_grad_warp(z, model: nuts_cuda.PackedFlow):
    """The per-warp module-list kernel (`fused_logp_chain_kernel`) on a
    contiguous float32 CUDA z, on any flow K3 takes, the affine one
    included: `chip_smoke.py`'s oracle for the tile kernel, which must
    equal it in value. On no path, and not counted in LAUNCHES."""
    lp, g = _yardstick(z, model)
    n, d = z.shape
    _call("fused_logp_chain_warp_f32", z, [
        z.data_ptr(), model.params.data_ptr(),
        *nuts_cuda.module_list_args(model, n), lp.data_ptr(), g.data_ptr()])
    return lp, g


class FusedLatentLogpAndGrad:
    """The hook z (n, d) -> (lp (n,), g (n, d)) of a flow over a target
    (`nuts_cuda.pack_flow`: any closed-form target of the port, any d <=
    256; flow None: the target alone, its packed parameters on `device`).
    The flow is packed for the kernel when this is constructed, so build it
    after the flow is trained."""

    def __init__(self, target, flow: Chain | None, device=None):
        self.model = nuts_cuda.pack_flow(flow, target, device=device)
        self._plain = nuts_cuda.plain_logp_grad(self.model)

    def plain(self, z):
        """The plain version on any device, in z's dtype."""
        lp, g = self._plain(z)
        return lp[:, 0], g

    def __call__(self, z):
        if z.ndim != 2 or z.shape[1] != self.model.d:
            raise ValueError(f"z must be (n, {self.model.d}), got "
                             f"{tuple(z.shape)}")
        if z.dtype != torch.float32:
            raise TypeError(f"z must be float32, got {z.dtype}")
        dev = self.model.packed_target.params.device
        if z.device != dev:
            raise ValueError(f"z is on {z.device}, the flow on {dev}")
        if z.device.type == "cpu":
            return self.plain(z)
        if z.device.type == "cuda":
            if not z.is_contiguous():
                raise ValueError("the kernel takes a contiguous z")
            return _launch(z, self.model)
        raise ValueError(f"no fused logp_and_grad for device {z.device}")


def fused_latent_logp_and_grad(target, flow: Chain | None
                               ) -> FusedLatentLogpAndGrad:
    """`logp_and_grad` for flow-preconditioned MCMC on `target`, K3 on the
    card: pass it as `logp_and_grad=` to `make_nuts_kernel`, `NUTSDriver`
    or `make_hmc_kernel`."""
    return FusedLatentLogpAndGrad(target, flow)
