"""K6 and K7 on Hopper: one whole RQS coupling block per tile of rows, and
its pullback (port of `tpuflows/kernels/coupling_pallas.py`).

  * the plain PyTorch version: `flatten_params` (the conditioner's flat
    parameters with the last layer relaid to p-major columns, a
    differentiable reshape outside the kernel), `block_math` (the Pallas
    body on a (T, d) tile, on top of `rqs_cuda`'s tile math), and
    `plain_block` / `plain_block_vjp`, its pullback by torch.autograd;
  * K6 and K7, hand-written CUDA (`csrc/coupling_block.cu`): the
    conditioner, the spline and the masked ladj sum per row in one kernel;
    its pullback in two launches, per-row cotangents, then the weights'
    cotangents summed over the rows in a fixed order;
  * `block_eval` / `block_grad`, the wrappers: a CPU tensor runs the plain
    version (in its own dtype), a CUDA tensor launches the kernel or the
    wrapper raises; `LAUNCHES` counts the kernels' launches (K7's second
    launch, when a weight needs its cotangent, counts too);
  * `FusedCouplingBlock`, the `torch.autograd.Function` whose forward is K6
    and whose backward is K7, and `fused_coupling_forward` /
    `fused_coupling_inverse` with the JAX package's signatures.

The conditioner computes in float32 (`flows/nets.py`); the JAX package's
opt-in bf16 operands (`compute_dtype`) and its "gelu" wait for ROADMAP
Queue 1 item 3. Importing this module compiles nothing.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from tpuflows_torch.flows.nets import _ACTIVATIONS
from tpuflows_torch.flows.rqs_ref import (
    DEFAULT_MIN_BIN,
    DEFAULT_MIN_DERIV,
    DEFAULT_RANGE,
)
from tpuflows_torch.kernels.cuda_build import CudaLibrary
from tpuflows_torch.kernels.rqs_cuda import (
    MAX_KNOTS,
    _fwd_tile_math,
    _inv_tile_math,
)
from tpuflows_torch.kernels.tile_flow import p_major

# kernel launches since the last reset, by kernel and direction
LAUNCHES = {"k6_forward": 0, "k6_inverse": 0, "k7_forward": 0,
            "k7_inverse": 0}
MAX_LAYERS = 8
MAX_SMEM = 232448  # bytes of shared memory a block may opt in to
ACTIVATION_CODES = {"silu": 0, "tanh": 1, "relu": 2}


def _bind(lib):
    # pointers, host arrays of pointers or ints and streams are c_void_p
    p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
    lib.coupling_block_smem.argtypes = [p, i32, i32, i32, i32, i32]
    lib.coupling_block_smem.restype = i64
    # x, mask, idx, ws, bs, widths, n_layers, N, d, nt, knots, range_limit,
    # activation, inverse, dc
    block = [p, p, p, p, p, p, i32, i64, i32, i32, i32, f32, i32, i32, i32]
    lib.coupling_block_fwd_f32.argtypes = block + [p, p, p]
    lib.coupling_block_fwd_f32.restype = i32
    lib.coupling_block_bwd_f32.argtypes = block + [p] * 6
    lib.coupling_block_bwd_f32.restype = i32
    lib.coupling_block_wgrad_f32.argtypes = [p] * 5 + [i32, i64, i32, i32,
                                                       i32, p, p]
    lib.coupling_block_wgrad_f32.restype = i32


LIBRARY = CudaLibrary("coupling_block", "coupling_block.cu",
                      [("coupling_block", [])], ["rqs_math.cuh"], _bind)


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------
def _activation(name):
    if name not in _ACTIVATIONS:
        raise ValueError(f"activation {name!r} is not ported (the JAX "
                         f"package's 'gelu' waits for ROADMAP Queue 1 item "
                         f"3)")
    return _ACTIVATIONS[name]


def flatten_params(net, d: int, knots: int) -> tuple:
    """The conditioner as the flat tuple (w0, b0, w1, b1, ...), biases as
    (1, n) rows, with the last layer's columns relaid from d-major
    (j (3K-1) + p) to p-major (p d + j), so that spline parameter p of all
    dims is one contiguous slice. The relayout is differentiable: the
    cotangents reach the module's own parameters."""
    P = 3 * knots - 1
    ws, bs = list(net.weights), list(net.biases)
    ws[-1] = p_major(ws[-1], d, P)
    bs[-1] = p_major(bs[-1], d, P)
    out = []
    for w, b in zip(ws, bs):
        out.append(w)
        out.append(b.reshape(1, -1))
    return tuple(out)


def block_math(x2d, params, mask_vec, K, B, activation, inverse):
    """One coupling block on a (T, d) tile, as the Pallas body computes it:
    the conditioner on x * b, p-major slices of its last layer, the spline
    (forward, or inverse when `inverse`), z = b x + (1 - b) y and the
    masked ladj summed per row. Returns (z (T, d), ladj (T, 1)); `params`
    as `flatten_params` gives them, `mask_vec` (d,) or (1, d)."""
    act = _activation(activation)
    d = x2d.shape[-1]
    ws, bs = params[0::2], params[1::2]
    h = x2d * mask_vec
    for w, b in zip(ws[:-1], bs[:-1]):
        h = act(h @ w + b)
    raw_t = h @ ws[-1] + bs[-1]  # (T, P d), p-major
    P = 3 * K - 1
    raw = [raw_t[:, p * d:(p + 1) * d] for p in range(P)]
    tile_math = _inv_tile_math if inverse else _fwd_tile_math
    y, ladj_el = tile_math(x2d, raw, K, B, DEFAULT_MIN_BIN,
                           DEFAULT_MIN_DERIV)
    z = mask_vec * x2d + (1.0 - mask_vec) * y
    ladj = torch.sum((1.0 - mask_vec) * ladj_el, dim=-1, keepdim=True)
    return z, ladj


def plain_block(x2d, params, mask_vec, K, B, activation, inverse):
    """The plain version of K6 on any device: (z (T, d), ladj (T,))."""
    with torch.no_grad():
        z, ladj = block_math(x2d, params, mask_vec, K, B, activation,
                             inverse)
    return z, ladj[:, 0]


def plain_block_vjp(x2d, params, mask_vec, gz, gladj, K, B, activation,
                    inverse):
    """The plain version of K7: (dx, dparams), the autograd pullback of
    `block_math` with cotangents gz (T, d) and gladj (T,)."""
    with torch.enable_grad():
        xg = x2d.detach().requires_grad_(True)
        pg = [p.detach().requires_grad_(True) for p in params]
        z, ladj = block_math(xg, pg, mask_vec, K, B, activation, inverse)
        dx, *dps = torch.autograd.grad((z, ladj), (xg, *pg),
                                       (gz, gladj[:, None]))
    return dx, tuple(dps)


# ---------------------------------------------------------------------------
# The kernels and their wrappers
# ---------------------------------------------------------------------------
class BlockSpec(NamedTuple):
    """The static fields of a block: what the pullback needs besides the
    tensors."""
    mask: tuple
    knots: int
    range_limit: float
    activation: str
    inverse: bool


_MASKS = {}


def _mask_tensors(mask, device, dtype):
    """(mask (d,) in `dtype`, the spline dims (nt,) int32) on `device`,
    made once per mask and device."""
    key = (tuple(mask), str(device), dtype)
    if key not in _MASKS:
        m = torch.tensor(mask, dtype=dtype, device=device)
        idx = torch.tensor([j for j, b in enumerate(mask) if b == 0],
                           dtype=torch.int32, device=device)
        _MASKS[key] = (m, idx)
    return _MASKS[key]


def _check(x2d, params, spec, *cots):
    """Shapes, devices and dtypes of a call (one floating dtype for all),
    for the plain version and the kernels alike; returns the layer
    widths."""
    if x2d.dim() != 2:
        raise ValueError(f"x must be (N, d), got {tuple(x2d.shape)}")
    N, d = x2d.shape
    K = spec.knots
    if len(spec.mask) != d:
        raise ValueError(f"mask of {len(spec.mask)} dims for x of {d}")
    if not 2 <= K <= MAX_KNOTS:
        raise ValueError(f"the kernels take 2..{MAX_KNOTS} knots, got {K}")
    if len(params) % 2 or not 2 <= len(params) <= 2 * MAX_LAYERS:
        raise ValueError(f"the kernels take 1..{MAX_LAYERS} layers as (w, "
                         f"b) pairs, got {len(params)} tensors")
    widths = [d]
    for w, b in zip(params[0::2], params[1::2]):
        if w.dim() != 2 or w.shape[0] != widths[-1]:
            raise ValueError(f"weight {tuple(w.shape)} does not follow a "
                             f"layer of width {widths[-1]}")
        if b.numel() != w.shape[1]:
            raise ValueError(f"bias of {b.numel()} values for weight "
                             f"{tuple(w.shape)}")
        widths.append(int(w.shape[1]))
    if widths[-1] != (3 * K - 1) * d:
        raise ValueError(f"the last layer has {widths[-1]} columns, not "
                         f"(3 K - 1) d = {(3 * K - 1) * d}")
    if not x2d.dtype.is_floating_point:
        raise TypeError(f"the block takes floating tensors, got {x2d.dtype}")
    for t in (*params, *cots):
        if t.device != x2d.device:
            raise ValueError(f"a tensor is on {t.device}, x on {x2d.device}")
        if t.dtype != x2d.dtype:
            raise TypeError(f"a tensor is {t.dtype}, x {x2d.dtype}")
    for t, shape in zip(cots, ((N, d), (N,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"cotangent {tuple(t.shape)} is not {shape}")
    _activation(spec.activation)
    return widths


def _check_kernel(x2d, params, *cots):
    for t in (x2d, *params, *cots):
        if t.dtype != torch.float32:
            raise TypeError(f"the coupling-block kernels take float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the coupling-block kernels take contiguous "
                             "tensors")


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _ints(xs):
    return (ctypes.c_int * len(xs))(*xs)


def _plan(lib, widths, d, K, grad):
    """Spline dims per chunk of a launch: 32, halved until the tile's
    shared memory fits."""
    dc = 32
    while True:
        smem = lib.coupling_block_smem(_ints(widths), len(widths) - 1, d,
                                       K, dc, int(grad))
        if smem <= MAX_SMEM or dc == 1:
            break
        dc //= 2
    if smem > MAX_SMEM:
        raise ValueError(f"a coupling block of widths {widths} needs {smem} "
                         f"bytes of shared memory, above {MAX_SMEM}")
    return dc


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launched(rc, name, key):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[key] += 1


def _common(x2d, params, spec, widths, dc):
    """The leading arguments shared by K6 and K7 pass 1."""
    N, d = x2d.shape
    mask, idx = _mask_tensors(spec.mask, x2d.device, torch.float32)
    ws, bs = params[0::2], params[1::2]
    return [x2d.data_ptr(), mask.data_ptr(), idx.data_ptr(), _ptrs(ws),
            _ptrs(bs), _ints(widths), len(ws), N, d, idx.numel(),
            spec.knots, float(spec.range_limit),
            ACTIVATION_CODES[spec.activation], int(spec.inverse), dc]


def _launch_eval(x2d, params, spec, widths):
    _check_kernel(x2d, params)
    z = torch.empty_like(x2d)
    ladj = torch.empty(x2d.shape[0], dtype=x2d.dtype, device=x2d.device)
    if x2d.shape[0] == 0:
        return z, ladj
    lib = LIBRARY.load()
    dc = _plan(lib, widths, x2d.shape[1], spec.knots, False)
    with torch.cuda.device(x2d.device):
        rc = lib.coupling_block_fwd_f32(
            *_common(x2d, params, spec, widths, dc), z.data_ptr(),
            ladj.data_ptr(), _stream(x2d))
    _launched(rc, "coupling_block_fwd_f32 (K6)",
              "k6_inverse" if spec.inverse else "k6_forward")
    return z, ladj


def _launch_grad(x2d, params, spec, widths, gz, gladj, need_params):
    _check_kernel(x2d, params, gz, gladj)
    N, d = x2d.shape
    if N == 0:
        return (torch.empty_like(x2d),
                tuple(torch.zeros_like(p) for p in params)
                if need_params else None)
    lib = LIBRARY.load()
    key = "k7_inverse" if spec.inverse else "k7_forward"
    dc = _plan(lib, widths, d, spec.knots, True)
    _, idx = _mask_tensors(spec.mask, x2d.device, torch.float32)
    nt, P = idx.numel(), 3 * spec.knots - 1
    dx = torch.empty_like(x2d)
    Hs = Gs = None
    if need_params:
        outs = [*widths[1:-1], P * nt]
        Hs = [torch.empty((N, w), dtype=x2d.dtype, device=x2d.device)
              for w in widths[:-1]]
        Gs = [torch.empty((N, w), dtype=x2d.dtype, device=x2d.device)
              for w in outs]
    with torch.cuda.device(x2d.device):
        rc = lib.coupling_block_bwd_f32(
            *_common(x2d, params, spec, widths, dc), gz.data_ptr(),
            gladj.data_ptr(), dx.data_ptr(),
            _ptrs(Hs) if Hs else None, _ptrs(Gs) if Gs else None,
            _stream(x2d))
    _launched(rc, "coupling_block_bwd_f32 (K7, pass 1)", key)
    if not need_params:
        return dx, None
    # the last layer's pass-through columns get no cotangent: zeros
    dps = [torch.empty_like(p) for p in params[:-2]]
    dps += [torch.zeros_like(params[-2]), torch.zeros_like(params[-1])]
    with torch.cuda.device(x2d.device):
        rc = lib.coupling_block_wgrad_f32(
            _ptrs(Hs), _ptrs(Gs), _ptrs(dps[0::2]), _ptrs(dps[1::2]),
            _ints(widths), len(Hs), N, d, nt, spec.knots, idx.data_ptr(),
            _stream(x2d))
    _launched(rc, "coupling_block_wgrad_f32 (K7, pass 2)", key)
    return dx, tuple(dps)


def block_eval(x2d, params, spec: BlockSpec):
    """(z (N, d), ladj (N,)) of the block: the plain version for a CPU
    tensor (in its dtype), K6 for a CUDA tensor."""
    widths = _check(x2d, params, spec)
    if x2d.device.type == "cpu":
        mask, _ = _mask_tensors(spec.mask, x2d.device, x2d.dtype)
        return plain_block(x2d, params, mask, spec.knots,
                           float(spec.range_limit), spec.activation,
                           spec.inverse)
    if x2d.device.type == "cuda":
        return _launch_eval(x2d, params, spec, widths)
    raise ValueError(f"no coupling-block kernel for device {x2d.device}")


def block_grad(x2d, params, spec: BlockSpec, gz, gladj, need_params=True):
    """(dx, dparams) of the block's pullback, dparams None unless
    `need_params`: the plain version for a CPU tensor, K7 for a CUDA
    tensor."""
    widths = _check(x2d, params, spec, gz, gladj)
    if x2d.device.type == "cpu":
        mask, _ = _mask_tensors(spec.mask, x2d.device, x2d.dtype)
        dx, dps = plain_block_vjp(x2d, params, mask, gz, gladj, spec.knots,
                                  float(spec.range_limit), spec.activation,
                                  spec.inverse)
        return dx, (dps if need_params else None)
    if x2d.device.type == "cuda":
        return _launch_grad(x2d, params, spec, widths, gz, gladj,
                            need_params)
    raise ValueError(f"no coupling-block kernel for device {x2d.device}")


class FusedCouplingBlock(torch.autograd.Function):
    """(z, ladj) = block(x2d; params), forward or inverse as `spec` says;
    its backward recomputes the block in K7 from (x2d, params) and the
    cotangents, and gives the parameters' cotangents only when one of them
    needs it (not in the STL loss's forward pass, whose parameters are
    detached)."""

    @staticmethod
    def forward(ctx, x2d, spec, *params):
        x2d = x2d.contiguous()
        params = tuple(p.contiguous() for p in params)
        ctx.save_for_backward(x2d, *params)
        ctx.spec = spec
        return block_eval(x2d, params, spec)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gz, gladj):
        x2d, *params = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dps = block_grad(x2d, tuple(params), ctx.spec, gz.contiguous(),
                             gladj.contiguous(), need_params=any(need[2:]))
        if dps is None:
            dps = (None,) * len(params)
        return (dx if need[0] else None, None,
                *(g if n else None for g, n in zip(dps, need[2:])))


def _apply(x, net, mask, knots, range_limit, inverse):
    d = len(mask)
    lead = x.shape[:-1]
    spec = BlockSpec(tuple(int(m) for m in mask), int(knots),
                     float(range_limit), net.activation, inverse)
    z2d, ladj = FusedCouplingBlock.apply(
        x.reshape(-1, d), spec, *flatten_params(net, d, knots))
    return z2d.reshape(*lead, d), ladj.reshape(lead)


def fused_coupling_forward(x, net, mask, knots,
                           range_limit: float = DEFAULT_RANGE):
    """Whole-block forward: z = b x + (1 - b) spline(x; net(x b)) and the
    masked ladj, for x of shape (..., d). Drop-in for
    `RQSCouplingBlock.forward_and_ladj`."""
    return _apply(x, net, mask, knots, range_limit, False)


def fused_coupling_inverse(z, net, mask, knots,
                           range_limit: float = DEFAULT_RANGE):
    """Whole-block analytic inverse and its ladj (the conditioner sees
    z b == x b)."""
    return _apply(z, net, mask, knots, range_limit, True)
