"""K4 and K5 on Hopper: the elementwise rational-quadratic spline and its
pullback (port of `tpuflows/kernels/rqs_pallas.py`).

  * the plain PyTorch version: `_normalize_tiles`, `_select_bin_params`,
    `_fwd_tile_math` and `_inv_tile_math`, the Pallas tile math written in
    torch on lists of same-shaped tensors (one per spline parameter), and
    its pullback by torch.autograd (`plain_eval`, `plain_grad`);
  * K4 and K5, hand-written CUDA (`csrc/rqs_spline.cu`, math in
    `csrc/rqs_math.cuh`), forward or inverse: a group of lanes per
    element, each block's span of raw values staged in shared memory
    (`csrc/rqs_lanes.cuh`); the one-thread K4 and K5 they replaced stay
    built as the oracles and yardsticks of `chip_smoke.py`
    (`earlier_spline_eval`, `earlier_spline_grad`, on no path, not
    counted);
  * `spline_eval` / `spline_grad`, the wrappers: a CPU tensor runs the
    plain version, a CUDA tensor launches the kernel or the wrapper raises;
    `LAUNCHES` counts the kernels' launches;
  * `RQSSpline`, the `torch.autograd.Function` whose forward is K4 and
    whose backward is K5 (the counterpart of `_make_op`'s `custom_vjp`),
    and `rqs_forward_from_raw` / `rqs_inverse_from_raw` on top of it.

x is (..., d) and raw (..., d, 3K-1) in the conditioner's own layout, as
`tpuflows.flows.rqs_ref` takes them. The library is built with nvcc at its
first launch (`cuda_build`); importing this module compiles nothing.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from tpuflows_torch.flows.rqs_ref import (
    DEFAULT_MIN_BIN,
    DEFAULT_MIN_DERIV,
    DEFAULT_RANGE,
    _SOFTPLUS_UNIT,
    clip,
    softplus,
)
from tpuflows_torch.kernels.cuda_build import CudaLibrary

# kernel launches since the last reset, by kernel and direction
LAUNCHES = {"k4_forward": 0, "k4_inverse": 0, "k5_forward": 0,
            "k5_inverse": 0}


def _bind(lib):
    p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
    for fn in (lib.rqs_eval_f32, lib.rqs_eval_thread_f32):
        fn.argtypes = [p] * 4 + [i64, i32, f32, i32, p]
        fn.restype = i32
    for fn in (lib.rqs_grad_f32, lib.rqs_grad_thread_f32):
        fn.argtypes = [p] * 6 + [i64, i32, f32, i32, p]
        fn.restype = i32


LIBRARY = CudaLibrary("rqs_spline", "rqs_spline.cu", [("rqs_spline", [])],
                      ["rqs_math.cuh", "rqs_lanes.cuh"], _bind)


# threads of a block of the group kernels and the bins a lane holds up to
# 32 lanes an element, K5's and K4's (csrc/rqs_lanes.cuh kLaneThreads,
# kBinsPerLane, kEvalBinsPerLane), and the bytes of shared memory a block
# may opt in to (kMaxSmem)
LANE_THREADS = 256
LANE_BINS = 4
EVAL_LANE_BINS = 8
MAX_SMEM = 232448


def lane_layout(K: int, bins: int = LANE_BINS) -> tuple[int, int, int]:
    """(L, NB, E) of a group kernel at K knots and `bins` bins a lane (K5's
    by default; K4's with EVAL_LANE_BINS), the host's copy of
    csrc/rqs_lanes.cuh `lanes_for` and `block_elements`: L lanes per
    element (the least power of two with L bins >= K, at most 32), NB
    bins a lane at most (lane l holds bins l, l + L, ...), E elements a
    block."""
    L = 1
    while L < 32 and L * bins < K:
        L *= 2
    return L, -(-K // L), LANE_THREADS // L


def _up4(n):
    return (n + 3) & ~3


def row_stride(K: int) -> int:
    """csrc/rqs_lanes.cuh `row_stride`: K5's floats between two elements'
    rows, K rounded up to whole 16-byte words, an odd number of them."""
    words = (K + 3) // 4
    return 4 * words if words % 2 else 4 * words + 4


def eval_stride(K: int) -> int:
    """csrc/rqs_lanes.cuh `eval_stride`: K4's two rows, each K rounded up
    to whole 16-byte words, and one word more."""
    return 4 * (2 * ((K + 3) // 4) + 1)


def block_floats(K: int, E: int, grad: bool) -> int:
    """Floats of a K5 (grad) or K4 block's dynamic shared memory at E
    elements (csrc/rqs_lanes.cuh `block_floats`, `eval_block_floats`): the
    raw span and x (K5: gy, gl), each region in whole 16-byte words
    (`rows_offset`), then each element's rows (K4 at one lane none)."""
    extra = 3 if grad else 1
    head = _up4(_up4(E * (3 * K - 1)) + extra * E)
    if grad:
        return head + E * 3 * row_stride(K)
    L = lane_layout(K, EVAL_LANE_BINS)[0]
    return head + (0 if L == 1 else E * eval_stride(K))


class SplinePlan(NamedTuple):
    lanes: int  # L, lanes an element
    elements: int  # E, elements a block of L E threads
    smem: int  # bytes of dynamic shared memory a block takes


def spline_plan(K: int, grad: bool) -> SplinePlan:
    """K5's (grad) or K4's launch plan at K knots, the host's copy of
    csrc/rqs_lanes.cuh `plan_elements`: 256 / L elements a block below 32
    lanes an element; at 32 lanes the most of 8, 4, 2 and 1 whose block
    fits MAX_SMEM. Raises ValueError, naming the shared memory, where not
    even one element's block fits: the kernels' only limit on K (the plain
    versions take any K)."""
    L, _, E = lane_layout(K, LANE_BINS if grad else EVAL_LANE_BINS)
    for e in (E, E // 2, E // 4, E // 8) if L == 32 else (E,):
        smem = 4 * block_floats(K, e, grad)
        if smem <= MAX_SMEM:
            return SplinePlan(L, e, smem)
    raise ValueError(
        f"{'K5' if grad else 'K4'} cannot take {K} knots: one element's "
        f"block needs {smem} bytes of shared memory, above the {MAX_SMEM} "
        f"a block may have")


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# The plain version: the Pallas tile math, on lists of tensors
# ---------------------------------------------------------------------------
def _normalize_tiles(raw, K, B, min_bin, min_deriv):
    """raw: list of 3K-1 tensors -> knot lists (xk, yk, dk), K+1 each."""
    w_raw, h_raw, d_raw = raw[:K], raw[K:2 * K], raw[2 * K:]

    def softmax_bins(vs):
        m = vs[0]
        for v in vs[1:]:
            m = torch.maximum(m, v)
        es = [torch.exp(v - m) for v in vs]
        tot = es[0]
        for e in es[1:]:
            tot = tot + e
        inv = 1.0 / tot
        return [min_bin + (1.0 - min_bin * K) * (e * inv) for e in es]

    def knots(bins):
        ks = [torch.full_like(bins[0], -B)]
        acc = ks[0]
        for b in bins[:-1]:
            acc = acc + 2.0 * B * b
            ks.append(acc)
        ks.append(torch.full_like(bins[0], B))  # pin the end knot exactly
        return ks

    xk = knots(softmax_bins(w_raw))
    yk = knots(softmax_bins(h_raw))
    one = torch.ones_like(w_raw[0])
    dk = [one] + [min_deriv + softplus(dr + _SOFTPLUS_UNIT) for dr in d_raw]
    dk.append(one)
    return xk, yk, dk


def _select_bin_params(t, sel_k, xk, yk, dk, K):
    """Parameters of the bin holding t (clamped into [-B, B]); `sel_k` is
    the knot list searched (xk forward, yk inverse).

    The Pallas tile math takes the last bin k with t >= sel_k[k] in a
    running select. The knots increase strictly (every bin is at least
    min_bin wide), so that k is the count of knots 1..K-1 at or below t,
    and the same values are gathered here in a few operations."""
    b = (t >= sel_k[1]).long()
    for k in range(2, K):
        b = b + (t >= sel_k[k]).long()
    b = b[..., None]
    xs, ys, ds = (torch.stack(ks, dim=-1) for ks in (xk, yk, dk))

    def at(s, shift=0):
        return torch.gather(s, -1, b + shift)[..., 0]

    x0, y0 = at(xs), at(ys)
    return x0, at(xs, 1) - x0, y0, at(ys, 1) - y0, at(ds), at(ds, 1)


def _fwd_tile_math(x, raw, K, B, min_bin, min_deriv):
    """Forward spline. x: tensor; raw: list of 3K-1 tensors of x's shape."""
    xk, yk, dk = _normalize_tiles(raw, K, B, min_bin, min_deriv)
    inside = torch.abs(x) <= B
    xc = clip(x, -B, B)
    x0, w, y0, h, d0, d1 = _select_bin_params(xc, xk, xk, yk, dk, K)

    s = h / w
    xi = (xc - x0) / w
    xi1m = 1.0 - xi
    q = xi * xi1m
    denom = s + (d1 + d0 - 2.0 * s) * q
    y = y0 + h * (s * xi * xi + d0 * q) / denom
    deriv_num = s * s * (d1 * xi * xi + 2.0 * s * q + d0 * xi1m * xi1m)
    ladj = torch.log(deriv_num) - 2.0 * torch.log(denom)
    return torch.where(inside, y, x), torch.where(inside, ladj, 0.0)


def _inv_tile_math(y, raw, K, B, min_bin, min_deriv):
    """Analytic inverse spline (the bin is searched by yk)."""
    xk, yk, dk = _normalize_tiles(raw, K, B, min_bin, min_deriv)
    inside = torch.abs(y) <= B
    yc = clip(y, -B, B)
    x0, w, y0, h, d0, d1 = _select_bin_params(yc, yk, xk, yk, dk, K)

    s = h / w
    dy = yc - y0
    t = d1 + d0 - 2.0 * s
    a = h * (s - d0) + dy * t
    b = h * d0 - dy * t
    c = -s * dy
    disc = b * b - 4.0 * a * c
    disc = torch.maximum(disc, torch.zeros_like(disc))
    xi = 2.0 * c / (-b - torch.sqrt(disc))
    xi = clip(xi, 0.0, 1.0)
    x = x0 + w * xi

    xi1m = 1.0 - xi
    q = xi * xi1m
    denom = s + t * q
    deriv_num = s * s * (d1 * xi * xi + 2.0 * s * q + d0 * xi1m * xi1m)
    ladj = 2.0 * torch.log(denom) - torch.log(deriv_num)
    return torch.where(inside, x, y), torch.where(inside, ladj, 0.0)


def _knots_of(raw):
    P = raw.shape[-1]
    if P % 3 != 2 or P < 5:
        raise ValueError(f"raw must end in 3K-1 spline parameters with "
                         f"K >= 2, got {P}")
    return (P + 1) // 3


def plain_eval(x, raw, range_limit=DEFAULT_RANGE, inverse=False):
    """The plain version of K4 on any device: (y, ladj), each x's shape."""
    K = _knots_of(raw)
    fn = _inv_tile_math if inverse else _fwd_tile_math
    return fn(x, [raw[..., p] for p in range(raw.shape[-1])], K,
              float(range_limit), DEFAULT_MIN_BIN, DEFAULT_MIN_DERIV)


def plain_grad(x, raw, gy, gl, range_limit=DEFAULT_RANGE, inverse=False):
    """The plain version of K5: (dx, draw), the autograd pullback of
    `plain_eval` with cotangents (gy, gl)."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        rg = raw.detach().requires_grad_(True)
        y, ladj = plain_eval(xg, rg, range_limit, inverse)
        dx, draw = torch.autograd.grad((y, ladj), (xg, rg), (gy, gl))
    return dx, draw


# ---------------------------------------------------------------------------
# The kernels and their wrappers
# ---------------------------------------------------------------------------
def _check(x, raw, *cots):
    """Shapes, devices and dtypes of a call, for the plain version and the
    kernels alike (one floating dtype for all; any K >= 2); returns K."""
    K = _knots_of(raw)
    if tuple(raw.shape[:-1]) != tuple(x.shape):
        raise ValueError(f"raw {tuple(raw.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if not x.dtype.is_floating_point:
        raise TypeError(f"the spline takes floating tensors, got {x.dtype}")
    for t in (x, raw, *cots):
        if t.device != x.device:
            raise ValueError(f"a tensor is on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"a tensor is {t.dtype}, x {x.dtype}")
    for t in cots:
        if t.shape != x.shape:
            raise ValueError(f"cotangent {tuple(t.shape)} does not match x "
                             f"{tuple(x.shape)}")
    return K


def _check_kernel(name, *ts):
    """What the kernels take besides: float32, contiguous."""
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"the spline kernels take float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _eval_call(entry, x, raw, range_limit, inverse):
    """Entry point `entry` of K4's library: (y, ladj)."""
    K = _check(x, raw)
    _check_kernel("K4", x, raw)
    spline_plan(K, False)
    lib = LIBRARY.load()
    y = torch.empty_like(x)
    ladj = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = getattr(lib, entry)(
            x.data_ptr(), raw.data_ptr(), y.data_ptr(), ladj.data_ptr(),
            x.numel(), K, float(range_limit), int(inverse), _stream(x))
    if rc != 0:
        raise RuntimeError(f"{entry} (K4) launch failed: cudaError {rc}")
    return y, ladj


def _launch_eval(x, raw, range_limit, inverse):
    y, ladj = _eval_call("rqs_eval_f32", x, raw, range_limit, inverse)
    LAUNCHES["k4_inverse" if inverse else "k4_forward"] += 1
    return y, ladj


def earlier_spline_eval(x, raw, range_limit=DEFAULT_RANGE, inverse=False):
    """The one-thread K4 (`rqs_eval_kernel`, entry point
    `rqs_eval_thread_f32`) that the group kernel replaced, on CUDA float32
    tensors: `chip_smoke.py`'s oracle and yardstick for K4. On no path,
    and not counted in LAUNCHES."""
    if x.device.type != "cuda":
        raise ValueError("the one-thread K4 takes CUDA tensors")
    return _eval_call("rqs_eval_thread_f32", x, raw, range_limit, inverse)


def _grad_call(entry, x, raw, gy, gl, range_limit, inverse, draw):
    """Entry point `entry` of K5's library: (dx, draw), draw written into
    `draw` where given (contiguous, raw's shape and dtype; chip_smoke.py
    passes a view at an offset), else into a new tensor."""
    K = _check(x, raw, gy, gl)
    _check_kernel("K5", x, raw, gy, gl)
    spline_plan(K, True)
    if draw is None:
        draw = torch.empty_like(raw)
    else:
        _check(x, draw)
        _check_kernel("K5", draw)
    lib = LIBRARY.load()
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = getattr(lib, entry)(
            x.data_ptr(), raw.data_ptr(), gy.data_ptr(), gl.data_ptr(),
            dx.data_ptr(), draw.data_ptr(), x.numel(), K, float(range_limit),
            int(inverse), _stream(x))
    if rc != 0:
        raise RuntimeError(f"{entry} (K5) launch failed: cudaError {rc}")
    return dx, draw


def _launch_grad(x, raw, gy, gl, range_limit, inverse, draw=None):
    dx, draw = _grad_call("rqs_grad_f32", x, raw, gy, gl, range_limit,
                          inverse, draw)
    LAUNCHES["k5_inverse" if inverse else "k5_forward"] += 1
    return dx, draw


def earlier_spline_grad(x, raw, gy, gl, range_limit=DEFAULT_RANGE,
                        inverse=False, draw=None):
    """The one-thread K5 (`rqs_grad_kernel`, entry point
    `rqs_grad_thread_f32`) that the group kernel replaced, on CUDA float32
    tensors: `chip_smoke.py`'s oracle and yardstick for K5. On no path,
    and not counted in LAUNCHES."""
    if x.device.type != "cuda":
        raise ValueError("the one-thread K5 takes CUDA tensors")
    return _grad_call("rqs_grad_thread_f32", x, raw, gy, gl, range_limit,
                      inverse, draw)


def spline_eval(x, raw, range_limit=DEFAULT_RANGE, inverse=False):
    """(y, ladj) of the forward or inverse spline: the plain version for a
    CPU tensor (in its dtype), K4 for a CUDA float32 tensor."""
    if x.device.type == "cpu":
        _check(x, raw)
        return plain_eval(x, raw, range_limit, inverse)
    if x.device.type == "cuda":
        return _launch_eval(x, raw, range_limit, inverse)
    raise ValueError(f"no spline kernel for device {x.device}")


def spline_grad(x, raw, gy, gl, range_limit=DEFAULT_RANGE, inverse=False):
    """(dx, draw) of the spline's pullback: the plain version for a CPU
    tensor (in its dtype), K5 for a CUDA float32 tensor."""
    if x.device.type == "cpu":
        _check(x, raw, gy, gl)
        return plain_grad(x, raw, gy, gl, range_limit, inverse)
    if x.device.type == "cuda":
        return _launch_grad(x, raw, gy, gl, range_limit, inverse)
    raise ValueError(f"no spline kernel for device {x.device}")


class RQSSpline(torch.autograd.Function):
    """(y, ladj) = spline(x; raw), forward or inverse; its backward
    recomputes the spline in K5 from (x, raw) and the cotangents."""

    @staticmethod
    def forward(ctx, x, raw, range_limit, inverse):
        x, raw = x.contiguous(), raw.contiguous()
        ctx.save_for_backward(x, raw)
        ctx.range_limit, ctx.inverse = range_limit, inverse
        return spline_eval(x, raw, range_limit, inverse)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy, gl):
        x, raw = ctx.saved_tensors
        dx, draw = spline_grad(x, raw, gy.contiguous(), gl.contiguous(),
                               ctx.range_limit, ctx.inverse)
        return dx, draw, None, None


def rqs_forward_from_raw(x, raw, range_limit: float = DEFAULT_RANGE):
    """Drop-in for `flows.rqs_ref.rqs_forward_from_raw` (K4 / K5)."""
    return RQSSpline.apply(x, raw, float(range_limit), False)


def rqs_inverse_from_raw(y, raw, range_limit: float = DEFAULT_RANGE):
    """Drop-in for `flows.rqs_ref.rqs_inverse_from_raw` (K4 / K5)."""
    return RQSSpline.apply(y, raw, float(range_limit), True)
