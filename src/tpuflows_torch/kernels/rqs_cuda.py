"""K4 and K5 on Hopper: the elementwise rational-quadratic spline and its
pullback (port of `tpuflows/kernels/rqs_pallas.py`).

  * the plain PyTorch version: `_normalize_tiles`, `_select_bin_params`,
    `_fwd_tile_math` and `_inv_tile_math`, the Pallas tile math written in
    torch on lists of same-shaped tensors (one per spline parameter), and
    its pullback by torch.autograd (`plain_eval`, `plain_grad`);
  * K4 and K5, hand-written CUDA (`csrc/rqs_spline.cu`, math in
    `csrc/rqs_math.cuh`): one thread per element, forward or inverse;
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
MAX_KNOTS = 64


def _bind(lib):
    p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
    lib.rqs_eval_f32.argtypes = [p] * 4 + [i64, i32, f32, i32, p]
    lib.rqs_eval_f32.restype = i32
    lib.rqs_grad_f32.argtypes = [p] * 6 + [i64, i32, f32, i32, p]
    lib.rqs_grad_f32.restype = i32


LIBRARY = CudaLibrary("rqs_spline", "rqs_spline.cu", [("rqs_spline", [])],
                      ["rqs_math.cuh"], _bind)


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
    K = _knots_of(raw)
    if K > MAX_KNOTS:
        raise ValueError(f"the kernels take at most {MAX_KNOTS} knots")
    if tuple(raw.shape[:-1]) != tuple(x.shape):
        raise ValueError(f"raw {tuple(raw.shape)} does not match x "
                         f"{tuple(x.shape)}")
    for t in (x, raw, *cots):
        if t.dtype != torch.float32:
            raise TypeError(f"the spline kernels take float32, got "
                            f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"a tensor is on {t.device}, x on {x.device}")
    for t in cots:
        if t.shape != x.shape:
            raise ValueError(f"cotangent {tuple(t.shape)} does not match x "
                             f"{tuple(x.shape)}")
    return K


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launched(rc, name, key):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[key] += 1


def _launch_eval(x, raw, range_limit, inverse):
    K = _check(x, raw)
    for t in (x, raw):
        if not t.is_contiguous():
            raise ValueError("K4 takes contiguous tensors")
    lib = LIBRARY.load()
    y = torch.empty_like(x)
    ladj = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.rqs_eval_f32(x.data_ptr(), raw.data_ptr(), y.data_ptr(),
                              ladj.data_ptr(), x.numel(), K,
                              float(range_limit), int(inverse), _stream(x))
    _launched(rc, "rqs_eval_f32 (K4)",
              "k4_inverse" if inverse else "k4_forward")
    return y, ladj


def _launch_grad(x, raw, gy, gl, range_limit, inverse):
    K = _check(x, raw, gy, gl)
    for t in (x, raw, gy, gl):
        if not t.is_contiguous():
            raise ValueError("K5 takes contiguous tensors")
    lib = LIBRARY.load()
    dx = torch.empty_like(x)
    draw = torch.empty_like(raw)
    with torch.cuda.device(x.device):
        rc = lib.rqs_grad_f32(x.data_ptr(), raw.data_ptr(), gy.data_ptr(),
                              gl.data_ptr(), dx.data_ptr(), draw.data_ptr(),
                              x.numel(), K, float(range_limit), int(inverse),
                              _stream(x))
    _launched(rc, "rqs_grad_f32 (K5)",
              "k5_inverse" if inverse else "k5_forward")
    return dx, draw


def spline_eval(x, raw, range_limit=DEFAULT_RANGE, inverse=False):
    """(y, ladj) of the forward or inverse spline: the plain version for a
    CPU tensor, K4 for a CUDA tensor."""
    if x.device.type == "cpu":
        _check(x, raw)
        return plain_eval(x, raw, range_limit, inverse)
    if x.device.type == "cuda":
        return _launch_eval(x, raw, range_limit, inverse)
    raise ValueError(f"no spline kernel for device {x.device}")


def spline_grad(x, raw, gy, gl, range_limit=DEFAULT_RANGE, inverse=False):
    """(dx, draw) of the spline's pullback: the plain version for a CPU
    tensor, K5 for a CUDA tensor."""
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
