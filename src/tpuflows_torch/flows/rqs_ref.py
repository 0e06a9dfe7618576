"""Rational-quadratic spline transforms: the plain PyTorch oracle (port of
`tpuflows/flows/rqs_ref.py`; Durkan et al. 2019, eqs. 4-8 and 25-29).

This is the `use_pallas=False` tier of `RQSCouplingBlock`. The kernel tier
(`kernels/rqs_cuda.py`) computes the same function with the tile math of
`tpuflows/kernels/rqs_pallas.py`; the two agree to float32 rounding.

  - Branchless bin search: the bin is a one-hot over K half-open bins
    (the edge t == B goes to the last bin), and per-bin parameters are a
    one-hot sum.
  - Identity tails: outside [-B, B] the map is the identity (ladj 0). The
    input is clamped into range first, so the branch that is not taken
    stays finite and no NaN reaches the gradient through `where`.

Shapes: x is (..., d); raw params are (..., d, 3K-1) = K widths, K heights,
K-1 interior derivatives. The returned ladj is elementwise (..., d).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

DEFAULT_RANGE = 4.0  # B: the spline acts on [-B, B]
DEFAULT_MIN_BIN = 1e-3
DEFAULT_MIN_DERIV = 1e-3
_SOFTPLUS_UNIT = 0.5413248546129181  # softplus(x) = 1 at x = log(e - 1)


class SplineKnots(NamedTuple):
    """xk, yk: (..., d, K+1) monotone knots spanning [-B, B]; dk: (..., d,
    K+1) positive derivatives with dk[..., 0] = dk[..., -1] = 1."""

    xk: torch.Tensor
    yk: torch.Tensor
    dk: torch.Tensor


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as `jax.nn.softplus` computes it (logaddexp(x, 0)),
    with the exact gradient sigmoid(x)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """`jnp.clip`: max then min, whose gradient at a tie is split in half
    in both frameworks (`torch.clamp` would pass all of it)."""
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def _cumsum_small(x: torch.Tensor) -> torch.Tensor:
    """Sequential prefix sum over the small knot axis, left to right."""
    acc = x[..., :1]
    parts = [acc]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i:i + 1]
        parts.append(acc)
    return torch.cat(parts, dim=-1)


def normalize_params(raw: torch.Tensor,
                     range_limit: float = DEFAULT_RANGE,
                     min_bin: float = DEFAULT_MIN_BIN,
                     min_derivative: float = DEFAULT_MIN_DERIV
                     ) -> SplineKnots:
    """raw (..., d, 3K-1) -> monotone knots: softmax widths and heights,
    softplus derivatives."""
    K = (raw.shape[-1] + 1) // 3
    w_raw = raw[..., :K]
    h_raw = raw[..., K:2 * K]
    d_raw = raw[..., 2 * K:]

    B = range_limit
    widths = min_bin + (1.0 - min_bin * K) * torch.softmax(w_raw, dim=-1)
    heights = min_bin + (1.0 - min_bin * K) * torch.softmax(h_raw, dim=-1)

    zero = torch.zeros_like(w_raw[..., :1])
    xk = -B + 2.0 * B * _cumsum_small(torch.cat([zero, widths], dim=-1))
    yk = -B + 2.0 * B * _cumsum_small(torch.cat([zero, heights], dim=-1))
    # pin the end knot exactly to +B (cumsum roundoff)
    endp = torch.full_like(xk[..., :1], B)
    xk = torch.cat([xk[..., :-1], endp], dim=-1)
    yk = torch.cat([yk[..., :-1], endp], dim=-1)

    d_int = min_derivative + softplus(d_raw + _SOFTPLUS_UNIT)
    one = torch.ones_like(d_raw[..., :1])
    dk = torch.cat([one, d_int, one], dim=-1)
    return SplineKnots(xk=xk, yk=yk, dk=dk)


def _select_bin(t: torch.Tensor, knots: torch.Tensor) -> torch.Tensor:
    """One-hot (..., d, K) of the half-open bin holding t (clamped into
    [-B, B]); t == B goes to the last bin."""
    K = knots.shape[-1] - 1
    ge_lo = t[..., None] >= knots[..., :-1]
    lt_hi = t[..., None] < knots[..., 1:]
    onehot = ge_lo & lt_hi
    none_hot = ~torch.any(onehot, dim=-1, keepdim=True)
    last = torch.arange(K, device=t.device) == K - 1
    onehot = onehot | (none_hot & last)
    return onehot.to(t.dtype)


def _gather(onehot: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.sum(onehot * v, dim=-1)


def rqs_forward(x: torch.Tensor, knots: SplineKnots):
    """Forward spline: (y, elementwise log|dy/dx|)."""
    xk, yk, dk = knots
    B = xk[..., -1]
    inside = torch.abs(x) <= B
    xc = clip(x, -B, B)

    onehot = _select_bin(xc, xk)
    x0 = _gather(onehot, xk[..., :-1])
    w = _gather(onehot, xk[..., 1:] - xk[..., :-1])
    y0 = _gather(onehot, yk[..., :-1])
    h = _gather(onehot, yk[..., 1:] - yk[..., :-1])
    d0 = _gather(onehot, dk[..., :-1])
    d1 = _gather(onehot, dk[..., 1:])

    s = h / w
    xi = (xc - x0) / w
    xi1m = 1.0 - xi
    q = xi * xi1m
    denom = s + (d1 + d0 - 2.0 * s) * q
    y = y0 + h * (s * xi * xi + d0 * q) / denom
    deriv_num = s * s * (d1 * xi * xi + 2.0 * s * q + d0 * xi1m * xi1m)
    ladj = torch.log(deriv_num) - 2.0 * torch.log(denom)

    y = torch.where(inside, y, x)
    ladj = torch.where(inside, ladj, torch.zeros_like(ladj))
    return y, ladj


def rqs_inverse(y: torch.Tensor, knots: SplineKnots):
    """Analytic inverse spline: (x, elementwise log|dx/dy|)."""
    xk, yk, dk = knots
    B = yk[..., -1]
    inside = torch.abs(y) <= B
    yc = clip(y, -B, B)

    onehot = _select_bin(yc, yk)
    x0 = _gather(onehot, xk[..., :-1])
    w = _gather(onehot, xk[..., 1:] - xk[..., :-1])
    y0 = _gather(onehot, yk[..., :-1])
    h = _gather(onehot, yk[..., 1:] - yk[..., :-1])
    d0 = _gather(onehot, dk[..., :-1])
    d1 = _gather(onehot, dk[..., 1:])

    s = h / w
    dy = yc - y0
    t = d1 + d0 - 2.0 * s
    # Durkan et al. eqs. 25-29: the stable root of a xi^2 + b xi + c = 0
    a = h * (s - d0) + dy * t
    b = h * d0 - dy * t
    c = -s * dy
    disc = b * b - 4.0 * a * c
    disc = torch.maximum(disc, torch.zeros_like(disc))  # roundoff at edges
    xi = 2.0 * c / (-b - torch.sqrt(disc))
    xi = clip(xi, 0.0, 1.0)
    x = x0 + w * xi

    xi1m = 1.0 - xi
    q = xi * xi1m
    denom = s + t * q
    deriv_num = s * s * (d1 * xi * xi + 2.0 * s * q + d0 * xi1m * xi1m)
    ladj = 2.0 * torch.log(denom) - torch.log(deriv_num)

    x = torch.where(inside, x, y)
    ladj = torch.where(inside, ladj, torch.zeros_like(ladj))
    return x, ladj


def rqs_forward_from_raw(x, raw, range_limit: float = DEFAULT_RANGE):
    return rqs_forward(x, normalize_params(raw, range_limit))


def rqs_inverse_from_raw(y, raw, range_limit: float = DEFAULT_RANGE):
    return rqs_inverse(y, normalize_params(raw, range_limit))
