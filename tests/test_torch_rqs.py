"""The rational-quadratic spline of the port against the JAX package, on the
same numpy inputs, and the hand-written pullback of K4/K5 against autograd.

  * the oracle `tpuflows_torch.flows.rqs_ref` against `tpuflows.flows.
    rqs_ref`: values to 1e-5 (float32, the same formulas; softmax and
    exp implementations differ in the last bits), gradients to the JAX
    package's own bar for its spline (tests/test_pallas.py: jnp.allclose,
    atol 1e-4);
  * the plain version of K4/K5 (`kernels/rqs_cuda.py` tile math and its
    autograd pullback) against `tpuflows.kernels.rqs_pallas` run as the
    JAX package's tests run it on the CPU (Pallas interpret mode), values
    and custom_vjp gradients, jnp.allclose atol 1e-4;
  * `mirror_vjp`, the pullbacks of `csrc/rqs_math.cuh` written out line by
    line in torch, against autograd on the plain version at points inside
    the bins, exactly on the knots, on +-B and in the tails: the same
    float32 operations in another order, so 1e-5 relative, and the JAX
    bar's 1e-4 absolute for the draw entries that cancel to about 0 (at a
    knot the two orders differ there by up to ~2e-5); 2e-4 relative where
    the K5 output is an ill-conditioned float32 quantity, named in the
    test;
  * the wrapper on the CPU runs the plain version and counts no launch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows.flows import rqs_ref as j_ref
from tpuflows.kernels import rqs_pallas as j_pallas

from tpuflows_torch.flows import rqs_ref
from tpuflows_torch.flows.rqs_ref import (DEFAULT_MIN_BIN,
                                          DEFAULT_MIN_DERIV, _SOFTPLUS_UNIT)
from tpuflows_torch.kernels import rqs_cuda

JAX_BAR = dict(atol=1e-4, rtol=1e-5)  # jnp.allclose(atol=1e-4)


def _inputs(seed, shape, K=8, scale=6.0):
    rng = np.random.default_rng(seed)
    x = (scale * rng.normal(size=shape)).astype(np.float32)
    raw = rng.normal(size=(*shape, 3 * K - 1)).astype(np.float32)
    gy = rng.normal(size=shape).astype(np.float32)
    gl = rng.normal(size=shape).astype(np.float32)
    return x, raw, gy, gl


def _torch_grads(fn, x, raw, gy, gl):
    xt = torch.from_numpy(x).requires_grad_(True)
    rt = torch.from_numpy(raw).requires_grad_(True)
    y, ladj = fn(xt, rt)
    dx, draw = torch.autograd.grad((y, ladj), (xt, rt),
                                   (torch.from_numpy(gy),
                                    torch.from_numpy(gl)))
    return y.detach().numpy(), ladj.detach().numpy(), dx.numpy(), draw.numpy()


def _jax_grads(fn, x, raw, gy, gl):
    (y, ladj), pull = jax.vjp(fn, jnp.asarray(x), jnp.asarray(raw))
    dx, draw = pull((jnp.asarray(gy), jnp.asarray(gl)))
    return tuple(np.asarray(a) for a in (y, ladj, dx, draw))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape,K", [((64, 8), 8), ((33, 3), 8),
                                     ((16, 4), 4), ((12, 5), 12)])
def test_oracle_matches_jax(shape, K, inverse):
    x, raw, gy, gl = _inputs(hash((shape, K)) % 1000, shape, K)
    name = "rqs_inverse_from_raw" if inverse else "rqs_forward_from_raw"
    got = _torch_grads(getattr(rqs_ref, name), x, raw, gy, gl)
    want = _jax_grads(getattr(j_ref, name), x, raw, gy, gl)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_allclose(a, b, **JAX_BAR)


def test_normalized_knots_match_jax():
    _, raw, _, _ = _inputs(3, (20, 6), 8)
    got = rqs_ref.normalize_params(torch.from_numpy(raw))
    want = j_ref.normalize_params(jnp.asarray(raw))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    assert float(got.xk[..., -1].min()) == rqs_ref.DEFAULT_RANGE


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape,K", [((64, 8), 8), ((33, 3), 8),
                                     ((16, 4), 4), ((7, 9), 12)])
def test_tile_math_matches_pallas_interpret(shape, K, inverse):
    """K4/K5's plain version against the JAX Pallas kernel (interpret mode
    on the CPU): values and the custom_vjp gradients."""
    x, raw, gy, gl = _inputs(100 + K + shape[0], shape, K)

    def plain(xt, rt):
        return rqs_cuda.plain_eval(xt, rt, 4.0, inverse)

    name = "rqs_inverse_from_raw" if inverse else "rqs_forward_from_raw"
    got = _torch_grads(plain, x, raw, gy, gl)
    want = _jax_grads(getattr(j_pallas, name), x, raw, gy, gl)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **JAX_BAR)


# ---------------------------------------------------------------------------
# csrc/rqs_math.cuh, line by line
# ---------------------------------------------------------------------------
def _softplus(x):
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def _clip_grad(v, lo, hi):
    inner = (v > lo) & (v < hi)
    tie = (v == lo) | (v == hi)
    return torch.where(inner, 1.0, torch.where(tie, 0.5, 0.0))


def _normalize(r, K):
    mw, mh = r[..., 0], r[..., K]
    for k in range(1, K):
        mw = torch.maximum(mw, r[..., k])
        mh = torch.maximum(mh, r[..., K + k])
    tw = torch.zeros_like(mw)
    th = torch.zeros_like(mh)
    for k in range(K):
        tw = tw + torch.exp(r[..., k] - mw)
        th = th + torch.exp(r[..., K + k] - mh)
    return mw, 1.0 / tw, mh, 1.0 / th


def _select_bin(t, r, K, B, n, by_y):
    mw, iw, mh, ih = n
    cw = 1.0 - 1e-3 * K
    xk = torch.full_like(t, -B)
    yk = torch.full_like(t, -B)
    dk = torch.ones_like(t)
    bin_ = [None] * 7
    for k in range(K):
        last = k == K - 1
        wk = DEFAULT_MIN_BIN + cw * (torch.exp(r[..., k] - mw) * iw)
        hk = DEFAULT_MIN_BIN + cw * (torch.exp(r[..., K + k] - mh) * ih)
        xn = torch.full_like(t, B) if last else xk + 2.0 * B * wk
        yn = torch.full_like(t, B) if last else yk + 2.0 * B * hk
        dn = (torch.ones_like(t) if last else DEFAULT_MIN_DERIV
              + _softplus(r[..., 2 * K + k] + _SOFTPLUS_UNIT))
        take = (torch.ones_like(t, dtype=torch.bool) if k == 0
                else t >= (yk if by_y else xk))
        new = (xk, xn - xk, yk, yn - yk, dk, dn,
               torch.full_like(t, float(k)))
        bin_ = [v if b is None else torch.where(take, v, b)
                for v, b in zip(new, bin_)]
        xk, yk, dk = xn, yn, dn
    return bin_


def _knots_vjp(r, K, B, n, bin_, g_x0, g_w, g_y0, g_h, g_d0, g_d1):
    mw, iw, mh, ih = n
    b = bin_[6]
    inner = b + 1 < K
    gxb, gxn = g_x0 - g_w, torch.where(inner, g_w, 0.0)
    gyb, gyn = g_y0 - g_h, torch.where(inner, g_h, 0.0)
    sw_lt = torch.zeros_like(b)
    sh_lt = torch.zeros_like(b)
    sw_b = torch.zeros_like(b)
    sh_b = torch.zeros_like(b)
    for i in range(K):
        sw = torch.exp(r[..., i] - mw) * iw
        sh = torch.exp(r[..., K + i] - mh) * ih
        sw_lt = torch.where(i < b, sw_lt + sw, sw_lt)
        sh_lt = torch.where(i < b, sh_lt + sh, sh_lt)
        sw_b = torch.where(b == i, sw, sw_b)
        sh_b = torch.where(b == i, sh, sh_b)
    c2 = (1.0 - 1e-3 * K) * 2.0 * B
    dot_w = c2 * (gxb * sw_lt + gxn * (sw_lt + sw_b))
    dot_h = c2 * (gyb * sh_lt + gyn * (sh_lt + sh_b))
    draw = torch.zeros_like(r)
    for i in range(K):
        sw = torch.exp(r[..., i] - mw) * iw
        sh = torch.exp(r[..., K + i] - mh) * ih
        gsw = c2 * (torch.where(i < b, gxb, 0.0)
                    + torch.where(i <= b, gxn, 0.0))
        gsh = c2 * (torch.where(i < b, gyb, 0.0)
                    + torch.where(i <= b, gyn, 0.0))
        draw[..., i] = sw * (gsw - dot_w)
        draw[..., K + i] = sh * (gsh - dot_h)
    for k in range(1, K):
        u = r[..., 2 * K + k - 1] + _SOFTPLUS_UNIT
        gd = (torch.where(b == k, g_d0, 0.0)
              + torch.where(b + 1 == k, g_d1, 0.0))
        draw[..., 2 * K + k - 1] = gd * torch.exp(u - _softplus(u))
    return draw


def _forward_vjp(x, r, K, B, gy, gl):
    n = _normalize(r, K)
    x0, w, y0, h, d0, d1, _ = bin_ = _select_bin(x, r, K, B, n, False)
    s = h / w
    xi = (x - x0) / w
    xi1m = 1.0 - xi
    q = xi * xi1m
    t = d1 + d0 - 2.0 * s
    denom = s + t * q
    A = s * xi * xi + d0 * q
    hA = h * A
    C = d1 * xi * xi + 2.0 * s * q + d0 * xi1m * xi1m
    num = s * s * C
    g_y0 = gy
    g_hA = gy / denom
    g_denom = -g_hA * (hA / denom)
    g_h = g_hA * A
    g_A = g_hA * h
    g_num = gl / num
    g_denom = g_denom - 2.0 * gl / denom
    g_s = g_num * 2.0 * s * C
    g_C = g_num * s * s
    g_d1 = g_C * xi * xi
    g_xi = g_C * 2.0 * d1 * xi
    g_s = g_s + g_C * 2.0 * q
    g_q = g_C * 2.0 * s
    g_d0 = g_C * xi1m * xi1m
    g_xi1m = g_C * 2.0 * d0 * xi1m
    g_s = g_s + g_A * xi * xi
    g_xi = g_xi + g_A * 2.0 * s * xi
    g_d0 = g_d0 + g_A * q
    g_q = g_q + g_A * d0
    g_s = g_s + g_denom
    g_t = g_denom * q
    g_q = g_q + g_denom * t
    g_d1 = g_d1 + g_t
    g_d0 = g_d0 + g_t
    g_s = g_s - 2.0 * g_t
    g_xi = g_xi + g_q * xi1m
    g_xi1m = g_xi1m + g_q * xi
    g_xi = g_xi - g_xi1m
    g_x = g_xi / w
    g_x0 = -g_xi / w
    g_w = -g_xi * xi / w
    g_h = g_h + g_s / w
    g_w = g_w - g_s * s / w
    dx = g_x * _clip_grad(x, -B, B)
    return dx, _knots_vjp(r, K, B, n, bin_, g_x0, g_w, g_y0, g_h, g_d0,
                          g_d1)


def _inverse_vjp(y, r, K, B, gx, gl):
    n = _normalize(r, K)
    x0, w, y0, h, d0, d1, _ = bin_ = _select_bin(y, r, K, B, n, True)
    s = h / w
    dy = y - y0
    t = d1 + d0 - 2.0 * s
    a = h * (s - d0) + dy * t
    bq = h * d0 - dy * t
    c = -s * dy
    disc_raw = bq * bq - 4.0 * a * c
    sq = torch.sqrt(torch.clamp(disc_raw, min=0.0))
    den = -bq - sq
    xi_raw = 2.0 * c / den
    xi = torch.clamp(xi_raw, 0.0, 1.0)
    xi1m = 1.0 - xi
    q = xi * xi1m
    denom = s + t * q
    C = d1 * xi * xi + 2.0 * s * q + d0 * xi1m * xi1m
    num = s * s * C
    g_x0 = gx
    g_w = gx * xi
    g_xi = gx * w
    g_denom = 2.0 * gl / denom
    g_num = -gl / num
    g_s = g_num * 2.0 * s * C
    g_C = g_num * s * s
    g_d1 = g_C * xi * xi
    g_xi = g_xi + g_C * 2.0 * d1 * xi
    g_s = g_s + g_C * 2.0 * q
    g_q = g_C * 2.0 * s
    g_d0 = g_C * xi1m * xi1m
    g_xi1m = g_C * 2.0 * d0 * xi1m
    g_s = g_s + g_denom
    g_t = g_denom * q
    g_q = g_q + g_denom * t
    g_xi = g_xi + g_q * xi1m
    g_xi1m = g_xi1m + g_q * xi
    g_xi = g_xi - g_xi1m
    g_xr = g_xi * _clip_grad(xi_raw, 0.0, 1.0)
    g_c = g_xr * 2.0 / den
    g_den = -g_xr * xi_raw / den
    g_bq = -g_den
    g_disc = torch.where(sq > 0.0, -g_den * 0.5 / sq, 0.0)
    g_dr = g_disc * torch.where(disc_raw > 0.0, 1.0,
                                torch.where(disc_raw == 0.0, 0.5, 0.0))
    g_bq = g_bq + g_dr * 2.0 * bq
    g_a = -g_dr * 4.0 * c
    g_c = g_c - g_dr * 4.0 * a
    g_s = g_s - g_c * dy
    g_dy = -g_c * s
    g_h = g_bq * d0
    g_d0 = g_d0 + g_bq * h
    g_dy = g_dy - g_bq * t
    g_t = g_t - g_bq * dy
    g_h = g_h + g_a * (s - d0)
    g_s = g_s + g_a * h
    g_d0 = g_d0 - g_a * h
    g_dy = g_dy + g_a * t
    g_t = g_t + g_a * dy
    g_d1 = g_d1 + g_t
    g_d0 = g_d0 + g_t
    g_s = g_s - 2.0 * g_t
    g_y0 = -g_dy
    g_h = g_h + g_s / w
    g_w = g_w - g_s * s / w
    dy_out = g_dy * _clip_grad(y, -B, B)
    return dy_out, _knots_vjp(r, K, B, n, bin_, g_x0, g_w, g_y0, g_h, g_d0,
                              g_d1)


def mirror_vjp(x, raw, gy, gl, B, inverse):
    """`rqs_forward_vjp` / `rqs_inverse_vjp` of csrc/rqs_math.cuh on
    (..., d) tensors: (dx, draw). Outside [-B, B] the identity."""
    K = (raw.shape[-1] + 1) // 3
    inside = x.abs() <= B
    xc = torch.where(inside, x, torch.zeros_like(x))  # the branch not taken
    fn = _inverse_vjp if inverse else _forward_vjp
    dx, draw = fn(xc, raw, K, B, gy, gl)
    return (torch.where(inside, dx, gy),
            torch.where(inside[..., None], draw, torch.zeros_like(draw)))


def _knot_points(raw, K, B, inverse, n_rows):
    """One element per row, exactly on knot k = row % (K + 1) (-B and B
    included), as the tile math computes the knots."""
    r = torch.from_numpy(raw)
    xk, yk, _ = rqs_cuda._normalize_tiles(
        [r[..., p] for p in range(3 * K - 1)], K, B, DEFAULT_MIN_BIN,
        DEFAULT_MIN_DERIV)
    ks = yk if inverse else xk
    pts = torch.stack([ks[i % (K + 1)][i] for i in range(n_rows)])
    return pts.numpy()


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("where", ["inside", "knots", "tails"])
@pytest.mark.parametrize("K", [4, 8])
def test_hand_written_pullback_matches_autograd(K, where, inverse):
    B, n = 4.0, 45
    x, raw, gy, gl = _inputs(7 * K + len(where), (n, 1), K)
    if where == "inside":
        x = np.random.default_rng(K).uniform(-3.9, 3.9, (n, 1)).astype(
            np.float32)
    elif where == "knots":
        x = _knot_points(raw, K, B, inverse, n)
    else:  # both tails, +-B and just inside
        x = np.resize(np.array([-6.5, -B, -3.9999, 3.9999, B, 5.0, 1e3],
                               np.float32), (n, 1))
    xt, rt, gyt, glt = (torch.from_numpy(a) for a in (x, raw, gy, gl))
    want = rqs_cuda.plain_grad(xt, rt, gyt, glt, B, inverse)
    got = mirror_vjp(xt, rt, gyt, glt, B, inverse)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("inverse", [False, True])
def test_hand_written_pullback_matches_autograd_at_scale(inverse):
    """Many elements with raw ~ N(0, 1): some bins are so narrow that dx
    and draw are ill-conditioned in float32 (both orders of the same
    operations move them by up to ~1e-4 relative), so the bar here is
    2e-4 relative on top of 1e-5 absolute."""
    x, raw, gy, gl = _inputs(11, (256, 8), 8)
    xt, rt, gyt, glt = (torch.from_numpy(a) for a in (x, raw, gy, gl))
    want = rqs_cuda.plain_grad(xt, rt, gyt, glt, 4.0, inverse)
    got = mirror_vjp(xt, rt, gyt, glt, 4.0, inverse)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("inverse", [False, True])
def test_cpu_wrapper_runs_plain_version_and_counts_no_launch(inverse):
    x, raw, gy, gl = _inputs(21, (32, 6), 8)
    before = dict(rqs_cuda.LAUNCHES)
    xt = torch.from_numpy(x).requires_grad_(True)
    rt = torch.from_numpy(raw).requires_grad_(True)
    fn = (rqs_cuda.rqs_inverse_from_raw if inverse
          else rqs_cuda.rqs_forward_from_raw)
    y, ladj = fn(xt, rt)
    py, pl = rqs_cuda.plain_eval(xt.detach(), rt.detach(), 4.0, inverse)
    torch.testing.assert_close(y.detach(), py, rtol=0, atol=0)
    torch.testing.assert_close(ladj.detach(), pl, rtol=0, atol=0)
    dx, draw = torch.autograd.grad((y, ladj), (xt, rt),
                                   (torch.from_numpy(gy),
                                    torch.from_numpy(gl)))
    pdx, pdraw = rqs_cuda.plain_grad(xt.detach(), rt.detach(),
                                     torch.from_numpy(gy),
                                     torch.from_numpy(gl), 4.0, inverse)
    torch.testing.assert_close(dx, pdx, rtol=0, atol=0)
    torch.testing.assert_close(draw, pdraw, rtol=0, atol=0)
    assert rqs_cuda.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "params", "device"])
def test_wrapper_rejects_bad_inputs(bad):
    x = torch.zeros(4, 3)
    raw = torch.zeros(4, 3, 23)
    err = ValueError
    if bad == "dtype":
        x, err = x.double(), TypeError
    elif bad == "shape":
        raw = torch.zeros(4, 2, 23)
    elif bad == "params":
        raw = torch.zeros(4, 3, 22)
    else:
        x = torch.zeros(4, 3, device="meta")
    with pytest.raises(err):
        rqs_cuda.spline_eval(x, raw)
