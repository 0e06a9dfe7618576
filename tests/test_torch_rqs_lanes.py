"""K4's and K5's group kernels (csrc/rqs_lanes.cuh, `eval_lanes`,
`grad_lanes`) in torch, on the CPU: the design that the card runs, held to
the one-thread kernels and to the JAX package.

  * `lanes_vjp` mirrors K5's kernel with the lane axis as a tensor
    dimension: each lane's own bins (k = l, l + L, ...), the group maxima
    as xor exchanges along the lane axis, the rows of exponentials and
    derivatives that the lanes write to shared memory and every lane reads
    back as gathers along it, the sums that rqs_math.cuh orders as loops
    in its order, every lane walking the knots with the running select
    (the last knot's step apart), the bin's derivatives and softmax
    outputs read from the rows after the walk, each lane writing its own
    bins' cotangents. In float32 it equals `mirror_vjp`
    (tests/test_torch_rqs.py, the line-by-line mirror of rqs_math.cuh's
    one-thread pullback) to the bit at K = 2, 4, 8, 12, 24 and 64, on
    elements inside the bins, exactly on the knots, on +-B and outside
    [-B, B]. Both round every operation as written; which products nvcc
    contracts into fmas is held to the one-thread kernel's on the card
    (chip_smoke.py `k5_vs_earlier`);
  * `lanes_eval` mirrors K4's kernel the same way, at K4's own bins a
    lane: the maxima, the exponentials (in rows that the lanes share, or
    at one lane an element, K <= 8, in registers, the bins past K zero),
    the softmax sums in knot order, the walk, then the bin's two
    derivatives computed from their raw values after the walk, the bin
    evaluated on every lane and lane 0 writing y and ladj; it equals
    `mirror_eval` (the line-by-line mirror
    of rqs_math.cuh's one-thread `rqs_forward` / `rqs_inverse`) to the bit
    at the same K and points (chip_smoke.py `k4_vs_earlier` on the card),
    and a mutation of the order of the softmax sums breaks that;
  * both match the JAX package's `_pallas_grad` / `_pallas_eval` (Pallas
    interpret mode, as tests/test_torch_rqs.py runs them) within that
    file's JAX_BAR;
  * the block layouts (`rqs_cuda.lane_layout`, the host's copy of the
    kernels' constants, and `row_stride` / `eval_stride` below): L and the
    bins a lane holds against K, every raw value owned by one lane, each
    block's span 16-byte aligned, the rows behind it aligned and spread
    over the banks, a block's shared memory, and a ragged last block.
"""
import jax.numpy as jnp  # JAX on the CPU, as conftest sets
import numpy as np
import pytest
import torch

from tpuflows.kernels import rqs_pallas as j_pallas

from tpuflows_torch.flows.rqs_ref import (DEFAULT_MIN_BIN,
                                          DEFAULT_MIN_DERIV, _SOFTPLUS_UNIT)
from tpuflows_torch.kernels import rqs_cuda

from test_torch_rqs import (JAX_BAR, _forward_local, _inputs,
                            _inverse_local, _jax_grads, _knot_points,
                            _softplus, _torch_grads, mirror_eval,
                            mirror_vjp)

B = 4.0


def _bits(t):
    return t.contiguous().view(torch.int32)


def lanes_vjp(x, raw, gy, gl, B, inverse):
    """K5's group kernel on (..., d) tensors: (dx, draw)."""
    shape, P = x.shape, raw.shape[-1]
    K = (P + 1) // 3
    L, NB, _ = rqs_cuda.lane_layout(K)
    x, gy, gl = (t.reshape(-1) for t in (x, gy, gl))
    raw = raw.reshape(-1, P)
    N = x.numel()
    lanes = torch.arange(L)
    k_of = lanes[:, None] + L * torch.arange(NB)[None, :]  # (L, NB)
    held = k_of < K
    kc = k_of.clamp(max=K - 1)
    inf = torch.tensor(float("inf"))
    rw = torch.where(held, raw[:, kc], -inf)  # (N, L, NB)
    rh = torch.where(held, raw[:, K + kc], -inf)
    mw, mh = rw[..., 0], rh[..., 0]
    for j in range(1, NB):
        mw, mh = torch.fmax(mw, rw[..., j]), torch.fmax(mh, rh[..., j])
    o = L // 2
    while o:  # __shfl_xor_sync over the group
        mw = torch.fmax(mw, mw[:, lanes ^ o])
        mh = torch.fmax(mh, mh[:, lanes ^ o])
        o //= 2
    # the rows each lane writes for its own bins: exponentials, the
    # derivative at the left knot (row index k - 1), the softplus'
    # derivative over the raw value
    ew = torch.zeros((N, K))
    eh = torch.zeros((N, K))
    dr = torch.ones((N, K))  # dr[m]: the derivative at knot m + 1
    q = torch.zeros((N, K))
    for l in range(L):
        for j in range(NB):
            k = l + L * j
            if k >= K:
                continue
            ew[:, k] = torch.exp(rw[:, l, j] - mw[:, l])
            eh[:, k] = torch.exp(rh[:, l, j] - mh[:, l])
            if k >= 1:
                u = raw[:, 2 * K + k - 1] + _SOFTPLUS_UNIT
                sp = _softplus(u)
                dr[:, k - 1] = DEFAULT_MIN_DERIV + sp
                q[:, k] = torch.exp(u - sp)

    def row(a, k):  # every lane of the group reads row entry k
        return a[:, k, None].expand(N, L)

    tw = torch.zeros((N, L))
    th = torch.zeros((N, L))
    for k in range(K):
        tw = tw + row(ew, k)
        th = th + row(eh, k)
    iw, ih = 1.0 / tw, 1.0 / th

    t = x[:, None].expand(N, L)
    cw = 1.0 - 1e-3 * K
    xk = torch.full((N, L), -B)
    yk = torch.full((N, L), -B)
    pw = torch.zeros((N, L))
    ph = torch.zeros((N, L))
    cap = [None] * 7  # b, x0, x1, y0, y1, sw_lt, sh_lt
    for k in range(K - 1):
        sw, sh = row(ew, k) * iw, row(eh, k) * ih
        wk = DEFAULT_MIN_BIN + cw * sw
        hk = DEFAULT_MIN_BIN + cw * sh
        xn = xk + 2.0 * B * wk
        yn = yk + 2.0 * B * hk
        take = (torch.ones_like(t, dtype=torch.bool) if k == 0
                else t >= (yk if inverse else xk))
        new = (torch.full_like(t, float(k)), xk, xn, yk, yn, pw, ph)
        cap = [v if c is None else torch.where(take, v, c)
               for v, c in zip(new, cap)]
        pw, ph = pw + sw, ph + sh
        xk, yk = xn, yn
    take = t >= (yk if inverse else xk)  # the last bin
    new = (torch.full_like(t, float(K - 1)), xk, torch.full_like(t, B), yk,
           torch.full_like(t, B), pw, ph)
    b, x0, x1, y0, y1, sw_lt, sh_lt = (torch.where(take, v, c)
                                       for v, c in zip(new, cap))
    bi = b.long()
    d0 = torch.where(bi == 0, 1.0, torch.gather(dr, 1, (bi - 1).clamp(0)))
    d1 = torch.gather(dr, 1, bi)
    sw_b = torch.gather(ew, 1, bi) * iw
    sh_b = torch.gather(eh, 1, bi) * ih
    bin_ = (x0, x1 - x0, y0, y1 - y0, d0, d1, b)

    inside = t.abs() <= B
    gyv, glv = gy[:, None].expand(N, L), gl[:, None].expand(N, L)
    local = _inverse_local if inverse else _forward_local
    dt, g_x0, g_w, g_y0, g_h, g_d0, g_d1 = local(t, bin_, B, gyv, glv)
    inner = b + 1 < K
    gxb, gxn = g_x0 - g_w, torch.where(inner, g_w, 0.0)
    gyb, gyn = g_y0 - g_h, torch.where(inner, g_h, 0.0)
    c2 = (1.0 - 1e-3 * K) * 2.0 * B
    dot_w = c2 * (gxb * sw_lt + gxn * (sw_lt + sw_b))
    dot_h = c2 * (gyb * sh_lt + gyn * (sh_lt + sh_b))
    draw = torch.full((N, P), float("nan"))
    for l in range(L):
        for j in range(NB):
            k = l + L * j
            if k >= K:
                continue
            ins, bl = inside[:, l], b[:, l]
            sw, sh = ew[:, k] * iw[:, l], eh[:, k] * ih[:, l]
            gsw = c2 * (torch.where(k < bl, gxb[:, l], 0.0)
                        + torch.where(k <= bl, gxn[:, l], 0.0))
            gsh = c2 * (torch.where(k < bl, gyb[:, l], 0.0)
                        + torch.where(k <= bl, gyn[:, l], 0.0))
            draw[:, k] = torch.where(ins, sw * (gsw - dot_w[:, l]), 0.0)
            draw[:, K + k] = torch.where(ins, sh * (gsh - dot_h[:, l]), 0.0)
            if k >= 1:
                gd = (torch.where(bl == k, g_d0[:, l], 0.0)
                      + torch.where(bl + 1 == k, g_d1[:, l], 0.0))
                draw[:, 2 * K + k - 1] = torch.where(ins, gd * q[:, k], 0.0)
    dx = torch.where(inside[:, 0], dt[:, 0], gy)  # lane 0 writes dx
    return dx.reshape(shape), draw.reshape(*shape, P)


def lanes_eval(x, raw, B, inverse, reverse_sums=False):
    """K4's group kernel on (..., d) tensors: (y, ladj). `reverse_sums`
    takes the softmax denominators in reverse knot order, a mutation that
    the bitwise test must catch."""
    shape, P = x.shape, raw.shape[-1]
    K = (P + 1) // 3
    L, NB, _ = rqs_cuda.lane_layout(K, rqs_cuda.EVAL_LANE_BINS)
    x = x.reshape(-1)
    raw = raw.reshape(-1, P)
    N = x.numel()
    lanes = torch.arange(L)
    k_of = lanes[:, None] + L * torch.arange(NB)[None, :]  # (L, NB)
    held = k_of < K
    kc = k_of.clamp(max=K - 1)
    inf = torch.tensor(float("inf"))
    rw = torch.where(held, raw[:, kc], -inf)  # (N, L, NB)
    rh = torch.where(held, raw[:, K + kc], -inf)
    mw, mh = rw[..., 0], rh[..., 0]
    for j in range(1, NB):
        mw, mh = torch.fmax(mw, rw[..., j]), torch.fmax(mh, rh[..., j])
    o = L // 2
    while o:  # __shfl_xor_sync over the group
        mw = torch.fmax(mw, mw[:, lanes ^ o])
        mh = torch.fmax(mh, mh[:, lanes ^ o])
        o //= 2
    # the rows of exponentials each lane writes for its own bins
    ew = torch.zeros((N, K))
    eh = torch.zeros((N, K))
    for l in range(L):
        for j in range(NB):
            k = l + L * j
            if k < K:
                ew[:, k] = torch.exp(rw[:, l, j] - mw[:, l])
                eh[:, k] = torch.exp(rh[:, l, j] - mh[:, l])

    def row(a, k):  # every lane of the group reads row entry k
        return a[:, k, None].expand(N, L)

    # at one lane the kernel holds EVAL_LANE_BINS exponentials in
    # registers, those of bins k >= K zero, and sums all of them
    M = max(K, rqs_cuda.EVAL_LANE_BINS) if L == 1 else K
    ew = torch.cat([ew, torch.zeros((N, M - K))], 1)
    eh = torch.cat([eh, torch.zeros((N, M - K))], 1)
    tw = torch.zeros((N, L))
    th = torch.zeros((N, L))
    for k in reversed(range(M)) if reverse_sums else range(M):
        tw = tw + row(ew, k)
        th = th + row(eh, k)
    iw, ih = 1.0 / tw, 1.0 / th

    t = x[:, None].expand(N, L)
    cw = 1.0 - 1e-3 * K
    xk = torch.full((N, L), -B)
    yk = torch.full((N, L), -B)
    cap = [None] * 5  # b, x0, x1, y0, y1
    for k in range(K - 1):
        wk = DEFAULT_MIN_BIN + cw * (row(ew, k) * iw)
        hk = DEFAULT_MIN_BIN + cw * (row(eh, k) * ih)
        xn = xk + 2.0 * B * wk
        yn = yk + 2.0 * B * hk
        take = (torch.ones_like(t, dtype=torch.bool) if k == 0
                else t >= (yk if inverse else xk))
        new = (torch.full_like(t, float(k)), xk, xn, yk, yn)
        cap = [v if c is None else torch.where(take, v, c)
               for v, c in zip(new, cap)]
        xk, yk = xn, yn
    take = t >= (yk if inverse else xk)  # the last bin
    new = (torch.full_like(t, float(K - 1)), xk, torch.full_like(t, B), yk,
           torch.full_like(t, B))
    b, x0, x1, y0, y1 = (torch.where(take, v, c) for v, c in zip(new, cap))
    bi = b.long()
    # the bin's derivatives from their raw values, after the walk
    rd = raw[:, 2 * K:]  # rd[m]: the raw derivative at knot m + 1

    def deriv(m):  # knot m + 1's derivative, m < K - 1
        u = torch.gather(rd, 1, m.clamp(0, K - 2)) + _SOFTPLUS_UNIT
        return DEFAULT_MIN_DERIV + _softplus(u)

    d0 = torch.where(bi == 0, 1.0, deriv(bi - 1))
    d1 = torch.where(bi == K - 1, 1.0, deriv(bi))
    inside = t.abs() <= B
    tc = torch.where(inside, t, 0.0)  # the branch not taken
    w, h = x1 - x0, y1 - y0
    s = h / w
    if inverse:
        dy = tc - y0
        tt = d1 + d0 - 2.0 * s
        a = h * (s - d0) + dy * tt
        bq = h * d0 - dy * tt
        c = -s * dy
        disc = bq * bq - 4.0 * a * c
        sq = torch.sqrt(torch.fmax(disc, torch.zeros_like(disc)))
        xi_raw = 2.0 * c / (-bq - sq)
        xi = torch.fmin(torch.fmax(xi_raw, torch.zeros_like(xi_raw)),
                        torch.ones_like(xi_raw))
        out = x0 + w * xi
        xi1m = 1.0 - xi
        q = xi * xi1m
        denom = s + tt * q
        num = s * s * (d1 * xi * xi + 2.0 * s * q + d0 * xi1m * xi1m)
        ladj = 2.0 * torch.log(denom) - torch.log(num)
    else:
        xi = (tc - x0) / w
        xi1m = 1.0 - xi
        q = xi * xi1m
        denom = s + (d1 + d0 - 2.0 * s) * q
        out = y0 + h * (s * xi * xi + d0 * q) / denom
        num = s * s * (d1 * xi * xi + 2.0 * s * q + d0 * xi1m * xi1m)
        ladj = torch.log(num) - 2.0 * torch.log(denom)
    # lane 0 writes y and ladj; outside [-B, B] the identity
    y = torch.where(inside[:, 0], out[:, 0], x)
    ladj = torch.where(inside[:, 0], ladj[:, 0], 0.0)
    return y.reshape(shape), ladj.reshape(shape)


def _points(K, n, seed, inverse):
    """x (n, 1): inside the bins, exactly on the knots, +-B and outside
    [-B, B], a third each; raw and cotangents from `_inputs`."""
    x, raw, gy, gl = _inputs(seed, (n, 1), K)
    rng = np.random.default_rng(seed)
    third = n // 3
    x[:third, 0] = rng.uniform(-3.9, 3.9, third)
    x[third:2 * third] = _knot_points(raw[third:2 * third], K, B, inverse,
                                      third)
    tails = np.array([-6.5, -B, -3.9999, 3.9999, B, 5.0, 1e3], np.float32)
    x[2 * third:, 0] = np.resize(tails, n - 2 * third)
    return x, raw, gy, gl


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("K", [2, 4, 8, 12, 24, 64])
def test_group_design_equals_the_one_thread_pullback_bitwise(K, inverse):
    x, raw, gy, gl = (torch.from_numpy(a)
                      for a in _points(K, 99, 40 + K, inverse))
    got = lanes_vjp(x, raw, gy, gl, B, inverse)
    want = mirror_vjp(x, raw, gy, gl, B, inverse)
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape,K", [((64, 8), 8), ((33, 3), 8),
                                     ((7, 9), 12), ((5, 6), 64)])
def test_group_design_bitwise_at_scale(shape, K, inverse):
    """raw ~ N(0, 1), x ~ 6 N(0, 1): ill-conditioned bins included, and a
    ragged last block wherever the element count is not a multiple of
    E."""
    x, raw, gy, gl = (torch.from_numpy(a)
                      for a in _inputs(60 + K + shape[0], shape, K))
    got = lanes_vjp(x, raw, gy, gl, B, inverse)
    want = mirror_vjp(x, raw, gy, gl, B, inverse)
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("K", [2, 4, 8, 12, 24, 64])
def test_eval_group_design_equals_the_one_thread_spline_bitwise(K, inverse):
    x, raw, _, _ = (torch.from_numpy(a)
                    for a in _points(K, 99, 50 + K, inverse))
    got = lanes_eval(x, raw, B, inverse)
    want = mirror_eval(x, raw, B, inverse)
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape,K", [((64, 8), 8), ((33, 3), 8),
                                     ((7, 9), 12), ((5, 6), 64)])
def test_eval_group_design_bitwise_at_scale(shape, K, inverse):
    """raw ~ N(0, 1), x ~ 6 N(0, 1), NaN among them: ill-conditioned bins
    included."""
    x, raw, _, _ = (torch.from_numpy(a)
                    for a in _inputs(70 + K + shape[0], shape, K))
    x.view(-1)[::13] = float("nan")
    got = lanes_eval(x, raw, B, inverse)
    want = mirror_eval(x, raw, B, inverse)
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("inverse", [False, True])
def test_eval_bitwise_test_catches_reversed_softmax_sums(inverse):
    """The softmax denominators summed from the last knot down (a mutation
    of the group kernel's order) move some element's bits."""
    x, raw, _, _ = (torch.from_numpy(a) for a in _inputs(81, (64, 8), 8))
    got = lanes_eval(x, raw, B, inverse, reverse_sums=True)
    want = mirror_eval(x, raw, B, inverse)
    assert not all(torch.equal(_bits(a), _bits(b))
                   for a, b in zip(got, want))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape,K", [((64, 8), 8), ((33, 3), 8),
                                     ((16, 4), 4), ((7, 9), 12)])
def test_eval_group_design_matches_pallas_interpret(shape, K, inverse):
    """y and ladj against the JAX kernel `_pallas_eval` (interpret mode on
    the CPU), on the same numpy inputs."""
    x, raw, _, _ = _inputs(300 + K + shape[0], shape, K)
    got = lanes_eval(torch.from_numpy(x), torch.from_numpy(raw), B, inverse)
    name = "rqs_inverse_from_raw" if inverse else "rqs_forward_from_raw"
    want = getattr(j_pallas, name)(jnp.asarray(x), jnp.asarray(raw))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **JAX_BAR)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape,K", [((64, 8), 8), ((33, 3), 8),
                                     ((16, 4), 4), ((7, 9), 12)])
def test_group_design_matches_pallas_interpret(shape, K, inverse):
    """dx and draw against the JAX kernel's custom_vjp (interpret mode on
    the CPU), on the same numpy inputs."""
    x, raw, gy, gl = _inputs(100 + K + shape[0], shape, K)
    dx, draw = lanes_vjp(*(torch.from_numpy(a) for a in (x, raw, gy, gl)),
                         B, inverse)
    name = "rqs_inverse_from_raw" if inverse else "rqs_forward_from_raw"
    want = _jax_grads(getattr(j_pallas, name), x, raw, gy, gl)
    np.testing.assert_allclose(dx.numpy(), want[2], **JAX_BAR)
    np.testing.assert_allclose(draw.numpy(), want[3], **JAX_BAR)


@pytest.mark.parametrize("inverse", [False, True])
def test_cpu_wrapper_pullback_matches_the_group_design(inverse):
    """The wrapper's plain version (autograd, another order) within the
    line-by-line mirror's bar of the group design."""
    x, raw, gy, gl = _inputs(5, (24, 4), 8)
    got = lanes_vjp(*(torch.from_numpy(a) for a in (x, raw, gy, gl)), B,
                    inverse)
    want = _torch_grads(
        lambda xt, rt: rqs_cuda.plain_eval(xt, rt, B, inverse), x, raw, gy,
        gl)[2:]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the block layout
# ---------------------------------------------------------------------------
def row_stride(K):
    """csrc/rqs_lanes.cuh `row_stride`: K rounded up to whole 16-byte
    words, an odd number of them."""
    words = (K + 3) // 4
    return 4 * words if words % 2 else 4 * words + 4


@pytest.mark.parametrize("K", range(2, rqs_cuda.MAX_KNOTS + 1))
def test_lanes_and_bins_per_lane_against_K(K):
    L, NB, E = rqs_cuda.lane_layout(K)
    T = rqs_cuda.LANE_BINS
    assert L & (L - 1) == 0 and 1 <= L <= 32
    assert L == 32 or L * T >= K  # at most T bins a lane below 32 lanes
    assert L == 1 or (L // 2) * T < K  # the least such power of two
    assert (NB - 1) * L < K <= NB * L and NB <= max(T, 2)
    assert E * L == rqs_cuda.LANE_THREADS and 32 % L == 0
    # every raw value has one owner: bin k's width and height and the
    # derivative at its left knot
    P = 3 * K - 1
    owned = []
    for l in range(L):
        for k in range(l, K, L):
            owned += [k, K + k] + ([2 * K + k - 1] if k >= 1 else [])
    assert sorted(owned) == list(range(P))


@pytest.mark.parametrize("K", range(2, rqs_cuda.MAX_KNOTS + 1))
def test_block_spans_and_rows_are_aligned(K):
    """Each block's span of raw values (and of x, gy, gl, dx) starts at a
    multiple of 16 bytes from an aligned base; the arrays behind the span
    in shared memory (x, gy, gl, the rows) start aligned; each element's
    three rows hold K floats in whole 16-byte words, and the rows of 8
    consecutive elements start in 8 different groups of 4 banks; a
    block's shared memory stays under the 48 KB a launch gets without
    asking."""
    L, NB, E = rqs_cuda.lane_layout(K)
    P, S = 3 * K - 1, row_stride(K)
    assert E % 4 == 0
    for block in range(5):
        e0 = block * E
        assert (4 * e0 * P) % 16 == 0 and (4 * e0) % 16 == 0
    assert (4 * E * P) % 16 == 0 and (4 * E) % 16 == 0
    assert S % 4 == 0 and S >= K and (S // 4) % 2 == 1
    assert len({(e * S // 4) % 8 for e in range(8)}) == 8
    assert 4 * E * (P + 3 + 3 * S) <= 48 * 1024


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [1, 31, 33, 200])
def test_ragged_last_block(n, inverse):
    """n not a multiple of E = 128 (K = 8): the last block takes the rest,
    its span n P - e0 P floats, and every element equals the one-thread
    pullback's."""
    K = 8
    L, NB, E = rqs_cuda.lane_layout(K)
    assert (L, NB, E) == (2, 4, 128)
    blocks = -(-n // E)
    ne = n - (blocks - 1) * E
    assert 1 <= ne <= E and (blocks - 1) * E + ne == n
    x, raw, gy, gl = (torch.from_numpy(a) for a in _inputs(n, (n, 1), K))
    got = lanes_vjp(x, raw, gy, gl, B, inverse)
    want = mirror_vjp(x, raw, gy, gl, B, inverse)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def eval_stride(K):
    """csrc/rqs_lanes.cuh `eval_stride`: K4's two rows, each K rounded up
    to whole 16-byte words, and one word more."""
    return 4 * (2 * ((K + 3) // 4) + 1)


@pytest.mark.parametrize("K", range(2, rqs_cuda.MAX_KNOTS + 1))
def test_eval_block_layout(K):
    """K4's block: L and the bins a lane holds; each warp's span of raw
    values (and of x, y, ladj; a warp stages its own) starts at a multiple
    of 16 bytes from an aligned base, in device and in shared memory; x
    and the rows behind the spans start aligned; where the lanes share
    rows (L > 1), each holds K floats in whole 16-byte words (the height
    row right behind the width row), and the rows of 8 consecutive
    elements start in 8 different groups of 4 banks; at one lane (K <= 8)
    the exponentials stay in registers and no rows are allocated; a
    block's shared memory stays under the 48 KB a launch gets without
    asking."""
    L, NB, E = rqs_cuda.lane_layout(K, rqs_cuda.EVAL_LANE_BINS)
    T = rqs_cuda.EVAL_LANE_BINS
    assert L & (L - 1) == 0 and 1 <= L <= 32
    assert L == 32 or L * T >= K
    assert L == 1 or (L // 2) * T < K
    assert (NB - 1) * L < K <= NB * L
    assert E * L == rqs_cuda.LANE_THREADS and E % 4 == 0
    P, S, W = 3 * K - 1, eval_stride(K), (K + 3) // 4 * 4
    EW = 32 // L  # elements a warp
    assert EW % 4 == 0 and E % EW == 0
    for warp in range(5 * E // EW):
        w0 = warp * EW
        assert (4 * w0 * P) % 16 == 0 and (4 * w0) % 16 == 0
    assert (4 * E * P) % 16 == 0 and (4 * (E * P + E)) % 16 == 0
    assert W >= K and W % 4 == 0 and S == 2 * W + 4 and (S // 4) % 2 == 1
    for row in (0, W):  # widths, heights
        assert len({(e * S + row) // 4 % 8 for e in range(8)}) == 8
    assert (L == 1) == (K <= rqs_cuda.EVAL_LANE_BINS)
    assert 4 * E * (3 * K + (S if L > 1 else 0)) <= 48 * 1024


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [1, 31, 129, 300])
def test_eval_ragged_last_block(n, inverse):
    """n not a multiple of E (K = 8): the last block takes the rest, its
    last busy warp the rest of that (idle warps return before staging),
    and every element equals the one-thread spline's."""
    K = 8
    L, NB, E = rqs_cuda.lane_layout(K, rqs_cuda.EVAL_LANE_BINS)
    EW = 32 // L
    blocks = -(-n // E)
    ne = n - (blocks - 1) * E
    assert 1 <= ne <= E and (blocks - 1) * E + ne == n
    busy = -(-ne // EW)
    assert 1 <= ne - (busy - 1) * EW <= EW and busy <= E // EW
    x, raw, _, _ = (torch.from_numpy(a) for a in _inputs(n, (n, 1), K))
    got = lanes_eval(x, raw, B, inverse)
    want = mirror_eval(x, raw, B, inverse)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(_bits(a), _bits(b))
