"""The tile design of K6 and K7 (csrc/coupling_tile.cu) on the CPU, where
no kernel runs: its decomposition mirrored in torch, its launch plan and
its thread layouts.

  * `mirror_tile_k6` / `mirror_tile_k7`: the kernels' arithmetic on (N, d)
    tensors as the tiles split it: tiles of R rows (a ragged last one),
    every layer's units split over a cluster of 2 CTAs and gathered, the
    spline dims split over the cluster and walked in chunks of dc, the
    ladj and the last hidden layer's partial cotangents summed over the
    cluster in rank order, and pass 2's dW = H^T G (a row of ones for the
    bias) over S row slices added in order. In float64 against autograd of
    the plain version (`plain_block_vjp`), and in float32 against the JAX
    package's oracle block;
  * `tile_plan` for every row of chip_smoke's COUPLING_SHAPES and
    COUPLING_TIMING_SHAPES: within the 232,448 bytes a CTA may take, its
    bytes counted independently here; and its reach against the earlier
    8-row layout's (csrc/coupling_block.cu `make_plan`) over a grid of
    widths, depths, knots and masks: no block that layout took goes to
    the wide unit; where no tile fits, the plan is the wide unit's;
  * the thread layout of a product (`thread_tile`, the columns per thread
    `ct_of`) and of the weight copies, written out from the CUDA source:
    each output and each staged weight exactly once;
  * what the wrappers refuse, and that no tensor on the CPU reaches a
    kernel or the earlier kernels.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_coupling_fused import JAX_BAR, leaves, pair
from tpuflows.flows.coupling import RQSCouplingBlock as JRQS

from tpuflows_torch.flows import MLP
from tpuflows_torch.flows.rqs_ref import DEFAULT_RANGE
from tpuflows_torch.kernels import coupling_cuda as cc
from tpuflows_torch.kernels import rqs_cuda
from tpuflows_torch.util.shapes import alternating_mask, block_mask

MAX_SMEM = 232448


# ---------------------------------------------------------------------------
# The decomposition, mirrored in torch
# ---------------------------------------------------------------------------
def _act_grad(a, activation):
    if activation == "silu":
        s = 1.0 / (1.0 + torch.exp(-a))
        return s * (1.0 + a * (1.0 - s))
    if activation == "tanh":
        return 1.0 - torch.tanh(a) ** 2
    return (a > 0).to(a.dtype)


CLUSTER = 2  # CTAs of a cluster (csrc kCluster)


def _slices(w):
    """[lo, hi) of each CTA of a cluster over w units (csrc slice_width)."""
    sw = -(-w // CLUSTER)
    return [(min(w, s * sw), min(w, min(w, s * sw) + sw))
            for s in range(CLUSTER)]


def _chunks(jlo, jhi, dc):
    return [(j0, min(dc, jhi - j0)) for j0 in range(jlo, jhi, dc)]


def _hidden_forward(h, ws, bs, activation):
    """Each hidden layer's units over the cluster, gathered: (inputs of
    every layer, act'(a) of each hidden layer)."""
    act = cc._activation(activation)
    H, D = [h], []
    for w, b in zip(ws[:-1], bs[:-1]):
        out = torch.empty(h.shape[0], w.shape[1], dtype=h.dtype)
        d_ = torch.empty_like(out)
        for lo, hi in _slices(w.shape[1]):
            a = H[-1] @ w[:, lo:hi] + b[lo:hi]
            out[:, lo:hi] = act(a)
            d_[:, lo:hi] = _act_grad(a, activation)
        H.append(out)
        D.append(d_)
    return H, D


def _chunk_raw(h, w, b, cols):
    return h @ w[:, cols] + b[cols]


def _tile_cols(idx, P, d, j0, nj):
    """The last layer's columns of a chunk, p-major: p d + idx[j0 + jj]."""
    return [p * d + idx[j0 + jj] for p in range(P) for jj in range(nj)]


def mirror_tile_k6(x, params, mask, K, B, activation, inverse, rows, dc):
    """K6 by tiles: (z (N, d), ladj (N,))."""
    N, d = x.shape
    P = 3 * K - 1
    idx = [j for j, m in enumerate(mask) if m == 0]
    nt = len(idx)
    ws, bs = list(params[0::2]), [b.reshape(-1) for b in params[1::2]]
    b_t = torch.tensor(mask, dtype=x.dtype)
    z = torch.empty_like(x)
    ladj = torch.empty(N, dtype=x.dtype)
    for row0 in range(0, N, rows):
        xt = x[row0:row0 + rows]
        T = xt.shape[0]
        H, _ = _hidden_forward(xt * b_t, ws, bs, activation)
        zt = xt.clone()
        lrow = []  # per CTA, over its chunks in order
        for jlo, jhi in _slices(nt):
            lacc = torch.zeros(T, dc, dtype=x.dtype)
            for j0, nj in _chunks(jlo, jhi, dc):
                raw = _chunk_raw(H[-1], ws[-1], bs[-1],
                                 _tile_cols(idx, P, d, j0, nj))
                raw = raw.reshape(T, P, nj).transpose(1, 2)
                dims = idx[j0:j0 + nj]
                y, lv = rqs_cuda.plain_eval(xt[:, dims], raw, B, inverse)
                zt[:, dims] = y
                lacc[:, :nj] += lv
            s = torch.zeros(T, dtype=x.dtype)
            for jj in range(dc):
                s = s + lacc[:, jj]
            lrow.append(s)
        total = torch.zeros(T, dtype=x.dtype)
        for s in lrow:
            total = total + s
        z[row0:row0 + T] = zt
        ladj[row0:row0 + T] = total
    return z, ladj


def mirror_tile_k7(x, params, mask, gz, gladj, K, B, activation, inverse,
                   rows, dc, slices):
    """K7 by tiles, pass 1 then pass 2: (dx, dparams)."""
    N, d = x.shape
    P = 3 * K - 1
    idx = [j for j, m in enumerate(mask) if m == 0]
    nt = len(idx)
    n = len(params) // 2
    ws, bs = list(params[0::2]), [b.reshape(-1) for b in params[1::2]]
    b_t = torch.tensor(mask, dtype=x.dtype)
    dx = torch.empty_like(x)
    # pass 1's scratch: every layer's input and pre-activation cotangent,
    # the last layer's over the compact spline columns p nt + t
    Hs = [torch.empty(N, w.shape[0], dtype=x.dtype) for w in ws]
    Gs = [torch.empty(N, w.shape[1], dtype=x.dtype) for w in ws[:-1]]
    Gs.append(torch.empty(N, P * nt, dtype=x.dtype))
    for row0 in range(0, N, rows):
        sl = slice(row0, row0 + rows)
        xt, gzt, glt = x[sl], gz[sl], gladj[sl]
        T = xt.shape[0]
        H, D = _hidden_forward(xt * b_t, ws, bs, activation)
        for l, h in enumerate(H):
            Hs[l][sl] = h
        partials = []  # each CTA's cotangent of the last layer's input
        for jlo, jhi in _slices(nt):
            gh = torch.zeros(T, ws[-1].shape[0], dtype=x.dtype)
            for j0, nj in _chunks(jlo, jhi, dc):
                cols = _tile_cols(idx, P, d, j0, nj)
                raw = _chunk_raw(H[-1], ws[-1], bs[-1], cols)
                raw = raw.reshape(T, P, nj).transpose(1, 2)
                dims = idx[j0:j0 + nj]
                dxs, draw = rqs_cuda.plain_grad(
                    xt[:, dims], raw, gzt[:, dims],
                    glt[:, None].expand(T, nj), B, inverse)
                dx[sl, dims] = dxs
                g = draw.transpose(1, 2).reshape(T, P * nj)
                for p in range(P):
                    Gs[-1][sl, p * nt + j0:p * nt + j0 + nj] = \
                        g[:, p * nj:(p + 1) * nj]
                gh = gh + g @ ws[-1][:, cols].T
            partials.append(gh)
        gh = torch.zeros_like(partials[0])
        for part in partials:
            gh = gh + part
        # down the hidden layers, each over the cluster's slices
        for l in range(n - 2, -1, -1):
            g = gh * D[l]
            Gs[l][sl] = g
            gh = torch.empty(T, ws[l].shape[0], dtype=x.dtype)
            for lo, hi in _slices(ws[l].shape[0]):
                gh[:, lo:hi] = g @ ws[l][lo:hi, :].T
        keep = [j for j, m in enumerate(mask) if m == 1]
        dx[sl, keep] = gzt[:, keep] + gh[:, keep]
    # pass 2: the rows in `slices` slices of whole steps of 32, in order
    per = -(-(-(-N // slices)) // 32) * 32
    dps = []
    for l in range(n):
        ones = torch.ones(N, 1, dtype=x.dtype)
        Ht = torch.cat([Hs[l], ones], dim=1)
        acc = torch.zeros(Ht.shape[1], Gs[l].shape[1], dtype=x.dtype)
        for s in range(slices):
            r = slice(min(N, s * per), min(N, s * per + per))
            acc = acc + Ht[r].T @ Gs[l][r]
        dw, db = acc[:-1], acc[-1]
        if l == n - 1:  # compact spline columns -> p-major p d + j
            full_w = torch.zeros_like(ws[-1])
            full_b = torch.zeros_like(bs[-1])
            cols = [p * d + j for p in range(P) for j in idx]
            full_w[:, cols], full_b[cols] = dw, db
            dw, db = full_w, full_b
        dps += [dw, db.reshape(1, -1)]
    return dx, tuple(dps)


MASKS = {"alternating": lambda d: alternating_mask(d, 1),
         "block": lambda d: block_mask(d, 0),
         "all-pass": lambda d: (1,) * d}


def _setup(activation, hidden, mask, n, d=7, K=4, dtype=torch.float64):
    m = MASKS[mask](d)
    ws, bs = leaves(11, d, hidden, K, last_scale=0.3)
    params = cc.flatten_params(MLP(
        [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs],
        activation=activation).to(dtype), d, K)
    params = tuple(p.detach() for p in params)
    rng = np.random.default_rng(12)
    x = torch.from_numpy(2.5 * rng.normal(size=(n, d))).to(dtype)
    gz = torch.from_numpy(rng.normal(size=(n, d))).to(dtype)
    gl = torch.from_numpy(rng.normal(size=n)).to(dtype)
    return m, params, x, gz, gl


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("activation,hidden,mask", [
    ("silu", (16, 12), "alternating"), ("tanh", (10,), "block"),
    ("relu", (), "block"), ("silu", (8,), "all-pass")])
@pytest.mark.parametrize("rows,dc,slices", [(16, 2, 2), (8, 1, 4),
                                           (16, 3, 1)])
def test_tile_k7_mirror_matches_autograd(activation, hidden, mask, inverse,
                                         rows, dc, slices):
    """In float64, so that the two agree to rounding and the comparison
    tests the decomposition, not float32; N = 45 leaves a ragged last
    tile at every R, a chunk of 3 over a CTA's 2 spline dims leaves it
    part empty, and the all-pass mask leaves both CTAs none."""
    d, K, n = 7, 4, 45
    m, params, x, gz, gl = _setup(activation, hidden, mask, n, d, K)
    mv = torch.tensor(m, dtype=torch.float64)
    want = cc.plain_block_vjp(x, params, mv, gz, gl, K, DEFAULT_RANGE,
                              activation, inverse)
    got = mirror_tile_k7(x, params, m, gz, gl, K, DEFAULT_RANGE, activation,
                         inverse, rows, dc, slices)
    torch.testing.assert_close(got[0], want[0], rtol=1e-9, atol=1e-9)
    assert len(got[1]) == len(want[1]) == 2 * (len(hidden) + 1)
    for g, w in zip(got[1], want[1]):
        torch.testing.assert_close(g, w, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("activation,hidden,mask", [
    ("silu", (16, 12), "alternating"), ("relu", (), "block"),
    ("tanh", (10,), "all-pass")])
@pytest.mark.parametrize("rows,dc", [(16, 2), (8, 1)])
def test_tile_k6_mirror_matches_the_plain_block(activation, hidden, mask,
                                                inverse, rows, dc):
    d, K, n = 7, 4, 45
    m, params, x, _, _ = _setup(activation, hidden, mask, n, d, K)
    mv = torch.tensor(m, dtype=torch.float64)
    wz, wl = cc.plain_block(x, params, mv, K, DEFAULT_RANGE, activation,
                            inverse)
    z, ladj = mirror_tile_k6(x, params, m, K, DEFAULT_RANGE, activation,
                             inverse, rows, dc)
    torch.testing.assert_close(z, wz, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(ladj, wl, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("inverse", [False, True])
def test_tile_k6_mirror_matches_the_jax_oracle_block(inverse):
    """float32, at the default plan of a ragged batch: against the JAX
    package's oracle block to JAX's own bar (forward) and its inverse
    bar (5e-3, tests/test_pallas.py)."""
    d, K, n = 8, 4, 37
    jb, tb = pair(4, alternating_mask(d, 0), hidden=(16, 12), knots=K)
    jo = JRQS(mask=jb.mask, net=jb.net, knots=K, use_pallas=False)
    x = (1.5 * np.random.default_rng(40).normal(size=(n, d))).astype(
        np.float32)
    params = tuple(p.detach() for p in cc.flatten_params(tb.net, d, K))
    widths = [d, 16, 12, (3 * K - 1) * d]
    plan = cc.tile_plan(widths, K, d // 2, n, False)
    z, ladj = mirror_tile_k6(torch.from_numpy(x), params, jb.mask, K,
                             DEFAULT_RANGE, "silu", inverse, plan.rows,
                             plan.dc)
    f = jo.inverse_and_ladj if inverse else jo.forward_and_ladj
    jz, jl = f(jnp.asarray(x))
    atol = 5e-3 if inverse else JAX_BAR["atol"]
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-5,
                               atol=atol)
    np.testing.assert_allclose(ladj.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=atol)


# ---------------------------------------------------------------------------
# The launch plan
# ---------------------------------------------------------------------------
def _shape_rows():
    """(n, d, hidden, K, mask) of every COUPLING_SHAPES and
    COUPLING_TIMING_SHAPES row."""
    rows = [(n, d, hidden, K, mask)
            for n, d, hidden, K, mask, _, _ in chip_smoke.COUPLING_SHAPES]
    return rows + [tuple(r) for r in chip_smoke.COUPLING_TIMING_SHAPES]


def _smem_here(widths, K, rows, dc, stage, grad):
    """The CTA's shared memory counted region by region, as
    csrc/coupling_tile.cu `make_layout` lays it out."""
    P, n = 3 * K - 1, len(widths) - 1
    words = [(P * dc + 3) // 4 * 4,                 # the chunk's columns
             rows * max(widths[:-1]),               # activations, twice
             rows * max(widths[:-1]),
             rows * P * dc]                         # the chunk's raw values
    if grad:  # act'(a) of each hidden layer over the CTA's slice
        words += [rows * -(-widths[l + 1] // CLUSTER) for l in range(n - 1)]
    else:  # ladj slots, the row sums
        words += [rows * dc, rows]
    words.append(4 * stage)                         # the ring
    return 4 * sum(words)


def _earlier_smem(widths, K, dc, grad):
    """Bytes of the earlier 8-row kernels' shared memory
    (csrc/coupling_block.cu `make_plan`), region by region."""
    d, P = widths[0], 3 * K - 1
    wmax = max([d, *widths[1:-1]])
    words = [(d + 3) // 4 * 4, (P * dc + 3) // 4 * 4, 8 * d]
    if grad:  # every layer's input, each hidden pre-activation
        words += [8 * w for w in widths[:-1]] + [8 * w for w in widths[1:-1]]
    words += [2 * 8 * wmax, 8 * P * dc, 8 * dc]  # 2 buffers, raw, ladj
    return 4 * sum(words)


def _earlier_takes(widths, K, grad):
    """Whether the earlier kernels launched the block: their chunk of
    spline dims halved from 32 down to 1 until it fit (`_rows8_dc`)."""
    return any(_earlier_smem(widths, K, dc, grad) <= MAX_SMEM
               for dc in (32, 16, 8, 4, 2, 1))


def _plan_or_none(widths, K, nt, n, grad):
    """The tile kernels' plan, or None where the block goes to the wide
    unit."""
    plan = cc.tile_plan(widths, K, nt, n, grad)
    return None if plan.wide else plan


@pytest.mark.parametrize("shape", _shape_rows(), ids=str)
@pytest.mark.parametrize("grad", [False, True])
def test_tile_plan_fits_every_chip_shape(shape, grad):
    n, d, hidden, K, mask_name = shape
    nt = sum(1 for m in chip_smoke.coupling_mask(mask_name, d) if m == 0)
    widths = [d, *hidden, (3 * K - 1) * d]
    plan = _plan_or_none(widths, K, nt, n, grad)
    if plan is None:  # wide only where the earlier kernels refused
        assert grad and not _earlier_takes(widths, K, grad)
        return
    assert plan.rows in cc.TILE_ROWS
    assert 1 <= plan.dc <= min(32, max(1, -(-nt // CLUSTER)))
    assert plan.stage in cc.STAGE_FLOATS or (plan.stage == 0 and not grad)
    assert plan.smem <= MAX_SMEM
    assert plan.smem == _smem_here(widths, K, plan.rows, plan.dc,
                                   plan.stage, grad)
    assert plan.slices in cc.WGRAD_SLICES


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("K", [2, 8, 24, 64])
def test_tile_plan_takes_every_block_the_earlier_layout_took(grad, K):
    """Over input widths 2-3000, 0-7 hidden layers of 8-4096 units (the
    widest first, last or alone) and spline dims from none to all: where
    the earlier 8-row layout fit a block, the tile plan fits it too."""
    taken = 0
    for d in (2, 7, 64, 96, 256, 700, 1500, 3000):
        for w in (8, 128, 700, 1500, 1800, 2300, 2900, 3100, 3300, 3600,
                  4096):
            for hidden in ((), (w,), (w, w), (w, 16), (16, w), (w,) * 7):
                widths = [d, *hidden, (3 * K - 1) * d]
                if not _earlier_takes(widths, K, grad):
                    continue
                for nt in sorted({0, 1, d // 2, d}):
                    plan = _plan_or_none(widths, K, nt, 1024, grad)
                    assert plan is not None, (widths, nt)
                    assert plan.smem == _smem_here(
                        widths, K, plan.rows, plan.dc, plan.stage, grad)
                    taken += 1
    assert taken > 100


def test_tile_plan_at_the_fits_shape():
    """1024 x 64, hidden 128 x 128, K = 8, 32 spline dims: 16 rows, each
    CTA's 16 spline dims in one chunk, the largest ring stage; pass 2's
    4 + 6 + 36 tiles over 8 row slices."""
    widths = [64, 128, 128, 23 * 64]
    for grad in (False, True):
        plan = cc.tile_plan(widths, 8, 32, 1024, grad)
        assert plan[:3] == (16, 16, 8448)
    assert cc.wgrad_tiles(widths, 8, 32) == 46
    assert plan.slices == 8
    # d = 256: 64 spline dims a CTA in chunks of 32
    assert cc.tile_plan([256, 128, 128, 23 * 256], 8, 128, 1024,
                        True)[:3] == (16, 32, 8448)
    # a small batch keeps at least 64 rows a slice
    assert cc.wgrad_slices(widths, 8, 32, 37) == 1
    assert cc.wgrad_slices(widths, 8, 32, 130) == 2
    # made once per shapes
    assert cc.tile_plan(widths, 8, 32, 1024, True) is plan


def test_tile_plan_falls_back_and_refuses():
    """Wide layers take fewer rows and a smaller ring; K6 where no ring
    fits beside its activations drops it (stage 0), as chip_smoke's row of
    a 3200-unit hidden layer does, where K7, as the earlier K7 did, has no
    tile: its plan, and that of a block that fits no tile, is the wide
    unit's (16 rows, no ring, no shared memory; the earlier kernels
    refuse both)."""
    widths = [64, 1536, 23 * 64]
    plan = cc.tile_plan(widths, 8, 32, 1024, True)
    assert plan.rows == 8 and plan.stage > 0 and plan.smem <= MAX_SMEM
    wide = [64, 3200, 23 * 64]
    plan = cc.tile_plan(wide, 8, 32, 45, False)
    assert plan[:3] == (8, 16, 0) and plan.smem <= MAX_SMEM
    assert _earlier_takes(wide, 8, False)
    plan = cc.tile_plan(wide, 8, 32, 45, True)
    assert plan.wide and plan[:4] == (cc.WIDE_ROWS, 16, 0, 0)
    assert not _earlier_takes(wide, 8, True)
    plan = cc.tile_plan([64, 8192, 23 * 64], 8, 32, 1024, False)
    assert plan.wide and plan[:4] == (cc.WIDE_ROWS, 16, 0, 0)
    assert not _earlier_takes([64, 8192, 23 * 64], 8, False)


# ---------------------------------------------------------------------------
# The thread layouts of a product and of its weight copies
# ---------------------------------------------------------------------------
THREADS = 256


def thread_tile(R, tid):
    """csrc `thread_tile<R>`: (first of the thread's 4 rows, its column
    group)."""
    tr = R // 4
    wr = min(tr, 4)
    lc = 32 // wr
    wrw = tr // wr
    lane, warp = tid % 32, tid // 32
    return 4 * ((warp % wrw) * wr + lane // lc), (warp // wrw) * lc + lane % lc


@pytest.mark.parametrize("R", cc.TILE_ROWS)
@pytest.mark.parametrize("CT", [1, 2, 4])
def test_every_output_of_a_panel_has_one_thread(R, CT):
    ow = CT * cc.col_groups(R)
    seen = np.zeros((R, ow), dtype=int)
    for tid in range(THREADS):
        r0, cg = thread_tile(R, tid)
        for i in range(4):
            for j in range(CT):
                seen[r0 + i, cg * CT + j] += 1
    assert (seen == 1).all()
    # a warp's rows: one float4 each for at most 4 row groups, in 64 bytes
    for w in range(THREADS // 32):
        r0s = {thread_tile(R, 32 * w + lane)[0] for lane in range(32)}
        assert len(r0s) == min(4, R // 4) and max(r0s) - min(r0s) < 16


def _fwd_copies(ow, nq, pw, vec):
    """Stage elements (q, o) written by the kFwd copies of one stage."""
    seen = np.zeros((nq, ow), dtype=int)
    for tid in range(THREADS):
        if vec:
            fo4, fq4 = 4 * (tid % (ow // 4)), tid // (ow // 4)
            for q in range(fq4, nq, THREADS * 4 // ow):
                for u in range(4 if fo4 + 3 < pw else 3):
                    if fo4 + u < pw:
                        seen[q, fo4 + u] += 1
        else:
            fo, fq = tid % ow, tid // ow
            if fo < pw:
                for q in range(fq, nq, THREADS // ow):
                    seen[q, fo] += 1
    return seen


def _bwd_copies(ow, nq, pw):
    seen = np.zeros((nq, ow), dtype=int)
    for tid in range(THREADS):
        bq, bo = tid & 7, tid >> 3
        for q in range(bq, nq, 8):
            for o in range(bo, pw, THREADS // 8):
                seen[q, o] += 1
    return seen


@pytest.mark.parametrize("R", cc.TILE_ROWS)
@pytest.mark.parametrize("CT", [1, 2, 4])
@pytest.mark.parametrize("stage", cc.STAGE_FLOATS)
def test_every_staged_weight_is_copied_once(R, CT, stage):
    ow = CT * cc.col_groups(R)
    if ow > THREADS or cc.stage_rows(stage, ow) < 16:
        assert cc.ct_of(R, 10 ** 6, stage) < CT  # never chosen
        return
    qc = cc.stage_rows(stage, ow)
    assert qc % 16 == 0 and qc * (ow + 4) <= stage
    for nq in (qc, qc - 5):
        for pw in (ow, ow - 6, 3):
            want = np.zeros((nq, ow), dtype=int)
            want[:, :pw] = 1
            for vec in (False, True):
                assert (_fwd_copies(ow, nq, pw, vec) == want).all()
            assert (_bwd_copies(ow, nq, pw) == want).all()


def test_columns_per_thread_follow_the_panel():
    """The fit's last layer (368 columns a CTA) takes CT = 2 at R = 16, its
    pullback (128) 2, a hidden slice of 64 columns 1; R = 8 never takes a
    panel wider than the block's threads; without a ring (K6's stage 0)
    one column a thread."""
    assert cc.ct_of(16, 368, 8448) == 2
    assert cc.ct_of(16, 128, 8448) == 2
    assert cc.ct_of(16, 64, 8448) == 1
    assert cc.ct_of(16, 1024, 8448) == 4
    assert cc.ct_of(8, 736, 8448) == 2
    assert cc.ct_of(8, 736, 0) == cc.ct_of(16, 368, 0) == 1
    assert cc.stage_rows(8448, 128) == 64 and cc.stage_rows(8448, 256) == 32


# ---------------------------------------------------------------------------
# What the wrappers refuse
# ---------------------------------------------------------------------------
def test_cpu_tensors_reach_no_kernel(monkeypatch):
    """On the CPU the wrappers run the plain version and never load a
    library; the earlier kernels take CUDA tensors only."""
    def refuse():
        raise AssertionError("a kernel library was loaded for a CPU tensor")

    monkeypatch.setattr(cc.LIBRARY, "load", refuse)
    monkeypatch.setattr(cc.EARLIER, "load", refuse)
    cc.reset_launches()
    _, tb = pair(3, alternating_mask(6, 0))
    params = cc.flatten_params(tb.net, 6, 4)
    spec = cc.BlockSpec(tb.mask, 4, 4.0, "silu", False)
    x = torch.randn(9, 6)
    z, ladj = cc.block_eval(x, params, spec)
    dx, dps = cc.block_grad(x, params, spec, torch.ones(9, 6), torch.ones(9))
    assert z.shape == (9, 6) and dx.shape == (9, 6) and len(dps) == 4
    with pytest.raises(ValueError, match="CUDA"):
        cc.earlier_block_eval(x, params, spec)
    with pytest.raises(ValueError, match="CUDA"):
        cc.earlier_block_grad(x, params, spec, torch.ones(9, 6),
                              torch.ones(9))
    assert not any(cc.LAUNCHES.values())
    assert not any(cc.EARLIER_LAUNCHES.values())
    assert cc.K7_LAUNCHES == {False: 1, True: 2}


@pytest.mark.parametrize("name,key", [
    ("_ZN46_GLOBAL__N__5f2e1a9c_16_coupling_tile_cu_7d3c2b1a24coupling_tile_"
     "fwd_kernelILb1ELi16EEEvNS_6LayersENS_5BlockEPfS3_",
     "K6 tile inverse R=16"),
    ("_ZN46_GLOBAL__N__5f2e1a9c_16_coupling_tile_cu_7d3c2b1a24coupling_tile_"
     "bwd_kernelILb0ELi8EEEvNS_6LayersENS_5BlockENS_7ScratchEPKfS5_Pf",
     "K7 tile pass 1 forward R=8"),
    ("_ZN46_GLOBAL__N__5f2e1a9c_16_coupling_tile_cu_7d3c2b1a26coupling_tile_"
     "wgrad_kernelENS_10WeightGradE", "K7 tile pass 2"),
    ("_ZN50_GLOBAL__N__570a5339_17_coupling_block_cu_3c6ffed619coupling_"
     "fwd_kernelILb0EEEvNS_6LayersENS_5BlockEPfS3_", "K6 forward")])
def test_ptxas_summary_names_the_tile_kernels(name, key):
    """Each instantiation of the tile kernels by its direction and rows;
    the earlier kernels keep their names."""
    log = (f"ptxas info    : Compiling entry function '{name}' for "
           "'sm_90a'\n    0 bytes stack frame, 0 bytes spill stores, 0 "
           "bytes spill loads\nptxas info    : Used 172 registers, used 1 "
           "barriers\n")
    assert chip_smoke.ptxas_summary(log) == {key: {
        "spill_stores": 0, "spill_loads": 0, "registers": 172,
        "static_smem": 0}}
