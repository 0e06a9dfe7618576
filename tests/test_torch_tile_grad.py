"""The tile gradient of K1's and K3's module-list kernels
(`csrc/tile_grad.cuh`), on the CPU: what the host decides and what the
design rests on. The kernels themselves run only on the card, where
`chip_smoke.py` (phase `tile_vs_warp`) holds them to the per-warp kernels
bit for bit.

  * `nuts_cuda.tile_rows`: R = 8 at the generic arqs flow (d = 64), at most
    4 at d = 256, K = 16, a power of two whose tile (R rows of scratch and
    of the weight ring) never exceeds SMEM_LIMIT, and the largest such;
    where one row leaves no room for the whole ring (d = 256, K = 64), R =
    1 on a smaller ring (`ring_stage_floats`), and the flow passes every
    kernel's width checks, K2's too;
  * the thread layout of `tile_matvec` (`tile_rpt`, groups of 32 RPT
    threads, KC columns per pass), written out here: every (row, column)
    cell of a layer is computed by exactly one thread;
  * the compact first and last layers `pack_flow` appends for the tile
    kernels (the pass-through dims' W1 rows, the transformed dims' head
    columns, p-major, zero-padded to multiples of 32) are the packed
    layers' entries, and `tile_mirror`, the tile gradient's per-row math
    written out in torch on them (compact positions, compact head, the
    pass-through dims' input cotangents), matches autograd through the
    flow to 1e-4 (the bar of tests/test_torch_nuts_spline.py's mirror:
    |grad| reaches ~1e3 on these flows);
  * `nuts_cuda.lockstep_gradients`: with one tile of the whole batch it is
    the number of gradient calls `transition_math_torch` makes on that
    batch, with tiles of 1 it is sum(n_steps) + n, and for any tile it is
    the sum of the plain version's calls tile by tile (affine and spline
    flows);
  * `test_chains_are_independent` of tests/test_torch_nuts.py carried to a
    module-list (arqs, mixed-mask) flow on both sides: the JAX package's
    `_transition_math` through `fused_nuts_for_flow` in Pallas interpret
    mode, and the port's plain version. K1's tile lockstep rests on it:
    a chain's result must not depend on its tile-mates. Discrete outputs
    exactly, the others to 1e-5 (float32 rounding of batched against
    single-row products);
  * the wrappers: the per-warp oracles refuse CPU tensors (no fallback).
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows.kernels.nuts_pallas import fused_nuts_for_flow as j_fused
from tpuflows.targets import NealsFunnel as JFunnel

import math
import struct

from tpuflows_torch.flows import build_flow
from tpuflows_torch.kernels import fused_logp_cuda, nuts_cuda, rqs_cuda
from tpuflows_torch.targets import NealsFunnel

from test_torch_coupling import carry, jax_arqs_flow
from test_torch_nuts_spline import _jax_keys_randomness, _silu_grad
from test_torch_rqs import mirror_vjp

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

D, DEPTH = 8, 4


def _arqs(d, hidden, knots, n_blocks, seed=0):
    g = torch.Generator().manual_seed(seed)
    init = torch.randn((256, d), generator=g)
    return build_flow(init, g, kind="arqs", n_blocks=n_blocks, knots=knots,
                      hidden=hidden, mask_scheme="mixed", clamp=8.0,
                      use_pallas="auto", device="cpu")


def _affine(d, hidden, seed=0):
    g = torch.Generator().manual_seed(seed)
    init = torch.randn((256, d), generator=g)
    return build_flow(init, g, kind="affine", n_blocks=1, hidden=hidden,
                      mask_scheme="leading", clamp=8.0, device="cpu")


def _model(flow):
    d = flow.transforms[0].loc.numel()
    return nuts_cuda.pack_flow(flow, NealsFunnel(dim=d))


# ---------------------------------------------------------------------------
# tile_rows
# ---------------------------------------------------------------------------
def test_tile_rows_of_the_generic_flow_is_8():
    model = _model(_arqs(64, (128, 128), 8, 3))
    assert nuts_cuda.smem_bytes(model) == 4 * (8 * 64 + 4 * 128 + 23 * 64)
    assert nuts_cuda.tile_rows(model) == 8
    # 8 rows and the weight ring: 176 KB of the 227 KB a block may use
    assert nuts_cuda.tile_smem_bytes(model, 8) == 8 * 9984 + 3 * 32768


def test_tile_rows_at_d256_k16_is_at_most_4():
    model = _model(_arqs(256, (64, 128), 16, 1))
    assert nuts_cuda.smem_bytes(model) > 50_000
    assert 1 <= nuts_cuda.tile_rows(model) <= 4


# (d, hidden, knots, blocks): the last two rows leave no room beside one
# row for the whole 96 KB ring (201,728 and 203,776 bytes a row)
TILE_SHAPES = [
    (32, (32, 64), 4, 2), (64, (128, 128), 8, 3), (96, (64, 32), 12, 2),
    (128, (256, 128), 8, 2), (192, (160, 224), 16, 1),
    (256, (128, 256), 16, 2), (256, (256, 256), 16, 5),
    (256, (64, 128), 40, 1), (256, (64, 128), 64, 1),
    (256, (128, 256), 64, 1)]


@pytest.mark.parametrize("d,hidden,knots,blocks", TILE_SHAPES)
def test_tile_rows_never_exceeds_smem_limit(d, hidden, knots, blocks):
    model = _model(_arqs(d, hidden, knots, blocks))
    rows = nuts_cuda.tile_rows(model)
    assert rows >= 1 and rows & (rows - 1) == 0
    assert rows <= nuts_cuda.MAX_TILE_ROWS
    nuts_cuda.check_tile(model, rows)
    tile, stage = nuts_cuda.tile_smem_bytes, nuts_cuda.ring_stage_floats
    full = nuts_cuda.RING_STAGE_FLOATS
    assert tile(model, rows) <= nuts_cuda.SMEM_LIMIT
    if stage(model, 1) == full:
        # each row's scratch and a ring of 3 stages of 32 KB, at the
        # largest such power of two
        assert tile(model, rows) == rows * nuts_cuda.smem_bytes(model) + \
            3 * 32768
        assert (2 * rows > nuts_cuda.MAX_TILE_ROWS
                or stage(model, 2 * rows) < full)
    else:  # one row on a smaller ring
        assert rows == 1 and 0 < stage(model, 1) < full


def _panel_widths(rows):
    """The panels `tile_matvec_part` fills its ring with at a tile of
    `rows`: KC x 32 RPT columns, RPT a power of two up to rows."""
    return {kc * 32 * rpt for kc in (1, 2)
            for rpt in (1, 2, 4, 8) if rpt <= rows}


@pytest.mark.parametrize("d,hidden,knots,blocks", TILE_SHAPES)
@pytest.mark.parametrize("rows", [1, 2, 4, 8])
def test_ring_stage_fits_beside_the_rows(d, hidden, knots, blocks, rows):
    """`ring_stage_floats` (csrc/tile_grad.cuh `tile_ring_stage`): 32 KB a
    stage, or the most that fits beside the rows in a whole number of
    chunks of at least 4 rows of every panel, or 0, and then the tile
    kernels refuse the tile."""
    model = _model(_arqs(d, hidden, knots, blocks))
    stage = nuts_cuda.ring_stage_floats(model, rows)
    row = nuts_cuda.smem_bytes(model)
    step = 256 * rows
    assert 0 <= stage <= nuts_cuda.RING_STAGE_FLOATS and stage % step == 0
    if stage:
        assert nuts_cuda.tile_smem_bytes(model, rows) == \
            rows * row + 3 * 4 * stage <= nuts_cuda.SMEM_LIMIT
        for pw in _panel_widths(rows):
            rc = stage // pw  # rows of the panel a chunk holds
            assert stage % pw == 0 and rc >= 4 and rc % 4 == 0
        assert (stage == nuts_cuda.RING_STAGE_FLOATS
                or rows * row + 3 * 4 * (stage + step)
                > nuts_cuda.SMEM_LIMIT)
        nuts_cuda.check_tile(model, rows)
    else:
        assert rows * row + 3 * 4 * step > nuts_cuda.SMEM_LIMIT
        with pytest.raises(ValueError, match="weight ring"):
            nuts_cuda.check_tile(model, rows)


def test_d256_k64_runs_on_one_row_and_a_smaller_ring():
    model = _model(_arqs(256, (64, 128), 64, 1))
    assert nuts_cuda.smem_bytes(model) == 201_728
    assert nuts_cuda.tile_rows(model) == 1
    # the 30,720 bytes left: 3 stages of 2,560 floats
    assert nuts_cuda.ring_stage_floats(model, 1) == 2560
    assert nuts_cuda.tile_smem_bytes(model, 1) == 201_728 + 3 * 2560 * 4


@pytest.mark.parametrize("check", ["K1 and K2 launch", "K3 launch",
                                   "tile"])
def test_d256_k64_passes_every_kernels_width_checks(check):
    """A module list whose row fits in SMEM_LIMIT but leaves no room for
    the whole ring still packs and passes the checks of K1's and K2's
    launches (`check_launch`), K3's, and the tile kernels'."""
    model = _model(_arqs(256, (64, 128), 64, 1))
    q = torch.zeros((4, 256))
    if check == "K1 and K2 launch":
        nuts_cuda.check_launch(q, (q,), model)
    elif check == "K3 launch":
        fused_logp_cuda._check(q, model)
    else:
        nuts_cuda.check_tile(model, nuts_cuda.tile_rows(model))


@pytest.mark.parametrize("rows", [0, 3, 16])
def test_check_tile_refuses_other_rows(rows):
    model = _model(_arqs(D, (16, 16), 4, 2))
    with pytest.raises(ValueError, match="power of two"):
        nuts_cuda.check_tile(model, rows)


# ---------------------------------------------------------------------------
# tile_matvec's thread layout (csrc/tile_grad.cuh), written out
# ---------------------------------------------------------------------------
def _tile_rpt(n_out, R):
    rpt = 1
    while rpt * 2 <= R and rpt * 64 <= n_out:
        rpt *= 2
    return rpt


def _cells(n_out, R):
    """Every (row, column) that tile_matvec's threads write, with the
    number of writes, and the cells each thread writes."""
    rpt = _tile_rpt(n_out, R)
    nct = 32 * rpt
    kc = 2 if n_out >= 2 * nct else 1
    seen, per_thread = {}, []
    for t in range(32 * R):
        b0, ct = (t // nct) * rpt, t % nct
        mine = 0
        for c0 in range(0, n_out, kc * nct):
            for k in range(kc):
                c = c0 + ct + nct * k
                if c < n_out:
                    mine += rpt
                    for i in range(rpt):
                        seen[(b0 + i, c)] = seen.get((b0 + i, c), 0) + 1
        per_thread.append(mine)
    return seen, per_thread, rpt, nct


@pytest.mark.parametrize("R", [1, 2, 4, 8])
@pytest.mark.parametrize("n_out", [32, 64, 96, 128, 160, 256, 352, 1472])
def test_tile_matvec_writes_every_cell_once(R, n_out):
    seen, per_thread, rpt, nct = _cells(n_out, R)
    assert set(seen) == {(b, c) for b in range(R) for c in range(n_out)}
    assert set(seen.values()) == {1}
    # a warp never straddles two row groups, and a column test is uniform
    # over a warp (nct and n_out are multiples of 32)
    assert nct % 32 == 0 and R % rpt == 0 and nct <= n_out
    # no thread idles, and the busiest does at most twice the mean's work
    # (a ragged last pass)
    assert min(per_thread) >= 1
    assert max(per_thread) <= 2 * R * n_out / len(per_thread)


# ---------------------------------------------------------------------------
# the compact layers of the tile kernels
# ---------------------------------------------------------------------------
def _pad32(n):
    return -(-n // 32) * 32


def _tile_leaves(model):
    """Each module's leaves as the tile kernels read them: Standardize's
    loc and log_scale; a coupling's mask, b1, W2, b2, W2^T from its packed
    leaves and the compact W1, W1^T, W3, b3, W3^T at row[6]. The leaves
    are packed at the lane width d_pad; the compact layers count the
    flow's d dims only."""
    p, d = model.params.detach(), model.d_pad
    out = []
    for row in model.mods.tolist():
        kind, off, h1, h2, K, cbits, coff, n_p = row
        if kind == 0:
            out.append((kind, {"loc": p[off:off + d],
                               "ls": p[off + d:off + 2 * d]}))
            continue
        n_param = 2 if kind == 1 else 3 * K - 1
        n_t = model.d - n_p
        n_in, n_head = _pad32(n_p), _pad32(n_param * n_t)
        L = {"c": struct.unpack("<f", struct.pack("<i", cbits))[0], "K": K,
             "P": n_param, "np": n_p, "nt": n_t, "n_in": n_in,
             "n_head": n_head}
        o = off
        for name, shape in [("mask", (d,)), ("w1", (d, h1)), ("b1", (h1,)),
                            ("w2", (h1, h2)), ("b2", (h2,)),
                            ("w3", (h2, n_param * d)),
                            ("b3", (n_param * d,)), ("w1t", (h1, d)),
                            ("w2t", (h2, h1)), ("w3t", (n_param * d, h2))]:
            L[name] = p[o:o + math.prod(shape)].reshape(shape)
            o += math.prod(shape)
        assert o == coff  # the compact block follows the module's leaves
        for name, shape in [("cw1", (n_in, h1)), ("cw1t", (h1, n_in)),
                            ("cw3", (h2, n_head)), ("cb3", (n_head,)),
                            ("cw3t", (n_head, h2))]:
            L[name] = p[o:o + math.prod(shape)].reshape(shape)
            o += math.prod(shape)
        out.append((kind, L))
    return out


def tile_mirror(model, sigma_v=3.0):
    """z (T, d) -> (lp (T, 1), g (T, d)) the way the tile gradient
    (csrc/tile_grad.cuh) computes them, on the compact layers: the
    conditioner sees the pass-through dims only, its head holds the
    transformed dims' parameters p-major (p nt + t), the backward carries
    only their cotangents and returns the pass-through dims' input
    cotangents. No autograd. It runs at the lane width d_pad, on z with
    zeros appended, as the kernels hold a row, and returns g's first d
    columns."""
    d, dp = model.d, model.d_pad
    mods = _tile_leaves(model)
    real = torch.arange(dp) < d  # a padded dim has no compact place
    silu = torch.nn.functional.silu

    def mlp(L, y, keep):
        xin = torch.zeros(y.shape[0], L["n_in"])
        xin[:, :L["np"]] = y[:, keep]
        a1 = xin @ L["cw1"] + L["b1"]
        a2 = silu(a1) @ L["w2"] + L["b2"]
        head = silu(a2) @ L["cw3"] + L["cb3"]
        used = head[:, :L["P"] * L["nt"]]
        return a1, a2, used.reshape(-1, L["P"], L["nt"])  # (T, P, nt)

    def fn(z):
        z = nuts_cuda.pad_lanes(z, dp)
        x, ladj, bounds = z, torch.zeros(z.shape[0]), [None] * len(mods)
        for k in range(len(mods) - 1, -1, -1):  # sweep 1
            bounds[k] = x
            kind, L = mods[k]
            if kind == 0:
                x = x * torch.exp(L["ls"]) + L["loc"]
                ladj = ladj + L["ls"].sum()
                continue
            keep, moved = (L["mask"] != 0) & real, L["mask"] == 0
            _, _, head = mlp(L, x, keep)
            x = x.clone()
            if kind == 1:
                sc = L["c"] * torch.tanh(head[:, 1] / L["c"])
                x[:, moved] = (x[:, moved] - head[:, 0]) * torch.exp(-sc)
                ladj = ladj - sc.sum(-1)
            else:
                xt, lel = rqs_cuda.plain_eval(
                    x[:, moved], head.transpose(1, 2), L["c"], inverse=True)
                x[:, moved] = xt
                ladj = ladj + lel.sum(-1)
        v, rest = x[:, 0], x[:, 1:]
        sq = (rest * rest).sum(-1)
        env = torch.exp(-v)
        km = float(d - 1)
        lp = (-0.5 * (v / sigma_v) ** 2 - math.log(sigma_v)
              - 0.5 * math.log(2 * math.pi) - 0.5 * sq * env - 0.5 * km * v
              - 0.5 * km * math.log(2 * math.pi)) + ladj
        g = -x * env[:, None]
        g[:, 0] = -v / sigma_v ** 2 + 0.5 * sq * env - 0.5 * km
        for k in range(len(mods)):  # sweep 2
            kind, L = mods[k]
            y = bounds[k]
            if kind == 0:
                g = g * torch.exp(L["ls"])
                continue
            keep, moved = (L["mask"] != 0) & real, L["mask"] == 0
            a1, a2, head = mlp(L, y, keep)
            gt, gd = g[:, moved], g.clone()
            if kind == 1:
                c = L["c"]
                th = torch.tanh(head[:, 1] / c)
                e = torch.exp(-(c * th))
                yt = (y[:, moved] - head[:, 0]) * e
                gh = torch.stack([-gt * e, -(gt * yt + 1.0) * (1.0 - th * th)],
                                 1)
                gd[:, moved] = gt * e
            else:
                dy, draw = mirror_vjp(y[:, moved], head.transpose(1, 2), gt,
                                      torch.ones_like(gt), L["c"], True)
                gd[:, moved] = dy
                gh = draw.transpose(1, 2)
            gin = torch.zeros(y.shape[0], L["n_head"])
            gin[:, :L["P"] * L["nt"]] = gh.reshape(y.shape[0], -1)
            g2 = (gin @ L["cw3t"]) * _silu_grad(a2)
            g1 = (g2 @ L["w2t"]) * _silu_grad(a1)
            gx = g1 @ L["cw1t"]
            g = gd
            g[:, keep] = gd[:, keep] + gx[:, :L["np"]]
        return lp[:, None], g[:, :d]

    return fn


@pytest.mark.parametrize("d,knots,blocks", [(8, 4, 2), (32, 4, 2),
                                            (64, 8, 1)])
def test_packer_writes_the_compact_layers(d, knots, blocks):
    model = _model(_arqs(d, (32, 32), knots, blocks))
    for kind, L in _tile_leaves(model):
        if kind == 0:
            continue
        keep = torch.nonzero(L["mask"][:d] != 0).flatten()
        moved = torch.nonzero(L["mask"] == 0).flatten()
        assert L["np"] == keep.numel() and L["n_in"] % 32 == 0
        assert L["n_head"] % 32 == 0
        torch.testing.assert_close(L["cw1"][:L["np"]], L["w1"][keep],
                                   rtol=0, atol=0)
        torch.testing.assert_close(L["cw1t"], L["cw1"].t(), rtol=0, atol=0)
        cols = (torch.arange(L["P"])[:, None] * model.d_pad
                + moved).reshape(-1)
        used = L["P"] * L["nt"]
        torch.testing.assert_close(L["cw3"][:, :used], L["w3"][:, cols],
                                   rtol=0, atol=0)
        torch.testing.assert_close(L["cb3"][:used], L["b3"][cols], rtol=0,
                                   atol=0)
        torch.testing.assert_close(L["cw3t"], L["cw3"].t(), rtol=0, atol=0)
        for pad in (L["cw1"][L["np"]:], L["cw3"][:, used:],
                    L["cb3"][used:]):
            assert not pad.any()  # zero padding


@pytest.mark.parametrize("d,knots,blocks,seed", [(8, 4, 2, 0), (8, 8, 3, 1),
                                                 (32, 4, 2, 2),
                                                 (64, 8, 1, 3)])
def test_tile_mirror_matches_autograd(d, knots, blocks, seed):
    flow = _arqs(d, (16, 32), knots, blocks, seed)
    model = _model(flow)
    z = torch.randn((48, d), generator=torch.Generator().manual_seed(seed))
    lp_a, g_a = nuts_cuda.autograd_logp_grad(
        flow, model.target.log_density)(z)
    with torch.no_grad():
        lp_t, g_t = tile_mirror(model)(z)
    torch.testing.assert_close(lp_t, lp_a, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(g_t, g_a, rtol=1e-4, atol=1e-4)


def test_affine_only_flow_packs_no_compact_layers():
    """Standardize + one AffineCoupling runs on the tile kernels too: its
    `Net` layout, which ends at W3^T, is followed by the compact layers,
    and the coupling's row of the module list holds their offset and the
    number of pass-through dims in columns 6-7 (Standardize's stay 0)."""
    model = _model(_affine(D, (16, 16)))
    assert model.mods[:, 0].tolist() == [0, 1]  # Standardize + affine
    # the leaves at the lane width, the hidden widths padded to 32
    d, h1, h2 = model.d_pad, 32, 32
    assert model.hidden == (h1, h2)
    n = 2 * d + d + d * h1 + h1 + h1 * h2 + h2 + h2 * 2 * d + 2 * d + \
        h1 * d + h2 * h1 + 2 * d * h2
    n_p = int(sum(model.flow.transforms[1].mask))
    assert model.mods[:, 6:].tolist() == [[0, 0], [n, n_p]]
    n_in, n_head = _pad32(n_p), _pad32(2 * (D - n_p))
    assert model.params.numel() == n + 2 * n_in * h1 + 2 * h2 * n_head + \
        n_head
    (_, std), (kind, L) = _tile_leaves(model)
    assert kind == 1 and L["np"] == n_p and L["n_head"] == n_head


# ---------------------------------------------------------------------------
# lockstep_gradients against the plain version's gradient calls
# ---------------------------------------------------------------------------
def _counted(fn):
    calls = [0]

    def wrapped(z):
        calls[0] += 1
        return fn(z)

    return wrapped, calls


def _plain(model, q, rnd, eps, im, depth):
    grad, calls = _counted(nuts_cuda.plain_logp_grad(model))
    out = nuts_cuda.transition_math_torch(q, *rnd, eps, im, grad, depth)
    return out, calls[0]


def _lockstep_inputs(kind, n=24, depth=5, seed=3):
    flow = (_affine(D, (16, 16), seed) if kind == "affine"
            else _arqs(D, (16, 16), 4, 2, seed))
    model = _model(flow)
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((n, D), generator=g)
    im = 0.5 + torch.rand(D, generator=g)
    rnd = nuts_cuda.draw_randomness(g, n, D, depth, im)
    return model, q, rnd, torch.tensor(0.35), im, depth


@pytest.mark.parametrize("kind", ["affine", "spline"])
def test_lockstep_count_of_the_whole_batch_is_the_plain_calls(kind):
    model, q, rnd, eps, im, depth = _lockstep_inputs(kind)
    out, calls = _plain(model, q, rnd, eps, im, depth)
    steps = out[3]
    assert len(torch.unique(steps)) >= 3  # trees of different sizes
    n = q.shape[0]
    assert nuts_cuda.lockstep_gradients(steps, n) == calls
    assert nuts_cuda.lockstep_gradients(steps, 1) == int(steps.sum()) + n
    assert calls < int(steps.sum()) + n  # the batch shares its leaf steps


@pytest.mark.parametrize("kind", ["affine", "spline"])
@pytest.mark.parametrize("rows", [2, 4, 8, 16])
def test_lockstep_count_is_the_plain_calls_tile_by_tile(kind, rows):
    """Tiles of `rows` chains in batch order, the last one ragged where n
    is not a multiple of rows: the plain version run on each tile alone
    makes as many gradient calls as the kernel's lockstep does there."""
    model, q, rnd, eps, im, depth = _lockstep_inputs(kind)
    steps = _plain(model, q, rnd, eps, im, depth)[0][3]
    total = 0
    for lo in range(0, q.shape[0], rows):
        sl = slice(lo, lo + rows)
        out, calls = _plain(model, q[sl], [r[sl] for r in rnd], eps, im,
                            depth)
        torch.testing.assert_close(out[3], steps[sl], rtol=0, atol=0)
        total += calls
    assert nuts_cuda.lockstep_gradients(steps, rows) == total


# ---------------------------------------------------------------------------
# chains are independent on module-list flows (the tile lockstep's premise)
# ---------------------------------------------------------------------------
def _chain_by_chain(run, n):
    outs = [run(slice(i, i + 1)) for i in range(n)]
    return tuple(np.concatenate([o[j] for o in outs]) for j in range(8))


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_module_list_chains_are_independent(side):
    jf, tf = jax_arqs_flow(11), None
    n, eps = 16, 0.3
    q = (np.random.default_rng(511).normal(size=(n, D))).astype(np.float32)
    im = np.linspace(0.6, 1.4, D).astype(np.float32)
    keys = jax.random.split(jax.random.key(21), n)
    if side == "jax":
        trans = jax.jit(j_fused(JFunnel(dim=D).log_density, jf,
                                max_depth=DEPTH, tile_b=8, interpret=True))

        def run(sl):
            jq, info = trans(keys[sl], jnp.asarray(q[sl]), jnp.asarray(eps),
                             jnp.asarray(im))
            return (np.asarray(jq), np.asarray(info.logp),
                    np.asarray(info.accept_prob),
                    np.asarray(info.num_steps), np.asarray(info.tree_depth),
                    np.asarray(info.diverging), np.asarray(info.turning),
                    np.asarray(info.energy))
    else:
        tf = carry(jf, use_pallas="auto")
        model = _model(tf)
        rnd = [torch.from_numpy(a) for a in _jax_keys_randomness(
            keys, D, DEPTH, jnp.asarray(im))]

        def run(sl):
            out = nuts_cuda.nuts_transition(
                torch.from_numpy(q[sl]), *(r[sl] for r in rnd),
                torch.tensor(eps), torch.from_numpy(im), model, DEPTH)
            return tuple(o.numpy() for o in out)
    batch = run(slice(0, n))
    single = _chain_by_chain(run, n)
    assert len(np.unique(batch[4])) >= 2  # trees of different depths
    for j in (3, 4, 5, 6):  # leapfrogs, depth, divergence, U-turn
        np.testing.assert_array_equal(single[j], batch[j])
    for j in (0, 1, 2, 7):  # q, logp, acceptance, energy
        np.testing.assert_allclose(single[j], batch[j], rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# chip_smoke.py's accounting of the tile kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,key", [
    ("_ZN55_GLOBAL__N__bba1580c_18_nuts_transition_cu_92810086_24622nuts_"
     "chain_tile_kernelILi2EEEvN13tpuflows_nuts4ArgsENS1_9ChainListEi",
     "chain tile d/32=2"),
    ("_ZN50_GLOBAL__N__32e37747_13_fused_logp_cu_0298189b_27222fused_logp_"
     "tile_kernelILi8EEEvN13tpuflows_nuts4ArgsENS1_9ChainListEi",
     "K3 tile d/32=8")])
def test_ptxas_summary_names_the_tile_kernels(name, key):
    log = (f"ptxas info    : Compiling entry function '{name}' for "
           "'sm_90a'\n    0 bytes stack frame, 4 bytes spill stores, 8 "
           "bytes spill loads\nptxas info    : Used 255 registers, used 1 "
           "barriers\n")
    assert chip_smoke.ptxas_summary(log) == {key: {
        "spill_stores": 4, "spill_loads": 8, "registers": 255,
        "static_smem": 0}}


def test_value_diff_counts_values_and_zero_signs_apart():
    a = torch.tensor([1.0, 0.0, -0.0, float("nan"), 2.0, 3.0])
    b = torch.tensor([1.0, -0.0, -0.0, float("nan"), 2.5, 3.0])
    differ, zero_signs, max_abs = chip_smoke.value_diff(a, b)
    assert (differ, zero_signs, max_abs) == (1, 1, 0.5)


def test_lockstep_efficiency_of_equal_trees_is_one():
    steps = torch.tensor([3.0, 3.0, 7.0, 7.0])
    assert chip_smoke.lockstep_efficiency(steps, 2) == 1.0
    # a tile of a 1-leaf and a 7-leaf chain computes 4 + 4 gradients for
    # 2 + 8 useful ones
    assert chip_smoke.lockstep_efficiency(torch.tensor([1.0, 7.0]),
                                          2) == 10 / 16


# ---------------------------------------------------------------------------
# the wrappers on the CPU
# ---------------------------------------------------------------------------
def test_per_warp_oracles_refuse_cpu_tensors():
    model = _model(_arqs(D, (16, 16), 4, 2))
    g = torch.Generator().manual_seed(0)
    q = torch.randn((4, D), generator=g)
    rnd = nuts_cuda.draw_randomness(g, 4, D, DEPTH, torch.ones(D))
    with pytest.raises(ValueError, match="CUDA"):
        nuts_cuda.chain_transition_warp(q, *rnd, torch.tensor(0.3),
                                        torch.ones(D), model, DEPTH)
    with pytest.raises(ValueError, match="CUDA"):
        fused_logp_cuda.chain_logp_grad_warp(q, model)
