"""K1's and K2's affine flow (Standardize + one AffineCoupling, the
ceiling path) on the tile kernels, on the CPU: what the host decides and
what the design rests on. The kernels run only on the card, where
`chip_smoke.py` (phase `tile_vs_warp`) holds them, in both weight modes,
to the per-warp module-list kernels bit for bit.

  * `pack_flow` keeps the `Net` layout (loc, log_scale, mask, W1, b1, W2,
    b2, W3, b3 and the transposes, the order the module-list kernels read
    a coupling's leaves in) as the prefix of the packed buffer, element
    for element against a `Net`-only pack, and appends the tile kernels'
    compact layers after it, their offset and the number of pass-through
    dims in columns 6-7 of the coupling's row of the module list;
  * `tile_mirror` (tests/test_torch_tile_grad.py), the tile gradient's
    per-row math in torch on the compact layers, matches autograd through
    the port's flow and the JAX package's `inverse_and_ladj` gradient on
    affine flows carried across with `convert.py` (leading and random
    masks, d = 32 and 64, hidden 16-128), to 1e-4 (float32 rounding of
    differently ordered sums);
  * the wrappers' routing: K1's and K2's `_launch` call the tile entry
    points at R = `tile_rows(model)` (8 at the ceiling flow) with the
    resident weights where they fit, the ring or another R only when
    asked; K3's calls `fused_logp_chain_f32` too, by the same rule.
    Checked with a recorder in
    place of the library call; the per-warp module-list oracle takes the
    affine flow's list;
  * the resident choice (`resident_fits`, the host's copy of
    csrc/tile_grad.cuh `tile_resident_floats` / `tile_resident_fits`):
    true at the ceiling flow at R = 8, false at the generic arqs flow and
    at h = 256, never over SMEM_LIMIT, and sized from the compact layers'
    own widths; every affine shape of `chip_smoke.OTHER_SHAPES` and its
    window rows runs on the tile kernels;
  * `lockstep_gradients` / `window_lockstep_gradients` on affine flows
    with random masks: the plain version's gradient calls, tile by tile;
  * a CPU tensor runs the plain version and counts no launch.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows.targets import NealsFunnel as JFunnel

from tpuflows_torch.kernels import fused_logp_cuda, nuts_cuda
from tpuflows_torch.kernels import nuts_window_cuda as nw
from tpuflows_torch.targets import NealsFunnel

from test_torch_nuts import flow_leaves, jax_flow, torch_flow
from test_torch_tile_grad import _arqs, _pad32, _tile_leaves, tile_mirror

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def _mask(d, kind, seed):
    if kind == "leading":
        return tuple(1 if j == 0 else 0 for j in range(d))
    rng = np.random.default_rng(700 + seed)
    return tuple(int(b) for b in rng.integers(0, 2, d))


def _flows(d, hidden, mask_kind, seed):
    """(JAX flow, the port's flow carried across, its packed model)."""
    jf = jax_flow(flow_leaves(seed, d=d, hidden=hidden,
                              mask=_mask(d, mask_kind, seed)))
    tf = torch_flow(jf)
    return jf, tf, nuts_cuda.pack_flow(tf, NealsFunnel(dim=d))


def _ceiling():
    """The ceiling flow's widths: d = 64, leading mask, hidden 128 x 128."""
    return _flows(64, (128, 128), "leading", 0)[2]


# (d, hidden, mask, seed) of the small affine flows
AFFINE_FLOWS = [(32, (16, 32), "leading", 0), (32, (32, 32), "random", 1),
                (64, (64, 128), "random", 2), (64, (128, 128), "leading", 3),
                (64, (128, 96), "random", 4)]


# ---------------------------------------------------------------------------
# the packed buffer: the `Net` prefix and the compact tail
# ---------------------------------------------------------------------------
def _net_only(tf):
    """The `Net` layout of Standardize + one AffineCoupling: loc,
    log_scale, mask, W1, b1, W2, b2, W3, b3, W1^T, W2^T, W3^T."""
    std, cp = tf.transforms
    ws, bs = cp.net.weights, cp.net.biases
    parts = [std.loc, std.log_scale, cp.mask_f, ws[0], bs[0], ws[1], bs[1],
             ws[2], bs[2], ws[0].t(), ws[1].t(), ws[2].t()]
    return torch.cat([p.detach().float().reshape(-1) for p in parts])


def _as_packed(tf, model):
    """`tf` as `pack_flow` packs it: each module at the lane width, each
    hidden width a multiple of 32 (`_pad_module`; (16, 32) packs as (32,
    32))."""
    return type(tf)([nuts_cuda._pad_module(t, model.d, model.d_pad)
                     if nuts_cuda._needs_pad(t, model.d, model.d_pad)
                     else t for t in tf.transforms])


@pytest.mark.parametrize("d,hidden,mask,seed", AFFINE_FLOWS)
def test_net_prefix_is_unchanged_and_the_compact_layers_follow(d, hidden,
                                                               mask, seed):
    _, tf, model = _flows(d, hidden, mask, seed)
    assert model.mods[:, 0].tolist() == [0, 1]  # Standardize + affine
    assert model.hidden == tuple(-(-h // 32) * 32 for h in hidden)
    hidden = model.hidden
    net = _net_only(_as_packed(tf, model))
    p = model.params
    torch.testing.assert_close(p[:net.numel()], net, rtol=0, atol=0)
    assert model.mods[:, 6:].tolist() == [[0, 0], [net.numel(),
                                                   int(sum(tf.transforms[1]
                                                           .mask))]]
    (_, _), (kind, L) = _tile_leaves(model)  # asserts the compact offset
    keep = torch.nonzero(L["mask"] != 0).flatten()
    moved = torch.nonzero(L["mask"] == 0).flatten()
    torch.testing.assert_close(L["cw1"][:L["np"]], L["w1"][keep], rtol=0,
                               atol=0)
    cols = torch.cat([moved, d + moved])  # shift, then scale, p-major
    used = 2 * L["nt"]
    torch.testing.assert_close(L["cw3"][:, :used], L["w3"][:, cols],
                               rtol=0, atol=0)
    torch.testing.assert_close(L["cb3"][:used], L["b3"][cols], rtol=0,
                               atol=0)
    torch.testing.assert_close(L["cw1t"], L["cw1"].t(), rtol=0, atol=0)
    torch.testing.assert_close(L["cw3t"], L["cw3"].t(), rtol=0, atol=0)
    end = net.numel() + 2 * L["n_in"] * hidden[0] + \
        2 * hidden[1] * L["n_head"] + L["n_head"]
    assert p.numel() == end


# ---------------------------------------------------------------------------
# the tile gradient's per-row math on affine flows
# ---------------------------------------------------------------------------
def _jax_logp_grad(jf, z):
    target = JFunnel(dim=z.shape[1])

    def tm(x):
        xx, ladj = jf.inverse_and_ladj(x)
        return target.log_density(xx) + ladj

    lp, pull = jax.vjp(tm, jnp.asarray(z))
    (g,) = pull(jnp.ones_like(lp))
    return np.asarray(lp)[:, None], np.asarray(g)


@pytest.mark.parametrize("d,hidden,mask,seed", AFFINE_FLOWS)
def test_tile_mirror_matches_autograd_and_jax(d, hidden, mask, seed):
    jf, tf, model = _flows(d, hidden, mask, seed)
    z = np.random.default_rng(900 + seed).normal(
        size=(40, d)).astype(np.float32)
    zt = torch.from_numpy(z)
    with torch.no_grad():
        lp_t, g_t = tile_mirror(model)(zt)
    lp_a, g_a = nuts_cuda.autograd_logp_grad(
        tf, model.target.log_density)(zt)
    torch.testing.assert_close(lp_t, lp_a, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(g_t, g_a, rtol=1e-4, atol=1e-4)
    lp_j, g_j = _jax_logp_grad(jf, z)
    np.testing.assert_allclose(lp_t.numpy(), lp_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the wrappers' routing
# ---------------------------------------------------------------------------
def _k1_launched(monkeypatch, model, **kw):
    """(entry point, rows, resident floats, launch count) of one K1
    `_launch` on CPU tensors, the library call replaced by a recorder."""
    seen = []
    monkeypatch.setattr(nuts_cuda, "_call",
                        lambda name, q, args: seen.append((name, args)))
    monkeypatch.setattr(nuts_cuda, "LAUNCHES", 0)
    d, n, depth = model.d, 5, 3
    g = torch.Generator().manual_seed(0)
    q = torch.zeros((n, d))
    rnd = nuts_cuda.draw_randomness(g, n, d, depth, torch.ones(d))
    out = nuts_cuda._launch(q, *rnd, torch.tensor(0.1), torch.ones(d),
                            model, depth, **kw)
    assert len(out) == 8 and out[0].shape == (n, d) and len(seen) == 1
    name, args = seen[0]
    return name, args[-2], args[-1], nuts_cuda.LAUNCHES


def _k2_launched(monkeypatch, model, **kw):
    seen = []

    def record(name, *args, extra=()):
        seen.append((name, extra))
        return "result"

    monkeypatch.setattr(nw, "_call", record)
    monkeypatch.setattr(nw, "LAUNCHES", 0)
    d, S, depth = model.d, 2, 3
    g = torch.Generator().manual_seed(0)
    q = torch.zeros((5, d))
    rnd = nw.draw_window_randomness(g, 5, d, S, depth, torch.ones(d))
    assert nw._launch(q, *rnd, torch.tensor(0.1), torch.ones(d), model,
                      depth, S, None, **kw) == "result"
    assert len(seen) == 1
    return (seen[0][0], *seen[0][1], nw.LAUNCHES)


@pytest.mark.parametrize("kernel", ["K1", "K2"])
@pytest.mark.parametrize("kw,want", [
    ({}, (8, True)), ({"resident": False}, (8, False)),
    ({"rows": 4}, (4, True)), ({"rows": 4, "resident": False}, (4, False)),
    ({"rows": 8, "resident": True}, (8, True))])
def test_ceiling_flow_launches_the_tile_kernel(monkeypatch, kernel, kw,
                                               want):
    model = _ceiling()
    assert nuts_cuda.tile_rows(model) == 8
    rows, resident = want
    floats = model.resident_floats if resident else 0
    if kernel == "K1":
        got = _k1_launched(monkeypatch, model, **kw)
        assert got == ("nuts_chain_transition_f32", rows, floats, 1)
    else:
        got = _k2_launched(monkeypatch, model, **kw)
        assert got == ("nuts_chain_window_f32", rows, floats, 1)


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_resident_weights_are_refused_where_they_do_not_fit(monkeypatch,
                                                            kernel):
    """h = 256: the ring only; asking for resident weights raises, and
    nothing is launched or counted."""
    model = _flows(64, (256, 256), "leading", 5)[2]
    assert not nuts_cuda.resident_fits(model, nuts_cuda.tile_rows(model))
    launched = _k1_launched if kernel == "K1" else _k2_launched
    assert launched(monkeypatch, model)[-2:] == (0, 1)
    with pytest.raises(ValueError, match="resident"):
        launched(monkeypatch, model, resident=True)
    assert (nuts_cuda if kernel == "K1" else nw).LAUNCHES == 0


def _k3_launched(monkeypatch, model, **kw):
    seen = []
    monkeypatch.setattr(fused_logp_cuda, "_call",
                        lambda name, z, args: seen.append((name, args)))
    monkeypatch.setattr(fused_logp_cuda, "LAUNCHES", 0)
    lp, g = fused_logp_cuda._launch(torch.zeros((6, model.d)), model, **kw)
    assert lp.shape == (6,) and g.shape == (6, model.d) and len(seen) == 1
    name, args = seen[0]
    return name, args[-2], args[-1], fused_logp_cuda.LAUNCHES


def test_k3_keeps_its_affine_kernel(monkeypatch):
    """K3 keeps taking the affine flow, now on the tile kernel: the
    ceiling flow launches `fused_logp_chain_f32` at R = 8 with its weights
    resident, K1's and K2's mode there and K3's fastest on the card."""
    model = _ceiling()
    assert nuts_cuda.tile_rows(model) == 8
    assert nuts_cuda.resident_fits(model, 8)
    assert _k3_launched(monkeypatch, model) == (
        "fused_logp_chain_f32", 8, model.resident_floats, 1)


@pytest.mark.parametrize("kw,want", [
    ({"resident": False}, (8, False)), ({"rows": 4}, (4, True)),
    ({"rows": 8, "resident": False}, (8, False)),
    ({"rows": 4, "resident": True}, (4, True))])
def test_k3_takes_every_tile_mode_of_the_ceiling_flow(monkeypatch, kw,
                                                      want):
    model = _ceiling()
    rows, resident = want
    floats = model.resident_floats if resident else 0
    assert _k3_launched(monkeypatch, model, **kw) == (
        "fused_logp_chain_f32", rows, floats, 1)


def test_k3_module_lists_keep_the_ring_at_tile_rows(monkeypatch):
    """A flow with six couplings (the generic arqs flow) has no resident
    mode: K3 takes `tile_rows` and the ring, and refuses resident
    weights without launching."""
    model = nuts_cuda.pack_flow(_arqs(64, (128, 128), 8, 3),
                                NealsFunnel(dim=64))
    assert _k3_launched(monkeypatch, model) == (
        "fused_logp_chain_f32", nuts_cuda.tile_rows(model), 0, 1)
    with pytest.raises(ValueError, match="resident"):
        _k3_launched(monkeypatch, model, resident=True)
    assert fused_logp_cuda.LAUNCHES == 0


def test_per_warp_module_list_oracle_takes_the_affine_flow(monkeypatch):
    """`chain_logp_grad_warp` no longer refuses the affine flow's list: on
    a CPU tensor it stops at the device check, and with a recorder in
    place of the library call it launches the per-warp module-list kernel
    on the ceiling flow's list, counting nothing."""
    model = _ceiling()
    with pytest.raises(ValueError, match="CUDA z"):
        fused_logp_cuda.chain_logp_grad_warp(torch.zeros((4, 64)), model)
    seen = []
    monkeypatch.setattr(fused_logp_cuda, "_call",
                        lambda name, z, args: seen.append((name, args)))
    monkeypatch.setattr(fused_logp_cuda, "_yardstick",
                        lambda z, m: (torch.empty(z.shape[0]),
                                      torch.empty_like(z)))
    monkeypatch.setattr(fused_logp_cuda, "LAUNCHES", 0)
    lp, g = fused_logp_cuda.chain_logp_grad_warp(torch.zeros((4, 64)),
                                                 model)
    assert [name for name, _ in seen] == ["fused_logp_chain_warp_f32"]
    assert seen[0][1][4] == model.mods.shape[0] == 2
    assert fused_logp_cuda.LAUNCHES == 0


# ---------------------------------------------------------------------------
# the resident choice
# ---------------------------------------------------------------------------
def test_resident_choice_at_the_ceiling_generic_and_h256():
    ceiling = _ceiling()
    assert nuts_cuda.resident_fits(ceiling, 8)
    assert nuts_cuda.resident_fits(ceiling, 4)
    # compact 32 -> 128 -> 128 -> 128 with rows of n_out + 1 floats
    assert ceiling.resident_floats == 32 * 129 + 128 * 129 + 128 * 129
    assert 8 * nuts_cuda.smem_bytes(ceiling) == 8 * 4 * 832
    generic = nuts_cuda.pack_flow(_arqs(64, (128, 128), 8, 3),
                                  NealsFunnel(dim=64))
    assert generic.resident_floats == 0
    assert not any(nuts_cuda.resident_fits(generic, R) for R in (1, 8))
    wide = _flows(64, (256, 256), "random", 6)[2]
    assert wide.resident_floats > 0
    assert not any(nuts_cuda.resident_fits(wide, R) for R in (1, 2, 4, 8))
    assert nuts_cuda.launch_resident(ceiling, 8) == ceiling.resident_floats
    assert nuts_cuda.launch_resident(generic, 8) == 0


@pytest.mark.parametrize("d", [32, 96, 160, 256])
@pytest.mark.parametrize("h1,h2", [(32, 32), (64, 128), (160, 96),
                                   (256, 32)])
@pytest.mark.parametrize("mask", ["leading", "random"])
def test_resident_choice_never_exceeds_smem_limit(d, h1, h2, mask):
    model = _flows(d, (h1, h2), mask, d + h1)[2]
    (_, _), (_, L) = _tile_leaves(model)
    assert model.resident_floats == L["n_in"] * (h1 + 1) + \
        h1 * (h2 + 1) + h2 * (L["n_head"] + 1)
    assert L["n_in"] == _pad32(L["np"])
    rows = nuts_cuda.tile_rows(model)
    assert rows == 8  # an affine row is at most 2,304 floats
    for R in (1, 2, 4, 8):
        fits = nuts_cuda.resident_fits(model, R)
        used = R * nuts_cuda.smem_bytes(model) + 4 * model.resident_floats
        assert fits == (used <= nuts_cuda.SMEM_LIMIT)


def _shape_model(d, h1, h2, scheme):
    return nuts_cuda.pack_flow(chip_smoke.shape_flow("cpu", d, h1, h2,
                                                     scheme),
                               NealsFunnel(dim=d))


@pytest.mark.parametrize("d,h1,h2,depth,eps,n,scheme",
                         chip_smoke.OTHER_SHAPES)
def test_every_affine_shape_runs_on_the_tile_kernels(d, h1, h2, depth, eps,
                                                     n, scheme):
    """The affine shapes of `chip_smoke.OTHER_SHAPES` pass the tile
    kernels' checks at R = tile_rows (8), with the ring or resident
    weights."""
    model = _shape_model(d, h1, h2, scheme)
    q = torch.zeros((n, d))
    nuts_cuda.check_launch(q, (q,), model)
    rows = nuts_cuda.launch_rows(model)
    assert rows == 8 and nuts_cuda.ring_stage_floats(model, rows) == \
        nuts_cuda.RING_STAGE_FLOATS
    assert nuts_cuda.launch_resident(model, rows) in (
        0, model.resident_floats)
    for R in chip_smoke.fitting_rows(model, chip_smoke.TILE_ROWS):
        nuts_cuda.check_tile(model, R)


def test_tile_modes_measure_the_resident_weights_where_they_fit():
    assert chip_smoke.tile_modes(_ceiling(), chip_smoke.TILE_ROWS) == [
        (4, False), (4, True), (8, False), (8, True)]
    wide = _shape_model(256, 128, 256, "random")
    assert chip_smoke.tile_modes(wide, chip_smoke.TILE_ROWS) == [
        (4, False), (8, False)]


@pytest.mark.parametrize("name,key", [
    ("_ZN55_GLOBAL__N__5c1e2b0a_14_nuts_window_cu_4f5d8e21_31123nuts_"
     "window_tile_kernelILi2ELb1EEEvN13tpuflows_nuts4ArgsENS1_9ChainListEii",
     "K2 tile d/32=2 resident"),
    ("_ZN55_GLOBAL__N__5c1e2b0a_14_nuts_window_cu_4f5d8e21_31123nuts_"
     "window_tile_kernelILi2ELb0EEEvN13tpuflows_nuts4ArgsENS1_9ChainListEii",
     "K2 tile d/32=2"),
    ("_ZN54_GLOBAL__N__4b7e_18_nuts_transition_cu_0d1b2c3a_27322nuts_"
     "chain_tile_kernelILi8ELb1EEEvN13tpuflows_nuts4ArgsENS1_9ChainListEi",
     "chain tile d/32=8 resident")])
def test_kernel_key_names_the_resident_instantiation(name, key):
    assert chip_smoke._kernel_key(name) == key


# ---------------------------------------------------------------------------
# lockstep counts on affine flows with random masks
# ---------------------------------------------------------------------------
def _counted(fn):
    calls = [0]

    def wrapped(z):
        calls[0] += 1
        return fn(z)

    return wrapped, calls


def _affine_inputs(n=20, d=32, depth=4, window=3, seed=7):
    model = _flows(d, (32, 32), "random", seed)[2]
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((n, d), generator=g)
    im = 0.5 + torch.rand(d, generator=g)
    return model, q, im, g, torch.tensor(0.6), depth, window


@pytest.mark.parametrize("rows", [2, 4, 8])
def test_k1_lockstep_count_is_the_plain_calls_tile_by_tile(rows):
    model, q, im, g, eps, depth, _ = _affine_inputs()
    rnd = nuts_cuda.draw_randomness(g, q.shape[0], model.d, depth, im)

    def plain(sl):
        grad, calls = _counted(nuts_cuda.plain_logp_grad(model))
        out = nuts_cuda.transition_math_torch(
            q[sl], *[r[sl] for r in rnd], eps, im, grad, depth)
        return out[3], calls[0]

    steps = plain(slice(None))[0]
    assert len(torch.unique(steps)) >= 3  # trees of different sizes
    total = sum(plain(slice(lo, lo + rows))[1]
                for lo in range(0, q.shape[0], rows))
    assert nuts_cuda.lockstep_gradients(steps, rows) == total


@pytest.mark.parametrize("rows", [2, 4, 8])
def test_k2_lockstep_count_is_the_plain_calls_tile_by_tile(rows):
    model, q, im, g, eps, depth, S = _affine_inputs()
    rnd = nw.draw_window_randomness(g, q.shape[0], model.d, S, depth, im)

    def plain(sl):
        grad, calls = _counted(nuts_cuda.plain_logp_grad(model))
        out = nw.chain_slots(
            lambda z, *r: nuts_cuda.transition_math_torch(
                z, *r, eps, im, grad, depth),
            q[sl], *[r[sl] for r in rnd], S, depth)
        return out[3], calls[0] - (S - 1)  # later slots carry lp and g

    steps = plain(slice(None))[0]
    assert steps.shape == (S, q.shape[0])
    total = sum(plain(slice(lo, lo + rows))[1]
                for lo in range(0, q.shape[0], rows))
    assert nw.window_lockstep_gradients(steps, rows) == total


# ---------------------------------------------------------------------------
# a CPU tensor runs the plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_cpu_tensor_runs_the_plain_version_with_no_launch(monkeypatch,
                                                          kernel):
    model, q, im, g, eps, depth, S = _affine_inputs(n=6)
    mod = nuts_cuda if kernel == "K1" else nw
    monkeypatch.setattr(mod, "LAUNCHES", 0)
    monkeypatch.setattr(mod, "_call", None)  # any launch would fail
    if kernel == "K1":
        rnd = nuts_cuda.draw_randomness(g, 6, model.d, depth, im)
        out = nuts_cuda.nuts_transition(q, *rnd, eps, im, model, depth)
        ref = nuts_cuda.transition_math_torch(
            q, *rnd, eps, im, nuts_cuda.plain_logp_grad(model), depth)
    else:
        rnd = nw.draw_window_randomness(g, 6, model.d, S, depth, im)
        out = nw.nuts_window(q, *rnd, eps, im, model, depth, S)
        ref = nw.window_math_torch(q, *rnd, eps, im,
                                   nuts_cuda.plain_logp_grad(model), S,
                                   depth)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert mod.LAUNCHES == 0
