"""K1, K2 and K3 past the register units' reach, and the public names the
port had lacked: the plain versions against the JAX package on the CPU.

  * (a) hidden widths that are not multiples of 32 ([48], [100]) or past
    256 ([320, 320]): `pack_flow` pads each to a multiple of 32 with zero
    units (`_pad_module`); the plain transition on the padded flow equals
    the one on the flow as given to the bit (d = 32, so that only the
    hidden widths are padded), and K1's plain version matches the JAX
    package's fused math (`fused_nuts_for_flow(..., interpret=False)`, on
    the randomness it derives from its keys) within the bar of
    tests/test_torch_nuts.py (at most one knife-edge chain; 1e-4);
  * (b) max_depth 11 and 12 with a step small enough that trees pass depth
    10: K1's plain version against the JAX fused math, and K2's (a window
    of one slot at depth 11) against the JAX window on its replayed draws
    (tests/test_torch_nuts_window.py's bar);
  * (c) d = 288 and 514 (the wide units' widths): K1's plain version
    against the JAX fused math, K3's against the JAX package's latent log
    density and its gradient (`flow_reparameterized` under `jax.grad`, the
    reference of its Pallas kernel), and the packed targets the wide units
    read (the hierarchical model, the correlated Gaussian's d x d
    precision) against the JAX targets;
  * (d) the limits: what the kernels take (d <= 1024, max_depth <= 16,
    hidden widths <= 4096) packs and builds a transition; past them
    `pack_flow`, `FusedNUTS` and `FusedNUTSWindow` refuse when they are
    built; `wide_path` sends d > 256, depth > 10 and a row too wide for
    shared memory to the wide units; the runner's "auto" takes K1 at depth
    11 and at `hidden: [48]` and returns None past the limits, where "on"
    raises naming them; the host's constants are the CUDA sources';
  * (e) `tpuflows_torch.mcmc.to_latent_space` and
    `tpuflows_torch.kernels.rqs_forward_from_raw` /
    `rqs_inverse_from_raw` against the JAX package's, and importing
    `tpuflows_torch.kernels` builds and loads nothing.

About 60 s of CPU on one worker (eight JAX compiles at XLA optimization
level 2, the deep trees' few thousand leapfrogs of a few chains).
"""
import dataclasses as dc
import functools
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows.flows.affine import AffineCoupling as JAffine
from tpuflows.flows.affine import Standardize as JStandardize
from tpuflows.flows.core import Chain as JChain
from tpuflows.flows.coupling import RQSCouplingBlock as JRQS
from tpuflows.kernels import rqs_forward_from_raw as j_rqs_forward
from tpuflows.kernels import rqs_inverse_from_raw as j_rqs_inverse
from tpuflows.kernels.nuts_pallas import fused_nuts_for_flow as j_fused
from tpuflows.kernels.nuts_pallas import (
    fused_nuts_window_for_flow as j_window)
from tpuflows.mcmc.preconditioned import flow_reparameterized as j_reparam
from tpuflows.mcmc.preconditioned import to_latent_space as j_to_latent

from tpuflows_torch import config as tconfig
from tpuflows_torch import run as trun
from tpuflows_torch import targets as T
from tpuflows_torch.kernels import fused_logp_cuda, nuts_cuda
from tpuflows_torch.kernels import nuts_window_cuda as nw
from tpuflows_torch.util.shapes import alternating_mask, leading_mask

from test_torch_coupling import carry
from test_torch_nuts import compare
from test_torch_nuts_spline import _jax_keys_randomness
from test_torch_nuts_targets import (_mlp, assert_close_scaled, optimized,
                                     padded_model, points, targets)
from test_torch_nuts_window import (TOL_JAX, assert_window_close,
                                    jax_window_draws)

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "tpuflows_torch" / "csrc"
BAR = dict(rtol=1e-4, atol=1e-4)
N = 8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Thousands of small ops: one intra-op thread keeps parallel test
    workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_flow(kind, d, hidden, seed=0, knots=4, scale=0.1):
    """Standardize + a leading-mask affine coupling ("affine"), or
    Standardize + 2 RQS blocks on alternating masks ("rqs"), of `hidden`
    widths, every leaf from numpy."""
    rng = np.random.default_rng(seed)
    f32 = jnp.float32
    mods = [JStandardize(loc=jnp.asarray(rng.normal(0, 0.2, d), f32),
                         log_scale=jnp.asarray(rng.normal(0, 0.1, d), f32))]
    if kind == "affine":
        mods.append(JAffine(mask=leading_mask(d, max(1, d // 4)),
                            net=_mlp(rng, (d, *hidden, 2 * d), scale),
                            clamp=8.0))
    else:
        for i in range(2):
            mods.append(JRQS(mask=alternating_mask(d, i % 2),
                             net=_mlp(rng, (d, *hidden, d * (3 * knots - 1)),
                                      scale),
                             knots=knots, use_pallas=False))
    return JChain(transforms=tuple(mods))


@functools.lru_cache(maxsize=None)
def jax_transition(kind, flow_kind, d, hidden, depth):
    """The JAX package's fused transition math over `jax_flow(flow_kind,
    d, hidden)` and the target of `kind`, compiled once."""
    jt = targets(kind, d)[0]
    trans = j_fused(jt.log_density, jax_flow(flow_kind, d, hidden),
                    max_depth=depth, tile_b=N, interpret=False)
    return optimized(trans, jax.random.split(jax.random.key(0), N),
                     jnp.zeros((N, d)), jnp.asarray(0.1), jnp.ones(d))


def both_transitions(kind, flow_kind, d, hidden, depth, eps, q):
    """(port, JAX) outputs of one transition of the N chains at q: K1's
    plain version (`nuts_cuda.nuts_transition` on CPU tensors) on the
    randomness the JAX transition derives from its keys."""
    tt = targets(kind, d)[1]
    tf = carry(jax_flow(flow_kind, d, hidden), use_pallas="auto")
    im = np.linspace(0.8, 1.2, d).astype(np.float32)
    keys = jax.random.split(jax.random.key(60), N)
    jq, info = jax_transition(kind, flow_kind, d, hidden, depth)(
        keys, jnp.asarray(q), jnp.asarray(eps), jnp.asarray(im))
    rnd = _jax_keys_randomness(keys, d, depth, jnp.asarray(im))
    model = nuts_cuda.pack_flow(tf, tt)
    port = nuts_cuda.nuts_transition(
        torch.from_numpy(q), *(torch.from_numpy(a) for a in rnd),
        torch.tensor(eps), torch.from_numpy(im), model, depth)
    ja = (np.asarray(jq), np.asarray(info.logp),
          np.asarray(info.accept_prob), np.asarray(info.num_steps),
          np.asarray(info.tree_depth),
          np.asarray(info.diverging).astype(np.float32),
          np.asarray(info.turning).astype(np.float32),
          np.asarray(info.energy))
    return tuple(o.numpy() for o in port), ja, model


def assert_k1_bar(port, ja):
    flips, ok = compare(port, ja)
    assert len(flips) <= 1, f"knife-edge chains {flips.tolist()}"
    np.testing.assert_allclose(port[0][ok], ja[0][ok], **BAR)
    np.testing.assert_allclose(port[1][ok], ja[1][ok], **BAR)
    np.testing.assert_allclose(port[7], ja[7], **BAR)
    assert np.isfinite(port[0]).all()


# ---------------------------------------------------------------------------
# (a) any hidden width
# ---------------------------------------------------------------------------
HIDDEN_CASES = [("affine", (48,)), ("rqs", (100,)), ("affine", (320, 320))]


@pytest.mark.parametrize("flow_kind,hidden", HIDDEN_CASES)
def test_padded_hidden_transition_equals_the_true_width(flow_kind, hidden):
    d = 32
    tt = targets("funnel", d)[1]
    tf = carry(jax_flow(flow_kind, d, hidden), use_pallas="auto")
    model = nuts_cuda.pack_flow(tf, tt)
    assert model.d_pad == d
    assert model.hidden == tuple(-(-h // 32) * 32 for h in hidden) * (
        2 if flow_kind == "rqs" else 1)
    padded = padded_model(model)
    for t, t_true in zip(padded.flow.transforms[1:], tf.transforms[1:]):
        for k, (w, w0) in enumerate(zip(t.net.weights, t_true.net.weights)):
            assert torch.equal(w[:w0.shape[0], :w0.shape[1]], w0) or k == (
                len(t.net.weights) - 1)
            assert not w[w0.shape[0]:].any()
            if k < len(t.net.weights) - 1:
                assert not w[:, w0.shape[1]:].any()
                assert not t.net.biases[k][w0.shape[1]:].any()
    g = torch.Generator().manual_seed(4)
    q = torch.from_numpy(points("funnel", 16, d))
    im = 0.7 + 0.6 * torch.rand(d, generator=g)
    rnd = nuts_cuda.draw_randomness(g, 16, d, 4, im)
    eps = torch.tensor(0.2)
    true = nuts_cuda.transition_math_torch(
        q, *rnd, eps, im, nuts_cuda.plain_logp_grad(model), 4)
    wide = nuts_cuda.transition_math_torch(
        q, *rnd, eps, im, nuts_cuda.plain_logp_grad(padded), 4)
    for a, b in zip(wide, true):
        assert torch.equal(a, b)


@pytest.mark.parametrize("flow_kind,hidden", HIDDEN_CASES)
def test_padded_hidden_k1_plain_matches_jax(flow_kind, hidden):
    q = points("funnel", N, 8, seed=1)
    port, ja, model = both_transitions("funnel", flow_kind, 8, hidden, 4,
                                       0.2, q)
    assert_k1_bar(port, ja)
    assert not nuts_cuda.wide_path(model, 4)  # the tile kernels take it


# ---------------------------------------------------------------------------
# (b) max_depth past 10
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("depth,eps", [(11, 0.002), (12, 0.001)])
def test_deep_k1_plain_matches_jax(depth, eps):
    """A near-identity flow over N(0, I_8): a trajectory turns after a
    time of about 2.5, 1,250 and 2,500 leapfrogs here, so trees pass depth
    10 (at eps = 0.004 every tree stopped at depth 10)."""
    q = points("std_normal", N, 8, seed=2)
    port, ja, model = both_transitions("std_normal", "affine", 8, (16, 16),
                                       depth, eps, q)
    assert ja[4].max() > 10 and port[4].max() > 10
    assert_k1_bar(port, ja)
    assert nuts_cuda.wide_path(model, depth)


def test_deep_k2_plain_matches_jax_window():
    d, n, S, depth, eps = 8, 4, 1, 11, 0.002
    jt, tt = targets("std_normal", d)
    jf = jax_flow("affine", d, (16, 16))
    q = points("std_normal", n, d, seed=3)
    im = np.linspace(0.8, 1.2, d).astype(np.float32)
    key = jax.random.key(5)
    win = j_window(jt.log_density, jf, window=S, max_depth=depth, tile_b=n,
                   interpret=False)
    args = (key, jnp.asarray(q), jnp.asarray(eps), jnp.asarray(im))
    draws, info = optimized(win, *args)(*args)
    ja = (np.asarray(draws), np.asarray(info.logp),
          np.asarray(info.accept_prob), np.asarray(info.num_steps),
          np.asarray(info.tree_depth),
          np.asarray(info.diverging).astype(np.float32),
          np.asarray(info.turning).astype(np.float32),
          np.asarray(info.energy))
    rnd = jax_window_draws(key, n, d, S, depth, im)
    model = nuts_cuda.pack_flow(carry(jf, use_pallas="auto"), tt)
    port = nw.nuts_window(torch.from_numpy(q),
                          *(torch.from_numpy(a) for a in rnd),
                          torch.tensor(eps), torch.from_numpy(im), model,
                          depth, S)
    port = tuple(o.numpy() for o in port)
    assert ja[4].max() > 10 and port[4].max() > 10
    assert_window_close(port, ja, TOL_JAX, max_flips=1)


# ---------------------------------------------------------------------------
# (c) d past 256
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,flow_kind,d", [("funnel", "affine", 288),
                                              ("hierarchical", "affine",
                                               514)])
def test_wide_k1_plain_matches_jax(kind, flow_kind, d):
    q = points(kind, N, d, seed=4)
    eps = 0.1
    if kind == "hierarchical":  # the latent point of a data-space start
        q[:, 1] *= 0.3
        eps = 0.02
    port, ja, model = both_transitions(kind, flow_kind, d, (16, 16), 4,
                                       eps, q)
    assert_k1_bar(port, ja)
    assert model.d_pad == -(-d // 32) * 32 and nuts_cuda.wide_path(model)


@pytest.mark.parametrize("kind,flow_kind,d", [("correlated", "affine", 288),
                                              ("hierarchical", "affine",
                                               514)])
def test_wide_k3_plain_matches_jax_latent_logp(kind, flow_kind, d):
    jt, tt = targets(kind, d)
    jf = jax_flow(flow_kind, d, (16, 16))
    z = points(kind, N, d, seed=5)
    if kind == "hierarchical":
        z[:, 1] *= 0.3
    jlp, jg = jax.jit(jax.vmap(jax.value_and_grad(
        j_reparam(jt.log_density, jf))))(jnp.asarray(z))
    hook = fused_logp_cuda.fused_latent_logp_and_grad(
        tt, carry(jf, use_pallas="auto"))
    lp, g = hook(torch.from_numpy(z))
    assert_close_scaled(lp.numpy(), jlp)
    assert_close_scaled(g.numpy(), jg)
    assert nuts_cuda.wide_path(hook.model)


@pytest.mark.parametrize("kind,d", [("hierarchical", 288),
                                    ("hierarchical", 514),
                                    ("correlated", 514)])
def test_wide_packed_targets_match_jax(kind, d):
    jt, tt = targets(kind, d)
    pt = nuts_cuda.pack_target(tt)
    assert pt.d_pad == -(-d // 32) * 32
    x = points(kind, 6, d, seed=6)
    jl, jg = jax.vmap(jax.value_and_grad(jt.log_density))(jnp.asarray(x))
    xt = nuts_cuda.pad_lanes(torch.from_numpy(x), pt.d_pad)
    xt.requires_grad_(True)
    lp = nuts_cuda.packed_log_density(pt, xt)
    (g,) = torch.autograd.grad(lp.sum(), xt)
    assert_close_scaled(lp.detach().numpy(), jl)
    assert_close_scaled(g[:, :d].numpy(), jg)
    assert torch.all(g[:, d:] == 0)


# ---------------------------------------------------------------------------
# (d) the limits, the route and the runner's choice
# ---------------------------------------------------------------------------
def _affine(d, hidden):
    return carry(jax_flow("affine", d, hidden), use_pallas="auto")


def test_limits_are_refused_when_the_transition_is_built():
    tt = T.StandardNormal(8)
    flow = _affine(8, (16,))
    for depth in (0, nuts_cuda.MAX_DEPTH + 1):
        for make in (lambda: nuts_cuda.fused_nuts_for_flow(tt, flow, depth),
                     lambda: nw.fused_nuts_window_for_flow(
                         tt, flow, window=2, max_depth=depth)):
            with pytest.raises(ValueError, match="max_depth in"):
                make()
    for depth in (11, nuts_cuda.MAX_DEPTH):
        assert nuts_cuda.fused_nuts_for_flow(tt, flow, depth).max_depth \
            == depth
    with pytest.raises(ValueError, match="hidden widths"):
        nuts_cuda.pack_flow(_affine(8, (nuts_cuda.MAX_HIDDEN + 1,)), tt)
    model = nuts_cuda.pack_flow(None, T.StandardNormal(nuts_cuda.MAX_DIM))
    assert model.d_pad == nuts_cuda.MAX_DIM
    with pytest.raises(ValueError, match=f"width {nuts_cuda.MAX_DIM + 1}"):
        nuts_cuda.pack_flow(None, T.StandardNormal(nuts_cuda.MAX_DIM + 1))


def test_wide_path_takes_what_the_tile_kernels_do_not():
    small = nuts_cuda.pack_flow(_affine(64, (48, 48)), T.StandardNormal(64))
    assert small.hidden == (64, 64)
    assert not nuts_cuda.wide_path(small, nuts_cuda.TILE_MAX_DEPTH)
    assert nuts_cuda.wide_path(small, nuts_cuda.TILE_MAX_DEPTH + 1)
    big = nuts_cuda.pack_flow(_affine(64, (512, 512)), T.StandardNormal(64))
    assert not nuts_cuda.wide_path(big, 4)
    rows = nuts_cuda.tile_rows(big)
    nuts_cuda.check_tile(big, rows)
    assert rows * nuts_cuda.smem_bytes(big) <= nuts_cuda.SMEM_LIMIT
    wide = nuts_cuda.pack_flow(None, T.StandardNormal(257))
    assert wide.d_pad == 288 and nuts_cuda.wide_path(wide)
    # a row past shared memory (the scratch of a 4096-wide 7-layer
    # conditioner: 2 x 7 x 4096 floats) runs the wide units
    huge = big._replace(hmax=nuts_cuda.MAX_HIDDEN, nhid=7)
    assert nuts_cuda.ring_stage_floats(huge, 1) == 0
    assert nuts_cuda.wide_path(huge, 4)
    assert nuts_cuda.wide_row_floats(wide, 12) == (
        (nuts_cuda.WIDE_VECTORS + 24) * 288 + nuts_cuda.smem_bytes(wide) // 4)


def test_host_constants_are_the_cuda_sources():
    src = (CSRC / "wide_grad.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kWideMaxDim") == nuts_cuda.MAX_DIM
    assert const("kWideMaxDepth") == nuts_cuda.MAX_DEPTH
    assert const("kMaxHidden") == nuts_cuda.MAX_HIDDEN
    assert const("kWideVectors") == nuts_cuda.WIDE_VECTORS
    assert src.count("next(d)") == nuts_cuda.WIDE_VECTORS
    for unit in ("nuts_transition", "nuts_window", "fused_logp"):
        text = (CSRC / f"{unit}.cu").read_text()
        assert (f"w <= {nuts_cuda.MAX_HIDDEN} && w % 32 == 0"
                in text), unit
    for text in ((CSRC / "nuts_transition.cu").read_text(),
                 (CSRC / "nuts_window.cu").read_text()):
        assert f"kMaxDepth = {nuts_cuda.TILE_MAX_DEPTH};" in text


def _runner_cfg(fused_kernel, max_depth=8, hidden=(48,), dim=8):
    tc = tconfig.RunConfig.from_json(str(ROOT / "configs" /
                                         "c4_funnel_nuts.json"))
    return dc.replace(
        tc, target=dc.replace(tc.target, dim=dim),
        flow=dc.replace(tc.flow, hidden=hidden),
        nuts=dc.replace(tc.nuts, fused_kernel=fused_kernel,
                        max_depth=max_depth))


def _runner_flow(cfg):
    g = torch.Generator().manual_seed(0)
    return trun._flow_from_spec(
        torch.randn(64, cfg.target.dim, generator=g), g, cfg.flow, "cpu")


@pytest.mark.parametrize("max_depth,hidden", [(11, (48,)), (16, (32,)),
                                              (8, (48,)), (12, (100, 100))])
def test_auto_takes_k1_at_the_new_reach(max_depth, hidden):
    cfg = _runner_cfg("auto", max_depth, hidden)
    tr = trun._nuts_transition(cfg, cfg.target.build("cpu"),
                               _runner_flow(cfg))
    assert isinstance(tr, nuts_cuda.FusedNUTS)
    assert tr.max_depth == max_depth
    nuts_cuda.check_widths(tr.model)
    assert all(h % 32 == 0 for h in tr.model.hidden)
    assert nuts_cuda.wide_path(tr.model, max_depth) == (max_depth > 10)


@pytest.mark.parametrize("edit,why", [
    (dict(max_depth=17), "max_depth in"),
    (dict(hidden=(nuts_cuda.MAX_HIDDEN + 32,)), "hidden widths"),
    (dict(dim=nuts_cuda.MAX_DIM + 1, hidden=(32,)), "width")])
def test_past_the_limits_auto_runs_portable_and_on_raises(edit, why):
    for fk in ("auto", "on"):
        cfg = _runner_cfg(fk, **edit)
        target, flow = cfg.target.build("cpu"), _runner_flow(cfg)
        if fk == "auto":
            assert trun._nuts_transition(cfg, target, flow) is None
        else:
            with pytest.raises(ValueError, match="fused_kernel='on'") as e:
                trun._nuts_transition(cfg, target, flow)
            assert why in str(e.value)


# ---------------------------------------------------------------------------
# (e) the public names
# ---------------------------------------------------------------------------
def test_to_latent_space_matches_jax():
    from tpuflows_torch.mcmc import to_data_space, to_latent_space

    jf = jax_flow("affine", 6, (16,))
    tf = carry(jf, use_pallas="auto")
    x = points("std_normal", 32, 6, seed=7)
    z = to_latent_space(tf, torch.from_numpy(x))
    np.testing.assert_allclose(z.detach().numpy(),
                               np.asarray(j_to_latent(jf, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    back = to_data_space(tf, z)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-4, atol=1e-4)


def test_kernels_package_exports_the_spline_and_builds_nothing():
    code = ("import sys; sys.path.insert(0, 'src');"
            "import tpuflows_torch.kernels as k;"
            "assert 'tpuflows_torch.kernels.rqs_cuda' not in sys.modules;"
            "from tpuflows_torch.kernels import rqs_forward_from_raw, "
            "rqs_inverse_from_raw;"
            "from tpuflows_torch.kernels import cuda_build as cb;"
            "libs = [v for m in list(sys.modules.values()) "
            "for v in vars(m).values() if isinstance(v, cb.CudaLibrary)];"
            "assert libs and all(l.lib is None for l in libs);"
            "assert sorted(k.__all__) == ['rqs_forward_from_raw', "
            "'rqs_inverse_from_raw']")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)
    from tpuflows_torch.kernels import (rqs_forward_from_raw,
                                        rqs_inverse_from_raw)

    rng = np.random.default_rng(8)
    K, B = 6, 3.0
    x = rng.uniform(-4, 4, (40, 5)).astype(np.float32)
    raw = rng.normal(size=(40, 5, 3 * K - 1)).astype(np.float32)
    for port, jax_fn in ((rqs_forward_from_raw, j_rqs_forward),
                         (rqs_inverse_from_raw, j_rqs_inverse)):
        y, ladj = port(torch.from_numpy(x), torch.from_numpy(raw), B)
        jy, jl = jax_fn(jnp.asarray(x), jnp.asarray(raw), B)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(ladj.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5)
