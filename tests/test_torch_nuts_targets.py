"""K1, K2 and K3 over every closed-form target of the port, at any width:
the plain versions against the JAX package's fused math, on the CPU.

  * (a) `pack_target` + `packed_log_density` (the plain mirror of
    `csrc/targets.cuh`, reading the packed buffer) and its autograd
    gradient against the JAX target's `log_density` and `jax.grad`, for
    every kind at d in {2, 8, 16, 40} (hierarchical at 40, rosenbrock at
    even d), rtol 1e-5 with atol 1e-5 of the largest |value|; at the lane
    width the padded dims add nothing and get a gradient of 0;
  * (b) K1's plain version (`nuts_cuda.nuts_transition` on CPU tensors,
    the target read from the packed buffer) against the JAX package's
    `fused_nuts_for_flow(..., interpret=False)` (`_transition_math` in
    plain XLA) for every kind under an affine flow (Standardize + a
    leading-mask coupling) and a 2-block rqs flow at d = 8 and 40, on the
    randomness the JAX transition derives from its keys (one JAX compile
    per flow and width, the kinds' own log densities behind `lax.switch`):
    the bar of
    tests/test_torch_nuts.py (at most one knife-edge chain; 1e-4 on q,
    logp and energy);
  * (c) the flow-less transition (`FusedNUTS(target)`, an empty module
    list) against `make_fused_nuts_transition(lambda x, p:
    t.log_density(x), ())` on the DiagNormal of tests/test_nuts_pallas.py;
  * (d) K2's and K3's plain versions over a non-funnel target against the
    JAX package's window (`fused_nuts_window_for_flow`, on its replayed
    draws: tests/test_torch_nuts_window.py's bar) and latent log density
    (`fused_latent_logp_and_grad` in interpret mode: rtol 1e-5, atol
    1e-4);
  * (e) the padding: the plain transition at the lane width, on rows with
    zero pads and the flow padded as `pack_flow` pads it (`_pad_module`,
    the kernels' layout), equals the one at the true width (no flip; rtol
    1e-5, atol 1e-4: the sums over d and d_pad round apart) and leaves the
    pads 0;
  * (f) `pack_flow` refuses a `Posterior` and a `Target` subclass with a
    ValueError that names it; K1's width checks take any d <= 256 on the
    tile kernels and d = 257 on the wide units (`wide_path`), and
    `pack_flow` refuses d past MAX_DIM.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows import targets as J
from tpuflows.flows.affine import AffineCoupling as JAffine
from tpuflows.flows.affine import Standardize as JStandardize
from tpuflows.flows.core import Chain as JChain
from tpuflows.flows.coupling import RQSCouplingBlock as JRQS
from tpuflows.flows.nets import MLP as JMLP
from tpuflows.kernels.fused_logp import (
    fused_latent_logp_and_grad as j_fused_logp)
from tpuflows.kernels.nuts_pallas import fused_nuts_for_flow as j_fused
from tpuflows.kernels.nuts_pallas import (
    fused_nuts_window_for_flow as j_window)
from tpuflows.kernels.nuts_pallas import make_fused_nuts_transition

from tpuflows_torch import targets as T
from tpuflows_torch.kernels import fused_logp_cuda, nuts_cuda
from tpuflows_torch.kernels import nuts_window_cuda as nw
from tpuflows_torch.util.shapes import alternating_mask, leading_mask

from test_torch_coupling import carry
from test_torch_nuts import compare
from test_torch_nuts_spline import _jax_keys_randomness
from test_torch_nuts_window import TOL_JAX, assert_window_close
from test_torch_nuts_window import jax_window_draws

KINDS = ["std_normal", "diag_normal", "correlated", "mixture", "funnel",
         "hierarchical", "banana", "rosenbrock", "cauchy"]
DEPTH = 4
N = 16
BAR = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Thousands of small ops: one intra-op thread keeps parallel test
    workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def targets(kind, d, seed=0):
    """(JAX target, port target) of `kind` at width d, from numpy."""
    rng = np.random.default_rng(100 + seed)
    f32 = np.float32
    if kind == "std_normal":
        return J.StandardNormal(dim=d), T.StandardNormal(d)
    if kind == "diag_normal":
        loc = rng.normal(0, 0.5, d).astype(f32)
        scale = rng.uniform(0.5, 2.0, d).astype(f32)
        return (J.DiagNormal(loc=jnp.asarray(loc), scale=jnp.asarray(scale)),
                T.DiagNormal(torch.from_numpy(loc), torch.from_numpy(scale)))
    if kind == "correlated":
        idx = np.arange(d)
        cov = 0.8 ** np.abs(idx[:, None] - idx[None, :])
        chol = np.linalg.cholesky(cov).astype(f32)
        loc = rng.normal(0, 0.5, d).astype(f32)
        return (J.CorrelatedGaussian(loc=jnp.asarray(loc),
                                     chol=jnp.asarray(chol)),
                T.CorrelatedGaussian(torch.from_numpy(loc),
                                     torch.from_numpy(chol)))
    if kind == "mixture":
        means = rng.normal(0, 1.5, (3, d)).astype(f32)
        scales = rng.uniform(0.6, 1.5, (3, d)).astype(f32)
        w = rng.uniform(0.5, 1.5, 3)
        lw = np.log(w / w.sum()).astype(f32)
        return (J.GaussianMixture(means=jnp.asarray(means),
                                  scales=jnp.asarray(scales),
                                  log_weights=jnp.asarray(lw)),
                T.GaussianMixture(torch.from_numpy(means),
                                  torch.from_numpy(scales),
                                  torch.from_numpy(lw)))
    if kind == "funnel":
        return J.NealsFunnel(dim=d, sigma_v=1.5), T.NealsFunnel(d, 1.5)
    if kind == "hierarchical":
        y = rng.normal(1.0, 2.0, d - 2).astype(f32)
        return (J.HierarchicalGaussian(y=jnp.asarray(y)),
                T.HierarchicalGaussian(torch.from_numpy(y)))
    if kind == "banana":
        return J.Banana(dim=d), T.Banana(d)
    if kind == "rosenbrock":
        return (J.Rosenbrock(dim=d, s2=0.5),
                T.Rosenbrock(d, s2=0.5))
    return J.MultimodalCauchy(dim=d), T.MultimodalCauchy(d)


def widths(kind):
    return [40] if kind == "hierarchical" else [2, 8, 16, 40]


def points(kind, n, d, seed=0):
    x = np.random.default_rng(200 + seed).normal(size=(n, d))
    if kind == "hierarchical":  # theta around the data, log tau moderate
        x[:, 2:] = 1.0 + 2.0 * x[:, 2:]
    return x.astype(np.float32)


def assert_close_scaled(got, want, rtol=1e-5):
    """rtol with an atol of rtol times the largest |want|."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# (a) the packed buffer and its mirror against the JAX targets
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,d", [(k, d) for k in KINDS
                                    for d in widths(k)])
def test_packed_log_density_matches_jax(kind, d):
    jt, tt = targets(kind, d)
    pt = nuts_cuda.pack_target(tt)
    assert pt.kind == nuts_cuda.TARGET_KIND[type(tt)]
    assert (pt.dim, pt.d_pad) == (d, -(-d // 32) * 32)
    x = points(kind, 24, d)
    jl, jg = jax.jit(jax.vmap(jax.value_and_grad(jt.log_density)))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    lp = nuts_cuda.packed_log_density(pt, xt)
    (g,) = torch.autograd.grad(lp.sum(), xt)
    assert_close_scaled(lp.detach().numpy(), jl)
    assert_close_scaled(g.numpy(), jg)
    # the lane width: zero pads add nothing and get a zero gradient
    xp = nuts_cuda.pad_lanes(torch.from_numpy(x), pt.d_pad)
    xp.requires_grad_(True)
    lpp = nuts_cuda.packed_log_density(pt, xp)
    (gp,) = torch.autograd.grad(lpp.sum(), xp)
    assert_close_scaled(lpp.detach().numpy(), jl)
    assert_close_scaled(gp[:, :d].numpy(), jg)
    assert torch.all(gp[:, d:] == 0)


def test_hierarchical_overflow_diverges_as_the_jax_math():
    """exp(-2 log tau) overflows at log tau < -44: -inf in both packages,
    never a finite value."""
    jt, tt = targets("hierarchical", 40)
    x = points("hierarchical", 4, 40)
    x[:, 1] = -60.0
    jl = np.asarray(jt.log_density(jnp.asarray(x)))
    lp = nuts_cuda.packed_log_density(nuts_cuda.pack_target(tt),
                                      torch.from_numpy(x)).numpy()
    assert np.all(np.isneginf(jl)) and np.all(np.isneginf(lp))


# ---------------------------------------------------------------------------
# (b) K1's plain version against the JAX package's fused transition math
# ---------------------------------------------------------------------------
def _mlp(rng, sizes, last_scale):
    f32 = jnp.float32
    ws = [rng.normal(0.0, np.sqrt(2.0 / a), (a, b))
          for a, b in zip(sizes[:-1], sizes[1:])]
    ws[-1] = last_scale * ws[-1]
    bs = [rng.normal(0.0, 0.05, b) for b in sizes[1:]]
    return JMLP(weights=tuple(jnp.asarray(w, f32) for w in ws),
                biases=tuple(jnp.asarray(b, f32) for b in bs))


def jax_flow(kind, d, seed=0, hidden=(16, 16), knots=4, scale=0.1):
    """Standardize + a leading-mask affine coupling ("affine"), or
    Standardize + 2 RQS blocks on alternating masks ("rqs"), every leaf
    from numpy."""
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


# a step size for each target under the random flows: a fraction of its
# narrowest scale, so that trees reach several depths
EPS = {"std_normal": 0.4, "diag_normal": 0.25, "correlated": 0.15,
       "mixture": 0.25, "funnel": 0.2, "hierarchical": 0.04, "banana": 0.1,
       "rosenbrock": 0.1, "cauchy": 0.05}


@functools.lru_cache(maxsize=None)
def jax_transition(flow_kind, d):
    """The JAX package's fused transition math over the flow `jax_flow(
    flow_kind, d)`, jitted once for every kind: the log density is the
    JAX target's own, picked by `lax.switch` on the kind's index (one
    compile per flow and width, not per target)."""
    jts = [targets(k, d)[0] for k in KINDS]
    jf = jax_flow(flow_kind, d)

    def run(index, keys, q, eps, im):
        def log_density(x):
            return jax.lax.switch(index, [t.log_density for t in jts], x)

        trans = j_fused(log_density, jf, max_depth=DEPTH, tile_b=N,
                        interpret=False)
        return trans(keys, q, eps, im)

    return optimized(run, 0, jax.random.split(jax.random.key(0), N),
                     jnp.zeros((N, d)), jnp.asarray(0.1), jnp.ones(d))


def optimized(fn, *example):
    """`fn` compiled for arguments shaped as `example` with XLA's CPU
    optimizations on: the suite's conftest turns them off for compile
    time, and these transitions then run 10x slower than they compile."""
    return jax.jit(fn).lower(*example).compile(
        compiler_options={"xla_backend_optimization_level": 2})


def transitions(kind, flow_kind, d, seed=0):
    """(port outputs, JAX outputs) of one transition of N chains."""
    _, tt = targets(kind, d)
    tf = carry(jax_flow(flow_kind, d), use_pallas="auto")
    q = points(kind, N, d, seed)
    if kind == "hierarchical":  # the latent point of a data-space start
        q[:, 1] *= 0.3
    im = np.linspace(0.7, 1.3, d).astype(np.float32)
    eps = EPS[kind]
    keys = jax.random.split(jax.random.key(50 + seed), N)
    jq, info = jax_transition(flow_kind, d)(
        KINDS.index(kind), keys, jnp.asarray(q), jnp.asarray(eps),
        jnp.asarray(im))
    rnd = _jax_keys_randomness(keys, d, DEPTH, jnp.asarray(im))
    model = nuts_cuda.pack_flow(tf, tt)
    port = nuts_cuda.nuts_transition(
        torch.from_numpy(q), *(torch.from_numpy(a) for a in rnd),
        torch.tensor(eps), torch.from_numpy(im), model, DEPTH)
    port = tuple(o.numpy() for o in port)
    ja = (np.asarray(jq), np.asarray(info.logp),
          np.asarray(info.accept_prob), np.asarray(info.num_steps),
          np.asarray(info.tree_depth),
          np.asarray(info.diverging).astype(np.float32),
          np.asarray(info.turning).astype(np.float32),
          np.asarray(info.energy))
    return port, ja


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("flow_kind", ["affine", "rqs"])
@pytest.mark.parametrize("d", [8, 40])
def test_k1_plain_matches_jax_fused_math(d, flow_kind, kind):
    port, ja = transitions(kind, flow_kind, d)
    flips, ok = compare(port, ja)
    assert len(flips) <= 1, f"knife-edge chains {flips.tolist()}"
    np.testing.assert_allclose(port[0][ok], ja[0][ok], **BAR)
    np.testing.assert_allclose(port[1][ok], ja[1][ok], **BAR)
    np.testing.assert_allclose(port[7], ja[7], **BAR)
    assert np.isfinite(port[0]).all() and (port[3] >= 1).all()


# ---------------------------------------------------------------------------
# (c) the flow-less transition
# ---------------------------------------------------------------------------
def test_flowless_k1_plain_matches_jax_on_a_diag_normal():
    loc = np.array([1.0, -1.0, 0.5, 0.0], np.float32)
    scale = np.array([1.0, 0.5, 2.0, 1.0], np.float32)
    jt = J.DiagNormal(loc=jnp.asarray(loc), scale=jnp.asarray(scale))
    tt = T.DiagNormal(torch.from_numpy(loc), torch.from_numpy(scale))
    d, n, depth, eps = 4, 64, 6, 0.4
    im = np.array([1.0, 0.25, 4.0, 1.0], np.float32)
    trans = make_fused_nuts_transition(lambda x, p: jt.log_density(x), (),
                                       max_depth=depth, interpret=False)
    q = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
    keys = jax.random.split(jax.random.key(1), n)
    jq, info = jax.jit(trans)(keys, jnp.asarray(q), jnp.asarray(eps),
                              jnp.asarray(im))
    k1 = nuts_cuda.FusedNUTS(tt, max_depth=depth)
    assert k1.model.mods.shape == (0, nuts_cuda.MOD_INTS)
    assert k1.model.params.numel() == 0 and k1.model.flow is None
    nuts_cuda.check_widths(k1.model)
    rnd = _jax_keys_randomness(keys, d, depth, jnp.asarray(im))
    port = nuts_cuda.nuts_transition(
        torch.from_numpy(q), *(torch.from_numpy(a) for a in rnd),
        torch.tensor(eps), torch.from_numpy(im), k1.model, depth)
    port = tuple(o.numpy() for o in port)
    ja = (np.asarray(jq), np.asarray(info.logp), None,
          np.asarray(info.num_steps), np.asarray(info.tree_depth),
          np.asarray(info.diverging).astype(np.float32),
          np.asarray(info.turning).astype(np.float32),
          np.asarray(info.energy))
    flips, ok = compare(port, ja)
    assert len(flips) <= 1
    np.testing.assert_allclose(port[0][ok], ja[0][ok], **BAR)
    np.testing.assert_allclose(port[1][ok], ja[1][ok], **BAR)
    np.testing.assert_allclose(port[7], ja[7], **BAR)
    assert len(np.unique(ja[4])) >= 2


# ---------------------------------------------------------------------------
# (d) K2's and K3's plain versions over a non-funnel target
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,flow_kind,d", [("hierarchical", "affine",
                                               40)])
def test_k2_plain_matches_jax_window(kind, flow_kind, d):
    jt, tt = targets(kind, d)
    jf = jax_flow(flow_kind, d)
    tf = carry(jf, use_pallas="auto")
    n, S, eps = 16, 3, EPS[kind]
    q = points(kind, n, d)
    if kind == "hierarchical":
        q[:, 1] *= 0.3
    im = np.linspace(0.8, 1.2, d).astype(np.float32)
    key = jax.random.key(3)
    win = j_window(jt.log_density, jf, window=S, max_depth=DEPTH, tile_b=n,
                   interpret=False)
    args = (key, jnp.asarray(q), jnp.asarray(eps), jnp.asarray(im))
    draws, info = optimized(win, *args)(*args)
    ja = (np.asarray(draws), np.asarray(info.logp),
          np.asarray(info.accept_prob), np.asarray(info.num_steps),
          np.asarray(info.tree_depth),
          np.asarray(info.diverging).astype(np.float32),
          np.asarray(info.turning).astype(np.float32),
          np.asarray(info.energy))
    rnd = jax_window_draws(key, n, d, S, DEPTH, im)
    model = nuts_cuda.pack_flow(tf, tt)
    port = nw.nuts_window(torch.from_numpy(q),
                          *(torch.from_numpy(a) for a in rnd),
                          torch.tensor(eps), torch.from_numpy(im), model,
                          DEPTH, S)
    port = tuple(o.numpy() for o in port)
    assert port[0].shape == (S, n, d)
    assert_window_close(port, ja, TOL_JAX, max_flips=1)


@pytest.mark.parametrize("kind,flow_kind,d", [("rosenbrock", "affine",
                                               40)])
def test_k3_plain_matches_jax_latent_logp(kind, flow_kind, d):
    jt, tt = targets(kind, d)
    jf = jax_flow(flow_kind, d)
    tf = carry(jf, use_pallas="auto")
    z = points(kind, 24, d)
    jlp, jg = jax.vmap(j_fused_logp(jt.log_density, jf, tile_b=8,
                                    interpret=True))(jnp.asarray(z))
    hook = fused_logp_cuda.fused_latent_logp_and_grad(tt, tf)
    lp, g = hook(torch.from_numpy(z))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-4)
    assert fused_logp_cuda.LAUNCHES == 0


# ---------------------------------------------------------------------------
# (e) the padding
# ---------------------------------------------------------------------------
def padded_model(model):
    """`model` with its flow at the lane width, each module padded as
    `pack_flow` pads it (`_pad_module`), and that flow's p-major relayout:
    its plain gradient takes z at d_pad."""
    from tpuflows_torch.flows import Chain
    from tpuflows_torch.kernels.tile_flow import permute_for_tiles

    wide = Chain([nuts_cuda._pad_module(t, model.d, model.d_pad)
                  for t in model.flow.transforms])
    return model._replace(flow=wide, flow_p=None if model.flow_p is None
                          else permute_for_tiles(wide))


@pytest.mark.parametrize("kind,flow_kind,d", [
    ("hierarchical", "affine", 40), ("rosenbrock", "rqs", 8),
    ("cauchy", "affine", 40), ("mixture", "rqs", 40),
    ("correlated", "affine", 2), ("banana", "rqs", 2)])
def test_padded_transition_equals_the_true_width(kind, flow_kind, d):
    _, tt = targets(kind, d)
    tf = carry(jax_flow(flow_kind, d), use_pallas="auto")
    model = nuts_cuda.pack_flow(tf, tt)
    dp = model.d_pad
    assert dp == -(-d // 32) * 32
    wide = padded_model(model)
    g = torch.Generator().manual_seed(4)
    q = torch.from_numpy(points(kind, N, d))
    im = 0.7 + 0.6 * torch.rand(d, generator=g)
    p0, dirs, ua, ut = nuts_cuda.draw_randomness(g, N, d, DEPTH, im)
    eps = torch.tensor(EPS[kind])
    true = nuts_cuda.transition_math_torch(
        q, p0, dirs, ua, ut, eps, im, nuts_cuda.plain_logp_grad(model),
        DEPTH)
    padded = nuts_cuda.transition_math_torch(
        nuts_cuda.pad_lanes(q, dp), nuts_cuda.pad_lanes(p0, dp), dirs, ua,
        ut, eps, nuts_cuda.pad_lanes(im, dp),
        nuts_cuda.plain_logp_grad(wide), DEPTH)
    assert torch.all(padded[0][:, d:] == 0)
    true = tuple(o.numpy() for o in true)
    padded = (padded[0][:, :d].numpy(), *(o.numpy() for o in padded[1:]))
    flips, _ = compare(padded, true)
    assert len(flips) == 0, f"chains {flips.tolist()}"
    for a, b in zip(padded, true):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)
    # the packed flow at the lane width: zero rows of W1, mask 1 and zero
    # head columns past d, a Standardize that leaves the pads at 0
    std = wide.flow.transforms[0]
    assert torch.all(std.loc[d:] == 0) and torch.all(std.log_scale[d:] == 0)
    for t in wide.flow.transforms[1:]:
        assert t.mask[d:] == (1,) * (dp - d)
        assert torch.all(t.net.weights[0][d:] == 0)


def test_compact_layers_leave_the_pads_out():
    """The tile kernels' pass-through count (module list column 7) counts
    the dims below d only; the resident floats follow it, at the hidden
    widths as packed (16 padded to 32)."""
    _, tt = targets("banana", 2)
    tf = carry(jax_flow("affine", 2), use_pallas="auto")
    model = nuts_cuda.pack_flow(tf, tt)
    n_p = sum(tf.transforms[1].mask)
    assert model.mods[1, 7].item() == n_p == 1
    assert model.hidden == (32, 32)
    assert model.resident_floats == nuts_cuda._resident_floats(32, 32, 32,
                                                               32)


# ---------------------------------------------------------------------------
# (f) what has no device form
# ---------------------------------------------------------------------------
class _UserTarget(T.DiagNormal):
    """A user's target: its own log density, so no device form."""

    def log_density(self, x):
        return super().log_density(x) + 1.0


def test_pack_flow_refuses_targets_with_no_device_form():
    tf = carry(jax_flow("affine", 8), use_pallas="auto")
    prior = T.IndependentPrior([T.Normal(0.0, 1.0)] * 8, device="cpu")
    post = T.Posterior(lambda th: -0.5 * torch.sum(th * th, -1), prior)
    user = _UserTarget(torch.zeros(8), torch.ones(8))
    for target, name in ((post, "Posterior"), (user, "_UserTarget")):
        for make in (lambda: nuts_cuda.pack_flow(tf, target),
                     lambda: nuts_cuda.fused_nuts_for_flow(target, tf),
                     lambda: nw.fused_nuts_window_for_flow(target, tf),
                     lambda: fused_logp_cuda.fused_latent_logp_and_grad(
                         target, tf)):
            with pytest.raises(ValueError, match=name):
                make()


@pytest.mark.parametrize("d", [1, 2, 31, 33, 255, 256])
def test_width_checks_take_any_d_up_to_256(d):
    """Any d up to 256 packs for the tile kernels; past it, up to MAX_DIM,
    the wide units take it (`wide_path`), and past that `pack_flow`
    refuses it."""
    model = nuts_cuda.pack_flow(None, T.StandardNormal(d))
    nuts_cuda.check_widths(model)
    assert model.d == d and model.d_pad == 32 * math.ceil(d / 32)
    assert not nuts_cuda.wide_path(model)
    wide = nuts_cuda.pack_flow(None, T.StandardNormal(257))
    nuts_cuda.check_widths(wide)
    assert wide.d_pad == 288 and nuts_cuda.wide_path(wide)
    with pytest.raises(ValueError,
                       match=f"width {nuts_cuda.MAX_DIM + 1}"):
        nuts_cuda.pack_flow(None, T.StandardNormal(nuts_cuda.MAX_DIM + 1))
