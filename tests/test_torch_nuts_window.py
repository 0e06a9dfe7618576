"""K2, the streaming NUTS draw window: the port's plain version
(`window_math_torch`) against the JAX package on the same numpy inputs and
randomness, on the CPU, and the window draw phase of `NUTSDriver`.

  * (a) `window_math_torch` against the JAX package's `_window_math` (the
    plain reference of its Pallas window), its gradient by `jax.vjp` as in
    `make_fused_nuts_window`, or for the arqs flow the streamed per-block
    gradient on the p-major relayout as in `fused_nuts_window_for_flow`:
    on a diagonal normal (d = 4), a Standardize + affine flow on the funnel
    (d = 8) and a 3-block arqs flow (d = 8, K = 8, hidden 16 x 16, mixed
    masks, last layers 0.03 x He), n = 64, windows of 4-8 slots, depths
    4-5, and one step size so large that leaves diverge (eps 6). On the
    spline flow the force jumps where the spline's second derivative does
    (at its knots), so a rounding difference that moves a leapfrog across a
    knot parts two trajectories: over 4-8 slots of depth 5, or at eps 0.25,
    q differs by 1e-4 to 1 with every decision the same, between the two
    float32 versions and between two of the port's own (c). Its rows run
    windows of 4 slots, depth 4, eps 0.1, where the parting stays under
    the bar; longer windows of spline flows are compared on the card,
    against the spread of two plain versions;
  * (b) the JAX package's window `win(key, ...)` run as a Pallas kernel in
    interpret mode on tiles of 8 rows, against the port on the randomness
    `win` derives from its keys, replayed (`jax_window_draws`), which also
    holds the slot-major layout of `draw_window_randomness` to the JAX
    package's.
  Tolerances of (a) and (b): every chain takes the same decisions (leapfrog
  count, depth, divergence, U-turn) in every slot, except at most one
  knife-edge chain, named when it flips (the two sum the kinetic energy in
  other orders, and a 1-ulp energy difference can flip a halting decision,
  after which the chain's later slots differ); on the other chains draws,
  lp and the energy agree to 1e-4, absolute and relative (float32 rounding
  carried through up to S (2^D - 1) leapfrogs);
  * (c) `window_math_torch` against S chained `transition_math_torch`
    calls on the slot columns (`chain_slots`), the equivalence K2's design
    rests on: identical decisions on every chain and slot, draws, lp and
    energy within 1e-5 absolute and relative (the window writes its state
    through blends b + m (a - b), which round, and sums the accept
    statistic per leaf). After a divergent slot the blends cancel
    catastrophically through the divergent leaf's huge positions, so at
    eps 6 only the chains that diverged earlier may differ;
  * (d) a window's chains are independent;
  * (e) on the CPU the wrapper runs the plain version and counts no
    launch; it rejects bad shapes, dtypes and devices, and the flows and
    targets K1 rejects;
  * (f) `NUTSDriver(window_transition=)`: draw and info shapes, the
    continuation, its three refusals, and warmup through the
    per-transition path only;
  * (g) the window samples a diagonal normal's moments (the JAX package's
    `test_window_math_samples_correct_moments`, through the port's
    `moment_gate`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows.kernels.nuts_pallas import _window_math
from tpuflows.kernels.nuts_pallas import make_fused_nuts_window
from tpuflows.kernels.tile_flow import permute_for_tiles as j_permute
from tpuflows.kernels.tile_flow import (
    tile_logp_and_grad_streamed as j_streamed)
from tpuflows.targets import DiagNormal as JDiag
from tpuflows.targets import NealsFunnel as JFunnel

from tpuflows_torch.diagnostics import moment_gate
from tpuflows_torch.kernels import nuts_cuda
from tpuflows_torch.kernels import nuts_window_cuda as nw
from tpuflows_torch.mcmc import NUTSDriver
from tpuflows_torch.mcmc.hmc import value_and_grad
from tpuflows_torch.mcmc.nuts import draw_window_randomness
from tpuflows_torch.targets import NealsFunnel

from test_torch_coupling import carry, jax_arqs_flow
from test_torch_nuts import flow_leaves, jax_flow, torch_flow

N = 64
DISCRETE = (3, 4, 5, 6)  # n_steps, depth, diverging, turning


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The window's plain math is thousands of small ops: one intra-op
    thread keeps parallel test workers from oversubscribing the cores,
    where a thread pool per op waits for its descheduled threads (on an
    8-core CPU the file took 149 s alone with the default threads, 146 s
    with one, and 1,021 s beside the loaded suite with the default)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
LOC = np.array([1.0, -1.0, 0.5, 0.0], np.float32)
SCALE = np.array([1.0, 0.5, 2.0, 1.0], np.float32)
HEAD = 0.03


def diag_logp(x):
    """The diagonal normal of tests/test_nuts_pallas.py in torch."""
    z = (x - torch.from_numpy(LOC)) / torch.from_numpy(SCALE)
    return (-0.5 * torch.sum(z * z, -1) - float(np.log(SCALE).sum())
            - 0.5 * 4 * float(np.log(2.0 * np.pi)))


def torch_diag_grad():
    value_grad = value_and_grad(diag_logp)

    def logp_grad(z):
        lp, g = value_grad(z)
        return lp[:, None], g

    return logp_grad


def jax_vjp_grad(logp):
    def logp_grad(xt):
        lp, pull = jax.vjp(lambda x: logp(x)[:, None], xt)
        (gx,) = pull(jnp.ones_like(lp))
        return lp, gx

    return logp_grad


def case(kind, seed=0):
    """(d, JAX gradient, port gradient) of one target of (a)."""
    if kind == "diag":
        jt = JDiag(loc=jnp.asarray(LOC), scale=jnp.asarray(SCALE))
        return 4, jax_vjp_grad(jt.log_density), torch_diag_grad()
    d = 8
    jtarget = JFunnel(dim=d)
    if kind == "affine":
        jf = jax_flow(flow_leaves(seed))
        tf = torch_flow(jf)

        def jlogp(z):
            x, ladj = jf.inverse_and_ladj(z)
            return jtarget.log_density(x) + ladj

        jgrad = jax_vjp_grad(jlogp)
    else:
        jf = jax_arqs_flow(seed, d=d, n_blocks=3, knots=8, scale=HEAD)
        tf = carry(jf, use_pallas="auto")
        jp = j_permute(jf)

        def jgrad(z):
            return j_streamed(jp, z, jtarget.log_density)

    model = nuts_cuda.pack_flow(tf, NealsFunnel(dim=d))
    return d, jgrad, nuts_cuda.plain_logp_grad(model)


def window_inputs(seed, d, window, depth, n=N, q_scale=1.0):
    """q, inv_mass and a window's randomness from numpy."""
    rng = np.random.default_rng(3000 + seed)
    f32 = np.float32
    S, D = window, depth
    im = (0.5 + rng.random(d)).astype(f32)
    p0c = (rng.normal(size=(n, S, d)).astype(f32)
           * (1.0 / np.sqrt(im))).reshape(n, S * d)
    return dict(
        q=(q_scale * rng.normal(size=(n, d))).astype(f32),
        p0c=p0c.astype(f32),
        dirs=np.where(rng.random((n, S * D)) < 0.5, 1.0, -1.0).astype(f32),
        u_acc=rng.random((n, S * D)).astype(f32),
        u_take=rng.random((n, S << D)).astype(f32)), im


KEYS = ("q", "p0c", "dirs", "u_acc", "u_take")


def jit_optimized(fn):
    """`jax.jit(fn)`, compiled once per shape of its arguments with XLA's
    CPU optimizations on: the suite's conftest turns them off for compile
    time, and a window's while loop then runs many times longer than it
    compiles."""
    jitted, compiled = jax.jit(fn), {}

    def call(*args):
        key = tuple((a.shape, a.dtype) for a in args)
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": 2})
        return compiled[key](*args)

    return call


def run_jax_math(jgrad, inp, eps, im, window, depth):
    fn = jit_optimized(lambda q, p0c, dd, ua, ut, e, m: _window_math(
        q, p0c, dd, ua, ut, e, m, jgrad, window, depth, 1000.0))
    out = fn(*(jnp.asarray(inp[k]) for k in KEYS),
             jnp.asarray(eps, jnp.float32), jnp.asarray(im).reshape(1, -1))
    draws = np.stack([np.asarray(o) for o in out[:window]])
    return (draws, *(np.asarray(o).T for o in out[window:]))


def run_port_math(tgrad, inp, eps, im, window, depth):
    out = nw.window_math_torch(
        *(torch.from_numpy(inp[k]) for k in KEYS), torch.tensor(eps),
        torch.from_numpy(im), tgrad, window, depth)
    return tuple(o.numpy() for o in out)


def compare(a, b):
    """Chains that take another decision in any slot, and the mask of the
    others."""
    flip = np.zeros(a[1].shape[1], bool)
    for i in DISCRETE:
        flip |= (a[i] != b[i]).any(axis=0)
    return np.nonzero(flip)[0], ~flip


def assert_window_close(a, b, tol, max_flips):
    flips, agree = compare(a, b)
    assert len(flips) <= max_flips, f"knife-edge chains {flips.tolist()}"
    np.testing.assert_allclose(a[0][:, agree], b[0][:, agree], **tol)
    for i, name in ((1, "lp"), (7, "energy"), (2, "accept")):
        np.testing.assert_allclose(a[i][:, agree], b[i][:, agree],
                                   err_msg=name, **tol)


TOL_JAX = dict(rtol=1e-4, atol=1e-4)
TOL_CHAIN = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind,seed,window,depth,eps", [
    ("diag", 0, 8, 5, 0.4), ("affine", 1, 6, 4, 0.3),
    ("affine", 2, 4, 5, 6.0), ("arqs", 0, 4, 4, 0.1),
    ("arqs", 3, 4, 4, 0.1)])
def test_window_math_matches_jax(kind, seed, window, depth, eps):
    d, jgrad, tgrad = case(kind, seed)
    inp, im = window_inputs(seed, d, window, depth,
                            q_scale=2.0 if eps > 1 else 1.0)
    ja = run_jax_math(jgrad, inp, eps, im, window, depth)
    to = run_port_math(tgrad, inp, eps, im, window, depth)
    assert to[0].shape == (window, N, d) and to[1].shape == (window, N)
    assert_window_close(to, ja, TOL_JAX, max_flips=1)
    if eps > 1:  # divergent leaves on both sides
        assert ja[5].sum() > 0
        np.testing.assert_array_equal(to[5], ja[5])
    else:  # real trees: several depths, U-turns, several slots
        assert len(np.unique(ja[4])) >= 2 and ja[6].sum() > 0


def jax_window_draws(key, n, d, window, depth, im):
    """(p0c, dirs, u_acc, u_take) as the JAX package's `win` derives them
    from its key: one key per chain, split in four."""
    S, D, L = window, depth, 1 << depth
    keys = jax.random.split(key, n)
    inv_sqrt = 1.0 / jnp.sqrt(jnp.asarray(im))

    def derive(kk):
        k1, k2, k3, k4 = jax.random.split(kk, 4)
        p0 = (jax.random.normal(k1, (S, d), jnp.float32)
              * inv_sqrt).reshape(S * d)
        dd = jnp.where(jax.random.bernoulli(k2, shape=(S * D,)), 1.0,
                       -1.0).astype(jnp.float32)
        ua = jax.random.uniform(k3, (S * D,), jnp.float32)
        ut = jax.random.uniform(k4, (S * L,), jnp.float32)
        return p0, dd, ua, ut

    return [np.array(a, np.float32) for a in jax.vmap(derive)(keys)]


def test_interpret_window_matches_port_on_replayed_draws():
    """The Pallas window in interpret mode (tile_b = 8, 16 chains: two
    tiles) against the port on the randomness it derived from its key."""
    d, n, S, D = 4, 16, 4, 4
    jt = JDiag(loc=jnp.asarray(LOC), scale=jnp.asarray(SCALE))
    win = make_fused_nuts_window(lambda x, p: jt.log_density(x), (),
                                 window=S, max_depth=D, tile_b=8,
                                 interpret=True)
    im = np.array([1.0, 0.25, 4.0, 1.0], np.float32)
    q = np.random.default_rng(5).normal(size=(n, d)).astype(np.float32)
    key = jax.random.key(7)
    draws, info = win(key, jnp.asarray(q), jnp.asarray(0.4),
                      jnp.asarray(im))
    ja = (np.asarray(draws), np.asarray(info.logp),
          np.asarray(info.accept_prob), np.asarray(info.num_steps),
          np.asarray(info.tree_depth), np.asarray(info.diverging),
          np.asarray(info.turning), np.asarray(info.energy))
    p0c, dd, ua, ut = jax_window_draws(key, n, d, S, D, im)
    to = nw.window_math_torch(
        torch.from_numpy(q), *(torch.from_numpy(a) for a in (p0c, dd, ua,
                                                             ut)),
        torch.tensor(0.4), torch.from_numpy(im), torch_diag_grad(), S, D)
    to = tuple(o.numpy() for o in to)
    to = (*to[:3], *(to[i].astype(ja[i].dtype) for i in DISCRETE), to[7])
    assert_window_close(to, ja, TOL_JAX, max_flips=1)
    assert len(np.unique(ja[4])) >= 2


def window_and_chained(kind, seed, window, depth, eps):
    """window_math_torch and S chained transition_math_torch calls on the
    same inputs, as numpy."""
    d, _, tgrad = case(kind, seed)
    inp, im = window_inputs(seed, d, window, depth,
                            q_scale=2.0 if eps > 1 else 1.0)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    e, m = torch.tensor(eps), torch.from_numpy(im)
    win = nw.window_math_torch(*(t[k] for k in KEYS), e, m, tgrad, window,
                               depth)
    chained = nw.chain_slots(
        lambda q, *r: nuts_cuda.transition_math_torch(q, *r, e, m, tgrad,
                                                      depth),
        *(t[k] for k in KEYS), window, depth)
    return (tuple(o.numpy() for o in win),
            tuple(o.numpy() for o in chained))


@pytest.mark.parametrize("kind,seed,window,depth,eps", [
    ("affine", 5, 8, 5, 0.3), ("affine", 8, 6, 4, 0.2),
    ("diag", 6, 8, 5, 0.5), ("arqs", 3, 4, 4, 0.1)])
def test_window_equals_chained_transitions(kind, seed, window, depth, eps):
    a, b = window_and_chained(kind, seed, window, depth, eps)
    for i in DISCRETE:
        np.testing.assert_array_equal(a[i], b[i])
    assert_window_close(a, b, TOL_CHAIN, max_flips=0)
    assert (a[3] >= 1).all() and len(np.unique(a[4])) >= 2


def test_window_after_a_divergence_differs_from_chained_transitions():
    """At eps 6 a divergent leaf leaves finite positions of order 1e19 in
    the window's subtree state, and the next slot's blends b + m (a - b)
    through them cancel catastrophically (JAX's `_window_math` does the
    same, and (a) holds the port to it); chained transitions, and K2,
    select instead. So slot 0 agrees in every decision, and every later
    disagreement is on a chain that diverged in an earlier slot."""
    a, b = window_and_chained("affine", 7, 4, 4, 6.0)
    differ = np.zeros_like(a[3], bool)
    for i in DISCRETE:
        differ |= a[i] != b[i]
    diverged_before = (np.cumsum(a[5], axis=0) - a[5]) > 0
    assert a[5].sum() > 0 and differ.any()
    assert not differ[0].any()
    assert not (differ & ~diverged_before).any()
    np.testing.assert_allclose(a[0][0], b[0][0], **TOL_CHAIN)


def test_window_chains_are_independent():
    """K2's warp-per-chain design rests on this: a chain's window does not
    depend on its batch-mates (a finished chain is frozen by the masks),
    so one chain at a time gives the batch's result."""
    d, _, tgrad = case("affine", 9)
    S, D, n = 4, 4, 12
    inp, im = window_inputs(9, d, S, D, n=n)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    e, m = torch.tensor(0.35), torch.from_numpy(im)
    batch = nw.window_math_torch(*(t[k] for k in KEYS), e, m, tgrad, S, D)
    singles = [nw.window_math_torch(*(t[k][i:i + 1] for k in KEYS), e, m,
                                    tgrad, S, D) for i in range(n)]
    assert len(torch.unique(batch[4])) >= 2
    for j in range(8):
        single = torch.cat([s[j] for s in singles], dim=1)
        if j in DISCRETE:
            assert torch.equal(single, batch[j])
        else:
            torch.testing.assert_close(single, batch[j], rtol=1e-5,
                                       atol=1e-5)


def _window(seed=3, window=4, depth=4):
    tf = torch_flow(jax_flow(flow_leaves(seed)))
    return nw.fused_nuts_window_for_flow(NealsFunnel(dim=8), tf,
                                         window=window, max_depth=depth)


def test_cpu_wrapper_runs_plain_version_and_counts_no_launch():
    win = _window()
    before = nw.LAUNCHES
    g = torch.Generator().manual_seed(0)
    q = torch.randn(16, 8, generator=g)
    out = torch.empty(4, 16, 8)
    draws, info = win(g, q, torch.tensor(0.3), torch.ones(8), out=out)
    assert nw.LAUNCHES == before and win.window == 4
    assert draws is out and torch.isfinite(draws).all()
    assert info.num_steps.shape == (4, 16)
    assert info.num_steps.dtype == torch.int32
    assert ((info.accept_prob >= 0) & (info.accept_prob <= 1)).all()
    assert (info.tree_depth <= 4).all()
    # the same randomness through the plain version directly
    g = torch.Generator().manual_seed(0)
    q2 = torch.randn(16, 8, generator=g)
    rnd = draw_window_randomness(g, 16, 8, 4, 4, torch.ones(8))
    ref = nw.window_math_torch(q2, *rnd, torch.tensor(0.3), torch.ones(8),
                               nuts_cuda.plain_logp_grad(win.model), 4, 4)
    assert torch.equal(ref[0], draws)


def test_draw_window_randomness_layout():
    """p0c is the (n, S, d) normal draw times 1 / sqrt(inv_mass), slot-major
    in each row; signs are +-1 and the uniforms lie in [0, 1)."""
    im = torch.tensor([1.0, 4.0, 0.25])
    rnd = draw_window_randomness(torch.Generator().manual_seed(2), 5, 3, 4,
                                 3, im)
    p0c, dirs, u_acc, u_take = rnd
    assert [tuple(t.shape) for t in rnd] == [(5, 12), (5, 12), (5, 12),
                                             (5, 32)]
    z = torch.randn((5, 4, 3), generator=torch.Generator().manual_seed(2))
    assert torch.equal(p0c, (z * (1.0 / torch.sqrt(im))).reshape(5, 12))
    assert set(dirs.unique().tolist()) <= {-1.0, 1.0}
    for u in (u_acc, u_take):
        assert (u >= 0).all() and (u < 1).all()


@pytest.mark.parametrize("bad", ["p0c", "u_take", "window", "dtype",
                                 "device", "depth", "out"])
def test_wrapper_rejects_bad_inputs(bad):
    model = _window().model
    inp, im = window_inputs(0, 8, 4, 4, n=16)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    window, depth, out, err = 4, 4, None, ValueError
    if bad in ("p0c", "u_take"):
        t[bad] = t[bad][:, :-1]
    elif bad == "window":
        window = 0
    elif bad == "dtype":
        t["u_acc"] = t["u_acc"].double()
        err = TypeError
    elif bad == "device":
        t["dirs"] = t["dirs"].to("meta")
    elif bad == "depth":
        depth = nuts_cuda.MAX_DEPTH + 1
    else:
        out = torch.empty(4, 16, 9)
    with pytest.raises(err):
        nw.nuts_window(*(t[k] for k in KEYS), torch.tensor(0.3),
                       torch.from_numpy(im), model, depth, window, out=out)


def test_window_rejects_what_k1_rejects():
    from tpuflows_torch.flows import Chain, Inverted

    tf = torch_flow(jax_flow(flow_leaves(0)))
    with pytest.raises(ValueError):
        nw.fused_nuts_window_for_flow(NealsFunnel(dim=16), tf)
    with pytest.raises(ValueError):
        nw.fused_nuts_window_for_flow(
            NealsFunnel(dim=8), Chain([tf.transforms[0],
                                       Inverted(tf.transforms[1])]))
    with pytest.raises(ValueError):
        nw.fused_nuts_window_for_flow(NealsFunnel(dim=8), tf, window=0)


class CountingWindow:
    """A window transition that counts its calls."""

    def __init__(self, inner):
        self.inner, self.window, self.calls = inner, inner.window, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.inner(*args, **kw)


def test_driver_window_draws():
    tf = torch_flow(jax_flow(flow_leaves(4)))
    target = NealsFunnel(dim=8)
    win = CountingWindow(nw.fused_nuts_window_for_flow(target, tf,
                                                       window=4,
                                                       max_depth=4))
    k1 = nuts_cuda.fused_nuts_for_flow(target, tf, max_depth=4)
    driver = NUTSDriver(transition=k1, window_transition=win)
    g = torch.Generator().manual_seed(1)
    state = driver.warmup(g, torch.randn(16, 8, generator=g), 20)
    assert win.calls == 0  # warmup runs the per-transition path only
    new, z, info = driver.draws(g, state, 12)
    assert win.calls == 3
    assert z.shape == (12, 16, 8) and torch.isfinite(z).all()
    assert info.num_steps.shape == (12, 16)
    assert info.tree_depth.dtype == torch.int32
    assert torch.equal(new.q, z[-1]) and new.step_size is state.step_size
    # continuation: the next call starts where this one stopped
    _, z2, _ = driver.draws(g, new, 4)
    assert not torch.equal(z2[0], z[-1])
    with pytest.raises(ValueError, match="multiple"):
        driver.draws(g, new, 6)


def test_driver_refuses_bad_windows():
    win = _window()
    with pytest.raises(ValueError, match="pooled"):
        NUTSDriver(lambda x: -x.sum(-1), window_transition=win,
                   per_chain_step_size=True)
    with pytest.raises(ValueError, match="window"):
        NUTSDriver(lambda x: -x.sum(-1),
                   window_transition=lambda *a, **k: None)


def test_window_math_samples_correct_moments():
    """The window on a diagonal normal, 256 chains, windows of 8, 50
    windows continued from the last draw (the first 10 dropped): every
    mean and variance within 5 Monte-Carlo sigma of the truth by the
    port's `moment_gate`, the standard deviations within 6%, the mean
    accept statistic above 0.6."""
    d, n, S, D = 4, 256, 8, 5
    im = torch.tensor([1.0, 0.25, 4.0, 1.0])
    g = torch.Generator().manual_seed(0)
    q = torch.randn(n, d, generator=g)
    grad = torch_diag_grad()
    xs = []
    for i in range(50):
        rnd = draw_window_randomness(g, n, d, S, D, im)
        draws, *info = nw.window_math_torch(q, *rnd, torch.tensor(0.4), im,
                                            grad, S, D)
        q = draws[-1]
        if i >= 10:
            xs.append(draws)
    x = torch.cat(xs)
    check = moment_gate(x, torch.from_numpy(LOC),
                        torch.from_numpy(SCALE ** 2), n_sigma=5.0)
    assert check.passed, check
    np.testing.assert_allclose(x.reshape(-1, d).std(0).numpy(), SCALE,
                               rtol=0.06)
    assert float(info[1].mean()) > 0.6 and bool((info[2] >= 1).all())
