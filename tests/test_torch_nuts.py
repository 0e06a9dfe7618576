"""K1, the fused NUTS transition: the port's plain version
(`transition_math_torch`) against the JAX package's `_transition_math` on
the same numpy inputs and randomness, on the CPU.

The JAX side calls `_transition_math` directly (the JAX package's own plain
reference of its Pallas kernel), with its gradient by `jax.vjp`; the port's
side takes its gradient by `torch.autograd`. Tolerances: every chain agrees
on tree depth, leapfrog count, divergence and U-turn except at most one
knife-edge chain (a 1-ulp energy difference may flip a halting decision and
is named when it does); on agreeing chains q, logp and energy agree to 1e-4
(float32 rounding, carried through up to 2^max_depth - 1 leapfrogs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows.flows.affine import AffineCoupling as JAffine
from tpuflows.flows.affine import Standardize as JStandardize
from tpuflows.flows.core import Chain as JChain
from tpuflows.flows.nets import MLP as JMLP
from tpuflows.kernels.nuts_pallas import _transition_math
from tpuflows.mcmc.nuts import _popcount32 as j_popcount
from tpuflows.mcmc.nuts import _trailing_zeros32 as j_tz
from tpuflows.targets import NealsFunnel as JFunnel

from tpuflows_torch.convert import flow_from_jax_params
from tpuflows_torch.kernels import nuts_cuda
from tpuflows_torch.mcmc.nuts import _popcount32, _trailing_zeros32
from tpuflows_torch.targets import NealsFunnel

D_MODEL, HIDDEN, N, DEPTH = 8, (16, 16), 64, 4


def flow_leaves(seed, d=D_MODEL, hidden=HIDDEN, mask=None):
    """Numpy leaves of a Standardize + AffineCoupling flow whose last
    conditioner layer is NOT zero (a zero layer would hide every error in
    the MLP path)."""
    rng = np.random.default_rng(seed)
    sizes = (d, *hidden, 2 * d)
    ws = [rng.normal(0.0, np.sqrt(2.0 / a), (a, b)).astype(np.float32)
          for a, b in zip(sizes[:-1], sizes[1:])]
    ws[-1] *= 0.3
    bs = [rng.normal(0.0, 0.1, (b,)).astype(np.float32) for b in sizes[1:]]
    if mask is None:
        mask = tuple(1 if j == 0 else 0 for j in range(d))
    return dict(loc=rng.normal(0.0, 0.3, d).astype(np.float32),
                log_scale=rng.normal(0.0, 0.2, d).astype(np.float32),
                weights=ws, biases=bs, mask=tuple(mask), clamp=8.0)


def jax_flow(lv):
    net = JMLP(weights=tuple(jnp.asarray(w) for w in lv["weights"]),
               biases=tuple(jnp.asarray(b) for b in lv["biases"]))
    return JChain(transforms=(
        JStandardize(loc=jnp.asarray(lv["loc"]),
                     log_scale=jnp.asarray(lv["log_scale"])),
        JAffine(mask=lv["mask"], net=net, clamp=lv["clamp"])))


def torch_flow(jf):
    """Carry the JAX flow across through its leaves, as numpy arrays."""
    std, cp = jf.transforms
    return flow_from_jax_params(
        np.asarray(std.loc), np.asarray(std.log_scale),
        [np.asarray(w) for w in cp.net.weights],
        [np.asarray(b) for b in cp.net.biases], cp.mask, cp.clamp,
        device="cpu")


def make_inputs(seed, n=N, d=D_MODEL, depth=DEPTH, q_scale=1.0):
    rng = np.random.default_rng(1000 + seed)
    f32 = np.float32
    return dict(
        q=(q_scale * rng.normal(size=(n, d))).astype(f32),
        p0=rng.normal(size=(n, d)).astype(f32),
        dirs=np.where(rng.random((n, depth)) < 0.5, 1.0, -1.0).astype(f32),
        u_acc=rng.random((n, depth)).astype(f32),
        u_take=rng.random((n, 1 << depth)).astype(f32))


def jax_transition_fn(jf, target, depth):
    """The JAX package's plain transition, jitted once per flow."""

    def logp_grad(xt):
        def tm(x):
            xx, ladj = jf.inverse_and_ladj(x)
            return (target.log_density(xx) + ladj)[:, None]

        lp, pull = jax.vjp(tm, xt)
        (gx,) = pull(jnp.ones_like(lp))
        return lp, gx

    return jax.jit(lambda q, p0, dirs, ua, ut, e, im: _transition_math(
        q, p0, dirs, ua, ut, e, im, logp_grad, depth, 1000.0))


def jax_transition(jf, target, inp, eps, inv_mass, depth, fn=None):
    fn = fn or jax_transition_fn(jf, target, depth)
    out = fn(*(jnp.asarray(inp[k]) for k in
               ("q", "p0", "dirs", "u_acc", "u_take")),
             jnp.asarray(eps, jnp.float32),
             jnp.asarray(inv_mass, jnp.float32).reshape(1, -1))
    q, lp, acc, steps, dep, div, turn, h0 = (np.asarray(o) for o in out)
    return (q, lp[:, 0], acc[:, 0], steps[:, 0], dep[:, 0], div[:, 0],
            turn[:, 0], h0[:, 0])


def torch_transition(tf, target, inp, eps, inv_mass, depth):
    model = nuts_cuda.pack_flow(tf, target)
    out = nuts_cuda.nuts_transition(
        *(torch.from_numpy(inp[k]) for k in
          ("q", "p0", "dirs", "u_acc", "u_take")),
        torch.tensor(eps, dtype=torch.float32),
        torch.as_tensor(np.asarray(inv_mass, np.float32)), model, depth)
    return tuple(o.numpy() for o in out)


def compare(a, b):
    """Knife-edge chains (any discrete disagreement) and the agreeing
    chains' mask."""
    discrete = np.zeros(a[0].shape[0], bool)
    for i in (3, 4, 5, 6):  # n_steps, depth, diverging, turning
        discrete |= a[i] != b[i]
    return np.nonzero(discrete)[0], ~discrete


@pytest.mark.parametrize("x", list(range(0, 70, 3)) + [1 << 20, 12345])
def test_bit_helpers_match_jax(x):
    assert _popcount32(x) == int(j_popcount(jnp.int32(x)))
    if x > 0:
        assert _trailing_zeros32(x) == int(j_tz(jnp.int32(x)))
    t = torch.tensor([x, x + 1], dtype=torch.int64)
    assert _popcount32(t).tolist() == [int(j_popcount(jnp.int32(v)))
                                       for v in (x, x + 1)]


@pytest.mark.parametrize("seed,eps,random_mask", [
    (0, 0.3, False), (1, 0.5, False), (2, 0.2, True), (3, 0.9, False),
    (4, 0.4, True)])
def test_transition_matches_jax(seed, eps, random_mask):
    mask = None
    if random_mask:
        rng = np.random.default_rng(seed)
        mask = tuple(int(m) for m in rng.integers(0, 2, D_MODEL))
    lv = flow_leaves(seed, mask=mask)
    jf = jax_flow(lv)
    tf = torch_flow(jf)
    inp = make_inputs(seed)
    im = np.linspace(0.5, 1.5, D_MODEL).astype(np.float32)
    ja = jax_transition(jf, JFunnel(dim=D_MODEL), inp, eps, im, DEPTH)
    to = torch_transition(tf, NealsFunnel(dim=D_MODEL), inp, eps, im, DEPTH)
    flips, agree = compare(ja, to)
    assert len(flips) <= 1, f"knife-edge chains {flips.tolist()}"
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to[0][agree], ja[0][agree], **tol)  # q
    np.testing.assert_allclose(to[1][agree], ja[1][agree], **tol)  # logp
    np.testing.assert_allclose(to[7], ja[7], **tol)  # energy, every chain
    np.testing.assert_allclose(to[2][agree], ja[2][agree], **tol)
    # the run exercised real trees: several depths, some U-turns
    assert len(np.unique(ja[4])) >= 2 and ja[6].sum() > 0


def test_transition_divergence_matches_jax():
    """A step size far too large: divergent leaves, with inf/nan handling
    on both sides."""
    lv = flow_leaves(7)
    jf = jax_flow(lv)
    tf = torch_flow(jf)
    inp = make_inputs(7, q_scale=2.0)
    im = np.ones(D_MODEL, np.float32)
    ja = jax_transition(jf, JFunnel(dim=D_MODEL), inp, 6.0, im, DEPTH)
    to = torch_transition(tf, NealsFunnel(dim=D_MODEL), inp, 6.0, im, DEPTH)
    flips, agree = compare(ja, to)
    assert len(flips) <= 1, f"knife-edge chains {flips.tolist()}"
    assert ja[5].sum() > 0  # some chains diverged
    np.testing.assert_array_equal(to[5], ja[5])
    np.testing.assert_allclose(to[0][agree], ja[0][agree], rtol=1e-4,
                               atol=1e-4)


def _chain_by_chain(run, inp):
    outs = [run({k: v[i:i + 1] for k, v in inp.items()})
            for i in range(inp["q"].shape[0])]
    return tuple(np.concatenate([o[j] for o in outs]) for j in range(8))


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_chains_are_independent(side):
    """The warp-per-chain design of K1 rests on this: a chain's transition
    does not depend on its batch-mates, so running the chains one at a time
    gives the batch's result (the subtree loop of `_transition_math` ends
    early only when every chain is done, and stopped chains are frozen)."""
    lv = flow_leaves(11)
    jf = jax_flow(lv)
    inp = make_inputs(11, n=24)
    im = np.ones(D_MODEL, np.float32)
    if side == "jax":
        target = JFunnel(dim=D_MODEL)
        fn = jax_transition_fn(jf, target, DEPTH)

        def run(x):
            return jax_transition(jf, target, x, 0.4, im, DEPTH, fn)
    else:
        tf = torch_flow(jf)
        target = NealsFunnel(dim=D_MODEL)

        def run(x):
            return torch_transition(tf, target, x, 0.4, im, DEPTH)
    batch = run(inp)
    single = _chain_by_chain(run, inp)
    assert len(np.unique(batch[4])) >= 2  # trees of different depths
    for j in (3, 4, 5, 6):
        np.testing.assert_array_equal(single[j], batch[j])
    for j in (0, 1, 2, 7):
        np.testing.assert_allclose(single[j], batch[j], rtol=1e-5,
                                   atol=1e-5)


def test_cpu_wrapper_runs_plain_version_and_counts_no_launch():
    lv = flow_leaves(3)
    tf = torch_flow(jax_flow(lv))
    before = nuts_cuda.LAUNCHES
    trans = nuts_cuda.fused_nuts_for_flow(NealsFunnel(dim=D_MODEL), tf,
                                          max_depth=DEPTH)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(16, D_MODEL, generator=g)
    q_new, info = trans(g, q, torch.tensor(0.3), torch.ones(D_MODEL))
    assert nuts_cuda.LAUNCHES == before
    assert q_new.shape == q.shape and torch.isfinite(q_new).all()
    assert info.num_steps.dtype == torch.int32
    assert ((info.accept_prob >= 0) & (info.accept_prob <= 1)).all()
    assert (info.tree_depth <= DEPTH).all()


def _model():
    return nuts_cuda.pack_flow(torch_flow(jax_flow(flow_leaves(0))),
                                        NealsFunnel(dim=D_MODEL))


@pytest.mark.parametrize("bad", ["width", "dtype", "depth", "u_take"])
def test_wrapper_rejects_bad_inputs(bad):
    model = _model()
    inp = {k: torch.from_numpy(v) for k, v in make_inputs(0).items()}
    eps, im, depth = torch.tensor(0.3), torch.ones(D_MODEL), DEPTH
    err = ValueError
    if bad == "width":
        inp["q"] = torch.zeros(N, D_MODEL + 1)
    elif bad == "dtype":
        inp["p0"] = inp["p0"].double()
        err = TypeError
    elif bad == "depth":
        depth = nuts_cuda.MAX_DEPTH + 1
    else:
        inp["u_take"] = inp["u_take"][:, :3]
    with pytest.raises(err):
        nuts_cuda.nuts_transition(inp["q"], inp["p0"], inp["dirs"],
                                  inp["u_acc"], inp["u_take"], eps, im,
                                  model, depth)


def test_pack_rejects_other_flows_and_targets():
    """What K1 does not compute is refused when the flow is packed: a
    target of another width, a module of another kind, a conditioner that
    is not a 3-layer MLP. (A Standardize-only chain packs since the
    module-list kernel: `test_pack_takes_a_standardize_only_chain`.)"""
    from tpuflows_torch.flows import AffineCoupling, Chain, Inverted, MLP

    tf = torch_flow(jax_flow(flow_leaves(0)))
    with pytest.raises(ValueError):
        nuts_cuda.pack_flow(tf, NealsFunnel(dim=16))
    with pytest.raises(ValueError):
        nuts_cuda.pack_flow(Chain([tf.transforms[0],
                                   Inverted(tf.transforms[1])]),
                            NealsFunnel(dim=D_MODEL))
    g = torch.Generator().manual_seed(0)
    deep = AffineCoupling(tf.transforms[1].mask,
                          MLP.init((D_MODEL, 8, 8, 8, 2 * D_MODEL), g))
    with pytest.raises(ValueError):
        nuts_cuda.pack_flow(Chain([tf.transforms[0], deep]),
                            NealsFunnel(dim=D_MODEL))


def test_pack_takes_a_standardize_only_chain():
    """A Chain of one Standardize is a module list for the kernel; on the
    CPU its transition runs the plain version with the autograd
    gradient."""
    from tpuflows_torch.flows import Chain, Standardize

    lv = flow_leaves(2)
    flow = Chain([Standardize(torch.from_numpy(lv["loc"]),
                              torch.from_numpy(lv["log_scale"]))])
    model = nuts_cuda.pack_flow(flow, NealsFunnel(dim=D_MODEL))
    assert model.flow_p is None and model.hidden == ()
    assert model.mods.tolist() == [[0, 0, 0, 0, 0, 0, 0, 0]]
    dp = model.d_pad  # loc and log_scale padded with zeros to the lanes
    torch.testing.assert_close(
        model.params, torch.cat([
            nuts_cuda.pad_lanes(flow.transforms[0].loc, dp),
            nuts_cuda.pad_lanes(flow.transforms[0].log_scale, dp)]).detach())
    inp = make_inputs(2)
    out = nuts_cuda.nuts_transition(
        *(torch.from_numpy(inp[k]) for k in ("q", "p0", "dirs", "u_acc",
                                             "u_take")),
        torch.tensor(0.3), torch.ones(D_MODEL), model, DEPTH)
    assert torch.isfinite(out[0]).all() and (out[3] >= 1).all()


def test_packed_layout_matches_kernel_order():
    """The packed buffer holds the leaves in the order the module-list
    kernels read them (the `Net` layout), with transposed weight copies,
    and then the tile kernels' compact first and last layers, at the
    offset column 6 of the coupling's row of the module list holds."""
    model = _model()
    std, cp = model.flow.transforms
    # the leaves at the lane width d (the flow's D_MODEL dims padded to 32:
    # zero W1 rows and zero head columns past them)
    d, (h1, h2) = model.d_pad, model.hidden
    p = model.params
    off = 3 * d
    w1 = p[off:off + d * h1].reshape(d, h1)
    torch.testing.assert_close(w1[:D_MODEL], cp.net.weights[0].detach())
    assert not w1[D_MODEL:].any()
    net = 3 * d + 2 * (d * h1 + h1 * h2 + h2 * 2 * d) + h1 + h2 + 2 * d
    w3t = p[net - 2 * d * h2:net].reshape(2, d, h2)[:, :D_MODEL]
    torch.testing.assert_close(w3t.reshape(2 * D_MODEL, h2),
                               cp.net.weights[2].detach().t())
    # the compact tail: W1, W1^T over the pass-through dims, W3, b3, W3^T
    # over the transformed dims' head columns, widths padded to 32
    n_p = int(sum(cp.mask))
    n_in, n_head = -(-n_p // 32) * 32, -(-2 * (D_MODEL - n_p) // 32) * 32
    assert model.mods[1, 6:].tolist() == [net, n_p]
    assert p.numel() == net + 2 * n_in * h1 + 2 * h2 * n_head + n_head
    keep = torch.tensor(cp.mask).bool()
    cw1 = p[net:net + n_in * h1].reshape(n_in, h1)
    torch.testing.assert_close(cw1[:n_p], cp.net.weights[0].detach()[keep])
