"""K1 on spline flows: the port's plain version against the JAX package on
the same numpy flow and randomness, at d = 8 with 2 arqs blocks (5
modules: Standardize + 2 x (affine + spline)), hidden 16, K = 4.

  * `tile_flow.tile_inverse_and_ladj` and `tile_logp_and_grad_streamed`
    against the JAX package's on the p-major relayout (1e-5; the same
    float32 formulas in the same order, up to exp's last bit);
  * the packer: the p-major last layers it writes are JAX's
    `permute_for_tiles` relayout, at the offsets of the module list;
  * `kernel_chain_logp_grad`, the module-list gradient of
    `csrc/latent_grad.cuh` (`chain_logp_grad`, the device code of K1 and
    K3) written out in torch, reading the leaves from the packed buffer
    by the module list, with the hand-written spline pullback of `csrc/rqs_math.cuh` (the mirror in
    test_torch_rqs.py): against autograd through the flow, 1e-4 relative
    and absolute (|grad| reaches ~1e3 on these flows, and a gradient
    pulled through three spline pullbacks in another order differs there
    by up to ~2e-5 relative);
  * `transition_math_torch` against JAX's `fused_nuts_for_flow` in
    Pallas interpret mode, on the randomness the JAX transition derives
    from its keys: the bar of tests/test_torch_nuts.py (at most one
    knife-edge chain; 1e-4 on q, logp and energy);
  * on the CPU the wrapper runs the plain version and counts no launch.

Run as a script it measures the spread of the plain version against the
JAX package on the CPU: `python tests/test_torch_nuts_spline.py rows` at
the flows and inputs of `chip_smoke.py`'s spline rows (built there on the
CPU), and `python tests/test_torch_nuts_spline.py STATE` at the generic
path's trained flow and post-warmup state that `chip_smoke.py
--save-generic-state STATE` saved on the card.
"""
import math
import struct
import sys
from pathlib import Path

if __name__ == "__main__":  # run as a script: the packages live in src/
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows.kernels.nuts_pallas import _transition_math
from tpuflows.kernels.nuts_pallas import fused_nuts_for_flow as j_fused
from tpuflows.kernels.tile_flow import permute_for_tiles as j_permute
from tpuflows.kernels.tile_flow import tile_inverse_and_ladj as j_tile_inv
from tpuflows.kernels.tile_flow import (
    tile_logp_and_grad_streamed as j_streamed)
from tpuflows.targets import NealsFunnel as JFunnel

from tpuflows_torch.kernels import nuts_cuda, rqs_cuda, tile_flow
from tpuflows_torch.targets import NealsFunnel

from test_torch_coupling import carry, jax_arqs_flow
from test_torch_rqs import mirror_vjp
from test_torch_nuts_window import jit_optimized

D, DEPTH = 8, 4
TOL = dict(rtol=1e-5, atol=1e-5)


def _flows(seed, **kw):
    jf = jax_arqs_flow(seed, **kw)
    return jf, carry(jf, use_pallas="auto")


def _z(seed, n=32, d=D):
    return np.random.default_rng(500 + seed).normal(size=(n, d)).astype(
        np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_tile_inverse_matches_jax_and_the_flow(seed):
    jf, tf = _flows(seed)
    z = _z(seed)
    jx, jl = j_tile_inv(j_permute(jf), jnp.asarray(z))
    tp = tile_flow.permute_for_tiles(tf)
    with torch.no_grad():
        tx, tl = tile_flow.tile_inverse_and_ladj(tp, torch.from_numpy(z))
        fx, fl = tf.inverse_and_ladj(torch.from_numpy(z))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    # the relayout computes the flow's own inverse
    np.testing.assert_allclose(tx.numpy(), fx.numpy(), **TOL)
    np.testing.assert_allclose(tl.numpy(), fl.numpy(), **TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_streamed_gradient_matches_jax(seed):
    jf, tf = _flows(seed)
    z = _z(seed)
    jlp, jg = j_streamed(j_permute(jf), jnp.asarray(z),
                         JFunnel(dim=D).log_density)
    tlp, tg = tile_flow.tile_logp_and_grad_streamed(
        tile_flow.permute_for_tiles(tf), torch.from_numpy(z),
        NealsFunnel(dim=D).log_density)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-4)


def test_packer_relayout_matches_permute_for_tiles():
    """Module k's leaves start at mods[k][1]; a spline's last layer W3
    (h2, P d) and b3 are JAX's p-major relayout, followed by W1^T, W2^T
    and W3^T; the hidden widths as packed, 16 padded to 32 with zero
    units (W3's rows past 16 zero)."""
    jf, tf = _flows(4)
    jp = j_permute(jf)
    model = nuts_cuda.pack_flow(tf, NealsFunnel(dim=D))
    p, dp = model.params, model.d_pad  # packed at the lane width
    assert dp == 32
    rows = model.mods.tolist()
    assert [r[0] for r in rows] == [0, 1, 2, 1, 2]
    assert model.flow_p is not None and model.resident_floats == 0
    for row, jt in zip(rows, jp.transforms):
        kind, off, h1, h2, K = row[:5]
        if kind == 0:
            np.testing.assert_array_equal(p[off:off + D].numpy(),
                                          np.asarray(jt.loc))
            assert not p[off + D:off + dp].any()
            continue
        c = struct.unpack("<f", struct.pack("<i", row[5]))[0]
        assert c == (jt.range_limit if kind == 2 else jt.clamp)
        n_par = 2 if kind == 1 else 3 * K - 1
        n_out = n_par * dp
        o = off + dp + dp * h1 + h1 + h1 * h2 + h2
        w3 = p[o:o + h2 * n_out].reshape(h2, n_par, dp)
        b3 = p[o + h2 * n_out:o + h2 * n_out + n_out].reshape(n_par, dp)
        # each parameter's columns over the flow's D dims, zeros past them
        jh2 = jt.net.weights[-1].shape[0]
        np.testing.assert_array_equal(
            w3[:jh2, :, :D].reshape(jh2, -1).numpy(),
            np.asarray(jt.net.weights[-1]))
        assert not w3[jh2:].any()
        np.testing.assert_array_equal(b3[:, :D].reshape(-1).numpy(),
                                      np.asarray(jt.net.biases[-1]))
        assert not w3[..., D:].any() and not b3[:, D:].any()
        t_end = o + h2 * n_out + n_out + h1 * dp + h2 * h1
        np.testing.assert_array_equal(
            p[t_end:t_end + n_out * h2].reshape(n_out, h2).numpy(),
            w3.reshape(h2, n_out).numpy().T)
    assert model.head == (3 * 4 - 1) * dp and model.hmax == 32


# ---------------------------------------------------------------------------
# csrc/latent_grad.cuh `chain_logp_grad` (K1, K3), written out in torch
# ---------------------------------------------------------------------------
def _silu_grad(a):
    s = torch.sigmoid(a)
    return s * (1.0 + a * (1.0 - s))


def kernel_chain_logp_grad(model, sigma_v=3.0):
    """z (T, d) -> (lp (T, 1), g (T, d)) the way the module-list kernel
    computes them, from `model.params` and `model.mods`, at the lane width
    d_pad the flow is packed at (z padded with zeros, g's first d columns
    returned). No autograd."""
    p, d = model.params.detach(), model.d_pad

    def leaves(row):
        kind, off, h1, h2, K, cbits = row[:6]
        c = struct.unpack("<f", struct.pack("<i", cbits))[0]
        if kind == 0:
            return kind, {"loc": p[off:off + d], "ls": p[off + d:off + 2 * d]}
        n_out = 2 * d if kind == 1 else (3 * K - 1) * d
        names = [("mask", (d,)), ("w1", (d, h1)), ("b1", (h1,)),
                 ("w2", (h1, h2)), ("b2", (h2,)), ("w3", (h2, n_out)),
                 ("b3", (n_out,)), ("w1t", (h1, d)), ("w2t", (h2, h1)),
                 ("w3t", (n_out, h2))]
        out, o = {"c": c, "K": K}, off
        for name, shape in names:
            n = math.prod(shape)
            out[name] = p[o:o + n].reshape(shape)
            o += n
        return kind, out

    mods = [leaves(r) for r in model.mods.tolist()]

    def mlp(L, y):
        a1 = (y * L["mask"]) @ L["w1"] + L["b1"]
        a2 = torch.nn.functional.silu(a1) @ L["w2"] + L["b2"]
        return a1, a2, torch.nn.functional.silu(a2) @ L["w3"] + L["b3"]

    def mlp_backward(L, a1, a2, gh):
        g2 = (gh @ L["w3t"]) * _silu_grad(a2)
        g1 = (g2 @ L["w2t"]) * _silu_grad(a1)
        return g1 @ L["w1t"]

    def raw_of(head, K):  # p-major head -> (T, d, 3K-1)
        return head.reshape(head.shape[0], 3 * K - 1, d).transpose(1, 2)

    def fn(z):
        z = nuts_cuda.pad_lanes(z, d)
        x, ladj, bounds = z, torch.zeros(z.shape[0]), [None] * len(mods)
        for k in range(len(mods) - 1, -1, -1):  # sweep 1
            bounds[k] = x
            kind, L = mods[k]
            if kind == 0:
                x = x * torch.exp(L["ls"]) + L["loc"]
                ladj = ladj + L["ls"].sum()
                continue
            m, om = L["mask"], 1.0 - L["mask"]
            _, _, head = mlp(L, x)
            if kind == 1:
                s = L["c"] * torch.tanh(head[:, d:] / L["c"])
                x = m * x + om * ((x - head[:, :d]) * torch.exp(-s))
                ladj = ladj - (om * s).sum(-1)
            else:
                xt, lel = rqs_cuda.plain_eval(x, raw_of(head, L["K"]),
                                              L["c"], inverse=True)
                x = torch.where(m == 0, xt, x)
                ladj = ladj + (om * lel).sum(-1)
        v, rest = x[:, 0], x[:, 1:]
        sq = (rest * rest).sum(-1)
        env = torch.exp(-v)
        k = float(model.d - 1)
        lp = (-0.5 * (v / sigma_v) ** 2 - math.log(sigma_v)
              - 0.5 * math.log(2 * math.pi) - 0.5 * sq * env - 0.5 * k * v
              - 0.5 * k * math.log(2 * math.pi)) + ladj
        g = -x * env[:, None]
        g[:, 0] = -v / sigma_v ** 2 + 0.5 * sq * env - 0.5 * k
        for k in range(len(mods)):  # sweep 2
            kind, L = mods[k]
            y = bounds[k]
            if kind == 0:
                g = g * torch.exp(L["ls"])
                continue
            m, om = L["mask"], 1.0 - L["mask"]
            a1, a2, head = mlp(L, y)
            if kind == 1:
                c = L["c"]
                th = torch.tanh(head[:, d:] / c)
                e = torch.exp(-(c * th))
                yt = (y - head[:, :d]) * e
                gh = torch.cat([-om * g * e,
                                -om * (g * yt + 1.0) * (1.0 - th * th)], -1)
                gd = g * (m + om * e)
            else:
                K = L["K"]
                dy, draw = mirror_vjp(y, raw_of(head, K), g,
                                      torch.ones_like(g), L["c"], True)
                gd = torch.where(m == 0, dy, g)
                draw = torch.where((m == 0)[..., None], draw, 0.0)
                gh = draw.transpose(1, 2).reshape(y.shape[0], -1)
            g = gd + m * mlp_backward(L, a1, a2, gh)
        return lp[:, None], g[:, :model.d]

    return fn


@pytest.mark.parametrize("seed,n_blocks,knots", [(0, 2, 4), (1, 3, 8),
                                                 (2, 1, 4)])
def test_kernel_gradient_matches_autograd(seed, n_blocks, knots):
    _, tf = _flows(seed, n_blocks=n_blocks, knots=knots)
    target = NealsFunnel(dim=D)
    model = nuts_cuda.pack_flow(tf, target)
    z = torch.from_numpy(_z(seed, n=64))
    lp_a, g_a = nuts_cuda.autograd_logp_grad(tf, target.log_density)(z)
    lp_k, g_k = kernel_chain_logp_grad(model)(z)
    torch.testing.assert_close(lp_k, lp_a, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(g_k, g_a, rtol=1e-4, atol=1e-4)


def _jax_keys_randomness(keys, d, depth, inv_mass):
    """The randomness `make_fused_nuts_transition` derives from its keys."""
    def derive(k):
        k_mom, k_dir, k_acc, k_take = jax.random.split(k, 4)
        p0 = jax.random.normal(k_mom, (d,), jnp.float32) / jnp.sqrt(inv_mass)
        dirs = jnp.where(jax.random.bernoulli(k_dir, shape=(depth,)),
                         1.0, -1.0).astype(jnp.float32)
        ua = jax.random.uniform(k_acc, (depth,), jnp.float32)
        ut = jax.random.uniform(k_take, (1 << depth,), jnp.float32)
        return p0, dirs, ua, ut

    return [np.array(a) for a in jax.vmap(derive)(keys)]


@pytest.mark.parametrize("seed,eps", [(0, 0.3), (1, 0.15)])
def test_transition_matches_jax_fused_interpret(seed, eps):
    jf, tf = _flows(seed)
    n = 32
    q = _z(seed, n=n)
    im = np.linspace(0.6, 1.4, D).astype(np.float32)
    keys = jax.random.split(jax.random.key(10 + seed), n)
    trans = j_fused(JFunnel(dim=D).log_density, jf, max_depth=DEPTH,
                    tile_b=32, interpret=True)
    jq, info = jit_optimized(trans)(keys, jnp.asarray(q), jnp.asarray(eps),
                                    jnp.asarray(im))
    rnd = _jax_keys_randomness(keys, D, DEPTH, jnp.asarray(im))
    model = nuts_cuda.pack_flow(tf, NealsFunnel(dim=D))
    tq, lp, acc, steps, depth, div, turn, h0 = nuts_cuda.nuts_transition(
        torch.from_numpy(q), *(torch.from_numpy(a) for a in rnd),
        torch.tensor(eps), torch.from_numpy(im), model, DEPTH)
    flips = ((steps.numpy() != np.asarray(info.num_steps))
             | (depth.numpy() != np.asarray(info.tree_depth))
             | ((div.numpy() > 0.5) != np.asarray(info.diverging))
             | ((turn.numpy() > 0.5) != np.asarray(info.turning)))
    assert flips.sum() <= 1, f"knife-edge chains {np.nonzero(flips)[0]}"
    ok = ~flips
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tq.numpy()[ok], np.asarray(jq)[ok], **tol)
    np.testing.assert_allclose(lp.numpy()[ok], np.asarray(info.logp)[ok],
                               **tol)
    np.testing.assert_allclose(h0.numpy(), np.asarray(info.energy), **tol)
    assert len(np.unique(np.asarray(info.tree_depth))) >= 2


def test_cpu_spline_transition_runs_plain_version_and_counts_no_launch():
    _, tf = _flows(5)
    before = (nuts_cuda.LAUNCHES, dict(rqs_cuda.LAUNCHES))
    trans = nuts_cuda.fused_nuts_for_flow(NealsFunnel(dim=D), tf,
                                          max_depth=DEPTH)
    assert trans.model.flow_p is not None
    g = torch.Generator().manual_seed(0)
    q = torch.randn(16, D, generator=g)
    q_new, info = trans(g, q, torch.tensor(0.3), torch.ones(D))
    assert (nuts_cuda.LAUNCHES, rqs_cuda.LAUNCHES) == before
    assert torch.isfinite(q_new).all() and (info.num_steps >= 1).all()


def test_spread_script_runs_on_a_saved_state(tmp_path):
    """`chip_smoke.save_generic_state` and this file's script, at d = 8:
    the same flow and state give the JAX package's transition to the bar
    of tests/test_torch_nuts.py."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from tpuflows_torch.mcmc import NUTSState

    _, tf = _flows(6)
    state = NUTSState(q=torch.from_numpy(_z(6, n=48)),
                      step_size=torch.tensor(0.25),
                      inv_mass=torch.linspace(0.7, 1.3, D))
    chip_smoke.save_generic_state(tmp_path / "state.pt", tf, state,
                                  max_depth=DEPTH)
    res = spread_at_saved_state(tmp_path / "state.pt")
    assert res["chains"] == 48 and res["flips"] <= 1
    assert res["max_dq"] <= 1e-4 and res["max_denergy"] <= 1e-4


def _jax_flow_of(specs):
    """The JAX Chain of `flow_from_jax_modules`-style dicts."""
    from tpuflows.flows.affine import AffineCoupling as JA
    from tpuflows.flows.affine import Standardize as JS
    from tpuflows.flows.core import Chain as JC
    from tpuflows.flows.coupling import RQSCouplingBlock as JR
    from tpuflows.flows.nets import MLP as JM

    mods = []
    for s in specs:
        if s["kind"] == "standardize":
            mods.append(JS(loc=jnp.asarray(s["loc"]),
                           log_scale=jnp.asarray(s["log_scale"])))
            continue
        net = JM(weights=tuple(jnp.asarray(w) for w in s["weights"]),
                 biases=tuple(jnp.asarray(b) for b in s["biases"]))
        mods.append(JA(mask=tuple(s["mask"]), net=net, clamp=s["clamp"])
                    if s["kind"] == "affine" else
                    JR(mask=tuple(s["mask"]), net=net, knots=s["knots"],
                       range_limit=s["range_limit"], use_pallas=False))
    return JC(transforms=tuple(mods))


def _chip_smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke


def plain_vs_jax(specs, q, eps, im, rnd, depth):
    """`chip_smoke.compare` of the JAX package's transition
    (`_transition_math` with `tile_logp_and_grad_streamed`, as its
    `fused_nuts_for_flow` off the TPU) and the port's plain version, on
    the flow of `specs` and the given inputs."""
    from tpuflows_torch.convert import flow_from_jax_modules

    jf = j_permute(_jax_flow_of(specs))
    tf = flow_from_jax_modules(specs, device="cpu")
    d = q.shape[1]
    model = nuts_cuda.pack_flow(tf, NealsFunnel(dim=d))
    plain = nuts_cuda.transition_math_torch(
        q, *rnd, eps, im, nuts_cuda.plain_logp_grad(model), depth)
    target = JFunnel(dim=d)
    out = jax.jit(lambda *a: _transition_math(
        *a, lambda z: j_streamed(jf, z, target.log_density), depth,
        nuts_cuda.MAX_DELTA_ENERGY))(
        *(jnp.asarray(t.numpy()) for t in (q, *rnd)),
        jnp.asarray(float(eps), jnp.float32),
        jnp.asarray(im.numpy()).reshape(1, -1))
    out = [np.array(o) for o in out]
    ref = tuple(torch.from_numpy(o if o.shape[1] > 1 else o[:, 0])
                for o in out)
    return _chip_smoke().compare(ref, plain)


def spread_at_saved_state(path):
    """`plain_vs_jax` at a state saved by `chip_smoke.py
    --save-generic-state`, on the randomness chip_smoke drew for it on the
    CPU."""
    from tpuflows_torch.mcmc import NUTSState

    saved = torch.load(path, weights_only=False)
    state = NUTSState(q=torch.from_numpy(saved["q"]),
                      step_size=torch.tensor(saved["step_size"]),
                      inv_mass=torch.from_numpy(saved["inv_mass"]))
    depth = saved["max_depth"]
    q, eps, im, *rnd = _chip_smoke().state_inputs(
        state, seed=saved["seed"], cpu_randomness=True, depth=depth)
    return plain_vs_jax(saved["modules"], q, eps, im, rnd, depth)


def spread_at_smoke_rows():
    """`plain_vs_jax` at every spline row of `chip_smoke.py`'s
    kernel_vs_plain_spline phase: the same flows and inputs."""
    cs = _chip_smoke()
    rows = []
    for d, hidden, K, nb, depth, eps, n, unit, head in [
            *cs.SPLINE_SHAPES, cs.SPLINE_CHAOS_SHAPE]:
        flow = cs.spline_flow_with_random_heads("cpu", 10 + d, dim=d,
                                                hidden=hidden, knots=K,
                                                n_blocks=nb, head=head)
        q, im, *rnd = cs.spline_inputs("cpu", n, d, depth, 20 + d, unit)
        specs = cs.flow_specs(flow)
        rows.append({"d": d, "knots": K, "head_scale": head,
                     **plain_vs_jax(specs, q, torch.tensor(eps), im, rnd,
                                    depth)})
    return rows


def _specs_of(flow):
    import tempfile

    from tpuflows_torch.mcmc import NUTSState

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "flow.pt"
        d = flow.transforms[0].loc.numel()
        _chip_smoke().save_generic_state(
            path, flow, NUTSState(torch.zeros(1, d), torch.tensor(0.0),
                                  torch.ones(d)))
        return torch.load(path, weights_only=False)["modules"]


if __name__ == "__main__":
    import json

    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1] == "rows":
        print(json.dumps({"plain_vs_jax_at_smoke_rows":
                          spread_at_smoke_rows()}))
    else:
        print(json.dumps({"plain_vs_jax_at_saved_state":
                          spread_at_saved_state(sys.argv[1])}))
