"""K1, K2 and K3 over every conditioner and module the JAX package's
in-kernel flow math takes, and K6/K7's bf16 rounding: the plain versions
against the JAX package, on the CPU.

The forms (`FORMS`): a leading-mask affine coupling (Standardize before
it) with a tanh, relu or gelu conditioner, with bf16 operands (silu and
gelu), of 2 and 4 layers; Whiten before that coupling and before two rqs
blocks; two rqs blocks of 4-layer gelu conditioners. Hidden width 32,
64 chains, depth 4, over the funnel at d = 8 and at d = 20 (a padded
width: the kernels pad it to 32 lanes), every leaf from numpy.

  * (a) K1's plain version (`nuts_cuda.nuts_transition` on CPU tensors)
    against `fused_nuts_for_flow(..., interpret=False)` on the randomness
    the JAX transition derives from its keys: the bar of
    tests/test_torch_nuts_targets.py (at most one knife-edge chain; 1e-4
    on q, logp and energy);
  * (b) K2's plain version against the JAX window at d = 20
    (tests/test_torch_nuts_window.py's bar, at most one knife-edge
    chain), and K3's against `fused_latent_logp_and_grad(...,
    interpret=True)` at d = 8 and 20 (rtol 1e-5, atol 1e-4; bf16 forms
    rtol 1e-4, atol 1e-3: a layer input that sits on a bf16 rounding edge
    rounds apart after sums in another order);
  * (c) the padding: the plain transition at the lane width, on the flow
    padded as `pack_flow` pads it, equals the one at the true width (no
    flip; rtol 1e-5, atol 1e-4) for every form, and the pads stay 0;
  * (d) `tile_flow` with a Whiten against the JAX package's
    `tile_inverse_and_ladj` and `tile_logp_and_grad_streamed` (rtol 1e-5,
    atol 1e-5 of the largest value);
  * (e) the bf16 rounding rule on one layer, written as the kernels
    compute it (weights packed rounded, the input rounded, the product
    summed in float32, the input's cotangent and the weight's rounded
    once after their sums, the cotangent g itself not rounded), against
    `jax.vjp` of `nets.MLP`: equal to the bit, on values whose float32
    sums are exact in any order; rounding g as well, or not rounding the
    cotangent, differs;
  * (f) the plain K6/K7 block's bf16 weight cotangents against the JAX
    block op's pullback (`coupling_pallas._fwd_block_op`, interpret
    mode): on one 128-row grid step they agree within float32's sum
    order (rtol 1e-5, atol 1e-5 of the largest value, bar a few elements
    on a bf16 rounding edge, each one bf16 step away); on 4 steps the JAX
    kernel rounds each step's sum and adds the four in float32, the plain
    version rounds the whole batch's sum once: they part by at most 4
    half-steps of bf16 at the steps' largest partial sum (stated gap),
    and do part.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows.flows.affine import AffineCoupling as JAffine
from tpuflows.flows.affine import Standardize as JStandardize
from tpuflows.flows.affine import Whiten as JWhiten
from tpuflows.flows.core import Chain as JChain
from tpuflows.flows.coupling import RQSCouplingBlock as JRQS
from tpuflows.flows.nets import MLP as JMLP
from tpuflows.kernels import coupling_pallas
from tpuflows.kernels import tile_flow as j_tile_flow
from tpuflows.kernels.fused_logp import (
    fused_latent_logp_and_grad as j_fused_logp)
from tpuflows.kernels.nuts_pallas import fused_nuts_for_flow as j_fused
from tpuflows.kernels.nuts_pallas import (
    fused_nuts_window_for_flow as j_window)

from tpuflows_torch.convert import flow_from_jax_modules
from tpuflows_torch.flows.rqs_ref import DEFAULT_MIN_BIN, DEFAULT_MIN_DERIV
from tpuflows_torch.kernels import coupling_cuda, fused_logp_cuda, nuts_cuda
from tpuflows_torch.kernels import nuts_window_cuda as nw
from tpuflows_torch.kernels import tile_flow
from tpuflows_torch.util.shapes import alternating_mask, leading_mask

from test_torch_nuts import compare
from test_torch_nuts_spline import _jax_keys_randomness
from test_torch_nuts_targets import optimized, padded_model, targets
from test_torch_nuts_window import TOL_JAX, assert_window_close
from test_torch_nuts_window import jax_window_draws

DEPTH = 4
N = 64
HIDDEN = 32
EPS = 0.15
BAR = dict(rtol=1e-4, atol=1e-4)
# (flow kind, activation, compute_dtype, hidden widths, Whiten first)
FORMS = {
    "tanh": ("affine", "tanh", "f32", (HIDDEN, HIDDEN), False),
    "relu": ("affine", "relu", "f32", (HIDDEN, HIDDEN), False),
    "gelu": ("affine", "gelu", "f32", (HIDDEN, HIDDEN), False),
    "bf16_silu": ("affine", "silu", "bf16", (HIDDEN, HIDDEN), False),
    "bf16_gelu": ("affine", "gelu", "bf16", (HIDDEN, HIDDEN), False),
    "layers2": ("affine", "silu", "f32", (HIDDEN,), False),
    "layers4": ("affine", "silu", "f32", (HIDDEN,) * 3, False),
    "whiten_affine": ("affine", "silu", "f32", (HIDDEN, HIDDEN), True),
    "whiten_rqs": ("rqs", "silu", "f32", (HIDDEN, HIDDEN), True),
    "rqs_gelu_layers4": ("rqs", "gelu", "f32", (HIDDEN,) * 3, False),
}
KNOTS = 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Thousands of small ops: one intra-op thread keeps parallel test
    workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mlp(rng, sizes, scale, activation, compute_dtype):
    f32 = jnp.float32
    ws = [rng.normal(0.0, np.sqrt(2.0 / a), (a, b))
          for a, b in zip(sizes[:-1], sizes[1:])]
    ws[-1] = scale * ws[-1]
    bs = [rng.normal(0.0, 0.05, b) for b in sizes[1:]]
    return JMLP(weights=tuple(jnp.asarray(w, f32) for w in ws),
                biases=tuple(jnp.asarray(b, f32) for b in bs),
                activation=activation, compute_dtype=compute_dtype)


def jax_flow(form, d, seed=0):
    """The JAX flow of `form` at width d, every leaf from numpy: a
    Standardize, or a Whiten fitted from correlated Gaussian draws, then
    a leading-mask affine coupling or 2 rqs blocks on alternating masks."""
    kind, act, dtype, hidden, whiten = FORMS[form]
    rng = np.random.default_rng(seed)
    f32 = jnp.float32
    if whiten:
        a = np.eye(d) + 0.3 * rng.normal(size=(d, d)) / np.sqrt(d)
        draws = rng.normal(size=(512, d)) @ a.T * 0.8 + 0.2
        mods = [JWhiten.from_samples(jnp.asarray(draws, f32))]
    else:
        mods = [JStandardize(loc=jnp.asarray(rng.normal(0, 0.2, d), f32),
                             log_scale=jnp.asarray(rng.normal(0, 0.1, d),
                                                   f32))]
    if kind == "affine":
        mods.append(JAffine(mask=leading_mask(d, max(1, d // 4)),
                            net=_mlp(rng, (d, *hidden, 2 * d), 0.1, act,
                                     dtype),
                            clamp=8.0))
    else:
        for i in range(2):
            mods.append(JRQS(mask=alternating_mask(d, i % 2),
                             net=_mlp(rng, (d, *hidden,
                                            d * (3 * KNOTS - 1)), 0.1, act,
                                      dtype),
                             knots=KNOTS, use_pallas=False))
    return JChain(transforms=tuple(mods))


def port_flow(jf):
    """The port's flow with the JAX flow's leaves and static fields."""
    specs = []
    for t in jf.transforms:
        if isinstance(t, JStandardize):
            specs.append({"kind": "standardize", "loc": np.asarray(t.loc),
                          "log_scale": np.asarray(t.log_scale)})
            continue
        if isinstance(t, JWhiten):
            specs.append({"kind": "whiten", "loc": np.asarray(t.loc),
                          "inv_chol": np.asarray(t.inv_chol),
                          "chol": np.asarray(t.chol)})
            continue
        spec = {"mask": t.mask, "activation": t.net.activation,
                "compute_dtype": t.net.compute_dtype,
                "weights": [np.asarray(w) for w in t.net.weights],
                "biases": [np.asarray(b) for b in t.net.biases]}
        if isinstance(t, JAffine):
            spec.update(kind="affine", clamp=t.clamp)
        else:
            spec.update(kind="rqs", knots=t.knots,
                        range_limit=t.range_limit, use_pallas="auto")
        specs.append(spec)
    return flow_from_jax_modules(specs, device="cpu")


def start(d, seed=0):
    return np.random.default_rng(200 + seed).normal(
        size=(N, d)).astype(np.float32)


def _is_bf16(form):
    return FORMS[form][2] == "bf16"


@functools.lru_cache(maxsize=None)
def jax_transition(form, d):
    jt, _ = targets("funnel", d)
    trans = j_fused(jt.log_density, jax_flow(form, d), max_depth=DEPTH,
                    tile_b=N, interpret=False)
    return optimized(trans, jax.random.split(jax.random.key(0), N),
                     jnp.zeros((N, d)), jnp.asarray(0.1), jnp.ones(d))


# ---------------------------------------------------------------------------
# (a) K1
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("d", [8, 20])
def test_k1_plain_matches_jax_fused_math(d, form):
    _, tt = targets("funnel", d)
    model = nuts_cuda.pack_flow(port_flow(jax_flow(form, d)), tt)
    assert model.general
    q = start(d)
    im = np.linspace(0.7, 1.3, d).astype(np.float32)
    keys = jax.random.split(jax.random.key(50), N)
    jq, info = jax_transition(form, d)(keys, jnp.asarray(q),
                                       jnp.asarray(EPS), jnp.asarray(im))
    rnd = _jax_keys_randomness(keys, d, DEPTH, jnp.asarray(im))
    port = nuts_cuda.nuts_transition(
        torch.from_numpy(q), *(torch.from_numpy(a) for a in rnd),
        torch.tensor(EPS), torch.from_numpy(im), model, DEPTH)
    port = tuple(o.numpy() for o in port)
    ja = (np.asarray(jq), np.asarray(info.logp),
          np.asarray(info.accept_prob), np.asarray(info.num_steps),
          np.asarray(info.tree_depth),
          np.asarray(info.diverging).astype(np.float32),
          np.asarray(info.turning).astype(np.float32),
          np.asarray(info.energy))
    flips, ok = compare(port, ja)
    assert len(flips) <= 1, f"knife-edge chains {flips.tolist()}"
    np.testing.assert_allclose(port[0][ok], ja[0][ok], **BAR)
    np.testing.assert_allclose(port[1][ok], ja[1][ok], **BAR)
    np.testing.assert_allclose(port[7], ja[7], **BAR)
    assert np.isfinite(port[0]).all() and (port[3] >= 1).all()


# ---------------------------------------------------------------------------
# (b) K2 and K3
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("form", sorted(FORMS))
def test_k2_plain_matches_jax_window(form):
    d, S = 20, 2
    jt, tt = targets("funnel", d)
    jf = jax_flow(form, d)
    q = start(d, 1)
    im = np.linspace(0.8, 1.2, d).astype(np.float32)
    key = jax.random.key(3)
    win = j_window(jt.log_density, jf, window=S, max_depth=DEPTH, tile_b=N,
                   interpret=False)
    args = (key, jnp.asarray(q), jnp.asarray(EPS), jnp.asarray(im))
    draws, info = optimized(win, *args)(*args)
    ja = (np.asarray(draws), np.asarray(info.logp),
          np.asarray(info.accept_prob), np.asarray(info.num_steps),
          np.asarray(info.tree_depth),
          np.asarray(info.diverging).astype(np.float32),
          np.asarray(info.turning).astype(np.float32),
          np.asarray(info.energy))
    rnd = jax_window_draws(key, N, d, S, DEPTH, im)
    model = nuts_cuda.pack_flow(port_flow(jf), tt)
    port = nw.nuts_window(torch.from_numpy(q),
                          *(torch.from_numpy(a) for a in rnd),
                          torch.tensor(EPS), torch.from_numpy(im), model,
                          DEPTH, S)
    port = tuple(o.numpy() for o in port)
    assert port[0].shape == (S, N, d)
    assert_window_close(port, ja, TOL_JAX, max_flips=1)
    assert nw.LAUNCHES == 0


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("d", [8, 20])
def test_k3_plain_matches_jax_latent_logp(d, form):
    jt, tt = targets("funnel", d)
    jf = jax_flow(form, d)
    z = start(d, 2)[:24]
    jlp, jg = jax.vmap(j_fused_logp(jt.log_density, jf, tile_b=8,
                                    interpret=True))(jnp.asarray(z))
    hook = fused_logp_cuda.fused_latent_logp_and_grad(tt, port_flow(jf))
    lp, g = hook(torch.from_numpy(z))
    tol = (dict(rtol=1e-4, atol=1e-3) if _is_bf16(form)
           else dict(rtol=1e-5, atol=1e-4))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), **tol)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **tol)
    assert fused_logp_cuda.LAUNCHES == 0


# ---------------------------------------------------------------------------
# (c) the padding
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("form", sorted(FORMS))
def test_padded_transition_equals_the_true_width(form):
    d = 20
    _, tt = targets("funnel", d)
    model = nuts_cuda.pack_flow(port_flow(jax_flow(form, d)), tt)
    dp = model.d_pad
    assert dp == 32
    wide = padded_model(model)
    g = torch.Generator().manual_seed(4)
    q = torch.from_numpy(start(d, 3))
    im = 0.7 + 0.6 * torch.rand(d, generator=g)
    p0, dirs, ua, ut = nuts_cuda.draw_randomness(g, N, d, DEPTH, im)
    eps = torch.tensor(EPS)
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
    # the padded modules: a Whiten's identity pads, zero first-layer rows
    # and head columns at every depth
    for t in wide.flow.transforms:
        if hasattr(t, "chol"):
            torch.testing.assert_close(t.chol[d:, d:], torch.eye(dp - d))
            assert torch.all(t.chol[d:, :d] == 0)
            assert torch.all(t.chol[:d, d:] == 0)
            assert torch.all(t.loc[d:] == 0)
        elif hasattr(t, "net"):
            assert t.mask[d:] == (1,) * (dp - d)
            assert torch.all(t.net.weights[0][d:] == 0)
            last = t.net.weights[-1]
            if hasattr(t, "knots"):  # spline head: column i P + p
                assert torch.all(last.reshape(len(last), dp, -1)[:, d:] == 0)
            else:  # affine head: [shift, raw scale]
                assert torch.all(last.reshape(len(last), 2, dp)[..., d:]
                                 == 0)


def test_the_module_list_carries_each_form():
    """`pack_flow`'s module list and forms: the layers, activation code,
    flags (bf16; the general path, on every coupling of a flow not of the
    main paths' form) and hidden widths of each conditioner; a Whiten's
    constant ladj in its row's column 5; `general` set, the scratch rows
    sized for the deepest conditioner."""
    import struct

    d = 20
    _, tt = targets("funnel", d)
    for form, (kind, act, dtype, hidden, whiten) in FORMS.items():
        flow = port_flow(jax_flow(form, d))
        model = nuts_cuda.pack_flow(flow, tt)
        rows = model.forms.tolist()
        for t, row, mrow in zip(flow.transforms, rows, model.mods.tolist()):
            if hasattr(t, "net"):
                flags = nuts_cuda.FORM_GENERAL | (
                    nuts_cuda.FORM_BF16 if dtype == "bf16" else 0)
                assert row[:3] == [len(hidden) + 1,
                                   nuts_cuda.ACTIVATION_CODES[act], flags]
                assert row[3:3 + len(hidden)] == list(hidden)
                assert mrow[2:4] == [hidden[0], hidden[-1]]
            elif hasattr(t, "chol"):
                ladj = struct.unpack("<f", struct.pack("<i", mrow[5]))[0]
                want = torch.sum(torch.log(torch.diagonal(t.chol)))
                assert mrow[0] == 3 and ladj == float(want)
            else:
                assert row == [0] * nuts_cuda.FORM_INTS
        assert model.general and model.nhid == len(hidden)
        assert nuts_cuda.smem_bytes(model) == 4 * (
            (len(rows) + 1) * 32 + 2 * len(hidden) * HIDDEN + model.head)
        if whiten:
            assert model.head >= 32 and model.resident_floats == 0


# ---------------------------------------------------------------------------
# (d) tile_flow with a Whiten
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("form", ["whiten_rqs", "whiten_affine"])
def test_tile_flow_takes_whiten(form):
    d = 8
    jt, tt = targets("funnel", d)
    jf = jax_flow(form, d)
    tf = port_flow(jf)
    z = start(d, 4)[:16]
    jfp = j_tile_flow.permute_for_tiles(jf)
    tfp = tile_flow.permute_for_tiles(tf)
    jx, jl = j_tile_flow.tile_inverse_and_ladj(jfp, jnp.asarray(z))
    x, ladj = tile_flow.tile_inverse_and_ladj(tfp, torch.from_numpy(z))
    jlp, jg = j_tile_flow.tile_logp_and_grad_streamed(
        jfp, jnp.asarray(z), jt.log_density)
    lp, g = tile_flow.tile_logp_and_grad_streamed(
        tfp, torch.from_numpy(z), tt.log_density)
    for got, want in ((x, jx), (ladj, jl), (lp, jlp), (g, jg)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# (e) the bf16 rounding rule on one layer
# ---------------------------------------------------------------------------
def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def test_bf16_rounding_of_one_layer_as_the_kernels_compute_it():
    """Inputs in +-[1, 2), weights bf16 values in +-[1, 2), cotangents of
    12 significant bits: every float32 sum below is exact in any order,
    so the kernels' rule must give JAX's vjp to the bit."""
    rng = np.random.default_rng(7)
    T, n_in, n_out = 16, 16, 16

    def signed(x):
        return x * rng.choice([-1.0, 1.0], size=x.shape)

    x = signed(rng.uniform(1.0, 2.0, (T, n_in))).astype(np.float32)
    w = signed(1.0 + rng.integers(0, 128, (n_in, n_out)) / 128.0)
    w = w.astype(np.float32)
    b = rng.normal(0, 0.5, n_out).astype(np.float32)
    gy = signed(1.0 + rng.integers(0, 2048, (T, n_out)) / 2048.0)
    gy = gy.astype(np.float32)
    net = JMLP(weights=(jnp.asarray(w),), biases=(jnp.asarray(b),),
               compute_dtype="bf16")
    y, pull = jax.vjp(lambda xx, ww: JMLP(
        weights=(ww,), biases=(jnp.asarray(b),),
        compute_dtype="bf16")(xx), jnp.asarray(x), jnp.asarray(w))
    jgx, jgw = pull(jnp.asarray(gy))
    assert np.array_equal(np.asarray(net(jnp.asarray(x))), np.asarray(y))
    # the kernels: weights packed rounded, the input rounded, float32 sums
    w_r, x_r = _bf16(w), _bf16(x)
    assert not np.array_equal(x_r, x)  # the input rounding is real
    np.testing.assert_array_equal((x_r @ w_r + b).astype(np.float32),
                                  np.asarray(y))
    gx = _bf16(gy @ w_r.T)  # g unrounded, the product rounded once
    gw = _bf16(x_r.T @ gy)  # the weight's cotangent rounded once
    np.testing.assert_array_equal(gx, np.asarray(jgx))
    np.testing.assert_array_equal(gw, np.asarray(jgw))
    # the other rules part from it
    assert not np.array_equal(_bf16(_bf16(gy) @ w_r.T), np.asarray(jgx))
    assert not np.array_equal(gy @ w_r.T, np.asarray(jgx))
    # the port's MLP under autograd follows the same rule
    from tpuflows_torch.flows import MLP

    xt = torch.from_numpy(x).requires_grad_(True)
    mlp = MLP([torch.from_numpy(w)], [torch.from_numpy(b)],
              compute_dtype="bf16")
    out = mlp(xt)
    tgx, tgw = torch.autograd.grad(out, (xt, mlp.weights[0]),
                                   torch.from_numpy(gy))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(y))
    np.testing.assert_array_equal(tgx.numpy(), gx)
    np.testing.assert_array_equal(tgw.numpy(), gw)


# ---------------------------------------------------------------------------
# (f) K6/K7's bf16 weight cotangents against the JAX block op
# ---------------------------------------------------------------------------
def _block_case(n, seed=11, d=6, K=4):
    rng = np.random.default_rng(seed)
    sizes = (d, 32, d * (3 * K - 1))
    ws = [(rng.normal(0, np.sqrt(2.0 / a), (a, b)) * (0.3 if i else 1.0))
          .astype(np.float32) for i, (a, b) in enumerate(zip(sizes[:-1],
                                                            sizes[1:]))]
    bs = [rng.normal(0, 0.1, b).astype(np.float32) for b in sizes[1:]]
    from tpuflows_torch.flows import MLP

    net = MLP(ws, bs, activation="gelu", compute_dtype="bf16")
    params = coupling_cuda.flatten_params(net, d, K)
    mask = (1, 0) * (d // 2)
    x = (1.5 * rng.normal(size=(n, d))).astype(np.float32)
    gz = rng.normal(size=(n, d)).astype(np.float32)
    gl = rng.normal(size=n).astype(np.float32)
    return params, mask, x, gz, gl, d, K


def _both_pullbacks(n):
    params, mask, x, gz, gl, d, K = _block_case(n)
    m = torch.tensor(mask, dtype=torch.float32)
    _, dps = coupling_cuda.plain_block_vjp(
        torch.from_numpy(x), tuple(p.detach() for p in params), m,
        torch.from_numpy(gz), torch.from_numpy(gl), K, 4.0, "gelu", False,
        "bf16")
    jparams = tuple(jnp.asarray(p.detach().numpy()) for p in params)
    _, pull = jax.vjp(lambda ps: coupling_pallas._fwd_block_op(
        jnp.asarray(x), ps, mask, K, 4.0, DEFAULT_MIN_BIN,
        DEFAULT_MIN_DERIV, "gelu", "bf16"), jparams)
    (jdps,) = pull((jnp.asarray(gz), jnp.asarray(gl)[:, None]))
    return [p.numpy() for p in dps], [np.asarray(p) for p in jdps]


def test_plain_block_bf16_weight_cotangents_on_one_tile():
    dps, jdps = _both_pullbacks(coupling_pallas.TILE_B)
    for i, (a, b) in enumerate(zip(dps, jdps)):
        a, b = a.reshape(b.shape), b
        scale = float(np.abs(b).max())
        apart = ~np.isclose(a, b, rtol=1e-5, atol=1e-5 * scale)
        if i % 2 == 0:  # a weight: a few elements on a bf16 rounding edge
            step = np.abs(b) * 2.0 ** -7 + 1e-30
            assert apart.mean() <= 0.02
            assert np.all(np.abs(a - b)[apart] <= 1.01 * step[apart])
        else:  # a bias: float32, not rounded
            assert not apart.any()


def test_plain_block_bf16_weight_cotangents_over_several_tiles():
    """The stated gap: 4 grid steps of 128 rows, each step's weight
    cotangent rounded to bf16 in the JAX kernel and summed in float32,
    against one rounding of the whole sum."""
    steps = 4
    n = steps * coupling_pallas.TILE_B
    dps, jdps = _both_pullbacks(n)
    params, mask, x, gz, gl, d, K = _block_case(n)
    # each step's partial sums, for the bound
    m = torch.tensor(mask, dtype=torch.float32)
    parts = []
    for s in range(steps):
        rows = slice(s * coupling_pallas.TILE_B,
                     (s + 1) * coupling_pallas.TILE_B)
        _, p = coupling_cuda.plain_block_vjp(
            torch.from_numpy(x[rows]), tuple(q.detach() for q in params),
            m, torch.from_numpy(gz[rows]), torch.from_numpy(gl[rows]), K,
            4.0, "gelu", False, "bf16")
        parts.append([t.numpy() for t in p])
    parted = False
    for i in range(0, len(dps), 2):  # the weights
        a, b = dps[i].reshape(jdps[i].shape), jdps[i]
        biggest = max(float(np.abs(p[i]).max()) for p in parts)
        whole = float(np.abs(b).max())
        bound = steps * 2.0 ** -8 * biggest + 2.0 ** -8 * whole
        assert float(np.abs(a - b).max()) <= bound
        parted |= not np.array_equal(a, b)
    assert parted
