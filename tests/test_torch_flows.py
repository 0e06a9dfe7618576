"""The port's affine flow against the JAX package's, on the same numpy
leaves carried across with `tpuflows_torch.convert`: forward, inverse and
both ladjs to 1e-5, and the gradient of log p(f^-1(z)) + ladj against
jax.grad to 1e-5 (float32; relative and absolute).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows.flows import build_flow as j_build_flow
from tpuflows.flows.affine import AffineCoupling as JAffine
from tpuflows.flows.affine import Standardize as JStandardize
from tpuflows.flows.core import Chain as JChain
from tpuflows.flows.nets import MLP as JMLP
from tpuflows.targets import NealsFunnel as JFunnel
from tpuflows.util.shapes import mask_array as j_mask_array

from tpuflows_torch.convert import flow_from_jax_params
from tpuflows_torch.flows import (AffineCoupling, Chain, Inverted, MLP,
                                  Standardize, build_flow, inverse,
                                  with_logabsdet_jacobian)
from tpuflows_torch.mcmc import flow_reparameterized, to_data_space
from tpuflows_torch.targets import NealsFunnel
from tpuflows_torch.util.shapes import leading_mask, mask_array

from test_torch_coupling import carry as carry_modules

TOL = dict(rtol=1e-5, atol=1e-5)
D, HIDDEN = 8, (16, 16)


def jax_flow(seed, d=D, hidden=HIDDEN, mask=None, clamp=8.0):
    """A JAX flow with numpy-drawn leaves and a non-zero last layer
    (`MLP.init` zero-inits it, which would hide every error in the MLP)."""
    rng = np.random.default_rng(seed)
    sizes = (d, *hidden, 2 * d)
    ws = [0.5 * rng.normal(0.0, np.sqrt(2.0 / a), (a, b))
          for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [rng.normal(0.0, 0.1, (b,)) for b in sizes[1:]]
    if mask is None:
        mask = leading_mask(d)
    f32 = jnp.float32
    net = JMLP(weights=tuple(jnp.asarray(w, f32) for w in ws),
               biases=tuple(jnp.asarray(b, f32) for b in bs))
    std = JStandardize(loc=jnp.asarray(rng.normal(0, 0.3, d), f32),
                       log_scale=jnp.asarray(rng.normal(0, 0.2, d), f32))
    return JChain(transforms=(std, JAffine(mask=tuple(mask), net=net,
                                           clamp=clamp)))


def carry(jf):
    std, cp = jf.transforms
    return flow_from_jax_params(
        np.asarray(std.loc), np.asarray(std.log_scale),
        [np.asarray(w) for w in cp.net.weights],
        [np.asarray(b) for b in cp.net.biases], cp.mask, cp.clamp,
        device="cpu")


def _z(seed, n=64, d=D):
    return np.random.default_rng(100 + seed).normal(size=(n, d)).astype(
        np.float32)


MASKS = {"leading": None, "complement": tuple(1 - m for m in leading_mask(D)),
         "checker": tuple(j % 2 for j in range(D))}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_flow_matches_jax(seed, mask):
    jf = jax_flow(seed, mask=MASKS[mask])
    tf = carry(jf)
    z = _z(seed)
    jx, jl = jf.inverse_and_ladj(jnp.asarray(z))
    tx, tl = tf.inverse_and_ladj(torch.from_numpy(z))
    np.testing.assert_allclose(tx.detach().numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
    x = np.array(jx)
    jz, jfl = jf.forward_and_ladj(jnp.asarray(x))
    tz, tfl = tf.forward_and_ladj(torch.from_numpy(x))
    np.testing.assert_allclose(tz.detach().numpy(), np.asarray(jz), **TOL)
    np.testing.assert_allclose(tfl.detach().numpy(), np.asarray(jfl), **TOL)
    # and the round trip closes, with opposite ladjs
    np.testing.assert_allclose(tz.detach().numpy(), z, **TOL)
    np.testing.assert_allclose(tfl.detach().numpy(), -tl.detach().numpy(),
                               **TOL)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_latent_logp_gradient_matches_jax(seed):
    jf = jax_flow(seed)
    tf = carry(jf)
    jt, tt = JFunnel(dim=D), NealsFunnel(dim=D)
    z = _z(seed)

    def j_lp(zz):
        x, ladj = jf.inverse_and_ladj(zz)
        return jt.log_density(x) + ladj

    want_lp = np.asarray(j_lp(jnp.asarray(z)))
    want_g = np.asarray(jax.grad(lambda zz: jnp.sum(j_lp(zz)))(
        jnp.asarray(z)))
    zt = torch.from_numpy(z).requires_grad_(True)
    lp = flow_reparameterized(tt.log_density, tf)(zt)
    (g,) = torch.autograd.grad(lp.sum(), zt)
    np.testing.assert_allclose(lp.detach().numpy(), want_lp, **TOL)
    np.testing.assert_allclose(g.numpy(), want_g, **TOL)


@pytest.mark.parametrize("activation", ["silu", "tanh", "relu"])
def test_mlp_matches_jax(activation):
    jf = jax_flow(5)
    jnet = jf.transforms[1].net
    jnet = JMLP(weights=jnet.weights, biases=jnet.biases,
                activation=activation)
    tnet = MLP([torch.tensor(np.asarray(w)) for w in jnet.weights],
               [torch.tensor(np.asarray(b)) for b in jnet.biases],
               activation=activation)
    x = _z(5, d=D)
    np.testing.assert_allclose(tnet(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jnet(jnp.asarray(x))), **TOL)


def test_carried_flow_defaults_to_the_card_with_tf32_off():
    """`flow_from_jax_params` is an entry point: it builds on "cuda" unless
    told otherwise (no quiet CPU run), and switches TF32 off."""
    std, cp = jax_flow(0).transforms
    leaves = (np.asarray(std.loc), np.asarray(std.log_scale),
              [np.asarray(w) for w in cp.net.weights],
              [np.asarray(b) for b in cp.net.biases], cp.mask, cp.clamp)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    tf = flow_from_jax_params(*leaves, device="cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert all(p.device.type == "cpu" for p in tf.parameters())
    if torch.cuda.is_available():
        tf = flow_from_jax_params(*leaves)
        assert all(p.device.type == "cuda" for p in tf.parameters())
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            flow_from_jax_params(*leaves)


def test_standardize_from_samples_matches_jax():
    x = (3.0 * _z(9, n=512) + 1.0).astype(np.float32)
    js = JStandardize.from_samples(jnp.asarray(x))
    ts = Standardize.from_samples(torch.from_numpy(x))
    np.testing.assert_allclose(ts.loc.detach().numpy(), np.asarray(js.loc),
                               **TOL)
    np.testing.assert_allclose(ts.log_scale.detach().numpy(),
                               np.asarray(js.log_scale), **TOL)


@pytest.mark.parametrize("n_leading", [1, 3])
def test_build_flow_matches_jax_structure(n_leading):
    x = _z(4, n=256)
    g = torch.Generator().manual_seed(0)
    tf = build_flow(torch.from_numpy(x), g, kind="affine", n_blocks=2,
                    hidden=HIDDEN, mask_scheme="leading", clamp=8.0,
                    n_leading=n_leading, device="cpu")
    jf = j_build_flow(jnp.asarray(x), jax.random.key(0), kind="affine",
                      n_blocks=2, hidden=HIDDEN, mask_scheme="leading",
                      clamp=8.0, n_leading=n_leading)
    assert len(tf) == len(jf.transforms) == 3
    for tb, jb in zip(tf.transforms[1:], jf.transforms[1:]):
        assert tb.mask == jb.mask and tb.clamp == jb.clamp
        assert [tuple(w.shape) for w in tb.net.weights] == [
            tuple(w.shape) for w in jb.net.weights]
        # fresh couplings start at the identity: zero last layer
        assert float(tb.net.weights[-1].detach().abs().max()) == 0.0
    np.testing.assert_allclose(tf.transforms[0].loc.detach().numpy(),
                               np.asarray(jf.transforms[0].loc), **TOL)
    # identity at init: the flow is the standardization alone
    z = torch.from_numpy(_z(5))
    with torch.no_grad():
        x_t, _ = tf.inverse_and_ladj(z)
    np.testing.assert_allclose(
        x_t.numpy(), np.asarray(jf.inverse(jnp.asarray(z.numpy()))), **TOL)


@pytest.mark.parametrize("kind,scheme,use_pallas", [
    ("rqs", "leading", "auto"), ("arqs", "leading", "auto"),
    ("affine", "alternating", "auto"), ("affine", "mixed", "auto"),
    ("rqs", "alternating", "fused")],
    ids=["rqs-leading", "arqs-leading", "affine-alternating", "affine-mixed",
         "rqs-fused"])
def test_build_flow_refuses_what_waits(kind, scheme, use_pallas):
    """The (kind, mask scheme) pairs that waited for the spline slice now
    build, with the JAX package's structure (module kinds, masks, widths,
    zero last layers) and, after carrying the JAX flow's leaves across,
    its values (1e-5). The fused block tier (K6/K7), which waited too, now
    builds and runs: its flow is carried across on that tier and held to
    the JAX package's spline bar (atol 1e-4)."""
    x = _z(4, n=256)
    g = torch.Generator().manual_seed(0)
    kw = dict(kind=kind, n_blocks=3, knots=4, hidden=HIDDEN,
              mask_scheme=scheme, clamp=8.0)
    tf = build_flow(torch.from_numpy(x), g, use_pallas=use_pallas,
                    device="cpu", **kw)
    if use_pallas == "fused":
        assert all(t.use_pallas == "fused" for t in tf.transforms[1:])
    jf = j_build_flow(jnp.asarray(x), jax.random.key(0), use_pallas=False,
                      **kw)
    assert [type(t).__name__ for t in tf.transforms] == [
        type(t).__name__ for t in jf.transforms]
    for tb, jb in zip(tf.transforms[1:], jf.transforms[1:]):
        assert tb.mask == jb.mask
        assert [tuple(w.shape) for w in tb.net.weights] == [
            tuple(w.shape) for w in jb.net.weights]
        assert float(tb.net.weights[-1].detach().abs().max()) == 0.0
    # values: the JAX flow with random last layers, carried across
    rng = np.random.default_rng(1)
    jt = list(jf.transforms)
    for i, t in enumerate(jt[1:], 1):
        ws = list(t.net.weights)
        ws[-1] = jnp.asarray(0.1 * rng.normal(size=ws[-1].shape), jnp.float32)
        jt[i] = type(t)(**{**t.__dict__, "net": type(t.net)(
            weights=tuple(ws), biases=t.net.biases)})
    jf = JChain(transforms=tuple(jt))
    fused = use_pallas == "fused"
    tf = carry_modules(jf, use_pallas="fused" if fused else False)
    z = _z(6)
    jx, jl = jf.inverse_and_ladj(jnp.asarray(z))
    with torch.no_grad():
        tx, tl = tf.inverse_and_ladj(torch.from_numpy(z))
    tol = dict(rtol=1e-5, atol=1e-4) if fused else TOL
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **tol)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)


def test_build_flow_takes_a_module_list():
    """`modules=`: ready bijectors are used as they are, callables are
    called with (samples, generator), and nothing else is built."""
    x = torch.from_numpy(_z(8, n=128))
    ready = AffineCoupling.init(leading_mask(D), torch.Generator(),
                                hidden=HIDDEN)
    seen = []

    def fitted(samples, generator):
        seen.append((samples.shape, generator))
        return Standardize.from_samples(samples)

    g = torch.Generator().manual_seed(0)
    tf = build_flow(x, g, modules=[fitted, ready], device="cpu")
    assert len(tf) == 2 and tf.transforms[1] is ready
    assert seen == [((128, D), g)]
    torch.testing.assert_close(tf.transforms[0].loc.detach(), x.mean(0))


def test_mask_helpers_match_jax():
    for mask in MASKS.values():
        mask = mask or leading_mask(D)
        np.testing.assert_array_equal(mask_array(mask).numpy(),
                                      np.asarray(j_mask_array(mask)))


@pytest.mark.parametrize("dim", [1, 4, 7, 64])
@pytest.mark.parametrize("parity", [0, 1, 2])
def test_alternating_and_block_masks_match_jax(dim, parity):
    from tpuflows.util.shapes import alternating_mask as j_alt
    from tpuflows.util.shapes import block_mask as j_block

    from tpuflows_torch.util.shapes import alternating_mask, block_mask

    assert alternating_mask(dim, parity) == j_alt(dim, parity)
    assert block_mask(dim, parity) == j_block(dim, parity)


def test_inverse_and_chain_order():
    jf = jax_flow(6)
    tf = carry(jf)
    z = torch.from_numpy(_z(6))
    inv = inverse(tf)
    assert isinstance(inv, Inverted) and inverse(inv) is tf
    with torch.no_grad():
        x, l_inv = tf.inverse_and_ladj(z)
        x2, l2 = inv.forward_and_ladj(z)
        z2, l_fwd = with_logabsdet_jacobian(tf, x)
        # Chain.inverse_and_ladj runs the transforms in reverse order
        y, l_c = tf.transforms[1].inverse_and_ladj(z)
        x3, l_s = tf.transforms[0].inverse_and_ladj(y)
    torch.testing.assert_close(x2, x)
    torch.testing.assert_close(l2, l_inv)
    torch.testing.assert_close(x3, x)
    torch.testing.assert_close(l_c + l_s, l_inv)
    torch.testing.assert_close(z2, z, **TOL)
    torch.testing.assert_close(l_fwd, -l_inv, **TOL)
    torch.testing.assert_close(tf(x), z2)
    np.testing.assert_allclose(
        to_data_space(tf, z[None]).numpy()[0],
        np.asarray(jf.inverse(jnp.asarray(z.numpy()))), **TOL)


def test_chain_of_several_couplings_matches_jax():
    """Chains longer than the bench's: two couplings with complementary
    masks, composed in both packages."""
    j1, j2 = jax_flow(7), jax_flow(8, mask=MASKS["complement"])
    jf = JChain(transforms=(*j1.transforms, j2.transforms[1]))
    t1, t2 = carry(j1), carry(j2)
    tf = Chain([*t1.transforms, t2.transforms[1]])
    z = _z(7)
    jx, jl = jf.inverse_and_ladj(jnp.asarray(z))
    with torch.no_grad():
        tx, tl = tf.inverse_and_ladj(torch.from_numpy(z))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert isinstance(tf.transforms[2], AffineCoupling)
