"""The rest of the flow core of the port against the JAX package, on the
same numpy inputs carried across with `tpuflows_torch.convert`:

  * `util/shapes.py`: `flatview`, `nestedview`, `num_batches_split` and
    `VariateShape`, whose flat layout must equal the JAX package's (a
    dict's keys in sorted order) on trees with unsorted keys;
  * `Identity`, `ScannedRepeat` (stacked leaves, run as a loop), `Whiten`
    (`from_samples` and its ladj), the gelu MLP (jax.nn.gelu is the tanh
    form) and the bf16 MLP: forward, inverse and ladj, and the gradient of
    a scalar of them with respect to every leaf, to rtol 1e-5 / atol 1e-5.
    The bf16 MLP rounds its operands as the JAX package's does but sums in
    another order, so its output is held to 1e-3 against the JAX bf16 MLP
    (and must differ from the float32 MLP by more than that bar's tenth).
    Its gradient rounds the cotangents to bf16 on both sides, and a
    cotangent one float32 ulp apart can round to the next bf16 value, so
    the gradient is held to 2^-7 (one bf16 ulp at 1) of its largest
    element.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows.flows.affine import AffineCoupling as JAffine
from tpuflows.flows.affine import Standardize as JStandardize
from tpuflows.flows.affine import Whiten as JWhiten
from tpuflows.flows.core import Chain as JChain
from tpuflows.flows.core import Identity as JIdentity
from tpuflows.flows.core import ScannedRepeat as JScanned
from tpuflows.flows.coupling import RQSCouplingBlock as JRQS
from tpuflows.flows.nets import MLP as JMLP
from tpuflows.util import shapes as jshapes

from tpuflows_torch.convert import flow_from_jax_modules
from tpuflows_torch.flows import Chain, Identity, MLP, ScannedRepeat, Whiten
from tpuflows_torch.util import shapes

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=1e-3, atol=1e-3)
D = 6


# ---------------------------------------------------------------------------
# carrying JAX modules across
# ---------------------------------------------------------------------------
def _np(a):
    return np.asarray(a)


def mlp_spec(net):
    return {"weights": [_np(w) for w in net.weights],
            "biases": [_np(b) for b in net.biases],
            "activation": net.activation,
            "compute_dtype": net.compute_dtype}


def spec_of(t):
    """The converter's dict of one JAX module (stacked leaves included)."""
    if isinstance(t, JStandardize):
        return {"kind": "standardize", "loc": _np(t.loc),
                "log_scale": _np(t.log_scale)}
    if isinstance(t, JWhiten):
        return {"kind": "whiten", "loc": _np(t.loc),
                "inv_chol": _np(t.inv_chol), "chol": _np(t.chol)}
    if isinstance(t, JIdentity):
        return {"kind": "identity"}
    if isinstance(t, JAffine):
        return {"kind": "affine", "mask": t.mask, "clamp": t.clamp,
                **mlp_spec(t.net)}
    if isinstance(t, JRQS):
        return {"kind": "rqs", "mask": t.mask, "knots": t.knots,
                "range_limit": t.range_limit, "use_pallas": False,
                **mlp_spec(t.net)}
    if isinstance(t, JScanned):
        return {"kind": "scanned", "inner": spec_of(t.stacked)}
    raise TypeError(type(t).__name__)


def carry(jf):
    return flow_from_jax_modules([spec_of(t) for t in jf.transforms],
                                 device="cpu")


def jmlp(rng, sizes, activation="silu", compute_dtype="f32", scale=0.5):
    f32 = jnp.float32
    return JMLP(
        weights=tuple(jnp.asarray(scale * rng.normal(
            0, np.sqrt(2.0 / a), (a, b)), f32)
            for a, b in zip(sizes[:-1], sizes[1:])),
        biases=tuple(jnp.asarray(rng.normal(0, 0.1, b), f32)
                     for b in sizes[1:]),
        activation=activation, compute_dtype=compute_dtype)


def jaffine(rng, mask, activation="silu", compute_dtype="f32"):
    return JAffine(mask=mask, net=jmlp(rng, (D, 12, 12, 2 * D), activation,
                                       compute_dtype), clamp=4.0)


def jwhiten(rng):
    a = 0.4 * rng.normal(size=(D, D))
    x = rng.normal(size=(512, D)) @ a.T + 0.3 * rng.normal(size=D)
    return JWhiten.from_samples(jnp.asarray(x, jnp.float32))


def _stack(blocks):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *blocks)


def jflow(kind, seed):
    rng = np.random.default_rng(seed)
    f32 = jnp.float32
    std = JStandardize(loc=jnp.asarray(rng.normal(0, 0.3, D), f32),
                       log_scale=jnp.asarray(rng.normal(0, 0.2, D), f32))
    m0, m1 = (1, 0) * (D // 2), (0, 1) * (D // 2)
    if kind == "identity":
        mods = (std, JIdentity(), jaffine(rng, m0))
    elif kind == "whiten":
        mods = (jwhiten(rng), jaffine(rng, m0), jaffine(rng, m1))
    elif kind == "scanned":
        mods = (std, JScanned(stacked=_stack(
            [jaffine(rng, m0) for _ in range(3)])))
    elif kind == "scanned_rqs":
        mods = (std, JScanned(stacked=_stack([JRQS(
            mask=m1, net=jmlp(rng, (D, 12, D * 11), scale=0.3), knots=4,
            use_pallas=False) for _ in range(2)])))
    elif kind == "gelu":
        mods = (std, jaffine(rng, m0, "gelu"), jaffine(rng, m1, "gelu"))
    else:
        raise ValueError(kind)
    return JChain(transforms=mods)


FLOWS = ["identity", "whiten", "scanned", "scanned_rqs", "gelu"]


def _x(seed, n=64):
    return np.random.default_rng(100 + seed).normal(
        size=(n, D)).astype(np.float32)


@pytest.mark.parametrize("kind", FLOWS)
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_flow_matches_jax(kind, direction):
    jf = jflow(kind, FLOWS.index(kind))
    tf = carry(jf)
    x = _x(FLOWS.index(kind))
    method = f"{direction}_and_ladj"
    jy, jl = getattr(jf, method)(jnp.asarray(x))
    ty, tl = getattr(tf, method)(torch.from_numpy(x))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("kind", FLOWS)
def test_gradients_match_jax(kind):
    """d/dleaves of sum(y^2 / 2) + sum(ladj) of the inverse."""
    jf = jflow(kind, 10 + FLOWS.index(kind))
    tf = carry(jf)
    x = _x(10 + FLOWS.index(kind))

    def j_obj(f):
        y, l = f.inverse_and_ladj(jnp.asarray(x))
        return 0.5 * jnp.sum(y * y) + jnp.sum(l)

    j_grads = jax.tree_util.tree_leaves(jax.grad(j_obj)(jf))
    y, l = tf.inverse_and_ladj(torch.from_numpy(x))
    params = list(tf.parameters())
    t_grads = torch.autograd.grad(0.5 * torch.sum(y * y) + torch.sum(l),
                                  params, allow_unused=True)
    # Whiten's inverse does not read inv_chol: JAX's gradient there is 0
    t_grads = [torch.zeros_like(p) if g is None else g
               for g, p in zip(t_grads, params)]
    assert len(t_grads) == len(j_grads)
    for tg, jg in zip(t_grads, j_grads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("kind", FLOWS)
def test_round_trip(kind):
    tf = carry(jflow(kind, 20 + FLOWS.index(kind)))
    x = torch.from_numpy(_x(20))
    z, lf = tf.forward_and_ladj(x)
    xb, li = tf.inverse_and_ladj(z)
    torch.testing.assert_close(xb, x, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(li, -lf, rtol=1e-4, atol=1e-4)


def test_identity_is_the_identity():
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
    for method in ("forward_and_ladj", "inverse_and_ladj"):
        y, l = getattr(Identity(), method)(x)
        assert y is x and l.shape == (5,) and not l.any()


def test_scanned_repeat_equals_the_chain_of_its_blocks():
    """`from_blocks` stacks blocks; the loop equals their Chain, block 0
    first forward, and a gradient reaches every stacked leaf."""
    rng = np.random.default_rng(30)
    blocks = list(carry(JChain(transforms=tuple(
        jaffine(rng, (0, 1) * (D // 2), "gelu") for _ in range(2))))
        .transforms)
    rep = ScannedRepeat.from_blocks(blocks)
    assert rep.num_blocks() == 2
    assert rep.stacked.net.weights[0].shape == (2, D, 12)
    x = torch.from_numpy(_x(30))
    for method in ("forward_and_ladj", "inverse_and_ladj"):
        y, l = getattr(rep, method)(x)
        yc, lc = getattr(Chain(blocks), method)(x)
        torch.testing.assert_close(y, yc, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(l, lc, rtol=1e-6, atol=1e-6)
    y, l = rep.inverse_and_ladj(x)
    grads = torch.autograd.grad(y.sum() + l.sum(), list(rep.parameters()))
    assert all(g.abs().sum() > 0 for g in grads)


def test_whiten_from_samples_matches_jax():
    rng = np.random.default_rng(40)
    x = (rng.normal(size=(400, D)) @ rng.normal(size=(D, D))).astype(
        np.float32)
    jw = JWhiten.from_samples(jnp.asarray(x))
    tw = Whiten.from_samples(torch.from_numpy(x))
    for name in ("loc", "chol", "inv_chol"):
        np.testing.assert_allclose(getattr(tw, name).detach().numpy(),
                                   np.asarray(getattr(jw, name)),
                                   rtol=1e-4, atol=1e-5)
    z = tw.forward(torch.from_numpy(x)).detach().numpy()
    # whitened: identity covariance up to the jitter
    np.testing.assert_allclose(np.cov(z.T, bias=True), np.eye(D), atol=1e-3)


@pytest.mark.parametrize("activation", ["silu", "gelu", "tanh", "relu"])
def test_mlp_activations_match_jax(activation):
    rng = np.random.default_rng(50)
    jnet = jmlp(rng, (D, 16, 16, 3), activation, scale=1.0)
    tnet = MLP(**{k: v for k, v in mlp_spec(jnet).items()})
    x = 2.0 * _x(50)
    np.testing.assert_allclose(tnet(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jnet(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_mlp_matches_jax_bf16(seed):
    """Operands rounded to bf16, float32 accumulation, on both sides; the
    gradient too. The bar (1e-3) is well under the bf16 rounding of the
    operands, which moves the output from the float32 MLP's by more than
    its tenth."""
    rng = np.random.default_rng(60 + seed)
    jnet = jmlp(rng, (D, 32, 32, 8), "silu", "bf16", scale=1.0)
    tnet = MLP(**mlp_spec(jnet))
    x = 3.0 * _x(60 + seed)
    jy = np.asarray(jnet(jnp.asarray(x)))
    ty = tnet(torch.from_numpy(x))
    np.testing.assert_allclose(ty.detach().numpy(), jy, **BF16_TOL)
    f32 = MLP(**{**mlp_spec(jnet), "compute_dtype": "f32"})
    assert np.abs(f32(torch.from_numpy(x)).detach().numpy() - jy).max() > 1e-4
    jg = jax.tree_util.tree_leaves(jax.grad(
        lambda n: jnp.sum(jnp.sin(n(jnp.asarray(x)))))(jnet))
    tg = torch.autograd.grad(torch.sum(torch.sin(ty)),
                             [*tnet.weights, *tnet.biases])
    for a, b in zip(tg, jg):  # weights, then biases, on both sides
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 2.0 ** -7 * np.abs(b).max()


def test_bf16_affine_coupling_round_trip_is_exact():
    """The inverse evaluates the same conditioner on the same pass-through
    bits, so bf16 operands keep the round trip as tight as float32."""
    jf = JChain(transforms=(jaffine(np.random.default_rng(70), (1, 0) * 3,
                                    compute_dtype="bf16"),))
    tf = carry(jf)
    assert tf.transforms[0].net.compute_dtype == "bf16"
    x = torch.from_numpy(_x(70))
    z, _ = tf.forward_and_ladj(x)
    torch.testing.assert_close(tf.inverse(z), x, rtol=1e-5, atol=1e-5)
    jz = np.asarray(jf.forward(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(z.detach().numpy(), jz, **BF16_TOL)


def test_mlp_refuses_unknown_settings():
    with pytest.raises(ValueError, match="activation"):
        MLP([torch.zeros(2, 2)], [torch.zeros(2)], activation="swish")
    with pytest.raises(ValueError, match="compute_dtype"):
        MLP([torch.zeros(2, 2)], [torch.zeros(2)], compute_dtype="f16")


# ---------------------------------------------------------------------------
# util/shapes.py
# ---------------------------------------------------------------------------
def test_flatview_and_nestedview_match_jax():
    rng = np.random.default_rng(80)
    rows = [rng.normal(size=3).astype(np.float32) for _ in range(5)]
    got = shapes.flatview([torch.from_numpy(r) for r in rows])
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jshapes.flatview(rows)))
    scalars = shapes.flatview(torch.arange(4.0))
    assert scalars.shape == (4, 1)
    assert jshapes.flatview(jnp.arange(4.0)).shape == (4, 1)
    nested = shapes.nestedview(got)
    assert len(nested) == 5 and nested[2].shape == (3,)
    np.testing.assert_array_equal(nested[2].numpy(), rows[2])


@pytest.mark.parametrize("n,nbatches", [(100, 10), (101, 10), (7, 7),
                                        (1000, 3)])
def test_num_batches_split_matches_jax(n, nbatches):
    assert shapes.num_batches_split(n, nbatches) == \
        jshapes.num_batches_split(n, nbatches)


@pytest.mark.parametrize("n,nbatches", [(3, 5), (10, 0)])
def test_num_batches_split_refuses(n, nbatches):
    with pytest.raises(ValueError):
        shapes.num_batches_split(n, nbatches)


def _example(rng, batch=()):
    """A parameter space with keys out of sorted order, a nested list and
    tuple, a scalar leaf and a None node."""
    f = np.float32
    return {
        "sigma": rng.normal(size=(*batch, 3)).astype(f),
        "W": rng.normal(size=(*batch, 2, 2)).astype(f),
        "mu": rng.normal(size=batch).astype(f),
        "block": [rng.normal(size=(*batch, 2)).astype(f),
                  (rng.normal(size=(*batch, 1)).astype(f), None)],
    }


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    return None if tree is None else torch.from_numpy(np.asarray(tree))


@pytest.mark.parametrize("batch", [(), (4,), (2, 3)])
def test_variate_shape_layout_matches_jax(batch):
    rng = np.random.default_rng(90)
    example = _example(rng)
    jvs, tvs = jshapes.VariateShape(example), shapes.VariateShape(
        _to_torch(example))
    assert tvs.dim == jvs.dim == 3 + 4 + 1 + 2 + 1
    tree = _example(rng, batch)
    jflat = np.asarray(jvs.flatten(tree))
    tflat = tvs.flatten(_to_torch(tree))
    assert tflat.shape == (*batch, tvs.dim)
    np.testing.assert_array_equal(tflat.numpy(), jflat)
    back = tvs.unflatten(tflat)
    assert list(back) == sorted(example)  # the keys in sorted order
    assert isinstance(back["block"], list)
    assert isinstance(back["block"][1], tuple) and back["block"][1][1] is None
    jback = jvs.unflatten(jnp.asarray(jflat))
    for key in ("sigma", "W", "mu"):
        np.testing.assert_array_equal(back[key].numpy(),
                                      np.asarray(jback[key]))
        np.testing.assert_array_equal(back[key].numpy(), tree[key])
    np.testing.assert_array_equal(back["block"][1][0].numpy(),
                                  tree["block"][1][0])


def test_variate_shape_flat_log_density():
    vs = shapes.VariateShape({"b": torch.zeros(2), "a": torch.zeros(())})

    def shaped(p):
        return p["a"] + 10.0 * p["b"].sum(-1)

    x = torch.tensor([[1.0, 2.0, 3.0], [0.0, 1.0, 0.0]])
    # "a" comes first in the flat layout
    torch.testing.assert_close(vs.flat_log_density(shaped)(x),
                               torch.tensor([51.0, 10.0]))


def test_variate_shape_keeps_named_tuples():
    from collections import namedtuple

    P = namedtuple("P", ["scale", "loc"])
    vs = shapes.VariateShape(P(torch.zeros(2), torch.zeros(())))
    back = vs.unflatten(torch.tensor([1.0, 2.0, 3.0]))
    assert isinstance(back, P)
    torch.testing.assert_close(back.scale, torch.tensor([1.0, 2.0]))
    torch.testing.assert_close(back.loc, torch.tensor(3.0))
