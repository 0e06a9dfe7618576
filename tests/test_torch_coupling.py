"""The spline coupling of the port against the JAX package's, on the same
numpy leaves carried across with `tpuflows_torch.convert.
flow_from_jax_modules`:

  * `RQSCouplingBlock` in its tiers: use_pallas=False (the oracle)
    against the JAX oracle, True and "auto" (on the CPU the plain version
    of K4/K5, the Pallas tile math) against the JAX Pallas tier in
    interpret mode, inverse on latent draws and forward on data-space
    draws, to the JAX package's own bar for its spline (jnp.allclose,
    atol 1e-4): the same float32 formulas, but knots that differ in the
    last bit move x in the flattest bins by up to ~5e-5, as far as either
    side is from a float64 evaluation; "fused" resolves to its tier
    (tests/test_torch_coupling_fused.py holds it to the JAX package);
  * `rqs_coupling_module` and `RQSCouplingBlock.init`: structure;
  * the converter on the committed engine-found flow
    (docs/artifacts/adaptive_generic_flow.{npz,tree}, 11 modules, read
    with `tpuflows.io.load_pytree`): inverse and ladj on 256 latent draws
    within 1e-4 on x and 1e-3 on ladj (plus 1e-5 relative), with the
    oracle tier and with the port's default tier, against the JAX flow as
    loaded (its "auto" runs the oracle on the CPU). Tighter is not
    meaningful: the JAX flow's own float32 x is 1.4e-4 from a float64
    evaluation of the same flow.
"""
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
from tpuflows.flows.coupling import rqs_coupling_module as j_module
from tpuflows.flows.nets import MLP as JMLP
from tpuflows.io import load_pytree

from tpuflows_torch.convert import flow_from_jax_modules
from tpuflows_torch.flows import (AffineCoupling, RQSCouplingBlock,
                                  Standardize, rqs_coupling_module)
from tpuflows_torch.util.shapes import alternating_mask, block_mask

ROOT = Path(__file__).resolve().parents[1]
ARTIFACT = ROOT / "docs" / "artifacts" / "adaptive_generic_flow"
TOL = dict(rtol=1e-5, atol=1e-5)
JAX_BAR = dict(rtol=1e-5, atol=1e-4)


def module_specs(jf, use_pallas=None):
    """The converter's dicts for a JAX Chain of Standardize /
    AffineCoupling / RQSCouplingBlock: numpy leaves and static fields. The
    spline blocks keep their `use_pallas` unless one is given."""
    specs = []
    for t in jf.transforms:
        if isinstance(t, JStandardize):
            specs.append({"kind": "standardize", "loc": np.asarray(t.loc),
                          "log_scale": np.asarray(t.log_scale)})
            continue
        spec = {"mask": t.mask, "activation": t.net.activation,
                "weights": [np.asarray(w) for w in t.net.weights],
                "biases": [np.asarray(b) for b in t.net.biases]}
        if isinstance(t, JAffine):
            spec.update(kind="affine", clamp=t.clamp)
        elif isinstance(t, JRQS):
            spec.update(kind="rqs", knots=t.knots, range_limit=t.range_limit,
                        use_pallas=(t.use_pallas if use_pallas is None
                                    else use_pallas))
        else:
            raise TypeError(type(t).__name__)
        specs.append(spec)
    return specs


def carry(jf, use_pallas=None):
    return flow_from_jax_modules(module_specs(jf, use_pallas), device="cpu")


def jax_arqs_flow(seed, d=8, n_blocks=2, knots=4, hidden=(16, 16),
                  scale=0.3, use_pallas=False):
    """Standardize + n_blocks x (affine, spline) on the mixed masks, with
    every leaf drawn from numpy (non-zero last layers)."""
    rng = np.random.default_rng(seed)
    f32 = jnp.float32

    def mlp(n_out, last_scale):
        sizes = (d, *hidden, n_out)
        ws = [rng.normal(0.0, np.sqrt(2.0 / a), (a, b))
              for a, b in zip(sizes[:-1], sizes[1:])]
        ws[-1] = last_scale * ws[-1]
        bs = [rng.normal(0.0, 0.1, b) for b in sizes[1:]]
        return JMLP(weights=tuple(jnp.asarray(w, f32) for w in ws),
                    biases=tuple(jnp.asarray(b, f32) for b in bs))

    def mask(i):
        return (alternating_mask(d, i % 4) if i % 4 < 2
                else block_mask(d, i % 4 - 2))

    mods = [JStandardize(loc=jnp.asarray(rng.normal(0, 0.3, d), f32),
                         log_scale=jnp.asarray(rng.normal(0, 0.2, d), f32))]
    for i in range(n_blocks):
        mods.append(JAffine(mask=mask(i), net=mlp(2 * d, scale), clamp=8.0))
        mods.append(JRQS(mask=mask(i), net=mlp(d * (3 * knots - 1), scale),
                         knots=knots, use_pallas=use_pallas))
    return JChain(transforms=tuple(mods))


def _z(seed, n=64, d=8, scale=1.5):
    return (scale * np.random.default_rng(300 + seed).normal(
        size=(n, d))).astype(np.float32)


def _both_ways(jf, tf, z):
    """Inverse on latent draws z, forward on data-space draws."""
    jx, jl = jf.inverse_and_ladj(jnp.asarray(z))
    with torch.no_grad():
        tx, tl = tf.inverse_and_ladj(torch.from_numpy(z))
    x = (np.random.default_rng(1).permutation(z.ravel()).reshape(z.shape)
         * 1.3).astype(np.float32)
    jz, jfl = jf.forward_and_ladj(jnp.asarray(x))
    with torch.no_grad():
        tz, tfl = tf.forward_and_ladj(torch.from_numpy(x))
    return ((tx.numpy(), np.asarray(jx)), (tl.numpy(), np.asarray(jl)),
            (tz.numpy(), np.asarray(jz)), (tfl.numpy(), np.asarray(jfl)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_oracle_tier_matches_jax(seed):
    jf = jax_arqs_flow(seed, n_blocks=1)
    blk = JChain(transforms=(jf.transforms[2],))
    tf = carry(blk)
    assert tf.transforms[0].use_pallas is False
    for a, b in _both_ways(blk, tf, _z(seed)):
        np.testing.assert_allclose(a, b, **JAX_BAR)


@pytest.mark.parametrize("tier", [True, "auto"])
def test_block_kernel_tier_matches_jax_pallas(tier):
    """On the CPU the K4/K5 tier runs their plain version; the JAX side
    runs its Pallas spline in interpret mode."""
    jf = jax_arqs_flow(3, n_blocks=1, use_pallas=True)
    blk = JChain(transforms=(jf.transforms[2],))
    tf = carry(blk, use_pallas=tier)
    for a, b in _both_ways(blk, tf, _z(3)):
        np.testing.assert_allclose(a, b, **JAX_BAR)
    # and its gradients through the block, against jax.grad
    z = _z(4)

    def j_loss(zz):
        x, ladj = blk.inverse_and_ladj(zz)
        return jnp.sum(jnp.sin(x)) + jnp.sum(ladj * ladj)

    want = np.asarray(jax.grad(j_loss)(jnp.asarray(z)))
    zt = torch.from_numpy(z).requires_grad_(True)
    x, ladj = tf.inverse_and_ladj(zt)
    (got,) = torch.autograd.grad(torch.sum(torch.sin(x))
                                 + torch.sum(ladj * ladj), zt)
    np.testing.assert_allclose(got.numpy(), want, **JAX_BAR)


def test_fused_tier_refuses_naming_the_roadmap():
    """The fused tier was refused until K6/K7 were ported; now "fused"
    resolves to that tier on a batch and runs (its parity with the JAX
    package is tests/test_torch_coupling_fused.py's); an unknown tier is
    still refused."""
    blk = carry(JChain(transforms=(jax_arqs_flow(0, n_blocks=1)
                                   .transforms[2],)), use_pallas="fused")
    t = blk.transforms[0]
    assert t._kernel_choice(torch.zeros(4, 8)) == "fused"
    z, ladj = blk.forward_and_ladj(torch.zeros(4, 8))
    assert z.shape == (4, 8) and ladj.shape == (4,)
    with pytest.raises(ValueError):
        RQSCouplingBlock(blk.transforms[0].mask, blk.transforms[0].net,
                         use_pallas="xla")


def test_block_init_and_module_match_jax_structure():
    g = torch.Generator().manual_seed(0)
    tm = rqs_coupling_module(g, 6, n_blocks=3, knots=5, hidden=(12, 10),
                             device="cpu")
    jm = j_module(jax.random.key(0), 6, n_blocks=3, knots=5, hidden=(12, 10))
    assert len(tm) == len(jm.transforms) == 3
    for tb, jb in zip(tm.transforms, jm.transforms):
        assert isinstance(tb, RQSCouplingBlock)
        assert (tb.mask, tb.knots, tb.range_limit, tb.use_pallas) == (
            jb.mask, jb.knots, jb.range_limit, jb.use_pallas)
        assert [tuple(w.shape) for w in tb.net.weights] == [
            tuple(w.shape) for w in jb.net.weights]
        assert float(tb.net.weights[-1].detach().abs().max()) == 0.0
    # a fresh block: the spline of uniform bins, slopes 1 + min_deriv
    z = torch.linspace(-5.0, 5.0, 60).reshape(10, 6)
    with torch.no_grad():
        x, ladj = tm.inverse_and_ladj(z)
    np.testing.assert_allclose(
        x.numpy(), np.asarray(jm.inverse(jnp.asarray(z.numpy()))), **TOL)


def test_converter_builds_every_module_kind():
    jf = jax_arqs_flow(5, n_blocks=2)
    tf = carry(jf)
    assert [type(t) for t in tf.transforms] == [
        Standardize, AffineCoupling, RQSCouplingBlock, AffineCoupling,
        RQSCouplingBlock]
    for a, b in _both_ways(jf, tf, _z(5)):
        np.testing.assert_allclose(a, b, **JAX_BAR)
    with pytest.raises(ValueError):
        flow_from_jax_modules([{"kind": "whiten"}], device="cpu")


def _trained_flow():
    return load_pytree(str(ARTIFACT))["flow"]


def _latent_draws():
    return np.random.default_rng(7).normal(size=(256, 64)).astype(np.float32)


@pytest.mark.parametrize("tier", [False, "auto"])
def test_converter_on_the_committed_trained_flow(tier):
    """The engine-found 64-d flow: 11 modules, K = 8, hidden 128 x 128."""
    jf = _trained_flow()
    assert len(jf.transforms) == 11
    tf = carry(jf, use_pallas=tier)
    assert sum(isinstance(t, RQSCouplingBlock) for t in tf.transforms) == 5
    z = _latent_draws()
    jx, jl = jf.inverse_and_ladj(jnp.asarray(z))
    with torch.no_grad():
        tx, tl = tf.inverse_and_ladj(torch.from_numpy(z))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-3)
