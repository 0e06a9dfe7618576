"""The Gaussian targets of the port (`StandardNormal`, `DiagNormal`,
`CorrelatedGaussian` and its `ar1`) against the JAX package's on the same
numpy inputs: log density to rtol 1e-5 / atol 1e-5 (on batches of any
leading shape), its gradient, the analytic moments, and the exact samplers
by their moments (a 5-sigma Monte-Carlo margin on 20,000 draws).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows import targets as JT

from tpuflows_torch import targets as TT

TOL = dict(rtol=1e-5, atol=1e-5)


def pair(kind, d):
    rng = np.random.default_rng(d)
    if kind == "std":
        return JT.StandardNormal(dim=d), TT.StandardNormal(d)
    if kind == "diag":
        loc = rng.normal(size=d).astype(np.float32)
        scale = np.exp(rng.normal(0, 0.5, d)).astype(np.float32)
        return (JT.DiagNormal(loc=jnp.asarray(loc), scale=jnp.asarray(scale)),
                TT.DiagNormal(torch.from_numpy(loc), torch.from_numpy(scale)))
    if kind == "ar1":
        return (JT.CorrelatedGaussian.ar1(dim=d, rho=0.8, scale=1.5),
                TT.CorrelatedGaussian.ar1(dim=d, rho=0.8, scale=1.5,
                                          device="cpu"))
    if kind == "correlated":
        a = rng.normal(size=(d, d))
        chol = np.linalg.cholesky(a @ a.T + d * np.eye(d)).astype(np.float32)
        loc = rng.normal(size=d).astype(np.float32)
        return (JT.CorrelatedGaussian(loc=jnp.asarray(loc),
                                      chol=jnp.asarray(chol)),
                TT.CorrelatedGaussian(torch.from_numpy(loc),
                                      torch.from_numpy(chol)))
    raise ValueError(kind)


KINDS = ["std", "diag", "ar1", "correlated"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", [1, 2, 8])
@pytest.mark.parametrize("batch", [(64,), (3, 5)])
def test_log_density_matches_jax(kind, d, batch):
    jt, tt = pair(kind, d)
    x = (1.5 * np.random.default_rng(10 + d).normal(
        size=(*batch, d))).astype(np.float32)
    want = np.asarray(jt.log_density(jnp.asarray(x)))
    got = tt.log_density(torch.from_numpy(x))
    assert got.shape == batch
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(tt(torch.from_numpy(x)).numpy(), want, **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_log_density_gradient_matches_jax(kind):
    jt, tt = pair(kind, 8)
    x = np.random.default_rng(20).normal(size=(32, 8)).astype(np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(jt.log_density(v)))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad(tt.log_density(xt).sum(), xt)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_moments_match_jax(kind):
    jt, tt = pair(kind, 8)
    assert tt.dim == jt.dim == 8
    np.testing.assert_allclose(tt.mean(device="cpu").numpy(),
                               np.asarray(jt.mean()), **TOL)
    np.testing.assert_allclose(tt.cov(device="cpu").numpy(),
                               np.asarray(jt.cov()), **TOL)


def test_ar1_factor_matches_jax():
    jt, tt = pair("ar1", 8)
    np.testing.assert_array_equal(tt.chol.numpy(), np.asarray(jt.chol))
    np.testing.assert_array_equal(tt.loc.numpy(), np.asarray(jt.loc))


@pytest.mark.parametrize("kind", KINDS)
def test_sampler_moments(kind):
    """Mean and covariance of 20,000 exact draws within 5 Monte-Carlo
    standard errors of the analytic ones."""
    _, tt = pair(kind, 4)
    n = 20_000
    x = tt.sample(torch.Generator().manual_seed(1), n, device="cpu").double()
    assert x.shape == (n, 4)
    mean, cov = tt.mean(device="cpu").double(), tt.cov(device="cpu").double()
    var = torch.diagonal(cov)
    assert torch.all((x.mean(0) - mean).abs() <= 5 * torch.sqrt(var / n))
    emp = torch.cov(x.T)
    # Var of a sample covariance entry: (S_ii S_jj + S_ij^2) / n
    se = torch.sqrt((var[:, None] * var[None, :] + cov ** 2) / n)
    assert torch.all((emp - cov).abs() <= 5 * se)


def test_samplers_draw_from_their_generator():
    _, tt = pair("ar1", 3)
    a, b = (tt.sample(torch.Generator().manual_seed(s), 5, device="cpu")
            for s in (2, 2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
