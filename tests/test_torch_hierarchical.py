"""The hierarchical target of the port (`tpuflows_torch.targets.hierarchical`,
config c5's) against the JAX package's, on the CPU, at d = 18 and 256:

  * the data y, the quadrature mean and covariance (float32) and the log
    evidence (float64) equal the JAX package's exactly: both cast the
    same float32 data to float64 and run the same numpy quadrature;
  * `log_density` on a batch of posterior draws and of wide ones to
    rtol 1e-5 (atol 1e-5 of its scale, which reaches 1e4 at d = 256);
  * `sample_prior` and `sample` pass the family-corrected moment gate at
    3 sigma against the prior's moments (mu ~ N(0, 25), log_tau ~ N(0, 1),
    theta_i with mean 0 and variance 25 + e^2) and the quadrature
    posterior moments;
  * `TargetSpec("hierarchical", d).build` is the standard target;
  * the JAX package's checks of the truth (`tests/test_targets.py`): the
    exact sampler against the moments, log_density peaked near the mean.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows.targets import HierarchicalGaussian as JHier

from tpuflows_torch.config import TargetSpec
from tpuflows_torch.diagnostics import moment_gate
from tpuflows_torch.targets import HierarchicalGaussian

DIMS = [18, 256]


@pytest.fixture(scope="module", params=DIMS)
def pair(request):
    d = request.param
    return JHier.standard(dim=d), HierarchicalGaussian.standard(
        dim=d, device="cpu")


def test_data_moments_and_evidence_equal_jax(pair):
    jt, tt = pair
    assert tt.dim == jt.dim
    assert np.array_equal(tt.y.numpy(), np.asarray(jt.y))
    assert np.array_equal(tt.mean("cpu").numpy(), np.asarray(jt.mean()))
    assert np.array_equal(tt.cov("cpu").numpy(), np.asarray(jt.cov()))
    assert tt.log_evidence() == jt.log_evidence()
    assert (tt.noise, tt.prior_mu_scale) == (jt.noise, jt.prior_mu_scale)


def test_log_density_matches_jax(pair):
    jt, tt = pair
    d = tt.dim
    rng = np.random.default_rng(d)
    post = np.asarray(jt.sample(jax.random.key(1), 64))
    wide = (np.asarray(jt.mean()) + 3.0 * rng.normal(size=(64, d))
            ).astype(np.float32)
    for x in (post, wide):
        want = np.asarray(jt.log_density(jnp.asarray(x)))
        got = tt.log_density(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def prior_moments(t):
    d = t.dim
    mean = np.zeros(d)
    var = np.full(d, t.prior_mu_scale ** 2 + math.exp(2.0))
    var[0], var[1] = t.prior_mu_scale ** 2, 1.0
    return mean, var


def test_sampling_passes_the_moment_gate(pair):
    _, tt = pair
    g = torch.Generator().manual_seed(3)
    prior = tt.sample_prior(g, 40_000, device="cpu")
    mean, var = prior_moments(tt)
    check = moment_gate(prior, mean, var, family_correction=True, ess=40_000)
    assert check.passed, check
    post = tt.sample(g, 40_000, device="cpu")
    check = moment_gate(post, tt.mean("cpu"), torch.diagonal(tt.cov("cpu")),
                        family_correction=True, ess=40_000)
    assert check.passed, check
    assert prior.shape == post.shape == (40_000, tt.dim)
    assert prior.dtype == post.dtype == torch.float32


def test_log_density_peaks_near_the_mean(pair):
    _, tt = pair
    m = tt.mean("cpu")[None]
    lp_mean = float(tt.log_density(m)[0])
    lp_far = float(tt.log_density(m + 10.0)[0])
    assert math.isfinite(lp_mean) and lp_mean > lp_far


@pytest.mark.parametrize("d", DIMS)
def test_target_spec_builds_the_standard_target(d):
    tt = TargetSpec("hierarchical", d).build(device="cpu")
    assert isinstance(tt, HierarchicalGaussian) and tt.dim == d
    assert np.array_equal(tt.y.numpy(),
                          HierarchicalGaussian.standard(
                              dim=d, device="cpu").y.numpy())
