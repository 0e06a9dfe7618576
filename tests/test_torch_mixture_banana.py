"""The mixture, banana and Rosenbrock targets of the port
(`tpuflows_torch.targets.mixture`, `.banana`) against the JAX package's
on the same numpy inputs, on the CPU (rtol/atol 1e-5):

  * log densities on batches of shape (n, d) and (a, b, d), `mean` and
    `cov`, for the bimodal mixture (the configs' c3 and c7 targets) and a
    three-component mixture of unequal weights, the banana at d = 2 and
    4, and the Rosenbrock at d = 2 and 6 (it has no `cov`);
  * `bimodal`'s parameters field for field;
  * exact samplers: 40,000 draws against `mean` and `cov` (the JAX
    package draws other random numbers, so the draws are held to the
    analytic moments, each within 5 standard errors estimated from the
    draws);
  * `TargetSpec.build` passes only the separation to `bimodal`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows import config as jconfig
from tpuflows import targets as JT

from tpuflows_torch import config as tconfig
from tpuflows_torch import targets as T

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def three_modes(rng, d):
    means = rng.normal(0.0, 2.0, (3, d)).astype(np.float32)
    scales = rng.uniform(0.5, 1.5, (3, d)).astype(np.float32)
    logw = np.log(np.array([0.2, 0.5, 0.3], np.float32))
    return (JT.GaussianMixture(means=jnp.asarray(means),
                               scales=jnp.asarray(scales),
                               log_weights=jnp.asarray(logw)),
            T.GaussianMixture(torch.from_numpy(means),
                              torch.from_numpy(scales),
                              torch.from_numpy(logw)))


def pair(name, d):
    if name == "bimodal":
        return (JT.GaussianMixture.bimodal(dim=d, separation=6.0),
                T.GaussianMixture.bimodal(dim=d, separation=6.0,
                                          device="cpu"))
    if name == "three_modes":
        return three_modes(np.random.default_rng(d), d)
    if name == "banana":
        return JT.Banana(dim=d), T.Banana(dim=d)
    return JT.Rosenbrock(dim=d), T.Rosenbrock(dim=d)


CASES = [("bimodal", 8), ("bimodal", 16), ("three_modes", 5),
         ("banana", 2), ("banana", 4), ("rosenbrock", 2), ("rosenbrock", 6)]


@pytest.mark.parametrize("name,d", CASES)
def test_log_density_matches_jax(name, d):
    jt, tt = pair(name, d)
    rng = np.random.default_rng(d)
    for shape in ((64, d), (3, 5, d)):
        x = (2.0 * rng.normal(size=shape)).astype(np.float32)
        np.testing.assert_allclose(
            tt.log_density(torch.from_numpy(x)).numpy(),
            np.asarray(jt.log_density(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("name,d", CASES)
def test_moments_match_jax(name, d):
    jt, tt = pair(name, d)
    np.testing.assert_allclose(tt.mean("cpu").numpy(),
                               np.asarray(jt.mean()), **TOL)
    if name == "rosenbrock":
        with pytest.raises(NotImplementedError):
            tt.cov("cpu")
        return
    np.testing.assert_allclose(tt.cov("cpu").numpy(), np.asarray(jt.cov()),
                               **TOL)


def test_bimodal_parameters_match_jax():
    jt = JT.GaussianMixture.bimodal(dim=4, separation=3.0, scale=0.5)
    tt = T.GaussianMixture.bimodal(dim=4, separation=3.0, scale=0.5,
                                   device="cpu")
    for name in ("means", "scales", "log_weights"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)))
    assert tt.dim == jt.dim == 4


@pytest.mark.parametrize("name,d", CASES)
def test_sampler_matches_the_moments(name, d):
    """Every mean and every (co)variance within 5 of its standard errors,
    the errors estimated from the draws themselves."""
    _, tt = pair(name, d)
    n = 40_000
    x = tt.sample(torch.Generator().manual_seed(d), n, device="cpu")
    assert x.shape == (n, d) and x.dtype == torch.float32
    xs = x.double()
    xc = xs - xs.mean(0)
    assert torch.all(torch.abs(xs.mean(0) - tt.mean("cpu").double())
                     < 5 * xs.std(0) / n ** 0.5)
    if name == "rosenbrock":  # no cov: the variances, computed here
        s1, mu = tt.s1, tt.mu
        want = torch.ones(d, dtype=torch.float64)
        want[0::2] = s1 ** 2
        want[1::2] = 4 * mu ** 2 * s1 ** 2 + 2 * s1 ** 4 + tt.s2 ** 2
        prods = xc * xc
    else:
        want = tt.cov("cpu").double()
        prods = xc[:, :, None] * xc[:, None, :]
    assert torch.all(torch.abs(prods.mean(0) - want)
                     < 5 * prods.std(0) / n ** 0.5)


def test_target_spec_passes_only_the_separation():
    spec = dict(kind="mixture", dim=6, separation=5.0, scale=0.3)
    jt = jconfig.TargetSpec(**spec).build()
    tt = tconfig.TargetSpec(**spec).build(device="cpu")
    np.testing.assert_array_equal(tt.scales.numpy(), np.asarray(jt.scales))
    assert float(tt.scales.max()) == 1.0
    np.testing.assert_array_equal(tt.means.numpy(), np.asarray(jt.means))
