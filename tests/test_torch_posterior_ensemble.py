"""The modules of the port that only tests reach: the posterior and its
priors (`targets/posterior.py`), the multimodal Cauchy target
(`targets/cauchy.py`) and the ensemble sampler (`mcmc/ensemble.py`),
against the JAX package's on the CPU:

  * every `IndependentPrior` function (constrain, unconstrain,
    constrain_ladj, log_pdf) and `Posterior.log_density` on the same
    inputs, all six marginal kinds, within 1e-5; prior sampling with the
    JAX draws replayed (`sample_math`: the normals, the uniforms and the
    Gamma draws of `posterior.py:187-198`) within 1e-5;
  * `find_mode` from the JAX starts (x0 + 0.5 N(0, I) on `key(0)`): the
    mode, its log density and the objective's trace within 1e-5 (the
    port's `Adam` is optax.adam written out);
  * the Cauchy log density and quantiles within 1e-5, and its sampler
    with the JAX draws replayed (`sample_math`: jax.random.cauchy and
    bernoulli);
  * the stretch move with the JAX draws replayed (`_half_step_math`: the
    key splits of `ensemble.py:40-46`), one half-step and a whole 50-step
    run (`_ensemble_run`), within 1e-5 with every accept decision equal;
  * the port's own samplers on the JAX package's checks
    (`tests/test_posterior.py`, `tests/test_targets.py`,
    `tests/test_ensemble_evidence.py`), through
    `chip_smoke.test_only_modules`, the phase that runs them on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows.mcmc import ensemble as jensemble
from tpuflows.mcmc import run_ensemble as j_run_ensemble
from tpuflows.targets import IndependentPrior as JPrior
from tpuflows.targets import MultimodalCauchy as JCauchy
from tpuflows.targets import Posterior as JPosterior
from tpuflows.targets import DiagNormal as JDiagNormal
from tpuflows.targets import find_mode as j_find_mode
from tpuflows.targets import posterior as jposterior

from tpuflows_torch.mcmc import EnsembleResult, run_ensemble
from tpuflows_torch.mcmc.ensemble import _ensemble_run, _half_step_math
from tpuflows_torch.targets import (DiagNormal, IndependentPrior,
                                    MultimodalCauchy, Posterior, find_mode)
from tpuflows_torch.targets import posterior as tposterior

import chip_smoke

TOL = dict(rtol=1e-5, atol=1e-5)
KINDS = ["Normal", "LogNormal", "Exponential", "HalfNormal", "Uniform",
         "Beta"]
ARGS = [(1.0, 2.0), (0.5, 0.7), (2.0,), (1.5,), (-1.0, 3.0), (2.0, 5.0)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(a):
    return torch.from_numpy(np.array(a))


def close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               **(tol or TOL))


def priors():
    jm = [getattr(jposterior, k)(*a) for k, a in zip(KINDS, ARGS)]
    tm = [getattr(tposterior, k)(*a) for k, a in zip(KINDS, ARGS)]
    assert [tuple(m) for m in tm] == [tuple(m) for m in jm]
    return JPrior(jm), IndependentPrior(tm, device="cpu")


def test_marginals_match_jax():
    assert tposterior.Marginal._fields == jposterior.Marginal._fields
    with pytest.raises(ValueError, match="hi > lo"):
        tposterior.Uniform(1.0, 1.0)


def test_prior_functions_match_jax():
    jp, tp = priors()
    u = 2.0 * np.random.default_rng(0).normal(size=(256, 6))
    u = u.astype(np.float32)
    close(tp.constrain(t(u)), jp.constrain(jnp.asarray(u)))
    close(tp.constrain_ladj(t(u)), jp.constrain_ladj(jnp.asarray(u)))
    theta = np.asarray(jp.constrain(jnp.asarray(u)))
    close(tp.unconstrain(t(theta)), jp.unconstrain(jnp.asarray(theta)))
    close(tp.log_pdf(t(theta)), jp.log_pdf(jnp.asarray(theta)))
    # outside the support: -inf in both
    out = theta.copy()
    out[:8, 4] = 5.0
    out[8:16, 2] = -1.0
    got = tp.log_pdf(t(out)).numpy()
    want = np.asarray(jp.log_pdf(jnp.asarray(out)))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got[:16]).all()
    close(got[16:], want[16:])


def test_prior_sampling_replays_jax():
    jp, tp = priors()
    key, n = jax.random.key(3), 2000
    kn, ku = jax.random.split(key)
    z = jax.random.normal(kn, (n, 6), jnp.float32)
    v = jax.random.uniform(ku, (n, 6), jnp.float32, minval=1e-7,
                           maxval=1 - 1e-7)
    g1 = jax.random.gamma(kn, jnp.maximum(jp._a, 1e-6), (n, 6))
    g2 = jax.random.gamma(ku, jnp.maximum(jp._b, 1e-6), (n, 6))
    close(tp.sample_math(t(z), t(v), t(g1), t(g2)), jp.sample(key, n))
    th = tp.sample(torch.Generator().manual_seed(0), 4)
    assert th.shape == (4, 6) and bool(torch.isfinite(th).all())


def conjugate(pkg):
    y = [0.8, 1.2, 1.0, 0.6]
    if pkg == "jax":
        yj = jnp.asarray(y, jnp.float32)
        return JPosterior(lambda th: -0.5 * jnp.sum(
            (yj - th[..., 0][..., None]) ** 2, axis=-1),
            JPrior([jposterior.Normal(0.0, 1.0),
                    jposterior.LogNormal(0.0, 1.0)]))
    yt = torch.tensor(y)
    return Posterior(lambda th: -0.5 * torch.sum(
        (yt - th[..., 0][..., None]) ** 2, dim=-1),
        IndependentPrior([tposterior.Normal(0.0, 1.0),
                          tposterior.LogNormal(0.0, 1.0)], device="cpu"))


def test_posterior_matches_jax():
    jpost, tpost = conjugate("jax"), conjugate("torch")
    u = np.random.default_rng(1).normal(size=(64, 2)).astype(np.float32)
    close(tpost.log_density(t(u)), jpost.log_density(jnp.asarray(u)))
    close(tpost.constrain(t(u)), jpost.constrain(jnp.asarray(u)))
    assert tpost.dim == jpost.dim == 2


def test_find_mode_from_the_jax_starts():
    jpost, tpost = conjugate("jax"), conjugate("torch")
    x0 = jnp.zeros(2)
    want = j_find_mode(jpost, x0, nsteps=300)
    starts = x0[None, :] + 0.5 * jax.random.normal(jax.random.key(0),
                                                   (8, 2), jnp.float32)
    starts = starts.at[0].set(x0)
    got = find_mode(tpost, torch.zeros(2), nsteps=300, starts=t(starts))
    close(got.mode_u, want.mode_u)
    close(got.mode, want.mode)
    close(got.log_density, want.log_density)
    close(got.trace, want.trace)
    # the MAP of mu: sum y / (n + 1)
    assert abs(float(got.mode[0]) - 3.6 / 5) < 1e-3


def test_cauchy_matches_jax():
    jt, tt = JCauchy(dim=5, mu=1.0, sigma=0.2), MultimodalCauchy(
        dim=5, mu=1.0, sigma=0.2)
    x = (np.random.default_rng(2).standard_cauchy((128, 5)) * 0.5
         ).astype(np.float32)
    close(tt.log_density(t(x)), jt.log_density(jnp.asarray(x)))
    qs = [0.1, 0.25, 0.5, 0.75, 0.9]
    close(tt.quantiles(qs, device="cpu"), jt.quantiles(qs))
    key, n = jax.random.key(4), 1000
    k_c, k_s = jax.random.split(key)
    c = jax.random.cauchy(k_c, (n, 5), jnp.float32)
    heads = jax.random.bernoulli(k_s, 0.5, (n, 2))
    close(tt.sample_math(t(c), t(heads)), jt.sample(key, n))


def laplace(x):
    return -torch.sum(torch.abs(x), dim=-1)


def half_step_draws(key, m, m2):
    k_z, k_j, k_u = jax.random.split(key, 3)
    return (jax.random.uniform(k_z, (m,)),
            jax.random.randint(k_j, (m,), 0, m2),
            jax.random.uniform(k_u, (m,)))


def test_half_step_replays_jax():
    jt = JDiagNormal(loc=jnp.array([1.0, -2.0, 0.5]),
                     scale=jnp.array([0.5, 1.5, 1.0]))
    tt = DiagNormal(loc=torch.tensor([1.0, -2.0, 0.5]),
                    scale=torch.tensor([0.5, 1.5, 1.0]))
    w = jax.random.normal(jax.random.key(5), (64, 3))
    movers, others = w[:32], w[32:]
    lp = jt.log_density(movers)
    key = jax.random.key(6)
    want = jensemble._half_step(key, movers, others, jt.log_density, lp, 2.0)
    u, j, u_acc = half_step_draws(key, 32, 32)
    got = _half_step_math(t(movers), t(others), tt.log_density, t(lp), 2.0,
                          t(u), t(j).long(), t(u_acc))
    close(got[0], want[0])
    close(got[1], want[1])
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0 < int(got[2].sum()) < 32


def test_ensemble_run_replays_jax():
    """50 steps (20 warmup) of 32 walkers on a 2-d Laplace target (the
    JAX package's gradient-free check), each half-step with the JAX
    draws: `run_ensemble`'s keys split per step (k1, k2) for the halves."""
    w0 = jax.random.normal(jax.random.key(2), (32, 2))
    key = jax.random.key(3)
    want = j_run_ensemble(key, lambda x: -jnp.sum(jnp.abs(x), axis=-1), w0,
                          num_warmup=20, num_samples=30)
    keys = jax.random.split(key, 50)
    halves = [jax.random.split(k) for k in keys]

    def half_step(step, h, movers, others, logp_movers):
        u, j, u_acc = half_step_draws(halves[step][h], 16, 16)
        return _half_step_math(movers, others, laplace, logp_movers, 2.0,
                               t(u), t(j).long(), t(u_acc))

    got = _ensemble_run(laplace, t(w0), 20, 30, 2.0, half_step)
    assert isinstance(got, EnsembleResult)
    close(got.samples, want.samples)
    close(got.final_walkers, want.final_walkers)
    close(got.accept_rate, want.accept_rate)


def test_odd_walker_counts_are_refused():
    with pytest.raises(ValueError, match="even"):
        run_ensemble(torch.Generator(), laplace, torch.zeros((3, 2)))


def test_the_jax_packages_checks_on_the_port():
    """Each check of `chip_smoke.test_only_modules` passes on the CPU at
    the JAX tests' sizes (the bounded posterior's NUTS at half its steps,
    `chip_smoke.POSTERIOR_NUTS_STEPS`)."""
    rows = chip_smoke.test_only_modules("cpu")
    assert len(rows) == 9
    for row in rows:
        assert row["passed"], row
