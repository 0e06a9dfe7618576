"""Diagnostics and adaptation state of the port against the JAX package on
identical numpy arrays: ESS and split-R-hat to 1e-5 (relative), one
dual-averaging / Welford update to 1e-6, and the warmup window schedule
exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows.diagnostics import effective_sample_size as j_ess
from tpuflows.diagnostics import split_rhat as j_rhat
from tpuflows.mcmc import dual_averaging as jda
from tpuflows.mcmc.sample import stan_window_closes as j_closes

from tpuflows_torch.diagnostics import effective_sample_size, split_rhat
from tpuflows_torch.mcmc import dual_averaging as tda
from tpuflows_torch.mcmc.sample import stan_window_closes


def _ar1(seed, n, m, d, phi):
    """AR(1) chains with a per-chain offset: autocorrelated draws with
    between-chain variance, so every branch of the estimators is used."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, m, d))
    e = rng.normal(size=(n, m, d))
    x[0] = e[0]
    for t in range(1, n):
        x[t] = phi * x[t - 1] + e[t]
    x += 0.1 * rng.normal(size=(1, m, d))
    return x.astype(np.float32)


SHAPES = [(64, 4, 3, 0.0), (100, 8, 2, 0.5), (257, 3, 4, 0.9),
          (50, 1, 2, 0.3), (128, 16, 5, -0.4)]


@pytest.mark.parametrize("n,m,d,phi", SHAPES)
def test_ess_matches_jax(n, m, d, phi):
    x = _ar1(n + m, n, m, d, phi)
    np.testing.assert_allclose(effective_sample_size(torch.from_numpy(x)),
                               np.asarray(j_ess(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,m,d,phi", [s for s in SHAPES if s[1] > 1])
def test_split_rhat_matches_jax(n, m, d, phi):
    x = _ar1(n * m, n, m, d, phi)
    np.testing.assert_allclose(split_rhat(torch.from_numpy(x)),
                               np.asarray(j_rhat(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


def _assert_state_close(t_state, j_state, tol=1e-6):
    for a, b in zip(t_state, j_state):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("eps0,accept", [(0.1, 0.3), (0.5, 0.95),
                                         (1.3, 0.8)])
def test_dual_averaging_matches_jax(eps0, accept):
    js, ts = jda.da_init(eps0), tda.da_init(eps0)
    _assert_state_close(ts, js)
    for a in (accept, 1.0 - accept, accept):
        js = jda.da_update(js, jnp.float32(a))
        ts = tda.da_update(ts, torch.tensor(a))
        _assert_state_close(ts, js)
    for averaged in (False, True):
        np.testing.assert_allclose(
            float(tda.da_step_size(ts, averaged)),
            float(jda.da_step_size(js, averaged)), rtol=1e-6)


def test_dual_averaging_per_chain_vector_matches_jax():
    eps0 = np.array([0.1, 0.2, 0.4], np.float32)
    acc = np.array([0.5, 0.9, 0.99], np.float32)
    js = jda.da_update(jda.da_init(jnp.asarray(eps0)), jnp.asarray(acc))
    ts = tda.da_update(tda.da_init(torch.from_numpy(eps0)),
                       torch.from_numpy(acc))
    _assert_state_close(ts, js)


@pytest.mark.parametrize("seed", [0, 1])
def test_welford_matches_jax(seed):
    rng = np.random.default_rng(seed)
    xs = [(3.0 * rng.normal(size=(16, 5)) + 2.0).astype(np.float32)
          for _ in range(3)]
    js, ts = jda.welford_init(5), tda.welford_init(5, device="cpu")
    for x in xs:
        js = jda.welford_update_batch(js, jnp.asarray(x))
        ts = tda.welford_update_batch(ts, torch.from_numpy(x))
        _assert_state_close(ts, js, tol=1e-5)
    for reg in (False, True):
        np.testing.assert_allclose(tda.welford_variance(ts, reg),
                                   np.asarray(jda.welford_variance(js, reg)),
                                   rtol=1e-5)
    # a merge of two streams equals the JAX merge
    jb = jda.welford_update_batch(jda.welford_init(5), jnp.asarray(xs[0]))
    tb = tda.welford_update_batch(tda.welford_init(5, device="cpu"),
                                  torch.from_numpy(xs[0]))
    _assert_state_close(tda.welford_merge(ts, tb),
                        jda.welford_merge(js, jb), tol=1e-5)


@pytest.mark.parametrize("num_warmup", [20, 128, 500, 1000])
def test_stan_window_closes_match_jax(num_warmup):
    a, b = stan_window_closes(num_warmup), j_closes(num_warmup)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1:] == b[1:]
