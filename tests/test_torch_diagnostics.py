"""Diagnostics and adaptation state of the port against the JAX package on
identical numpy arrays: ESS and split-R-hat to 1e-5 (relative), one
dual-averaging / Welford update to 1e-6, and the warmup window schedule
exactly. The moment gate: the same verdict, its z-scores to 1e-4 and its
ESS to 1e-5 (relative; both reduce in float32, in other orders), the
family threshold to 1e-12; the importance-weight ESS to 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows.diagnostics import effective_sample_size as j_ess
from tpuflows.diagnostics import importance_weight_ess as j_iw_ess
from tpuflows.diagnostics import moment_gate as j_gate
from tpuflows.diagnostics import split_rhat as j_rhat
from tpuflows.diagnostics.moments import family_threshold as j_family
from tpuflows.mcmc import dual_averaging as jda
from tpuflows.mcmc.sample import stan_window_closes as j_closes

from tpuflows_torch.diagnostics import (MomentCheck, effective_sample_size,
                                        family_threshold,
                                        importance_weight_ess, moment_gate,
                                        split_rhat)
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


@pytest.mark.parametrize("n_sigma,m", [(3.0, 8), (5.0, 2), (3.0, 512),
                                       (2.0, 1)])
def test_family_threshold_matches_jax(n_sigma, m):
    np.testing.assert_allclose(family_threshold(n_sigma, m),
                               j_family(n_sigma, m), rtol=1e-12)


# (draws, chains, d, mean shift, ess, family correction): chains of draws
# and a single-chain (n, d) array, a gate that fails on a shifted mean, a
# given ESS, and the family-wise threshold
GATE_CASES = [(200, 4, 3, 0.0, None, False), (500, 0, 3, 0.0, None, True),
              (300, 8, 2, 0.5, None, False), (100, 8, 2, 0.0, 300.0, False),
              (128, 16, 5, 0.05, None, True)]


@pytest.mark.parametrize("n,m,d,shift,ess,family", GATE_CASES)
def test_moment_gate_matches_jax(n, m, d, shift, ess, family):
    x = _ar1(n + d, n, max(m, 1), d, 0.3)
    x = x[:, 0, :] if m == 0 else x
    x = (x + shift).astype(np.float32)
    true_mean = np.zeros(d, np.float32)
    true_var = np.full(d, 1.0 / (1.0 - 0.09), np.float32)
    jc = j_gate(jnp.asarray(x), true_mean, true_var, ess=ess,
                family_correction=family)
    tc = moment_gate(torch.from_numpy(x), torch.from_numpy(true_mean),
                     torch.from_numpy(true_var), ess=ess,
                     family_correction=family)
    assert isinstance(tc, MomentCheck)
    assert tc.passed == jc.passed
    np.testing.assert_allclose(tc.threshold, jc.threshold, rtol=1e-12)
    np.testing.assert_allclose(
        [tc.max_sigma_mean, tc.max_sigma_var],
        [jc.max_sigma_mean, jc.max_sigma_var], rtol=1e-4)
    np.testing.assert_allclose(tc.ess_min, jc.ess_min, rtol=1e-5)
    if shift >= 0.5:
        assert not tc.passed


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_importance_weight_ess_matches_jax(axis):
    lw = np.random.default_rng(4).normal(0.0, 2.0, (64, 5)).astype(
        np.float32)
    np.testing.assert_allclose(
        importance_weight_ess(torch.from_numpy(lw), axis=axis).numpy(),
        np.asarray(j_iw_ess(jnp.asarray(lw), axis=axis)), rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_moment_gate_repeats_the_float64_check_it_replaced(seed):
    """`chip_smoke.py` judged v's draws with a float64 reduction of the
    same formulas before the port had `moment_gate`, which reduces in
    float32 as the JAX package does. On draws of one window's size on the
    card (512 draws x 1024 chains of N(0, 9) with small chain offsets) the
    mean's z-score agrees to 1e-6 and the variance's to 1e-4 (relative):
    a printed z moves from its 7th or 5th significant digit on."""
    import math

    rng = np.random.default_rng(seed)
    x = (3.0 * rng.normal(size=(512, 1024))
         + 0.02 * rng.normal(size=(1, 1024))).astype(np.float32)
    xs = torch.from_numpy(x)[..., None]
    nm = x.size
    ess = float(effective_sample_size(xs)[0].clamp(2.0, nm))
    ess_v = float(effective_sample_size(xs * xs)[0].clamp(2.0, nm))
    flat = xs.reshape(-1).double()
    mean, var = float(flat.mean()), float(flat.var(correction=0))
    m4 = float(((flat - mean) ** 4).mean())
    z_mean = abs(mean) / math.sqrt(9.0 / ess)
    z_var = abs(var - 9.0) / math.sqrt(max(m4 - var * var, 162.0) / ess_v)
    check = moment_gate(xs, [0.0], [9.0], n_sigma=5.0)
    assert check.passed
    np.testing.assert_allclose(check.max_sigma_mean, z_mean, rtol=1e-6)
    np.testing.assert_allclose(check.max_sigma_var, z_var, rtol=1e-4)
