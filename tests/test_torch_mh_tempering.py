"""Random-walk MH, flow-independence MH and parallel tempering of the port
(`tpuflows_torch.mcmc.mh`, `.tempering`) against the JAX package's on the
same inputs, on the CPU.

The JAX samplers draw per step and per chain from split keys; the tests
derive those draws exactly as the JAX code does and hand them to the
port's math functions (`rwmh_transition_math`, `flow_imh_transition_math`)
and runs (`_rwmh_run`, `_flow_imh_run`, `_pt_run`, whose `draw(t)` gives
step t's draws), as `tests/test_torch_hmc.py` does for HMC:

  * single transitions of every chain: q, logp and the acceptance
    probability within rtol/atol 1e-5 and every accept decision equal (the
    flow proposal through a spline flow: within the spline oracles' own
    float32 agreement, atol 1e-4, `test_torch_coupling.JAX_BAR`);
  * short whole runs (RWMH 80 warmup + 20 draws, flow-IMH 60 draws, PT
    60 warmup + 40 draws at 4 temperatures): the adapted log scale(s), the
    proposal shape sigma, the draws and the per-draw info agree to 1e-5,
    with no accept or swap decision flipped by float32 rounding on these
    inputs (the only float32 differences are the order of the pooled
    means and the Robbins-Monro power, an ulp each);
  * `geometric_betas` (1e-6), one rung included;
  * the port's own samplers, drawing from a `torch.Generator`, on the
    JAX package's statistical checks (`tests/test_mh_tempering.py`):
    moments at its n_sigma, proposal-shape adaptation, the exact proposal
    always accepting, a bimodal target mixed by exchange, one rung being
    plain MH.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows.flows import Standardize as JStandardize
from tpuflows.mcmc import geometric_betas as j_betas
from tpuflows.mcmc import run_flow_imh as j_run_flow_imh
from tpuflows.mcmc import run_parallel_tempering as j_run_pt
from tpuflows.mcmc import run_rwmh as j_run_rwmh
from tpuflows.mcmc.mh import make_flow_imh_kernel as j_flow_imh_kernel
from tpuflows.mcmc.mh import make_rwmh_kernel as j_rwmh_kernel
from tpuflows import targets as JT

from tpuflows_torch import targets as T
from tpuflows_torch.diagnostics import moment_gate
from tpuflows_torch.flows import Standardize
from tpuflows_torch.mcmc import (geometric_betas, make_rwmh_kernel,
                                 run_flow_imh, run_parallel_tempering,
                                 run_rwmh)
from tpuflows_torch.mcmc.mh import (_flow_imh_run, _rwmh_run,
                                    flow_imh_transition_math,
                                    make_flow_imh_kernel,
                                    rwmh_transition_math)
from tpuflows_torch.mcmc.tempering import _pt_run
from tpuflows_torch.targets import std_normal_logpdf

from test_torch_coupling import JAX_BAR, carry, jax_arqs_flow

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(a):
    return torch.from_numpy(np.array(a))


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


TARGETS = {
    "banana": (JT.Banana(dim=2), T.Banana(dim=2)),
    "mixture": (JT.GaussianMixture.bimodal(dim=8, separation=6.0),
                T.GaussianMixture.bimodal(dim=8, separation=6.0,
                                          device="cpu")),
}


# ---------------------------------------------------------------------------
# the JAX samplers' draws
# ---------------------------------------------------------------------------
def key_draws(keys, d):
    """Per chain key: split into (proposal, acceptance); the normals
    (n, d) and uniforms (n,) of the MH transitions."""
    def one(k):
        k_prop, k_acc = jax.random.split(k)
        return (jax.random.normal(k_prop, (d,), jnp.float32),
                jax.random.uniform(k_acc))

    return jax.vmap(one)(keys)


def chain_draws(step_keys, n, d):
    """Per step key: split into n chain keys (`key_draws`); the normals
    (steps, n, d) and uniforms (steps, n), as `run_rwmh` and
    `run_flow_imh` draw them."""
    eps, u = jax.vmap(lambda sk: key_draws(jax.random.split(sk, n), d))(
        step_keys)
    return t(eps), t(u)


def rwmh_draws(key, n, d, num_warmup, num_samples):
    k_warm, k_sample = jax.random.split(key)
    eps_w, u_w = chain_draws(jax.random.split(k_warm, num_warmup), n, d)
    eps_s, u_s = chain_draws(jax.random.split(k_sample, num_samples), n, d)
    eps, u = torch.cat([eps_w, eps_s]), torch.cat([u_w, u_s])
    return lambda step: (eps[step], u[step])


def pt_draws(key, n_temps, n, d, num_warmup, num_samples):
    """Per step key: (move, swap), the move split into (proposal,
    acceptance), as `run_parallel_tempering` draws them."""
    def one(sk):
        k_move, k_swap = jax.random.split(sk)
        k_prop, k_acc = jax.random.split(k_move)
        return (jax.random.normal(k_prop, (n_temps, n, d), jnp.float32),
                jax.random.uniform(k_acc, (n_temps, n)),
                jax.random.uniform(k_swap, (n_temps, n)))

    k_warm, k_sample = jax.random.split(key)
    parts = [jax.vmap(one)(jax.random.split(k, s))
             for k, s in ((k_warm, num_warmup), (k_sample, num_samples))]
    eps, u_move, u_swap = (torch.cat([t(p[i]) for p in parts])
                           for i in range(3))
    return lambda step: (eps[step], u_move[step], u_swap[step])


def start(seed, n, d, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=(n, d))
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# random-walk MH
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,scale", [("banana", 1.5), ("banana", 0.4),
                                        ("mixture", 0.6)])
def test_rwmh_transition_matches_jax(name, scale):
    jt, tt = TARGETS[name]
    d = tt.dim
    n = 128
    q = start(1, n, d, 2.0)
    sigma = np.random.default_rng(2).uniform(0.5, 2.0, d).astype(np.float32)
    keys = jax.random.split(jax.random.key(3), n)
    logp = np.asarray(jax.vmap(jt.log_density)(q))
    kernel = jax.vmap(j_rwmh_kernel(jt.log_density),
                      in_axes=(0, 0, 0, None, None))
    jq, jlogp, jinfo = kernel(keys, q, logp, jnp.float32(scale), sigma)
    eps, u = key_draws(keys, d)
    tq, tlogp, tinfo = rwmh_transition_math(
        tt.log_density, t(q), t(logp), torch.tensor(scale), t(sigma),
        t(eps), t(u))
    np.testing.assert_array_equal(tinfo.accepted.numpy(),
                                  np.asarray(jinfo.accepted))
    assert 0 < int(tinfo.accepted.sum()) < n
    for a, b in ((tq, jq), (tlogp, jlogp), (tinfo.accept_prob,
                                            jinfo.accept_prob),
                 (tinfo.logp, jinfo.logp)):
        close(a, b)


@pytest.mark.parametrize("name", ["banana", "mixture"])
def test_rwmh_warmup_and_draws_match_jax(name):
    """80 warmup steps (Welford from step 12, sigma installed once its
    count passes 10) and 20 draws of 64 chains."""
    jt, tt = TARGETS[name]
    d, n, W, S = tt.dim, 64, 80, 20
    q0 = start(4, n, d)
    key = jax.random.key(5)
    jres = j_run_rwmh(key, jt.log_density, jnp.asarray(q0), num_warmup=W,
                      num_samples=S)
    tres = _rwmh_run(tt.log_density, t(q0), rwmh_draws(key, n, d, W, S),
                     W, S, 0.5, 0.234, True)
    np.testing.assert_array_equal(tres.info.accepted.numpy(),
                                  np.asarray(jres.info.accepted))
    close(tres.scale, jres.scale)
    close(tres.sigma, jres.sigma)
    assert not np.allclose(np.asarray(jres.sigma), 1.0)
    close(tres.samples, jres.samples)
    close(tres.info.accept_prob, jres.info.accept_prob)
    close(tres.info.logp, jres.info.logp)


def test_rwmh_without_shape_adaptation_matches_jax():
    jt, tt = TARGETS["banana"]
    n, W, S = 32, 40, 10
    q0 = start(6, n, 2)
    key = jax.random.key(7)
    jres = j_run_rwmh(key, jt.log_density, jnp.asarray(q0), num_warmup=W,
                      num_samples=S, initial_scale=1.0, target_accept=0.3,
                      adapt_shape=False)
    tres = _rwmh_run(tt.log_density, t(q0), rwmh_draws(key, n, 2, W, S),
                     W, S, 1.0, 0.3, False)
    np.testing.assert_array_equal(tres.sigma.numpy(), np.ones(2))
    close(tres.scale, jres.scale)
    close(tres.samples, jres.samples)


# ---------------------------------------------------------------------------
# flow-independence MH
# ---------------------------------------------------------------------------
def imh_flows(kind):
    """(JAX flow, port flow, bar): an identity Standardize, or
    Standardize + an affine and a spline coupling with non-zero last
    layers (the spline through the oracles on both sides)."""
    if kind == "identity":
        return (JStandardize.identity(8), Standardize.identity(8),
                TOL)
    jf = jax_arqs_flow(11, d=8, n_blocks=1, scale=0.3)
    return jf, carry(jf, use_pallas=False), JAX_BAR


@pytest.mark.parametrize("kind", ["identity", "arqs"])
def test_flow_imh_transition_matches_jax(kind):
    jt, tt = TARGETS["mixture"]
    jf, tf, bar = imh_flows(kind)
    n, d = 96, 8
    q = start(8, n, d, 1.5)
    keys = jax.random.split(jax.random.key(9), n)
    transition, j_log_q = j_flow_imh_kernel(jt.log_density, jf, d)
    logp = np.asarray(jax.vmap(jt.log_density)(q))
    logq = np.asarray(jax.vmap(j_log_q)(q))
    _, t_log_q = make_flow_imh_kernel(tt.log_density, tf, d)
    close(t_log_q(t(q)), logq, bar)
    jq, jlogp, jlogq, jinfo = jax.vmap(transition)(keys, q, logp, logq)
    z, u = key_draws(keys, d)
    tq, tlogp, tlogq, tinfo = flow_imh_transition_math(
        tt.log_density, tf, t(q), t(logp), t(logq), t(z), t(u))
    np.testing.assert_array_equal(tinfo.accepted.numpy(),
                                  np.asarray(jinfo.accepted))
    assert 0 < int(tinfo.accepted.sum()) < n
    for a, b in ((tq, jq), (tlogp, jlogp), (tlogq, jlogq),
                 (tinfo.accept_prob, jinfo.accept_prob)):
        close(a, b, bar)


def test_flow_imh_run_matches_jax():
    jt, tt = TARGETS["mixture"]
    jf, tf, bar = imh_flows("arqs")
    n, d, S = 32, 8, 60
    q0 = start(10, n, d)
    key = jax.random.key(11)
    jres = j_run_flow_imh(key, jt.log_density, jf, jnp.asarray(q0),
                          num_samples=S)
    z, u = chain_draws(jax.random.split(key, S), n, d)
    tres = _flow_imh_run(tt.log_density, tf, t(q0),
                         lambda s: (z[s], u[s]), S)
    np.testing.assert_array_equal(tres.info.accepted.numpy(),
                                  np.asarray(jres.info.accepted))
    close(tres.samples, jres.samples, bar)
    close(tres.info.accept_prob, jres.info.accept_prob, bar)
    close(tres.scale, jres.scale)
    close(tres.sigma, jres.sigma)


# ---------------------------------------------------------------------------
# parallel tempering
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_temps,beta_min", [(1, 0.01), (2, 0.01),
                                              (8, 0.01), (6, 0.02)])
def test_geometric_betas_match_jax(n_temps, beta_min):
    b = geometric_betas(n_temps, beta_min, device="cpu")
    assert b.dtype == torch.float32 and b.shape == (n_temps,)
    close(b, j_betas(n_temps, beta_min), dict(rtol=1e-6, atol=0))
    assert float(b[-1]) == 1.0


@pytest.mark.parametrize("W,S", [(0, 1), (0, 2), (60, 40)])
def test_parallel_tempering_matches_jax(W, S):
    """4 temperatures x 48 chains on the 8-d bimodal mixture, from one
    mode. (0, 1) and (0, 2) are single steps at parity 0 and 1."""
    jt, tt = TARGETS["mixture"]
    n, d = 48, 8
    jbetas = j_betas(4, 0.05)
    q0 = start(12, n, d) + np.float32(3.0)
    key = jax.random.key(13)
    jres = j_run_pt(key, jt.log_density, jnp.asarray(q0), jbetas,
                    num_warmup=W, num_samples=S)
    tres = _pt_run(tt.log_density, std_normal_logpdf, t(q0),
                   geometric_betas(4, 0.05, device="cpu"),
                   pt_draws(key, 4, n, d, W, S), W, S, 0.5, 0.234)
    close(tres.scales, jres.scales)
    close(tres.betas, jres.betas, dict(rtol=1e-6, atol=0))
    close(tres.samples, jres.samples)
    for a, b in zip(tres.info, jres.info):
        close(a, b)
    assert tres.info.swap_accept.shape == (S, 3)
    assert float(tres.info.swap_accept.sum()) > 0


def test_parallel_tempering_with_a_reference_density_matches_jax():
    """log_ref given (a wider normal); 20 warmup steps and 10 draws."""
    jt, tt = TARGETS["banana"]
    n, W, S = 40, 20, 10
    q0 = start(14, n, 2)
    key = jax.random.key(15)

    def j_ref(x):
        return -0.5 * jnp.sum((x / 3.0) ** 2, axis=-1)

    def t_ref(x):
        return -0.5 * torch.sum((x / 3.0) ** 2, dim=-1)

    jres = j_run_pt(key, jt.log_density, jnp.asarray(q0), j_betas(3),
                    num_warmup=W, num_samples=S, log_ref=j_ref)
    tres = _pt_run(tt.log_density, t_ref, t(q0),
                   geometric_betas(3, device="cpu"),
                   pt_draws(key, 3, n, 2, W, S), W, S, 0.5, 0.234)
    close(tres.scales, jres.scales)
    close(tres.samples, jres.samples)
    close(tres.info.swap_accept, jres.info.swap_accept)


# ---------------------------------------------------------------------------
# the port's own samplers on the JAX package's statistical checks
# ---------------------------------------------------------------------------
def gen(seed):
    return torch.Generator().manual_seed(seed)


def test_rwmh_standard_normal_moments():
    tt = T.StandardNormal(dim=3)
    q0 = torch.randn((64, 3), generator=gen(0))
    res = run_rwmh(gen(1), tt.log_density, q0, num_warmup=600,
                   num_samples=800)
    assert res.samples.shape == (800, 64, 3)
    check = moment_gate(res.samples, tt.mean("cpu"),
                        torch.diagonal(tt.cov("cpu")), n_sigma=3.5)
    assert check.passed, check
    assert 0.1 < float(torch.mean(res.info.accept_prob)) < 0.5


def test_rwmh_shape_adaptation():
    stds = torch.tensor([0.1, 1.0, 10.0])
    tt = T.DiagNormal(torch.zeros(3), stds)
    q0 = tt.sample(gen(0), 64, device="cpu")
    res = run_rwmh(gen(1), tt.log_density, q0, num_warmup=800,
                   num_samples=200)
    ratio = res.sigma / stds
    assert torch.all(ratio > 0.5) and torch.all(ratio < 2.0)


def test_rwmh_kernel_draws_its_own_randomness():
    tt = T.Banana(dim=2)
    kernel = make_rwmh_kernel(tt.log_density)
    q = torch.zeros(16, 2)
    lp = tt.log_density(q)
    a = kernel(gen(3), q, lp, torch.tensor(0.5), torch.ones(2))
    b = kernel(gen(3), q, lp, torch.tensor(0.5), torch.ones(2))
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    assert a[0].shape == (16, 2) and a[2].accepted.dtype == torch.bool


def test_flow_imh_exact_proposal_always_accepts():
    tt = T.StandardNormal(dim=4)
    q0 = torch.randn((32, 4), generator=gen(0))
    res = run_flow_imh(gen(1), tt.log_density, Standardize.identity(4), q0,
                       num_samples=300)
    assert float(torch.mean(res.info.accepted.float())) > 0.999
    check = moment_gate(res.samples, tt.mean("cpu"),
                        torch.diagonal(tt.cov("cpu")), n_sigma=3.5)
    assert check.passed, check


def test_parallel_tempering_mixes_bimodal():
    tt = T.GaussianMixture.bimodal(dim=2, separation=8.0, scale=0.5,
                                   device="cpu")
    q0 = torch.zeros((32, 2)) + 4.0  # every chain in one mode
    res = run_parallel_tempering(gen(0), tt.log_density, q0,
                                 geometric_betas(6, 0.02, device="cpu"),
                                 num_warmup=500, num_samples=1000)
    assert res.samples.shape == (1000, 32, 2)
    frac_pos = float(torch.mean((res.samples[..., 0] > 0).float()))
    assert 0.25 < frac_pos < 0.75, frac_pos
    assert float(torch.min(torch.mean(res.info.swap_accept, 0))) > 0.05
    check = moment_gate(res.samples, tt.mean("cpu"),
                        torch.diagonal(tt.cov("cpu")), n_sigma=4.0)
    assert check.max_sigma_mean < 4.0, check


def test_parallel_tempering_single_temperature_is_rwmh():
    tt = T.StandardNormal(dim=2)
    q0 = torch.randn((64, 2), generator=gen(0))
    res = run_parallel_tempering(gen(1), tt.log_density, q0,
                                 geometric_betas(1, device="cpu"),
                                 num_warmup=400, num_samples=600)
    assert res.info.swap_accept.shape == (600, 0)
    check = moment_gate(res.samples, tt.mean("cpu"),
                        torch.diagonal(tt.cov("cpu")), n_sigma=3.5)
    assert check.passed, check
