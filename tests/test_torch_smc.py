"""Annealed SMC of the port (`tpuflows_torch.smc`) against the JAX
package's (`tpuflows.smc`) on the same inputs and the same draws, on the
CPU:

  * `SMCConfig` and `SMCResult`: the JAX package's fields and defaults;
  * `systematic_indices` with the JAX draw's uniform replayed
    (`systematic_indices_math`): every index equal except where a
    position lies within 1e-6 of an edge of the JAX weights' CDF (the two
    cumulative sums may round apart); `normalize_log_weights` and
    `relative_ess` to 1e-5 relative, `resample` and `multinomial_indices`
    on their own checks;
  * `next_beta` within 1e-6 of the JAX value, from beta = 0 and from
    beta > 0, and exactly 1 where even beta = 1 clears the target;
  * `_hmc_sweep` and one stage at d = 18 and n = 256 on the hierarchical
    target through two affine flows (the path's q0 and another one as
    preconditioner), with every JAX draw replayed (the key splits of
    `sampler.py:206`, `:268-273` and `:170`): `log_z_inc`, `rel_ess` and
    the weights to 1e-5 relative, beta_new within 1e-6, the same
    resampling decision and the same ancestors, particles to 1e-4, with
    the stage resampling and not, and mutating in the latent space and
    in the data space. The acceptance probabilities agree to 1e-4
    absolute, not 1e-5: the energies (of order 50) differ by a few
    float32 ulps, since torch's and XLA's exp and matmul round apart (the
    latent gradient by 1e-4 relative). So the mean acceptance and the
    adapted step size are held to 1e-4, and accept decisions are equal
    wherever |u - acc_p| >= 1e-4. The same differences grow along
    trajectories through the two flows: after a second latent sweep a few
    particles differ by 1e-3 (measured), so the latent stages run one
    sweep and the data-space stage three (5e-5 apart);
  * the path switch, the cross-fitted switch and the final resample
    against the JAX formulas (`sampler.py:412-447`, `:612-620`) on the
    same inputs;
  * `smc_measured_ess` equal to the JAX function's on a given result;
  * `run_smc`: a run cut after two stages and resumed from its `smc_2`
    checkpoint equals the uninterrupted run to the bit; a "freeze"
    retrain leaves the path's q0 flow (the caller's) unchanged; an
    unknown retrain mode is refused.

The whole runs on the hierarchical target against the JAX package's are in
`tests/test_torch_smc_runs.py`.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows.diagnostics import importance_weight_ess as j_kish
from tpuflows.flows import build_flow as j_build_flow
from tpuflows.smc import next_beta as j_next_beta
from tpuflows.smc import normalize_log_weights as j_normalize
from tpuflows.smc import relative_ess as j_relative_ess
from tpuflows.smc import sampler as jsampler
from tpuflows.smc import systematic_indices as j_systematic
from tpuflows.targets import HierarchicalGaussian as JHier

from tpuflows_torch.flows import build_flow
from tpuflows_torch.smc import (SMCConfig, SMCResult, multinomial_indices,
                                next_beta, normalize_log_weights,
                                relative_ess, resample, run_smc,
                                smc_measured_ess, systematic_indices)
from tpuflows_torch.smc import sampler
from tpuflows_torch.smc.resample import systematic_indices_math
from tpuflows_torch.targets import DiagNormal, HierarchicalGaussian

from test_torch_coupling import carry

REL = dict(rtol=1e-5, atol=1e-5)


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
                               **(tol or REL))


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------
def test_config_and_result_match_jax():
    assert SMCConfig._fields == jsampler.SMCConfig._fields
    assert SMCConfig() == jsampler.SMCConfig()
    assert SMCResult._fields == jsampler.SMCResult._fields


# ---------------------------------------------------------------------------
# resampling and annealing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,n_out,scale,seed", [
    (4, None, 1.0, 0), (512, None, 1.0, 1), (512, None, 5.0, 2),
    (257, 1024, 2.0, 3), (1000, 500, 0.1, 4)])
def test_systematic_indices_replay_jax(n, n_out, scale, seed):
    key = jax.random.key(seed)
    log_w = scale * np.random.default_rng(seed).normal(size=n)
    log_w = log_w.astype(np.float32)
    want = np.asarray(j_systematic(key, jnp.asarray(log_w), n_out))
    u0 = jax.random.uniform(key, ())
    got = systematic_indices_math(t(u0), t(log_w), n_out).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    # positions within 1e-6 of an edge of the JAX CDF may fall either side
    w = np.exp(np.asarray(j_normalize(jnp.asarray(log_w))))
    cdf = np.cumsum(w, dtype=np.float64)
    cdf /= cdf[-1]
    m = n if n_out is None else n_out
    pos = (float(u0) + np.arange(m)) / m
    near = np.min(np.abs(pos[:, None] - cdf[None, :]), axis=1) < 1e-6
    assert np.array_equal(got[~near], want[~near])
    assert (~near).sum() >= m // 2


def test_normalize_and_relative_ess_match_jax():
    lw = (3.0 * np.random.default_rng(5).normal(size=300)).astype(np.float32)
    close(normalize_log_weights(t(lw)), j_normalize(jnp.asarray(lw)))
    close(relative_ess(t(lw)), j_relative_ess(jnp.asarray(lw)))


def test_resample_and_multinomial():
    """The JAX package's checks (`tests/test_smc.py`): offspring counts
    are floor or ceil of n w, a fixed generator state gives the same
    draw, heavy particles appear; the multinomial draw is in range."""
    log_w = torch.log(torch.tensor([0.5, 0.25, 0.125, 0.125]))
    idx = systematic_indices(torch.Generator().manual_seed(0), log_w)
    counts = torch.bincount(idx.long(), minlength=4)
    assert torch.all(torch.abs(counts - 4 * torch.exp(log_w)) <= 1.0)

    x = torch.randn((128, 3), generator=torch.Generator().manual_seed(2))
    log_w = torch.randn(128, generator=torch.Generator().manual_seed(3))
    x1, i1 = resample(torch.Generator().manual_seed(1), x, log_w)
    x2, i2 = resample(torch.Generator().manual_seed(1), x, log_w)
    assert torch.equal(i1, i2) and torch.equal(x1, x[i1.long()])
    assert x1.shape == x.shape
    assert int(torch.sum(i1 == torch.argmax(log_w))) >= 1
    im = multinomial_indices(torch.Generator().manual_seed(4), log_w)
    assert im.dtype == torch.int32 and bool(((im >= 0) & (im < 128)).all())
    _, im2 = resample(torch.Generator().manual_seed(4), x, log_w,
                      scheme="multinomial")
    assert torch.equal(im, im2)
    with pytest.raises(ValueError, match="unknown resampling scheme"):
        resample(torch.Generator(), x, log_w, scheme="residual")


@pytest.mark.parametrize("beta,scale,target,seed", [
    (0.0, 5.0, 0.5, 0), (0.0, 40.0, 0.8, 1), (0.37, 12.0, 0.8, 2),
    (0.9, 0.5, 0.5, 3), (0.0, 1e-3, 0.5, 4)])
def test_next_beta_matches_jax(beta, scale, target, seed):
    lr = (scale * np.random.default_rng(seed).normal(size=1024)
          ).astype(np.float32)
    want = float(j_next_beta(beta, jnp.asarray(lr), target))
    got = next_beta(beta, t(lr), target)
    assert got.dtype == torch.float32 and got.ndim == 0
    assert abs(float(got) - want) < 1e-6
    if want < 1.0:
        # the bisection lands on the ESS target
        assert abs(float(relative_ess((float(got) - beta) * t(lr)))
                   - target) < 0.01
    else:
        assert float(got) == 1.0


def test_next_beta_is_one_for_flat_ratios():
    assert float(next_beta(0.0, torch.zeros(16), 0.5)) == 1.0
    assert float(j_next_beta(0.0, jnp.zeros(16), 0.5)) == 1.0


# ---------------------------------------------------------------------------
# the mutation and the stage, with the JAX draws replayed
# ---------------------------------------------------------------------------
D, N = 18, 256


def hierarchical_flows(d=D, hidden=(32, 32), epochs=(20, 5)):
    """The hierarchical target in both packages, and two affine
    leading-mask flows (c5's family): q0, pretrained on prior draws, and
    a preconditioner fitted a little further on posterior draws."""
    import optax

    from tpuflows.flows import optimize_flow as j_fit

    jt = JHier.standard(dim=d)
    prior = jt.sample_prior(jax.random.key(0), 2048)
    jf = j_build_flow(prior, jax.random.key(1), kind="affine", n_blocks=2,
                      hidden=hidden, mask_scheme="leading", n_leading=2,
                      clamp=8.0)
    jq0 = j_fit(jax.random.key(2), prior, jf, optax.adam(2e-3), nbatches=8,
                nepochs=epochs[0]).result
    post = jt.sample(jax.random.key(3), 2048)
    jpre = j_fit(jax.random.key(4), post, jq0, optax.adam(2e-3), nbatches=8,
                 nepochs=epochs[1]).result
    tt = HierarchicalGaussian.standard(dim=d, device="cpu")
    return jt, tt, (jq0, carry(jq0)), (jpre, carry(jpre))


@pytest.fixture(scope="module")
def setup():
    return hierarchical_flows()


def sweep_draws(key, n, d):
    """One sweep's per-particle draws as the JAX stage derives them:
    split(key, n) per particle, then `_hmc_sweep`'s split(kk, 1) and its
    split into the momentum and acceptance keys."""
    def one(kk):
        (k,) = jax.random.split(kk, 1)
        k_mom, k_acc = jax.random.split(k)
        return (jax.random.normal(k_mom, (d,), jnp.float32),
                jax.random.uniform(k_acc))

    return jax.vmap(one)(jax.random.split(key, n))


def test_hmc_sweep_matches_jax(setup):
    jt, tt, (jq0, tq0), (jpre, tpre) = setup
    beta = 0.4

    def j_latent(z):
        x, ladj = jpre.inverse_and_ladj(z)
        return ((1 - beta) * jsampler._flow_log_q(jq0, x)
                + beta * jt.log_density(x) + ladj)

    def t_latent(z):
        x, ladj = tpre.inverse_and_ladj(z)
        return ((1 - beta) * sampler._flow_log_q(tq0, x)
                + beta * tt.log_density(x) + ladj)

    z = np.asarray(jpre.forward(jt.sample(jax.random.key(5), N)))
    inv_mass = np.var(z, axis=0).astype(np.float32)
    eps = 0.3
    key = jax.random.key(6)
    keys = jax.random.split(key, N)
    jz, jacc = jax.vmap(lambda kk, q: jsampler._hmc_sweep(
        kk, q, j_latent, eps, jnp.asarray(inv_mass), 1, 8))(keys,
                                                            jnp.asarray(z))
    normals, u = sweep_draws(key, N, D)
    from tpuflows_torch.mcmc.hmc import value_and_grad

    tz, tacc = sampler._hmc_sweep_math(
        t(z), value_and_grad(t_latent), torch.tensor(eps), t(inv_mass), 8,
        t(normals)[None], t(u)[None])
    close(tacc, jacc, rtol=0, atol=1e-4)
    u, ja, ta = np.asarray(u), np.asarray(jacc), tacc.numpy()
    clear = np.abs(u - ja) >= 1e-4
    assert np.array_equal((u < ja)[clear], (u < ta)[clear])
    assert 0.2 < ta.mean() < 1.0 and (u >= ta).any()  # some rejected
    close(tz[clear], np.asarray(jz)[clear], rtol=1e-4, atol=1e-4)


def test_hmc_sweep_draws_from_the_generator():
    """`_hmc_sweep` is `_hmc_sweep_math` on the generator's normals, then
    its uniforms, with autograd's gradient; two sweeps on a Gaussian."""
    from tpuflows_torch.mcmc.hmc import value_and_grad

    def logp(x):
        return -0.5 * torch.sum(x * x, dim=-1)

    q = torch.randn((64, 3), generator=torch.Generator().manual_seed(0))
    inv_mass = torch.tensor([1.0, 0.5, 2.0])
    got = sampler._hmc_sweep(torch.Generator().manual_seed(1), q, logp,
                             0.3, inv_mass, 2, 4)
    g = torch.Generator().manual_seed(1)
    normals = torch.randn((2, 64, 3), generator=g)
    u = torch.rand((2, 64), generator=g)
    want = sampler._hmc_sweep_math(q, value_and_grad(logp), 0.3, inv_mass,
                                   4, normals, u)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1].shape == (64,) and 0.5 < float(got[1].mean()) <= 1.0


def stage_inputs(jt, jq0, log_w_scale, seed):
    rng = np.random.default_rng(seed)
    x = jt.sample(jax.random.key(seed), N) + 0.5 * jnp.asarray(
        rng.normal(size=(N, D)), jnp.float32)
    log_q0 = jsampler._flow_log_q(jq0, x)
    log_w = jnp.asarray(log_w_scale * rng.normal(size=N), jnp.float32)
    anc = jnp.asarray(rng.permutation(N), jnp.int32)
    return x, log_w, log_q0, anc


@pytest.mark.parametrize("case", ["latent", "latent_resample", "data_space"])
def test_stage_matches_jax(setup, case):
    jt, tt, (jq0, tq0), (jpre, tpre) = setup
    cfg = SMCConfig(n_particles=N, n_leapfrog=8,
                    n_mutation_steps=(3 if case == "data_space" else 1),
                    target_rel_ess=0.8,
                    latent_mutation=(case != "data_space"))
    jcfg = jsampler.SMCConfig(**cfg._asdict())
    x, log_w, log_q0, anc = stage_inputs(
        jt, jq0, 2.0 if case == "latent_resample" else 0.0, seed=7)
    beta, eps = 0.05, 0.2
    key = jax.random.key(8)
    jstage = jax.jit(jsampler._make_stage(jt.log_density, jcfg, N))
    jout = jstage(key, x, log_w, log_q0, anc, jnp.float32(beta),
                  jnp.float32(eps), jq0, jpre)

    # the stage's draws, as `_make_stage` splits its key
    k_resample, k_mutate = jax.random.split(key)
    u0 = jax.random.uniform(k_resample, ())
    draws = [sweep_draws(k, N, D)
             for k in jax.random.split(k_mutate, cfg.n_mutation_steps)]
    tout = sampler._stage_math(
        tt.log_density, cfg, t(x), t(log_w), t(log_q0), t(anc),
        torch.tensor(beta), torch.tensor(eps), tq0, tpre, t(u0),
        lambda s: (t(draws[s][0]), t(draws[s][1])))

    (tx, tlw, tlq, tanc, tbeta, teps, tinc, tvar, tress, tacc) = tout
    (jx, jlw, jlq, janc, jbeta, jeps, jinc, jvar, jress, jacc) = jout
    assert abs(float(tbeta) - float(jbeta)) < 1e-6
    assert 0.0 < float(tbeta) < 1.0
    resampled = bool(float(jress) < cfg.resample_threshold)
    assert resampled == (case == "latent_resample")
    assert bool(tress < cfg.resample_threshold) == resampled
    assert np.array_equal(tanc.numpy(), np.asarray(janc))
    assert tanc.dtype == torch.int32
    for a, b in ((tinc, jinc), (tress, jress), (tvar, jvar), (tlw, jlw)):
        close(a, b)
    close(tacc, jacc, rtol=0, atol=1e-4)
    close(teps, jeps, rtol=1e-4, atol=0)
    close(tx, jx, rtol=1e-4, atol=1e-4)
    close(tlq, jlq, rtol=1e-5, atol=1e-3)


# ---------------------------------------------------------------------------
# path switches and the final resample, against the JAX formulas
# ---------------------------------------------------------------------------
def j_switch_terms(lw, dlw):
    lse = jax.scipy.special.logsumexp(lw)
    inc = jax.scipy.special.logsumexp(lw + dlw) - lse
    wn = jnp.exp(lw - lse)
    rr = jnp.exp(dlw - jnp.max(dlw))
    zhat = jnp.sum(wn * rr)
    return inc, jnp.sum((wn * (rr - zhat)) ** 2) / (zhat * zhat)


def test_path_switches_match_jax(setup):
    jt, tt, (jq0, tq0), (jpre, tpre) = setup
    x, log_w, log_q0, anc = stage_inputs(jt, jq0, 1.0, seed=9)
    beta = 0.3
    # run_smc's path_switch (sampler.py:412-422)
    log_q0_new = jsampler._flow_log_q(jpre, x)
    dlw = (1.0 - beta) * (log_q0_new - log_q0)
    inc, var = j_switch_terms(log_w, dlw)
    got = sampler._path_switch(tpre, t(x), t(log_w), t(log_q0),
                               torch.tensor(beta))
    for a, b in zip(got, (log_w + dlw, log_q0_new, inc, var)):
        close(a, b, rtol=1e-5, atol=1e-4)

    # cross_fit_switch (sampler.py:431-447)
    key = jax.random.key(10)
    xk, lwk, lqk, anck = x[1::2], log_w[1::2], log_q0[1::2], anc[1::2]
    lq_new = jsampler._flow_log_q(jpre, xk)
    dlw = (1.0 - beta) * (lq_new - lqk)
    inc, var = j_switch_terms(lwk, dlw)
    idx = j_systematic(key, lwk + dlw, n_out=N)
    u0 = jax.random.uniform(key, ())
    got = sampler._cross_fit_switch_math(tpre, t(u0), t(x), t(log_w),
                                         t(log_q0), t(anc),
                                         torch.tensor(beta))
    assert np.array_equal(got[3].numpy(), np.asarray(anck[idx]))
    close(got[0], xk[idx])
    assert not bool(got[1].any())
    close(got[2], lq_new[idx], rtol=1e-5, atol=1e-4)
    close(got[4], inc)
    close(got[5], var)


def test_finalize_matches_jax():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(N, 3)).astype(np.float32)
    log_w = (2.0 * rng.normal(size=N)).astype(np.float32)
    anc = rng.integers(0, N, N).astype(np.int32)
    key = jax.random.key(12)
    idx = j_systematic(key, jnp.asarray(log_w))
    tx, tanc, kish, uniq = sampler._finalize_math(
        t(jax.random.uniform(key, ())), t(x), t(log_w), t(anc))
    assert np.array_equal(tx.numpy(), x[np.asarray(idx)])
    assert np.array_equal(tanc.numpy(), anc[np.asarray(idx)])
    close(kish, j_kish(jnp.asarray(log_w)))
    assert int(uniq) == np.unique(anc[np.asarray(idx)]).size


@pytest.mark.parametrize("uniq,kish", [(300, 812.5), (900, 410.25),
                                       (64, float("nan"))])
def test_measured_ess_matches_jax(uniq, kish):
    common = dict(log_z=0.0, betas=None, ess_hist=None, accept_hist=None,
                  n_stages=3, flow=None, final_kish_ess=kish,
                  unique_ancestors=uniq)
    jres = jsampler.SMCResult(particles=None, log_weights=None, **common)
    tres = SMCResult(particles=None, log_weights=None, **common)
    want = jsampler.smc_measured_ess(jres)
    assert smc_measured_ess(tres) == want
    assert want == (uniq if kish != kish else min(uniq, kish))


# ---------------------------------------------------------------------------
# run_smc: resume, the freeze retrain, refusals
# ---------------------------------------------------------------------------
RESUME = dict(n_particles=512, n_mutation_steps=2, n_leapfrog=3,
              target_rel_ess=0.9, max_stages=40, retrain_every=2,
              retrain_epochs=3, retrain_batches=4)


def small_problem(d=2):
    target = DiagNormal(loc=torch.tensor([1.0, -1.0]),
                        scale=torch.tensor([0.5, 2.0]))
    init = torch.randn((256, d), generator=torch.Generator().manual_seed(0))
    flow = build_flow(init, torch.Generator().manual_seed(1), kind="affine",
                      n_blocks=2, hidden=(8,), device="cpu")
    return target, flow


def params(flow):
    return [p.detach().clone() for p in flow.parameters()]


@pytest.mark.parametrize("mode", ["freeze", "reweight"])
def test_resume_equals_the_uninterrupted_run(tmp_path, mode):
    """Cut after stage 2 (max_stages=2 saves smc_1 and smc_2, then
    finishes), resume from smc_2 with the full config: every result equal
    to the bit, both flows included."""
    cfg = SMCConfig(**RESUME, retrain_mode=mode,
                    final_equilibration_stages=1)
    target, flow = small_problem()
    ref = run_smc(torch.Generator().manual_seed(2), target.log_density,
                  copy.deepcopy(flow), 2, cfg, device="cpu")
    ckpt = str(tmp_path / "smc")
    run_smc(torch.Generator().manual_seed(2), target.log_density,
            copy.deepcopy(flow), 2, cfg._replace(max_stages=2),
            checkpoint_dir=ckpt, device="cpu")
    res = run_smc(torch.Generator().manual_seed(99), target.log_density,
                  copy.deepcopy(flow), 2, cfg, checkpoint_dir=ckpt,
                  device="cpu")
    assert ref.n_stages > 3 and res.n_stages == ref.n_stages
    assert float(res.betas[-1]) == 1.0
    for name in ("particles", "log_z", "betas", "ess_hist", "accept_hist",
                 "log_z_sigma", "ancestors"):
        assert torch.equal(getattr(res, name), getattr(ref, name)), name
    assert res.unique_ancestors == ref.unique_ancestors
    assert res.final_kish_ess == ref.final_kish_ess
    for a, b in zip(params(res.flow), params(ref.flow)):
        assert torch.equal(a, b)


def test_freeze_retrain_leaves_the_path_endpoint():
    """Under "freeze" the caller's flow is the path's q0: training is in
    place, so `run_smc` must retrain a copy. The caller's flow keeps its
    parameters across every retrain, and the result's flow is the
    retrained one."""
    cfg = SMCConfig(**{**RESUME, "retrain_every": 1})
    target, flow = small_problem()
    before = params(flow)
    calls = []
    fit = sampler.optimize_flow

    def spy(generator, samples, f, *args, **kwargs):
        assert f is not flow
        calls.append(1)
        return fit(generator, samples, f, *args, **kwargs)

    sampler.optimize_flow = spy
    try:
        res = run_smc(torch.Generator().manual_seed(3), target.log_density,
                      flow, 2, cfg, device="cpu")
    finally:
        sampler.optimize_flow = fit
    assert len(calls) >= 2
    for a, b in zip(params(flow), before):
        assert torch.equal(a, b)
    assert res.flow is not flow
    assert any(not torch.equal(a, b)
               for a, b in zip(params(res.flow), before))


def test_unknown_retrain_mode_is_refused():
    target, flow = small_problem()
    with pytest.raises(ValueError, match="retrain_mode"):
        run_smc(torch.Generator(), target.log_density, flow, 2,
                SMCConfig(retrain_mode="refit"), device="cpu")
