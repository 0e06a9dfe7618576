"""The portable HMC (`tpuflows_torch.mcmc.hmc`) against the JAX package's
`tpuflows.mcmc.hmc` on the same numpy inputs, on the CPU.

  * `kinetic`, `energy` and `leapfrog` on a batch against the JAX functions
    vmapped over it (1e-6: the same float32 formulas, up to the order of
    one sum);
  * `make_hmc_kernel` against `jax.vmap(make_hmc_kernel(...))` on a
    flow-preconditioned funnel at d = 8 (Standardize + one affine coupling
    with a non-zero last layer, carried across by `flow_from_jax_params`),
    10 leapfrogs, with the JAX kernel's own draws replayed: per chain key
    `k_mom, k_acc = split(key)`, p0 = normal(k_mom) / sqrt(inv_mass) and
    u = uniform(k_acc), fed to `hmc_transition_math`. Its gradient comes
    from autograd, from the port's K3 hook (its plain version on the CPU)
    and, on the raw funnel, from autograd alone; pooled and per-chain step
    sizes. Every chain takes the JAX package's accept decision; q, logp
    and energy agree to 1e-5 (absolute and relative: float32 rounding
    carried through 10 leapfrogs);
  * the transition's own draws (`make_hmc_kernel(...)(generator, ...)`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows.mcmc.hmc import PhasePoint as JPhasePoint
from tpuflows.mcmc.hmc import energy as j_energy
from tpuflows.mcmc.hmc import kinetic as j_kinetic
from tpuflows.mcmc.hmc import leapfrog as j_leapfrog
from tpuflows.mcmc.hmc import make_hmc_kernel as j_make_hmc
from tpuflows.mcmc.preconditioned import flow_reparameterized as j_reparam
from tpuflows.targets import NealsFunnel as JFunnel

from tpuflows_torch.kernels.fused_logp_cuda import fused_latent_logp_and_grad
from tpuflows_torch.mcmc import (PhasePoint, energy, flow_reparameterized,
                                 kinetic, leapfrog, make_hmc_kernel)
from tpuflows_torch.mcmc.hmc import hmc_transition_math, value_and_grad
from tpuflows_torch.targets import NealsFunnel

from test_torch_nuts import flow_leaves, jax_flow, torch_flow

D, N, STEPS = 8, 64, 10
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, n=N, d=D, q_scale=0.8):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return ((q_scale * rng.normal(size=(n, d))).astype(f32),
            rng.normal(size=(n, d)).astype(f32),
            (0.5 + rng.random(d)).astype(f32))


def test_kinetic_energy_and_leapfrog_match_jax():
    jf = jax_flow(flow_leaves(0))
    tf = torch_flow(jf)
    jlogp = j_reparam(JFunnel(dim=D).log_density, jf)
    tlogp = flow_reparameterized(NealsFunnel(dim=D).log_density, tf)
    q, p, im = _inputs(1)
    jvg = jax.vmap(jax.value_and_grad(jlogp))
    lp, g = (np.array(a) for a in jvg(jnp.asarray(q)))
    np.testing.assert_allclose(
        kinetic(torch.from_numpy(p), torch.from_numpy(im)).numpy(),
        np.asarray(jax.vmap(j_kinetic, (0, None))(p, im)), rtol=1e-6)
    jz = JPhasePoint(*(jnp.asarray(a) for a in (q, p, lp, g)))
    tz = PhasePoint(*(torch.from_numpy(a) for a in (q, p, lp, g)))
    np.testing.assert_allclose(
        energy(tz, torch.from_numpy(im)).numpy(),
        np.asarray(jax.vmap(j_energy, (0, None))(jz, im)), rtol=1e-6)
    eps = np.float32(-0.3)  # signed: a step backwards
    jn = jax.vmap(lambda z: j_leapfrog(jax.value_and_grad(jlogp), z, eps,
                                       jnp.asarray(im)))(jz)
    tn = leapfrog(value_and_grad(tlogp), tz, torch.tensor(eps),
                  torch.from_numpy(im))
    for a, b in zip(tn, jn):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def jax_hmc_draws(keys, d, inv_mass):
    """The momenta and uniforms `make_hmc_kernel`'s transition draws."""
    def derive(k):
        k_mom, k_acc = jax.random.split(k)
        p0 = jax.random.normal(k_mom, (d,), jnp.float32) / jnp.sqrt(inv_mass)
        return p0, jax.random.uniform(k_acc)

    return [np.array(a) for a in jax.vmap(derive)(keys)]


def _run_both(seed, eps, hook, preconditioned=True, q_scale=0.8):
    jf = jax_flow(flow_leaves(seed))
    tf = torch_flow(jf)
    if preconditioned:
        jlogp = j_reparam(JFunnel(dim=D).log_density, jf)
        tlogp = flow_reparameterized(NealsFunnel(dim=D).log_density, tf)
    else:
        jlogp, tlogp = JFunnel(dim=D).log_density, NealsFunnel(
            dim=D).log_density
    q, _, im = _inputs(seed, q_scale=q_scale)
    keys = jax.random.split(jax.random.key(100 + seed), N)
    eps = np.asarray(eps, np.float32)
    kernel = jax.vmap(j_make_hmc(jlogp, num_leapfrog=STEPS),
                      in_axes=(0, 0, 0 if eps.ndim else None, None))
    jq, jinfo = jax.jit(kernel)(keys, jnp.asarray(q), jnp.asarray(eps),
                                jnp.asarray(im))
    p0, u = jax_hmc_draws(keys, D, jnp.asarray(im))
    logp_and_grad = (fused_latent_logp_and_grad(NealsFunnel(dim=D), tf)
                     if hook == "k3" else value_and_grad(tlogp))
    tq, tinfo = hmc_transition_math(
        torch.from_numpy(q), torch.from_numpy(p0), torch.from_numpy(u),
        torch.from_numpy(eps), torch.from_numpy(im), logp_and_grad, STEPS)
    return (np.asarray(jq), jinfo), (tq.numpy(), tinfo)


@pytest.mark.parametrize("seed,eps,hook", [
    (0, 0.5, "autograd"), (1, 0.7, "autograd"), (2, 0.5, "k3"),
    (3, 0.5, "k3"), (4, "per_chain", "autograd"), (5, "per_chain", "k3")])
def test_hmc_transition_matches_jax(seed, eps, hook):
    if eps == "per_chain":
        eps = np.random.default_rng(seed).uniform(0.1, 0.6, N)
    (jq, jinfo), (tq, tinfo) = _run_both(seed, eps, hook)
    acc = np.asarray(jinfo.accepted)
    np.testing.assert_array_equal(tinfo.accepted.numpy(), acc)
    assert 0 < acc.sum() < N  # both decisions occur
    np.testing.assert_allclose(tq, jq, **TOL)
    np.testing.assert_allclose(tinfo.logp.numpy(), np.asarray(jinfo.logp),
                               **TOL)
    np.testing.assert_allclose(tinfo.energy.numpy(),
                               np.asarray(jinfo.energy), **TOL)
    np.testing.assert_allclose(tinfo.accept_prob.numpy(),
                               np.asarray(jinfo.accept_prob), **TOL)


def test_hmc_on_the_raw_funnel_matches_jax():
    (jq, jinfo), (tq, tinfo) = _run_both(6, 0.1, "autograd",
                                         preconditioned=False, q_scale=0.5)
    np.testing.assert_array_equal(tinfo.accepted.numpy(),
                                  np.asarray(jinfo.accepted))
    np.testing.assert_allclose(tq, jq, **TOL)
    np.testing.assert_allclose(tinfo.logp.numpy(), np.asarray(jinfo.logp),
                               **TOL)


def test_hmc_kernel_draws_its_own_randomness():
    """The transition as `make_hmc_kernel` returns it: momenta and
    uniforms from the generator, the default autograd gradient; the same
    generator state gives the same result, and the K3 hook (its plain
    version here) gives the same draws as autograd."""
    tf = torch_flow(jax_flow(flow_leaves(7)))
    target = NealsFunnel(dim=D)
    logp = flow_reparameterized(target.log_density, tf)
    q = torch.from_numpy(_inputs(7)[0])
    eps, im = torch.tensor(0.6), torch.ones(D)
    outs = []
    for hook in (None, fused_latent_logp_and_grad(target, tf)):
        kernel = make_hmc_kernel(logp, num_leapfrog=STEPS,
                                 logp_and_grad=hook)
        outs.append(kernel(torch.Generator().manual_seed(3), q, eps, im))
    (q1, i1), (q2, i2) = outs
    assert q1.shape == (N, D) and i1.accepted.dtype == torch.bool
    torch.testing.assert_close(q1, q2, rtol=1e-6, atol=1e-6)
    assert torch.equal(i1.accepted, i2.accepted)
    assert 0 < int(i1.accepted.sum()) < N
