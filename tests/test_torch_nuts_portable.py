"""The portable NUTS (`tpuflows_torch.mcmc.nuts.make_nuts_kernel`) and its
driver (`mcmc.sample`) against the JAX package, on the CPU.

  * `make_nuts_kernel` against `jax.vmap(make_nuts_kernel(...))` with the
    JAX kernel's own draws replayed (`jax_nuts_draws`): per chain key
    `k_mom, k_loop = split(key)`, p0 = normal(k_mom) / sqrt(inv_mass);
    per doubling `k_loop, k_dir, k_sub, k_acc = split(k_loop, 4)`, the
    direction bernoulli(k_dir) and u_acc = uniform(k_acc); per leaf of the
    subtree `k_sub, k_take = split(k_sub)`, u_take = uniform(k_take). On a
    flow-preconditioned funnel at d = 8 (Standardize + one affine coupling
    with a non-zero last layer), depths 3 to 6, pooled and per-chain step
    sizes, random masks, the autograd default and the K3 hook (its plain
    version here), and one step size so large that leaves diverge. Every
    chain takes the JAX package's decisions (num_steps, tree_depth,
    diverging, turning); q, logp, energy and the accept statistic agree to
    1e-5 (absolute and relative: float32 rounding carried through up to 63
    leapfrogs);
  * at the divergent step size K1's plain version, which zeroes a
    divergent leaf's non-finite values as the JAX package's
    `_transition_math` does, reports another `turning` flag on some
    divergent chains than `make_nuts_kernel`: the portable kernel carries
    them as `make_nuts_kernel` does;
  * `NUTSDriver(log_density=...)`: warmup and continued draws, per-chain
    step sizes ((n,) leaves, each chain its own), the "stan" schedule, and
    the refusal of `transition=` with per-chain step sizes;
  * `run_nuts`, `nuts_warmup` + `nuts_draws` against the JAX package's
    `run_nuts` on a small funnel: the RNG streams differ, so the check is
    on the distribution: v's mean and variance from each side agree within
    5 Monte-Carlo standard errors (ESS-based, both sides' errors combined)
    and each lies within 5 of them of the truth, N(0, 1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows.mcmc.nuts import make_nuts_kernel as j_make_nuts
from tpuflows.mcmc.preconditioned import flow_reparameterized as j_reparam
from tpuflows.mcmc.sample import run_nuts as j_run_nuts
from tpuflows.targets import NealsFunnel as JFunnel

from tpuflows_torch.diagnostics import effective_sample_size
from tpuflows_torch.kernels import nuts_cuda
from tpuflows_torch.kernels.fused_logp_cuda import fused_latent_logp_and_grad
from tpuflows_torch.mcmc import (MCMCResult, NUTSDriver, NUTSState,
                                 flow_reparameterized, make_nuts_kernel,
                                 nuts_draws, nuts_warmup, run_nuts)
from tpuflows_torch.mcmc.hmc import value_and_grad
from tpuflows_torch.targets import NealsFunnel

from test_torch_nuts import flow_leaves, jax_flow, torch_flow

D, N = 8, 64
TOL = dict(rtol=1e-5, atol=1e-5)
DISCRETE = ("num_steps", "tree_depth", "diverging", "turning")


def jax_nuts_draws(keys, d, depth, inv_mass):
    """(p0, dirs, u_acc, u_take) as `make_nuts_kernel`'s transition draws
    them from each chain's key; u_take holds doubling k's leaves in columns
    2^k - 1 .. 2^(k+1) - 2."""
    def derive(key):
        k_mom, k_loop = jax.random.split(key)
        p0 = jax.random.normal(k_mom, (d,), jnp.float32) / jnp.sqrt(inv_mass)
        dirs, u_acc, u_take = [], [], []
        for k in range(depth):
            k_loop, k_dir, k_sub, k_acc = jax.random.split(k_loop, 4)
            dirs.append(jnp.where(jax.random.bernoulli(k_dir), 1.0, -1.0))
            u_acc.append(jax.random.uniform(k_acc))
            for _ in range(1 << k):
                k_sub, k_take = jax.random.split(k_sub)
                u_take.append(jax.random.uniform(k_take))
        u_take.append(jnp.float32(0.5))  # the unused last column
        return p0, jnp.stack(dirs), jnp.stack(u_acc), jnp.stack(u_take)

    return [np.array(a, np.float32) for a in jax.vmap(derive)(keys)]


def _case(seed, random_mask):
    mask = None
    if random_mask:
        rng = np.random.default_rng(seed)
        mask = tuple(int(m) for m in rng.integers(0, 2, D))
    jf = jax_flow(flow_leaves(seed, mask=mask))
    return jf, torch_flow(jf)


def _inputs(seed, q_scale=1.0):
    rng = np.random.default_rng(500 + seed)
    q = (q_scale * rng.normal(size=(N, D))).astype(np.float32)
    im = (0.5 + rng.random(D)).astype(np.float32)
    return q, im


def run_both(seed, depth, eps, hook="autograd", random_mask=False,
             q_scale=1.0):
    """The JAX kernel on its keys and the port's `NUTSKernel.math` on the
    draws replayed from them. Returns ((q, info) JAX, (q, info) port, the
    replayed inputs)."""
    jf, tf = _case(seed, random_mask)
    target, jtarget = NealsFunnel(dim=D), JFunnel(dim=D)
    q, im = _inputs(seed, q_scale)
    eps = np.asarray(eps, np.float32)
    keys = jax.random.split(jax.random.key(200 + seed), N)
    jkernel = jax.vmap(
        j_make_nuts(j_reparam(jtarget.log_density, jf), max_depth=depth),
        in_axes=(0, 0, 0 if eps.ndim else None, None))
    jq, jinfo = jax.jit(jkernel)(keys, jnp.asarray(q), jnp.asarray(eps),
                                 jnp.asarray(im))
    rnd = jax_nuts_draws(keys, D, depth, jnp.asarray(im))
    hook_fn = (fused_latent_logp_and_grad(target, tf) if hook == "k3"
               else None)
    kernel = make_nuts_kernel(flow_reparameterized(target.log_density, tf),
                              max_depth=depth, logp_and_grad=hook_fn)
    inputs = [torch.from_numpy(a) for a in (q, *rnd)]
    tq, tinfo = kernel.math(*inputs[:5], torch.from_numpy(eps),
                            torch.from_numpy(im))
    return (np.asarray(jq), jinfo), (tq.numpy(), tinfo), (
        tf, inputs, torch.from_numpy(eps), torch.from_numpy(im), kernel)


def assert_same_decisions(jinfo, tinfo):
    for name in DISCRETE:
        np.testing.assert_array_equal(
            getattr(tinfo, name).numpy(), np.asarray(getattr(jinfo, name)),
            err_msg=name)


@pytest.mark.parametrize("seed,depth,eps,hook,random_mask", [
    (0, 3, 0.4, "autograd", False), (1, 4, 0.3, "autograd", True),
    (2, 5, 0.25, "k3", False), (3, 6, 0.15, "autograd", False),
    (4, 6, 0.2, "k3", True), (5, 4, "per_chain", "autograd", False),
    (6, 6, "per_chain", "k3", True)])
def test_nuts_transition_matches_jax(seed, depth, eps, hook, random_mask):
    if eps == "per_chain":
        eps = np.random.default_rng(seed).uniform(0.1, 0.5, N)
    (jq, jinfo), (tq, tinfo), _ = run_both(seed, depth, eps, hook,
                                           random_mask)
    assert_same_decisions(jinfo, tinfo)
    np.testing.assert_allclose(tq, jq, **TOL)
    for name in ("logp", "energy", "accept_prob"):
        np.testing.assert_allclose(getattr(tinfo, name).numpy(),
                                   np.asarray(getattr(jinfo, name)),
                                   err_msg=name, **TOL)
    # real trees: several depths, U-turns
    assert len(np.unique(np.asarray(jinfo.tree_depth))) >= 2
    assert np.asarray(jinfo.turning).sum() > 0


def test_divergent_leaves_match_jax_and_k1_plain_differs():
    (jq, jinfo), (tq, tinfo), (tf, inputs, eps, im, _) = run_both(
        11, 5, 6.0)
    div = np.asarray(jinfo.diverging)
    assert div.sum() >= N // 4
    assert_same_decisions(jinfo, tinfo)
    np.testing.assert_allclose(tq, jq, **TOL)
    np.testing.assert_allclose(tinfo.logp.numpy(), np.asarray(jinfo.logp),
                               **TOL)
    # K1's plain version zeroes a divergent leaf's non-finite q, p and g:
    # its U-turn check at that leaf then sees p = 0, a turn; the JAX
    # package's sees inf or nan there. Only `turning` of divergent chains
    # can differ.
    k1 = nuts_cuda.transition_math_torch(
        *inputs, eps, im, nuts_cuda.autograd_logp_grad(
            tf, NealsFunnel(dim=D).log_density), 5)
    k1_turn = k1[6].numpy() > 0.5
    differs = k1_turn != tinfo.turning.numpy()
    assert differs.any() and not (differs & ~div).any()
    np.testing.assert_array_equal(k1[3].numpy(), tinfo.num_steps.numpy())
    np.testing.assert_array_equal(k1[0].numpy(), tq)


def test_math_counts_one_gradient_per_leaf_step():
    """One hook call at q and one per leaf step of the batch: a doubling
    of 2^k leaves costs 2^k calls while any chain still runs there."""
    (_, jinfo), (_, tinfo), (_, inputs, eps, im, kernel) = run_both(
        8, 4, 0.3)
    depths = tinfo.tree_depth.numpy()
    calls = kernel.grad_calls
    assert calls >= 1 + (1 << int(depths.max())) - 1
    assert calls <= 1 + (1 << 4) - 1
    calls_before = kernel.grad_calls
    kernel.math(*inputs[:5], eps, im)
    assert kernel.grad_calls - calls_before == calls


def test_pooled_and_per_chain_eps_agree_when_equal():
    """A per-chain step size of equal values gives the pooled result bit
    for bit (the (n, 1) broadcast)."""
    _, (tq, tinfo), (_, inputs, eps, im, kernel) = run_both(9, 4, 0.3)
    q2, info2 = kernel.math(*inputs[:5], torch.full((N,), 0.3), im)
    assert np.array_equal(q2.numpy(), tq)
    assert torch.equal(info2.num_steps, tinfo.num_steps)


def test_default_hook_is_autograd_and_k3_plain_matches_it():
    """The transition `make_nuts_kernel` returns draws its own randomness;
    with the K3 hook (its plain version on the CPU) the result is
    autograd's, bit for bit, on the affine flow."""
    _, tf = _case(10, False)
    target = NealsFunnel(dim=D)
    logp = flow_reparameterized(target.log_density, tf)
    q, im = (torch.from_numpy(a) for a in _inputs(10))
    outs = []
    for hook in (None, fused_latent_logp_and_grad(target, tf)):
        kernel = make_nuts_kernel(logp, max_depth=5, logp_and_grad=hook)
        outs.append(kernel(torch.Generator().manual_seed(4), q,
                           torch.tensor(0.3), im))
    (q1, i1), (q2, i2) = outs
    assert torch.equal(q1, q2) and torch.equal(i1.num_steps, i2.num_steps)
    lp, g = value_and_grad(logp)(q)
    assert lp.shape == (N,) and g.shape == (N, D)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------
def _small_funnel_case(seed=0, n=32, d=4):
    target = NealsFunnel(dim=d, sigma_v=1.0)
    g = torch.Generator().manual_seed(seed)
    return target, torch.randn(n, d, generator=g), g


@pytest.mark.parametrize("schedule,per_chain", [("single", False),
                                                ("stan", False),
                                                ("single", True)])
def test_driver_warmup_and_draws(schedule, per_chain):
    target, q0, g = _small_funnel_case()
    driver = NUTSDriver(target.log_density, max_depth=5,
                        per_chain_step_size=per_chain,
                        warmup_schedule=schedule)
    state = driver.warmup(g, q0, 80)
    assert state.step_size.shape == ((32,) if per_chain else ())
    assert torch.isfinite(state.q).all()
    assert (state.step_size > 0).all() and (state.step_size < 5).all()
    assert not torch.equal(state.inv_mass, torch.ones(4))
    if per_chain:  # each chain adapted its own step size
        assert len(torch.unique(state.step_size)) == 32
    new, z, info = driver.draws(g, state, 6)
    assert z.shape == (6, 32, 4) and torch.equal(new.q, z[-1])
    assert info.num_steps.shape == (6, 32)
    assert info.num_steps.dtype == torch.int32
    assert new.step_size is state.step_size
    # continuation: the next window starts where this one stopped
    _, z2, _ = driver.draws(g, new, 2)
    assert not torch.equal(z2[0], z[-1])


def test_per_chain_eps_broadcasts_per_chain():
    """Distinct per-chain step sizes: chain i's transition is the pooled
    transition at chain i's step size."""
    target, q0, _ = _small_funnel_case(n=6)
    kernel = make_nuts_kernel(target.log_density, max_depth=4)
    eps = torch.tensor([0.05, 0.1, 0.2, 0.3, 0.5, 0.8])
    im = torch.ones(4)
    rnd = nuts_cuda.draw_randomness(torch.Generator().manual_seed(1), 6, 4,
                                    4, im)
    q_all, info_all = kernel.math(q0, *rnd, eps, im)
    for i in range(6):
        qi, info_i = kernel.math(q0[i:i + 1], *(r[i:i + 1] for r in rnd),
                                 eps[i], im)
        torch.testing.assert_close(qi[0], q_all[i], rtol=0, atol=0)
        assert int(info_i.num_steps[0]) == int(info_all.num_steps[i])
    assert len(torch.unique(info_all.num_steps)) >= 2


def test_driver_refuses_per_chain_with_a_batched_transition():
    with pytest.raises(ValueError, match="pooled"):
        NUTSDriver(transition=lambda *a: None, per_chain_step_size=True)
    with pytest.raises(ValueError, match="log_density"):
        NUTSDriver()
    with pytest.raises(ValueError, match="log_density"):
        NUTSDriver(logp_and_grad=lambda z: None)


def _v_moments(x):
    """Mean and variance of v = x[..., 0] over (draws, chains) with their
    ESS-based standard errors."""
    v = x[..., 0]
    ess = float(effective_sample_size(v[..., None])[0])
    ess2 = float(effective_sample_size((v * v)[..., None])[0])
    flat = v.reshape(-1).double()
    mean, var = float(flat.mean()), float(flat.var())
    m4 = float(((flat - mean) ** 4).mean())
    return (mean, (var / ess) ** 0.5), (var, ((m4 - var ** 2) / ess2) ** 0.5)


def _agree(a, b, truth):
    (ma, sa), (mb, sb) = a, b
    z_ab = abs(ma - mb) / (sa * sa + sb * sb) ** 0.5
    return z_ab, abs(ma - truth) / sa, abs(mb - truth) / sb


def test_run_nuts_matches_jax_run_nuts_in_distribution():
    d, n, warm, draws = 4, 64, 150, 150
    q0 = np.random.default_rng(3).normal(size=(n, d)).astype(np.float32)
    jres = j_run_nuts(jax.random.key(0), JFunnel(dim=d, sigma_v=1.0)
                      .log_density, jnp.asarray(q0), num_warmup=warm,
                      num_samples=draws, max_depth=5)
    target = NealsFunnel(dim=d, sigma_v=1.0)
    g = torch.Generator().manual_seed(0)
    res = run_nuts(g, target.log_density, torch.from_numpy(q0),
                   num_warmup=warm, num_samples=draws, max_depth=5)
    assert isinstance(res, MCMCResult)
    assert res.samples.shape == (draws, n, d)
    assert res.info.tree_depth.shape == (draws, n)
    # the split API: warmup once, draw twice from where it stopped
    state = nuts_warmup(g, target.log_density, torch.from_numpy(q0),
                        num_warmup=warm, max_depth=5)
    assert isinstance(state, NUTSState)
    state, z1, _ = nuts_draws(g, target.log_density, state, draws // 2,
                              max_depth=5)
    _, z2, _ = nuts_draws(g, target.log_density, state, draws // 2,
                          max_depth=5)
    split = torch.cat([z1, z2])
    jx = torch.from_numpy(np.array(jres.samples))
    jm, jv = _v_moments(jx)
    for x in (res.samples, split):
        m, v = _v_moments(x)
        for z in (*_agree(m, jm, 0.0), *_agree(v, jv, 1.0)):
            assert z < 5.0, (m, v, jm, jv)
    # both adapted a step size of the same order
    assert 0.5 < float(res.step_size) / float(jres.step_size) < 2.0


def test_run_nuts_without_warmup_uses_the_initial_step():
    target, q0, g = _small_funnel_case(n=8)
    res = run_nuts(g, target.log_density, q0, num_warmup=0, num_samples=3,
                   initial_step_size=0.25, max_depth=3,
                   per_chain_step_size=True)
    assert torch.equal(res.step_size, torch.full((8,), 0.25))
    assert torch.equal(res.inv_mass, torch.ones(4))
    assert res.samples.shape == (3, 8, 4)
