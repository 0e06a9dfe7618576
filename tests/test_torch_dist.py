"""The distributed layer of the port (`tpuflows_torch.dist`) in worlds of
1, 2 and 4 gloo ranks on the CPU, against the JAX package's `tpuflows.dist`
on the virtual 8-device mesh of `tests/conftest.py` and against the
port's own unsharded code.

Each world is started once for this module (`tests/torch_dist_world.py`:
one process a rank, one thread each, joined through a file in a temporary
directory, with a time limit), all three side by side, and runs its list
of checks on seeded numpy inputs; the JAX side runs here under
`shard_map` on the same inputs. What is held:

  * collectives: `logsumexp_g`, `kish_ess_g`, `pmean`, `pmax` and `psum`
    equal the JAX `shard_map` values on W devices and the local math, to
    rtol 1e-6; the fused `kish_ess_g` equals two separate `psum`s to the
    bit; `all_gather` gives the global vector; `fold_in_axis_index`
    decorrelates the ranks; `replicate` installs rank 0's parameters;
  * resampling: `resample_sharded`, gather and ring exchange, balanced
    weights and degenerate ones (all the mass on the last rank's
    particles, so the ring spans W // 2 hops), a two-leaf payload, and
    n_out = 2n and n / 2: the ancestors equal the JAX `resample_sharded`'s
    (n_out = n, the same uniform as `jax.random.uniform(key, ())`) or the
    JAX `systematic_indices`' (other n_out), and the port's
    `systematic_indices_math`, exactly; the rows are the ancestors' rows;
  * annealing: `next_beta(mesh=)` equals the port's unsharded and the JAX
    sharded result, to 1e-6;
  * the sharded stage (`_stage_math(mesh=)`), given the unsharded stage's
    draws split by rank and the same uniform, equals the port's unsharded
    stage, which `tests/test_torch_smc.py` holds against JAX: the same
    resampling decision and ancestors, beta, the log Z increment, its
    variance and the relative ESS to 1e-6, the weights to 1e-5, x to 1e-5
    in the data space and 1e-4 after a latent sweep (`STAGES`): the
    reductions sum in another order, nothing else differs;
  * one data-parallel train step at W = 2 equals the JAX
    `make_train_step(axis_name=WORKERS)` under `shard_map` on the same
    blocks and parameters (carried across by `convert`), to 1e-5; and
    `optimize_flow_dp` passes `tests/test_dist.py`'s fit-quality check,
    its parameters equal to the bit on every rank;
  * `run_nuts_sharded` at W = 2 passes `tests/test_dist.py`'s moments with
    the step size and metric equal on every rank; at W = 1 it equals
    `run_nuts` on the folded generator to the bit; with `transition=`
    (K1) the plain version runs once per transition;
  * `run_rwmh` and `run_parallel_tempering` with a mesh at W = 2: the
    pooled adaptation equal on every rank, the moments as the JAX tests
    of the samplers bar them;
  * `heartbeat` returns at W = 2; a rank that skips it makes the other's
    `run_with_timeout(heartbeat, timeout_s=2)` raise `CollectiveTimeout`;
  * checkpoints: a 2-rank save loads resharded in one process, a
    one-process save loads into 2 ranks, and the same with the process
    facts monkeypatched, as `tests/test_checkpoint_reshard.py` does.

Whole SMC runs, resumes and the runner under `torchrun` are in
`tests/test_torch_dist_runs.py`.
"""
import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from tpuflows.dist import WORKERS
from tpuflows.dist import resample_sharded as j_resample_sharded
from tpuflows.dist import worker_mesh as j_worker_mesh
from tpuflows.dist.collectives import kish_ess_g as j_kish_ess_g
from tpuflows.dist.collectives import logsumexp_g as j_logsumexp_g
from tpuflows.flows import build_flow as j_build_flow
from tpuflows.flows import negll_flow_loss as j_negll
from tpuflows.flows.train import make_train_step as j_make_train_step
from tpuflows.smc import next_beta as j_next_beta
from tpuflows.smc import systematic_indices as j_systematic

import tpuflows_torch.io.checkpoint as ckpt
from tpuflows_torch.diagnostics import moment_gate
from tpuflows_torch.flows import Adam, build_flow, optimize_flow
from tpuflows_torch.io import load_pytree, save_pytree
from tpuflows_torch.smc import SMCConfig, next_beta
from tpuflows_torch.smc.resample import systematic_indices_math
from tpuflows_torch.smc.sampler import _flow_log_q, _stage_math
from tpuflows_torch.targets import GaussianMixture, HierarchicalGaussian

from test_torch_coupling import carry
from torch_dist_world import result, start_world, wait_world, write_inputs

WORLDS = (1, 2, 4)
COMMON = ["collectives", "resample", "annealing", "stage"]
# the worlds the module starts side by side: label -> (size, checks); the
# samplers' checks run in two more worlds of 2 beside the first, whose
# last check (the skipped heartbeat) holds it for 6 s
CHECKS = {1: (1, COMMON + ["nuts_folded"]),
          2: (2, COMMON + ["dp_step", "dp_fit", "nuts_k1",
                           "checkpoint_save", "checkpoint_load", "heartbeat",
                           "heartbeat_skipped"]),
          "2_samplers": (2, ["nuts", "mh"]),
          "2_tempering": (2, ["pt"]),
          4: (4, COMMON)}
TOL = dict(rtol=1e-6, atol=1e-6)
N_RS, D_RS = 64, 3
D_STAGE, N_STAGE = 18, 256


def t(a):
    return torch.from_numpy(np.array(a))


def close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(tol or TOL))


def rng(seed):
    return np.random.default_rng(seed)


def f32(a):
    return np.asarray(a, dtype=np.float32)


# ---------------------------------------------------------------------------
# inputs, shared by the worlds and the JAX side
# ---------------------------------------------------------------------------
def resample_cases(w):
    """(name, case) pairs for a world of w ranks."""
    key = jax.random.key(0)
    u0 = float(jax.random.uniform(key, ()))
    x = f32(rng(1).normal(size=(N_RS, D_RS)))
    lp = f32(rng(5).normal(size=N_RS))
    weights = {
        "balanced": f32(0.1 * rng(2).normal(size=N_RS)),
        # all the mass on the last rank's particles
        "degenerate": f32(np.where(np.arange(N_RS) >= N_RS - N_RS
                                   // max(w, 2), 0.0, -100.0))}
    cases = []
    for wname, log_w in weights.items():
        for gather in (True, False):
            cases.append((f"{wname}-{'gather' if gather else 'exchange'}",
                          dict(u0=u0, leaves=[x], log_w=log_w,
                               gather=gather, n_out=None)))
    log_w = f32(rng(6).normal(size=N_RS))
    cases.append(("two-leaf-exchange", dict(u0=u0, leaves=[x, lp],
                                            log_w=log_w, gather=False,
                                            n_out=None)))
    for n_out, gather in ((2 * N_RS, False), (N_RS // 2, True)):
        cases.append((f"n_out={n_out}", dict(u0=u0, leaves=[x, lp],
                                             log_w=log_w, gather=gather,
                                             n_out=n_out)))
    return cases


ANNEALING = [(0.0, 5.0, 0.5, 0), (0.37, 12.0, 0.8, 2), (0.0, 1e-3, 0.5, 4)]


def annealing_cases():
    return [(beta, f32(scale * rng(seed).normal(size=256)), target)
            for beta, scale, target, seed in ANNEALING]


# one latent sweep, as `tests/test_torch_smc.py` runs. The pooled
# variance's other rounding order (1e-7) moves the momenta, and the
# leapfrogs through the flows carry that to x: after one latent sweep 2 of
# 4,608 coordinates differ by 1.8e-5 (4e-5 relative), after two 5 by
# 3.8e-5 (measured at W = 2). So x is held to 1e-5 in the data space and
# to `tests/test_torch_smc.py`'s 1e-4 after a latent sweep.
STAGES = {"latent": dict(log_w_scale=0.0, latent=True, sweeps=1,
                         gather=None),
          "latent_resample_gather": dict(log_w_scale=2.0, latent=True,
                                         sweeps=1, gather=True),
          "latent_resample_exchange": dict(log_w_scale=2.0, latent=True,
                                           sweeps=1, gather=False),
          "data_space": dict(log_w_scale=0.0, latent=False, sweeps=3,
                             gather=None)}


def stage_flows(path):
    """c5's family at d = 18 in the port alone: q0 fitted a little on the
    prior, a preconditioner a little further on the posterior; saved
    for the worlds."""
    target = HierarchicalGaussian.standard(dim=D_STAGE, device="cpu")
    g = torch.Generator().manual_seed(0)
    prior = target.sample_prior(g, 1024, device="cpu")
    q0 = build_flow(prior, torch.Generator().manual_seed(1), kind="affine",
                    n_blocks=2, hidden=(32, 32), mask_scheme="leading",
                    n_leading=2, clamp=8.0, device="cpu")
    optimize_flow(torch.Generator().manual_seed(2), prior, q0,
                  Adam(2e-3), nbatches=8, nepochs=5)
    pre = copy.deepcopy(q0)
    post = target.sample(torch.Generator().manual_seed(3), 1024,
                         device="cpu")
    optimize_flow(torch.Generator().manual_seed(4), post, pre, Adam(2e-3),
                  nbatches=8, nepochs=3)
    save_pytree(path, {"q0": q0, "pre": pre})
    return target, q0, pre


def stage_cases(directory):
    target, q0, pre = stage_flows(os.path.join(directory, "stage_flows"))
    cases = {}
    for i, (name, spec) in enumerate(STAGES.items()):
        r = rng(10 + i)
        x = target.sample(torch.Generator().manual_seed(20 + i), N_STAGE,
                          device="cpu") + 0.5 * t(f32(r.normal(
                              size=(N_STAGE, D_STAGE))))
        with torch.no_grad():
            log_q0 = _flow_log_q(q0, x)
        cfg = dict(n_particles=N_STAGE, n_leapfrog=5,
                   n_mutation_steps=spec["sweeps"], target_rel_ess=0.8,
                   latent_mutation=spec["latent"],
                   gather_resample=spec["gather"])
        cases[name] = dict(
            flows=os.path.join(directory, "stage_flows"), dim=D_STAGE,
            cfg=cfg, x=x.numpy(), log_q0_x=log_q0.numpy(),
            log_w=f32(spec["log_w_scale"] * r.normal(size=N_STAGE)),
            anc=r.permutation(N_STAGE).astype(np.int32), beta=0.05,
            eps=0.2, u0=float(r.uniform()),
            normals=f32(r.normal(size=(spec["sweeps"], N_STAGE, D_STAGE))),
            u=f32(r.uniform(size=(spec["sweeps"], N_STAGE))))
    return cases


def dp_inputs(directory):
    samples = jax.random.normal(jax.random.key(0), (512, 2)) * jnp.array(
        [0.5, 2.0]) + jnp.array([1.0, -1.0])
    jf = j_build_flow(samples, jax.random.key(1), kind="affine", n_blocks=2,
                      hidden=(16,))
    path = os.path.join(directory, "dp_flow")
    save_pytree(path, carry(jf))
    batch = f32(rng(7).normal(size=(256, 2)) * [0.5, 2.0] + [1.0, -1.0])
    return jf, {"flow": path, "batch": batch}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world's results, and the inputs it ran on (the worlds start
    side by side)."""
    root = str(tmp_path_factory.mktemp("dist"))
    jf, dp_step = dp_inputs(root)
    full = np.arange(16.0 * 3, dtype=np.float32).reshape(16, 3)
    written_by_one = os.path.join(root, "ck_one")
    save_pytree(written_by_one, {
        "particles": t(full), "flow_param": torch.arange(4.0),
        "key": torch.Generator().manual_seed(7), "beta": torch.tensor(0.5)},
        sharded=("particles",))
    target = f32(rng(8).normal(size=(2048, 2)) * [0.5, 2.0] + [1.0, -1.0])
    common = dict(
        v=f32(rng(3).normal(size=48)), lw=f32(3.0 * rng(4).normal(size=48)),
        annealing=annealing_cases(), stage=list(stage_cases(root).values()),
        dp_step=dp_step, dp_fit=target,
        nuts_q0=f32(rng(9).normal(size=(32, 2))),
        mh_q0=f32(rng(11).normal(size=(64, 3))),
        checkpoint=dict(full=full, written_by_one=written_by_one,
                        written_here=os.path.join(root, "ck_two")))
    started = {}
    for label, (w, checks) in CHECKS.items():
        d = os.path.join(root, f"world{label}")
        write_inputs(d, dict(common, resample=[c for _, c in
                                               resample_cases(w)]))
        started[label] = (start_world(w, checks, d), d)
    out = {w: wait_world(procs, d) for w, (procs, d) in started.items()}
    return {"results": out, "inputs": common, "jax_flow": jf}


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def jax_collectives(v, lw, w):
    def body(v, lw):
        return (j_logsumexp_g(lw, WORKERS), j_kish_ess_g(lw, WORKERS),
                jax.lax.pmean(jnp.mean(v), WORKERS),
                jax.lax.pmax(jnp.max(v), WORKERS),
                jax.lax.psum(jnp.sum(v), WORKERS))

    f = jax.jit(shard_map(body, mesh=j_worker_mesh(w),
                          in_specs=(P(WORKERS), P(WORKERS)),
                          out_specs=(P(),) * 5, check_vma=False))
    return [float(a) for a in f(jnp.asarray(v), jnp.asarray(lw))]


@pytest.mark.parametrize("w", WORLDS)
def test_collectives_match_jax_and_the_local_math(worlds, w):
    inp = worlds["inputs"]
    v, lw = inp["v"], inp["lw"]
    ranks = result(worlds["results"][w], "collectives")
    j_lse, j_kish, j_mean, j_max, j_sum = jax_collectives(v, lw, w)
    lwt = t(lw)
    local = {"lse": float(torch.logsumexp(lwt, 0)),
             "kish": float(torch.sum(torch.exp(lwt - lwt.max())) ** 2
                           / torch.sum(torch.exp(2 * (lwt - lwt.max())))),
             "pmean": float(np.mean(v)), "pmax": float(np.max(v)),
             "psum": float(np.sum(v))}
    jaxs = {"lse": j_lse, "kish": j_kish, "pmean": j_mean, "pmax": j_max,
            "psum": j_sum}
    for r in ranks:
        for k in local:
            close(r[k], local[k])
            close(r[k], jaxs[k])
            assert r[k] == ranks[0][k]  # replicated to the bit
        assert r["kish"] == r["kish_unfused"]
        assert np.array_equal(r["gathered"], v)
        for got, want in zip(r["replicated"], ranks[0]["replicated"]):
            assert np.all(got == 1.0) and np.array_equal(got, want)
    folds = [tuple(r["fold"]) for r in ranks]
    assert len(set(folds)) == w  # one stream a rank


# ---------------------------------------------------------------------------
# resampling
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def jax_resampler(w, gather):
    """The JAX `resample_sharded` on w devices, compiled once for every
    case of its transport."""
    def body(key, x, log_w):
        (out,), anc = j_resample_sharded(key, (x,), log_w,
                                         gather_particles=gather)
        return out, anc

    return jax.jit(shard_map(body, mesh=j_worker_mesh(w),
                             in_specs=(P(), P(WORKERS), P(WORKERS)),
                             out_specs=(P(WORKERS), P(WORKERS)),
                             check_vma=False))


def jax_ancestors(case, w):
    key = jax.random.key(0)
    log_w = jnp.asarray(case["log_w"])
    if case["n_out"] is not None:
        return np.asarray(j_systematic(key, log_w, case["n_out"]))
    _, anc = jax_resampler(w, case["gather"])(
        key, jnp.asarray(case["leaves"][0]), log_w)
    return np.asarray(anc)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("i", range(7))
def test_resample_sharded_matches_jax(worlds, w, i):
    name, case = resample_cases(w)[i]
    ranks = result(worlds["results"][w], "resample")
    anc = np.concatenate([r[i]["anc"] for r in ranks])
    assert anc.dtype == np.int32
    want = systematic_indices_math(torch.tensor(case["u0"]),
                                   t(case["log_w"]), case["n_out"]).numpy()
    assert np.array_equal(anc, want), name
    assert np.array_equal(anc, jax_ancestors(case, w)), name
    for j, leaf in enumerate(case["leaves"]):
        rows = np.concatenate([r[i]["rows"][j] for r in ranks])
        assert np.array_equal(rows, leaf[anc]), name
    if name == "degenerate-exchange":
        owner = anc // (N_RS // w)
        assert np.all(owner == w - 1)  # every row from the last rank


# ---------------------------------------------------------------------------
# annealing
# ---------------------------------------------------------------------------
def jax_next_beta(beta, lr, target, w):
    def body(lr):
        return j_next_beta(beta, lr, target, axis_name=WORKERS,
                           n_global=lr.shape[0] * w)

    f = jax.jit(shard_map(body, mesh=j_worker_mesh(w),
                          in_specs=(P(WORKERS),), out_specs=P(),
                          check_vma=False))
    return float(f(jnp.asarray(lr)))


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("i", range(len(ANNEALING)))
def test_next_beta_is_global(worlds, w, i):
    beta, lr, target = annealing_cases()[i]
    got = [r[i] for r in result(worlds["results"][w], "annealing")]
    assert len(set(got)) == 1
    want = float(next_beta(beta, t(lr), target))
    assert abs(got[0] - want) < 1e-6
    assert abs(got[0] - jax_next_beta(beta, lr, target, w)) < 1e-6
    if ANNEALING[i][1] < 1e-2:
        assert got[0] == 1.0


# ---------------------------------------------------------------------------
# the sharded stage
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("name", list(STAGES))
def test_sharded_stage_equals_the_unsharded_one(worlds, w, name):
    i = list(STAGES).index(name)
    case = worlds["inputs"]["stage"][i]
    flows = load_pytree(case["flows"])
    target = HierarchicalGaussian.standard(dim=D_STAGE, device="cpu")
    normals, u = t(case["normals"]), t(case["u"])
    want = _stage_math(
        target.log_density, SMCConfig(**case["cfg"]), t(case["x"]),
        t(case["log_w"]), t(case["log_q0_x"]), t(case["anc"]),
        torch.tensor(case["beta"]), torch.tensor(case["eps"]), flows["q0"],
        flows["pre"], torch.tensor(case["u0"]),
        lambda s: (normals[s], u[s]))
    ranks = [r[i] for r in result(worlds["results"][w], "stage")]
    x, log_w, log_q0, anc = (np.concatenate([r[k] for r in ranks])
                             for k in range(4))
    (wx, wlw, wlq, wanc, wbeta, weps, winc, wvar, wress, wacc) = (
        a.detach().numpy() for a in want)
    resampled = bool(wress < 0.5)
    assert resampled == (STAGES[name]["log_w_scale"] > 0)
    for r in ranks:
        for k in range(4, 10):  # replicated scalars
            assert r[k] == ranks[0][k]
    beta, eps, inc, var, ress, acc = ranks[0][4:]
    assert bool(ress < 0.5) == resampled
    assert np.array_equal(anc, wanc)
    assert abs(float(beta) - float(wbeta)) < 1e-6 and 0.0 < beta < 1.0
    for a, b in ((inc, winc), (var, wvar), (ress, wress), (acc, wacc),
                 (eps, weps)):
        close(a, b)
    x_bar = 1e-4 if STAGES[name]["latent"] else 1e-5
    close(x, wx, rtol=x_bar, atol=x_bar)
    close(log_w, wlw, rtol=1e-5, atol=1e-5)
    close(log_q0, wlq, rtol=1e-5, atol=1e-3)


# ---------------------------------------------------------------------------
# data-parallel training
# ---------------------------------------------------------------------------
def test_dp_step_matches_jax(worlds):
    """One step of the data-parallel Adam at W = 2 against the JAX step
    under `shard_map`, parameters to 1e-5."""
    jf = worlds["jax_flow"]
    batch = jnp.asarray(worlds["inputs"]["dp_step"]["batch"])
    opt = optax.adam(1e-3)
    step = j_make_train_step(opt, j_negll, axis_name=WORKERS)
    f = jax.jit(shard_map(step, mesh=j_worker_mesh(2),
                          in_specs=(P(), P(), P(WORKERS)),
                          out_specs=(P(), P(), P()), check_vma=False))
    jf2, _, jloss = f(jf, opt.init(jf), batch)
    want = [p.detach().numpy() for p in carry(jf2).parameters()]
    ranks = result(worlds["results"][2], "dp_step")
    for r in ranks:
        close(r["loss"], float(jloss), rtol=1e-5, atol=1e-5)
        assert len(r["params"]) == len(want)
        for got, ref in zip(r["params"], want):
            close(got, ref, rtol=1e-5, atol=1e-5)
        for got, ref in zip(r["params"], ranks[0]["params"]):
            assert np.array_equal(got, ref)


def test_optimize_flow_dp_trains(worlds):
    """`tests/test_dist.py`'s fit-quality check, on 2 ranks."""
    ranks = result(worlds["results"][2], "dp_fit")
    for r in ranks:
        assert r["loss1"] < r["loss0"] and r["state"] is None
        assert r["loss_hist"].shape == (30 * 4,)
        assert np.all(np.abs(r["z_mean"]) < 0.15)
        assert np.all(np.abs(r["z_std"] - 1.0) < 0.15)
        for got, ref in zip(r["params"], ranks[0]["params"]):
            assert np.array_equal(got, ref)  # equal to the bit
        assert np.array_equal(r["loss_hist"], ranks[0]["loss_hist"])


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------
def test_run_nuts_sharded_moments(worlds):
    ranks = result(worlds["results"]["2_samplers"], "nuts")
    s = np.concatenate([r["samples"] for r in ranks], axis=1)
    assert s.shape == (200, 32, 2)
    s = s.reshape(-1, 2)
    assert np.allclose(s.mean(0), [2.0, -1.0], atol=0.2)
    assert np.allclose(s.std(0), [1.0, 0.5], atol=0.2)
    for r in ranks:
        assert np.array_equal(r["step_size"], ranks[0]["step_size"])
        assert np.array_equal(r["inv_mass"], ranks[0]["inv_mass"])
    # the ranks draw their own streams
    assert not np.array_equal(ranks[0]["samples"], ranks[1]["samples"])


def test_run_nuts_sharded_at_one_rank_is_run_nuts(worlds):
    assert result(worlds["results"][1], "nuts_folded")[0]["equal"]


def test_run_nuts_sharded_through_k1(worlds):
    """`transition=fused_nuts_for_flow(...)`: on CPU tensors K1's plain
    version, once per transition of each rank; the launches stay 0."""
    ranks = result(worlds["results"][2], "nuts_k1")
    for r in ranks:
        assert r["plain_calls"] == 30 and r["launches"] == 0
        assert r["finite"] and r["shape"] == (10, 8, 8)
        assert np.array_equal(r["step_size"], ranks[0]["step_size"])
        assert np.array_equal(r["inv_mass"], ranks[0]["inv_mass"])


def test_rwmh_and_tempering_pool_over_the_mesh(worlds):
    """The JAX tests' bars (`tests/test_mh_tempering.py`) on the chains of
    both ranks; the adaptation equal on every rank."""
    ranks = [{**a, **b} for a, b in zip(
        result(worlds["results"]["2_samplers"], "mh"),
        result(worlds["results"]["2_tempering"], "pt"))]
    for k in ("mh_scale", "mh_sigma", "pt_scales", "pt_accept"):
        assert np.array_equal(ranks[0][k], ranks[1][k]), k
    mh = np.concatenate([r["mh_samples"] for r in ranks], axis=1)
    assert mh.shape == (800, 64, 3)
    check = moment_gate(t(mh), torch.zeros(3), torch.ones(3), n_sigma=3.5)
    assert check.passed, check
    assert 0.1 < np.mean([r["mh_accept"] for r in ranks]) < 0.5
    pt = np.concatenate([r["pt_samples"] for r in ranks], axis=1)
    assert pt.shape == (1000, 32, 2)
    frac_pos = float(np.mean(pt[..., 0] > 0))
    assert 0.25 < frac_pos < 0.75, frac_pos
    for r in ranks:
        assert float(np.min(r["pt_swap"].mean(0))) > 0.05
    mix = GaussianMixture.bimodal(dim=2, separation=8.0, scale=0.5,
                                  device="cpu")
    check = moment_gate(t(pt), mix.mean("cpu"),
                        torch.diagonal(mix.cov("cpu")), n_sigma=4.0)
    assert check.max_sigma_mean < 4.0, check


# ---------------------------------------------------------------------------
# failure detection
# ---------------------------------------------------------------------------
def test_heartbeat_returns(worlds):
    for beats in result(worlds["results"][2], "heartbeat"):
        assert len(beats) == 3 and all(0.0 < b < 5.0 for b in beats)


def test_a_skipped_heartbeat_times_out(worlds):
    r0, r1 = result(worlds["results"][2], "heartbeat_skipped")
    assert r1 == "skipped"
    assert r0["raised"] == "CollectiveTimeout"
    assert 2.0 <= r0["seconds"] < 10.0


# ---------------------------------------------------------------------------
# checkpoints across process counts
# ---------------------------------------------------------------------------
def test_two_rank_checkpoint_loads_in_one_process(worlds):
    result(worlds["results"][2], "checkpoint_save")
    case = worlds["inputs"]["checkpoint"]
    path = case["written_here"]
    assert sorted(os.listdir(os.path.dirname(path))).count(
        "ck_two_p1.pt") == 1
    out = load_pytree(path)
    assert np.array_equal(out["particles"].numpy(), case["full"])
    assert torch.equal(out["flow_param"], torch.arange(4.0))
    assert torch.equal(out["key"].get_state(),
                       torch.Generator().manual_seed(7).get_state())
    assert float(out["beta"]) == 0.5


def test_one_process_checkpoint_loads_into_two_ranks(worlds):
    full = worlds["inputs"]["checkpoint"]["full"]
    ranks = result(worlds["results"][2], "checkpoint_load")
    for r, out in enumerate(ranks):
        assert np.array_equal(out["particles"], full[8 * r:8 * (r + 1)])
        assert np.array_equal(out["flow_param"], np.arange(4.0))
        assert out["beta"] == 0.5
        assert np.array_equal(out["key"], torch.Generator().manual_seed(
            7).get_state().numpy())


@pytest.fixture
def fake_procs(monkeypatch):
    state = {"pid": 0, "count": 1}

    def set_proc(pid, count):
        state["pid"], state["count"] = pid, count

    monkeypatch.setattr(ckpt, "process_index", lambda: state["pid"])
    monkeypatch.setattr(ckpt, "process_count", lambda: state["count"])
    return set_proc


def small_tree(rows):
    return {"particles": rows, "flow_param": torch.arange(4.0),
            "key": torch.Generator().manual_seed(7),
            "beta": torch.tensor(0.5)}


@pytest.mark.parametrize("saved,loaded", [(2, 1), (1, 2), (4, 2), (2, 4)])
def test_restore_across_process_counts(tmp_path, fake_procs, saved, loaded):
    """`tests/test_checkpoint_reshard.py`'s simulation: the process facts
    monkeypatched, each fake process saving its rows."""
    full = torch.arange(16.0 * 3).reshape(16, 3)
    path = str(tmp_path / "ck")
    for pid in range(saved):
        fake_procs(pid, saved)
        blk = 16 // saved
        save_pytree(path, small_tree(full[pid * blk:(pid + 1) * blk]),
                    sharded=("particles",))
    for pid in range(loaded):
        fake_procs(pid, loaded)
        out = load_pytree(path)
        blk = 16 // loaded
        assert torch.equal(out["particles"], full[pid * blk:(pid + 1) * blk])
        assert torch.equal(out["flow_param"], torch.arange(4.0))
        assert float(out["beta"]) == 0.5


def test_reshard_refuses_rows_that_do_not_divide(tmp_path, fake_procs):
    path = str(tmp_path / "ck")
    fake_procs(0, 1)
    save_pytree(path, small_tree(torch.zeros(6, 2)), sharded=("particles",))
    fake_procs(0, 4)
    with pytest.raises(ValueError, match="cannot reshard leaf 'particles'"):
        load_pytree(path)


def test_one_process_without_sharded_leaves_keeps_one_file(tmp_path):
    path = str(tmp_path / "ck")
    save_pytree(path, small_tree(torch.ones(6, 2)))
    assert os.listdir(tmp_path) == ["ck.pt"]
    out = load_pytree(path)
    assert torch.equal(out["particles"], torch.ones(6, 2))


def test_latest_checkpoint_matches_shards(tmp_path, fake_procs):
    for step in (1, 3):
        for pid in range(2):
            fake_procs(pid, 2)
            save_pytree(str(tmp_path / f"smc_{step}"),
                        small_tree(torch.zeros(2, 1)), sharded=("particles",))
    assert ckpt.latest_checkpoint(str(tmp_path), prefix="smc_") == str(
        tmp_path / "smc_3")


@pytest.mark.parametrize("sharded", [(), ("particles",)])
def test_one_process_save_replaces_a_two_rank_checkpoint(tmp_path, fake_procs,
                                                         sharded):
    """A later one-process save to the path of a 2-rank checkpoint loads
    as itself, not as the older shards its meta file pointed to."""
    path = str(tmp_path / "ck")
    for pid in range(2):
        fake_procs(pid, 2)
        save_pytree(path, small_tree(torch.zeros(4, 3)),
                    sharded=("particles",))
    fake_procs(0, 1)
    new = torch.arange(6.0 * 3).reshape(6, 3)
    save_pytree(path, small_tree(new), sharded=sharded)
    out = load_pytree(path)
    assert torch.equal(out["particles"], new)
    assert os.path.exists(path + ".meta.json") == bool(sharded)
