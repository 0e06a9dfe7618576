"""Worlds of gloo ranks for the distributed tests of the port
(`tests/test_torch_dist*.py`).

`start_world(world, checks, directory)` starts one Python process a rank
(`wait_world` collects their results):

    python tests/torch_dist_world.py <rank> <world> <directory> <check> ...

Each joins a gloo world through `file://<directory>/init` (no port, so
concurrent test workers never race for one), on one thread, builds
`worker_mesh(device="cpu")` and runs the named checks of `CHECKS` in
order, with the inputs the test pickled to `<directory>/inputs.pkl`. It
writes its results to `<directory>/rank<r>.pkl` after every check (a check
that raises records its traceback under "error") and leaves by
`os._exit(0)`. The parent waits with a time limit, so a hang fails the
test instead of stalling the suite. The checks import torch, numpy and the
port only: the tests compare their results with the JAX package.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKS = {}


def check(fn):
    CHECKS[fn.__name__] = fn
    return fn


def write_inputs(directory, inputs) -> None:
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)


def start_world(world, checks, directory):
    """The rank processes of a world, started (see `wait_world`)."""
    os.makedirs(directory, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    procs = []
    for r in range(world):
        log = open(os.path.join(directory, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(world),
             directory, *checks], env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    return procs


def wait_world(procs, directory, timeout=240.0):
    """Each rank's results (a dict of check -> result), once every rank has
    left; a rank still running after `timeout` seconds, or one that left
    without results, fails with the ranks' logs."""
    deadline = time.monotonic() + timeout
    hung = False
    for p, log in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            hung = True
    for p, log in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()
    results, missing = [], []
    for r in range(len(procs)):
        path = os.path.join(directory, f"rank{r}.pkl")
        if not os.path.exists(path):
            missing.append(r)
            continue
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    if hung or missing:
        logs = "\n".join(
            f"--- rank {r}:\n" + open(os.path.join(
                directory, f"rank{r}.log")).read()[-3000:]
            for r in range(len(procs)))
        raise RuntimeError(f"world of {len(procs)}: "
                           f"{'hung' if hung else 'ranks without results'}"
                           f" {missing}\n{logs}")
    return results


def result(results, name):
    """Every rank's result of check `name`, raising a rank's error."""
    out = []
    for r, res in enumerate(results):
        value = res[name]
        if isinstance(value, dict) and "error" in value:
            raise AssertionError(f"rank {r}, check {name}:\n"
                                 f"{value['error']}")
        out.append(value)
    return out


# ---------------------------------------------------------------------------
# the checks: check(mesh, inputs, directory) -> picklable result
# ---------------------------------------------------------------------------
def _t(a):
    import numpy as np
    import torch

    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


def _block(a, mesh):
    from tpuflows_torch.dist import row_block

    return row_block(_t(a), mesh)


@check
def collectives(mesh, inp, directory):
    import torch
    from tpuflows_torch.dist.collectives import (all_gather,
                                                 fold_in_axis_index,
                                                 kish_ess_g, logsumexp_g,
                                                 pmax, pmean, psum)
    from tpuflows_torch.dist.mesh import replicate

    v, lw = _block(inp["v"], mesh), _block(inp["lw"], mesh)
    m = pmax(torch.max(lw), mesh)
    w = torch.exp(lw - m)
    s1, s2 = psum(torch.sum(w), mesh), psum(torch.sum(w * w), mesh)
    g = fold_in_axis_index(torch.Generator().manual_seed(5), mesh)
    module = torch.nn.Linear(3, 2)
    with torch.no_grad():
        for p in module.parameters():
            p.fill_(float(mesh.rank + 1))
    replicate(module, mesh)
    return {"lse": float(logsumexp_g(lw, mesh)),
            "kish": float(kish_ess_g(lw, mesh)),
            "kish_unfused": float(s1 * s1 / s2),
            "pmean": float(pmean(torch.mean(v), mesh)),
            "pmax": float(pmax(torch.max(v), mesh)),
            "psum": float(psum(torch.sum(v), mesh)),
            "gathered": _np(all_gather(v, mesh)),
            "fold": _np(torch.rand(4, generator=g)),
            "replicated": [_np(p) for p in module.parameters()]}


@check
def resample(mesh, inp, directory):
    import torch
    from tpuflows_torch.dist import resample_sharded

    out = []
    for case in inp["resample"]:
        leaves = tuple(_block(a, mesh) for a in case["leaves"])
        rows, anc = resample_sharded(
            torch.tensor(case["u0"]), leaves, _block(case["log_w"], mesh),
            mesh, gather_particles=case["gather"], n_out=case["n_out"])
        out.append({"anc": _np(anc), "rows": [_np(r) for r in rows]})
    return out


@check
def annealing(mesh, inp, directory):
    from tpuflows_torch.smc import next_beta

    return [float(next_beta(beta, _block(lr, mesh), target, mesh=mesh,
                            n_global=len(lr)))
            for beta, lr, target in inp["annealing"]]


@check
def stage(mesh, inp, directory):
    import torch
    from tpuflows_torch.io import load_pytree
    from tpuflows_torch.smc import SMCConfig
    from tpuflows_torch.smc.sampler import _stage_math
    from tpuflows_torch.targets import HierarchicalGaussian

    out = []
    for case in inp["stage"]:
        flows = load_pytree(case["flows"])
        target = HierarchicalGaussian.standard(dim=case["dim"],
                                               device="cpu")
        normals = _t(case["normals"]).transpose(0, 1)
        u = _t(case["u"]).transpose(0, 1)
        normals = _block(normals, mesh).transpose(0, 1)
        u = _block(u, mesh).transpose(0, 1)
        res = _stage_math(
            target.log_density, SMCConfig(**case["cfg"]),
            _block(case["x"], mesh), _block(case["log_w"], mesh),
            _block(case["log_q0_x"], mesh), _block(case["anc"], mesh),
            torch.tensor(case["beta"]), torch.tensor(case["eps"]),
            flows["q0"], flows["pre"], torch.tensor(case["u0"]),
            lambda s: (normals[s], u[s]), mesh)
        out.append([_np(t) for t in res])
    return out


@check
def dp_step(mesh, inp, directory):
    from tpuflows_torch.flows import Adam, negll_flow_loss
    from tpuflows_torch.flows.train import make_train_step
    from tpuflows_torch.io import load_pytree

    flow = load_pytree(inp["dp_step"]["flow"])
    opt = Adam(1e-3)
    state = opt.init(list(flow.parameters()))
    step = make_train_step(opt, negll_flow_loss, mesh)
    flow, state, loss = step(flow, state, _block(inp["dp_step"]["batch"],
                                                 mesh))
    return {"params": [_np(p) for p in flow.parameters()],
            "loss": float(loss)}


@check
def dp_fit(mesh, inp, directory):
    import torch
    from tpuflows_torch.dist import optimize_flow_dp
    from tpuflows_torch.flows import build_flow, negll_flow_loss

    samples = _t(inp["dp_fit"])
    flow = build_flow(samples, torch.Generator().manual_seed(1),
                      kind="affine", n_blocks=2, hidden=(16,), device="cpu")
    with torch.no_grad():
        loss0 = float(negll_flow_loss(flow, samples))
    res = optimize_flow_dp(torch.Generator().manual_seed(2),
                           _block(samples, mesh), flow, mesh, nbatches=4,
                           nepochs=30)
    with torch.no_grad():
        z = res.result.forward(samples)
        loss1 = float(negll_flow_loss(res.result, samples))
    return {"loss0": loss0, "loss1": loss1, "z_mean": _np(z.mean(0)),
            "z_std": _np(z.std(0)), "state": res.optimizer_state,
            "params": [_np(p) for p in res.result.parameters()],
            "loss_hist": _np(res.loss_hist)}


@check
def nuts(mesh, inp, directory):
    import torch
    from tpuflows_torch.dist import run_nuts_sharded
    from tpuflows_torch.targets import DiagNormal

    target = DiagNormal(loc=torch.tensor([2.0, -1.0]),
                        scale=torch.tensor([1.0, 0.5]))
    res = run_nuts_sharded(torch.Generator().manual_seed(1),
                           target.log_density, _block(inp["nuts_q0"], mesh),
                           mesh, num_warmup=200, num_samples=200)
    return {"samples": _np(res.samples), "step_size": _np(res.step_size),
            "inv_mass": _np(res.inv_mass)}


@check
def nuts_folded(mesh, inp, directory):
    """At a world of one, run_nuts_sharded equals run_nuts on the folded
    generator to the bit."""
    import torch
    from tpuflows_torch.dist import run_nuts_sharded
    from tpuflows_torch.dist.collectives import fold_in_axis_index
    from tpuflows_torch.mcmc import run_nuts
    from tpuflows_torch.targets import DiagNormal

    target = DiagNormal(loc=torch.tensor([2.0, -1.0]),
                        scale=torch.tensor([1.0, 0.5]))
    q0 = _t(inp["nuts_q0"])
    a = run_nuts_sharded(torch.Generator().manual_seed(1),
                         target.log_density, q0, mesh, num_warmup=50,
                         num_samples=50)
    b = run_nuts(fold_in_axis_index(torch.Generator().manual_seed(1), mesh),
                 target.log_density, q0, num_warmup=50, num_samples=50)
    return {"equal": all(torch.equal(x, y) for x, y in (
        (a.samples, b.samples), (a.step_size, b.step_size),
        (a.inv_mass, b.inv_mass)))}


@check
def nuts_k1(mesh, inp, directory):
    """run_nuts_sharded through `fused_nuts_for_flow` (K1); on CPU tensors
    its plain version, counted here."""
    import torch
    from tpuflows_torch.dist import run_nuts_sharded
    from tpuflows_torch.flows import build_flow
    from tpuflows_torch.kernels import nuts_cuda
    from tpuflows_torch.targets import NealsFunnel

    target = NealsFunnel(dim=8)
    init = torch.randn((256, 8), generator=torch.Generator().manual_seed(0))
    flow = build_flow(init, torch.Generator().manual_seed(1), kind="affine",
                      n_blocks=1, hidden=(16, 16), mask_scheme="leading",
                      clamp=8.0, device="cpu")
    calls = []
    plain = nuts_cuda.transition_math_torch

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    nuts_cuda.transition_math_torch = counted
    try:
        q0 = torch.randn((16, 8), generator=torch.Generator().manual_seed(2))
        res = run_nuts_sharded(
            torch.Generator().manual_seed(3), None, _block(q0, mesh), mesh,
            num_warmup=20, num_samples=10,
            transition=nuts_cuda.fused_nuts_for_flow(target, flow,
                                                     max_depth=4))
    finally:
        nuts_cuda.transition_math_torch = plain
    return {"plain_calls": len(calls), "launches": nuts_cuda.LAUNCHES,
            "finite": bool(torch.isfinite(res.samples).all()),
            "shape": tuple(res.samples.shape),
            "step_size": _np(res.step_size), "inv_mass": _np(res.inv_mass)}


@check
def mh(mesh, inp, directory):
    import torch
    from tpuflows_torch.mcmc import run_rwmh
    from tpuflows_torch.targets import StandardNormal

    t = StandardNormal(dim=3)
    mh = run_rwmh(torch.Generator().manual_seed(1), t.log_density,
                  _block(inp["mh_q0"], mesh), num_warmup=600,
                  num_samples=800, mesh=mesh)
    return {"mh_samples": _np(mh.samples), "mh_scale": _np(mh.scale),
            "mh_sigma": _np(mh.sigma),
            "mh_accept": float(mh.info.accept_prob.mean())}


@check
def pt(mesh, inp, directory):
    import torch
    from tpuflows_torch.mcmc import geometric_betas, run_parallel_tempering
    from tpuflows_torch.targets import GaussianMixture

    mix = GaussianMixture.bimodal(dim=2, separation=8.0, scale=0.5,
                                  device="cpu")
    pt = run_parallel_tempering(
        torch.Generator().manual_seed(0), mix.log_density,
        torch.zeros((16, 2)) + 4.0, geometric_betas(6, beta_min=0.02,
                                                    device="cpu"),
        num_warmup=500, num_samples=1000, mesh=mesh)
    return {"pt_samples": _np(pt.samples), "pt_scales": _np(pt.scales),
            "pt_accept": _np(pt.info.accept_prob),
            "pt_swap": _np(pt.info.swap_accept)}


@check
def heartbeat(mesh, inp, directory):
    from tpuflows_torch.dist import heartbeat as beat

    return [beat(mesh) for _ in range(3)]


@check
def heartbeat_skipped(mesh, inp, directory):
    """Rank 1 skips the probe: rank 0's times out. The last check of its
    world, since rank 0's all_reduce stays pending."""
    from tpuflows_torch.dist import (CollectiveTimeout, heartbeat,
                                     run_with_timeout)

    if mesh.rank != 0:
        time.sleep(6.0)  # alive, but not in the collective
        return "skipped"
    t0 = time.perf_counter()
    try:
        run_with_timeout(heartbeat, mesh, timeout_s=2.0)
    except CollectiveTimeout:
        return {"raised": "CollectiveTimeout",
                "seconds": time.perf_counter() - t0}
    return {"raised": None}


@check
def checkpoint_save(mesh, inp, directory):
    import torch
    from tpuflows_torch.io import save_pytree

    case = inp["checkpoint"]
    save_pytree(case["written_here"], {
        "particles": _block(case["full"], mesh),
        "flow_param": torch.arange(4.0),
        "key": torch.Generator().manual_seed(7), "beta": torch.tensor(0.5)},
        sharded=("particles",))
    return True


@check
def checkpoint_load(mesh, inp, directory):
    from tpuflows_torch.io import load_pytree

    out = load_pytree(inp["checkpoint"]["written_by_one"])
    return {"particles": _np(out["particles"]),
            "flow_param": _np(out["flow_param"]),
            "key": _np(out["key"].get_state()), "beta": float(out["beta"])}


# ---------------------------------------------------------------------------
# whole SMC runs (tests/test_torch_dist_runs.py)
# ---------------------------------------------------------------------------
REPLICATED = ("log_z", "betas", "ess_hist", "accept_hist", "log_z_sigma",
              "final_kish_ess", "unique_ancestors", "n_stages")


def _smc_problem(inp):
    import torch
    from tpuflows_torch.io import load_pytree
    from tpuflows_torch.targets import DiagNormal

    target = DiagNormal(loc=torch.tensor([1.0, 0.0]),
                        scale=torch.tensor([1.5, 0.7]))
    return target, load_pytree(inp["smc"]["flow"])


def _smc_record(res):
    rec = {k: (_np(v) if hasattr(v, "detach") else v)
           for k, v in res._asdict().items() if k in REPLICATED}
    rec["particles"] = _np(res.particles)
    rec["ancestors"] = _np(res.ancestors)
    rec["flow"] = [_np(p) for p in res.flow.parameters()]
    return rec


@check
def smc_runs(mesh, inp, directory):
    import copy

    import torch
    from tpuflows_torch.smc import SMCConfig, run_smc

    target, flow = _smc_problem(inp)
    out = {}
    for name, cfg in inp["smc"]["configs"].items():
        res = run_smc(torch.Generator().manual_seed(2), target.log_density,
                      copy.deepcopy(flow), 2, SMCConfig(**cfg), device="cpu",
                      mesh=mesh)
        out[name] = _smc_record(res)
    return out


@check
def smc_refusals(mesh, inp, directory):
    """The JAX sharded path's two checks: n % n_dev at the start, and the
    cross-fit's even half at the first retrain."""
    import copy

    import torch
    from tpuflows_torch.smc import SMCConfig, run_smc

    target, flow = _smc_problem(inp)
    out = {}
    for name, cfg in inp["smc"]["refused"].items():
        try:
            run_smc(torch.Generator().manual_seed(2), target.log_density,
                    copy.deepcopy(flow), 2, SMCConfig(**cfg), device="cpu",
                    mesh=mesh)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


@check
def smc_resume(mesh, inp, directory):
    """A run cut after two stages and resumed from its `smc_2` checkpoint
    (per-rank shards) equals the uninterrupted run to the bit; the
    checkpoint is kept for a world of another size."""
    import copy
    import shutil

    import torch
    import torch.distributed as dist
    from tpuflows_torch.smc import SMCConfig, run_smc

    target, flow = _smc_problem(inp)
    cfg = SMCConfig(**inp["smc"]["resume"])
    ckpt = inp["smc"]["checkpoint_dir"]
    ref = run_smc(torch.Generator().manual_seed(2), target.log_density,
                  copy.deepcopy(flow), 2, cfg, device="cpu", mesh=mesh)
    run_smc(torch.Generator().manual_seed(2), target.log_density,
            copy.deepcopy(flow), 2, cfg._replace(max_stages=2),
            checkpoint_dir=ckpt, device="cpu", mesh=mesh)
    if mesh.rank == 0:
        shutil.copytree(ckpt, ckpt + "_kept")
    dist.barrier()
    res = run_smc(torch.Generator().manual_seed(99), target.log_density,
                  copy.deepcopy(flow), 2, cfg, checkpoint_dir=ckpt,
                  device="cpu", mesh=mesh)
    return {"ref": _smc_record(ref), "resumed": _smc_record(res),
            "files": sorted(os.listdir(ckpt + "_kept"))}


@check
def smc_resume_other_world(mesh, inp, directory):
    """Resume the kept checkpoint of a world of another size."""
    import torch
    from tpuflows_torch.smc import SMCConfig, run_smc

    target, flow = _smc_problem(inp)
    cfg = SMCConfig(**inp["smc"]["resume"])
    res = run_smc(torch.Generator().manual_seed(99), target.log_density,
                  flow, 2, cfg, checkpoint_dir=inp["smc"]["checkpoint_dir"]
                  + "_kept", device="cpu", mesh=mesh)
    return _smc_record(res)


@check
def c5_runner_one(mesh, inp, directory):
    """The cut c5 through the config runner in this world of one: its
    record's log Z and final beta, and the delta-method sigma of the run
    (`run_smc` wrapped to keep its result)."""
    from tpuflows_torch import run as runner
    from tpuflows_torch import smc
    from tpuflows_torch.config import RunConfig

    captured = {}
    run_smc = smc.run_smc

    def probe(*args, **kwargs):
        captured["res"] = run_smc(*args, **kwargs)
        return captured["res"]

    smc.run_smc = probe
    try:
        rec = runner.run(RunConfig.from_json(inp["c5_cut"]), device="cpu")
    finally:
        smc.run_smc = run_smc
    return {"log_z": float(rec["log_z"]),
            "final_beta": float(rec["final_beta"]),
            "sigma": float(captured["res"].log_z_sigma)}


def _main(rank, world, directory, names):
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{directory}/init",
                            rank=rank, world_size=world)
    from tpuflows_torch.dist import worker_mesh

    mesh = worker_mesh(device="cpu")
    inputs = {}
    path = os.path.join(directory, "inputs.pkl")
    if os.path.exists(path):
        with open(path, "rb") as f:
            inputs = pickle.load(f)
    results = {}
    out = os.path.join(directory, f"rank{rank}.pkl")
    for name in names:
        try:
            results[name] = CHECKS[name](mesh, inputs, directory)
        except Exception:  # noqa: BLE001 — reported by the test
            results[name] = {"error": traceback.format_exc()}
        with open(out + ".tmp", "wb") as f:
            pickle.dump(results, f)
        os.replace(out + ".tmp", out)
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    _main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4:])
