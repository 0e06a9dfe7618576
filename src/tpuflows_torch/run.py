"""Config-file runner (port of `tpuflows/run.py`):

    python -m tpuflows_torch.run configs/c2_correlated_rqs.json [...]
    python -m tpuflows_torch.run --device cpu configs/c1_std_normal_affine.json
    python -m torch.distributed.run --standalone --nproc_per_node=2 \
        -m tpuflows_torch.run --device cpu configs/c5_hierarchical_smc.json

Runs each `RunConfig` task end to end on one device (default "cuda"),
writes one JSONL record per task through `MetricsLogger` (stdout, and the
file TPUFLOWS_METRICS names), with the JAX runner's keys, and saves the
task's state when `output_dir` is set. The `nuts` record adds one key,
`transition`: "fused" where K1 (or its plain version on the CPU) ran,
"portable" where the portable NUTS did.

Tasks: `fit` (forward KL on exact samples), `vi` (reverse KL), `nuts`
(VI-fitted flow, then flow-preconditioned NUTS), `mh` (adaptive
random-walk MH, or flow-independence MH from a VI-fitted flow), `pt`
(parallel tempering), `adaptive` (the train, sample, retrain loop, which
saves its best flow) and `smc` (annealed SMC from a flow built on normal
draws, or pretrained on the target's prior, checkpointing each stage
under `{output_dir}/smc_ckpt`). Every task of the JAX runner is ported.
Randomness comes from three `torch.Generator`s seeded from `cfg.seed`
(data, flow build, task), the roles of the JAX runner's three keys; the
draws differ from the JAX package's, so results agree in distribution,
not in value.

`main` first joins the world `torchrun` describes (`dist.init_distributed`:
NCCL, each rank on the CUDA device LOCAL_RANK; gloo under `--device
cpu`); without one it runs in one process. `smc.sharded` (c5 sets it)
runs the `smc` task's SMC over `dist.worker_mesh()`: the particles
row-sharded over that world, or a world of one over an in-process store,
through the same collectives. Every other task runs whole on each rank,
as in the JAX runner. Records and files go out from rank 0 only
(`MetricsLogger`); a sharded run's state is each rank's block of the
particles (`save_pytree(..., sharded=True)`).
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from tpuflows_torch.util.device import f32_device
from tpuflows_torch.util.profiling import MetricsLogger, Timer

# JSONL metrics: stdout on process 0, or the file TPUFLOWS_METRICS names
_metrics = MetricsLogger(path=os.environ.get("TPUFLOWS_METRICS"),
                         stream=sys.stdout)

TASKS = ("fit", "vi", "nuts", "mh", "pt", "adaptive", "smc")


def _emit(record: dict) -> None:
    _metrics.log(**record)


def run(cfg, device="cuda") -> dict:
    """Execute one config under the env-configured `FailurePolicy`
    (TPUFLOWS_COLLECTIVE_TIMEOUT_S). `smc` and `adaptive` guard each stage
    or each phase of each round themselves (`run_smc`, `adaptive_fit`),
    so the timeout is a per-stage budget there; the other tasks have no
    intermediate checkpoints, so each is guarded whole and the timeout
    must cover the full task."""
    from tpuflows_torch.dist import FailurePolicy

    if cfg.task in ("smc", "adaptive"):
        return _run_task(cfg, device)
    policy = FailurePolicy.from_env()
    return policy.guard(_run_task, cfg, device, phase=f"task:{cfg.task}")


def _generators(seed: int, device) -> list:
    """Three generators on `device` (data, flow build, task), seeded by
    numpy's SeedSequence from `seed`."""
    states = np.random.SeedSequence(seed).generate_state(3, dtype=np.uint64)
    return [torch.Generator(device=device).manual_seed(int(s) >> 1)
            for s in states]


def _flow_from_spec(samples, generator, spec, device):
    """build_flow with every FlowSpec knob applied (one call site per
    task)."""
    from tpuflows_torch.flows import build_flow

    return build_flow(samples, generator, kind=spec.kind,
                      n_blocks=spec.n_blocks, knots=spec.knots,
                      hidden=spec.hidden, use_pallas=spec.use_pallas,
                      mask_scheme=spec.mask_scheme,
                      n_leading=spec.n_leading, clamp=spec.clamp,
                      device=device)


def _nuts_transition(cfg, target, flow):
    """The transition `nuts.fused_kernel` asks for: K1 ("on", or "auto"
    where K1 takes the flow, the target and the depth), else None (the
    portable NUTS). K1 takes every target the runner builds (std_normal,
    diag_normal, correlated, mixture, funnel, hierarchical, banana,
    rosenbrock) at the config's own width up to `nuts_cuda.MAX_DIM` =
    1024, under an affine, rqs or arqs flow of any `hidden` (MLPs of 1 to
    8 layers, each width up to `nuts_cuda.MAX_HIDDEN` = 4096, padded to a
    multiple of 32), at any max_depth up to `nuts_cuda.MAX_DEPTH` = 16,
    as the JAX runner hands any target to its fused transition; past
    d = 256 or depth 10 it runs K1's wide unit (`nuts_cuda.wide_path`).
    Everything else is refused when the transition is built
    (`fused_nuts_for_flow`: `pack_flow`, `check_depth`), never at a
    launch: a target with no device form (a Posterior, a user Target), a
    width, hidden width or depth past those limits. "auto" then runs the
    portable NUTS, as the JAX runner does where it has no kernel, and
    "on" raises naming the limit. The choice does not depend on the
    device: on the CPU K1's plain version runs, as every kernel tier
    does."""
    from tpuflows_torch.kernels import nuts_cuda

    fk = cfg.nuts.fused_kernel
    if fk not in ("auto", "on", "off"):
        raise ValueError(f"unknown nuts.fused_kernel: {fk!r}")
    if fk == "on" and flow is None:
        raise ValueError(
            "nuts.fused_kernel='on' requires nuts.preconditioned=true "
            "(the fused transition runs in a flow's latent space)")
    if fk == "off" or flow is None:
        return None
    try:
        return nuts_cuda.fused_nuts_for_flow(target, flow,
                                             max_depth=cfg.nuts.max_depth)
    except ValueError as e:
        if fk == "on":
            raise ValueError(f"nuts.fused_kernel='on': {e}") from e
        return None


def _sampler_record(samples, **out) -> dict:
    from tpuflows_torch.diagnostics import effective_sample_size, split_rhat

    return {"min_ess": float(torch.min(effective_sample_size(samples))),
            "max_rhat": float(torch.max(split_rhat(samples))), **out}


def _run_task(cfg, device="cuda") -> dict:
    from tpuflows_torch.adaptive import adaptive_fit
    from tpuflows_torch.flows import Adam, optimize_flow
    from tpuflows_torch.io import save_pytree
    from tpuflows_torch.mcmc import (geometric_betas, run_flow_imh, run_nuts,
                                     run_parallel_tempering, run_rwmh)
    from tpuflows_torch.mcmc.preconditioned import (flow_reparameterized,
                                                    to_data_space)
    from tpuflows_torch.smc import run_smc
    from tpuflows_torch.vi import fit_vi

    if cfg.task not in TASKS:
        raise ValueError(f"unknown task: {cfg.task!r}")
    dev = f32_device(device)
    target = cfg.target.build(device=dev)
    dim = cfg.target.dim
    g_data, g_build, g_task = _generators(cfg.seed, dev)
    timer = Timer()
    sharded = False

    if cfg.task == "fit":
        samples = target.sample(g_data, cfg.train.n_fit_samples, device=dev)
        flow = _flow_from_spec(samples, g_build, cfg.flow, dev)
        res = optimize_flow(g_task, samples, flow,
                            Adam(cfg.train.learning_rate),
                            nbatches=cfg.train.nbatches,
                            nepochs=cfg.train.nepochs)
        out = {"final_loss": float(res.loss_hist[-1]),
               "initial_loss": float(res.loss_hist[0])}
        state = res.result
    elif cfg.task == "vi":
        init = torch.randn((cfg.train.batch_size, dim), generator=g_data,
                           device=dev)
        flow = _flow_from_spec(init, g_build, cfg.flow, dev)
        res = fit_vi(g_task, target.log_density, flow, dim,
                     optimizer=Adam(cfg.train.learning_rate),
                     batch_size=cfg.train.batch_size,
                     nsteps=cfg.train.nsteps, device=dev)
        out = {"final_elbo": float(res.final_elbo)}
        state = res.flow
    elif cfg.task == "adaptive":
        acfg = cfg.adaptive.to_adaptive_config(cfg.flow)
        res = adaptive_fit(g_task, target.log_density, dim, acfg,
                           verbose=True, device=dev)
        out = {"n_rounds": res.n_rounds, "converged": res.converged,
               "min_ess": float(res.rounds[-1].min_ess),
               "best_min_ess": float(res.best_min_ess),
               "flow_is_ess": float(res.rounds[-1].flow_is_ess)}
        # the best-measured preconditioner, not necessarily the last refit
        state = res.best_flow
    elif cfg.task == "mh":
        q0 = torch.randn((cfg.mh.n_chains, dim), generator=g_data,
                         device=dev)
        if cfg.mh.flow_proposal:
            init = torch.randn((2048, dim), generator=g_build, device=dev)
            flow = _flow_from_spec(init, g_build, cfg.flow, dev)
            flow = fit_vi(g_task, target.log_density, flow, dim,
                          batch_size=cfg.train.batch_size,
                          nsteps=cfg.train.nsteps, device=dev).flow
            res = run_flow_imh(g_task, target.log_density, flow, q0,
                               num_samples=cfg.mh.num_samples)
        else:
            res = run_rwmh(g_task, target.log_density, q0,
                           num_warmup=cfg.mh.num_warmup,
                           num_samples=cfg.mh.num_samples,
                           target_accept=cfg.mh.target_accept)
        out = _sampler_record(res.samples, accept_rate=float(
            torch.mean(res.info.accept_prob)))
        state = res.samples
    elif cfg.task == "pt":
        q0 = torch.randn((cfg.pt.n_chains, dim), generator=g_data,
                         device=dev)
        betas = geometric_betas(cfg.pt.n_temps, cfg.pt.beta_min, device=dev)
        res = run_parallel_tempering(
            g_task, target.log_density, q0, betas,
            num_warmup=cfg.pt.num_warmup, num_samples=cfg.pt.num_samples,
            target_accept=cfg.pt.target_accept)
        out = _sampler_record(res.samples, mean_swap_accept=float(
            torch.mean(res.info.swap_accept)))
        state = res.samples
    elif cfg.task == "smc":
        if cfg.smc.pretrain == "prior":
            # c5's recipe: build the bridge flow on draws from the
            # target's prior and fit it by forward KL there; the build
            # generator serves both, as the JAX runner's k_build does
            if not hasattr(target, "sample_prior"):
                raise ValueError(
                    f'smc.pretrain="prior" needs target.sample_prior; '
                    f"{cfg.target.kind!r} has none")
            init = target.sample_prior(g_data, cfg.smc.pretrain_draws,
                                       device=dev)
            flow = _flow_from_spec(init, g_build, cfg.flow, dev)
            flow = optimize_flow(g_build, init, flow,
                                 Adam(cfg.smc.pretrain_lr),
                                 nbatches=cfg.smc.pretrain_batches,
                                 nepochs=cfg.smc.pretrain_epochs).result
        else:
            init = torch.randn((2048, dim), generator=g_data, device=dev)
            flow = _flow_from_spec(init, g_build, cfg.flow, dev)
        mesh = None
        if cfg.smc.sharded:
            from tpuflows_torch.dist import worker_mesh

            mesh = worker_mesh(device=dev)
        ckpt = f"{cfg.output_dir}/smc_ckpt" if cfg.output_dir else None
        res = run_smc(g_task, target.log_density, flow, dim,
                      cfg.smc.to_smc_config(), verbose=True,
                      checkpoint_dir=ckpt, device=dev, mesh=mesh)
        out = {"n_stages": res.n_stages, "log_z": float(res.log_z),
               "final_beta": float(res.betas[-1]),
               "mean_accept": float(torch.mean(res.accept_hist))}
        state = res.particles
        sharded = mesh is not None
    else:  # nuts
        q0 = torch.randn((cfg.nuts.n_chains, dim), generator=g_data,
                         device=dev)
        if cfg.nuts.preconditioned:
            init = torch.randn((2048, dim), generator=g_build, device=dev)
            flow = _flow_from_spec(init, g_build, cfg.flow, dev)
            flow = fit_vi(g_task, target.log_density, flow, dim,
                          batch_size=cfg.train.batch_size,
                          nsteps=cfg.train.nsteps, device=dev).flow
            logp = flow_reparameterized(target.log_density, flow)
        else:
            flow = None
            logp = target.log_density
        transition = _nuts_transition(cfg, target, flow)
        res = run_nuts(g_task, logp, q0, num_warmup=cfg.nuts.num_warmup,
                       num_samples=cfg.nuts.num_samples,
                       max_depth=cfg.nuts.max_depth,
                       target_accept=cfg.nuts.target_accept,
                       warmup_schedule=cfg.nuts.warmup_schedule,
                       transition=transition)
        x = res.samples
        if flow is not None:
            x = to_data_space(flow, x)
        out = _sampler_record(
            x, step_size=float(res.step_size),
            divergence_rate=float(torch.mean(res.info.diverging.float())),
            transition="portable" if transition is None else "fused")
        state = x

    out.update({"name": cfg.name, "task": cfg.task,
                "wall_s": round(timer.stop(sync_on=state), 2)})
    if cfg.output_dir:
        save_pytree(f"{cfg.output_dir}/{cfg.name}_state", state,
                    sharded=sharded)
    _emit(out)
    return out


def main(argv=None) -> None:
    from tpuflows_torch.config import RunConfig
    from tpuflows_torch.dist import init_distributed

    parser = argparse.ArgumentParser(
        prog="python -m tpuflows_torch.run",
        description="Run configs/*.json tasks on the PyTorch port.")
    parser.add_argument("configs", nargs="+", metavar="config.json")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    joined = torch.distributed.is_initialized()
    init_distributed(backend="gloo" if device.type == "cpu" else None)
    if device.type == "cuda" and device.index is None \
            and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    for path in args.configs:
        run(RunConfig.from_json(path), device=device)
    # the world this call formed (torchrun's, or a sharded config's world
    # of one) ends with it
    if not joined and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
