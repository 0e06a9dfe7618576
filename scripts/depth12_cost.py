"""What c4 costs past the tile kernels' depth: c4_funnel_nuts.json's
flow fitted once as the runner fits it (VI, c4's steps and batch), then
c4's NUTS (1024 chains, 128 warmup steps, 512 draws) from the same start
three ways, each timed on the host around a synchronized run:

  tile     K1's tile kernel at max_depth 10, the most it takes;
  wide     K1 at max_depth 12, which runs its wide unit
           (csrc/nuts_transition_wide.cu; nuts_cuda.wide_path);
  portable the portable NUTS (tpuflows_torch.mcmc) at max_depth 12.

Each row: seconds and ms a transition, K1's launches (tile and wide),
the step size, mean leapfrogs a draw, the tree depths reached and the
draws' min ESS. Prints the card's name and power limit, then one JSON
line per row.

    python scripts/depth12_cost.py
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402


def main():
    from tpuflows_torch.config import RunConfig
    from tpuflows_torch.diagnostics import effective_sample_size
    from tpuflows_torch.kernels import nuts_cuda
    from tpuflows_torch.mcmc import run_nuts, to_data_space
    from tpuflows_torch.mcmc.preconditioned import flow_reparameterized
    from tpuflows_torch.run import _flow_from_spec, _generators
    from tpuflows_torch.vi import fit_vi

    if not torch.cuda.is_available():
        print("depth12_cost.py: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    dev = "cuda"
    cfg = RunConfig.from_json(os.path.join(ROOT, "configs",
                                           "c4_funnel_nuts.json"))
    target = cfg.target.build(device=dev)
    dim = cfg.target.dim
    g_data, g_build, g_task = _generators(cfg.seed, dev)
    q0 = torch.randn((cfg.nuts.n_chains, dim), generator=g_data, device=dev)
    init = torch.randn((2048, dim), generator=g_build, device=dev)
    flow = _flow_from_spec(init, g_build, cfg.flow, dev)
    t = time.perf_counter()
    flow = fit_vi(g_task, target.log_density, flow, dim,
                  batch_size=cfg.train.batch_size, nsteps=cfg.train.nsteps,
                  device=dev).flow
    torch.cuda.synchronize()
    print(json.dumps({"fit_s": time.perf_counter() - t}), flush=True)
    logp = flow_reparameterized(target.log_density, flow)
    n_transitions = cfg.nuts.num_warmup + cfg.nuts.num_samples
    for name, depth, fused in (("tile", 10, True), ("wide", 12, True),
                               ("portable", 12, False)):
        transition = (nuts_cuda.fused_nuts_for_flow(target, flow,
                                                    max_depth=depth)
                      if fused else None)
        nuts_cuda.LAUNCHES = nuts_cuda.WIDE_LAUNCHES = 0
        g = torch.Generator(device=dev).manual_seed(cfg.seed)
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = run_nuts(g, logp, q0, num_warmup=cfg.nuts.num_warmup,
                       num_samples=cfg.nuts.num_samples, max_depth=depth,
                       target_accept=cfg.nuts.target_accept,
                       warmup_schedule=cfg.nuts.warmup_schedule,
                       transition=transition)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        x = to_data_space(flow, res.samples)
        depths = res.info.tree_depth.reshape(-1).long()
        print(json.dumps({
            "row": name, "max_depth": depth, "seconds": seconds,
            "ms_per_transition": 1e3 * seconds / n_transitions,
            "k1_launches": nuts_cuda.LAUNCHES,
            "k1_wide_launches": nuts_cuda.WIDE_LAUNCHES,
            "step_size": float(res.step_size),
            "mean_leapfrogs_per_draw": float(
                res.info.num_steps.float().mean()),
            "draw_depth_histogram": torch.bincount(
                depths, minlength=depth + 1).tolist(),
            "min_ess": float(effective_sample_size(x).min())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
