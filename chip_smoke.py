#!/usr/bin/env python3
"""Drive tpuflows_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; one CUDA card

Phases, one JSON line each on stdout with its wall time in seconds:
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — K1 (src/tpuflows_torch/csrc/nuts_transition.cu) with nvcc,
               and ptxas' registers, shared memory and spills;
  3. kernel_vs_plain — K1 against its plain PyTorch version
               (`transition_math_torch`, autograd gradient) at the bench
               widths (1024 chains, d = 64, max_depth 6, MLP 64-128-128-128)
               on the same precomputed randomness, through a seeded random
               flow with a non-zero last layer. The bar is the JAX kernel's
               own on-chip bar (docs/artifacts/nuts_kernel_onchip_diff.json):
               at most 5 of 1024 chains disagree on tree decisions; on the
               rest energy agrees to 0.012 and q to 2.3e-4 (absolute);
     kernel_shapes — the same, under the same bar (flips scaled to the
               chain count), at one shape for each other instantiation of
               K1 (d = 32..256), hidden widths 32..256, depths to 10,
               random masks, random Standardize leaves and random metrics,
               and at the bench shape with random leaves and metric;
  4. main_path — config 4 of bench.py (`ceiling` variant): a 6000-step
               reverse-KL/STL fit at batch 1024 of Standardize + one
               leading-mask affine coupling on the 64-d funnel, then NUTS
               with 1024 chains through K1: 128 warmup steps, then windows
               of 512 draws until max split-R-hat < 1.05 and min ESS >=
               10000 on data-space draws (at most 4 windows, else it fails).
               K1's launch count is set to 0 before and must equal the
               number of transitions after; v's draws must pass a 5-sigma
               moment check against N(0, 9);
  5. timing  — K1 and its plain version with CUDA events at the main path's
               post-warmup state (trained flow, adapted metric and step
               size), beside the bound of the work; the two are held to the
               same bar there.
Then the card's nvidia-smi line, the kernels' JSON line and, last,
{"ok": true, "device": {...}}. Any failure raises: the exit code is not 0
and the last line is not printed. It imports nothing of JAX.
"""
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

DIM = 64
N_CHAINS = 1024
HIDDEN = (128, 128)
CLAMP = 8.0
MAX_DEPTH = 6
TRAIN_STEPS = 6000
TRAIN_BATCH = 1024
NUM_WARMUP = 128
DRAW_WINDOW = 512
MAX_WINDOWS = 4
RHAT_GATE = 1.05
ESS_GATE = 10_000.0
# kernel-vs-plain bar: the JAX kernel's on-chip bar
MAX_FLIPS = 5
MAX_DENERGY = 0.012
MAX_DQ = 2.3e-4
# published float32 (non-tensor-core) rate and memory rate of one H100 SXM
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

T0 = time.perf_counter()


def emit(phase, t_start, **kw):
    print(json.dumps({"phase": phase,
                      "seconds": round(time.perf_counter() - t_start, 3),
                      **kw}), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log):
    """Registers, shared memory and spills of each instantiation of the
    kernel (template argument = d / 32), from nvcc -Xptxas -v."""
    rows, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            t = re.search(r"ILi(\d+)E", m.group(1))
            cur = f"d/32={t.group(1)}" if t else m.group(1)
            rows[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rows[cur]["spill_stores"] = int(m.group(1))
            rows[cur]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows[cur]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            rows[cur]["static_smem"] = int(s.group(1)) if s else 0
    return rows


def bench_flow_with_random_head(device, seed):
    """The flow the JAX kernel's on-chip bar was measured with
    (scripts/nuts_kernel_onchip_diff.py: `build_flow` on N(0, 1) samples),
    except that its last layer is random and non-zero, so that the MLP
    path is exercised."""
    import torch
    from tpuflows_torch.flows import build_flow

    g = torch.Generator(device=device).manual_seed(seed)
    init = torch.randn((1024, DIM), generator=g, device=device)
    flow = build_flow(init, g, kind="affine", n_blocks=1, hidden=HIDDEN,
                      mask_scheme="leading", clamp=CLAMP, device=device)
    net = flow.transforms[1].net
    with torch.no_grad():
        w3, b3 = net.weights[2], net.biases[2]
        w3.copy_(0.3 * math.sqrt(2.0 / w3.shape[0]) * torch.randn(
            w3.shape, generator=g, device=device))
        b3.copy_(0.1 * torch.randn(b3.shape, generator=g, device=device))
    return flow


def random_flow(device, seed, dim, hidden, mask):
    """Standardize + one affine coupling with every leaf random from
    `seed` (non-zero last layer)."""
    import torch
    from tpuflows_torch.flows import AffineCoupling, Chain, MLP, Standardize

    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    sizes = (dim, *hidden, 2 * dim)
    ws = [math.sqrt(2.0 / a) * randn(a, b)
          for a, b in zip(sizes[:-1], sizes[1:])]
    ws[-1] = 0.3 * ws[-1]
    bs = [0.1 * randn(b) for b in sizes[1:]]
    return Chain([Standardize(0.3 * randn(dim), 0.2 * randn(dim)),
                  AffineCoupling(mask, MLP(ws, bs), clamp=CLAMP)])


def compare(plain, kern):
    """Knife-edge chains (any disagreement on leapfrog count, depth,
    divergence or U-turn, or a q difference above 1e-3 that reveals a
    flipped proposal) and the largest differences on the other chains."""
    import torch

    flip = torch.zeros_like(plain[1], dtype=torch.bool)
    for i in (3, 4, 5, 6):
        flip |= plain[i] != kern[i]
    dq = (plain[0] - kern[0]).abs().amax(dim=1)
    flip |= dq > 1e-3
    agree = ~flip

    def worst(x):
        return float(x[agree].max()) if bool(agree.any()) else float("nan")

    n = int(plain[1].numel())
    res = {"chains": n, "flips": int(flip.sum()), "max_dq": worst(dq),
           "max_denergy": worst((plain[7] - kern[7]).abs()),
           "max_dlogp": worst((plain[1] - kern[1]).abs())}
    # the bar, with the flips scaled to the chain count
    res["passed"] = bool(res["flips"] <= max(1, n * MAX_FLIPS // 1024)
                         and res["max_denergy"] <= MAX_DENERGY
                         and res["max_dq"] <= MAX_DQ)
    return res


def kernel_vs_plain(device, flow, n, depth, eps, seed, unit_metric):
    """K1 against its plain version on one set of inputs: q ~ N(0, 1), a
    unit or a random diagonal metric, and the precomputed randomness."""
    import torch
    from tpuflows_torch.kernels import nuts_cuda
    from tpuflows_torch.targets import NealsFunnel

    d = flow.transforms[0].loc.numel()
    target = NealsFunnel(dim=d)
    model = nuts_cuda.pack_affine_funnel(flow, target)
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((n, d), generator=g, device=device)
    im = (torch.ones(d, device=device) if unit_metric
          else 0.5 + torch.rand(d, generator=g, device=device))
    e = torch.tensor(eps, device=device)
    rnd = nuts_cuda.draw_randomness(g, n, d, depth, im)
    kern = nuts_cuda.nuts_transition(q, *rnd, e, im, model, depth)
    plain = nuts_cuda.transition_math_torch(
        q, *rnd, e, im,
        nuts_cuda.autograd_logp_grad(flow, target.log_density), depth)
    for t in kern:
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError("K1 returned non-finite values")
    res = compare(plain, kern)
    res["depth_histogram"] = torch.bincount(
        plain[4].long(), minlength=depth + 1).tolist()
    res["divergent_chains"] = int(plain[5].sum())
    return res


# (d, h1, h2, max_depth, eps, chains, mask): the bench shape with the
# bench's leading mask, then one shape for every other instantiation of K1
# (d / 32 = 1, 3, ..., 8), hidden widths 32..256, depths up to the
# kernel's 10, random 0/1 masks
OTHER_SHAPES = [(64, 128, 128, 6, 0.3, 1024, "leading"),
                (32, 32, 64, 3, 0.3, 256, "random"),
                (96, 64, 32, 5, 0.2, 256, "random"),
                (128, 256, 128, 4, 0.2, 256, "random"),
                (160, 96, 160, 8, 0.05, 128, "random"),
                (192, 160, 224, 7, 0.05, 128, "random"),
                (224, 32, 32, 10, 0.02, 64, "random"),
                (256, 128, 256, 2, 0.1, 256, "random")]


def kernel_shapes(device, shapes=OTHER_SHAPES):
    """K1 against its plain version with every flow leaf and the metric
    random, at the bench shape and away from it."""
    import torch
    from tpuflows_torch.util.shapes import leading_mask

    rows = []
    for d, h1, h2, depth, eps, n, scheme in shapes:
        g = torch.Generator().manual_seed(d)
        mask = (leading_mask(d) if scheme == "leading" else
                tuple(torch.randint(0, 2, (d,), generator=g).tolist()))
        flow = random_flow(device, d + h1, d, (h1, h2), mask)
        res = kernel_vs_plain(device, flow, n, depth, eps, seed=d + h2,
                              unit_metric=False)
        rows.append({"d": d, "h1": h1, "h2": h2, "max_depth": depth,
                     "eps": eps, "mask": scheme, **res})
    return rows


def moment_z(x, true_mean, true_var):
    """z-scores of the mean and variance of draws x (n, m) of one scalar,
    with ESS-based standard errors (as tpuflows' moment_gate)."""
    from tpuflows_torch.diagnostics import effective_sample_size

    xs = x[..., None]
    nm = x.numel()
    ess = float(effective_sample_size(xs)[0].clamp(2.0, nm))
    ess_v = float(effective_sample_size(xs * xs)[0].clamp(2.0, nm))
    flat = x.reshape(-1).double()
    mean, var = float(flat.mean()), float(flat.var(correction=0))
    m4 = float(((flat - mean) ** 4).mean())
    z_mean = abs(mean - true_mean) / math.sqrt(true_var / ess)
    z_var = abs(var - true_var) / math.sqrt(
        max(m4 - var * var, 2.0 * true_var ** 2) / ess_v)
    return z_mean, z_var, mean, var


def main_path(device, dim=DIM, n_chains=N_CHAINS, hidden=HIDDEN,
              train_steps=TRAIN_STEPS, train_batch=TRAIN_BATCH,
              num_warmup=NUM_WARMUP, window=DRAW_WINDOW,
              max_windows=MAX_WINDOWS, ess_gate=ESS_GATE):
    """Phase 4: fit, warmup and gated draw windows through the port's entry
    points. Returns (result dict, trained flow, final NUTSState)."""
    import torch
    from tpuflows_torch.diagnostics import effective_sample_size, split_rhat
    from tpuflows_torch.flows import (ClipAdamCosine, build_flow,
                                      make_reverse_kl_trainer)
    from tpuflows_torch.kernels import nuts_cuda
    from tpuflows_torch.mcmc import NUTSDriver, to_data_space
    from tpuflows_torch.targets import NealsFunnel
    from tpuflows_torch.vi import elbo

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    target = NealsFunnel(dim=dim)
    nuts_cuda.LAUNCHES = 0
    init = torch.randn((1024, dim), generator=gen(1), device=device)
    flow = build_flow(init, gen(2), kind="affine", n_blocks=1, hidden=hidden,
                      mask_scheme="leading", clamp=CLAMP, device=device)
    trainer = make_reverse_kl_trainer(
        target.log_density, dim,
        ClipAdamCosine(lr=1e-2, decay_steps=train_steps, alpha=0.03,
                       max_norm=10.0),
        batch_size=train_batch, stl=True, device=device)
    t = time.perf_counter()
    res = trainer(gen(3), flow, train_steps)
    sync()
    train_time = time.perf_counter() - t
    final_elbo = float(elbo(gen(7), flow, target.log_density, dim,
                            device=device))

    transition = nuts_cuda.fused_nuts_for_flow(target, flow,
                                               max_depth=MAX_DEPTH)
    driver = NUTSDriver(transition=transition)
    q0 = torch.randn((n_chains, dim), generator=gen(4), device=device)
    t = time.perf_counter()
    state = driver.warmup(gen(5), q0, num_warmup)
    sync()
    warm_time = time.perf_counter() - t
    warm_state = state

    draw_time = 0.0
    zs, infos = [], []
    converged = False
    g_draw = gen(6)
    for w in range(max_windows):
        t = time.perf_counter()
        state, z, info = driver.draws(g_draw, state, window)
        sync()
        draw_time += time.perf_counter() - t
        zs.append(z)
        infos.append(info)
        x = to_data_space(flow, torch.cat(zs))
        min_ess = float(effective_sample_size(x).min())
        max_rhat = float(split_rhat(x).max())
        print(json.dumps({"window": w, "draws": int(x.shape[0]),
                          "min_ess": min_ess, "max_rhat": max_rhat}),
              file=sys.stderr, flush=True)
        if max_rhat < RHAT_GATE and min_ess >= ess_gate:
            converged = True
            break
    launches = nuts_cuda.LAUNCHES
    transitions = num_warmup + window * len(zs)
    if not bool(torch.isfinite(x).all()) or x.shape != (
            window * len(zs), n_chains, dim):
        raise RuntimeError(f"draws are not finite or have shape "
                           f"{tuple(x.shape)}")
    z_mean, z_var, v_mean, v_var = moment_z(x[..., 0], 0.0,
                                            target.sigma_v ** 2)
    div = torch.cat([i.diverging.reshape(-1) for i in infos]).float().mean()
    steps = torch.cat([i.num_steps.reshape(-1) for i in infos]).float()
    out = {
        "train_steps": train_steps, "train_time_s": train_time,
        "train_final_loss": float(res.loss_hist[-1]),
        "final_elbo": final_elbo,
        "warmup_time_s": warm_time, "draw_time_s": draw_time,
        "windows": len(zs), "n_draws": int(x.shape[0]),
        "min_ess": min_ess, "max_rhat": max_rhat, "converged": converged,
        "v_mean": v_mean, "v_var": v_var, "v_z_mean": z_mean,
        "v_z_var": z_var, "divergence_rate": float(div),
        "mean_leapfrogs_per_draw": float(steps.mean()),
        "step_size": float(state.step_size),
        "launches": launches, "transitions": transitions,
    }
    return out, flow, warm_state


def time_kernel(flow, state, n_reps=50):
    """Phase 5: K1 and its plain version at the post-warmup state, timed
    with CUDA events on the same inputs, and the bound of the work."""
    import torch
    from tpuflows_torch.kernels import nuts_cuda
    from tpuflows_torch.targets import NealsFunnel

    target = NealsFunnel(dim=DIM)
    model = nuts_cuda.pack_affine_funnel(flow, target)
    dev = state.q.device
    g = torch.Generator(device=dev).manual_seed(8)
    q, eps, im = state.q.contiguous(), state.step_size, state.inv_mass
    rnd = nuts_cuda.draw_randomness(g, N_CHAINS, DIM, MAX_DEPTH, im)

    def run_kernel():
        return nuts_cuda.nuts_transition(q, *rnd, eps, im, model, MAX_DEPTH)

    logp_grad = nuts_cuda.autograd_logp_grad(flow, target.log_density)

    def run_plain():
        return nuts_cuda.transition_math_torch(q, *rnd, eps, im, logp_grad,
                                               MAX_DEPTH)

    def timed(fn, reps):
        for _ in range(3):
            out = fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps, out

    ms, kern = timed(run_kernel, n_reps)
    plain_ms, plain = timed(run_plain, 5)
    # the work this run's data needs: one gradient at q plus one per
    # leapfrog, each an MLP forward and input-gradient backward
    d, h1, h2 = model.d, model.h1, model.h2
    leaves = float(kern[3].sum()) + N_CHAINS
    flops = leaves * 2 * 2 * (d * h1 + h1 * h2 + h2 * 2 * d)
    flow_floats = 3 * d + d * h1 + h1 + h1 * h2 + h2 + h2 * 2 * d + 2 * d
    n_in = (2 * N_CHAINS * d + 2 * N_CHAINS * MAX_DEPTH
            + N_CHAINS * (1 << MAX_DEPTH) + 1 + d + flow_floats)
    n_out = N_CHAINS * d + 7 * N_CHAINS
    nbytes = 4.0 * (n_in + n_out)
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {"ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes, "leapfrogs": leaves,
            "achieved_tflops": flops / (ms * 1e-3) / 1e12,
            "vs_plain_at_state": compare(plain, kern)}


def main():
    t = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from tpuflows_torch.kernels import nuts_cuda

    smi = nvidia_smi_line()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("device", t, nvidia_smi=smi, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    device = "cuda"

    t = time.perf_counter()
    info = nuts_cuda.build()
    emit("build", t, nvcc_seconds=info.seconds, library=info.path,
         ptxas=ptxas_summary(info.log))

    t = time.perf_counter()
    # the setting of the JAX kernel's on-chip bar: unit metric, eps 0.3
    cmp = kernel_vs_plain(device, bench_flow_with_random_head(device, 2),
                          N_CHAINS, MAX_DEPTH, eps=0.3, seed=3,
                          unit_metric=True)
    emit("kernel_vs_plain", t, **cmp,
         bar={"flips": MAX_FLIPS, "denergy": MAX_DENERGY, "dq": MAX_DQ})
    if not cmp["passed"]:
        raise RuntimeError(f"K1 disagrees with its plain version: {cmp}")

    t = time.perf_counter()
    rows = kernel_shapes(device)
    emit("kernel_shapes", t, rows=rows)
    bad = [r for r in rows if not r["passed"]]
    if bad:
        raise RuntimeError(f"K1 disagrees with its plain version: {bad}")

    t = time.perf_counter()
    res, flow, warm_state = main_path(device)
    emit("main_path", t, **res)
    if not res["converged"]:
        raise RuntimeError("convergence gate failed: max split-R-hat "
                           f"{res['max_rhat']}, min ESS {res['min_ess']}")
    if res["launches"] <= 0 or res["launches"] != res["transitions"]:
        raise RuntimeError(f"K1 launched {res['launches']} times for "
                           f"{res['transitions']} transitions")
    if res["v_z_mean"] > 5.0 or res["v_z_var"] > 5.0:
        raise RuntimeError(f"v's draws fail the moment check: {res}")

    t = time.perf_counter()
    tim = time_kernel(flow, warm_state)
    emit("timing", t, **tim)
    if not tim["vs_plain_at_state"]["passed"]:
        raise RuntimeError("K1 disagrees with its plain version at the main "
                           f"path's state: {tim['vs_plain_at_state']}")

    kernels = [{
        "name": "nuts_transition",
        "route": "cuda",
        "source": "src/tpuflows_torch/csrc/nuts_transition.cu",
        "replaces": "src/tpuflows/kernels/nuts_pallas.py:407",
        "launches": res["launches"],
        "max_abs_err": cmp["max_dq"],
        "ms": tim["ms"],
        "plain_ms": tim["plain_ms"],
        "bound_ms": tim["bound_ms"],
        "bound_by": tim["bound_by"],
        "library_ms": None,
    }]
    print(json.dumps({"total_seconds": time.perf_counter() - T0}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
