#!/usr/bin/env python3
"""Drive tpuflows_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; one CUDA card

Phases, one JSON line each on stdout with its wall time in seconds:
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — every kernel with nvcc, all units in parallel: K1
               (csrc/nuts_transition.cu), K4/K5 (csrc/rqs_spline.cu) and
               K6/K7 (csrc/coupling_block.cu), and ptxas' registers, shared
               memory and spills per kernel;
  3. rqs_vs_plain — K4 (forward and inverse spline) and K5 (their
               pullbacks) against their plain PyTorch versions at the fit's
               shape (1024 x 64, K = 8) and three others (d = 8, 96, 256;
               K = 4, 12), raw ~ N(0, 1), x spread over [-6, 6], on y,
               ladj, dx and draw. The bar is the JAX package's for its
               Pallas spline against the oracle (tests/test_pallas.py:
               jnp.allclose, atol 1e-4 and its default rtol 1e-5), with the
               plain version in float64 as referee: float32 itself does not
               resolve some ill-conditioned elements of dx and draw to that
               bar, so the kernel must be as accurate against float64 as
               the two float32 plain versions (`judge`);
  4. kernel_vs_plain — K1 against its plain PyTorch version
               (`transition_math_torch`) at the bench widths (1024 chains,
               d = 64, max_depth 6, MLP 64-128-128-128) on the same
               precomputed randomness, through a seeded random flow with a
               non-zero last layer. The bar is the JAX kernel's own on-chip
               bar (docs/artifacts/nuts_kernel_onchip_diff.json): at most 5
               of 1024 chains disagree on tree decisions; on the rest
               energy agrees to 0.012 and q to 2.3e-4 (absolute);
     kernel_shapes — the same, under the same bar (flips scaled to the
               chain count), at one shape for each other instantiation of
               K1 (d = 32..256), hidden widths 32..256, depths to 10,
               random masks, random Standardize leaves and random metrics,
               and at the bench shape with random leaves and metric;
  5. kernel_vs_plain_spline — K1's module-list kernel against the plain
               version (streamed per-block gradient on the p-major flow)
               under K1's bar, through a seeded arqs flow at the bench
               widths (3 x (affine + spline), K = 8, mixed masks) whose
               last layers are random and small, 1024 chains, depth 6,
               eps 0.3, unit metric; and at d = 32 and 256 (K = 16, 54 KB of
               shared memory per warp). One more row,
               with large random last layers (SPLINE_CHAOS), is printed
               beside the spread of two plain versions on the same inputs
               and is not held to the bar: there the trajectories are so
               sensitive that two float32 evaluations of the same math
               disagree on many chains;
  6. main_path — config 4 of bench.py (`ceiling` variant): a 6000-step
               reverse-KL/STL fit at batch 1024 of Standardize + one
               leading-mask affine coupling on the 64-d funnel, then NUTS
               with 1024 chains through K1: 128 warmup steps, then windows
               of 512 draws until max split-R-hat < 1.05 and min ESS >=
               10000 on data-space draws (at most 4 windows, else it fails).
               K1's launch count is set to 0 before and must equal the
               number of transitions after; v's draws must pass a 5-sigma
               moment check against N(0, 9);
  7. timing  — K1 and its plain version with CUDA events at the main path's
               post-warmup state (trained flow, adapted metric and step
               size), beside the bound of the work; the two are held to the
               same bar there;
  8. main_path_generic — the `generic` variant of bench.py: the arqs flow
               (Standardize + 3 x (affine + spline), K = 8, hidden 128 x
               128, mixed masks, clamp 8) fitted the same way, every spline
               through K4 and K5, then NUTS through K1's module-list kernel
               under the same gates. The launch counts are set to 0 before:
               K1's must equal the transitions, K4's and K5's 6 per fit step
               (3 spline blocks, inverse and forward) plus the final ELBO's
               and the data-space mapping's inverses;
  9. timing_generic — K4 and K5 at the fit's shape (also replayed from a
               CUDA graph, the device's time alone), and K1 at the generic
               path's post-warmup state, with CUDA events, beside their
               bounds and their plain versions' times. K1 is held to K1's
               bar there, with q's bar raised to twice the spread of two
               plain versions on the same inputs (`time_kernel`).
 10. coupling_vs_plain — K6 (the whole spline coupling block) and K7 (its
               pullback) against their plain PyTorch versions, both
               directions, on z, ladj, dx and every weight's and bias's
               cotangent: the fit's shape (1024 x 64, hidden 128 x 128,
               K = 8) under each mixed mask, a ragged batch of 37, d = 256
               (a 3 MB last layer, streamed), and two rows off the main
               path (tanh and relu conditioners, one and three hidden
               layers); last layers 0.1 N(0, 1) and 0.01 x He. The bar is
               K4/K5's (`judge`, refereed by float64), at the quantile
               `block_quantile`; K7 must repeat itself to the bit;
 11. main_path_generic_fused — the generic variant with every spline block
               on the fused tier (use_pallas="fused"), under the same
               gates; K6's and K7's launch counts must equal the counts the
               path implies and K4/K5 must launch 0 times;
 12. timing_coupling — K6 and K7 with CUDA events at the fit's shape and at
               d = 256 (also replayed from a CUDA graph), beside their
               bounds and plain versions, and the same block's times on the
               K4/K5 tier.
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
# the generic variant's flow (bench.py `make_flow0`)
KNOTS = 8
GENERIC_BLOCKS = 3
# kernel-vs-plain bar: the JAX kernel's on-chip bar
MAX_FLIPS = 5
MAX_DENERGY = 0.012
MAX_DQ = 2.3e-4
# spline-kernel bar: jnp.allclose(atol=1e-4) of tests/test_pallas.py,
# with jnp.allclose's default rtol
RQS_ATOL = 1e-4
RQS_RTOL = 1e-5
# random last layers of the spline flows held to K1's bar, as a multiple
# of the He scale (biases 0.1); SPLINE_CHAOS is the informative row's
SPLINE_HEAD = 0.01
SPLINE_CHAOS = 0.3
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


def _kernel_key(name):
    """A short name for a kernel's mangled name."""
    t = re.search(r"ILi(\d+)E", name)
    if "nuts_transition_kernel" in name and t:
        return f"d/32={t.group(1)}"
    if "nuts_chain_kernel" in name and t:
        return f"chain d/32={t.group(1)}"
    for kern, label in (("rqs_eval_kernel", "K4"), ("rqs_grad_kernel", "K5"),
                        ("coupling_fwd_kernel", "K6"),
                        ("coupling_bwd_kernel", "K7 pass 1")):
        if kern in name:
            return f"{label} {'inverse' if 'ILb1E' in name else 'forward'}"
    if "weight_grad_kernel" in name:
        return "K7 pass 2"
    return name


def ptxas_summary(log):
    """Registers, shared memory and spills of each kernel (K1's keyed by
    its template argument d / 32), from nvcc -Xptxas -v."""
    rows, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = _kernel_key(m.group(1))
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


def timed(fn, reps, warmup=3):
    """Mean ms of fn() over `reps` calls with CUDA events, and its last
    result."""
    import torch

    for _ in range(warmup):
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


def graph_ms(fn, reps=20, replays=10):
    """Mean ms of fn() on the device alone: `reps` calls captured in one
    CUDA graph, replayed `replays` times between CUDA events. `timed`
    launches from the host, and a kernel shorter than its wrapper's host
    work (checks, ctypes, allocation) is timed at the host's pace."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


# ---------------------------------------------------------------------------
# K4 / K5
# ---------------------------------------------------------------------------
# (rows, d, knots): the fit's shape, then three others
RQS_SHAPES = [(TRAIN_BATCH, DIM, KNOTS), (333, 8, 4), (200, 96, 12),
              (64, 256, 4)]


def rqs_inputs(device, n, d, K, seed):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    x = 12.0 * torch.rand((n, d), generator=g, device=device) - 6.0
    raw = torch.randn((n, d, 3 * K - 1), generator=g, device=device)
    gy = torch.randn((n, d), generator=g, device=device)
    gl = torch.randn((n, d), generator=g, device=device)
    return x, raw, gy, gl


def _within(a, b):
    """Elements where a agrees with b to the bar: jnp.allclose's test
    |a - b| <= atol + rtol |b|."""
    return (a - b).abs() <= RQS_ATOL + RQS_RTOL * b.abs()


def _units(a, b):
    """|a - b| in units of the bar around b."""
    return (a - b).abs() / (RQS_ATOL + RQS_RTOL * b.abs())


def judge(kern, plain, oracle, exact, quantile=0.999):
    """The spline kernels' bar on one output, refereed by `exact`, the
    plain version in float64. Two float32 evaluations of the same
    function, `plain` (the tile math) and `oracle` (`flows/rqs_ref.py`),
    give float32's own error: a few ill-conditioned elements of dx and
    draw (very narrow or flat bins) miss the JAX package's bar in every
    float32 evaluation, some by thousands of bars, so the largest error is
    noise. The kernel must be as accurate as they are: its count of
    elements beyond the bar of float64 and its `quantile` error (in units
    of the bar; the 99.9th percentile for K4/K5) may exceed the worse
    plain version's by at most 25% (plus one element, plus 0.1 bar)."""
    import torch

    exact = exact.float()
    errs = {k: _units(t, exact).flatten()
            for k, t in (("kernel", kern), ("plain", plain),
                         ("oracle", oracle))}
    miss = {k: int((v > 1.0).sum()) for k, v in errs.items()}
    q = {k: float(torch.quantile(v, quantile)) for k, v in errs.items()}
    worst_miss = max(miss["plain"], miss["oracle"])
    worst_q = max(q["plain"], q["oracle"])
    return {"max_abs": float((kern - plain).abs().max()),
            "beyond_bar_of_plain": int((~_within(kern, plain)).sum()),
            "beyond_bar_of_f64": miss, "quantile": quantile, "q_bars": q,
            "max_bars": {k: float(v.max()) for k, v in errs.items()},
            "passed": bool(torch.isfinite(kern).all()
                           and miss["kernel"] <= 1.25 * worst_miss + 1
                           and q["kernel"] <= 1.25 * worst_q + 0.1)}


def oracle_eval(x, raw, inverse):
    from tpuflows_torch.flows import rqs_ref

    fn = rqs_ref.rqs_inverse_from_raw if inverse else \
        rqs_ref.rqs_forward_from_raw
    return fn(x, raw, 4.0)


def oracle_grad(x, raw, gy, gl, inverse):
    import torch

    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        rg = raw.detach().requires_grad_(True)
        return torch.autograd.grad(oracle_eval(xg, rg, inverse), (xg, rg),
                                   (gy, gl))


def rqs_vs_plain(device, shapes=RQS_SHAPES):
    """K4 and K5 against their plain versions, both directions, refereed
    by the plain version in float64 (`judge`)."""
    from tpuflows_torch.kernels import rqs_cuda

    rows = []
    for n, d, K in shapes:
        x, raw, gy, gl = rqs_inputs(device, n, d, K, seed=n + d + K)
        f64 = [t.double() for t in (x, raw, gy, gl)]
        for inverse in (False, True):
            outs = (
                ("y", "ladj", rqs_cuda.spline_eval(x, raw, 4.0, inverse),
                 rqs_cuda.plain_eval(x, raw, 4.0, inverse),
                 oracle_eval(x, raw, inverse),
                 rqs_cuda.plain_eval(*f64[:2], 4.0, inverse)),
                ("dx", "draw",
                 rqs_cuda.spline_grad(x, raw, gy, gl, 4.0, inverse),
                 rqs_cuda.plain_grad(x, raw, gy, gl, 4.0, inverse),
                 oracle_grad(x, raw, gy, gl, inverse),
                 rqs_cuda.plain_grad(*f64, 4.0, inverse)))
            row = {"n": n, "d": d, "knots": K,
                   "direction": "inverse" if inverse else "forward"}
            for n1, n2, k, p, o, e in outs:
                for j, name in enumerate((n1, n2)):
                    row[name] = judge(k[j], p[j], o[j], e[j])
            row["passed"] = all(row[m]["passed"]
                                for m in ("y", "ladj", "dx", "draw"))
            rows.append(row)
    return rows


def rqs_bytes_ops(n_el, K):
    """(K4 bytes, K4 ops, K5 bytes, K5 ops) for n_el elements: each input
    read once and each output written once (x, 3K-1 raw in, y and ladj
    out; K5 also reads gy, gl and writes dx, draw), and a count of the
    spline's arithmetic that takes each exp, log, division and select as
    one operation (normalisation ~8K, running knot select ~17K, evaluation
    ~30; the pullback about as much again plus ~12K)."""
    P = 3 * K - 1
    k4_ops = 25 * K + 30
    return (4.0 * n_el * (1 + P + 2), float(n_el * k4_ops),
            4.0 * n_el * (1 + P + 2 + 1 + P), float(n_el * (2 * k4_ops
                                                             + 12 * K + 60)))


def time_rqs(device, n_reps=200, plain_reps=20):
    """K4 and K5 at the fit's shape, forward and inverse, with CUDA events
    (launched from the host, and replayed from a CUDA graph: `graph_ms`),
    beside their bounds and the plain versions."""
    from tpuflows_torch.kernels import rqs_cuda

    n, d, K = RQS_SHAPES[0]
    x, raw, gy, gl = rqs_inputs(device, n, d, K, seed=n + d + K)
    b4, o4, b5, o5 = rqs_bytes_ops(n * d, K)
    out = {}
    for inverse in (False, True):
        direction = "inverse" if inverse else "forward"
        for kname, nbytes, ops, kern, plain in (
                ("k4", b4, o4,
                 lambda: rqs_cuda.spline_eval(x, raw, 4.0, inverse),
                 lambda: rqs_cuda.plain_eval(x, raw, 4.0, inverse)),
                ("k5", b5, o5,
                 lambda: rqs_cuda.spline_grad(x, raw, gy, gl, 4.0, inverse),
                 lambda: rqs_cuda.plain_grad(x, raw, gy, gl, 4.0,
                                             inverse))):
            ms, res = timed(kern, n_reps)
            plain_ms, ref = timed(plain, plain_reps)
            t_bytes = nbytes / PEAK_BYTES * 1e3
            t_ops = ops / PEAK_F32_FLOPS * 1e3
            out[f"{kname}_{direction}"] = {
                "ms": ms, "device_ms": graph_ms(kern), "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "ops": ops,
                "max_abs_err": max(float((a - b).abs().max())
                                   for a, b in zip(res, ref))}
    return out


# ---------------------------------------------------------------------------
# K6 / K7
# ---------------------------------------------------------------------------
# (rows, d, hidden, knots, mask, head, activation): the fit's shape under
# each of the mixed masks, a ragged batch, d = 256 (where the JAX package's
# own "auto" picks this tier; its last layer, 128 x 5888 floats, is
# streamed), and two rows off the main path: the other activations, one
# and three hidden layers, other knots, and spline dims that fill no whole
# chunk (16 of 32) or end in a partial one (48). head: the last layer's
# weights, "n0.1" = 0.1 N(0, 1) (the JAX tests'), "he0.01" = 0.01 x the He
# scale (SPLINE_HEAD, as the gated spline rows of K1); other weights He,
# biases 0.1 N(0, 1).
COUPLING_SHAPES = [
    (TRAIN_BATCH, DIM, HIDDEN, KNOTS, "alternating0", "n0.1", "silu"),
    (TRAIN_BATCH, DIM, HIDDEN, KNOTS, "alternating1", "n0.1", "silu"),
    (TRAIN_BATCH, DIM, HIDDEN, KNOTS, "block0", "n0.1", "silu"),
    (TRAIN_BATCH, DIM, HIDDEN, KNOTS, "block1", "n0.1", "silu"),
    (TRAIN_BATCH, DIM, HIDDEN, KNOTS, "alternating0", "he0.01", "silu"),
    (37, DIM, HIDDEN, KNOTS, "alternating1", "n0.1", "silu"),
    (TRAIN_BATCH, 256, HIDDEN, KNOTS, "alternating0", "n0.1", "silu"),
    (TRAIN_BATCH, 256, HIDDEN, KNOTS, "block1", "he0.01", "silu"),
    (300, 32, (64,), 4, "alternating0", "n0.1", "tanh"),
    (513, 96, (96, 48, 80), 12, "block0", "he0.01", "relu")]
COUPLING_PARAMS = ("w0", "b0", "w1", "b1", "w2", "b2")


def param_names(n_params):
    """w0, b0, w1, b1, ... for a conditioner's flat parameters."""
    return tuple(f"{'wb'[j % 2]}{j // 2}" for j in range(n_params))


def coupling_mask(name, d):
    from tpuflows_torch.util.shapes import alternating_mask, block_mask

    kind, i = name[:-1], int(name[-1])
    return alternating_mask(d, i) if kind == "alternating" else \
        block_mask(d, i)


def coupling_inputs(device, n, d, hidden, K, head, seed):
    """(x, flat p-major params, gz, gladj), drawn on `device`: x ~ 2 N(0,
    1) (the JAX test's spread; some of it beyond B = 4), He hidden
    weights, the last layer's weights as `head` says, biases 0.1 N(0, 1),
    cotangents N(0, 1)."""
    import torch
    from tpuflows_torch.kernels.tile_flow import p_major

    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    P = 3 * K - 1
    sizes = (d, *hidden, P * d)
    params = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        w = randn(a, b)
        if i < len(hidden):
            w = math.sqrt(2.0 / a) * w
        elif head == "n0.1":
            w = 0.1 * w
        else:
            w = 0.01 * math.sqrt(2.0 / a) * w
        bias = 0.1 * randn(b)
        if i == len(hidden):  # drawn d-major, as a module holds them
            w, bias = p_major(w, d, P), p_major(bias, d, P)
        params += [w.contiguous(), bias.reshape(1, -1).contiguous()]
    return 2.0 * randn(n, d), tuple(params), randn(n, d), randn(n)


def oracle_block(x, params, mask, K, inverse, activation="silu"):
    """The block through the oracle spline (`flows/rqs_ref.py`) on the
    same flat p-major parameters: a float32 evaluation independent of the
    tile math. Returns (z, ladj (T,))."""
    import torch
    from tpuflows_torch.flows import rqs_ref
    from tpuflows_torch.flows.nets import _ACTIVATIONS

    act = _ACTIVATIONS[activation]
    T, d = x.shape
    ws, bs = params[0::2], params[1::2]
    h = x * mask
    for w, b in zip(ws[:-1], bs[:-1]):
        h = act(h @ w + b)
    raw = (h @ ws[-1] + bs[-1]).reshape(T, 3 * K - 1, d).transpose(1, 2)
    fn = rqs_ref.rqs_inverse_from_raw if inverse else \
        rqs_ref.rqs_forward_from_raw
    y, ladj_el = fn(x, raw, 4.0)
    z = mask * x + (1.0 - mask) * y
    return z, torch.sum((1.0 - mask) * ladj_el, dim=-1)


def oracle_block_vjp(x, params, mask, K, inverse, gz, gl, activation):
    import torch

    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        pg = [p.detach().requires_grad_(True) for p in params]
        out = oracle_block(xg, pg, mask, K, inverse, activation)
        return torch.autograd.grad(out, (xg, *pg), (gz, gl))


def block_quantile(n):
    """The error quantile `judge` compares for an output of n values: the
    99.9th percentile, or the 10th-largest error where that is lower (the
    median at most). A bias's cotangent or a per-row ladj has only
    10^2-10^3 values, and there the 99.9th percentile is the largest
    error, which is noise (`judge`)."""
    return max(0.5, min(0.999, 1.0 - 10.0 / n))


def coupling_vs_plain(device, shapes=COUPLING_SHAPES):
    """K6 and K7 against their plain versions, both directions, on z, ladj,
    dx and every weight's and bias's cotangent, refereed by the plain
    version in float64 (`judge`, the spline kernels' bar, at the quantile
    `block_quantile`). Both plain versions take their conditioner from
    PyTorch's matmul, so they share its rounding; the kernels sum their own
    products and round differently, which the bar's comparison against
    float64 allows for. K7 runs twice and must repeat itself to the bit
    (its sums have a fixed order), and its dx without the weights' pass
    must equal its dx with it."""
    import torch
    from tpuflows_torch.kernels import coupling_cuda as cc

    rows = []
    for n, d, hidden, K, mask_name, head, act in shapes:
        mask_t = coupling_mask(mask_name, d)
        x, params, gz, gl = coupling_inputs(device, n, d, hidden, K, head,
                                            seed=n + d + K)
        m32 = torch.tensor(mask_t, dtype=torch.float32, device=device)
        f64 = [t.double() for t in (x, *params, gz, gl)]
        x64, p64, gz64, gl64 = f64[0], tuple(f64[1:-2]), f64[-2], f64[-1]
        for inverse in (False, True):
            spec = cc.BlockSpec(mask_t, K, 4.0, act, inverse)
            kz = cc.block_eval(x, params, spec)
            kdx, kdp = cc.block_grad(x, params, spec, gz, gl)
            rdx, rdp = cc.block_grad(x, params, spec, gz, gl)
            odx, _ = cc.block_grad(x, params, spec, gz, gl,
                                   need_params=False)
            pz = cc.plain_block(x, params, m32, K, 4.0, act, inverse)
            pdx, pdp = cc.plain_block_vjp(x, params, m32, gz, gl, K, 4.0,
                                          act, inverse)
            oz = oracle_block(x, params, m32, K, inverse, act)
            odx2, *odp = oracle_block_vjp(x, params, m32, K, inverse, gz, gl,
                                          act)
            ez = cc.plain_block(x64, p64, m32.double(), K, 4.0, act, inverse)
            edx, edp = cc.plain_block_vjp(x64, p64, m32.double(), gz64,
                                          gl64, K, 4.0, act, inverse)
            row = {"n": n, "d": d, "hidden": list(hidden), "knots": K,
                   "mask": mask_name, "head": head, "activation": act,
                   "direction": "inverse" if inverse else "forward"}
            outs = [("z", kz[0], pz[0], oz[0], ez[0]),
                    ("ladj", kz[1], pz[1], oz[1], ez[1]),
                    ("dx", kdx, pdx, odx2, edx)]
            outs += [(name, k, p, o, e) for name, k, p, o, e in zip(
                param_names(len(params)), kdp, pdp, odp, edp)]
            for name, k, p, o, e in outs:
                row[name] = judge(k, p, o, e, block_quantile(k.numel()))
            row["repeats_bitwise"] = bool(
                torch.equal(kdx, rdx) and torch.equal(kdx, odx)
                and all(torch.equal(a, b) for a, b in zip(kdp, rdp)))
            row["passed"] = row["repeats_bitwise"] and all(
                row[name]["passed"] for name, *_ in outs)
            rows.append(row)
    return rows


def coupling_work(n, d, hidden, K, nt):
    """(K6 ops, K6 bytes, K7 ops, K7 bytes, K7 pass-1 ops, pass-1 bytes)
    of a block on n rows with nt spline dims. The work the function needs:
    the conditioner's products over the hidden layers and over the spline
    dims' P nt columns of the last layer (a pass-through dim's columns
    reach nothing), 2 operations per multiply-add, and the spline's
    arithmetic counted as in `rqs_bytes_ops`; K7 recomputes the
    conditioner, pulls back through each layer (2 products) and, for the
    weights, forms H^T G (one more). Bytes: each input read once (x, the
    cotangents, the weights it needs) and each output written once (z and
    ladj; dx and, for K7, the whole of every cotangent of the weights)."""
    P = 3 * K - 1
    widths = (d, *hidden)
    mac = sum(a * b for a, b in zip(widths[:-1], widths[1:])) \
        + hidden[-1] * P * nt
    k4_ops = 25 * K + 30
    spline = n * nt * k4_ops
    spline_vjp = n * nt * (2 * k4_ops + 12 * K + 60)
    need = mac + sum(hidden) + P * nt  # weights and biases read
    full = sum(a * b + b for a, b in zip((*widths,), (*hidden, P * d)))
    k6_ops = 2.0 * n * mac + spline
    k6_bytes = 4.0 * (n * d + need + d + n * d + n)
    k7a_ops = 4.0 * n * mac + spline_vjp
    k7a_bytes = 4.0 * (2 * n * d + n + need + d + n * d)
    return (k6_ops, k6_bytes, k7a_ops + 2.0 * n * mac,
            k7a_bytes + 4.0 * full, k7a_ops, k7a_bytes)


def _bound(ops, nbytes):
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


# (rows, d, hidden, knots, mask): the fit's shape and d = 256
COUPLING_TIMING_SHAPES = [(TRAIN_BATCH, DIM, HIDDEN, KNOTS, "alternating0"),
                          (TRAIN_BATCH, 256, HIDDEN, KNOTS, "alternating0")]


def time_coupling(device, shapes=COUPLING_TIMING_SHAPES, n_reps=200,
                  plain_reps=20):
    """K6 and K7 with CUDA events at the fit's shape and at d = 256, both
    directions, launched from the host (`timed`) and replayed from a CUDA
    graph (`graph_ms`, the device alone), beside their bounds and their
    plain versions. K7 is timed
    as the fit runs it: with the weights' pass in the inverse direction
    (the sample path, whose weights train) and without it in the forward
    direction (the STL loss's detached pass); the other variant is timed
    too. Beside them, the same block on the K4/K5 tier (torch.matmul
    conditioner + K4/K5) and on this tier through autograd, forward alone
    and forward + backward with every cotangent: a comparison of tiers,
    not a library call (no single PyTorch call computes a block)."""
    import torch
    from tpuflows_torch.flows import MLP, RQSCouplingBlock
    from tpuflows_torch.kernels import coupling_cuda as cc

    rows = []
    for n, d, hidden, K, mask_name in shapes:
        mask_t = coupling_mask(mask_name, d)
        nt = sum(1 for m in mask_t if m == 0)
        x, params, gz, gl = coupling_inputs(device, n, d, hidden, K, "n0.1",
                                            seed=n + d + K)
        m32 = torch.tensor(mask_t, dtype=torch.float32, device=device)
        k6_ops, k6_bytes, k7_ops, k7_bytes, k7a_ops, k7a_bytes = \
            coupling_work(n, d, hidden, K, nt)
        row = {"n": n, "d": d, "hidden": list(hidden), "knots": K,
               "mask": mask_name, "spline_dims": nt}
        for inverse in (False, True):
            direction = "inverse" if inverse else "forward"
            spec = cc.BlockSpec(mask_t, K, 4.0, "silu", inverse)
            fit_params = inverse  # what the fit runs
            cases = (
                ("k6", k6_ops, k6_bytes,
                 lambda: cc.block_eval(x, params, spec),
                 lambda: cc.plain_block(x, params, m32, K, 4.0, "silu",
                                        inverse)),
                ("k7", *((k7_ops, k7_bytes) if fit_params
                         else (k7a_ops, k7a_bytes)),
                 lambda: cc.block_grad(x, params, spec, gz, gl,
                                       need_params=fit_params),
                 lambda: cc.plain_block_vjp(x, params, m32, gz, gl, K, 4.0,
                                            "silu", inverse)))
            for kname, ops, nbytes, kern, plain in cases:
                ms, _ = timed(kern, n_reps)
                plain_ms, _ = timed(plain, plain_reps)
                bound_ms, bound_by = _bound(ops, nbytes)
                row[f"{kname}_{direction}"] = {
                    "ms": ms, "device_ms": graph_ms(kern),
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "ops": ops, "bytes": nbytes,
                    "with_weight_pass": kname == "k7" and fit_params}
            other_ms, _ = timed(lambda: cc.block_grad(
                x, params, spec, gz, gl, need_params=not fit_params), n_reps)
            row[f"k7_{direction}"]["other_variant_ms"] = other_ms
            # the same block on both tiers, through the module
            ws = list(params[0::2])
            bs = [b.reshape(-1) for b in params[1::2]]
            P = 3 * K - 1
            ws[-1] = ws[-1].reshape(-1, P, d).transpose(1, 2).reshape(
                -1, d * P)
            bs[-1] = bs[-1].reshape(P, d).t().reshape(-1)
            net = MLP([w.contiguous() for w in ws],
                      [b.contiguous() for b in bs])
            tiers = {}
            for tier in (True, "fused"):
                blk = RQSCouplingBlock(mask_t, net, knots=K,
                                       use_pallas=tier)
                f = blk.inverse_and_ladj if inverse else blk.forward_and_ladj

                def ev(f=f):
                    with torch.no_grad():
                        return f(x)

                def ev_grad(f=f):
                    xx = x.detach().requires_grad_(True)
                    z, ladj = f(xx)
                    return torch.autograd.grad(
                        (z, ladj), (xx, *net.parameters()), (gz, gl))

                tiers["k4k5" if tier is True else "fused"] = {
                    "eval_ms": timed(ev, n_reps // 4)[0],
                    "eval_grad_ms": timed(ev_grad, n_reps // 4)[0]}
            row[f"tiers_{direction}"] = tiers
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------
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


def spline_flow_with_random_heads(device, seed, dim=DIM, hidden=HIDDEN,
                                  knots=KNOTS, n_blocks=GENERIC_BLOCKS,
                                  head=SPLINE_HEAD):
    """The generic path's arqs flow as bench.py builds it on N(0, 1)
    samples, with every conditioner's last layer random: weights `head`
    times the He scale, biases 0.1 N(0, 1). Drawn on the CPU, so that the
    same flow can be carried to the JAX package there."""
    import torch
    from tpuflows_torch.flows import build_flow

    g = torch.Generator().manual_seed(seed)
    init = torch.randn((1024, dim), generator=g)
    flow = build_flow(init, g, kind="arqs", n_blocks=n_blocks, knots=knots,
                      hidden=hidden, mask_scheme="mixed", clamp=CLAMP,
                      use_pallas="auto", device=device)
    with torch.no_grad():
        for t in flow.transforms[1:]:
            w, b = t.net.weights[-1], t.net.biases[-1]
            w.copy_(head * math.sqrt(2.0 / w.shape[0])
                    * torch.randn(w.shape, generator=g))
            b.copy_(0.1 * torch.randn(b.shape, generator=g))
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


def compare(plain, kern, max_dq=MAX_DQ):
    """Knife-edge chains (any disagreement on leapfrog count, depth,
    divergence or U-turn, or a q difference above 1e-3 that reveals a
    flipped proposal) and the largest differences on the other chains,
    against K1's bar (with `max_dq` for q)."""
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
                         and res["max_dq"] <= max_dq)
    return res


def spline_inputs(device, n, d, depth, seed, unit_metric):
    """q ~ N(0, 1), the metric and the randomness of a spline row, drawn on
    the CPU (as `spline_flow_with_random_heads`) and moved to `device`."""
    import torch
    from tpuflows_torch.kernels import nuts_cuda

    g = torch.Generator().manual_seed(seed)
    q = torch.randn((n, d), generator=g)
    im = torch.ones(d) if unit_metric else 0.5 + torch.rand(d, generator=g)
    rnd = nuts_cuda.draw_randomness(g, n, d, depth, im)
    return [t.to(device) for t in (q, im, *rnd)]


def kernel_vs_plain(device, flow, n, depth, eps, seed, unit_metric,
                    plain_spread=False, cpu_inputs=False):
    """K1 against its plain version on one set of inputs: q ~ N(0, 1), a
    unit or a random diagonal metric, and the precomputed randomness
    (drawn on the card, or on the CPU with `cpu_inputs`). `plain_spread`
    also compares two plain versions (the streamed and the whole-flow
    autograd gradient) on the same inputs."""
    import torch
    from tpuflows_torch.kernels import nuts_cuda
    from tpuflows_torch.targets import NealsFunnel

    d = flow.transforms[0].loc.numel()  # every flow here is standardized
    model = nuts_cuda.pack_flow(flow, NealsFunnel(dim=d))
    target = model.target
    if cpu_inputs:
        q, im, *rnd = spline_inputs(device, n, d, depth, seed, unit_metric)
    else:
        g = torch.Generator(device=device).manual_seed(seed)
        q = torch.randn((n, d), generator=g, device=device)
        im = (torch.ones(d, device=device) if unit_metric
              else 0.5 + torch.rand(d, generator=g, device=device))
        rnd = nuts_cuda.draw_randomness(g, n, d, depth, im)
    e = torch.tensor(eps, device=device)
    kern = nuts_cuda.nuts_transition(q, *rnd, e, im, model, depth)
    plain = nuts_cuda.transition_math_torch(
        q, *rnd, e, im, nuts_cuda.plain_logp_grad(model), depth)
    for t in kern:
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError("K1 returned non-finite values")
    res = compare(plain, kern)
    res["depth_histogram"] = torch.bincount(
        plain[4].long(), minlength=depth + 1).tolist()
    res["divergent_chains"] = int(plain[5].sum())
    if plain_spread:
        other = nuts_cuda.transition_math_torch(
            q, *rnd, e, im,
            nuts_cuda.autograd_logp_grad(flow, target.log_density), depth)
        res["plain_vs_plain"] = compare(plain, other)
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


# (d, hidden, knots, blocks, max_depth, eps, chains, unit metric, head):
# the setting of the bar at the bench widths, two other instantiations of
# the module-list kernel (at d = 256 with K = 16 the warp's scratch is 54
# KB, above the 48 KB a launch gets without opting in), and the
# informative row with large random heads
SPLINE_SHAPES = [(64, HIDDEN, KNOTS, GENERIC_BLOCKS, 6, 0.3, 1024, True,
                  SPLINE_HEAD),
                 (32, (32, 64), 4, 2, 5, 0.2, 256, False, SPLINE_HEAD),
                 (256, (64, 128), 16, 1, 4, 0.1, 128, False, SPLINE_HEAD)]
SPLINE_CHAOS_SHAPE = (64, HIDDEN, KNOTS, GENERIC_BLOCKS, 6, 0.3, 1024, True,
                      SPLINE_CHAOS)


def kernel_vs_plain_spline(device, shapes=SPLINE_SHAPES,
                           chaos=SPLINE_CHAOS_SHAPE):
    """K1's module-list kernel against its plain version on arqs flows;
    the `chaos` row also reports the spread of two plain versions."""
    rows = []
    for i, (d, hidden, K, nb, depth, eps, n, unit, head) in enumerate(
            [*shapes, *([chaos] if chaos else [])]):
        flow = spline_flow_with_random_heads(device, 10 + d, dim=d,
                                             hidden=hidden, knots=K,
                                             n_blocks=nb, head=head)
        res = kernel_vs_plain(device, flow, n, depth, eps, seed=20 + d,
                              unit_metric=unit, plain_spread=True,
                              cpu_inputs=True)
        rows.append({"d": d, "hidden": list(hidden), "knots": K,
                     "blocks": nb, "max_depth": depth, "eps": eps,
                     "head_scale": head, "gated": i < len(shapes), **res})
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


def main_path(device, variant="ceiling", dim=DIM, n_chains=N_CHAINS,
              hidden=HIDDEN, train_steps=TRAIN_STEPS,
              train_batch=TRAIN_BATCH, num_warmup=NUM_WARMUP,
              window=DRAW_WINDOW, max_windows=MAX_WINDOWS,
              ess_gate=ESS_GATE, knots=KNOTS, n_blocks=GENERIC_BLOCKS,
              use_pallas="auto"):
    """Fit, warmup and gated draw windows through the port's entry points,
    for bench.py's `ceiling` variant (Standardize + one leading-mask affine
    coupling) or its `generic` variant (the arqs flow, its spline blocks on
    the tier `use_pallas`: "auto" is K4/K5, "fused" K6/K7). Returns
    (result dict, trained flow, post-warmup NUTSState)."""
    import torch
    from tpuflows_torch.diagnostics import effective_sample_size, split_rhat
    from tpuflows_torch.flows import (ClipAdamCosine, RQSCouplingBlock,
                                      build_flow, make_reverse_kl_trainer)
    from tpuflows_torch.kernels import coupling_cuda, nuts_cuda, rqs_cuda
    from tpuflows_torch.mcmc import NUTSDriver, to_data_space
    from tpuflows_torch.mcmc.preconditioned import _CHUNK
    from tpuflows_torch.targets import NealsFunnel
    from tpuflows_torch.vi import elbo

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    target = NealsFunnel(dim=dim)
    nuts_cuda.LAUNCHES = 0
    rqs_cuda.reset_launches()
    coupling_cuda.reset_launches()
    init = torch.randn((1024, dim), generator=gen(1), device=device)
    if variant == "generic":
        flow = build_flow(init, gen(2), kind="arqs", n_blocks=n_blocks,
                          knots=knots, hidden=hidden, mask_scheme="mixed",
                          clamp=CLAMP, use_pallas=use_pallas, device=device)
    elif variant == "ceiling":
        flow = build_flow(init, gen(2), kind="affine", n_blocks=1,
                          hidden=hidden, mask_scheme="leading", clamp=CLAMP,
                          device=device)
    else:
        raise ValueError(f"unknown variant {variant!r}")
    n_rqs = sum(isinstance(t, RQSCouplingBlock) for t in flow.transforms)
    trainer = make_reverse_kl_trainer(
        target.log_density, dim,
        ClipAdamCosine(lr=1e-2, decay_steps=train_steps, alpha=0.03,
                       max_norm=10.0),
        batch_size=train_batch, stl=True, device=device)
    t = time.perf_counter()
    res = trainer(gen(3), flow, train_steps)
    sync()
    train_time = time.perf_counter() - t
    fit_launches = dict(rqs_cuda.LAUNCHES)
    fit_coupling = dict(coupling_cuda.LAUNCHES)
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
    mapped_rows = []
    g_draw = gen(6)
    for w in range(max_windows):
        t = time.perf_counter()
        state, z, info = driver.draws(g_draw, state, window)
        sync()
        draw_time += time.perf_counter() - t
        zs.append(z)
        infos.append(info)
        x = to_data_space(flow, torch.cat(zs))
        mapped_rows.append(x.shape[0] * n_chains)
        min_ess = float(effective_sample_size(x).min())
        max_rhat = float(split_rhat(x).max())
        print(json.dumps({"variant": variant, "window": w,
                          "draws": int(x.shape[0]), "min_ess": min_ess,
                          "max_rhat": max_rhat}),
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
    depths = torch.cat([i.tree_depth.reshape(-1) for i in infos]).long()
    # On the card every fit step runs each spline block's inverse (the
    # sample path) and forward (the STL loss's log q) and both pullbacks;
    # the ELBO and each data-space mapping call run the inverses. On the
    # K4/K5 tier that is one K4 and one K5 launch each. On the fused tier
    # it is one K6 launch each; K7 launches pass 1 for both pullbacks and
    # pass 2 (the weights' cotangents) for the inverse's only, since the
    # forward pass's weights are detached.
    inverse_calls = 1 + sum(-(-r // _CHUNK) for r in mapped_rows)
    per = n_rqs if on_card else 0
    fused = use_pallas == "fused"
    per_rqs, per_fused = (0, per) if fused else (per, 0)
    expected = {"k4_forward": per_rqs * train_steps,
                "k4_inverse": per_rqs * (train_steps + inverse_calls),
                "k5_forward": per_rqs * train_steps,
                "k5_inverse": per_rqs * train_steps}
    expected_coupling = {
        "k6_forward": per_fused * train_steps,
        "k6_inverse": per_fused * (train_steps + inverse_calls),
        "k7_forward": per_fused * train_steps,
        "k7_inverse": 2 * per_fused * train_steps}
    out = {
        "variant": variant, "modules": len(flow.transforms),
        "train_steps": train_steps, "train_time_s": train_time,
        "train_ms_per_step": 1e3 * train_time / max(train_steps, 1),
        "train_final_loss": float(res.loss_hist[-1]),
        "final_elbo": final_elbo,
        "warmup_time_s": warm_time, "draw_time_s": draw_time,
        "windows": len(zs), "n_draws": int(x.shape[0]),
        "min_ess": min_ess, "max_rhat": max_rhat, "converged": converged,
        "v_mean": v_mean, "v_var": v_var, "v_z_mean": z_mean,
        "v_z_var": z_var, "divergence_rate": float(div),
        "mean_leapfrogs_per_draw": float(steps.mean()),
        "tree_depth_histogram": torch.bincount(
            depths, minlength=MAX_DEPTH + 1).tolist(),
        "step_size": float(state.step_size),
        "launches": launches, "transitions": transitions,
        "rqs_launches": dict(rqs_cuda.LAUNCHES),
        "rqs_launches_fit": fit_launches,
        "rqs_launches_expected": expected, "use_pallas": use_pallas,
        "coupling_launches": dict(coupling_cuda.LAUNCHES),
        "coupling_launches_fit": fit_coupling,
        "coupling_launches_expected": expected_coupling,
    }
    return out, flow, warm_state


def check_main_path(res):
    if not res["converged"]:
        raise RuntimeError(f"{res['variant']}: convergence gate failed: max "
                           f"split-R-hat {res['max_rhat']}, min ESS "
                           f"{res['min_ess']}")
    if res["launches"] <= 0 or res["launches"] != res["transitions"]:
        raise RuntimeError(f"{res['variant']}: K1 launched "
                           f"{res['launches']} times for "
                           f"{res['transitions']} transitions")
    if res["rqs_launches"] != res["rqs_launches_expected"]:
        raise RuntimeError(f"{res['variant']}: K4/K5 launched "
                           f"{res['rqs_launches']}, the path implies "
                           f"{res['rqs_launches_expected']}")
    if res["coupling_launches"] != res["coupling_launches_expected"]:
        raise RuntimeError(f"{res['variant']}: K6/K7 launched "
                           f"{res['coupling_launches']}, the path implies "
                           f"{res['coupling_launches_expected']}")
    if res["v_z_mean"] > 5.0 or res["v_z_var"] > 5.0:
        raise RuntimeError(f"{res['variant']}: v's draws fail the moment "
                           f"check: {res}")


def mlp_flops(model):
    """Flops of one latent gradient's MLPs: a forward and an
    input-gradient backward of every conditioner, 2 x 2 x (d h1 + h1 h2 +
    h2 n_out) each."""
    d = model.d
    total = 0
    for row in model.mods.tolist():
        kind, _, h1, h2, K = row[:5]
        if kind == 0:
            continue
        n_out = 2 * d if kind == 1 else (3 * K - 1) * d
        total += 4 * (d * h1 + h1 * h2 + h2 * n_out)
    return total


def state_inputs(state, seed=8, cpu_randomness=False, depth=MAX_DEPTH):
    """(q, eps, inv_mass, p0, dirs, u_acc, u_take) for timing K1 at a
    post-warmup state; the randomness is drawn on the card, or on the CPU
    (so that `--save-generic-state` can carry it to the JAX package)."""
    import torch
    from tpuflows_torch.kernels import nuts_cuda

    dev = state.q.device
    q, eps, im = state.q.contiguous(), state.step_size, state.inv_mass
    n, d = q.shape
    if cpu_randomness:
        g = torch.Generator().manual_seed(seed)
        rnd = nuts_cuda.draw_randomness(g, n, d, depth, im.cpu())
        rnd = [t.to(dev) for t in rnd]
    else:
        g = torch.Generator(device=dev).manual_seed(seed)
        rnd = nuts_cuda.draw_randomness(g, n, d, depth, im)
    return (q, eps, im, *rnd)


def time_kernel(flow, state, n_reps=50, plain_reps=5, cpu_randomness=False):
    """K1 and its plain version at a main path's post-warmup state, timed
    with CUDA events on the same inputs, and the bound of the work; the two
    are held to K1's bar. For a flow with splines the spread of two plain
    versions on the same inputs (the streamed gradient and autograd through
    the whole flow) is measured too, and q is held to the larger of K1's
    bar and twice that spread: at the generic path's state float32
    reordering alone moves q by more than K1's bar, and the largest q
    difference of two such float32 evaluations over 1024 chains varies by
    up to twice from one pair to another (PERF.md, Findings)."""
    from tpuflows_torch.kernels import nuts_cuda
    from tpuflows_torch.targets import NealsFunnel

    model = nuts_cuda.pack_flow(flow, NealsFunnel(dim=DIM))
    q, eps, im, *rnd = state_inputs(state, cpu_randomness=cpu_randomness)
    logp_grad = nuts_cuda.plain_logp_grad(model)

    ms, kern = timed(lambda: nuts_cuda.nuts_transition(
        q, *rnd, eps, im, model, MAX_DEPTH), n_reps)
    plain_ms, plain = timed(lambda: nuts_cuda.transition_math_torch(
        q, *rnd, eps, im, logp_grad, MAX_DEPTH), plain_reps,
        warmup=min(3, plain_reps))
    # the work this run's data needs: one gradient at q plus one per
    # leapfrog, each the MLPs' forward and input-gradient backward
    d = model.d
    leaves = float(kern[3].sum()) + N_CHAINS
    flops = leaves * mlp_flops(model)
    flow_floats = (sum(p.numel() for p in flow.parameters())
                   + d * sum(1 for t in flow.transforms
                             if hasattr(t, "mask")))
    n_in = (2 * N_CHAINS * d + 2 * N_CHAINS * MAX_DEPTH
            + N_CHAINS * (1 << MAX_DEPTH) + 1 + d + flow_floats)
    n_out = N_CHAINS * d + 7 * N_CHAINS
    nbytes = 4.0 * (n_in + n_out)
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    out = {"ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "flops": flops, "bytes": nbytes, "leapfrogs": leaves,
           "achieved_tflops": flops / (ms * 1e-3) / 1e12}
    max_dq = MAX_DQ
    if model.flow_p is not None:
        other = nuts_cuda.transition_math_torch(
            q, *rnd, eps, im, nuts_cuda.autograd_logp_grad(
                flow, model.target.log_density), MAX_DEPTH)
        out["plain_vs_plain_at_state"] = compare(plain, other)
        max_dq = max(MAX_DQ,
                     2.0 * out["plain_vs_plain_at_state"]["max_dq"])
    out["dq_bar"] = max_dq
    out["vs_plain_at_state"] = compare(plain, kern, max_dq)
    return out


def flow_specs(flow):
    """A flow's modules as `convert.flow_from_jax_modules` dicts (numpy
    leaves and static fields), for the JAX package on the CPU."""
    from tpuflows_torch.flows import AffineCoupling, Standardize

    def arr(t):
        return t.detach().cpu().numpy()

    specs = []
    for t in flow.transforms:
        if isinstance(t, Standardize):
            specs.append({"kind": "standardize", "loc": arr(t.loc),
                          "log_scale": arr(t.log_scale)})
            continue
        spec = {"mask": t.mask, "weights": [arr(w) for w in t.net.weights],
                "biases": [arr(b) for b in t.net.biases],
                "activation": t.net.activation}
        if isinstance(t, AffineCoupling):
            spec.update(kind="affine", clamp=t.clamp)
        else:
            spec.update(kind="rqs", knots=t.knots,
                        range_limit=t.range_limit)
        specs.append(spec)
    return specs


def save_generic_state(path, flow, state, max_depth=MAX_DEPTH):
    """The generic path's trained flow (`flow_specs`) and post-warmup
    state, for the plain-versus-JAX spread on the CPU
    (`python tests/test_torch_nuts_spline.py PATH`)."""
    import torch

    torch.save({"modules": flow_specs(flow),
                "q": state.q.detach().cpu().numpy(),
                "step_size": float(state.step_size),
                "inv_mass": state.inv_mass.detach().cpu().numpy(),
                "seed": 8, "max_depth": max_depth}, path)


def main(argv=None):
    """`--save-generic-state PATH` also writes the generic path's trained
    flow and post-warmup state to PATH."""
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--save-generic-state", metavar="PATH")
    save_state = parser.parse_args(argv).save_generic_state
    t = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from tpuflows_torch.kernels import (coupling_cuda, cuda_build, nuts_cuda,
                                        rqs_cuda)

    smi = nvidia_smi_line()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("device", t, nvidia_smi=smi, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    device = "cuda"

    t = time.perf_counter()
    infos = cuda_build.build(nuts_cuda.LIBRARY, rqs_cuda.LIBRARY,
                             coupling_cuda.LIBRARY)
    emit("build", t,
         nvcc_seconds=max(i.seconds for i in infos.values()),
         libraries=[i.path for i in infos.values()],
         ptxas={k: v for i in infos.values()
                for k, v in ptxas_summary(i.log).items()})

    t = time.perf_counter()
    rqs_rows = rqs_vs_plain(device)
    emit("rqs_vs_plain", t, rows=rqs_rows,
         bar={"atol": RQS_ATOL, "rtol": RQS_RTOL})
    bad = [r for r in rqs_rows if not r["passed"]]
    if bad:
        raise RuntimeError(f"K4/K5 disagree with their plain versions: "
                           f"{bad}")

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
    spline_rows = kernel_vs_plain_spline(device)
    emit("kernel_vs_plain_spline", t, rows=spline_rows,
         bar={"flips": MAX_FLIPS, "denergy": MAX_DENERGY, "dq": MAX_DQ})
    bad = [r for r in spline_rows if r["gated"] and not r["passed"]]
    if bad:
        raise RuntimeError(f"K1 (module list) disagrees with its plain "
                           f"version: {bad}")

    t = time.perf_counter()
    res, flow, warm_state = main_path(device)
    emit("main_path", t, **res)
    check_main_path(res)

    t = time.perf_counter()
    tim = time_kernel(flow, warm_state)
    emit("timing", t, **tim)
    if not tim["vs_plain_at_state"]["passed"]:
        raise RuntimeError("K1 disagrees with its plain version at the main "
                           f"path's state: {tim['vs_plain_at_state']}")

    t = time.perf_counter()
    gres, gflow, gstate = main_path(device, variant="generic")
    emit("main_path_generic", t, **gres)
    check_main_path(gres)

    t = time.perf_counter()
    rqs_tim = time_rqs(device)
    gtim = time_kernel(gflow, gstate, n_reps=10, plain_reps=2,
                       cpu_randomness=True)
    if save_state:
        save_generic_state(save_state, gflow, gstate)
    emit("timing_generic", t, rqs=rqs_tim, k1=gtim)
    if not gtim["vs_plain_at_state"]["passed"]:
        raise RuntimeError("K1 (module list) disagrees with its plain "
                           "version at the generic path's state: "
                           f"{gtim['vs_plain_at_state']}")

    t = time.perf_counter()
    block_rows = coupling_vs_plain(device)
    emit("coupling_vs_plain", t, rows=block_rows,
         bar={"atol": RQS_ATOL, "rtol": RQS_RTOL,
              "quantile": "block_quantile"})
    bad = [r for r in block_rows if not r["passed"]]
    if bad:
        raise RuntimeError(f"K6/K7 disagree with their plain versions: "
                           f"{bad}")

    t = time.perf_counter()
    fres, _, _ = main_path(device, variant="generic", use_pallas="fused")
    emit("main_path_generic_fused", t, **fres)
    check_main_path(fres)

    t = time.perf_counter()
    block_tim = time_coupling(device)
    emit("timing_coupling", t, rows=block_tim,
         fit_step_launches={k: v // TRAIN_STEPS for k, v in
                            fres["coupling_launches_fit"].items()})

    k1 = "src/tpuflows/kernels/nuts_pallas.py:407"
    kernels = [{
        "name": "nuts_transition (affine)", "route": "cuda",
        "source": "src/tpuflows_torch/csrc/nuts_transition.cu",
        "replaces": k1, "launches": res["launches"],
        "max_abs_err": cmp["max_dq"], "ms": tim["ms"],
        "plain_ms": tim["plain_ms"], "bound_ms": tim["bound_ms"],
        "bound_by": tim["bound_by"], "library_ms": None,
    }, {
        "name": "nuts_transition (module list, spline)", "route": "cuda",
        "source": "src/tpuflows_torch/csrc/nuts_transition.cu",
        "replaces": k1, "launches": gres["launches"],
        "max_abs_err": spline_rows[0]["max_dq"], "ms": gtim["ms"],
        "plain_ms": gtim["plain_ms"], "bound_ms": gtim["bound_ms"],
        "bound_by": gtim["bound_by"], "library_ms": None,
    }]
    fit_rows = [r for r in rqs_rows if r["n"] == RQS_SHAPES[0][0]]
    for key, name, replaces in (
            ("k4_forward", "rqs_eval forward (K4)", ":204"),
            ("k4_inverse", "rqs_eval inverse (K4)", ":204"),
            ("k5_forward", "rqs_grad forward (K5)", ":240"),
            ("k5_inverse", "rqs_grad inverse (K5)", ":240")):
        r = rqs_tim[key]
        row = next(x for x in fit_rows if x["direction"] in key)
        errs = ("y", "ladj") if key.startswith("k4") else ("dx", "draw")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/tpuflows_torch/csrc/rqs_spline.cu",
            "replaces": "src/tpuflows/kernels/rqs_pallas.py" + replaces,
            "launches": gres["rqs_launches"][key],
            "max_abs_err": max(row[e]["max_abs"] for e in errs),
            "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    fit_block = block_tim[0]
    for key, name, replaces in (
            ("k6_forward", "coupling_block forward (K6)", ":185"),
            ("k6_inverse", "coupling_block inverse (K6)", ":185"),
            ("k7_forward", "coupling_block pullback, forward (K7)", ":215"),
            ("k7_inverse", "coupling_block pullback, inverse (K7)", ":215")):
        r = fit_block[key]
        row = next(x for x in block_rows if x["n"] == fit_block["n"]
                   and x["d"] == fit_block["d"]
                   and x["mask"] == fit_block["mask"]
                   and x["head"] == "n0.1" and x["direction"] in key)
        errs = (("z", "ladj") if key.startswith("k6")
                else ("dx", *COUPLING_PARAMS))
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/tpuflows_torch/csrc/coupling_block.cu",
            "replaces": "src/tpuflows/kernels/coupling_pallas.py" + replaces,
            "launches": fres["coupling_launches"][key],
            "max_abs_err": max(row[e]["max_abs"] for e in errs),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
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
