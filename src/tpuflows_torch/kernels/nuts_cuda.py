"""K1 on Hopper: the fused NUTS transition (port of
`tpuflows/kernels/nuts_pallas.py`, `make_fused_nuts_transition` and
`fused_nuts_for_flow` for affine flows).

Three pieces:
  * `transition_math_torch` — the plain PyTorch version: a step-by-step port
    of `_transition_math` (one batched transition with masked lockstep over
    the whole batch), whose gradient comes from `torch.autograd.grad` on the
    port's own flow modules. It runs on any device;
  * `nuts_transition` — the wrapper. A CPU tensor goes to the plain
    version; a CUDA tensor goes to the hand-written kernel
    `csrc/nuts_transition.cu` (one warp per chain), or the wrapper raises.
    There is no fallback from one to the other. `LAUNCHES` counts the
    kernel's launches;
  * `FusedNUTS` / `fused_nuts_for_flow` — the batched transition that
    `NUTSDriver(transition=...)` calls: it draws the randomness (momenta,
    direction signs, acceptance uniforms, one uniform per potential leaf)
    with a `torch.Generator` on the chains' device and calls the wrapper.

The kernel is built with nvcc into `build/kernels/` at the repository root
on first use (a plain C interface loaded with ctypes; rebuilt only when the
source's hash changes). Nothing is compiled or loaded at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple

import torch

from tpuflows_torch.flows.affine import AffineCoupling, Standardize
from tpuflows_torch.flows.core import Chain
from tpuflows_torch.mcmc.nuts import NUTSInfo, _popcount32, _trailing_zeros32
from tpuflows_torch.targets.funnel import NealsFunnel

# kernel launches since the last reset (the main path's proof of use)
LAUNCHES = 0

MAX_DIM = 256
MAX_DEPTH = 10
# energy error above which a leaf counts as divergent (the JAX kernel's
# default)
MAX_DELTA_ENERGY = 1000.0
_SRC = Path(__file__).resolve().parents[1] / "csrc" / "nuts_transition.cu"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
# one translation unit per instantiation (d / 32 dims per lane) plus the
# C entry point, compiled in parallel
_UNITS = [("entry", [])] + [(f"dpl{k}", [f"-DNUTS_DPL={k}"])
                             for k in range(1, MAX_DIM // 32 + 1)]
_LIB = None


class BuildInfo(NamedTuple):
    path: str
    seconds: float  # 0.0 when an existing build was reused
    log: str  # nvcc / ptxas output (-Xptxas -v), empty when reused


_BUILD_INFO: BuildInfo | None = None


def _compile(nvcc: str, tmp: Path, out: Path) -> str:
    """All units at once (one nvcc each), then one link; returns the
    compilers' output."""
    objs, procs = [], []
    try:
        for name, defs in _UNITS:
            obj, log = tmp / f"{name}.o", tmp / f"{name}.log"
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, *defs, "-c", "-o", str(obj),
                     str(_SRC)], stdout=f, stderr=subprocess.STDOUT))
            objs.append(obj)
        rcs = [p.wait() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    log = "".join((tmp / f"{name}.log").read_text() for name, _ in _UNITS)
    if any(rcs):
        sys.stderr.write(log)
        raise RuntimeError(f"nvcc failed (exit codes {rcs}) on {_SRC}")
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(out),
                           *map(str, objs)], capture_output=True, text=True)
    log += link.stdout + link.stderr
    if link.returncode != 0:
        sys.stderr.write(log)
        raise RuntimeError(f"nvcc link failed ({link.returncode})")
    return log


def build() -> BuildInfo:
    """Compile `csrc/nuts_transition.cu` for sm_90a with nvcc (once per
    source hash) and load it with ctypes. nvcc's output goes to stderr."""
    global _LIB, _BUILD_INFO
    if _LIB is not None:
        return _BUILD_INFO
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"libnuts_transition_{tag}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found: the CUDA kernel of "
                               "tpuflows_torch is built on the GPU machine")
        tmp = _BUILD_DIR / f"tmp_{tag}_{os.getpid()}"
        tmp.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        log = _compile(nvcc, tmp, tmp / out.name)
        seconds = time.perf_counter() - t0
        sys.stderr.write(log)
        os.replace(tmp / out.name, out)
        shutil.rmtree(tmp, ignore_errors=True)
    lib = ctypes.CDLL(str(out))
    fn = lib.nuts_transition_f32
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    _LIB = lib
    _BUILD_INFO = BuildInfo(str(out), seconds, log)
    return _BUILD_INFO


class AffineFunnel(NamedTuple):
    """An affine flow over Neal's funnel, checked and packed for K1."""

    flow: Chain
    target: NealsFunnel
    params: torch.Tensor  # packed, see csrc/nuts_transition.cu `Net`
    d: int
    h1: int
    h2: int
    clamp: float


def pack_affine_funnel(flow: Chain, target: NealsFunnel) -> AffineFunnel:
    """Check that `flow` is what K1 computes (Standardize + one
    AffineCoupling with a 3-layer silu MLP, over a funnel of the flow's
    width) and pack its leaves in the kernel's order, with transposed
    weight copies for the backward pass."""
    ts = list(flow.transforms) if isinstance(flow, Chain) else []
    if (len(ts) != 2 or not isinstance(ts[0], Standardize)
            or not isinstance(ts[1], AffineCoupling)):
        raise ValueError("the fused NUTS kernel takes Chain([Standardize, "
                         "AffineCoupling]); spline flows wait for the "
                         "spline slice (ROADMAP.md)")
    std, cp = ts
    d = std.loc.numel()
    ws, bs = list(cp.net.weights), list(cp.net.biases)
    if len(ws) != 3 or cp.net.activation != "silu":
        raise ValueError("the fused NUTS kernel takes a 3-layer silu MLP")
    h1, h2 = ws[0].shape[1], ws[1].shape[1]
    if (ws[0].shape != (d, h1) or ws[1].shape != (h1, h2)
            or ws[2].shape != (h2, 2 * d)):
        raise ValueError(f"MLP widths {[tuple(w.shape) for w in ws]} do not "
                         f"match the flow width d={d}")
    if not isinstance(target, NealsFunnel) or target.dim != d:
        raise ValueError("the fused NUTS kernel takes a NealsFunnel of the "
                         "flow's width")
    parts = [std.loc, std.log_scale, cp.mask_f, ws[0], bs[0], ws[1], bs[1],
             ws[2], bs[2], ws[0].t(), ws[1].t(), ws[2].t()]
    with torch.no_grad():
        params = torch.cat([p.detach().float().reshape(-1) for p in parts])
    return AffineFunnel(flow, target, params.contiguous(), d, h1, h2,
                        cp.clamp)


def autograd_logp_grad(flow: Chain, log_density: Callable) -> Callable:
    """z (T, d) -> (lp (T, 1), d lp / dz (T, d)) for
    lp = log_density(f^-1(z)) + ladj, by torch.autograd."""

    def logp_grad(z):
        with torch.enable_grad():
            z = z.detach().requires_grad_(True)
            x, ladj = flow.inverse_and_ladj(z)
            lp = log_density(x) + ladj
            (g,) = torch.autograd.grad(lp.sum(), z)
        return lp.detach()[:, None], g

    return logp_grad


def transition_math_torch(q, p0, dirs, u_acc, u_take, eps, inv_mass,
                          logp_grad, max_depth):
    """One batched NUTS transition on (n, d) chains: `_transition_math` of
    the JAX package, step by step, with exact selects in place of its
    arithmetic blends.

    q/p0: (n, d); dirs/u_acc: (n, max_depth); u_take: (n, 2^max_depth);
    eps: 0-d; inv_mass: (d,); logp_grad: (n, d) -> ((n, 1), (n, d)).
    Returns (q_new, lp_new, sum_accept, n_steps, depth, diverging,
    turning, h0): q_new (n, d), the rest (n,) float32."""
    D = max_depth
    inf = float("inf")

    def kin(p):
        return 0.5 * torch.sum(p * p * inv_mass, -1, keepdim=True)

    def is_turning(p_left, p_right, rho):
        v = rho * inv_mass
        return ((torch.sum(v * p_left, -1, keepdim=True) <= 0.0)
                | (torch.sum(v * p_right, -1, keepdim=True) <= 0.0))

    def where(m, a, b):
        return torch.where(m, a, b)

    def finite_or_zero(x):
        return where(torch.isfinite(x), x, torch.zeros_like(x))

    lp0, g0 = logp_grad(q)
    h0 = -lp0 + kin(p0)
    zeros1 = torch.zeros_like(lp0)
    false1 = torch.zeros_like(lp0, dtype=torch.bool)
    zl = (q, p0, lp0, g0)
    zr = (q, p0, lp0, g0)
    q_prop, lp_prop = q, lp0
    logw, rho = zeros1, p0
    turning, diverging = false1, false1
    sum_accept, n_steps, depth = zeros1, zeros1, zeros1
    col = 0
    for k in range(D):
        active = ~(turning | diverging)
        if not bool(active.any()):
            break
        direction = dirs[:, k:k + 1]
        fwd = direction > 0.0
        s_q, s_p, s_lp, s_g = (where(fwd, r, l) for r, l in zip(zr, zl))
        eps_s = direction * eps
        n_leaves = 1 << k

        # subtree: up to n_leaves leapfrogs, masked lockstep over the batch
        st_qp, st_lpp = s_q, s_lp
        st_logw = torch.full_like(lp0, -inf)
        st_rho = torch.zeros_like(s_p)
        st_turn, st_div = false1, false1
        st_acc, st_n = zeros1, zeros1
        ck_p = [torch.zeros_like(s_p) for _ in range(D)]
        ck_r = [torch.zeros_like(s_p) for _ in range(D)]
        for leaf in range(n_leaves):
            msk = active & ~(st_turn | st_div)
            if not bool(msk.any()):
                break
            p_half = s_p + 0.5 * eps_s * s_g
            q_new = s_q + eps_s * p_half * inv_mass
            lp_new, g_new = logp_grad(q_new)
            p_new = p_half + 0.5 * eps_s * g_new
            dh = -lp_new + kin(p_new) - h0
            dh = where(torch.isfinite(dh), dh, torch.full_like(dh, inf))
            div_leaf = dh > MAX_DELTA_ENERGY
            logw_leaf = where(div_leaf, torch.full_like(dh, -inf), -dh)
            accept = torch.clamp(torch.exp(torch.clamp(-dh, max=0.0)),
                                 max=1.0)
            accept = finite_or_zero(accept)
            logw_new = torch.logaddexp(st_logw, logw_leaf)
            u = u_take[:, col + leaf:col + leaf + 1]
            # divergent leaves may carry inf; they never become proposals
            q_new = finite_or_zero(q_new)
            p_new = finite_or_zero(p_new)
            g_new = finite_or_zero(g_new)
            take = msk & (torch.log(u) < logw_leaf - logw_new) & ~div_leaf
            st_qp = where(take, q_new, st_qp)
            st_lpp = where(take, lp_new, st_lpp)

            # checkpoint store: slot = popcount(leaf), even leaves only
            if leaf % 2 == 0:
                slot = _popcount32(leaf)
                ck_p[slot] = where(msk, p_new, ck_p[slot])
                ck_r[slot] = where(msk, st_rho, ck_r[slot])
            rho_new = st_rho + p_new

            # U-turn over the complete subtrees that end at this leaf
            nl = leaf + 1
            any_turn = false1
            if nl % 2 == 0:
                pc = _popcount32(nl)
                for i in range(pc - 1, pc - 1 + _trailing_zeros32(nl)):
                    any_turn = any_turn | is_turning(ck_p[i], p_new,
                                                     rho_new - ck_r[i])
            st_turn = st_turn | (msk & any_turn)
            st_div = st_div | (msk & div_leaf)
            st_logw = where(msk, logw_new, st_logw)
            st_rho = where(msk, rho_new, st_rho)
            st_acc = st_acc + where(msk, accept, zeros1)
            st_n = st_n + msk.to(st_n.dtype)
            s_q = where(msk, q_new, s_q)
            s_p = where(msk, p_new, s_p)
            s_lp = where(msk, lp_new, s_lp)
            s_g = where(msk, g_new, s_g)
        col += n_leaves

        ok = active & ~(st_turn | st_div)
        acc_p = torch.clamp(torch.exp(st_logw - logw), max=1.0)
        take = ok & (u_acc[:, k:k + 1] < acc_p)
        q_prop = where(take, st_qp, q_prop)
        lp_prop = where(take, st_lpp, lp_prop)
        e = (s_q, s_p, s_lp, s_g)
        zr = tuple(where(ok & fwd, a, b) for a, b in zip(e, zr))
        zl = tuple(where(ok & ~fwd, a, b) for a, b in zip(e, zl))
        logw = where(ok, torch.logaddexp(logw, st_logw), logw)
        rho = where(ok, rho + st_rho, rho)
        turn_comb = is_turning(zl[1], zr[1], rho)
        turning = where(active, st_turn | (ok & turn_comb), turning)
        diverging = where(active, st_div, diverging)
        sum_accept = sum_accept + where(active, st_acc, zeros1)
        n_steps = n_steps + where(active, st_n, zeros1)
        depth = where(ok, torch.full_like(depth, k + 1.0), depth)

    f32 = torch.float32
    return (q_prop, lp_prop[:, 0], sum_accept[:, 0], n_steps[:, 0],
            depth[:, 0], diverging[:, 0].to(f32), turning[:, 0].to(f32),
            h0[:, 0])


def _check_inputs(q, p0, dirs, u_acc, u_take, eps, inv_mass, model,
                  max_depth):
    if not 1 <= max_depth <= MAX_DEPTH:
        raise ValueError(f"max_depth must be in [1, {MAX_DEPTH}], got "
                         f"{max_depth}")
    if q.ndim != 2:
        raise ValueError(f"q must be (n, d), got {tuple(q.shape)}")
    n, d = q.shape
    if d != model.d:
        raise ValueError(f"q has width {d}, the flow's MLP takes {model.d}")
    want = {"q": (n, d), "p0": (n, d), "dirs": (n, max_depth),
            "u_acc": (n, max_depth), "u_take": (n, 1 << max_depth),
            "eps": (), "inv_mass": (d,)}
    got = {"q": q, "p0": p0, "dirs": dirs, "u_acc": u_acc,
           "u_take": u_take, "eps": eps, "inv_mass": inv_mass}
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _launch(q, p0, dirs, u_acc, u_take, eps, inv_mass, model, max_depth):
    global LAUNCHES
    n, d = q.shape
    if d > MAX_DIM or d % 32:
        raise ValueError(f"the kernel takes d % 32 == 0 and d <= {MAX_DIM},"
                         f" got d={d}")
    for w in (model.h1, model.h2):
        if w > MAX_DIM or w % 32:
            raise ValueError(f"the kernel takes hidden widths % 32 == 0 and "
                             f"<= {MAX_DIM}, got {w}")
    ins = (q, p0, dirs, u_acc, u_take, eps, inv_mass, model.params)
    for t in ins:
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
    if model.params.device != q.device:
        raise ValueError("the packed flow is on another device than q")
    build()
    q_out = torch.empty_like(q)
    info = torch.empty((7, n), device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _LIB.nuts_transition_f32(
            *(t.data_ptr() for t in ins), n, d, model.h1, model.h2,
            max_depth, model.clamp, model.target.sigma_v, MAX_DELTA_ENERGY,
            q_out.data_ptr(), info.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"nuts_transition_f32 launch failed: cudaError "
                           f"{rc}")
    LAUNCHES += 1
    return (q_out, *info.unbind(0))


def nuts_transition(q, p0, dirs, u_acc, u_take, eps, inv_mass,
                    model: AffineFunnel, max_depth: int):
    """One NUTS transition of every chain, with the randomness given.

    A CPU tensor runs `transition_math_torch` with the autograd gradient of
    `model.flow`; a CUDA tensor launches K1. Same returns as
    `transition_math_torch`."""
    _check_inputs(q, p0, dirs, u_acc, u_take, eps, inv_mass, model,
                  max_depth)
    if q.device.type == "cpu":
        logp_grad = autograd_logp_grad(model.flow, model.target.log_density)
        return transition_math_torch(q, p0, dirs, u_acc, u_take, eps,
                                     inv_mass, logp_grad, max_depth)
    if q.device.type == "cuda":
        return _launch(q, p0, dirs, u_acc, u_take, eps, inv_mass, model,
                       max_depth)
    raise ValueError(f"no NUTS transition for device {q.device}")


def draw_randomness(generator: torch.Generator, n: int, d: int,
                    max_depth: int, inv_mass: torch.Tensor):
    """(p0, dirs, u_acc, u_take) for n chains: momenta ~ N(0, M), direction
    signs +-1, one acceptance uniform per doubling, one uniform per
    potential leaf — drawn on `inv_mass`'s device, which must be the
    generator's."""
    dev = inv_mass.device
    p0 = torch.randn((n, d), generator=generator, device=dev)
    p0 = p0 / torch.sqrt(inv_mass)
    dirs = torch.where(
        torch.rand((n, max_depth), generator=generator, device=dev) < 0.5,
        1.0, -1.0)
    u_acc = torch.rand((n, max_depth), generator=generator, device=dev)
    u_take = torch.rand((n, 1 << max_depth), generator=generator,
                        device=dev)
    return p0, dirs, u_acc, u_take


class FusedNUTS:
    """Batched flow-preconditioned NUTS transition for
    `NUTSDriver(transition=...)`: `(generator, q, eps, inv_mass) ->
    (q_new, NUTSInfo)` on the latent density log p(f^-1(z)) + ladj.

    The flow's parameters are packed for K1 when this is constructed, so
    build it after the flow is trained."""

    def __init__(self, target: NealsFunnel, flow: Chain, max_depth: int = 8):
        self.model = pack_affine_funnel(flow, target)
        self.max_depth = max_depth

    def __call__(self, generator, q, eps, inv_mass):
        n, d = q.shape
        eps = torch.as_tensor(eps, dtype=torch.float32, device=q.device)
        p0, dirs, u_acc, u_take = draw_randomness(
            generator, n, d, self.max_depth, inv_mass)
        q_prop, lp, sum_acc, n_steps, depth, div, turn, h0 = nuts_transition(
            q, p0, dirs, u_acc, u_take, eps, inv_mass, self.model,
            self.max_depth)
        info = NUTSInfo(
            accept_prob=sum_acc / torch.clamp(n_steps, min=1.0),
            num_steps=n_steps.to(torch.int32),
            tree_depth=depth.to(torch.int32),
            diverging=div > 0.5,
            turning=turn > 0.5,
            energy=h0,
            logp=lp,
        )
        return q_prop, info


def fused_nuts_for_flow(target: NealsFunnel, flow: Chain,
                        max_depth: int = 8) -> FusedNUTS:
    """The fused transition for flow-preconditioned NUTS on `target`
    (the north-star path); drop into `NUTSDriver(transition=...)`."""
    return FusedNUTS(target, flow, max_depth=max_depth)
