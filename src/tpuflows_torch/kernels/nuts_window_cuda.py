"""K2 on Hopper: the streaming NUTS draw window (port of
`tpuflows/kernels/nuts_pallas.py`, `make_fused_nuts_window`,
`_window_math` and `fused_nuts_window_for_flow`).

A window is S sequential multinomial-NUTS transitions of every chain in
one call, from precomputed randomness laid out slot-major inside each
chain's row (`mcmc.nuts.draw_window_randomness`); slot s starts where slot
s - 1's proposal ended, and the next window continues from the last draw.
Four pieces:
  * `window_math_torch` — the plain PyTorch version: a step-by-step port
    of `_window_math`, the per-chain state machine over ticks (each tick
    one leapfrog of every chain that still has slots to run) with its
    masked blends `b + m (a - b)` as written, so it rounds as the JAX
    package's window does. It differs from S chained K1 transitions
    (`transition_math_torch`) at rounding level only: it sums the accept
    statistic per leaf, writes through blends, and carries the proposal's
    lp and g between transitions instead of recomputing them;
  * `nuts_window` — the wrapper. A CPU tensor goes to the plain version
    with `nuts_cuda.plain_logp_grad`; a CUDA tensor goes to the
    hand-written kernel `csrc/nuts_window.cu` (K1's tree code once per
    slot, the flow as a module list on tiles of
    `nuts_cuda.tile_rows(model)` chains in K1's tile lockstep, every
    gradient through the tile gradient `csrc/tile_grad.cuh`, the weights
    resident in shared memory for the whole window where they fit:
    `nuts_cuda.launch_resident`), or the wrapper raises. There is no
    fallback from one to the other. `LAUNCHES` counts the kernel's
    launches. `chain_window_warp` runs the per-warp module-list window
    (`nuts_window_chain_kernel`), on no path: `chip_smoke.py`'s oracle
    and yardstick for the tile kernel;
  * `chain_slots` — S chained per-transition calls on the slot columns
    (the equivalence the kernel's design rests on), or S calls each from
    a given window's previous draw, to hold every slot of a window on its
    own against one transition from the same state;
  * `FusedNUTSWindow` / `fused_nuts_window_for_flow` — the window that
    `NUTSDriver(window_transition=...)` calls for the draw phase: it draws
    the window's randomness with a `torch.Generator` on the chains' device
    and calls the wrapper. It takes the flows K1 takes (`pack_flow`) and
    exposes the window size as `.window`.
`window_lockstep_gradients` counts the gradients the tile lockstep
computes for a window.

The library is built with nvcc into `build/kernels/` at the repository
root on first use (`cuda_build`); nothing is compiled or loaded at import
time.
"""
from __future__ import annotations

import ctypes
from typing import Callable

import torch

from tpuflows_torch.flows.core import Chain
from tpuflows_torch.kernels.cuda_build import CudaLibrary
from tpuflows_torch.kernels.nuts_cuda import (_UNITS, MAX_DELTA_ENERGY,
                                              PackedFlow, check_inputs,
                                              check_launch,
                                              launch_resident, launch_rows,
                                              lockstep_gradients,
                                              module_list_args, pack_flow,
                                              plain_logp_grad)
from tpuflows_torch.mcmc.nuts import (NUTSInfo, _popcount32,
                                      _trailing_zeros32,
                                      draw_window_randomness)

# kernel launches since the last reset (the main path's proof of use)
LAUNCHES = 0


def _bind(lib):
    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.nuts_chain_window_f32
    fn.argtypes = [p] * 10 + [i32] * 9 + [f32] + [p] * 2 + [i32, i32, p]
    fn.restype = i32
    fn = lib.nuts_chain_window_warp_f32
    fn.argtypes = [p] * 10 + [i32] * 9 + [f32] + [p] * 3
    fn.restype = i32


# one translation unit per instantiation (d / 32 dims per lane) plus the C
# entry points, as K1's
LIBRARY = CudaLibrary("nuts_window", "nuts_window.cu", _UNITS,
                      ["latent_grad.cuh", "targets.cuh", "tile_grad.cuh",
                       "nuts_tree.cuh", "nuts_tree_body.inc",
                       "rqs_math.cuh"], _bind)


def window_math_torch(q, p0c, dirs, u_acc, u_take, eps, inv_mass,
                      logp_grad: Callable, window: int, max_depth: int):
    """K2's plain version: `_window_math` step by step.

    q (n, d); p0c (n, S d) scaled momenta; dirs and u_acc (n, S D); u_take
    (n, S 2^D), slot-major inside each row (S = window, D = max_depth);
    eps 0-d; inv_mass (d,); logp_grad: (n, d) -> ((n, 1), (n, d)), called
    once at q and once per tick. A leaf diverges at an energy error above
    MAX_DELTA_ENERGY; its non-finite q, p and g are zeroed, as in K1.
    Returns (draws (S, n, d), lp, accept, n_steps,
    depth, diverging, turning, h0), each of the last seven (S, n), accept
    the mean accept statistic of the transition."""
    T, d = q.shape
    S, D, L = window, max_depth, 1 << max_depth
    dev, dt = q.device, q.dtype
    inf = float("inf")
    rows = torch.arange(T, device=dev)
    lane_s = torch.arange(S, device=dev)[None, :]
    p0_slots = p0c.reshape(T, S, d)

    def kin(p):
        return 0.5 * torch.sum(p * p * inv_mass, -1, keepdim=True)

    def is_turning(p_left, p_right, rho):
        v = rho * inv_mass
        return ((torch.sum(v * p_left, -1, keepdim=True) <= 0.0)
                | (torch.sum(v * p_right, -1, keepdim=True) <= 0.0))

    def blend(m, a, b):
        return b + m * (a - b)

    def f(pred):
        return pred.to(dt)

    def where(m, a, b):
        return torch.where(m, a, b)

    def take_col(mat, col):
        """mat[row, col] per row, 0 where col is past the last column."""
        w = mat.shape[1]
        v = torch.gather(mat, 1, col.clamp(max=w - 1))
        return where(col < w, v, torch.zeros_like(v))

    def finite_or_zero(x):
        return where(torch.isfinite(x), x, torch.zeros_like(x))

    def logp_grad2(z):
        lp, g = logp_grad(z)
        return lp.reshape(T, 1), g

    lp0, g0 = logp_grad2(q)
    zeros1 = torch.zeros_like(lp0)
    ones1 = torch.ones_like(lp0)
    zero_d = torch.zeros_like(q)
    izero = torch.zeros((T, 1), dtype=torch.long, device=dev)

    s, k, leaf_idx, leaf_col = izero, izero, izero, izero
    new_tr, new_sub = ones1, zeros1
    q_cur, lp_cur, g_cur = q, lp0, g0
    h0 = zeros1
    zl_q, zl_p, zl_lp, zl_g = q, zero_d, lp0, g0
    zr_q, zr_p, zr_lp, zr_g = q, zero_d, lp0, g0
    q_prop, lp_prop, g_prop = q, lp0, g0
    logw, rho = zeros1, zero_d
    turning, diverging = zeros1, zeros1
    sum_acc, n_steps, depth = zeros1, zeros1, zeros1
    s_q, s_p, s_lp, s_g = q, zero_d, lp0, g0
    st_qp, st_lpp, st_gp = q, lp0, g0
    st_logw = torch.full_like(lp0, -inf)
    st_rho, st_turn, st_div = zero_d, zeros1, zeros1
    direction = ones1
    ck_p = [zero_d] * D
    ck_r = [zero_d] * D
    out_q = torch.zeros((S, T, d), dtype=dt, device=dev)
    out_info = torch.zeros((7, T, S), dtype=dt, device=dev)

    while bool((s < S).any()):
        active = f(s < S)

        # -- A. transition init (chains flagged new_tr) -------------------
        init_f = active * new_tr
        init = init_f > 0.5
        p0 = where(init, p0_slots[rows, s.clamp(max=S - 1)[:, 0]], zero_d)
        h0 = where(init, -lp_cur + kin(p0), h0)
        zl_q = blend(init_f, q_cur, zl_q)
        zl_p = blend(init_f, p0, zl_p)
        zl_lp = where(init, lp_cur, zl_lp)
        zl_g = blend(init_f, g_cur, zl_g)
        zr_q = blend(init_f, q_cur, zr_q)
        zr_p = blend(init_f, p0, zr_p)
        zr_lp = where(init, lp_cur, zr_lp)
        zr_g = blend(init_f, g_cur, zr_g)
        q_prop = blend(init_f, q_cur, q_prop)
        lp_prop = where(init, lp_cur, lp_prop)
        g_prop = blend(init_f, g_cur, g_prop)
        logw = where(init, zeros1, logw)
        rho = blend(init_f, p0, rho)
        turning = where(init, zeros1, turning)
        diverging = where(init, zeros1, diverging)
        sum_acc = where(init, zeros1, sum_acc)
        n_steps = where(init, zeros1, n_steps)
        depth = where(init, zeros1, depth)
        k = where(init, izero, k)
        leaf_col = where(init, izero, leaf_col)
        sub_f = torch.maximum(new_sub, init_f) * active
        sub = sub_f > 0.5

        # -- B. subtree init (the proposal and the checkpoints are not
        # reset: a stale proposal is gated by st_logw = -inf, and a
        # checkpoint is read only after this subtree wrote it) -----------
        direction = where(sub, take_col(dirs, s * D + k), direction)
        fwd = 0.5 * (direction + 1.0)
        s_q = blend(sub_f, blend(fwd, zr_q, zl_q), s_q)
        s_p = blend(sub_f, blend(fwd, zr_p, zl_p), s_p)
        s_lp = where(sub, where(fwd > 0.5, zr_lp, zl_lp), s_lp)
        s_g = blend(sub_f, blend(fwd, zr_g, zl_g), s_g)
        st_logw = where(sub, torch.full_like(st_logw, -inf), st_logw)
        st_rho = blend(sub_f, zero_d, st_rho)
        st_turn = where(sub, zeros1, st_turn)
        st_div = where(sub, zeros1, st_div)
        leaf_idx = where(sub, izero, leaf_idx)

        # -- C. one leapfrog for every active chain -----------------------
        msk = active
        run = msk > 0.5
        eps_s = direction * eps
        p_half = s_p + 0.5 * eps_s * s_g
        q_new = s_q + eps_s * p_half * inv_mass
        lp_new, g_new = logp_grad2(q_new)
        p_new = p_half + 0.5 * eps_s * g_new
        dh = (-lp_new + kin(p_new)) - h0
        dh = where(torch.isfinite(dh), dh, torch.full_like(dh, inf))
        div_leaf = dh > MAX_DELTA_ENERGY
        logw_leaf = where(div_leaf, torch.full_like(dh, -inf), -dh)
        accept = torch.clamp(torch.exp(torch.clamp(-dh, max=0.0)), max=1.0)
        accept = finite_or_zero(accept)
        logw_new = torch.logaddexp(st_logw, logw_leaf)
        u = take_col(u_take, s * L + leaf_col)
        q_new = finite_or_zero(q_new)
        p_new = finite_or_zero(p_new)
        g_new = finite_or_zero(g_new)
        take_f = msk * f((torch.log(u) < logw_leaf - logw_new) & ~div_leaf)
        st_qp = blend(take_f, q_new, st_qp)
        st_lpp = where(take_f > 0.5, lp_new, st_lpp)
        st_gp = blend(take_f, g_new, st_gp)

        # checkpoint store: slot popcount(leaf), even leaves only
        slot = _popcount32(leaf_idx)
        store = (leaf_idx % 2) == 0
        for i in range(D):
            w_f = msk * f(store & (slot == i))
            ck_p[i] = blend(w_f, p_new, ck_p[i])
            ck_r[i] = blend(w_f, st_rho, ck_r[i])
        rho_new = st_rho + p_new

        # U-turn over every complete subtree that ends at this leaf
        nl = leaf_idx + 1
        tz = _trailing_zeros32(nl)
        pc = _popcount32(nl)
        idx_min, idx_max = pc - 1, pc - 2 + tz
        even = (nl % 2) == 0
        any_turn = zeros1
        for i in range(D):
            valid = f(even & (i >= idx_min) & (i <= idx_max))
            any_turn = torch.maximum(any_turn, f(is_turning(
                ck_p[i], p_new, rho_new - ck_r[i])) * valid)
        st_turn = torch.maximum(st_turn, msk * any_turn)
        st_div = torch.maximum(st_div, msk * f(div_leaf))
        st_logw = where(run, logw_new, st_logw)
        st_rho = blend(msk, rho_new, st_rho)
        sum_acc = sum_acc + msk * accept
        n_steps = n_steps + msk
        s_q = blend(msk, q_new, s_q)
        s_p = blend(msk, p_new, s_p)
        s_lp = where(run, lp_new, s_lp)
        s_g = blend(msk, g_new, s_g)
        leaf_idx = where(run, leaf_idx + 1, leaf_idx)
        leaf_col = where(run, leaf_col + 1, leaf_col)

        # -- E. subtree end: trajectory commit ----------------------------
        n_leaves = torch.ones_like(k) << k
        sub_done = msk * f((leaf_idx >= n_leaves) | ((st_turn + st_div) > 0.5))
        ok = sub_done * f((st_turn + st_div) < 0.5)
        acc_p = torch.clamp(torch.exp(st_logw - logw), max=1.0)
        take_t = ok * f(take_col(u_acc, s * D + k) < acc_p)
        q_prop = blend(take_t, st_qp, q_prop)
        lp_prop = where(take_t > 0.5, st_lpp, lp_prop)
        g_prop = blend(take_t, st_gp, g_prop)
        mr, ml = ok * fwd, ok * (1.0 - fwd)
        zr_q = blend(mr, s_q, zr_q)
        zr_p = blend(mr, s_p, zr_p)
        zr_lp = where(mr > 0.5, s_lp, zr_lp)
        zr_g = blend(mr, s_g, zr_g)
        zl_q = blend(ml, s_q, zl_q)
        zl_p = blend(ml, s_p, zl_p)
        zl_lp = where(ml > 0.5, s_lp, zl_lp)
        zl_g = blend(ml, s_g, zl_g)
        logw = where(ok > 0.5, torch.logaddexp(logw, st_logw), logw)
        rho = blend(ok, rho + st_rho, rho)
        turn_comb = f(is_turning(zl_p, zr_p, rho))
        done = sub_done > 0.5
        turning = where(done, torch.maximum(st_turn, ok * turn_comb),
                        turning)
        diverging = where(done, torch.maximum(diverging, st_div), diverging)
        depth = where(ok > 0.5, (k + 1).to(dt), depth)
        k = where(done, k + 1, k)
        traj_done = sub_done * f((k >= D) | (turning > 0.5)
                                 | (diverging > 0.5))
        new_sub = sub_done * (1.0 - traj_done)

        # -- F. transition end: write the draw and its info, next slot ----
        m_slot = traj_done * f(lane_s == s)  # (T, S)
        out_q = blend(m_slot.t()[:, :, None], q_prop[None], out_q)
        vals = torch.stack([lp_prop, sum_acc / torch.clamp(n_steps, min=1.0),
                            n_steps, depth, diverging, turning, h0])
        out_info = blend(m_slot[None], vals, out_info)
        q_cur = blend(traj_done, q_prop, q_cur)
        lp_cur = where(traj_done > 0.5, lp_prop, lp_cur)
        g_cur = blend(traj_done, g_prop, g_cur)
        s = where(traj_done > 0.5, s + 1, s)
        new_tr = traj_done

    return (out_q, *out_info.transpose(1, 2))


def chain_slots(step: Callable, q, p0c, dirs, u_acc, u_take, window: int,
                max_depth: int, starts=None):
    """S = `window` per-transition calls, slot s on slot s's columns:
    `step(q, p0, dirs, u_acc, u_take)` returns (q_new, lp, sum_accept,
    n_steps, depth, diverging, turning, h0) as K1's wrapper and plain
    version do. Slot s starts from slot s - 1's result, or, when `starts`
    (S, n, d) is given (another window's draws), from starts[s - 1]; slot
    0 starts from q. Returns the window's outputs (draws (S, n, d) and
    seven (S, n), accept the mean)."""
    d, D, L = q.shape[1], max_depth, 1 << max_depth
    outs = []
    for s in range(window):
        if starts is not None and s > 0:
            q = starts[s - 1].contiguous()
        res = step(q, p0c[:, s * d:(s + 1) * d].contiguous(),
                   dirs[:, s * D:(s + 1) * D].contiguous(),
                   u_acc[:, s * D:(s + 1) * D].contiguous(),
                   u_take[:, s * L:(s + 1) * L].contiguous())
        q = res[0]
        outs.append(res)
    draws, lp, sacc, n_steps, depth, div, turn, h0 = (
        torch.stack(x) for x in zip(*outs))
    return (draws, lp, sacc / torch.clamp(n_steps, min=1.0), n_steps, depth,
            div, turn, h0)


def window_lockstep_gradients(n_steps: torch.Tensor, rows: int) -> int:
    """Latent gradients K2's tile lockstep of `rows` chains computes for
    one window with these leapfrog counts (n_steps (S, n), info's, chains
    in tile order), counted per tile, not per row: one at the window's
    start, then in each slot `nuts_cuda.lockstep_gradients` without its
    start call (a slot starts from the carried lp and g). With rows = 1
    it is sum(n_steps) + n. A ragged last tile counts as a whole one."""
    steps = n_steps.detach().to("cpu").reshape(n_steps.shape[0], -1)
    tiles = -(-steps.shape[1] // rows)
    return tiles + sum(lockstep_gradients(s, rows) - tiles for s in steps)


def _call(name, q, p0c, dirs, u_acc, u_take, eps, inv_mass, model,
          max_depth, window, out, extra=()):
    """One entry point of the library on CUDA tensors, with the module
    list's arguments; `extra` goes between info and the stream. Returns
    `nuts_window`'s outputs."""
    n, d = q.shape
    ins = (q, p0c, dirs, u_acc, u_take, eps, inv_mass, model.params)
    check_launch(q, (*ins, *(() if out is None else (out,))), model)
    lib = LIBRARY.load()
    draws = (torch.empty((window, n, d), device=q.device, dtype=q.dtype)
             if out is None else out)
    info = torch.empty((7, window, n), device=q.device, dtype=torch.float32)
    ptrs = [t.data_ptr() for t in ins]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, name)(
            *ptrs, *module_list_args(model, n), max_depth, window,
            MAX_DELTA_ENERGY, draws.data_ptr(), info.data_ptr(), *extra,
            stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    lp, sum_acc, n_steps, depth, div, turn, h0 = info.unbind(0)
    return (draws, lp, sum_acc / torch.clamp(n_steps, min=1.0), n_steps,
            depth, div, turn, h0)


def _launch(q, p0c, dirs, u_acc, u_take, eps, inv_mass, model, max_depth,
            window, out, rows=None, resident=None):
    """K2 on the card: the tile kernel on tiles of `rows` chains, its
    weights resident where they fit (the wrapper's `tile_rows(model)` and
    `nuts_cuda.launch_resident`; `chip_smoke.py` times other R and the
    ring)."""
    global LAUNCHES
    rows = launch_rows(model, rows)
    res = _call("nuts_chain_window_f32", q, p0c, dirs, u_acc, u_take, eps,
                inv_mass, model, max_depth, window, out,
                extra=(rows, launch_resident(model, rows, resident)))
    LAUNCHES += 1
    return res


def chain_window_warp(q, p0c, dirs, u_acc, u_take, eps, inv_mass,
                      model: PackedFlow, max_depth: int, window: int):
    """The per-warp module-list window (`nuts_window_chain_kernel`) on
    CUDA tensors: `chip_smoke.py`'s oracle and yardstick for the tile
    kernel, which must equal it in value, on every flow. On no path, and
    not counted in LAUNCHES. Same returns as `nuts_window`."""
    if q.device.type != "cuda":
        raise ValueError("the per-warp module-list window takes CUDA "
                         "tensors")
    check_inputs(q, p0c, dirs, u_acc, u_take, eps, inv_mass, model,
                 max_depth, window=window)
    return _call("nuts_chain_window_warp_f32", q, p0c, dirs, u_acc, u_take,
                 eps, inv_mass, model, max_depth, window, None)


def nuts_window(q, p0c, dirs, u_acc, u_take, eps, inv_mass,
                model: PackedFlow, max_depth: int, window: int, out=None):
    """`window` NUTS transitions of every chain, with the randomness given
    (the layout of `draw_window_randomness`).

    A CPU tensor runs `window_math_torch` with `plain_logp_grad`; a CUDA
    tensor launches K2's tile kernel on tiles of `tile_rows(model)`
    chains, the weights resident where they fit. Same returns as
    `window_math_torch`; the draws are written into `out` (S, n, d) when
    it is given."""
    check_inputs(q, p0c, dirs, u_acc, u_take, eps, inv_mass, model,
                  max_depth, window=window, out=out)
    if q.device.type == "cpu":
        res = window_math_torch(q, p0c, dirs, u_acc, u_take, eps, inv_mass,
                                plain_logp_grad(model), window, max_depth)
        if out is not None:
            res = (out.copy_(res[0]), *res[1:])
        return res
    if q.device.type == "cuda":
        return _launch(q, p0c, dirs, u_acc, u_take, eps, inv_mass, model,
                       max_depth, window, out)
    raise ValueError(f"no NUTS window for device {q.device}")


class FusedNUTSWindow:
    """Flow-preconditioned NUTS draw window for
    `NUTSDriver(window_transition=...)`: `(generator, q, eps, inv_mass,
    out=None) -> (draws (S, n, d), NUTSInfo with (S, n) fields)` on the
    latent density log p(f^-1(z)) + ladj, S = `.window`. Continue a run
    by passing `draws[-1]` back as q.

    The flow's parameters are packed for K2 when this is constructed, so
    build it after the flow is trained."""

    def __init__(self, target, flow: Chain | None, window: int = 32,
                 max_depth: int = 8, device=None):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.model = pack_flow(flow, target, device=device)
        self.window = window
        self.max_depth = max_depth

    def __call__(self, generator, q, eps, inv_mass, out=None):
        n, d = q.shape
        eps = torch.as_tensor(eps, dtype=torch.float32, device=q.device)
        rnd = draw_window_randomness(generator, n, d, self.window,
                                     self.max_depth, inv_mass)
        draws, lp, acc, n_steps, depth, div, turn, h0 = nuts_window(
            q, *rnd, eps, inv_mass, self.model, self.max_depth, self.window,
            out=out)
        return draws, NUTSInfo(
            accept_prob=acc, num_steps=n_steps.to(torch.int32),
            tree_depth=depth.to(torch.int32), diverging=div > 0.5,
            turning=turn > 0.5, energy=h0, logp=lp)


def fused_nuts_window_for_flow(target, flow: Chain | None,
                               window: int = 32,
                               max_depth: int = 8) -> FusedNUTSWindow:
    """The streaming draw window for flow-preconditioned NUTS on `target`,
    for the targets and flows `fused_nuts_for_flow` takes (spline flows
    through the p-major relayout and the streamed per-block gradient, any
    closed-form target at any d <= 256); pass it to
    `NUTSDriver(window_transition=...)`."""
    return FusedNUTSWindow(target, flow, window=window, max_depth=max_depth)
