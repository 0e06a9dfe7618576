"""No-U-Turn Sampler: iterative multinomial NUTS over a batch of chains,
fixed max depth (port of `tpuflows/mcmc/nuts.py`).

The JAX package writes `make_nuts_kernel` for one chain and vmaps it, so
its `lax.while_loop`s run in masked lockstep over the chains. Here the
lockstep is written out (`nuts_transition_math`): a Python loop over the
doublings and, inside each, over the leaves of the subtree, on (n, d)
tensors, every update a select under the mask of the chains still
running. The loops end as soon as no chain runs. The tree is the JAX
package's: progressive multinomial sampling within subtrees, biased
progressive acceptance across doublings, the generalized U-turn criterion
on momentum sums with the O(max_depth) checkpoint scheme, and divergence
at an energy error above `max_delta_energy`.

The randomness comes in as tensors (`draw_randomness` draws it from a
`torch.Generator`): momenta, one direction sign and one acceptance uniform
per doubling, one uniform per potential leaf. The leaf uniforms of
doubling k sit in columns 2^k - 1 .. 2^(k+1) - 2, so a run with fewer
leaves draws the same numbers.

The gradient comes from a hook `logp_and_grad(q (n, d)) -> (lp (n,),
g (n, d))`: autograd through `log_density` by default (`hmc.value_and_grad`),
or `kernels.fused_logp_cuda.fused_latent_logp_and_grad` (K3). K1's plain
version (`kernels.nuts_cuda.transition_math_torch`) is this same function
with non-finite divergent leaves zeroed, as K1 does.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from tpuflows_torch.mcmc.hmc import step_column, value_and_grad


def _popcount32(x):
    """Set bits of a 32-bit non-negative int (Python int or int tensor)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _trailing_zeros32(x):
    """Trailing zero bits of a positive 32-bit int."""
    return _popcount32((x & -x) - 1)


class NUTSInfo(NamedTuple):
    accept_prob: torch.Tensor  # mean MH-style accept stat over the trajectory
    num_steps: torch.Tensor  # leapfrog steps taken
    tree_depth: torch.Tensor
    diverging: torch.Tensor
    turning: torch.Tensor
    energy: torch.Tensor  # H0 of the transition
    logp: torch.Tensor  # log density at the new position


def _is_turning(p_left, p_right, rho, inv_mass):
    """Generalized U-turn: rho . v <= 0 at either end (v = M^-1 p), per
    chain, as an (n, 1) mask."""
    v = rho * inv_mass
    return ((torch.sum(v * p_left, -1, keepdim=True) <= 0.0)
            | (torch.sum(v * p_right, -1, keepdim=True) <= 0.0))


def nuts_transition_math(q, p0, dirs, u_acc, u_take, eps, inv_mass,
                         logp_and_grad: Callable, max_depth: int,
                         max_delta_energy: float = 1000.0,
                         zero_nonfinite: bool = False):
    """One NUTS transition of every chain, with the randomness given:
    `make_nuts_kernel`'s tree (and `_transition_math`'s, the JAX kernel's
    plain reference) with exact selects.

    q/p0: (n, d); dirs/u_acc: (n, max_depth); u_take: (n, 2^max_depth);
    eps: 0-d, or (n,) for one step size per chain; inv_mass: (d,);
    logp_and_grad: (n, d) -> (lp (n,) or (n, 1), g (n, d)), called once at
    q and once per leaf step of the batch. A divergent leaf carries its
    values as they are, as `make_nuts_kernel` does; `zero_nonfinite` zeroes
    its non-finite q, p and g instead, as K1 does (it can change only the
    divergent chain's `turning` flag).
    Returns (q_new, lp_new, sum_accept, n_steps, depth, diverging,
    turning, h0): q_new (n, d), the rest (n,) float32."""
    D = max_depth
    inf = float("inf")
    eps = step_column(eps, q)

    def kin(p):
        return 0.5 * torch.sum(p * p * inv_mass, -1, keepdim=True)

    def where(m, a, b):
        return torch.where(m, a, b)

    def finite_or_zero(x):
        return where(torch.isfinite(x), x, torch.zeros_like(x))

    def logp_grad(z):
        lp, g = logp_and_grad(z)
        return lp.reshape(-1, 1), g

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
            div_leaf = dh > max_delta_energy
            logw_leaf = where(div_leaf, torch.full_like(dh, -inf), -dh)
            accept = torch.clamp(torch.exp(torch.clamp(-dh, max=0.0)),
                                 max=1.0)
            accept = finite_or_zero(accept)
            logw_new = torch.logaddexp(st_logw, logw_leaf)
            u = u_take[:, col + leaf:col + leaf + 1]
            if zero_nonfinite:
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
                    any_turn = any_turn | _is_turning(
                        ck_p[i], p_new, rho_new - ck_r[i], inv_mass)
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
        turn_comb = _is_turning(zl[1], zr[1], rho, inv_mass)
        turning = where(active, st_turn | (ok & turn_comb), turning)
        diverging = where(active, st_div, diverging)
        sum_accept = sum_accept + where(active, st_acc, zeros1)
        n_steps = n_steps + where(active, st_n, zeros1)
        depth = where(ok, torch.full_like(depth, k + 1.0), depth)

    f32 = torch.float32
    return (q_prop, lp_prop[:, 0], sum_accept[:, 0], n_steps[:, 0],
            depth[:, 0], diverging[:, 0].to(f32), turning[:, 0].to(f32),
            h0[:, 0])


def nuts_info(lp, sum_accept, n_steps, depth, diverging, turning, h0
              ) -> NUTSInfo:
    """The NUTSInfo of `nuts_transition_math`'s (n,) float outputs."""
    return NUTSInfo(
        accept_prob=sum_accept / torch.clamp(n_steps, min=1.0),
        num_steps=n_steps.to(torch.int32),
        tree_depth=depth.to(torch.int32),
        diverging=diverging > 0.5,
        turning=turning > 0.5,
        energy=h0,
        logp=lp,
    )


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


def draw_window_randomness(generator: torch.Generator, n: int, d: int,
                           window: int, max_depth: int,
                           inv_mass: torch.Tensor):
    """(p0c, dirs, u_acc, u_take) for `window` sequential transitions of n
    chains, in the layout of the JAX package's window kernel
    (`make_fused_nuts_window`): slot-major inside each chain's row, so
    slot s owns p0c columns s d .. (s + 1) d - 1, dirs and u_acc columns
    s D .. (s + 1) D - 1 and u_take columns s 2^D .. (s + 1) 2^D - 1
    (D = max_depth). p0c (n, window d) is already scaled to N(0, M); as in
    the JAX package the momenta are `normal * (1 / sqrt(inv_mass))`, which
    rounds differently from `draw_randomness`'s `normal / sqrt(inv_mass)`.
    Drawn on `inv_mass`'s device, which must be the generator's."""
    dev = inv_mass.device
    D, L = max_depth, 1 << max_depth
    inv_sqrt = 1.0 / torch.sqrt(inv_mass)
    p0c = (torch.randn((n, window, d), generator=generator, device=dev)
           * inv_sqrt).reshape(n, window * d)
    dirs = torch.where(
        torch.rand((n, window * D), generator=generator, device=dev) < 0.5,
        1.0, -1.0)
    u_acc = torch.rand((n, window * D), generator=generator, device=dev)
    u_take = torch.rand((n, window * L), generator=generator, device=dev)
    return p0c, dirs, u_acc, u_take


class NUTSKernel:
    """`transition(generator, q (n, d), eps, inv_mass) -> (q_new,
    NUTSInfo)`, the batched transition `make_nuts_kernel` returns.

    `math(q, p0, dirs, u_acc, u_take, eps, inv_mass)` runs it on given
    randomness. `grad_calls` counts the calls of the gradient hook since
    construction: one at q and one per leaf step of the batch, per
    transition."""

    def __init__(self, logp_and_grad: Callable, max_depth: int,
                 max_delta_energy: float):
        self.logp_and_grad = logp_and_grad
        self.max_depth = max_depth
        self.max_delta_energy = max_delta_energy
        self.grad_calls = 0

    def _counted(self, z):
        self.grad_calls += 1
        return self.logp_and_grad(z)

    def math(self, q, p0, dirs, u_acc, u_take, eps, inv_mass):
        q_new, *rest = nuts_transition_math(
            q, p0, dirs, u_acc, u_take, eps, inv_mass, self._counted,
            self.max_depth, self.max_delta_energy)
        return q_new, nuts_info(*rest)

    def __call__(self, generator, q, eps, inv_mass):
        n, d = q.shape
        p0, dirs, u_acc, u_take = draw_randomness(generator, n, d,
                                                  self.max_depth, inv_mass)
        return self.math(q, p0, dirs, u_acc, u_take, eps, inv_mass)


def make_nuts_kernel(log_density: Callable, max_depth: int = 8,
                     max_delta_energy: float = 1000.0,
                     logp_and_grad: Callable | None = None) -> NUTSKernel:
    """The batched NUTS transition on `log_density` (`NUTSKernel`). `eps`
    is 0-d (pooled) or (n,) (one per chain); `inv_mass` (d,).

    `logp_and_grad(q) -> (lp, g)` overrides autograd through
    `log_density`: the hook for K3
    (`kernels.fused_logp_cuda.fused_latent_logp_and_grad`)."""
    if logp_and_grad is None:
        logp_and_grad = value_and_grad(log_density)
    return NUTSKernel(logp_and_grad, max_depth, max_delta_energy)
