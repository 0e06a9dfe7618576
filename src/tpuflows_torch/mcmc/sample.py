"""NUTS warmup and draw driver (port of `tpuflows/mcmc/sample.py`:
`NUTSDriver`, `run_nuts`, `nuts_warmup`, `nuts_draws`,
`stan_window_closes`).

The JAX driver runs warmup and draws as jitted scans. Here they are host
loops that call one batched transition per step; the step size, the
dual-averaging and Welford states and the draws stay on the device, so the
driver itself reads nothing back to the host (the portable transition
reads one flag per doubling and per leaf step; K1 none). Warmup schedule
(Stan-like, over num_warmup steps):
  [0, 15%)        step size only
  [15%, 75%)      step size + Welford accumulation
  at 75%          metric <- regularized Welford variance; DA re-centred
  [75%, 100%)     step size under the final metric
Final eps = averaged dual-averaging iterate. `warmup_schedule="stan"`
closes doubling windows instead (`stan_window_closes`).

The transition is the portable `make_nuts_kernel` on `log_density` (its
gradient by autograd, or by a `logp_and_grad=` hook such as K3), or a
natively batched `transition=` (K1, `kernels.nuts_cuda.fused_nuts_for_flow`)
with one pooled step size. Step sizes are pooled by default; with
`per_chain_step_size=True` every dual-averaging leaf is (n_chains,) and the
accept statistic is not pooled.

`window_transition=` (K2,
`kernels.nuts_window_cuda.fused_nuts_window_for_flow`) takes over the draw
phase: each call runs a window of S transitions of every chain and writes
its draws straight into the run's output, and the next call continues from
the last draw. Warmup keeps the per-transition path, since dual averaging
pools the accept statistic between transitions. The draws come from
another random stream than the per-transition path's.

Left out of the port: `jit` and `chunk_size` (eager PyTorch compiles
nothing and runs no device program whose length needs bounding) and
`axis_name` (waits for `dist/`, ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from tpuflows_torch.mcmc.dual_averaging import (
    da_init,
    da_step_size,
    da_update,
    welford_init,
    welford_update_batch,
    welford_variance,
)
from tpuflows_torch.mcmc.nuts import NUTSInfo, make_nuts_kernel


class NUTSState(NamedTuple):
    """Chain state after warmup; pass to `NUTSDriver.draws` to continue."""

    q: torch.Tensor  # (n_chains, d)
    step_size: torch.Tensor  # 0-d (pooled) or (n_chains,)
    inv_mass: torch.Tensor  # (d,)


class MCMCResult(NamedTuple):
    samples: torch.Tensor  # (num_samples, n_chains, d)
    info: NUTSInfo  # stacked per-draw info, (num_samples, n_chains) fields
    step_size: torch.Tensor
    inv_mass: torch.Tensor


def stan_window_closes(num_warmup: int, init_frac: float = 0.15,
                       term_frac: float = 0.10, base_window: int = 25):
    """Stan-style doubling adaptation windows: (closes, welford_start,
    window_end), `closes` a (num_warmup,) bool array marking the steps at
    which a slow window closes (metric installed, Welford reset, DA
    re-centred)."""
    start = int(init_frac * num_warmup)
    end = max(start + 1, int(num_warmup * (1.0 - term_frac)))
    closes = np.zeros(num_warmup, dtype=bool)
    pos, w = start, base_window
    while pos < end:
        nxt = pos + w
        if nxt + 2 * w > end:  # absorb the remainder into this window
            nxt = end
        closes[min(nxt, end) - 1] = True
        pos = nxt
        w *= 2
    return closes, start, end


class NUTSDriver:
    """Reusable NUTS runner: warm up once, then draw windows that continue
    the same chains.

    By default each step runs `make_nuts_kernel(log_density, max_depth,
    logp_and_grad=logp_and_grad)`. `transition(generator, q, eps,
    inv_mass) -> (q_new, NUTSInfo)` replaces it with a natively batched
    transition (`kernels.nuts_cuda.fused_nuts_for_flow`) that draws its
    own randomness from `generator` and takes one pooled 0-d `eps`, so it
    refuses `per_chain_step_size`. `log_density` is required unless
    `transition` is given.

    `window_transition(generator, q, eps, inv_mass, out) -> (draws (S, n,
    d), NUTSInfo with (S, n) fields)`, S its `.window`, writes S draws of
    every chain into `out` (S, n, d) per call
    (`kernels.nuts_window_cuda.fused_nuts_window_for_flow`); when given,
    `draws` runs through it and `num_samples` must be a multiple of S.
    Pooled step size only."""

    def __init__(self, log_density: Callable | None = None,
                 max_depth: int = 8, target_accept: float = 0.8,
                 adapt_mass: bool = True, per_chain_step_size: bool = False,
                 warmup_schedule: str = "single",
                 logp_and_grad: Callable | None = None,
                 transition: Callable | None = None,
                 window_transition: Callable | None = None):
        if window_transition is not None:
            if per_chain_step_size:
                raise ValueError("window_transition= (batched kernel) "
                                 "requires pooled step size")
            if getattr(window_transition, "window", None) is None:
                raise ValueError("window_transition must expose its window "
                                 "size as a `.window` attribute "
                                 "(fused_nuts_window_for_flow does)")
        if transition is not None:
            if per_chain_step_size:
                raise ValueError("transition= (batched kernel) requires "
                                 "pooled step size")
        elif log_density is None:
            raise ValueError("NUTSDriver needs log_density unless "
                             "transition= is given")
        else:
            transition = make_nuts_kernel(log_density, max_depth=max_depth,
                                          logp_and_grad=logp_and_grad)
        if warmup_schedule not in ("single", "stan"):
            raise ValueError(f"unknown warmup_schedule: {warmup_schedule!r}")
        self.transition = transition
        self.window_transition = window_transition
        self.target_accept = target_accept
        self.adapt_mass = adapt_mass
        self.per_chain_step_size = per_chain_step_size
        self.warmup_schedule = warmup_schedule

    def warmup(self, generator: torch.Generator,
               init_positions: torch.Tensor, num_warmup: int,
               initial_step_size: float = 0.1) -> NUTSState:
        if init_positions.ndim != 2:
            raise ValueError("init_positions must be (n_chains, d)")
        q = init_positions
        dev = q.device
        n, d = q.shape
        if self.warmup_schedule == "stan":
            closes, w_start, w_end = stan_window_closes(num_warmup)
        else:
            w_start = int(0.15 * num_warmup)
            w_end = int(0.75 * num_warmup)
            closes = np.zeros(max(num_warmup, 1), dtype=bool)
            closes[w_end] = True
        eps0 = torch.full((n,) if self.per_chain_step_size else (),
                          initial_step_size, device=dev)
        da = da_init(eps0)
        wf = welford_init(d, device=dev)
        inv_mass = torch.ones(d, device=dev)
        for step in range(num_warmup):
            q, info = self.transition(generator, q, da_step_size(da),
                                      inv_mass)
            accept = (info.accept_prob if self.per_chain_step_size
                      else torch.mean(info.accept_prob))
            da = da_update(da, accept, target_accept=self.target_accept)
            if w_start <= step < w_end:
                wf = welford_update_batch(wf, q)
            if self.adapt_mass and closes[step]:
                inv_mass = welford_variance(wf)
                da = da_init(da_step_size(da))
                wf = welford_init(d, device=dev)
        return NUTSState(q=q, step_size=da_step_size(da, averaged=True),
                         inv_mass=inv_mass)

    def draws(self, generator: torch.Generator, state: NUTSState,
              num_samples: int):
        """(new_state, samples (num_samples, n, d), info with (num_samples,
        n) fields); call again to extend the run."""
        q = state.q
        n, d = q.shape
        samples = torch.empty((num_samples, n, d), device=q.device)
        infos = []
        if self.window_transition is not None:
            S = self.window_transition.window
            if num_samples % S:
                raise ValueError(f"num_samples={num_samples} must be a "
                                 f"multiple of the window size {S}")
            for lo in range(0, num_samples, S):
                draws, info = self.window_transition(
                    generator, q, state.step_size, state.inv_mass,
                    out=samples[lo:lo + S])
                q = draws[-1]
                infos.append(info)
            info = NUTSInfo(*(torch.cat(f) for f in zip(*infos)))
            return (NUTSState(q=q, step_size=state.step_size,
                              inv_mass=state.inv_mass), samples, info)
        for s in range(num_samples):
            q, info = self.transition(generator, q, state.step_size,
                                      state.inv_mass)
            samples[s] = q
            infos.append(info)
        info = NUTSInfo(*(torch.stack(f) for f in zip(*infos)))
        return (NUTSState(q=q, step_size=state.step_size,
                          inv_mass=state.inv_mass), samples, info)


def run_nuts(generator: torch.Generator, log_density: Callable,
             init_positions: torch.Tensor, num_warmup: int = 500,
             num_samples: int = 500, initial_step_size: float = 0.1,
             max_depth: int = 8, target_accept: float = 0.8,
             adapt_mass: bool = True, per_chain_step_size: bool = False,
             warmup_schedule: str = "single",
             transition: Callable | None = None) -> MCMCResult:
    """Warmup, then `num_samples` draws of every chain, from one generator.

    Step sizes are pooled by default: the chains run in lockstep, so one
    chain adapting to a tiny step would force deep trees on the whole
    batch. `per_chain_step_size=True` gives each chain its own dual
    averaging, for chains that start in different curvature regimes.
    `transition=` takes a natively batched transition (pooled step size
    only). With `num_warmup=0` the draws use `initial_step_size` and the
    unit metric."""
    if init_positions.ndim != 2:
        raise ValueError("init_positions must be (n_chains, d)")
    driver = NUTSDriver(log_density, max_depth=max_depth,
                        target_accept=target_accept, adapt_mass=adapt_mass,
                        per_chain_step_size=per_chain_step_size,
                        warmup_schedule=warmup_schedule,
                        transition=transition)
    if num_warmup > 0:
        state = driver.warmup(generator, init_positions, num_warmup,
                              initial_step_size=initial_step_size)
    else:
        n, d = init_positions.shape
        dev = init_positions.device
        state = NUTSState(
            q=init_positions,
            step_size=torch.full((n,) if per_chain_step_size else (),
                                 initial_step_size, device=dev),
            inv_mass=torch.ones(d, device=dev))
    state, samples, info = driver.draws(generator, state, num_samples)
    return MCMCResult(samples=samples, info=info, step_size=state.step_size,
                      inv_mass=state.inv_mass)


def nuts_warmup(generator: torch.Generator, log_density: Callable,
                init_positions: torch.Tensor, num_warmup: int = 500,
                initial_step_size: float = 0.1, max_depth: int = 8,
                target_accept: float = 0.8, adapt_mass: bool = True,
                per_chain_step_size: bool = False) -> NUTSState:
    """Warmup adaptation only; returns the state to draw from. One-shot
    convenience over `NUTSDriver` (pooled step size by default, see
    `run_nuts`)."""
    driver = NUTSDriver(log_density, max_depth=max_depth,
                        target_accept=target_accept, adapt_mass=adapt_mass,
                        per_chain_step_size=per_chain_step_size)
    return driver.warmup(generator, init_positions, num_warmup,
                         initial_step_size=initial_step_size)


def nuts_draws(generator: torch.Generator, log_density: Callable,
               state: NUTSState, num_samples: int, max_depth: int = 8):
    """Draw `num_samples` from `state`; returns (new_state, samples, info).
    Call again to extend the run: each call continues the same chains."""
    driver = NUTSDriver(log_density, max_depth=max_depth,
                        per_chain_step_size=bool(state.step_size.ndim))
    return driver.draws(generator, state, num_samples)
