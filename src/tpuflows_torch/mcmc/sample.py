"""NUTS warmup and draw driver (port of `NUTSDriver` and
`stan_window_closes` from `tpuflows/mcmc/sample.py`).

The JAX driver runs warmup and draws as jitted scans. Here they are host
loops that launch one batched transition per step; the step size, the
dual-averaging and Welford states and the draws stay on the device, so a
step reads nothing back to the host. Warmup schedule (Stan-like, over
num_warmup steps):
  [0, 15%)        step size only
  [15%, 75%)      step size + Welford accumulation
  at 75%          metric <- regularized Welford variance; DA re-centred
  [75%, 100%)     step size under the final metric
Final eps = averaged dual-averaging iterate.

Only the pooled step size and a batched `transition` are ported;
`make_nuts_kernel` (the JAX driver's default transition), `run_nuts`,
per-chain step sizes and the streaming window path wait (ROADMAP.md,
Queue 1 item 4).
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
from tpuflows_torch.mcmc.nuts import NUTSInfo


class NUTSState(NamedTuple):
    """Chain state after warmup; pass to `NUTSDriver.draws` to continue."""

    q: torch.Tensor  # (n_chains, d)
    step_size: torch.Tensor  # 0-d, pooled
    inv_mass: torch.Tensor  # (d,)


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

    `transition(generator, q, eps, inv_mass) -> (q_new, NUTSInfo)` is a
    natively batched transition (`kernels.nuts_cuda.fused_nuts_for_flow`);
    it draws its own randomness from `generator` and takes one pooled 0-d
    `eps`."""

    def __init__(self, transition: Callable, target_accept: float = 0.8,
                 adapt_mass: bool = True, warmup_schedule: str = "single"):
        if warmup_schedule not in ("single", "stan"):
            raise ValueError(f"unknown warmup_schedule: {warmup_schedule!r}")
        self.transition = transition
        self.target_accept = target_accept
        self.adapt_mass = adapt_mass
        self.warmup_schedule = warmup_schedule

    def warmup(self, generator: torch.Generator,
               init_positions: torch.Tensor, num_warmup: int,
               initial_step_size: float = 0.1) -> NUTSState:
        if init_positions.ndim != 2:
            raise ValueError("init_positions must be (n_chains, d)")
        q = init_positions
        dev = q.device
        d = q.shape[-1]
        if self.warmup_schedule == "stan":
            closes, w_start, w_end = stan_window_closes(num_warmup)
        else:
            w_start = int(0.15 * num_warmup)
            w_end = int(0.75 * num_warmup)
            closes = np.zeros(max(num_warmup, 1), dtype=bool)
            closes[w_end] = True
        da = da_init(torch.tensor(initial_step_size, device=dev))
        wf = welford_init(d, device=dev)
        inv_mass = torch.ones(d, device=dev)
        for step in range(num_warmup):
            q, info = self.transition(generator, q, da_step_size(da),
                                      inv_mass)
            da = da_update(da, torch.mean(info.accept_prob),
                           target_accept=self.target_accept)
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
        for s in range(num_samples):
            q, info = self.transition(generator, q, state.step_size,
                                      state.inv_mass)
            samples[s] = q
            infos.append(info)
        info = NUTSInfo(*(torch.stack(f) for f in zip(*infos)))
        return (NUTSState(q=q, step_size=state.step_size,
                          inv_mass=state.inv_mass), samples, info)
