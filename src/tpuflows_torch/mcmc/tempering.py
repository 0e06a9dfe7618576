"""Parallel tempering (replica exchange) over a fixed ladder of betas (port
of `tpuflows/mcmc/tempering.py`).

The tempered density of replica (i, c) is

    log pi_beta(x) = (1 - beta_i) log_ref(x) + beta_i log_density(x),

log_ref a standard normal by default, each replica caching its log_ref and
log_density values. The replicas are one (n_temps, n_chains, d) tensor.
Each step is a random-walk MH move of every replica, then an even/odd
exchange: pair (i, i+1) forms where (i - parity) % 2 == 0, and swaps
chain by chain with the Metropolis ratio dbeta (d(logl - logr)), a gather
along the temperature axis whose pair shares the uniform of its lower
member. Warmup adapts one log scale per temperature by Robbins-Monro
toward `target_accept`. As in `mcmc/mh.py`, the move and the exchange are
math functions of their draws (`pt_move_math`, `pt_swap_math`), and the
run takes a `draw(t)` callable.

`mesh=` (the JAX package's `axis_name`): the chains are this rank's block
and the generator is folded by rank; each step's acceptance per
temperature is averaged over the mesh (`pmean`) before the warmup adapts
on it and the draws record it. Left out: `jit`.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from tpuflows_torch.dist.collectives import fold_in_axis_index, pmean
from tpuflows_torch.mcmc.mh import (accept_probability, initial_log_scale,
                                    robbins_monro_rate, select)
from tpuflows_torch.targets.base import std_normal_logpdf


class PTInfo(NamedTuple):
    accept_prob: torch.Tensor  # (n_temps,) mean within-temperature accept
    swap_accept: torch.Tensor  # (n_temps - 1,) neighbour swap acceptance
    logp: torch.Tensor  # (n_chains,) the beta = 1 replica's log density


class PTResult(NamedTuple):
    samples: torch.Tensor  # (num_samples, n_chains, d) beta = 1 draws
    info: PTInfo  # stacked per-draw info
    scales: torch.Tensor  # (n_temps,) final proposal scales
    betas: torch.Tensor  # (n_temps,)


def geometric_betas(n_temps: int, beta_min: float = 1e-2,
                    device="cuda") -> torch.Tensor:
    """The geometric ladder beta_min -> 1 in float32 (one rung: [1])."""
    if n_temps < 2:
        return torch.ones(1, device=device)
    f32 = np.float32
    expo = f32(1.0) - np.arange(n_temps, dtype=f32) / f32(n_temps - 1)
    return torch.tensor(f32(beta_min) ** expo, device=device)


def tempered(betas, logr, logl):
    """(n_temps, n_chains) tempered log densities from cached values."""
    return (1.0 - betas)[:, None] * logr + betas[:, None] * logl


def pt_move_math(log_density: Callable, log_ref: Callable, betas, x, logr,
                 logl, scales, eps, u):
    """One random-walk MH step of every replica: x (T, n, d), logr and
    logl (T, n), scales (T,), the standard normals eps (T, n, d) and the
    uniforms u (T, n). Returns (x, logr, logl, the mean acceptance
    probability per temperature (T,))."""
    x_new = x + scales[:, None, None] * eps
    logr_new = log_ref(x_new)
    logl_new = log_density(x_new)
    log_ratio = (tempered(betas, logr_new, logl_new)
                 - tempered(betas, logr, logl))
    accepted = torch.log(u) < log_ratio
    x = select(accepted, x_new, x)
    logr = select(accepted, logr_new, logr)
    logl = select(accepted, logl_new, logl)
    return x, logr, logl, torch.mean(accept_probability(log_ratio), dim=1)


def pt_swap_math(betas, x, logr, logl, u, parity: int):
    """The exchange at `parity`: pair (i, i+1) for (i - parity) % 2 == 0;
    the uniforms u (T, n), the pair using its lower member's. Returns
    (x, logr, logl, the swap rate per interface (T - 1,), read off the
    lower members)."""
    n_temps = betas.shape[0]
    idx = torch.arange(n_temps, device=betas.device)
    lower = ((idx - parity) % 2) == 0
    partner = torch.where(lower, idx + 1, idx - 1)
    valid = (partner >= 0) & (partner < n_temps)
    partner = torch.clamp(partner, 0, n_temps - 1)
    e = logl - logr
    log_ratio = (betas[partner] - betas)[:, None] * (e - e[partner])
    u_pair = torch.where(lower[:, None], u, u[partner])
    do_swap = (torch.log(u_pair) < log_ratio) & valid[:, None]
    x = select(do_swap, x[partner], x)
    logr = select(do_swap, logr[partner], logr)
    logl = select(do_swap, logl[partner], logl)
    rate = torch.mean(do_swap.float(), dim=1)
    return x, logr, logl, torch.where(lower[:-1], rate[:-1], rate[1:])


def _pt_randomness(generator, n_temps, n, d, device):
    def draw(_):
        eps = torch.randn((n_temps, n, d), generator=generator,
                          device=device)
        u_move = torch.rand((n_temps, n), generator=generator,
                            device=device)
        u_swap = torch.rand((n_temps, n), generator=generator,
                            device=device)
        return eps, u_move, u_swap

    return draw


def _pt_step(log_density, log_ref, betas, draw, t, parity, x, logr, logl,
             log_scales, mesh=None):
    """Step t: the move (its acceptance averaged over the mesh), then the
    exchange at `parity`."""
    eps, u_move, u_swap = draw(t)
    x, logr, logl, acc = pt_move_math(log_density, log_ref, betas, x, logr,
                                      logl, torch.exp(log_scales), eps,
                                      u_move)
    acc = pmean(acc, mesh)
    x, logr, logl, swap_rate = pt_swap_math(betas, x, logr, logl, u_swap,
                                            parity)
    return x, logr, logl, acc, swap_rate


def _pt_warmup(log_density, log_ref, q0, betas, draw, num_warmup,
               initial_scale, target_accept, mesh=None):
    """Steps 0 .. num_warmup - 1 from q0 tiled over the ladder: (x, logr,
    logl, log_scales)."""
    n, d = q0.shape
    n_temps = betas.shape[0]
    x = q0[None].expand(n_temps, n, d)
    logr, logl = log_ref(x), log_density(x)
    log_scales = initial_log_scale(initial_scale, d, q0.device).expand(
        n_temps)
    for t in range(num_warmup):
        x, logr, logl, acc, _ = _pt_step(log_density, log_ref, betas, draw,
                                         t, t % 2, x, logr, logl,
                                         log_scales, mesh)
        log_scales = log_scales + robbins_monro_rate(t) * (acc
                                                           - target_accept)
    return x, logr, logl, log_scales


def _pt_sample(log_density, log_ref, betas, draw, first, num_samples, x,
               logr, logl, log_scales, mesh=None):
    """Steps first .. first + num_samples - 1, the parity restarting at 0:
    (the beta = 1 draws, stacked PTInfo)."""
    n_temps, n, d = x.shape
    dev = x.device
    samples = torch.empty((num_samples, n, d), device=dev)
    info = PTInfo(accept_prob=torch.empty((num_samples, n_temps),
                                          device=dev),
                  swap_accept=torch.empty((num_samples, n_temps - 1),
                                          device=dev),
                  logp=torch.empty((num_samples, n), device=dev))
    for s in range(num_samples):
        x, logr, logl, acc, swap_rate = _pt_step(
            log_density, log_ref, betas, draw, first + s, s % 2, x, logr,
            logl, log_scales, mesh)
        samples[s] = x[-1]
        info.accept_prob[s] = acc
        info.swap_accept[s] = swap_rate
        info.logp[s] = logl[-1]
    return samples, info


def _pt_run(log_density, log_ref, q0, betas, draw, num_warmup, num_samples,
            initial_scale, target_accept, mesh=None) -> PTResult:
    x, logr, logl, log_scales = _pt_warmup(
        log_density, log_ref, q0, betas, draw, num_warmup, initial_scale,
        target_accept, mesh)
    samples, info = _pt_sample(log_density, log_ref, betas, draw,
                               num_warmup, num_samples, x, logr, logl,
                               log_scales, mesh)
    return PTResult(samples=samples, info=info, scales=torch.exp(log_scales),
                    betas=betas)


def run_parallel_tempering(generator: torch.Generator, log_density: Callable,
                           init_positions: torch.Tensor, betas,
                           num_warmup: int = 1000, num_samples: int = 1000,
                           initial_scale: float = 0.5,
                           target_accept: float = 0.234,
                           log_ref: Optional[Callable] = None,
                           mesh=None) -> PTResult:
    """Replica-exchange MH from (n_chains, d) positions, tiled over the
    ascending ladder `betas` (betas[-1] == 1); returns the beta = 1
    replica's draws. Each step's normals and uniforms come from
    `generator` on the chains' device: the move's normals (T, n, d) and
    uniforms (T, n), then the exchange's uniforms (T, n). `mesh`
    (`axis_name`): the chains are this rank's block, the generator folded
    by rank, the acceptance per temperature averaged over the mesh."""
    if log_ref is None:
        log_ref = std_normal_logpdf
    generator = fold_in_axis_index(generator, mesh)
    dev = init_positions.device
    betas = torch.as_tensor(betas, dtype=torch.float32, device=dev)
    n, d = init_positions.shape
    return _pt_run(log_density, log_ref, init_positions, betas,
                   _pt_randomness(generator, betas.shape[0], n, d, dev),
                   num_warmup, num_samples, initial_scale, target_accept,
                   mesh)
