"""Metropolis-Hastings: adaptive random walk and flow independence (port of
`tpuflows/mcmc/mh.py`).

The chain axis is written out, as in `mcmc/hmc.py`: positions are (n, d),
log densities and acceptance statistics (n,). Each transition is a math
function that takes its randomness as tensors (the proposal's standard
normals and the acceptance uniforms) and a wrapper that draws them from a
`torch.Generator`; the runs take a `draw(t)` callable for step t (warmup
steps first, then draws), which the tests fill with the JAX package's own
key-derived draws.

Adaptation (random walk, warmup only): the global log scale takes a
Robbins-Monro step (t+1)^-0.6 toward `target_accept` on the chains'
pooled mean acceptance probability; the per-dim proposal shape sigma is
the square root of the pooled Welford variance (regularized) of the
positions from step int(0.15 num_warmup) on, installed once the count
passes 10. The host loops read nothing back from the device.

Left out: `jit` (nothing to compile in eager PyTorch) and `axis_name`
(waits for `dist/`, ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from tpuflows_torch.flows.core import Bijector
from tpuflows_torch.mcmc.dual_averaging import (welford_init,
                                                welford_update_batch,
                                                welford_variance)
from tpuflows_torch.targets.base import std_normal_logpdf


class MHInfo(NamedTuple):
    accept_prob: torch.Tensor
    accepted: torch.Tensor
    logp: torch.Tensor


class MHResult(NamedTuple):
    samples: torch.Tensor  # (num_samples, n_chains, d)
    info: MHInfo  # stacked per-draw info, (num_samples, n_chains) fields
    scale: torch.Tensor  # final global proposal scale, 0-d
    sigma: torch.Tensor  # final per-dim proposal std (d,)


def accept_probability(log_ratio: torch.Tensor) -> torch.Tensor:
    """min(1, exp(min(log_ratio, 0))), NaN kept."""
    return torch.clamp(torch.exp(torch.clamp(log_ratio, max=0.0)), max=1.0)


def select(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    """where(mask, new, old), mask broadcast over new's trailing axes."""
    shape = mask.shape + (1,) * (new.ndim - mask.ndim)
    return torch.where(mask.reshape(shape), new, old)


def rwmh_transition_math(log_density: Callable, q, logp, scale, sigma, eps,
                         u):
    """One Gaussian random-walk MH step of every chain: q (n, d), logp
    (n,), scale 0-d, sigma (d,), the proposal's standard normals eps
    (n, d) and the uniforms u (n,). Returns (q, logp, MHInfo)."""
    q_new = q + scale * sigma * eps
    logp_new = log_density(q_new)
    log_ratio = logp_new - logp
    accepted = torch.log(u) < log_ratio
    q = select(accepted, q_new, q)
    logp = select(accepted, logp_new, logp)
    return q, logp, MHInfo(accept_prob=accept_probability(log_ratio),
                           accepted=accepted, logp=logp)


def _normals_and_uniforms(generator, n, d, device):
    def draw(_):
        eps = torch.randn((n, d), generator=generator, device=device)
        u = torch.rand(n, generator=generator, device=device)
        return eps, u

    return draw


def make_rwmh_kernel(log_density: Callable) -> Callable:
    """`transition(generator, q (n, d), logp (n,), scale, sigma) -> (q,
    logp, MHInfo)`, its randomness drawn from `generator` on q's device.
    Carries logp so the target is evaluated once per step."""

    def transition(generator, q, logp, scale, sigma):
        eps, u = _normals_and_uniforms(generator, *q.shape, q.device)(0)
        return rwmh_transition_math(log_density, q, logp, scale, sigma,
                                    eps, u)

    return transition


def robbins_monro_rate(t: int) -> float:
    """(t+1)^-0.6 in float32, the adaptation's step size at step t."""
    return float(np.float32(t + 1.0) ** np.float32(-0.6))


def initial_log_scale(initial_scale: float, d: int, device) -> torch.Tensor:
    """log(initial_scale 2.38 / sqrt(d)) in float32: the optimal-scaling
    start (Roberts et al.)."""
    f32 = torch.float32
    return torch.log(torch.tensor(initial_scale * 2.38, dtype=f32,
                                  device=device)
                     / torch.sqrt(torch.tensor(float(d), dtype=f32,
                                               device=device)))


def _stacked_info(num_samples, n, device) -> MHInfo:
    return MHInfo(accept_prob=torch.empty((num_samples, n), device=device),
                  accepted=torch.empty((num_samples, n), dtype=torch.bool,
                                       device=device),
                  logp=torch.empty((num_samples, n), device=device))


def _rwmh_warmup(log_density, q0, draw, num_warmup, initial_scale,
                 target_accept, adapt_shape):
    """Steps 0 .. num_warmup - 1: (q, logp, log_scale, sigma)."""
    n, d = q0.shape
    dev = q0.device
    welford_start = int(0.15 * num_warmup)
    q, logp = q0, log_density(q0)
    log_scale = initial_log_scale(initial_scale, d, dev)
    sigma = torch.ones(d, device=dev)
    wf = welford_init(d, device=dev)
    for t in range(num_warmup):
        eps, u = draw(t)
        q, logp, info = rwmh_transition_math(log_density, q, logp,
                                             torch.exp(log_scale), sigma,
                                             eps, u)
        accept = torch.mean(info.accept_prob)
        log_scale = log_scale + robbins_monro_rate(t) * (accept
                                                         - target_accept)
        if adapt_shape:
            if t >= welford_start:
                wf = welford_update_batch(wf, q)
            sigma = torch.where(wf.count > 10.0,
                                torch.sqrt(welford_variance(wf)), sigma)
    return q, logp, log_scale, sigma


def _rwmh_draws(log_density, q, logp, scale, sigma, draw, first,
                num_samples):
    """Steps first .. first + num_samples - 1 at a fixed proposal:
    (samples, stacked MHInfo)."""
    n, d = q.shape
    samples = torch.empty((num_samples, n, d), device=q.device)
    infos = _stacked_info(num_samples, n, q.device)
    for s in range(num_samples):
        eps, u = draw(first + s)
        q, logp, info = rwmh_transition_math(log_density, q, logp, scale,
                                             sigma, eps, u)
        samples[s] = q
        for out, v in zip(infos, info):
            out[s] = v
    return samples, infos


def _rwmh_run(log_density, q0, draw, num_warmup, num_samples, initial_scale,
              target_accept, adapt_shape) -> MHResult:
    q, logp, log_scale, sigma = _rwmh_warmup(
        log_density, q0, draw, num_warmup, initial_scale, target_accept,
        adapt_shape)
    scale = torch.exp(log_scale)
    samples, infos = _rwmh_draws(log_density, q, logp, scale, sigma, draw,
                                 num_warmup, num_samples)
    return MHResult(samples=samples, info=infos, scale=scale, sigma=sigma)


def run_rwmh(generator: torch.Generator, log_density: Callable,
             init_positions: torch.Tensor, num_warmup: int = 1000,
             num_samples: int = 1000, initial_scale: float = 0.5,
             target_accept: float = 0.234,
             adapt_shape: bool = True) -> MHResult:
    """Adaptive random-walk Metropolis over (n_chains, d) chains (BAT's
    `MetropolisHastings`): warmup adapts the global scale and, with
    `adapt_shape`, the per-dim proposal shape (module docstring); the
    draws keep both fixed. Every step's normals and uniforms come from
    `generator` on the chains' device."""
    n, d = init_positions.shape
    return _rwmh_run(log_density, init_positions,
                     _normals_and_uniforms(generator, n, d,
                                           init_positions.device),
                     num_warmup, num_samples, initial_scale, target_accept,
                     adapt_shape)


def flow_imh_transition_math(log_density: Callable, flow: Bijector, q, logp,
                             logq, z, u):
    """One flow-independence MH step of every chain: the proposal
    x' = f^-1(z) for the base draws z (n, d), log q(x') = log N(z) -
    ladj_inv(z), accepted by min(1, p(x') q(x) / (p(x) q(x'))) against
    the uniforms u (n,). Returns (q, logp, logq, MHInfo)."""
    with torch.no_grad():
        x_new, inv_ladj = flow.inverse_and_ladj(z)
    logq_new = std_normal_logpdf(z) - inv_ladj
    logp_new = log_density(x_new)
    log_ratio = (logp_new - logp) - (logq_new - logq)
    accepted = torch.log(u) < log_ratio
    q = select(accepted, x_new, q)
    logp = select(accepted, logp_new, logp)
    logq = select(accepted, logq_new, logq)
    return q, logp, logq, MHInfo(accept_prob=accept_probability(log_ratio),
                                 accepted=accepted, logp=logp)


def make_flow_imh_kernel(log_density: Callable, flow: Bijector, dim: int):
    """(transition, log_q): `transition(generator, q, logp, logq) -> (q,
    logp, logq, MHInfo)` proposes from the flow (z ~ N(0, I), x' =
    f^-1(z)); `log_q(x)` = log N(f(x)) + ladj_f(x), the proposal's
    density."""

    def log_q(x):
        with torch.no_grad():
            z, ladj = flow.forward_and_ladj(x)
        return std_normal_logpdf(z) + ladj

    def transition(generator, q, logp, logq):
        z, u = _normals_and_uniforms(generator, q.shape[0], dim,
                                     q.device)(0)
        return flow_imh_transition_math(log_density, flow, q, logp, logq,
                                        z, u)

    return transition, log_q


def _flow_imh_run(log_density, flow, q0, draw, num_samples) -> MHResult:
    n, d = q0.shape
    dev = q0.device
    _, log_q = make_flow_imh_kernel(log_density, flow, d)
    q, logp, logq = q0, log_density(q0), log_q(q0)
    samples = torch.empty((num_samples, n, d), device=dev)
    infos = _stacked_info(num_samples, n, dev)
    for s in range(num_samples):
        z, u = draw(s)
        q, logp, logq, info = flow_imh_transition_math(
            log_density, flow, q, logp, logq, z, u)
        samples[s] = q
        for out, v in zip(infos, info):
            out[s] = v
    return MHResult(samples=samples, info=infos,
                    scale=torch.ones((), device=dev),
                    sigma=torch.ones(d, device=dev))


def run_flow_imh(generator: torch.Generator, log_density: Callable,
                 flow: Bijector, init_positions: torch.Tensor,
                 num_samples: int = 1000) -> MHResult:
    """Flow-independence MH over (n_chains, d) chains. No adaptation: the
    proposal is the trained flow, which the adaptive loop retrains. The
    result's scale and sigma are ones."""
    n, d = init_positions.shape
    return _flow_imh_run(log_density, flow, init_positions,
                         _normals_and_uniforms(generator, n, d,
                                               init_positions.device),
                         num_samples)
