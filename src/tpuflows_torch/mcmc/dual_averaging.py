"""Step-size and mass-matrix adaptation (port of
`tpuflows/mcmc/dual_averaging.py`).

Nesterov dual averaging with Stan's defaults, and a Welford (Chan parallel)
diagonal variance estimator. Every state field is a tensor on the chains'
device, so an adaptation step never reads a value back to the host.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class DualAveragingState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    mu: torch.Tensor
    t: torch.Tensor


def da_init(eps0) -> DualAveragingState:
    """`eps0`: a float or a tensor (0-d pooled, or one per chain)."""
    log_eps = torch.log(torch.as_tensor(eps0, dtype=torch.float32))
    zeros = torch.zeros_like(log_eps)
    return DualAveragingState(log_eps=log_eps, log_eps_bar=zeros,
                              h_bar=zeros, mu=math.log(10.0) + log_eps,
                              t=zeros)


def da_update(state: DualAveragingState, accept_stat: torch.Tensor,
              target_accept: float = 0.8, gamma: float = 0.05,
              t0: float = 10.0, kappa: float = 0.75) -> DualAveragingState:
    t = state.t + 1.0
    w = 1.0 / (t + t0)
    h_bar = (1.0 - w) * state.h_bar + w * (target_accept - accept_stat)
    log_eps = state.mu - torch.sqrt(t) / gamma * h_bar
    eta = t ** (-kappa)
    log_eps_bar = eta * log_eps + (1.0 - eta) * state.log_eps_bar
    return DualAveragingState(log_eps=log_eps, log_eps_bar=log_eps_bar,
                              h_bar=h_bar, mu=state.mu, t=t)


def da_step_size(state: DualAveragingState, averaged: bool = False):
    return torch.exp(state.log_eps_bar if averaged else state.log_eps)


class WelfordState(NamedTuple):
    """Streaming mean/variance over pooled (chain x step) draws."""

    count: torch.Tensor  # 0-d
    mean: torch.Tensor  # (d,)
    m2: torch.Tensor  # (d,)


def welford_init(dim: int, device="cuda") -> WelfordState:
    return WelfordState(count=torch.zeros((), device=device),
                        mean=torch.zeros(dim, device=device),
                        m2=torch.zeros(dim, device=device))


def welford_update_batch(state: WelfordState, x: torch.Tensor
                         ) -> WelfordState:
    """Chan parallel update with a batch x: (n, d)."""
    n = float(x.shape[0])
    bmean = torch.mean(x, dim=0)
    bm2 = torch.sum((x - bmean) ** 2, dim=0)
    delta = bmean - state.mean
    tot = state.count + n
    mean = state.mean + delta * n / torch.clamp(tot, min=1.0)
    m2 = (state.m2 + bm2
          + delta * delta * state.count * n / torch.clamp(tot, min=1.0))
    return WelfordState(count=tot, mean=mean, m2=m2)


def welford_merge(a: WelfordState, b: WelfordState) -> WelfordState:
    tot = a.count + b.count
    delta = b.mean - a.mean
    mean = a.mean + delta * b.count / torch.clamp(tot, min=1.0)
    m2 = (a.m2 + b.m2
          + delta * delta * a.count * b.count / torch.clamp(tot, min=1.0))
    return WelfordState(count=tot, mean=mean, m2=m2)


def welford_variance(state: WelfordState, regularize: bool = True
                     ) -> torch.Tensor:
    var = state.m2 / torch.clamp(state.count - 1.0, min=1.0)
    if regularize:
        # Stan's shrinkage toward the unit metric for small counts
        n = state.count
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return var
