"""Particle resampling (port of `tpuflows/smc/resample.py`): systematic
resampling, the low-variance O(n) standard, and multinomial for tests.

Systematic resampling takes one uniform u0; `systematic_indices_math`
takes it as a tensor, so tests can hand it the JAX package's draw, and
`systematic_indices` draws it from a `torch.Generator`. Ancestor indices
come from `searchsorted` on the weights' cumulative sum, as int32 (the
JAX package's dtype; torch indexes with int32 too).
"""
from __future__ import annotations

import torch


def normalize_log_weights(log_w: torch.Tensor, dim: int = -1
                          ) -> torch.Tensor:
    return log_w - torch.logsumexp(log_w, dim=dim, keepdim=True)


def systematic_indices_math(u0, log_w: torch.Tensor,
                            n_out: int | None = None) -> torch.Tensor:
    """Systematic ancestors of (n,) log weights for the uniform u0 (0-d):
    (n_out,) int32, n_out defaulting to n (another n_out draws a
    population of that size from the same weighted measure: the
    cross-fitted path switch resamples n particles from half of them)."""
    n = log_w.shape[0]
    m = n if n_out is None else n_out
    w = torch.exp(normalize_log_weights(log_w))
    cdf = torch.cumsum(w, dim=0)
    cdf = cdf / cdf[-1]  # an exact 1.0 endpoint despite roundoff
    positions = (u0 + torch.arange(m, dtype=torch.float32,
                                   device=log_w.device)) / m
    idx = torch.searchsorted(cdf, positions, side="left")
    return torch.clamp(idx, 0, n - 1).to(torch.int32)


def systematic_indices(generator: torch.Generator, log_w: torch.Tensor,
                       n_out: int | None = None) -> torch.Tensor:
    """`systematic_indices_math` with u0 drawn from `generator` (on
    log_w's device)."""
    u0 = torch.rand((), generator=generator, device=log_w.device)
    return systematic_indices_math(u0, log_w, n_out)


def multinomial_indices(generator: torch.Generator, log_w: torch.Tensor
                        ) -> torch.Tensor:
    """IID categorical ancestors (higher variance; a test baseline)."""
    n = log_w.shape[0]
    w = torch.exp(normalize_log_weights(log_w))
    return torch.multinomial(w, n, replacement=True,
                             generator=generator).to(torch.int32)


def resample(generator: torch.Generator, particles: torch.Tensor,
             log_w: torch.Tensor, scheme: str = "systematic"):
    """Resample (n, d) particles to equal weights. Returns (particles,
    idx)."""
    if scheme == "systematic":
        idx = systematic_indices(generator, log_w)
    elif scheme == "multinomial":
        idx = multinomial_indices(generator, log_w)
    else:
        raise ValueError(f"unknown resampling scheme: {scheme!r}")
    return particles[idx], idx
