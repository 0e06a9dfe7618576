"""Target-density protocol (port of `tpuflows/targets/base.py`).

A target exposes `log_density` on `(..., d)` batches and, where available,
exact sampling and analytic moments for the moment gates.
"""
from __future__ import annotations

import math

import torch


class Target:
    """Protocol: dim, log_density; optional sample/mean/cov."""

    dim: int

    def log_density(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., d) -> (...) unnormalized log density."""
        raise NotImplementedError

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.log_density(x)

    def sample(self, generator: torch.Generator, n: int, device="cuda"
               ) -> torch.Tensor:
        raise NotImplementedError(
            f"{type(self).__name__} has no exact sampler")

    def mean(self, device="cuda") -> torch.Tensor:
        raise NotImplementedError

    def cov(self, device="cuda") -> torch.Tensor:
        raise NotImplementedError


def logdensityof(target: Target, x: torch.Tensor) -> torch.Tensor:
    return target.log_density(x)


def std_normal_logpdf(x: torch.Tensor) -> torch.Tensor:
    """log N(x; 0, I) summed over the trailing feature axis."""
    d = x.shape[-1]
    return -0.5 * torch.sum(x * x, dim=-1) - 0.5 * d * math.log(2.0 * math.pi)
