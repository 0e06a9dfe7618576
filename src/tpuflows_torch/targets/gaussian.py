"""Standard and diagonal Gaussian targets (port of
`tpuflows/targets/gaussian.py`; config 1)."""
from __future__ import annotations

import math

import torch

from tpuflows_torch.targets.base import Target


class StandardNormal(Target):
    def __init__(self, dim: int):
        self.dim = int(dim)

    def log_density(self, x):
        return (-0.5 * torch.sum(x * x, dim=-1)
                - 0.5 * self.dim * math.log(2.0 * math.pi))

    def sample(self, generator, n, device="cuda"):
        return torch.randn((n, self.dim), generator=generator,
                           device=generator.device).to(device)

    def mean(self, device="cuda"):
        return torch.zeros(self.dim, device=device)

    def cov(self, device="cuda"):
        return torch.eye(self.dim, device=device)


class DiagNormal(Target):
    """N(loc, diag(scale^2)); `log_density` takes x on loc's device."""

    def __init__(self, loc, scale):
        self.loc = torch.as_tensor(loc, dtype=torch.float32)
        self.scale = torch.as_tensor(scale, dtype=torch.float32,
                                     device=self.loc.device)

    @property
    def dim(self):
        return self.loc.shape[-1]

    def log_density(self, x):
        z = (x - self.loc) / self.scale
        return (-0.5 * torch.sum(z * z, dim=-1)
                - torch.sum(torch.log(self.scale))
                - 0.5 * self.dim * math.log(2.0 * math.pi))

    def sample(self, generator, n, device="cuda"):
        eps = torch.randn((n, self.dim), generator=generator,
                          device=generator.device)
        return (self.loc.to(eps.device)
                + self.scale.to(eps.device) * eps).to(device)

    def mean(self, device="cuda"):
        return self.loc.to(device)

    def cov(self, device="cuda"):
        return torch.diag(self.scale ** 2).to(device)
