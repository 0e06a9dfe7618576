"""Neal's funnel (port of `tpuflows/targets/funnel.py`; config 4: 64-d).

v = x[0] ~ N(0, sigma_v^2);  x[1:] | v ~ N(0, exp(v) I).
"""
from __future__ import annotations

import math

import torch

from tpuflows_torch.targets.base import Target


class NealsFunnel(Target):
    def __init__(self, dim: int = 64, sigma_v: float = 3.0):
        self.dim = int(dim)
        self.sigma_v = float(sigma_v)

    def log_density(self, x):
        v = x[..., 0]
        rest = x[..., 1:]
        k = self.dim - 1
        lp_v = (-0.5 * (v / self.sigma_v) ** 2 - math.log(self.sigma_v)
                - 0.5 * math.log(2.0 * math.pi))
        # x_i | v ~ N(0, exp(v)) => var = exp(v), log std = v/2
        lp_rest = (-0.5 * torch.sum(rest * rest, dim=-1) * torch.exp(-v)
                   - 0.5 * k * v - 0.5 * k * math.log(2.0 * math.pi))
        return lp_v + lp_rest

    def sample(self, generator, n, device="cuda"):
        g_dev = generator.device
        v = self.sigma_v * torch.randn(n, generator=generator, device=g_dev)
        rest = torch.exp(v / 2.0)[:, None] * torch.randn(
            (n, self.dim - 1), generator=generator, device=g_dev)
        return torch.cat([v[:, None], rest], dim=-1).to(device)

    def mean(self, device="cuda"):
        return torch.zeros(self.dim, device=device)

    def cov(self, device="cuda"):
        # Var(v) = sigma_v^2; Var(x_i) = E[exp(v)] = exp(sigma_v^2 / 2)
        var = torch.full((self.dim,), math.exp(self.sigma_v ** 2 / 2.0),
                         device=device)
        var[0] = self.sigma_v ** 2
        return torch.diag(var)
