"""Banana (Haario twisted Gaussian) and Rosenbrock targets (port of
`tpuflows/targets/banana.py`; config c6: the 2-d banana).

Banana: z ~ N(0, diag(sigma1^2, 1, ..., 1)), twisted as x0 = z0,
x1 = z1 + b (z0^2 - sigma1^2), the rest unchanged. The twist has a unit
Jacobian, so the density, the sampler and the moments are exact.

Rosenbrock: log p = -sum_i [(x_2i - mu)^2 / (2 s1^2)
                           + (x_2i+1 - x_2i^2)^2 / (2 s2^2)] + const
over consecutive pairs: x_even ~ N(mu, s1^2), x_odd | x_even ~
N(x_even^2, s2^2).
"""
from __future__ import annotations

import math

import torch

from tpuflows_torch.targets.base import Target


class Banana(Target):
    def __init__(self, dim: int = 2, b: float = 0.5, sigma1: float = 2.0):
        self.dim = int(dim)
        self.b = float(b)
        self.sigma1 = float(sigma1)

    def _untwist(self, x):
        z1 = x[..., 1] - self.b * (x[..., 0] ** 2 - self.sigma1 ** 2)
        return torch.cat([x[..., :1], z1[..., None], x[..., 2:]], dim=-1)

    def log_density(self, x):
        z = self._untwist(x)  # unit Jacobian
        quad = ((z[..., 0] / self.sigma1) ** 2
                + torch.sum(z[..., 1:] ** 2, dim=-1))
        return (-0.5 * quad - math.log(self.sigma1)
                - 0.5 * self.dim * math.log(2.0 * math.pi))

    def sample(self, generator, n, device="cuda"):
        z = torch.randn((n, self.dim), generator=generator,
                        device=generator.device)
        z0 = z[:, :1] * self.sigma1
        x1 = z[:, 1:2] + self.b * (z0 ** 2 - self.sigma1 ** 2)
        return torch.cat([z0, x1, z[:, 2:]], dim=-1).to(device)

    def mean(self, device="cuda"):
        # E[x1] = E[z1] + b (E[z0^2] - sigma1^2) = 0
        return torch.zeros(self.dim, device=device)

    def cov(self, device="cuda"):
        # Var(x0) = sigma1^2; Var(x1) = 1 + b^2 Var(z0^2) = 1 + 2 b^2 s^4
        var = torch.ones(self.dim, device=device)
        var[0] = self.sigma1 ** 2
        var[1] = 1.0 + 2.0 * self.b ** 2 * self.sigma1 ** 4
        return torch.diag(var)


class Rosenbrock(Target):
    def __init__(self, dim: int = 2, mu: float = 1.0, s1: float = 1.0,
                 s2: float = 0.1):
        self.dim = int(dim)  # even
        self.mu, self.s1, self.s2 = float(mu), float(s1), float(s2)

    def log_density(self, x):
        xe, xo = x[..., 0::2], x[..., 1::2]
        quad = (torch.sum(((xe - self.mu) / self.s1) ** 2, dim=-1)
                + torch.sum(((xo - xe ** 2) / self.s2) ** 2, dim=-1))
        npairs = self.dim // 2
        return (-0.5 * quad
                - npairs * (math.log(self.s1) + math.log(self.s2))
                - 0.5 * self.dim * math.log(2.0 * math.pi))

    def sample(self, generator, n, device="cuda"):
        npairs = self.dim // 2
        gdev = generator.device
        xe = self.mu + self.s1 * torch.randn((n, npairs),
                                             generator=generator,
                                             device=gdev)
        xo = xe ** 2 + self.s2 * torch.randn((n, npairs),
                                             generator=generator,
                                             device=gdev)
        return torch.stack([xe, xo], dim=-1).reshape(n, self.dim).to(device)

    def mean(self, device="cuda"):
        m = torch.zeros(self.dim, device=device)
        m[0::2] = self.mu
        # E[x_odd] = E[x_even^2] = mu^2 + s1^2
        m[1::2] = self.mu ** 2 + self.s1 ** 2
        return m
