"""Gaussian-mixture targets (port of `tpuflows/targets/mixture.py`;
configs c3 and c7: the bimodal mixture)."""
from __future__ import annotations

import math

import torch

from tpuflows_torch.targets.base import Target


class GaussianMixture(Target):
    """sum_k w_k N(mu_k, diag(sigma_k^2)), the log density through
    `torch.logsumexp`; `log_density` takes x on the parameters' device.

    means (K, d), scales (K, d), log_weights (K,) normalized."""

    def __init__(self, means, scales, log_weights):
        self.means = torch.as_tensor(means, dtype=torch.float32)
        dev = self.means.device
        self.scales = torch.as_tensor(scales, dtype=torch.float32,
                                      device=dev)
        self.log_weights = torch.as_tensor(log_weights, dtype=torch.float32,
                                           device=dev)

    @property
    def dim(self):
        return self.means.shape[-1]

    def log_density(self, x):
        d = self.dim
        z = (x[..., None, :] - self.means) / self.scales  # (..., K, d)
        comp = (-0.5 * torch.sum(z * z, dim=-1)
                - torch.sum(torch.log(self.scales), dim=-1)
                - 0.5 * d * math.log(2.0 * math.pi))  # (..., K)
        return torch.logsumexp(comp + self.log_weights, dim=-1)

    def sample(self, generator, n, device="cuda"):
        """A component per draw from the weights, then its normal."""
        gdev = generator.device
        comp = torch.multinomial(torch.exp(self.log_weights).to(gdev), n,
                                 replacement=True, generator=generator)
        eps = torch.randn((n, self.dim), generator=generator, device=gdev)
        x = (self.means.to(gdev)[comp] + self.scales.to(gdev)[comp] * eps)
        return x.to(device)

    def mean(self, device="cuda"):
        w = torch.exp(self.log_weights)[:, None]
        return torch.sum(w * self.means, dim=0).to(device)

    def cov(self, device="cuda"):
        w = torch.exp(self.log_weights)
        mu = torch.sum(w[:, None] * self.means, dim=0)
        within = torch.einsum("k,kd->d", w, self.scales ** 2)
        centered = self.means - mu
        between = torch.einsum("k,kd,ke->de", w, centered, centered)
        return (torch.diag(within) + between).to(device)

    @staticmethod
    def bimodal(dim: int, separation: float = 4.0, scale: float = 1.0,
                device="cuda") -> "GaussianMixture":
        """Two equal-weight modes at -/+ separation/2 on the first
        coordinate, every scale `scale` (configs c3 and c7)."""
        mu = torch.zeros((2, dim), dtype=torch.float32, device=device)
        mu[0, 0] = -separation / 2.0
        mu[1, 0] = separation / 2.0
        scales = torch.full((2, dim), scale, dtype=torch.float32,
                            device=device)
        logw = torch.log(torch.tensor([0.5, 0.5], dtype=torch.float32,
                                      device=device))
        return GaussianMixture(mu, scales, logw)
