"""Correlated multivariate Gaussian target (port of
`tpuflows/targets/correlated.py`; config 2)."""
from __future__ import annotations

import math

import numpy as np
import torch

from tpuflows_torch.targets.base import Target


class CorrelatedGaussian(Target):
    """N(loc, Sigma) with Sigma = chol chol^T, chol lower triangular;
    `log_density` takes x on loc's device."""

    def __init__(self, loc, chol):
        self.loc = torch.as_tensor(loc, dtype=torch.float32)
        self.chol = torch.as_tensor(chol, dtype=torch.float32,
                                    device=self.loc.device)

    @property
    def dim(self):
        return self.loc.shape[-1]

    def log_density(self, x):
        d = self.dim
        batch_shape = x.shape[:-1]
        diff = (x - self.loc).reshape(-1, d)
        # one triangular solve over the whole batch: L Y = diff^T
        y = torch.linalg.solve_triangular(self.chol, diff.T, upper=False)
        quad = torch.sum(y * y, dim=0).reshape(batch_shape)
        logdet = torch.sum(torch.log(torch.diagonal(self.chol)))
        return -0.5 * quad - logdet - 0.5 * d * math.log(2.0 * math.pi)

    def sample(self, generator, n, device="cuda"):
        eps = torch.randn((n, self.dim), generator=generator,
                          device=generator.device)
        return (self.loc.to(eps.device)
                + eps @ self.chol.to(eps.device).T).to(device)

    def mean(self, device="cuda"):
        return self.loc.to(device)

    def cov(self, device="cuda"):
        return (self.chol @ self.chol.T).to(device)

    @staticmethod
    def ar1(dim: int, rho: float = 0.7, scale: float = 1.0,
            device="cuda") -> "CorrelatedGaussian":
        """AR(1)-correlated Gaussian: Sigma_ij = scale^2 rho^|i-j|, its
        Cholesky factor computed in float64 and stored in float32."""
        idx = np.arange(dim)
        cov = (scale ** 2) * (rho ** np.abs(idx[:, None] - idx[None, :]))
        chol = np.linalg.cholesky(cov.astype(np.float64))
        return CorrelatedGaussian(
            torch.zeros(dim, device=device),
            torch.tensor(chol, dtype=torch.float32, device=device))
