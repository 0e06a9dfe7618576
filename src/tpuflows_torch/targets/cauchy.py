"""Multimodal Cauchy target (port of `tpuflows/targets/cauchy.py`, after
BATTestCases.jl's `MultimodalCauchy`): symmetric Cauchy peaks at +-mu in
the first two dimensions, independent zero-centred Cauchy in the rest.
Its heavy tails have no moments, so it is judged on quantiles.
"""
from __future__ import annotations

import math

import torch

from tpuflows_torch.targets.base import Target


def _log_cauchy(x, loc, scale):
    z = (x - loc) / scale
    return -torch.log1p(z * z) - math.log(math.pi * scale)


class MultimodalCauchy(Target):
    def __init__(self, dim: int = 4, mu: float = 1.0, sigma: float = 0.2):
        self.dim, self.mu, self.sigma = int(dim), mu, sigma

    def log_density(self, x):
        # dims 0, 1: 1/2 Cauchy(-mu, sigma) + 1/2 Cauchy(+mu, sigma)
        bimodal = torch.logaddexp(
            _log_cauchy(x[..., :2], -self.mu, self.sigma),
            _log_cauchy(x[..., :2], self.mu, self.sigma),
        ) - math.log(2.0)
        rest = _log_cauchy(x[..., 2:], 0.0, self.sigma)
        return torch.sum(bimodal, dim=-1) + torch.sum(rest, dim=-1)

    def sample_math(self, c, heads):
        """Draws from standard Cauchy draws c (n, d) and the first two
        dimensions' mode choices `heads` (n, 2) bool (True: +mu)."""
        signs = torch.where(heads, self.mu, -self.mu)
        locs = torch.cat([signs, torch.zeros((c.shape[0], self.dim - 2),
                                             device=c.device)], dim=-1)
        return self.sigma * c + locs

    def sample(self, generator, n, device="cuda"):
        gdev = generator.device
        u = torch.rand((n, self.dim), generator=generator, device=gdev)
        c = torch.tan(math.pi * (u - 0.5))  # the Cauchy inverse CDF
        heads = torch.rand((n, 2), generator=generator, device=gdev) < 0.5
        return self.sample_math(c, heads).to(device)

    def quantiles(self, qs, device="cuda"):
        """Analytic quantiles of dims >= 2, loc + scale tan(pi (q - 1/2));
        dims 0 and 1 are symmetric mixtures with median 0."""
        qs = torch.as_tensor(qs, dtype=torch.float32, device=device)
        return self.sigma * torch.tan(math.pi * (qs - 0.5))
