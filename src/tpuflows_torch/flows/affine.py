"""Input standardization, whitening and affine coupling (port of
`tpuflows/flows/affine.py`).

Couplings use the dense-mask formulation of the JAX package: the
conditioner sees `x * mask` at full width d and emits (shift, raw
log-scale) for all d dims; the transform applies where mask == 0.
"""
from __future__ import annotations

import torch
from torch import nn

from tpuflows_torch.flows.core import Bijector
from tpuflows_torch.flows.nets import MLP
from tpuflows_torch.util.shapes import mask_array


class Standardize(Bijector):
    """z = (x - loc) / scale with scale = exp(log_scale).

    forward ladj = -sum(log_scale), constant in x."""

    def __init__(self, loc, log_scale):
        super().__init__()
        self.loc = nn.Parameter(torch.as_tensor(loc, dtype=torch.float32))
        self.log_scale = nn.Parameter(
            torch.as_tensor(log_scale, dtype=torch.float32))

    def forward_and_ladj(self, x):
        z = (x - self.loc) * torch.exp(-self.log_scale)
        ladj = (-torch.sum(self.log_scale)).expand(x.shape[:-1])
        return z, ladj

    def inverse_and_ladj(self, z):
        x = z * torch.exp(self.log_scale) + self.loc
        ladj = torch.sum(self.log_scale).expand(z.shape[:-1])
        return x, ladj

    @staticmethod
    def from_samples(samples: torch.Tensor, eps: float = 1e-6
                     ) -> "Standardize":
        """Fit from an (N, d) sample matrix: mean and (biased) std."""
        loc = torch.mean(samples, dim=0)
        std = torch.std(samples, dim=0, correction=0)
        return Standardize(loc, torch.log(std + eps))

    @staticmethod
    def identity(dim: int, device=None) -> "Standardize":
        return Standardize(torch.zeros(dim, device=device),
                           torch.zeros(dim, device=device))


class Whiten(Bijector):
    """Full-covariance whitening: z = L^-1 (x - loc), Sigma = L L^T.

    Both L and L^-1 are stored (computed once at fit time), so each
    direction is one dense matmul. The ladj is constant in x: forward
    ladj = sum(log diag L^-1), broadcast over the batch."""

    def __init__(self, loc, inv_chol, chol):
        super().__init__()
        self.loc = nn.Parameter(torch.as_tensor(loc, dtype=torch.float32))
        self.inv_chol = nn.Parameter(
            torch.as_tensor(inv_chol, dtype=torch.float32))
        self.chol = nn.Parameter(torch.as_tensor(chol, dtype=torch.float32))

    def forward_and_ladj(self, x):
        z = (x - self.loc) @ self.inv_chol.T
        ladj = torch.sum(torch.log(torch.diagonal(self.inv_chol)))
        return z, ladj.expand(x.shape[:-1])

    def inverse_and_ladj(self, z):
        x = z @ self.chol.T + self.loc
        ladj = torch.sum(torch.log(torch.diagonal(self.chol)))
        return x, ladj.expand(z.shape[:-1])

    @staticmethod
    def from_samples(samples: torch.Tensor, jitter: float = 1e-5
                     ) -> "Whiten":
        """Fit from an (N, d) sample matrix: the (biased) covariance plus
        `jitter` on the diagonal, its Cholesky factor and that factor's
        inverse by a triangular solve."""
        loc = torch.mean(samples, dim=0)
        xc = samples - loc
        cov = xc.T @ xc / samples.shape[0]
        eye = torch.eye(cov.shape[0], dtype=cov.dtype, device=cov.device)
        chol = torch.linalg.cholesky(cov + jitter * eye)
        inv_chol = torch.linalg.solve_triangular(chol, eye, upper=False)
        return Whiten(loc, inv_chol, chol)


class AffineCoupling(Bijector):
    """RealNVP-style affine coupling block.

    mask[i] == 1: pass-through dim; 0: transformed dim. The log-scale is
    soft-clamped to (-clamp, clamp) through tanh.
    forward (data -> base): z_t = x_t * exp(s) + shift on transformed dims.
    """

    def __init__(self, mask: tuple, net: MLP, clamp: float = 4.0):
        super().__init__()
        self.mask = tuple(int(m) for m in mask)
        self.net = net
        self.clamp = float(clamp)
        device = net.weights[0].device
        self.register_buffer("mask_f", mask_array(self.mask, device=device),
                             persistent=False)

    def _params(self, masked_input):
        h = self.net(masked_input)
        shift, raw = torch.chunk(h, 2, dim=-1)
        s = self.clamp * torch.tanh(raw / self.clamp)
        return shift, s

    def forward_and_ladj(self, x):
        b = self.mask_f
        shift, s = self._params(x * b)
        z = b * x + (1.0 - b) * (x * torch.exp(s) + shift)
        ladj = torch.sum((1.0 - b) * s, dim=-1)
        return z, ladj

    def inverse_and_ladj(self, z):
        b = self.mask_f
        shift, s = self._params(z * b)  # pass dims are unchanged
        x = b * z + (1.0 - b) * ((z - shift) * torch.exp(-s))
        ladj = -torch.sum((1.0 - b) * s, dim=-1)
        return x, ladj

    @staticmethod
    def init(mask: tuple, generator: torch.Generator,
             hidden: tuple = (64, 64), activation: str = "silu",
             clamp: float = 4.0, device=None) -> "AffineCoupling":
        d = len(mask)
        net = MLP.init((d, *hidden, 2 * d), generator,
                       activation=activation, device=device)
        return AffineCoupling(mask, net, clamp=clamp)
