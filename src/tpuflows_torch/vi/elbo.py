"""ELBO and sampling of the flow as a variational family (port of the part
of `tpuflows/vi/elbo.py` the funnel path runs; `fit_vi` waits).

ELBO = E_{z~N(0,I)}[log p(f^-1(z)) + ladj_{f^-1}(z)] + H(N(0, I)).
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from tpuflows_torch.flows.core import Bijector
from tpuflows_torch.util.device import f32_device


def _base_entropy(dim: int) -> float:
    return 0.5 * dim * (1.0 + math.log(2.0 * math.pi))


@torch.no_grad()
def elbo(generator: torch.Generator, flow: Bijector, log_density: Callable,
         dim: int, n: int = 4096, device="cuda") -> torch.Tensor:
    """Monte-Carlo ELBO of the flow family against `log_density` (0-d
    tensor on `device`)."""
    dev = f32_device(device)
    z = torch.randn((n, dim), generator=generator, device=dev)
    x, ladj = flow.inverse_and_ladj(z)
    return torch.mean(log_density(x) + ladj) + _base_entropy(dim)


@torch.no_grad()
def vi_sample(generator: torch.Generator, flow: Bijector, dim: int, n: int,
              device="cuda") -> torch.Tensor:
    """n draws from the variational posterior q = f^-1 # N(0, I)."""
    dev = f32_device(device)
    z = torch.randn((n, dim), generator=generator, device=dev)
    return flow.inverse(z)
