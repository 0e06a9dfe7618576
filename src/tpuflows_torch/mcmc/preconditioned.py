"""Flow-preconditioned targets: MCMC in the flow's latent space (port of
`tpuflows/mcmc/preconditioned.py`).

    logp~(z) = logp(f^-1(z)) + log|det d f^-1 / dz|

`to_data_space` and `to_latent_space` map draws between the two spaces.
"""
from __future__ import annotations

from typing import Callable

import torch

from tpuflows_torch.flows.core import Bijector


def flow_reparameterized(log_density: Callable, flow: Bijector) -> Callable:
    """Latent-space log density logp~(z) on (..., d) tensors."""

    def logp_tilde(z):
        x, ladj = flow.inverse_and_ladj(z)
        return log_density(x) + ladj

    return logp_tilde


# rows per inverse call: keeps the conditioner's activations to ~128 MB at
# hidden width 128 when mapping whole windows of draws
_CHUNK = 1 << 18


@torch.no_grad()
def to_data_space(flow: Bijector, z_samples: torch.Tensor) -> torch.Tensor:
    """x = f^-1(z) for (..., d) latent draws, in chunks of rows."""
    flat = z_samples.reshape(-1, z_samples.shape[-1])
    out = torch.cat([flow.inverse(flat[lo:lo + _CHUNK])
                     for lo in range(0, flat.shape[0], _CHUNK)])
    return out.reshape(z_samples.shape)


def to_latent_space(flow: Bijector, x_samples: torch.Tensor) -> torch.Tensor:
    """z = f(x) for (..., d) data-space points: latent start points for a
    sampler that runs in the flow's latent space."""
    return flow.forward(x_samples)
