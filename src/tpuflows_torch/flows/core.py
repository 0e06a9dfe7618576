"""Bijector protocol and flow composition (port of `tpuflows/flows/core.py`).

Conventions:
  - `forward` maps DATA -> BASE (x -> z), `inverse` maps BASE -> DATA;
  - tensors are `(..., d)`;
  - `forward_and_ladj` returns log|det dz/dx| and `inverse_and_ladj`
    log|det dx/dz|, summed over the feature axis (shape = batch shape).

A bijector is an `nn.Module`: its tensors are `nn.Parameter`s (trainable)
or buffers (masks). Calling it applies `forward`, as in the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


class Bijector(nn.Module):
    """Protocol: implement `forward_and_ladj` and `inverse_and_ladj`."""

    def forward_and_ladj(self, x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def inverse_and_ladj(self, z: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_and_ladj(x)[0]

    def inverse(self, z: torch.Tensor) -> torch.Tensor:
        return self.inverse_and_ladj(z)[0]


class Inverted(Bijector):
    """`inverse(f)` as a first-class object."""

    def __init__(self, inner: Bijector):
        super().__init__()
        self.inner = inner

    def forward_and_ladj(self, x):
        return self.inner.inverse_and_ladj(x)

    def inverse_and_ladj(self, z):
        return self.inner.forward_and_ladj(z)


def inverse(b: Bijector) -> Bijector:
    if isinstance(b, Inverted):
        return b.inner
    return Inverted(b)


def with_logabsdet_jacobian(b: Bijector, x: torch.Tensor):
    return b.forward_and_ladj(x)


class Chain(Bijector):
    """Composition of bijectors; ladj accumulates. `inverse_and_ladj` runs
    the transforms in reverse order."""

    def __init__(self, transforms):
        super().__init__()
        self.transforms = nn.ModuleList(transforms)

    def forward_and_ladj(self, x):
        ladj = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for t in self.transforms:
            x, l = t.forward_and_ladj(x)
            ladj = ladj + l
        return x, ladj

    def inverse_and_ladj(self, z):
        ladj = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
        for t in reversed(self.transforms):
            z, l = t.inverse_and_ladj(z)
            ladj = ladj + l
        return z, ladj

    def __len__(self):
        return len(self.transforms)
