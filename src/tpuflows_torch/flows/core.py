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

import copy
from typing import Mapping, Tuple

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


class Identity(Bijector):
    def forward_and_ladj(self, x):
        return x, torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)

    def inverse_and_ladj(self, z):
        return z, torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)


class _Method(nn.Module):
    """Lets `torch.func.functional_call` run one method of a module."""

    def __init__(self, module: nn.Module, method: str):
        super().__init__()
        self.module = module
        self.method = method

    def forward(self, *args):
        return getattr(self.module, self.method)(*args)


def call_with(module: nn.Module, method: str,
              params: Mapping[str, torch.Tensor], *args):
    """`module.<method>(*args)` with the parameters named in `params`
    (names as `module.named_parameters()` gives them) substituted; the
    others are the module's own."""
    return torch.func.functional_call(
        _Method(module, method),
        {"module." + k: v for k, v in params.items()}, args)


def detached(module: nn.Module) -> dict:
    """The module's parameters, detached: with `call_with`, evaluation
    through a stop-gradient copy of the module."""
    return {k: v.detach() for k, v in module.named_parameters()}


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

    def append(self, *modules) -> "Chain":
        """Adaptive growth: a new Chain of this one's modules, then
        `modules`. This Chain keeps its own list; the two share the
        module objects, as the JAX package's share their leaves, so
        training the new Chain in place trains the shared modules too."""
        return Chain([*self.transforms, *modules])

    def __len__(self):
        return len(self.transforms)


class ScannedRepeat(Bijector):
    """N structurally identical blocks with stacked parameters: every
    parameter of `stacked` has a leading axis of length N, block i being
    `stacked` with each parameter's slice i. The blocks run as a loop
    (block 0 first forward, last first inverse); buffers and static
    fields (masks, clamps) are shared by all blocks."""

    def __init__(self, stacked: Bijector):
        super().__init__()
        self.stacked = stacked

    @staticmethod
    def from_blocks(blocks) -> "ScannedRepeat":
        """Stack the parameters of structurally identical blocks."""
        stacked = copy.deepcopy(blocks[0])
        per_block = [dict(b.named_parameters()) for b in blocks]
        with torch.no_grad():
            for name, p in stacked.named_parameters():
                p.data = torch.stack([pb[name].detach() for pb in per_block])
        return ScannedRepeat(stacked)

    def num_blocks(self) -> int:
        return next(self.stacked.parameters()).shape[0]

    def _block(self, i):
        return {k: v[i] for k, v in self.stacked.named_parameters()}

    def _run(self, method, x, order):
        ladj = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for i in order:
            x, l = call_with(self.stacked, method, self._block(i), x)
            ladj = ladj + l
        return x, ladj

    def forward_and_ladj(self, x):
        return self._run("forward_and_ladj", x, range(self.num_blocks()))

    def inverse_and_ladj(self, z):
        return self._run("inverse_and_ladj", z,
                         reversed(range(self.num_blocks())))
