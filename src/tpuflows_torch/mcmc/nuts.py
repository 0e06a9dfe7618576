"""NUTS helpers shared with the fused transition (port of the part of
`tpuflows/mcmc/nuts.py` the kernel path needs).

`make_nuts_kernel`, the portable per-chain NUTS of the JAX package, waits
for a later slice (ROADMAP.md, Queue 1 item 4); the funnel path runs every
transition through `tpuflows_torch.kernels.nuts_cuda`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def _popcount32(x):
    """Set bits of a 32-bit non-negative int (Python int or int tensor)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _trailing_zeros32(x):
    """Trailing zero bits of a positive 32-bit int."""
    return _popcount32((x & -x) - 1)


class NUTSInfo(NamedTuple):
    accept_prob: torch.Tensor  # mean MH-style accept stat over the trajectory
    num_steps: torch.Tensor  # leapfrog steps taken
    tree_depth: torch.Tensor
    diverging: torch.Tensor
    turning: torch.Tensor
    energy: torch.Tensor  # H0 of the transition
    logp: torch.Tensor  # log density at the new position
