"""Coupling-mask helpers (port of `tpuflows/util/shapes.py`, the part the
affine path needs).

A mask is a hashable tuple of 0/1 ints: 1 = pass-through dim (conditioner
input), 0 = transformed dim.
"""
from __future__ import annotations

import torch


def leading_mask(dim: int, n_leading: int = 1) -> tuple[int, ...]:
    """Pass the first `n_leading` dims through and transform the rest (the
    `mask_scheme="leading"` mask of `tpuflows/flows/build.py`)."""
    return tuple(1 if j < n_leading else 0 for j in range(dim))


def mask_array(mask: tuple[int, ...], dtype=torch.float32,
               device=None) -> torch.Tensor:
    return torch.tensor(mask, dtype=dtype, device=device)
