"""Coupling-mask helpers (port of the mask helpers of
`tpuflows/util/shapes.py`).

A mask is a hashable tuple of 0/1 ints: 1 = pass-through dim (conditioner
input), 0 = transformed dim.
"""
from __future__ import annotations

import torch


def leading_mask(dim: int, n_leading: int = 1) -> tuple[int, ...]:
    """Pass the first `n_leading` dims through and transform the rest (the
    `mask_scheme="leading"` mask of `tpuflows/flows/build.py`)."""
    return tuple(1 if j < n_leading else 0 for j in range(dim))


def alternating_mask(dim: int, parity: int) -> tuple[int, ...]:
    """Checkerboard coupling mask: dim i passes through when
    (i + parity) is even."""
    return tuple(1 if (i + parity) % 2 == 0 else 0 for i in range(dim))


def block_mask(dim: int, parity: int) -> tuple[int, ...]:
    """First-half/second-half split mask: parity 0 passes the first half,
    parity 1 the second."""
    half = dim // 2
    if parity % 2 == 0:
        return tuple(1 if i < half else 0 for i in range(dim))
    return tuple(0 if i < half else 1 for i in range(dim))


def mask_array(mask: tuple[int, ...], dtype=torch.float32,
               device=None) -> torch.Tensor:
    return torch.tensor(mask, dtype=dtype, device=device)
