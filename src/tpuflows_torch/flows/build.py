"""`build_flow` (port of `tpuflows/flows/build.py`, the affine kind with
leading masks — the flow of `bench.py`'s `ceiling` variant).

The JAX package also builds `rqs` and `arqs` spline flows and the
`alternating` / `mixed` mask schemes; those wait for the spline slice
(ROADMAP.md, Queue 1 item 7) and raise `NotImplementedError` here.
"""
from __future__ import annotations

import torch

from tpuflows_torch.flows.affine import AffineCoupling, Standardize
from tpuflows_torch.flows.core import Chain
from tpuflows_torch.util.device import f32_device
from tpuflows_torch.util.shapes import leading_mask

_SPLINE_SLICE = ("waits for the spline slice of the port "
                 "(ROADMAP.md, Queue 1 item 7)")


def build_flow(
    samples: torch.Tensor,
    generator: torch.Generator,
    kind: str = "affine",
    n_blocks: int = 1,
    hidden: tuple = (64, 64),
    activation: str = "silu",
    mask_scheme: str = "leading",
    clamp: float = 4.0,
    n_leading: int = 1,
    device="cuda",
) -> Chain:
    """Standardize (fitted on the (N, d) `samples`) + `n_blocks` affine
    couplings. Leading masks pass the first `n_leading` dims and transform
    the rest, alternating with the complement block by block; one such
    block with a wide `clamp` holds the funnel's exact transport.

    `generator` draws the He-initialized hidden layers; the last layer of
    every conditioner starts at zero (identity map)."""
    if kind != "affine":
        raise NotImplementedError(f"flow kind {kind!r} {_SPLINE_SLICE}")
    if mask_scheme != "leading":
        raise NotImplementedError(
            f"mask_scheme {mask_scheme!r} {_SPLINE_SLICE}")
    dev = f32_device(device)
    samples = torch.as_tensor(samples, dtype=torch.float32, device=dev)
    dim = samples.shape[-1]
    std = Standardize.from_samples(samples)
    lead = leading_mask(dim, n_leading)
    blocks = []
    for i in range(n_blocks):
        mask = lead if i % 2 == 0 else tuple(1 - m for m in lead)
        blocks.append(AffineCoupling.init(
            mask, generator, hidden=hidden, activation=activation,
            clamp=clamp, device=dev))
    return Chain([std, *blocks])
