"""`build_flow` (port of `tpuflows/flows/build.py`): a Standardize fitted
to samples plus a module of couplings.

Kinds: "affine" (affine couplings), "rqs" (spline couplings) and "arqs"
(each layer an affine coupling then a spline coupling on the same mask).
Mask schemes: "alternating" (checkerboards), "mixed" (checkerboard even
and odd, then first-half and second-half blocks, in a cycle of four) and
"leading" (the first `n_leading` dims, alternating with the complement).
"""
from __future__ import annotations

import torch

from tpuflows_torch.flows.affine import AffineCoupling, Standardize
from tpuflows_torch.flows.core import Chain
from tpuflows_torch.flows.coupling import RQSCouplingBlock
from tpuflows_torch.util.device import f32_device
from tpuflows_torch.util.shapes import (alternating_mask, block_mask,
                                        leading_mask)


def _mask_for(mask_scheme: str, dim: int, n_leading: int, i: int):
    if mask_scheme == "alternating":
        return alternating_mask(dim, i % 2)
    if mask_scheme == "mixed":
        kind = i % 4
        if kind < 2:
            return alternating_mask(dim, kind)
        return block_mask(dim, kind - 2)
    if mask_scheme == "leading":
        lead = leading_mask(dim, n_leading)
        return lead if i % 2 == 0 else tuple(1 - m for m in lead)
    raise ValueError(f"unknown mask_scheme: {mask_scheme!r}")


def build_flow(
    samples: torch.Tensor,
    generator: torch.Generator,
    kind: str = "rqs",
    n_blocks: int = 4,
    knots: int = 8,
    hidden: tuple = (64, 64),
    activation: str = "silu",
    use_pallas="auto",
    mask_scheme: str = "alternating",
    clamp: float = 4.0,
    n_leading: int = 1,
    modules=None,
    device="cuda",
) -> Chain:
    """Standardize (fitted on the (N, d) `samples`) + `n_blocks` coupling
    layers of `kind` (forward maps data -> base).

    `generator` draws the He-initialized hidden layers, module by module in
    chain order (for "arqs": affine 0, spline 0, affine 1, ...); the last
    layer of every conditioner starts at zero. `clamp` is the affine
    couplings' log-scale soft clamp; a funnel-style target needs it to
    cover the scale range at the tails of its global scale (bench: 8).

    `modules`: a user-supplied module list. Each item is a ready Bijector,
    used as it is, or a callable `(samples, generator) -> Bijector`; when
    given, the chain is exactly those modules."""
    dev = f32_device(device)
    samples = torch.as_tensor(samples, dtype=torch.float32, device=dev)
    dim = samples.shape[-1]

    if modules is not None:
        return Chain([m if hasattr(m, "forward_and_ladj")
                      else m(samples, generator) for m in modules])

    std = Standardize.from_samples(samples)

    def mask_for(i):
        return _mask_for(mask_scheme, dim, n_leading, i)

    def affine(i):
        return AffineCoupling.init(mask_for(i), generator, hidden=hidden,
                                   activation=activation, clamp=clamp,
                                   device=dev)

    def spline(i):
        return RQSCouplingBlock.init(generator, mask_for(i), knots=knots,
                                     hidden=hidden, activation=activation,
                                     use_pallas=use_pallas, device=dev)

    if kind == "rqs":
        blocks = [spline(i) for i in range(n_blocks)]
    elif kind == "arqs":
        # an affine coupling (unbounded scale: heavy tails, funnel-style
        # dynamic range) then a spline (shape inside its window) per
        # layer, on the same mask
        blocks = [b for i in range(n_blocks) for b in (affine(i), spline(i))]
    elif kind == "affine":
        blocks = [affine(i) for i in range(n_blocks)]
    else:
        raise ValueError(f"unknown flow kind: {kind!r}")
    return Chain([std, *blocks])
