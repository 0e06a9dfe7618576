"""Sharded-chain NUTS over the worker mesh (port of `tpuflows/dist/chains.py`).

The chain axis is row-sharded over the ranks; each rank runs `run_nuts` on
its block with `mesh` set, so the warmup's step size and metric are pooled
over every chain of every rank and the random streams are decorrelated by
folding the rank into the generator. A `transition=` (K1) runs per chain
and is passed through unchanged: only the driver's pooled statistics cross
ranks.
"""
from __future__ import annotations

from typing import Callable

import torch

from tpuflows_torch.dist.collectives import all_gather
from tpuflows_torch.mcmc.sample import MCMCResult, run_nuts


def run_nuts_sharded(generator: torch.Generator, log_density: Callable,
                     init_positions_local: torch.Tensor, mesh,
                     **nuts_kwargs) -> MCMCResult:
    """`run_nuts` with the chain axis sharded over `mesh`:
    `init_positions_local` is this rank's (n_local, d) block, and the global
    chain count must divide by the world size, in equal blocks. Returns
    this rank's `MCMCResult`: samples (num_samples, n_local, d), and the
    step size and metric, equal on every rank."""
    counts = all_gather(torch.tensor([init_positions_local.shape[0]],
                                     device=mesh.device), mesh).tolist()
    n_chains = sum(counts)
    if n_chains % mesh.size != 0:
        raise ValueError(f"{n_chains} chains not divisible by {mesh.size} "
                         f"devices")
    if len(set(counts)) > 1:
        raise ValueError(f"the ranks hold {counts} chains, not equal blocks")
    return run_nuts(generator, log_density, init_positions_local, mesh=mesh,
                    **nuts_kwargs)
