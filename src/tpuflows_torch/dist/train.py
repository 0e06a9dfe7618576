"""Data-parallel flow training over the worker mesh (port of
`tpuflows/dist/train.py`).

Each rank trains on its own rows, and every step averages the gradients
and the loss over the mesh before the replicated Adam update: the inner
loop is `flows.train.optimize_flow` with `mesh` set, so the algorithm does
not change with the world size, only the rows each rank holds.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from tpuflows_torch.dist.collectives import all_gather, fold_in_axis_index
from tpuflows_torch.dist.mesh import replicate
from tpuflows_torch.flows.core import Bijector
from tpuflows_torch.flows.train import (Adam, TrainResult, negll_flow_loss,
                                        optimize_flow)


def optimize_flow_dp(
    generator: torch.Generator,
    samples_local: torch.Tensor,
    flow: Bijector,
    mesh,
    optimizer: Optional[Adam] = None,
    loss: Callable = negll_flow_loss,
    nbatches: int = 10,
    nepochs: int = 100,
) -> TrainResult:
    """`optimize_flow` with the (N, d) sample matrix row-sharded over
    `mesh`: `samples_local` is this rank's block, and `flow` (trained in
    place) starts from rank 0's parameters. The global N must divide by
    the world size, in equal blocks. Each rank shuffles its rows from
    `generator` folded by its rank; the gradients and losses are averaged
    every step, so the parameters stay equal to the bit on every rank.
    Returns the trained flow, no optimizer state and the averaged loss
    history."""
    if optimizer is None:
        optimizer = Adam(1e-3)
    counts = all_gather(torch.tensor([samples_local.shape[0]],
                                     device=mesh.device), mesh).tolist()
    n = sum(counts)
    if n % mesh.size != 0:
        raise ValueError(f"{n} samples not divisible by {mesh.size} devices")
    if len(set(counts)) > 1:
        raise ValueError(f"the ranks hold {counts} samples, not equal "
                         f"blocks")
    replicate(flow, mesh)
    res = optimize_flow(fold_in_axis_index(generator, mesh), samples_local,
                        flow, optimizer, loss=loss, nbatches=nbatches,
                        nepochs=nepochs, mesh=mesh)
    return TrainResult(result=res.result, optimizer_state=None,
                       loss_hist=res.loss_hist)
