"""Mesh-optional collectives (port of `tpuflows/dist/collectives.py`).

Every helper takes `mesh=None`, the JAX package's `axis_name=None`: then it
is the identity or the local math, with the same operations as the
unsharded code it replaces. With a `WorkerMesh` (`dist/mesh.py`) it runs a
`torch.distributed` collective over the mesh's process group on a copy of
its input, so the samplers, the trainer and the SMC stage compute the same
algorithm at any world size.

Each rank holds only its own block of a row-sharded tensor (JAX's global
array is the concatenation of the blocks in rank order), so the helpers
below that the JAX package gets from `shard_map` — `all_gather`,
`broadcast`, the ring's point-to-point exchange (`dist/resample.py`) — are
written out here too. `COUNTS` counts the collectives each helper issues,
by kind, for the record of a run (`reset_counts`, `collective_count`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

COUNTS = {"all_reduce": 0, "all_gather": 0, "broadcast": 0, "send_recv": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def collective_count() -> int:
    """Collectives issued since the last `reset_counts`."""
    return sum(COUNTS.values())


def _all_reduce(x: torch.Tensor, mesh, op) -> torch.Tensor:
    mesh.check(x)
    y = torch.clone(x.detach(), memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=mesh.group)
    COUNTS["all_reduce"] += 1
    return y


def psum(x: torch.Tensor, mesh) -> torch.Tensor:
    return x if mesh is None else _all_reduce(x, mesh, dist.ReduceOp.SUM)


def pmean(x: torch.Tensor, mesh) -> torch.Tensor:
    """`jax.lax.pmean`: the sum over the mesh over its size."""
    return x if mesh is None else psum(x, mesh) / mesh.size


def pmax(x: torch.Tensor, mesh) -> torch.Tensor:
    return x if mesh is None else _all_reduce(x, mesh, dist.ReduceOp.MAX)


def axis_size(mesh) -> int:
    return 1 if mesh is None else mesh.size


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """The blocks of every rank, concatenated along axis 0 in rank order
    (each rank's block must have the same shape)."""
    if mesh is None:
        return x
    mesh.check(x)
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    COUNTS["all_gather"] += 1
    return torch.cat(parts)


def broadcast(x: torch.Tensor, mesh, src: int = 0) -> torch.Tensor:
    """Rank `src`'s value of the contiguous tensor `x`, written into `x` on
    every rank."""
    if mesh is not None:
        mesh.check(x)
        dist.broadcast(x, src=src, group=mesh.group)
        COUNTS["broadcast"] += 1
    return x


def fold_in_axis_index(generator: torch.Generator, mesh) -> torch.Generator:
    """This rank's own random stream (`jax.random.fold_in(key,
    axis_index)`): a new generator on `generator`'s device, seeded from one
    draw of `generator` (the same draw on every rank, whose generators are
    in the same state) and the rank. The identity without a mesh."""
    if mesh is None:
        return generator
    draw = int(torch.randint(0, 1 << 62, (1,), generator=generator,
                             device=generator.device))
    seed = np.random.SeedSequence([draw, mesh.rank]).generate_state(
        1, dtype=np.uint64)[0]
    return torch.Generator(device=generator.device).manual_seed(
        int(seed) >> 2)


def logsumexp_g(v: torch.Tensor, mesh) -> torch.Tensor:
    """The global logsumexp of a row-sharded vector ((n_local,) here)."""
    m = pmax(torch.max(v), mesh)
    return m + torch.log(psum(torch.sum(torch.exp(v - m)), mesh))


def kish_ess_g(log_w: torch.Tensor, mesh) -> torch.Tensor:
    """The global Kish ESS (sum w)^2 / sum w^2 of row-sharded log weights;
    the two sums reduced in one `all_reduce` of a 2-vector (each element
    sums in the order the separate reductions would)."""
    m = pmax(torch.max(log_w), mesh)
    w = torch.exp(log_w - m)
    if mesh is None:
        s1, s2 = torch.sum(w), torch.sum(w * w)
    else:
        s1, s2 = psum(torch.stack([torch.sum(w), torch.sum(w * w)]), mesh)
    return s1 * s1 / s2
