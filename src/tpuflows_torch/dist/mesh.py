"""The worker mesh and the runtime's initialization (port of
`tpuflows/dist/mesh.py`).

The JAX package runs one controller over a 1-D device mesh whose axis is
`WORKERS`, and `shard_map` runs a per-shard body over a global row-sharded
array. `torch.distributed` runs one process a rank instead, and each rank
holds only its own block: the global array is the concatenation of the
ranks' blocks in rank order. A `WorkerMesh` stands for the JAX package's
`axis_name`: the process group, its size, this process's rank and the
device its tensors live on. Every function of the port that takes
`mesh=None` keeps the one-process code path when it is None.

The backend follows the device: NCCL for CUDA tensors, gloo only for CPU
ones. Neither is swapped for the other, and nothing falls back to one
process: a failure of the setup or of a collective raises.

  - `init_distributed()` joins the world `torchrun` describes (RANK,
    WORLD_SIZE, MASTER_ADDR / MASTER_PORT, LOCAL_RANK) or the one its
    arguments describe, and does nothing without either;
  - `worker_mesh(device=)` spans the initialized world, or, where none is,
    forms a world of one over an in-process `HashStore`, so a single
    process runs the sharded code paths through real collectives;
  - `row_block` and `replicate` stand for `row_sharded` and `replicated`.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from tpuflows_torch.dist.collectives import broadcast

WORKERS = "workers"


def _backend(device: torch.device) -> str:
    if device.type == "cuda":
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device {device}")


class WorkerMesh:
    """A process group over which the particle, chain and sample axes are
    row-sharded: `size` ranks, this process's `rank`, the `device` of its
    tensors and the `backend` that serves them. `axis_name` is `WORKERS`,
    the JAX mesh's axis, for the reader."""

    axis_name = WORKERS

    def __init__(self, group, device):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if _backend(device) != self.backend:
            raise ValueError(f"device {device} needs {_backend(device)}; "
                             f"the world runs {self.backend}")
        self.device = device

    def check(self, x: torch.Tensor) -> None:
        """Raise ValueError unless `x` lives on the mesh's device."""
        d = x.device
        if d.type != self.device.type or (
                d.type == "cuda" and d.index != self.device.index):
            raise ValueError(f"a tensor on {d} given to a mesh on "
                             f"{self.device}")

    def __repr__(self):
        return (f"WorkerMesh(size={self.size}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Join a multi-process world (a no-op with neither arguments nor
    torchrun's RANK and WORLD_SIZE, or when a world is already joined).

    `backend` defaults to NCCL, whose rank takes the CUDA device LOCAL_RANK
    (else `rank`) modulo the devices present; pass "gloo" for a world of
    CPU processes."""
    explicit = init_method is not None
    auto = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if dist.is_initialized() or not (explicit or auto):
        return
    backend = backend or "nccl"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method if explicit else "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)


def worker_mesh(n: Optional[int] = None, device="cuda") -> WorkerMesh:
    """The mesh over the whole initialized world (`n`, if given, must be
    its size), its tensors on `device`; without a world, a world of one
    over an in-process `HashStore`, with the device's backend."""
    device = torch.device(device)
    backend = _backend(device)
    if not dist.is_initialized():
        if n not in (None, 1):
            raise ValueError(f"a mesh of {n} needs init_distributed() "
                             f"first (torchrun, or explicit arguments)")
        if device.type == "cuda" and device.index is not None:
            torch.cuda.set_device(device)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    elif n is not None and n != dist.get_world_size():
        raise ValueError(f"the world has {dist.get_world_size()} ranks, "
                         f"not {n}")
    return WorkerMesh(dist.group.WORLD, device)


def row_block(x: torch.Tensor, mesh: WorkerMesh) -> torch.Tensor:
    """This rank's equal block of the rows of a global tensor."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows not divisible by {mesh.size} ranks")
    b = n // mesh.size
    return x[mesh.rank * b:(mesh.rank + 1) * b]


@torch.no_grad()
def replicate(obj, mesh: WorkerMesh):
    """Rank 0's values on every rank: a tensor (contiguous, written in
    place) or a module's parameters and buffers (one broadcast per dtype).
    Returns `obj`."""
    if isinstance(obj, torch.Tensor):
        return broadcast(obj, mesh)
    if not isinstance(obj, nn.Module):
        raise TypeError(f"replicate takes a tensor or a module, not "
                        f"{type(obj).__name__}")
    by_dtype = {}
    for t in (*obj.parameters(), *obj.buffers()):
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = broadcast(torch.cat([t.reshape(-1) for t in ts]), mesh)
        for t, v in zip(ts, torch.split(flat, [t.numel() for t in ts])):
            t.copy_(v.view_as(t))
    return obj
