"""Systematic resampling of row-sharded particles (port of
`tpuflows/dist/resample.py`).

Every rank runs the same steps:
  1. the ranks' log weights are gathered (n floats: 256 KB at c5's
     65,536 particles) and each rank builds the global CDF from them with
     `systematic_indices_math`, the unsharded resampler's own arithmetic,
     from the one uniform `u0` every rank holds: the ancestors are those
     of the unsharded stage, on every rank and at every world size. The
     JAX package gathers max-normalized weights instead; gathering the
     log weights keeps the CDF bit for bit the one-process one;
  2. each rank keeps the ancestors of its own output slots, global row
     indices;
  3. it fetches those rows either with one `all_gather` of every rank's
     block and a local take (`gather_particles=True`: n x d floats a rank)
     or with the bidirectional ring exchange (`sharded_take_exchange`):
     O(n_local x d) memory, and under the balanced weights an ESS-triggered
     resample sees, one hop of traffic. A world of one never enters the
     ring.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from tpuflows_torch.dist.collectives import COUNTS, all_gather, pmax
from tpuflows_torch.smc.resample import systematic_indices_math


def sharded_ancestors(u0, log_w: torch.Tensor, mesh,
                      n_out: int | None = None) -> torch.Tensor:
    """The global systematic ancestors of this rank's output slots: (n_out
    / size,) int32 indices into the global rows, n_out defaulting to the
    global row count. `log_w` (n_local,); `u0` (0-d) the same on every
    rank."""
    lw_all = all_gather(log_w, mesh)
    m = lw_all.shape[0] if n_out is None else n_out
    if m % mesh.size:
        raise ValueError(f"{m} output slots not divisible by {mesh.size} "
                         f"ranks")
    blk = m // mesh.size
    idx = systematic_indices_math(u0, lw_all, n_out=m)
    return idx[mesh.rank * blk:(mesh.rank + 1) * blk]


def sharded_take(arr: torch.Tensor, anc: torch.Tensor,
                 mesh) -> torch.Tensor:
    """The rows at global indices `anc` of a row-sharded tensor: an
    `all_gather` of every rank's block, then a local take."""
    return all_gather(arr, mesh)[anc.long()]


def _ring_round(fwd, bwd, mesh):
    """One rotation of both rings: `fwd` goes to rank r - 1 and comes from
    r + 1, `bwd` the other way; one `batch_isend_irecv` for every leaf."""
    r, w = mesh.rank, mesh.size
    new_f = [torch.empty_like(b) for b in fwd]
    new_b = [torch.empty_like(b) for b in bwd]
    ops = []
    for i, (bf, bb, nf, nb) in enumerate(zip(fwd, bwd, new_f, new_b)):
        ops += [dist.P2POp(dist.isend, bf, (r - 1) % w, mesh.group, 2 * i),
                dist.P2POp(dist.irecv, nf, (r + 1) % w, mesh.group, 2 * i),
                dist.P2POp(dist.isend, bb, (r + 1) % w, mesh.group,
                           2 * i + 1),
                dist.P2POp(dist.irecv, nb, (r - 1) % w, mesh.group,
                           2 * i + 1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    COUNTS["send_recv"] += 1
    return new_f, new_b


def sharded_take_exchange(leaves, anc: torch.Tensor, mesh) -> list:
    """The rows at global indices `anc` of row-sharded tensors that share
    their leading axis, through the bidirectional ring: after t rotations
    the forward buffer holds rank r + t's block and the backward one rank
    r - t's. The rounds run to the farthest ring distance any slot's
    ancestor lies at, agreed by a `pmax`, so every rank runs as many:
    one under balanced weights, size // 2 when all the mass sits on one
    rank."""
    r, w = mesh.rank, mesh.size
    n_in = leaves[0].shape[0]
    anc = anc.long()
    src, loc = anc // n_in, anc % n_in
    fwd_dist = (src - r) % w
    ring = torch.minimum(fwd_dist, w - fwd_dist)
    hops = int(pmax(torch.max(ring), mesh)) if w > 1 else 0

    def take_from(out, bufs, shard):
        sel = src == shard
        return [torch.where(sel.reshape(sel.shape + (1,) * (b.ndim - 1)),
                            b[loc], o) for o, b in zip(out, bufs)]

    out = [torch.zeros((anc.shape[0],) + l.shape[1:], dtype=l.dtype,
                       device=l.device) for l in leaves]
    out = take_from(out, leaves, r)
    fwd = bwd = [l.contiguous() for l in leaves]
    for t in range(1, hops + 1):
        fwd, bwd = _ring_round(fwd, bwd, mesh)
        out = take_from(out, fwd, (r + t) % w)
        out = take_from(out, bwd, (r - t) % w)
    return out


def resample_sharded(u0, particles, log_w: torch.Tensor, mesh,
                     gather_particles: bool = True,
                     n_out: int | None = None):
    """Systematic resampling of row-sharded particles: `particles` a
    tensor or a tuple of tensors whose leading axis is log_w's (n_local,),
    every one taken by the same ancestors. `n_out` global output rows
    (default the input's) draws a population of another size from the
    same weighted measure. Returns (particles in the form given, this
    rank's ancestors (n_out / size,) int32). Both transports give the
    same rows."""
    single = isinstance(particles, torch.Tensor)
    leaves = [particles] if single else list(particles)
    for leaf in leaves:
        if leaf.shape[0] != log_w.shape[0]:
            raise ValueError(f"a leaf of {leaf.shape[0]} rows beside "
                             f"{log_w.shape[0]} weights")
    anc = sharded_ancestors(u0, log_w, mesh, n_out)
    if gather_particles:
        out = [sharded_take(leaf, anc, mesh) for leaf in leaves]
    else:
        out = sharded_take_exchange(leaves, anc, mesh)
    return (out[0] if single else tuple(out)), anc
