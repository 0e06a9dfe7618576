"""Sample-matrix, mask and shaped-variate helpers (port of
`tpuflows/util/shapes.py`).

A mask is a hashable tuple of 0/1 ints: 1 = pass-through dim (conditioner
input), 0 = transformed dim. Sample matrices are (N, d), batch leading.
"""
from __future__ import annotations

import math

import torch


def flatview(samples) -> torch.Tensor:
    """A list or stack of d-vectors -> an (N, d) matrix; scalars become
    (N, 1)."""
    if isinstance(samples, (list, tuple)):
        arr = torch.stack([torch.as_tensor(s) for s in samples])
    else:
        arr = torch.as_tensor(samples)
    if arr.ndim == 1:
        arr = arr[:, None]
    return arr.reshape(-1, arr.shape[-1])


def nestedview(matrix: torch.Tensor) -> list:
    """An (N, d) matrix -> a list of N d-vectors (views of its rows)."""
    return list(matrix)


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


def num_batches_split(n: int, nbatches: int) -> int:
    """The largest batch size that fills all `nbatches` batches from n
    samples (the remainder is dropped)."""
    if nbatches <= 0:
        raise ValueError("nbatches must be positive")
    bs = n // nbatches
    if bs == 0:
        raise ValueError(f"cannot split {n} samples into {nbatches} batches")
    return bs


def _tree_flatten(tree):
    """(leaves, treedef) of a tree of dicts, lists and tuples (named
    tuples included). A dict's children come in sorted-key order, as
    `jax.tree_util` flattens them, so the flat layout equals the JAX
    package's; None is a node without leaves; anything else is a leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        subs = [_tree_flatten(tree[k]) for k in keys]
        return ([leaf for ls, _ in subs for leaf in ls],
                (dict, tuple(keys), tuple(d for _, d in subs)))
    if isinstance(tree, (list, tuple)):
        subs = [_tree_flatten(t) for t in tree]
        return ([leaf for ls, _ in subs for leaf in ls],
                (type(tree), None, tuple(d for _, d in subs)))
    if tree is None:
        return [], None
    return [tree], "leaf"


def _tree_unflatten(treedef, leaves):
    """The inverse of `_tree_flatten`: consumes `leaves` (an iterator)."""
    if treedef == "leaf":
        return next(leaves)
    if treedef is None:
        return None
    kind, keys, children = treedef
    built = [_tree_unflatten(c, leaves) for c in children]
    if kind is dict:
        return dict(zip(keys, built))
    if kind in (list, tuple):
        return kind(built)
    return kind(*built)  # a named tuple


class VariateShape:
    """Shaped <-> flat variate transform.

    Built from an example tree of tensors (a named parameter space, e.g.
    `{"mu": (), "sigma": (3,), "W": (2, 2)}` as tensors); converts between
    such trees and flat `(..., d)` vectors with any leading batch axes, so
    samplers and flows see dense matrices while user densities see named
    parameters. Leaves are laid out in `jax.tree_util` order (a dict's
    keys sorted)."""

    def __init__(self, example):
        leaves, self._treedef = _tree_flatten(example)
        self._shapes = tuple(tuple(torch.as_tensor(leaf).shape)
                             for leaf in leaves)
        self._sizes = tuple(math.prod(s) for s in self._shapes)
        self.dim = int(sum(self._sizes))

    def flatten(self, tree) -> torch.Tensor:
        """Tree with leaves of shape (*batch, *leaf_shape) -> (*batch, d)."""
        leaves, _ = _tree_flatten(tree)
        parts = []
        for leaf, shape, size in zip(leaves, self._shapes, self._sizes):
            leaf = torch.as_tensor(leaf)
            batch = leaf.shape[:leaf.ndim - len(shape)]
            parts.append(leaf.reshape(*batch, size))
        return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]

    def unflatten(self, vec: torch.Tensor):
        """(*batch, d) -> tree with leaves (*batch, *leaf_shape)."""
        vec = torch.as_tensor(vec)
        batch = vec.shape[:-1]
        leaves, off = [], 0
        for shape, size in zip(self._shapes, self._sizes):
            leaves.append(vec[..., off:off + size].reshape(
                (*batch, *shape)))
            off += size
        return _tree_unflatten(self._treedef, iter(leaves))

    def flat_log_density(self, shaped_log_density):
        """A density over named parameters as one over flat vectors."""

        def logp(x):
            return shaped_log_density(self.unflatten(x))

        return logp
