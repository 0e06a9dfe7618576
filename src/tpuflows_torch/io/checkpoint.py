"""Checkpoint / resume for one process (port of `tpuflows/io/checkpoint.py`:
`save_pytree`, `load_pytree`, `latest_checkpoint`; the multi-process shards
wait for `dist/`, ROADMAP Queue 1 item 11).

A checkpoint is one `<path>.pt` file written by `torch.save`: a tensor, or
a tree of dicts, lists and tuples of tensors and plain values; a module is
saved as its `state_dict`. Tensors are moved to the CPU first. The write
is atomic: a temporary file, then `os.replace`.
"""
from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch
from torch import nn

SUFFIX = ".pt"


def _to_cpu(tree):
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return type(tree)((k, _to_cpu(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_pytree(path: str, tree: Any) -> None:
    """Save `tree` (a module's state_dict when it is a module) to
    `<path>.pt`, atomically."""
    file = path + SUFFIX
    os.makedirs(os.path.dirname(os.path.abspath(file)), exist_ok=True)
    tmp = file + ".tmp"
    torch.save(_to_cpu(tree), tmp)
    os.replace(tmp, file)


def load_pytree(path: str, device=None) -> Any:
    """Load what `save_pytree(path, ...)` wrote, its tensors on `device`
    (default the CPU). A module's state goes back with
    `module.load_state_dict(load_pytree(path))`."""
    return torch.load(path + SUFFIX, map_location=device, weights_only=True)


def latest_checkpoint(directory: str, prefix: str = "ckpt_") -> Optional[str]:
    """The path (without extension) of the highest-step `<prefix><step>`
    checkpoint in `directory`, or None."""
    if not os.path.isdir(directory):
        return None
    pat = re.compile(re.escape(prefix) + r"(\d+)" + re.escape(SUFFIX) + "$")
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := pat.match(f))]
    if not steps:
        return None
    return os.path.join(directory, f"{prefix}{max(steps)}")
