"""Checkpoint / resume (port of `tpuflows/io/checkpoint.py`: `save_pytree`,
`load_pytree`, `latest_checkpoint`).

A checkpoint of one process is one `<path>.pt` file written by
`torch.save` and read back by `torch.load(weights_only=True)`: a tree of
dicts, lists, tuples and
NamedTuples over tensors, plain values, generators and modules. Tensors
are moved to the CPU first. Three kinds of node are stored as tagged
records of plain values and tensors, since the weights-only loader
rebuilds no other class:

  * a NamedTuple: its class (module and qualified name) and its fields;
    the load rebuilds it by position from that class, which must be a
    NamedTuple importable under that name;
  * a `torch.Generator`: its `get_state()` and its device type; the load
    gives back a new generator of that type in that state;
  * a flow: a `Bijector` of a kind `convert.module_spec` describes
    (Standardize, Whiten, Identity, AffineCoupling, RQSCouplingBlock,
    ScannedRepeat), or a `Chain` of such modules; the load gives back a
    `Chain` of them built by `convert.flow_from_jax_modules` on the device
    `load_pytree` is given, so a flow that grew comes back grown.

Any other module (a nested Chain, a wrapper) is saved as its
`state_dict`, and goes back with `module.load_state_dict(...)`. The write
is atomic: a temporary file, then `os.replace`.

Several processes (a `torch.distributed` world of more than one): each
rank writes its own `<path>_p{rank}.pt`, and rank 0 writes
`<path>.meta.json` with the process count and each top-level leaf's
layout, "sharded0" (this rank's block of rows along axis 0) or
"replicated". A torch tensor carries no sharding, so the caller declares
the row-sharded leaves (`save_pytree(..., sharded=("x", ...))`); a process
that declares some writes the meta file beside its one `<path>.pt` too.
`load_pytree` reshards a checkpoint written by another process count (a
shared file system assumed): a sharded leaf is concatenated from every
shard in rank order and re-sliced into this rank's equal block, a
replicated one read from shard 0. One process without declared leaves
writes and reads `<path>.pt` alone, as before, and removes the meta file
an earlier save to the same path left.
"""
from __future__ import annotations

import importlib
import json
import os
import re
from typing import Any, Optional

import torch
from torch import nn

from tpuflows_torch.util.profiling import process_count, process_index

SUFFIX = ".pt"
# the key that marks a tagged record, and its kinds
TAG = "__tpuflows_torch__"


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(type(tree), "_fields")


def _flow_modules(tree):
    """The modules of `tree` as a flow (a list for `flow_from_jax_modules`),
    or None where it is not one."""
    from tpuflows_torch.convert import SPEC_KINDS
    from tpuflows_torch.flows.core import Chain

    modules = list(tree.transforms) if isinstance(tree, Chain) else [tree]
    if all(isinstance(m, SPEC_KINDS) for m in modules):
        return modules
    return None


def _to_saved(tree):
    if isinstance(tree, torch.Generator):
        return {TAG: "generator", "device": tree.device.type,
                "state": tree.get_state()}
    if isinstance(tree, nn.Module):
        modules = _flow_modules(tree)
        if modules is None:
            return _to_saved(tree.state_dict())
        from tpuflows_torch.convert import module_spec

        return {TAG: "flow", "modules": [_to_saved(module_spec(m))
                                         for m in modules]}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return type(tree)((k, _to_saved(v)) for k, v in tree.items())
    if _is_namedtuple(tree):
        cls = type(tree)
        return {TAG: "namedtuple", "module": cls.__module__,
                "name": cls.__qualname__,
                "fields": [_to_saved(v) for v in tree]}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_saved(v) for v in tree)
    return tree


def _namedtuple_class(module: str, name: str):
    cls = importlib.import_module(module)
    for part in name.split("."):
        cls = getattr(cls, part)
    if not (isinstance(cls, type) and issubclass(cls, tuple)
            and hasattr(cls, "_fields")):
        raise TypeError(f"{module}.{name} is not a NamedTuple")
    return cls


def _from_saved(tree, device):
    if isinstance(tree, dict) and TAG in tree:
        kind = tree[TAG]
        if kind == "generator":
            g = torch.Generator(device=tree["device"])
            g.set_state(tree["state"].cpu())
            return g
        if kind == "flow":
            from tpuflows_torch.convert import flow_from_jax_modules

            return flow_from_jax_modules(
                [_from_saved(m, device) for m in tree["modules"]],
                device=device or "cpu")
        if kind == "namedtuple":
            cls = _namedtuple_class(tree["module"], tree["name"])
            return cls(*(_from_saved(v, device) for v in tree["fields"]))
        raise ValueError(f"unknown checkpoint record: {kind!r}")
    if isinstance(tree, dict):
        return type(tree)((k, _from_saved(v, device))
                          for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_from_saved(v, device) for v in tree)
    return tree


def _shard_file(path: str, pid: int, pcount: int) -> str:
    return f"{path}_p{pid}{SUFFIX}" if pcount > 1 else path + SUFFIX


def _write(file: str, write) -> None:
    tmp = file + ".tmp"
    write(tmp)
    os.replace(tmp, file)


def _layouts(tree, sharded) -> dict:
    """{top-level key: layout} of a dict tree (sharded: the keys named),
    or {"": layout} of any other tree (sharded: `sharded is True`)."""
    if isinstance(tree, dict) and sharded is not True:
        unknown = set(sharded) - set(tree)
        if unknown:
            raise KeyError(f"sharded leaves not in the tree: "
                           f"{sorted(unknown)}")
        return {k: "sharded0" if k in sharded else "replicated"
                for k in tree}
    return {"": "sharded0" if sharded is True else "replicated"}


def save_pytree(path: str, tree: Any, sharded=()) -> None:
    """Save `tree` to `<path>.pt`, atomically (see the module docstring
    for what a tree may hold); in a world of several processes each rank
    writes `<path>_p{rank}.pt`. `sharded` names the top-level keys of a
    dict tree whose leaves hold this rank's rows (True: the tree is one
    such tensor)."""
    pid, pcount = process_index(), process_count()
    file = _shard_file(path, pid, pcount)
    os.makedirs(os.path.dirname(os.path.abspath(file)), exist_ok=True)
    layouts = _layouts(tree, sharded)
    _write(file, lambda tmp: torch.save(_to_saved(tree), tmp))
    if pid != 0:
        return
    meta = path + ".meta.json"
    if pcount > 1 or "sharded0" in layouts.values():
        def dump(tmp):
            with open(tmp, "w") as f:
                json.dump({"process_count": pcount, "layouts": layouts}, f)

        _write(meta, dump)
    elif os.path.exists(meta):
        # a meta file of an earlier save would send the load to its shards
        os.remove(meta)


def _read(file: str, device):
    return torch.load(file, map_location=device, weights_only=True)


def _block(leaf, layout, pid, pcount, key):
    """This rank's equal block of a sharded leaf's rows."""
    if layout != "sharded0" or pcount == 1:
        return leaf
    rows = leaf.shape[0]
    if rows % pcount != 0:
        raise ValueError(f"cannot reshard leaf {key!r}: {rows} rows over "
                         f"{pcount} processes")
    blk = rows // pcount
    return leaf[pid * blk:(pid + 1) * blk]


def load_pytree(path: str, device=None) -> Any:
    """Load what `save_pytree(path, ...)` wrote, its tensors and flows on
    `device` (default the CPU), its generators on their own device type.
    This rank's shard where the process count is the writer's; otherwise
    the checkpoint resharded (module docstring)."""
    pid, pcount = process_index(), process_count()
    meta = None
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    saved_count = 1 if meta is None else meta["process_count"]
    if saved_count == pcount:
        return _from_saved(_read(_shard_file(path, pid, pcount), device),
                           device)
    shards = [_read(_shard_file(path, p, saved_count), device)
              for p in range(saved_count)]
    layouts = {"": "replicated"} if meta is None else meta["layouts"]

    def whole(key, pick):
        """The leaf under `key` of every shard, as the global leaf."""
        if layouts[key] == "sharded0" and saved_count > 1:
            full = torch.cat([pick(s) for s in shards])
        else:
            full = pick(shards[0])
        return _block(full, layouts[key], pid, pcount, key)

    if "" in layouts:
        return _from_saved(whole("", lambda s: s), device)
    return _from_saved(type(shards[0])(
        (k, whole(k, lambda s, k=k: s[k])) for k in shards[0]), device)


def latest_checkpoint(directory: str, prefix: str = "ckpt_") -> Optional[str]:
    """The path (without extension) of the highest-step `<prefix><step>`
    checkpoint in `directory` (one file, or per-rank `_p{i}` shards), or
    None."""
    if not os.path.isdir(directory):
        return None
    pat = re.compile(re.escape(prefix) + r"(\d+)(?:_p\d+)?"
                     + re.escape(SUFFIX) + "$")
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := pat.match(f))]
    if not steps:
        return None
    return os.path.join(directory, f"{prefix}{max(steps)}")
