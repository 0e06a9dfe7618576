"""Checkpoint / resume for one process (port of `tpuflows/io/checkpoint.py`:
`save_pytree`, `load_pytree`, `latest_checkpoint`; the multi-process shards
wait for `dist/`, ROADMAP Queue 1 item 11).

A checkpoint is one `<path>.pt` file written by `torch.save` and read back
by `torch.load(weights_only=True)`: a tree of dicts, lists, tuples and
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
"""
from __future__ import annotations

import importlib
import os
import re
from typing import Any, Optional

import torch
from torch import nn

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


def save_pytree(path: str, tree: Any) -> None:
    """Save `tree` to `<path>.pt`, atomically (see the module docstring
    for what a tree may hold)."""
    file = path + SUFFIX
    os.makedirs(os.path.dirname(os.path.abspath(file)), exist_ok=True)
    tmp = file + ".tmp"
    torch.save(_to_saved(tree), tmp)
    os.replace(tmp, file)


def load_pytree(path: str, device=None) -> Any:
    """Load what `save_pytree(path, ...)` wrote, its tensors and flows on
    `device` (default the CPU), its generators on their own device type."""
    return _from_saved(torch.load(path + SUFFIX, map_location=device,
                                  weights_only=True), device)


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
