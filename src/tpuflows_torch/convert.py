"""Carry a flow across from the JAX package.

The converters take a JAX flow's leaves as numpy arrays (or anything
`torch.as_tensor` accepts) and its static fields as plain values, and build
the port's modules that compute the same function. They import nothing of
JAX: the caller reads the leaves and passes them.

  * `flow_from_jax_params` — `Chain(Standardize, AffineCoupling)`, the
    flow of the ceiling path;
  * `flow_from_jax_modules` — any Chain of Standardize, Whiten, Identity,
    AffineCoupling, RQSCouplingBlock and ScannedRepeat, one dict per
    module (`module_from_jax_spec`);
  * `module_spec` — the inverse: a module's dict, its leaves as CPU
    tensors (what `io/checkpoint.py` stores for a flow).
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from tpuflows_torch.flows.affine import AffineCoupling, Standardize, Whiten
from tpuflows_torch.flows.core import Chain, Identity, ScannedRepeat
from tpuflows_torch.flows.coupling import RQSCouplingBlock
from tpuflows_torch.flows.nets import MLP
from tpuflows_torch.flows.rqs_ref import DEFAULT_RANGE
from tpuflows_torch.util.device import f32_device


def _t(a, device):
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


def _mlp(spec, device):
    return MLP([_t(w, device) for w in spec["weights"]],
               [_t(b, device) for b in spec["biases"]],
               activation=spec.get("activation", "silu"),
               compute_dtype=spec.get("compute_dtype", "f32"))


def flow_from_jax_params(loc, log_scale, weights: Sequence,
                         biases: Sequence, mask: Sequence[int],
                         clamp: float, device="cuda") -> Chain:
    """Chain([Standardize(loc, log_scale), AffineCoupling(mask, MLP, clamp)])
    with the JAX flow's values: weights[i] is (d_in, d_out), biases[i]
    (d_out,), as in `tpuflows.flows.nets.MLP` with its default silu. Built
    on `device` (default "cuda"), with TF32 switched off."""
    device = f32_device(device)
    std = Standardize(_t(loc, device), _t(log_scale, device))
    net = MLP([_t(w, device) for w in weights],
              [_t(b, device) for b in biases])
    coupling = AffineCoupling(tuple(int(m) for m in mask), net, clamp=clamp)
    return Chain([std, coupling])


def module_from_jax_spec(spec: Mapping, device):
    """One of the port's modules from its dict:

      {"kind": "standardize", "loc", "log_scale"}
      {"kind": "whiten", "loc", "inv_chol", "chol"}
      {"kind": "identity"}
      {"kind": "affine", "mask", "weights", "biases", "clamp",
       "activation" (default "silu"), "compute_dtype" (default "f32")}
      {"kind": "rqs", "mask", "weights", "biases", "knots",
       "range_limit" (default 4.0), "activation" (default "silu"),
       "compute_dtype" (default "f32"), "use_pallas" (default "auto")}
      {"kind": "scanned", "inner": the dict of the stacked block, whose
       leaves carry the leading block axis}

    weights[i] is (d_in, d_out) and biases[i] (d_out,), as in
    `tpuflows.flows.nets.MLP`; a spline conditioner's last layer keeps the
    JAX package's d-major columns."""
    kind = spec["kind"]
    if kind == "standardize":
        return Standardize(_t(spec["loc"], device),
                           _t(spec["log_scale"], device))
    if kind == "whiten":
        return Whiten(_t(spec["loc"], device), _t(spec["inv_chol"], device),
                      _t(spec["chol"], device))
    if kind == "identity":
        return Identity()
    if kind == "affine":
        return AffineCoupling(tuple(int(m) for m in spec["mask"]),
                              _mlp(spec, device), clamp=spec["clamp"])
    if kind == "rqs":
        return RQSCouplingBlock(
            tuple(int(m) for m in spec["mask"]), _mlp(spec, device),
            knots=spec["knots"],
            range_limit=spec.get("range_limit", DEFAULT_RANGE),
            use_pallas=spec.get("use_pallas", "auto"))
    if kind == "scanned":
        return ScannedRepeat(module_from_jax_spec(spec["inner"], device))
    raise ValueError(f"unknown module kind: {kind!r}")


# the module kinds `module_spec` describes
SPEC_KINDS = (Standardize, Whiten, Identity, AffineCoupling, RQSCouplingBlock,
              ScannedRepeat)


def _leaves(ts):
    return [t.detach().cpu().clone() for t in ts]


def module_spec(module) -> dict:
    """The dict `module_from_jax_spec` builds `module` from: its static
    fields as plain values and its tensors detached on the CPU, so that
    the module it builds computes the same function to the bit."""
    if isinstance(module, Standardize):
        return {"kind": "standardize",
                **dict(zip(("loc", "log_scale"),
                           _leaves((module.loc, module.log_scale))))}
    if isinstance(module, Whiten):
        return {"kind": "whiten",
                **dict(zip(("loc", "inv_chol", "chol"),
                           _leaves((module.loc, module.inv_chol,
                                    module.chol))))}
    if isinstance(module, Identity):
        return {"kind": "identity"}
    if isinstance(module, ScannedRepeat):
        return {"kind": "scanned", "inner": module_spec(module.stacked)}
    if not isinstance(module, (AffineCoupling, RQSCouplingBlock)):
        raise TypeError(f"no spec for a {type(module).__name__}")
    spec = {"mask": list(module.mask),
            "weights": _leaves(module.net.weights),
            "biases": _leaves(module.net.biases),
            "activation": module.net.activation,
            "compute_dtype": module.net.compute_dtype}
    if isinstance(module, AffineCoupling):
        return {"kind": "affine", **spec, "clamp": module.clamp}
    return {"kind": "rqs", **spec, "knots": module.knots,
            "range_limit": module.range_limit,
            "use_pallas": module.use_pallas}


def flow_from_jax_modules(modules: Sequence[Mapping],
                          device="cuda") -> Chain:
    """A Chain of the port's modules, one per dict
    (`module_from_jax_spec`), in chain order; built on `device` (default
    "cuda"), with TF32 switched off."""
    device = f32_device(device)
    return Chain([module_from_jax_spec(spec, device) for spec in modules])
