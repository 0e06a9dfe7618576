"""Carry a flow across from the JAX package.

`flow_from_jax_params` takes the leaves of a JAX `Chain(Standardize,
AffineCoupling)` as numpy arrays (or anything `torch.as_tensor` accepts) and
builds the port's modules that compute the same function. It imports
nothing of JAX: the caller reads the leaves (`flow.transforms[0].loc`, ...,
`flow.transforms[1].net.weights`) and passes them as arrays.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tpuflows_torch.flows.affine import AffineCoupling, Standardize
from tpuflows_torch.flows.core import Chain
from tpuflows_torch.flows.nets import MLP
from tpuflows_torch.util.device import f32_device


def _t(a, device):
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


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
