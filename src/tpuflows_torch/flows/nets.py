"""Dense conditioner network (port of `tpuflows/flows/nets.py`).

float32 only: the JAX package's opt-in bf16 operands wait for a later slice.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

_ACTIVATIONS = {
    "silu": F.silu,
    "tanh": torch.tanh,
    "relu": F.relu,
}


class MLP(nn.Module):
    """weights[i]: (d_in, d_out); biases[i]: (d_out,). Last layer linear."""

    def __init__(self, weights, biases, activation: str = "silu"):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation: {activation!r}")
        self.weights = nn.ParameterList(
            [nn.Parameter(torch.as_tensor(w, dtype=torch.float32))
             for w in weights])
        self.biases = nn.ParameterList(
            [nn.Parameter(torch.as_tensor(b, dtype=torch.float32))
             for b in biases])
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = _ACTIVATIONS[self.activation]
        n = len(self.weights)
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            x = x @ w + b
            if i + 1 < n:
                x = act(x)
        return x

    @staticmethod
    def init(sizes: Sequence[int], generator: torch.Generator,
             activation: str = "silu", final_zero: bool = True,
             device=None) -> "MLP":
        """He-init hidden layers, zero biases; `final_zero` zero-inits the
        last layer so a fresh coupling starts at the identity map."""
        ws, bs = [], []
        for i, (d_in, d_out) in enumerate(zip(sizes[:-1], sizes[1:])):
            last = i == len(sizes) - 2
            if last and final_zero:
                w = torch.zeros((d_in, d_out), dtype=torch.float32)
            else:
                w = math.sqrt(2.0 / d_in) * torch.randn(
                    (d_in, d_out), generator=generator,
                    device=generator.device, dtype=torch.float32)
            ws.append(w.to(device))
            bs.append(torch.zeros((d_out,), dtype=torch.float32,
                                  device=device))
        return MLP(ws, bs, activation=activation)
