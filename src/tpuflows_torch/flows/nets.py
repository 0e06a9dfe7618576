"""Dense conditioner network (port of `tpuflows/flows/nets.py`).

Parameters are float32. `compute_dtype="bf16"` (opt-in) rounds each
matmul's operands to bfloat16 and accumulates in float32; the biases and
activations stay float32. The kernel tiers that run a conditioner
themselves (K1, K2, K3, K6/K7) round where this does: weights packed
rounded, each layer's input rounded, and, under autograd, each input
cotangent rounded once after its float32 sum.
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
    # jax.nn.gelu's default is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}
COMPUTE_DTYPES = ("f32", "bf16")


def _bf16_operand(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16 and held in its own dtype (float32, or
    float64 for a float64 referee): a product of two such values is exact
    in float32, so a float32 matmul of them accumulates bf16 operands in
    float32 (`x.bfloat16() @ w.bfloat16()` would round the result to
    bf16)."""
    return t.bfloat16().to(t.dtype)


class MLP(nn.Module):
    """weights[i]: (d_in, d_out); biases[i]: (d_out,). Last layer linear."""

    def __init__(self, weights, biases, activation: str = "silu",
                 compute_dtype: str = "f32"):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation: {activation!r}")
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown compute_dtype: {compute_dtype!r}")
        self.weights = nn.ParameterList(
            [nn.Parameter(torch.as_tensor(w, dtype=torch.float32))
             for w in weights])
        self.biases = nn.ParameterList(
            [nn.Parameter(torch.as_tensor(b, dtype=torch.float32))
             for b in biases])
        self.activation = activation
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = _ACTIVATIONS[self.activation]
        bf16 = self.compute_dtype == "bf16"
        n = len(self.weights)
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            if bf16:
                x = _bf16_operand(x) @ _bf16_operand(w) + b
            else:
                x = x @ w + b
            if i + 1 < n:
                x = act(x)
        return x

    @staticmethod
    def init(sizes: Sequence[int], generator: torch.Generator,
             activation: str = "silu", final_zero: bool = True,
             device=None, compute_dtype: str = "f32") -> "MLP":
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
        return MLP(ws, bs, activation=activation,
                   compute_dtype=compute_dtype)
