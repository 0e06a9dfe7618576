"""Device choice for the entry points.

Every entry point of the port takes `device=` (default "cuda") and passes it
through `f32_device`, which also switches TF32 off: the port computes in
float32 throughout, and a float32 matmul on Hopper would otherwise be free
to round its operands to TF32 (cuDNN does so by default).
"""
from __future__ import annotations

import torch


def f32_device(device) -> torch.device:
    """`torch.device(device)`, with TF32 matmuls and convolutions disabled."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device(device)
