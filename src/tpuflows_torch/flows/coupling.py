"""Rational-quadratic-spline coupling blocks and modules (port of
`tpuflows/flows/coupling.py`).

Dense-mask formulation, as for the affine coupling: the conditioner sees
`x * mask` at full width d and emits (d, 3K-1) spline parameters, d-major
(column j (3K-1) + p is parameter p of dim j); the spline runs on every dim
and the mask selects the transformed ones.

The `use_pallas` field keeps the JAX package's values, mapped to this
port's tiers:
  * False      — the plain PyTorch oracle (`flows/rqs_ref.py`);
  * True       — K4/K5 (`kernels/rqs_cuda.py`): a CUDA tensor launches the
                 kernels or raises, a CPU tensor runs their plain version;
  * "auto"     — the same as True. The JAX package's "auto" picks XLA or
                 its fused block kernel from timings taken on a TPU, which
                 mean nothing on this card, and the fused tier is not
                 ported yet;
  * "fused"    — the whole-block kernels K6/K7, not ported yet: raises
                 NotImplementedError (ROADMAP.md, Queue 2).
"""
from __future__ import annotations

import torch

from tpuflows_torch.flows import rqs_ref
from tpuflows_torch.flows.core import Bijector, Chain
from tpuflows_torch.flows.nets import MLP
from tpuflows_torch.util.device import f32_device
from tpuflows_torch.util.shapes import alternating_mask, mask_array


def _spline_fns(use_pallas):
    if use_pallas == "fused":
        raise NotImplementedError(
            'use_pallas="fused" (the whole-block kernels K6/K7) is not '
            "ported yet (ROADMAP.md, Queue 2)")
    if use_pallas is False:
        return rqs_ref.rqs_forward_from_raw, rqs_ref.rqs_inverse_from_raw
    from tpuflows_torch.kernels import rqs_cuda

    return rqs_cuda.rqs_forward_from_raw, rqs_cuda.rqs_inverse_from_raw


class RQSCouplingBlock(Bijector):
    """One coupling block: conditioner MLP -> per-dim RQS transform.

    mask[i] == 1: pass-through dim; 0: spline-transformed dim."""

    def __init__(self, mask: tuple, net: MLP, knots: int = 8,
                 range_limit: float = rqs_ref.DEFAULT_RANGE,
                 use_pallas=False):
        super().__init__()
        if not (isinstance(use_pallas, bool)
                or use_pallas in ("auto", "fused")):
            raise ValueError(f"unknown use_pallas: {use_pallas!r}")
        self.mask = tuple(int(m) for m in mask)
        self.net = net
        self.knots = int(knots)
        self.range_limit = float(range_limit)
        self.use_pallas = use_pallas
        device = net.weights[0].device
        self.register_buffer("mask_f", mask_array(self.mask, device=device),
                             persistent=False)

    def _raw_params(self, masked_input):
        d = len(self.mask)
        h = self.net(masked_input)
        return h.reshape(*h.shape[:-1], d, 3 * self.knots - 1)

    def forward_and_ladj(self, x):
        fwd, _ = _spline_fns(self.use_pallas)
        b = self.mask_f
        raw = self._raw_params(x * b)
        y, ladj_el = fwd(x, raw, self.range_limit)
        z = b * x + (1.0 - b) * y
        ladj = torch.sum((1.0 - b) * ladj_el, dim=-1)
        return z, ladj

    def inverse_and_ladj(self, z):
        _, inv = _spline_fns(self.use_pallas)
        b = self.mask_f
        raw = self._raw_params(z * b)  # pass dims unchanged: z*b == x*b
        x_t, ladj_el = inv(z, raw, self.range_limit)
        x = b * z + (1.0 - b) * x_t
        ladj = torch.sum((1.0 - b) * ladj_el, dim=-1)
        return x, ladj

    @staticmethod
    def init(generator: torch.Generator, mask: tuple, knots: int = 8,
             hidden: tuple = (64, 64), activation: str = "silu",
             range_limit: float = rqs_ref.DEFAULT_RANGE,
             use_pallas="auto", device=None) -> "RQSCouplingBlock":
        """He-initialized hidden layers drawn from `generator`; the last
        layer is zero, so a fresh block is the spline of uniform bins with
        unit derivatives (the identity up to min_deriv)."""
        d = len(mask)
        net = MLP.init((d, *hidden, d * (3 * knots - 1)), generator,
                       activation=activation, device=device)
        return RQSCouplingBlock(tuple(mask), net, knots=knots,
                                range_limit=range_limit,
                                use_pallas=use_pallas)


def rqs_coupling_module(generator: torch.Generator, dim: int,
                        n_blocks: int = 4, knots: int = 8,
                        hidden: tuple = (64, 64), activation: str = "silu",
                        range_limit: float = rqs_ref.DEFAULT_RANGE,
                        use_pallas="auto", device="cuda") -> Chain:
    """n_blocks blocks with alternating checkerboard masks, so every dim
    is transformed by half of them; built on `device` (default "cuda"),
    with TF32 switched off."""
    device = f32_device(device)
    return Chain([
        RQSCouplingBlock.init(generator, alternating_mask(dim, i % 2),
                              knots=knots, hidden=hidden,
                              activation=activation,
                              range_limit=range_limit,
                              use_pallas=use_pallas, device=device)
        for i in range(n_blocks)])
