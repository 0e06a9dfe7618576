"""Rational-quadratic-spline coupling blocks and modules (port of
`tpuflows/flows/coupling.py`).

Dense-mask formulation, as for the affine coupling: the conditioner sees
`x * mask` at full width d and emits (d, 3K-1) spline parameters, d-major
(column j (3K-1) + p is parameter p of dim j); the spline runs on every dim
and the mask selects the transformed ones.

The `use_pallas` field keeps the JAX package's values, mapped to this
port's tiers:
  * False      — the plain PyTorch oracle (`flows/rqs_ref.py`);
  * True       — K4/K5 (`kernels/rqs_cuda.py`): the conditioner in torch,
                 then the elementwise spline kernels;
  * "fused"    — K6/K7 (`kernels/coupling_cuda.py`): the whole block, the
                 conditioner included, in one kernel and its pullback;
  * "auto"     — the same as True on a batch. The JAX package's "auto"
                 picks its fused tier at d % 128 == 0 from timings taken
                 on a TPU, which mean nothing on this card; PERF.md records
                 both tiers' times on the H100, and the choice waits for a
                 PR that reads them.
For the kernel tiers a CUDA tensor launches the kernels or raises, and a
CPU tensor runs their plain version in its own dtype. As in the JAX
package, a single vector (x.ndim == 1) under "auto" or "fused" takes the
oracle. Every tier takes any K; K4/K5's blocks must fit the shared
memory, which sets their one limit (`rqs_cuda.spline_plan`: 11,620 knots
for K4, 9,684 for K5), checked when a block is built on a CUDA device
under True or "auto".
"""
from __future__ import annotations

import torch

from tpuflows_torch.flows import rqs_ref
from tpuflows_torch.flows.core import Bijector, Chain
from tpuflows_torch.flows.nets import MLP
from tpuflows_torch.util.device import f32_device
from tpuflows_torch.util.shapes import alternating_mask, mask_array


def _spline_fns(use_pallas):
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
        if device.type == "cuda" and use_pallas in (True, "auto"):
            from tpuflows_torch.kernels import rqs_cuda

            for grad in (False, True):  # K4's and K5's shared memory
                rqs_cuda.spline_plan(self.knots, grad)
        self.register_buffer("mask_f", mask_array(self.mask, device=device),
                             persistent=False)

    def _kernel_choice(self, x):
        """The tier for input x: a single vector under "auto" or "fused"
        takes the oracle (False), as in the JAX package; a batch under
        "auto" takes K4/K5 (True)."""
        if x.dim() < 2:
            return False if self.use_pallas in ("auto", "fused") \
                else self.use_pallas
        if self.use_pallas == "auto":
            return True
        return self.use_pallas

    def _raw_params(self, masked_input):
        d = len(self.mask)
        h = self.net(masked_input)
        return h.reshape(*h.shape[:-1], d, 3 * self.knots - 1)

    def _fused(self, x, inverse):
        from tpuflows_torch.kernels import coupling_cuda

        fn = (coupling_cuda.fused_coupling_inverse if inverse
              else coupling_cuda.fused_coupling_forward)
        return fn(x, self.net, self.mask, self.knots, self.range_limit)

    def forward_and_ladj(self, x):
        kernel = self._kernel_choice(x)
        if kernel == "fused":
            return self._fused(x, inverse=False)
        fwd, _ = _spline_fns(kernel)
        b = self.mask_f
        raw = self._raw_params(x * b)
        y, ladj_el = fwd(x, raw, self.range_limit)
        z = b * x + (1.0 - b) * y
        ladj = torch.sum((1.0 - b) * ladj_el, dim=-1)
        return z, ladj

    def inverse_and_ladj(self, z):
        kernel = self._kernel_choice(z)
        if kernel == "fused":
            return self._fused(z, inverse=True)
        _, inv = _spline_fns(kernel)
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
