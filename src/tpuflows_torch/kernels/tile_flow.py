"""Flow application on (T, d) tiles with p-major spline conditioners (port
of `tpuflows/kernels/tile_flow.py`).

`permute_for_tiles` relays the last layer of every RQS conditioner from
the d-major columns j (3K-1) + p to p-major columns p d + j, so spline
parameter p of all dims is one contiguous (T, d) slice. These functions are
the plain version of K1's spline gradient, and the map of what its device
code does (`csrc/latent_grad.cuh`, `chain_logp_grad`): the inverse chain
block by block, and the gradient of log p(f^-1(z)) + ladj by a per-block
rematerialised backward.
"""
from __future__ import annotations

import torch

from tpuflows_torch.flows.affine import AffineCoupling, Standardize, Whiten
from tpuflows_torch.flows.core import Chain
from tpuflows_torch.flows.coupling import RQSCouplingBlock
from tpuflows_torch.flows.nets import MLP
from tpuflows_torch.flows.rqs_ref import DEFAULT_MIN_BIN, DEFAULT_MIN_DERIV
from tpuflows_torch.kernels.rqs_cuda import _inv_tile_math


def p_major(w: torch.Tensor, d: int, P: int) -> torch.Tensor:
    """(..., d P) d-major columns -> (..., P d) p-major columns."""
    lead = w.shape[:-1]
    return w.reshape(*lead, d, P).transpose(-1, -2).reshape(*lead, P * d)


@torch.no_grad()
def permute_for_tiles(flow: Chain) -> Chain:
    """A chain of the same modules whose RQS blocks hold p-major copies of
    their conditioners' last layers (detached; the other modules are
    shared). Only the tile functions below read such a block."""
    out = []
    for t in flow.transforms:
        if isinstance(t, RQSCouplingBlock):
            d, P = len(t.mask), 3 * t.knots - 1
            ws = [w.detach().clone() for w in t.net.weights]
            bs = [b.detach().clone() for b in t.net.biases]
            ws[-1] = p_major(ws[-1], d, P)
            bs[-1] = p_major(bs[-1], d, P)
            out.append(RQSCouplingBlock(
                t.mask, MLP(ws, bs, activation=t.net.activation,
                            compute_dtype=t.net.compute_dtype),
                knots=t.knots, range_limit=t.range_limit,
                use_pallas=t.use_pallas))
        else:
            out.append(t)
    return Chain(out)


def _rqs_block_inverse_2d(blk: RQSCouplingBlock, z2d):
    """Inverse of one RQS block with a p-major conditioner on (T, d)."""
    d, P = len(blk.mask), 3 * blk.knots - 1
    b = blk.mask_f
    raw_t = blk.net(z2d * b)  # (T, P d), p-major columns
    raw = [raw_t[:, p * d:(p + 1) * d] for p in range(P)]
    x_t, ladj_el = _inv_tile_math(z2d, raw, blk.knots, blk.range_limit,
                                  DEFAULT_MIN_BIN, DEFAULT_MIN_DERIV)
    x = b * z2d + (1.0 - b) * x_t
    ladj = torch.sum((1.0 - b) * ladj_el, dim=-1)
    return x, ladj


def _block_inverse_2d(t, x):
    if isinstance(t, RQSCouplingBlock):
        return _rqs_block_inverse_2d(t, x)
    if isinstance(t, (AffineCoupling, Standardize, Whiten)):
        return t.inverse_and_ladj(x)
    raise NotImplementedError(
        f"tile flow math: unsupported module {type(t).__name__}")


def tile_inverse_and_ladj(flow_p: Chain, z2d):
    """`flow.inverse_and_ladj(z)` for a permuted flow on (T, d)."""
    x = z2d
    total = torch.zeros(z2d.shape[:-1], dtype=z2d.dtype, device=z2d.device)
    for t in reversed(flow_p.transforms):
        x, ladj = _block_inverse_2d(t, x)
        total = total + ladj
    return x, total


def tile_logp_and_grad_streamed(flow_p: Chain, z2d, log_density):
    """(lp (T, 1), g (T, d)) of logp~(z) = log_density(f^-1(z)) + ladj(z)
    for a permuted flow, with a streamed per-block backward:

      sweep 1  apply the inverse chain block by block, keeping only the
               (T, d) block boundaries and the summed ladj;
      sweep 2  walk the chain backwards; re-run each block's inverse from
               its stored boundary and pull the cotangent through it.
    """
    ts = list(reversed(flow_p.transforms))  # order of application
    with torch.no_grad():
        ys = [z2d]
        lp_sum = torch.zeros(z2d.shape[:-1], dtype=z2d.dtype,
                             device=z2d.device)
        x = z2d
        for t in ts:
            x, ladj = _block_inverse_2d(t, x)
            ys.append(x)
            lp_sum = lp_sum + ladj
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        lp_t = log_density(xx)
        (g,) = torch.autograd.grad(lp_t.sum(), xx)
    lp = lp_t.detach()[:, None] + lp_sum[:, None]
    one_ladj = torch.ones(z2d.shape[:-1], dtype=z2d.dtype, device=z2d.device)
    for i in range(len(ts) - 1, -1, -1):
        with torch.enable_grad():
            y = ys[i].detach().requires_grad_(True)
            out, ladj = _block_inverse_2d(ts[i], y)
            # a Standardize's or Whiten's ladj does not depend on y
            pairs = [(o, c) for o, c in ((out, g), (ladj, one_ladj))
                     if o.requires_grad]
            (g,) = torch.autograd.grad([o for o, _ in pairs], y,
                                       [c for _, c in pairs])
    return lp, g
