"""Reverse-KL flow training (port of the part of `tpuflows/flows/train.py`
that the funnel path runs: `reverse_kl_loss`, the STL loss and
`make_reverse_kl_trainer`), plus `ClipAdamCosine`, the optimizer of
`bench.py` written out.

The JAX trainer runs its steps inside jitted scans. Here a host loop runs
one eager step at a time, with the loss history kept on the device and read
back once per `train` call. Training updates the flow's parameters in place.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from tpuflows_torch.flows.core import Bijector
from tpuflows_torch.targets.base import std_normal_logpdf
from tpuflows_torch.util.device import f32_device


def reverse_kl_loss(flow: Bijector, log_density: Callable,
                    z: torch.Tensor) -> torch.Tensor:
    """KL(q || p) up to the base entropy: E_z[-ladj_inv(z) - log p(f^-1(z))],
    z ~ N(0, I). Also the negative ELBO minus that entropy."""
    x, ladj = flow.inverse_and_ladj(z)
    return -torch.mean(log_density(x) + ladj)


class _ForwardAndLadj(nn.Module):
    """Lets `torch.func.functional_call` evaluate `forward_and_ladj` with
    substituted (detached) parameters."""

    def __init__(self, flow: Bijector):
        super().__init__()
        self.flow = flow

    def forward(self, x):
        return self.flow.forward_and_ladj(x)


def reverse_kl_stl_loss(flow: Bijector, log_density: Callable,
                        z: torch.Tensor) -> torch.Tensor:
    """Sticking-the-landing reverse KL: log q(x) is evaluated with the
    flow's parameters detached, so the gradient flows only through the
    sample path x = f^-1(z). Its value is -(ELBO estimate)."""
    x, _ = flow.inverse_and_ladj(z)
    frozen = {"flow." + k: v.detach() for k, v in flow.named_parameters()}
    z_sg, ladj_fwd = torch.func.functional_call(
        _ForwardAndLadj(flow), frozen, (x,))
    log_q = std_normal_logpdf(z_sg) + ladj_fwd
    return -torch.mean(log_density(x) - log_q)


class AdamState(NamedTuple):
    count: int  # updates applied so far (host integer: no device read)
    mu: list
    nu: list


class ClipAdamCosine:
    """`optax.chain(clip_by_global_norm(max_norm),
    adam(cosine_decay_schedule(lr, decay_steps, alpha)))`, the optimizer of
    `bench.py`, written out in the same order of operations.

    The learning rate of update `count` is computed on the host; the global
    norm, the clip and the moments stay on the device."""

    def __init__(self, lr: float = 1e-2, decay_steps: int = 6000,
                 alpha: float = 0.03, max_norm: float = 10.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.decay_steps, self.alpha = lr, decay_steps, alpha
        self.max_norm, self.b1, self.b2, self.eps = max_norm, b1, b2, eps

    def init(self, params) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    def learning_rate(self, count: int) -> float:
        c = min(count, self.decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / self.decay_steps))
        return self.lr * ((1.0 - self.alpha) * cosine + self.alpha)

    @torch.no_grad()
    def update(self, params, grads, state: AdamState) -> AdamState:
        """Applies one update to `params` in place; returns the new state."""
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = g_norm < self.max_norm
        grads = [torch.where(keep, g, g / g_norm * self.max_norm)
                 for g in grads]
        count = state.count + 1
        mu = [(1.0 - self.b1) * g + self.b1 * m
              for g, m in zip(grads, state.mu)]
        nu = [(1.0 - self.b2) * (g * g) + self.b2 * v
              for g, v in zip(grads, state.nu)]
        c1 = 1.0 - self.b1 ** count
        c2 = 1.0 - self.b2 ** count
        step = -self.learning_rate(state.count)
        for p, m, v in zip(params, mu, nu):
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            p.add_(step * u)
        return AdamState(count, mu, nu)


class TrainResult(NamedTuple):
    result: Bijector  # the trained flow (the same module, updated in place)
    optimizer_state: object
    loss_hist: torch.Tensor  # (nsteps,)


def _check_finite_loss(loss_hist: torch.Tensor) -> None:
    h = loss_hist.detach().cpu()
    if not torch.isfinite(h[-1]):
        bad = int(torch.nonzero(~torch.isfinite(h))[0, 0])
        raise FloatingPointError(
            f"flow training diverged: loss became non-finite at step {bad} "
            f"of {h.numel()} (loss_hist[-1]={float(h[-1])})")


def make_reverse_kl_trainer(
    log_density: Callable,
    dim: int,
    optimizer: ClipAdamCosine,
    batch_size: int = 512,
    stl: bool = False,
    device="cuda",
):
    """Returns `train(generator, flow, nsteps, opt_state=None) ->
    TrainResult`. Each step draws z ~ N(0, I) of shape (batch_size, dim)
    from `generator` on `device` and takes one optimizer step on the
    reverse-KL loss (STL when `stl`)."""
    dev = f32_device(device)

    def train(generator: torch.Generator, flow: Bijector, nsteps: int,
              opt_state: Optional[AdamState] = None) -> TrainResult:
        params = list(flow.parameters())
        if opt_state is None:
            opt_state = optimizer.init(params)
        losses = torch.empty(nsteps, device=dev)
        for i in range(nsteps):
            z = torch.randn((batch_size, dim), generator=generator,
                            device=dev)
            if stl:
                loss = reverse_kl_stl_loss(flow, log_density, z)
            else:
                loss = reverse_kl_loss(flow, log_density, z)
            grads = torch.autograd.grad(loss, params)
            opt_state = optimizer.update(params, grads, opt_state)
            losses[i] = loss.detach()
        _check_finite_loss(losses)
        return TrainResult(flow, opt_state, losses)

    return train
