"""Hamiltonian Monte Carlo: leapfrog integrator and fixed-length HMC (port
of `tpuflows/mcmc/hmc.py`).

The JAX package writes its kernels on one chain's (d,) vector and vmaps
them; here the chain axis is written out: positions are (n, d), the
log density and the acceptance statistics (n,). The mass matrix is
diagonal, given as `inv_mass` (d,) (Stan's convention: it approximates the
posterior's variances). A step size is 0-d (pooled) or (n,) (one per
chain).

Each transition is split in two: a math function that takes its
randomness as tensors (`hmc_transition_math`: the momenta p0 and the
acceptance uniforms u), and the transition `make_hmc_kernel` returns,
which draws them from a `torch.Generator` and calls it. The tests feed the
math function the JAX package's own draws.

A gradient hook `logp_and_grad(q (n, d)) -> (lp (n,), g (n, d))` replaces
autograd (`value_and_grad`); `kernels.fused_logp_cuda` gives one for
flow-preconditioned funnels.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class PhasePoint(NamedTuple):
    q: torch.Tensor  # position (n, d)
    p: torch.Tensor  # momentum (n, d)
    logp: torch.Tensor  # log density at q, (n,)
    grad: torch.Tensor  # d logp / dq, (n, d)


def kinetic(p: torch.Tensor, inv_mass: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.sum(p * p * inv_mass, dim=-1)


def energy(z: PhasePoint, inv_mass: torch.Tensor) -> torch.Tensor:
    return -z.logp + kinetic(z.p, inv_mass)


def step_column(eps, q: torch.Tensor) -> torch.Tensor:
    """A step size as a tensor that broadcasts against (n, d): 0-d if
    pooled, (n, 1) if one per chain."""
    eps = torch.as_tensor(eps, dtype=q.dtype, device=q.device)
    return eps[:, None] if eps.ndim == 1 else eps


def leapfrog(logp_and_grad: Callable, z: PhasePoint, eps: torch.Tensor,
             inv_mass: torch.Tensor) -> PhasePoint:
    """One leapfrog step (velocity Verlet) of every chain. `eps` is 0-d or
    (n, 1) (`step_column`) and may be signed (the direction)."""
    p_half = z.p + 0.5 * eps * z.grad
    q_new = z.q + eps * p_half * inv_mass
    logp_new, grad_new = logp_and_grad(q_new)
    p_new = p_half + 0.5 * eps * grad_new
    return PhasePoint(q=q_new, p=p_new, logp=logp_new, grad=grad_new)


def value_and_grad(log_density: Callable) -> Callable:
    """The default hook: q (n, d) -> (log_density(q) (n,), its gradient)
    by torch.autograd. Valid because every target's log density is
    independent row by row, so the gradient of the sum is each row's."""

    def logp_and_grad(q):
        with torch.enable_grad():
            qq = q.detach().requires_grad_(True)
            lp = log_density(qq)
            (g,) = torch.autograd.grad(lp.sum(), qq)
        return lp.detach(), g

    return logp_and_grad


class HMCInfo(NamedTuple):
    accept_prob: torch.Tensor
    accepted: torch.Tensor
    logp: torch.Tensor
    energy: torch.Tensor


def hmc_transition_math(q, p0, u, eps, inv_mass, logp_and_grad: Callable,
                        num_leapfrog: int):
    """One HMC transition of every chain, with the randomness given: the
    momenta p0 (n, d) ~ N(0, M) and the acceptance uniforms u (n,).
    Returns (q_new (n, d), HMCInfo of (n,) tensors)."""
    eps = step_column(eps, q)
    logp0, grad0 = logp_and_grad(q)
    z0 = PhasePoint(q=q, p=p0, logp=logp0, grad=grad0)
    h0 = energy(z0, inv_mass)
    z1 = z0
    for _ in range(num_leapfrog):
        z1 = leapfrog(logp_and_grad, z1, eps, inv_mass)
    h1 = energy(z1, inv_mass)
    dh = h1 - h0
    dh = torch.where(torch.isfinite(dh), dh, torch.full_like(dh, torch.inf))
    accept_prob = torch.clamp(torch.exp(-dh), max=1.0)
    accepted = u < accept_prob
    q_new = torch.where(accepted[:, None], z1.q, z0.q)
    return q_new, HMCInfo(accept_prob=accept_prob, accepted=accepted,
                          logp=torch.where(accepted, z1.logp, z0.logp),
                          energy=torch.where(accepted, h1, h0))


def make_hmc_kernel(log_density: Callable, num_leapfrog: int = 10,
                    logp_and_grad: Callable | None = None) -> Callable:
    """Fixed-trajectory-length HMC with an MH correction:
    `transition(generator, q (n, d), eps, inv_mass) -> (q_new, HMCInfo)`.
    The momenta and the uniforms are drawn from `generator` on q's device.

    `logp_and_grad` overrides autograd through `log_density`
    (`kernels.fused_logp_cuda.fused_latent_logp_and_grad`)."""
    if logp_and_grad is None:
        logp_and_grad = value_and_grad(log_density)

    def transition(generator, q, eps, inv_mass):
        p0 = torch.randn(q.shape, generator=generator, device=q.device,
                         dtype=q.dtype) / torch.sqrt(inv_mass)
        u = torch.rand(q.shape[0], generator=generator, device=q.device,
                       dtype=q.dtype)
        return hmc_transition_math(q, p0, u, eps, inv_mass, logp_and_grad,
                                   num_leapfrog)

    return transition
