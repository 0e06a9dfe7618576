"""Affine-invariant ensemble sampler, the Goodman & Weare stretch move (port
of `tpuflows/mcmc/ensemble.py`).

The walkers are split into two fixed halves, and each half moves in
lockstep against the other: two dense batched updates per step, no loop
over walkers. Stretch move: a partner x_j from the other half, the
proposal y = x_j + z (x_k - x_j) with z ~ g(z) propto 1/sqrt(z) on
[1/a, a] (z = ((a - 1) u + 1)^2 / a), accepted with probability
min(1, z^(d-1) p(y) / p(x_k)). Gradient-free.

`_half_step_math` takes a half-step's draws as tensors (the stretch
uniforms, the partner indices, the acceptance uniforms), so tests can
hand it the JAX package's; `_half_step` draws them from a
`torch.Generator`.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class EnsembleResult(NamedTuple):
    samples: torch.Tensor  # (num_samples, n_walkers, d) post-warmup states
    accept_rate: torch.Tensor  # 0-d mean acceptance over the draws
    final_walkers: torch.Tensor  # (n_walkers, d)


def _half_step_math(movers, others, log_density, logp_movers, a, u, j,
                    u_acc):
    """Stretch-move update of `movers` (m, d) against `others` (m2, d),
    with u (m,) uniforms for the stretch, j (m,) partner indices into
    `others` and u_acc (m,) acceptance uniforms. Returns (movers,
    logp_movers, accepted)."""
    d = movers.shape[-1]
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    partners = others[j]
    prop = partners + z[:, None] * (movers - partners)
    logp_prop = log_density(prop)
    log_accept = (d - 1.0) * torch.log(z) + logp_prop - logp_movers
    accepted = torch.log(u_acc) < log_accept
    movers = torch.where(accepted[:, None], prop, movers)
    logp_movers = torch.where(accepted, logp_prop, logp_movers)
    return movers, logp_movers, accepted


def _half_step(generator, movers, others, log_density, logp_movers, a):
    m = movers.shape[0]
    dev = movers.device
    u = torch.rand((m,), generator=generator, device=dev)
    j = torch.randint(0, others.shape[0], (m,), generator=generator,
                      device=dev)
    u_acc = torch.rand((m,), generator=generator, device=dev)
    return _half_step_math(movers, others, log_density, logp_movers, a, u,
                           j, u_acc)


@torch.no_grad()
def _ensemble_run(log_density, walkers0, num_warmup, num_samples, a,
                  half_step):
    """The run on given half-steps: `half_step(t, half, movers, others,
    logp_movers)` is step t's update of half 0 (the first n/2 walkers)
    or 1."""
    n_walkers = walkers0.shape[0]
    half = n_walkers // 2
    w, logp = walkers0, log_density(walkers0)
    traj, accs = [], []
    for t in range(num_warmup + num_samples):
        w_a, w_b = w[:half], w[half:]
        lp_a, lp_b = logp[:half], logp[half:]
        w_a, lp_a, acc_a = half_step(t, 0, w_a, w_b, lp_a)
        w_b, lp_b, acc_b = half_step(t, 1, w_b, w_a, lp_b)
        w = torch.cat([w_a, w_b], dim=0)
        logp = torch.cat([lp_a, lp_b], dim=0)
        if t >= num_warmup:
            traj.append(w)
            accs.append(torch.mean(torch.cat([acc_a, acc_b]).float()))
    return EnsembleResult(samples=torch.stack(traj),
                          accept_rate=torch.mean(torch.stack(accs)),
                          final_walkers=w)


def run_ensemble(generator: torch.Generator, log_density: Callable,
                 walkers0: torch.Tensor, num_warmup: int = 200,
                 num_samples: int = 500, a: float = 2.0) -> EnsembleResult:
    """Run the ensemble from (n_walkers, d) initial states, on their
    device (`generator` on it too).

    n_walkers must be even (the two halves) and should be >= 2 d for
    healthy mixing."""
    if walkers0.shape[0] % 2 != 0:
        raise ValueError("n_walkers must be even")

    def half_step(_, __, movers, others, logp_movers):
        return _half_step(generator, movers, others, log_density,
                          logp_movers, a)

    return _ensemble_run(log_density, walkers0, num_warmup, num_samples, a,
                         half_step)
