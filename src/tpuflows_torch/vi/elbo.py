"""Variational inference with the flow as variational family (port of
`tpuflows/vi/elbo.py`).

ELBO = E_{z~N(0,I)}[log p(f^-1(z)) + ladj_{f^-1}(z)] + H(N(0, I)). The fit
is `optimize_flow_reverse_kl`; this module adds the ELBO estimator, the
variational density q(x) and sampling from the fitted family.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from tpuflows_torch.flows.core import Bijector
from tpuflows_torch.flows.train import (Adam, TrainResult,
                                        optimize_flow_reverse_kl)
from tpuflows_torch.targets.base import std_normal_logpdf
from tpuflows_torch.util.device import f32_device


class VIResult(NamedTuple):
    flow: Bijector
    elbo_hist: torch.Tensor  # (nsteps,) running ELBO estimates
    final_elbo: torch.Tensor  # 0-d


def _base_entropy(dim: int) -> float:
    return 0.5 * dim * (1.0 + math.log(2.0 * math.pi))


@torch.no_grad()
def _elbo_on(z: torch.Tensor, flow: Bijector,
             log_density: Callable) -> torch.Tensor:
    x, ladj = flow.inverse_and_ladj(z)
    return torch.mean(log_density(x) + ladj) + _base_entropy(z.shape[-1])


def elbo(generator: torch.Generator, flow: Bijector, log_density: Callable,
         dim: int, n: int = 4096, device="cuda") -> torch.Tensor:
    """Monte-Carlo ELBO of the flow family against `log_density` (0-d
    tensor on `device`)."""
    dev = f32_device(device)
    z = torch.randn((n, dim), generator=generator, device=dev)
    return _elbo_on(z, flow, log_density)


@torch.no_grad()
def vi_sample(generator: torch.Generator, flow: Bijector, dim: int, n: int,
              device="cuda") -> torch.Tensor:
    """n draws from the variational posterior q = f^-1 # N(0, I)."""
    dev = f32_device(device)
    z = torch.randn((n, dim), generator=generator, device=dev)
    return flow.inverse(z)


def vi_log_q(flow: Bijector, x: torch.Tensor) -> torch.Tensor:
    """log q(x) of the flow family: log N(f(x); 0, I) + log|det df/dx|."""
    z, ladj = flow.forward_and_ladj(x)
    return std_normal_logpdf(z) + ladj


def _vi_result(res: TrainResult, log_density: Callable, stl: bool,
               z_eval: torch.Tensor) -> VIResult:
    """The ELBO history of a reverse-KL fit and the final ELBO on z_eval.
    The STL loss is -(ELBO estimate) itself; the plain loss lacks the base
    entropy."""
    dim = z_eval.shape[-1]
    hist = (-res.loss_hist if stl
            else -res.loss_hist + _base_entropy(dim))
    return VIResult(res.result, hist,
                    _elbo_on(z_eval, res.result, log_density))


def fit_vi(
    generator: torch.Generator,
    log_density: Callable,
    flow: Bijector,
    dim: int,
    optimizer: Optional[Adam] = None,
    batch_size: int = 512,
    nsteps: int = 1000,
    anneal_steps: int = 0,
    stl: bool = False,
    chunk_size: Optional[int] = None,
    device="cuda",
) -> VIResult:
    """Fit the flow as a VI family by maximizing the ELBO (reverse KL,
    `optimize_flow_reverse_kl`; `anneal_steps` ramps the target's
    temperature, `stl` takes the sticking-the-landing estimator,
    `chunk_size` is ignored), then estimate the final ELBO on 4096 base
    draws, all from `generator`."""
    dev = f32_device(device)
    res = optimize_flow_reverse_kl(
        generator, log_density, flow, dim, optimizer=optimizer,
        batch_size=batch_size, nsteps=nsteps, anneal_steps=anneal_steps,
        stl=stl, chunk_size=chunk_size, device=dev)
    z_eval = torch.randn((4096, dim), generator=generator, device=dev)
    return _vi_result(res, log_density, stl, z_eval)
