"""Evidence (marginal likelihood) estimators (port of
`tpuflows/integration/evidence.py`, after BAT.jl's `bat_integrate`). A
fitted flow is a normalized density with an exact log density, so:

  1. `log_evidence_is`: importance sampling with the flow as proposal,
     log Z = logsumexp(log p(x_i) - log q(x_i)) - log n, x_i ~ q, with the
     weights' ESS;
  2. `log_evidence_bridge`: the Meng & Wong (1996) optimal bridge between
     q and p on flow draws and posterior draws, a fixed number of
     fixed-point iterations (BridgeSampling.jl's algorithm);
  3. `log_evidence_harmonic`: the reciprocal harmonic mean on posterior
     draws with the flow as the auxiliary density h,
     1/Z = E_p[h(x) / p*(x)].

All in log space, in float32. The estimators that draw from the flow take
their base draws z from a `torch.Generator`; `_is_math` and
`_bridge_math` take them as tensors, so tests can hand them the JAX
package's.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from tpuflows_torch.diagnostics import importance_weight_ess
from tpuflows_torch.flows.core import Bijector
from tpuflows_torch.targets.base import std_normal_logpdf
from tpuflows_torch.vi.elbo import vi_log_q as _flow_log_q


class EvidenceResult(NamedTuple):
    log_z: torch.Tensor  # 0-d
    ess: torch.Tensor  # importance-weight ESS (n for a perfect q)
    n: int


def _base_draws(generator, n, dim):
    return torch.randn((n, dim), generator=generator,
                       device=generator.device)


@torch.no_grad()
def _is_math(z, log_density: Callable, flow: Bijector) -> EvidenceResult:
    n = z.shape[0]
    x, ladj = flow.inverse_and_ladj(z)
    log_q = std_normal_logpdf(z) - ladj  # ladj_fwd(x) = -ladj_inv(z)
    log_w = log_density(x) - log_q
    log_z = torch.logsumexp(log_w, dim=0) - math.log(float(n))
    return EvidenceResult(log_z=log_z, ess=importance_weight_ess(log_w), n=n)


def log_evidence_is(generator: torch.Generator, log_density: Callable,
                    flow: Bijector, dim: int, n: int = 8192
                    ) -> EvidenceResult:
    """Flow importance sampling, x ~ q = flow.inverse # N(0, I), the draws
    on `generator`'s device."""
    return _is_math(_base_draws(generator, n, dim), log_density, flow)


@torch.no_grad()
def log_evidence_harmonic(log_density: Callable, flow: Bijector,
                          posterior_samples: torch.Tensor) -> torch.Tensor:
    """The harmonic mean with the flow as auxiliary density h:
    1/Z = E_{x~p}[h(x) / p*(x)] (p* unnormalized); finite variance where
    h has lighter tails than p."""
    x = posterior_samples
    log_h = _flow_log_q(flow, x)
    log_inv_z = (torch.logsumexp(log_h - log_density(x), dim=0)
                 - math.log(float(x.shape[0])))
    return -log_inv_z


@torch.no_grad()
def _bridge_math(z, log_density: Callable, flow: Bijector,
                 posterior_samples, n_iter: int = 32) -> EvidenceResult:
    n1 = posterior_samples.shape[0]
    n2 = z.shape[0]
    log_s1 = math.log(n1 / (n1 + n2))
    log_s2 = math.log(n2 / (n1 + n2))
    x_q, ladj = flow.inverse_and_ladj(z)
    # l = log p*(x) - log q(x) on both sample sets
    l1 = log_density(posterior_samples) - _flow_log_q(flow,
                                                      posterior_samples)
    l2 = log_density(x_q) - (std_normal_logpdf(z) - ladj)

    r = torch.logsumexp(l2, dim=0) - math.log(float(n2))  # the IS start
    for _ in range(n_iter):
        # numerator: E_q[p* / (s1 p* + s2 q Z)], in log space
        num = torch.logsumexp(
            l2 - torch.logaddexp(log_s1 + l2, log_s2 + r), dim=0
        ) - math.log(float(n2))
        den = torch.logsumexp(
            -torch.logaddexp(log_s1 + l1, log_s2 + r), dim=0
        ) - math.log(float(n1))
        r = num - den
    # the ESS of the q-side weights is the quality diagnostic
    return EvidenceResult(log_z=r, ess=importance_weight_ess(l2), n=n2)


def log_evidence_bridge(generator: torch.Generator, log_density: Callable,
                        flow: Bijector, posterior_samples: torch.Tensor,
                        n_proposal: int = 8192, n_iter: int = 32
                        ) -> EvidenceResult:
    """Meng-Wong optimal bridge sampling between the flow q and the target:
    posterior draws x_1..x_N1 (given) and flow draws y_1..y_N2, l = log p*
    - log q on each, and the fixed point r <- log mean_j[w(y_j)] -
    log mean_i[1/w'(x_i)] of the optimal bridge h propto p* q /
    (s1 p* + s2 q e^r), run `n_iter` times from the IS estimate."""
    z = _base_draws(generator, n_proposal, posterior_samples.shape[-1])
    return _bridge_math(z, log_density, flow, posterior_samples, n_iter)
