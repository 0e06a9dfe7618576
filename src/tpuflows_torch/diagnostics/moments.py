"""The Monte-Carlo-sigma moment gate (port of
`tpuflows/diagnostics/moments.py`): draws' means and variances against
known moments, with standard errors from the ESS, not the raw draw count,
so autocorrelated MCMC output is judged honestly.
"""
from __future__ import annotations

from statistics import NormalDist
from typing import NamedTuple

import torch

from tpuflows_torch.diagnostics.ess import effective_sample_size


class MomentCheck(NamedTuple):
    passed: bool
    max_sigma_mean: float  # worst |mean error| / MC s.e.
    max_sigma_var: float  # worst |var error| / MC s.e. of the variance
    ess_min: float
    threshold: float = 3.0  # the threshold `passed` was judged against


def family_threshold(n_sigma: float, n_comparisons: int) -> float:
    """Threshold t* at which a correct sampler fails the max-over-m test as
    often as one comparison fails the n_sigma test: m P(|Z| > t*) =
    P(|Z| > n_sigma) (Bonferroni). The max of 2 x 256 null z-scores
    concentrates near 3, so 'max z < 3' alone would reject a perfect
    sampler about half the time."""
    nd = NormalDist()
    p_single = 2.0 * (1.0 - nd.cdf(n_sigma))
    return float(nd.inv_cdf(1.0 - p_single / n_comparisons / 2.0))


def moment_gate(samples, true_mean, true_var, n_sigma: float = 3.0,
                ess: float | None = None,
                family_correction: bool = False) -> MomentCheck:
    """The n-sigma gate on every dimension's mean and variance.

    samples: (n_draws, n_chains, d) or (n, d); true_mean and true_var
    broadcast to (d,). Reductions run in float32, as the JAX package's do
    on float32 draws. The ESS of x (for the mean) and of x^2 (for the
    variance) is clipped to [2, n_draws n_chains]: an antithetic kernel can
    push it past the draw count, where the Gaussian formula no longer
    holds. The variance's standard error comes from the empirical fourth
    moment, Var(s^2) ~ (m4 - var^2) / n_eff, floored at the Gaussian
    2 var^2 / n_eff. `family_correction=True` judges the worst z-score
    against `family_threshold(n_sigma, 2 d)`."""
    s = torch.as_tensor(samples, dtype=torch.float32)
    if s.ndim == 2:
        s = s[:, None, :]
    n, m, d = s.shape
    flat = s.reshape(n * m, d)
    if ess is None:
        ess_d = effective_sample_size(s)
        ess_v = effective_sample_size(s * s)
    else:
        ess_d = torch.full((d,), float(ess), device=s.device)
        ess_v = ess_d
    ess_d = torch.clamp(ess_d, 2.0, n * m)
    ess_v = torch.clamp(ess_v, 2.0, n * m)

    mean = torch.mean(flat, dim=0)
    var = torch.var(flat, dim=0, correction=0)
    tm = torch.as_tensor(true_mean, dtype=torch.float32, device=s.device)
    tv = torch.as_tensor(true_var, dtype=torch.float32, device=s.device)

    se_mean = torch.sqrt(tv / ess_d)
    m4 = torch.mean((flat - mean) ** 4, dim=0)
    se_var = torch.sqrt(torch.maximum(m4 - var * var, 2.0 * tv * tv)
                        / ess_v)
    sig_mean = torch.abs(mean - tm) / torch.clamp(se_mean, min=1e-12)
    sig_var = torch.abs(var - tv) / torch.clamp(se_var, min=1e-12)
    thr = family_threshold(n_sigma, 2 * d) if family_correction else n_sigma
    return MomentCheck(
        passed=bool((sig_mean < thr).all() and (sig_var < thr).all()),
        max_sigma_mean=float(sig_mean.max()),
        max_sigma_var=float(sig_var.max()),
        ess_min=float(ess_d.min()),
        threshold=float(thr),
    )
