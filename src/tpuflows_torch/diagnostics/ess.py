"""Effective sample size (port of `tpuflows/diagnostics/ess.py`).

Cross-chain ESS (Stan / Vehtari et al. 2021): FFT autocovariances over the
draw axis for all (chain, dim) series at once, the multi-chain (W, B)
variance decomposition, and Geyer's initial monotone positive sequence,
written branch-free. `importance_weight_ess` is the Kish ESS of importance
weights (SMC and the adaptive loop's stopping rule).
"""
from __future__ import annotations

import math

import torch


def _autocovariance(x: torch.Tensor) -> torch.Tensor:
    """Biased autocovariance per series. x: (n, ...) -> (n, ...)."""
    n = x.shape[0]
    xc = x - torch.mean(x, dim=0, keepdim=True)
    nfft = 1 << (2 * n - 1).bit_length()
    f = torch.fft.rfft(xc, n=nfft, dim=0)
    acov = torch.fft.irfft(f * torch.conj(f), n=nfft, dim=0)[:n]
    return acov / n


def effective_sample_size(samples: torch.Tensor) -> torch.Tensor:
    """samples: (n_draws, n_chains, d) -> (d,)."""
    n, m, d = samples.shape
    acov = _autocovariance(samples)  # (n, m, d)
    chain_var = acov[0] * n / (n - 1.0)  # (m, d)
    w = torch.mean(chain_var, dim=0)  # within-chain variance (d,)
    mean_per_chain = torch.mean(samples, dim=0)  # (m, d)
    if m > 1:
        b_over_n = torch.var(mean_per_chain, dim=0, correction=1)
    else:
        b_over_n = torch.zeros_like(w)
    var_plus = w * (n - 1.0) / n + b_over_n

    rho = 1.0 - (w - torch.mean(acov, dim=1)) / var_plus  # (n, d)

    # Geyer: adjacent pairs, truncated at the first negative pair, made
    # monotone non-increasing
    n_pairs = n // 2
    pair = rho[0:2 * n_pairs:2] + rho[1:2 * n_pairs:2]  # (n_pairs, d)
    pos = (pair > 0.0).to(pair.dtype)
    pair = pair * torch.cumprod(pos, dim=0)
    pair = torch.cummin(pair, dim=0).values
    pair = torch.clamp(pair, min=0.0)
    tau = -1.0 + 2.0 * torch.sum(pair, dim=0)
    tau = torch.clamp(tau, min=1.0 / math.log10(float(n * m) + 10.0))
    return (n * m) / tau



def importance_weight_ess(log_weights: torch.Tensor, axis=None):
    """Kish ESS of (log) importance weights: (sum w)^2 / sum w^2, over all
    entries (`axis=None`) or along `axis`."""
    if axis is None:
        w = torch.exp(log_weights - torch.max(log_weights))
        s1, s2 = torch.sum(w), torch.sum(w * w)
    else:
        lw = log_weights - torch.amax(log_weights, dim=axis, keepdim=True)
        w = torch.exp(lw)
        s1, s2 = torch.sum(w, dim=axis), torch.sum(w * w, dim=axis)
    return s1 * s1 / s2
