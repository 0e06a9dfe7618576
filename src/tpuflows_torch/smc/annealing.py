"""Adaptive annealing schedule for SMC (port of `tpuflows/smc/annealing.py`):
the inverse temperature beta goes from 0 to 1 in steps chosen so that each
stage's incremental weights keep a target relative ESS, found by
bisection.

The bisection runs a fixed 60 halvings of [beta, 1] in float32 on the
device, with `torch.where` for each decision, so it makes no host read.
"""
from __future__ import annotations

import torch

from tpuflows_torch.diagnostics import importance_weight_ess


def relative_ess(log_w_inc: torch.Tensor) -> torch.Tensor:
    """Kish ESS / n of incremental log weights."""
    return importance_weight_ess(log_w_inc) / log_w_inc.shape[0]


def next_beta(beta, log_ratio: torch.Tensor, target_rel_ess: float = 0.5,
              n_bisect: int = 60) -> torch.Tensor:
    """The largest beta' in (beta, 1] with relative ESS of
    (beta' - beta) * log_ratio at least `target_rel_ess`, by bisection; 1
    where beta' = 1 already clears it. A 0-d float32 tensor on
    log_ratio's device.

    `log_ratio` is log p_1(x_i) - log p_0(x_i) per particle. Left out:
    `axis_name` and `n_global` (the sharded ESS, ROADMAP Queue 1 item
    11)."""
    dev = log_ratio.device
    beta = torch.as_tensor(beta, dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    n = log_ratio.shape[0]

    def ess_at(b):
        return importance_weight_ess((b - beta) * log_ratio) / n

    full = ess_at(one) >= target_rel_ess
    lo, hi = beta, one
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        ok = ess_at(mid) >= target_rel_ess
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return torch.where(full, one, lo)
