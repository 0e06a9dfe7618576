"""Split Gelman-Rubin R-hat (port of `tpuflows/diagnostics/rhat.py`)."""
from __future__ import annotations

import torch


def split_rhat(samples: torch.Tensor) -> torch.Tensor:
    """samples: (n_draws, n_chains, d) -> (d,) split-R-hat."""
    n, m, d = samples.shape
    half = n // 2
    x = torch.cat([samples[:half], samples[half:2 * half]], dim=1)
    nn = half
    chain_mean = torch.mean(x, dim=0)  # (2m, d)
    chain_var = torch.var(x, dim=0, correction=1)  # (2m, d)
    w = torch.mean(chain_var, dim=0)
    b = nn * torch.var(chain_mean, dim=0, correction=1)
    var_plus = (nn - 1.0) / nn * w + b / nn
    return torch.sqrt(var_plus / w)
