from tpuflows_torch.smc.annealing import next_beta, relative_ess
from tpuflows_torch.smc.resample import (
    multinomial_indices,
    normalize_log_weights,
    resample,
    systematic_indices,
)
from tpuflows_torch.smc.sampler import (
    SMCConfig,
    SMCResult,
    run_smc,
    smc_measured_ess,
)

__all__ = [
    "next_beta",
    "relative_ess",
    "multinomial_indices",
    "normalize_log_weights",
    "resample",
    "systematic_indices",
    "SMCConfig",
    "SMCResult",
    "run_smc",
    "smc_measured_ess",
]
