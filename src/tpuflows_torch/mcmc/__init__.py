from tpuflows_torch.mcmc.nuts import NUTSInfo
from tpuflows_torch.mcmc.dual_averaging import (
    DualAveragingState,
    WelfordState,
    da_init,
    da_step_size,
    da_update,
    welford_init,
    welford_merge,
    welford_update_batch,
    welford_variance,
)
from tpuflows_torch.mcmc.sample import NUTSDriver, NUTSState, stan_window_closes
from tpuflows_torch.mcmc.preconditioned import flow_reparameterized, to_data_space

__all__ = [
    "NUTSInfo",
    "DualAveragingState", "WelfordState", "da_init", "da_step_size",
    "da_update", "welford_init", "welford_merge", "welford_update_batch",
    "welford_variance",
    "NUTSDriver", "NUTSState", "stan_window_closes",
    "flow_reparameterized", "to_data_space",
]
