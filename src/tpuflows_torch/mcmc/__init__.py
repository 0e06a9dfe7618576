from tpuflows_torch.mcmc.hmc import (HMCInfo, PhasePoint, energy, kinetic,
                                     leapfrog, make_hmc_kernel)
from tpuflows_torch.mcmc.nuts import NUTSInfo, make_nuts_kernel
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
from tpuflows_torch.mcmc.sample import (MCMCResult, NUTSDriver, NUTSState,
                                        nuts_draws, nuts_warmup, run_nuts,
                                        stan_window_closes)
from tpuflows_torch.mcmc.preconditioned import (flow_reparameterized,
                                               to_data_space, to_latent_space)
from tpuflows_torch.mcmc.mh import (MHInfo, MHResult, make_flow_imh_kernel,
                                    make_rwmh_kernel, run_flow_imh, run_rwmh)
from tpuflows_torch.mcmc.ensemble import EnsembleResult, run_ensemble
from tpuflows_torch.mcmc.tempering import (PTInfo, PTResult, geometric_betas,
                                           run_parallel_tempering)

__all__ = [
    "HMCInfo", "PhasePoint", "energy", "kinetic", "leapfrog",
    "make_hmc_kernel",
    "NUTSInfo", "make_nuts_kernel",
    "DualAveragingState", "WelfordState", "da_init", "da_step_size",
    "da_update", "welford_init", "welford_merge", "welford_update_batch",
    "welford_variance",
    "MCMCResult", "NUTSDriver", "NUTSState", "nuts_draws", "nuts_warmup",
    "run_nuts", "stan_window_closes",
    "flow_reparameterized", "to_data_space", "to_latent_space",
    "MHInfo", "MHResult", "make_flow_imh_kernel", "make_rwmh_kernel",
    "run_flow_imh", "run_rwmh",
    "EnsembleResult", "run_ensemble",
    "PTInfo", "PTResult", "geometric_betas", "run_parallel_tempering",
]
