from tpuflows_torch.diagnostics.ess import (effective_sample_size,
                                            importance_weight_ess)
from tpuflows_torch.diagnostics.moments import (MomentCheck,
                                                family_threshold,
                                                moment_gate)
from tpuflows_torch.diagnostics.rhat import split_rhat

__all__ = ["effective_sample_size", "importance_weight_ess", "split_rhat",
           "MomentCheck", "family_threshold", "moment_gate"]
