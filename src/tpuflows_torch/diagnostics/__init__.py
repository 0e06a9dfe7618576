from tpuflows_torch.diagnostics.ess import effective_sample_size
from tpuflows_torch.diagnostics.rhat import split_rhat

__all__ = ["effective_sample_size", "split_rhat"]
