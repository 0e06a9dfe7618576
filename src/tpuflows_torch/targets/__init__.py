from tpuflows_torch.targets.base import Target, logdensityof, std_normal_logpdf
from tpuflows_torch.targets.funnel import NealsFunnel

__all__ = ["Target", "logdensityof", "std_normal_logpdf", "NealsFunnel"]
