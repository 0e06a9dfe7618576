from tpuflows_torch.targets.base import Target, logdensityof, std_normal_logpdf
from tpuflows_torch.targets.correlated import CorrelatedGaussian
from tpuflows_torch.targets.funnel import NealsFunnel
from tpuflows_torch.targets.gaussian import DiagNormal, StandardNormal

__all__ = ["Target", "logdensityof", "std_normal_logpdf",
           "CorrelatedGaussian", "DiagNormal", "NealsFunnel",
           "StandardNormal"]
