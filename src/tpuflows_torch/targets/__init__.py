from tpuflows_torch.targets.base import Target, logdensityof, std_normal_logpdf
from tpuflows_torch.targets.banana import Banana, Rosenbrock
from tpuflows_torch.targets.correlated import CorrelatedGaussian
from tpuflows_torch.targets.funnel import NealsFunnel
from tpuflows_torch.targets.gaussian import DiagNormal, StandardNormal
from tpuflows_torch.targets.mixture import GaussianMixture

__all__ = ["Target", "logdensityof", "std_normal_logpdf", "Banana",
           "CorrelatedGaussian", "DiagNormal", "GaussianMixture",
           "NealsFunnel", "Rosenbrock", "StandardNormal"]
