from tpuflows_torch.targets.base import Target, logdensityof, std_normal_logpdf
from tpuflows_torch.targets.banana import Banana, Rosenbrock
from tpuflows_torch.targets.cauchy import MultimodalCauchy
from tpuflows_torch.targets.correlated import CorrelatedGaussian
from tpuflows_torch.targets.funnel import NealsFunnel
from tpuflows_torch.targets.gaussian import DiagNormal, StandardNormal
from tpuflows_torch.targets.hierarchical import HierarchicalGaussian
from tpuflows_torch.targets.mixture import GaussianMixture
from tpuflows_torch.targets.posterior import (Beta, Exponential, HalfNormal,
                                              IndependentPrior, LogNormal,
                                              Normal, Posterior, Uniform,
                                              find_mode)

__all__ = ["Target", "logdensityof", "std_normal_logpdf", "Banana",
           "CorrelatedGaussian", "DiagNormal", "GaussianMixture",
           "HierarchicalGaussian", "MultimodalCauchy", "NealsFunnel",
           "Rosenbrock", "StandardNormal", "IndependentPrior", "Posterior",
           "Normal", "LogNormal", "Exponential", "HalfNormal", "Uniform",
           "Beta", "find_mode"]
