"""Whole SMC runs of the port against the JAX package's, on the CPU: c5's
recipe cut to d = 18 and 2,048 particles (an affine leading-mask flow,
hidden (32, 32), pretrained 60 epochs on 4,096 prior draws, then 5 sweeps
of 8 leapfrog steps a stage, target relative ESS 0.8, a retrain every two
stages, 8 equilibration stages), from the same flow (the JAX flow carried
across), under "freeze" here; under "reweight" with the cross-fitted
switch in `tests/test_torch_smc_reweight.py` and with the fit-on-all one
in `tests/test_torch_smc_fit_on_all.py` (one run of each package a file,
about 45 s, so the files run side by side).

The two runs draw other random numbers, so they agree in distribution.
Both must reach beta = 1. The port's log Z must lie within 4 sigma + 0.05
of the quadrature truth (`scripts/config5_artifact.py`'s gate) and
within 4 sqrt(sigma_jax^2 + sigma_port^2) + 0.05 of the JAX run's. Both
runs' particles must pass the family-corrected moment gate at 3 sigma
with the measured ESS (`smc_measured_ess`). With 4 equilibration stages
and a 20-epoch pretrain the JAX package's own runs miss that gate
(log_tau's variance ratio 0.73-0.76 on two seeds), so the cut keeps c5's
8 and 60. The JAX log Z is not held to the truth: on this seed its
cross-fitted run lands 0.245 below it (4 sigma + 0.05 = 0.232), the
port's 0.009 (seeds 3 and 4: JAX 0.053 and 0.125, the port 0.022 and
0.039). The fit-on-all switch sits 0.10-0.19 above the truth in both
packages over seeds 2-4, the adaptive-overfit bias `SMCConfig` names,
inside the gate at 2,048 particles.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpuflows.diagnostics import moment_gate as j_moment_gate
from tpuflows.flows import build_flow as j_build_flow
from tpuflows.flows import optimize_flow as j_fit
from tpuflows.smc import SMCConfig as JSMCConfig
from tpuflows.smc import run_smc as j_run_smc
from tpuflows.smc import smc_measured_ess as j_measured_ess
from tpuflows.targets import HierarchicalGaussian as JHier

from tpuflows_torch.diagnostics import moment_gate
from tpuflows_torch.smc import SMCConfig, run_smc, smc_measured_ess
from tpuflows_torch.targets import HierarchicalGaussian

from test_torch_coupling import carry

D, N = 18, 2048
CFG = dict(n_particles=N, n_mutation_steps=5, n_leapfrog=8,
           target_rel_ess=0.8, max_stages=100, retrain_every=2,
           final_equilibration_stages=8)
MODES = {"freeze": dict(retrain_mode="freeze"),
         "reweight_cross_fit": dict(retrain_mode="reweight"),
         "reweight_fit_on_all": dict(retrain_mode="reweight",
                                     reweight_cross_fit=False)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def problem():
    jt = JHier.standard(dim=D)
    prior = jt.sample_prior(jax.random.key(0), 4096)
    jf = j_build_flow(prior, jax.random.key(1), kind="affine", n_blocks=2,
                      hidden=(32, 32), mask_scheme="leading", n_leading=2,
                      clamp=8.0)
    jf = j_fit(jax.random.key(1), prior, jf, optax.adam(2e-3), nbatches=8,
               nepochs=60).result
    return jt, HierarchicalGaussian.standard(dim=D, device="cpu"), jf


def compare_runs(problem, mode):
    jt, tt, jf = problem
    cfg = dict(CFG, **MODES[mode])
    jres = j_run_smc(jax.random.key(2), jt.log_density, jf, D,
                     JSMCConfig(**cfg))
    tres = run_smc(torch.Generator().manual_seed(2), tt.log_density,
                   carry(jf), D, SMCConfig(**cfg), device="cpu")
    truth = tt.log_evidence()
    assert truth == jt.log_evidence()
    sig_j = max(float(jres.log_z_sigma), 1e-6)
    sig_t = max(float(tres.log_z_sigma), 1e-6)
    assert float(jres.betas[-1]) == 1.0 and float(tres.betas[-1]) == 1.0
    assert abs(float(tres.log_z) - truth) < 4.0 * sig_t + 0.05
    assert (abs(float(tres.log_z) - float(jres.log_z))
            < 4.0 * np.hypot(sig_j, sig_t) + 0.05)
    jgate = j_moment_gate(jres.particles, jt.mean(), jnp.diag(jt.cov()),
                          ess=j_measured_ess(jres), family_correction=True)
    tgate = moment_gate(tres.particles, tt.mean("cpu"),
                        torch.diagonal(tt.cov("cpu")),
                        ess=smc_measured_ess(tres), family_correction=True)
    assert jgate.passed, jgate
    assert tgate.passed, tgate
    assert tres.ancestors.dtype == torch.int32
    assert tres.unique_ancestors == int(torch.unique(tres.ancestors).numel())
    # the stage counts come from the same ESS bisection on similar weights
    assert abs(tres.n_stages - jres.n_stages) <= 3


def test_freeze_matches_jax(problem):
    compare_runs(problem, "freeze")
