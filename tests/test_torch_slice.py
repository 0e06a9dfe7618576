"""The whole slice on the CPU at a small size: `chip_smoke.main_path` (the
path the chip run drives at full width), through the port's entry points.

  * the ceiling variant with d = 8, 64 chains and an MLP 8-16-16-16: a
    200-step reverse-KL/STL fit, 64 warmup steps and one draw window of
    64; the funnel's v must pass the 3-MC-sigma moment gate against N(0, 9);
  * the generic variant (the arqs flow, 3 x (affine + spline), mixed
    masks) with d = 4, K = 4, MLPs 4-8-8-*, 32 chains, a 200-step fit, 32
    warmup steps and one window of 32: the pipeline, its launch bookkeeping
    and the fit's quality (at this size the gates need more draws than a
    CPU test affords; the card runs them at full size).

On the CPU every transition and every spline runs its plain version, so
the launch counters of K1, K4 and K5 stay 0.
"""
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def test_slice_runs_end_to_end_on_the_cpu():
    torch.manual_seed(0)
    res, flow, warm_state = chip_smoke.main_path(
        "cpu", dim=8, n_chains=64, hidden=(16, 16), train_steps=200,
        train_batch=256, num_warmup=64, window=64, max_windows=1,
        ess_gate=100.0)
    assert res["launches"] == 0
    assert res["transitions"] == 128 and res["n_draws"] == 64
    assert res["converged"], res
    assert math.isfinite(res["final_elbo"]) and res["final_elbo"] < 0.5
    assert 0.0 < res["step_size"] < 3.0
    assert res["divergence_rate"] < 0.05
    assert res["v_z_mean"] < 3.0 and res["v_z_var"] < 3.0, res
    assert warm_state.q.shape == (64, 8)
    assert torch.isfinite(warm_state.inv_mass).all()


def test_generic_slice_runs_end_to_end_on_the_cpu():
    torch.manual_seed(0)
    res, flow, warm_state = chip_smoke.main_path(
        "cpu", variant="generic", dim=4, n_chains=32, hidden=(8, 8),
        train_steps=200, train_batch=256, num_warmup=32, window=32,
        max_windows=1, ess_gate=50.0, knots=4)
    assert res["modules"] == 7 and res["launches"] == 0
    assert res["rqs_launches"] == res["rqs_launches_expected"] == {
        "k4_forward": 0, "k4_inverse": 0, "k5_forward": 0, "k5_inverse": 0}
    assert res["transitions"] == 64 and res["n_draws"] == 32
    assert math.isfinite(res["final_elbo"]) and res["final_elbo"] > -0.5
    assert sum(res["tree_depth_histogram"]) == 32 * 32
    assert res["v_z_mean"] < 5.0 and res["v_z_var"] < 5.0, res
    assert warm_state.q.shape == (32, 4)
    assert torch.isfinite(warm_state.inv_mass).all()


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("name,key", [
    ("_ZN55_GLOBAL__N__bba1580c_18_nuts_transition_cu_1b91165b_19517nuts_"
     "chain_kernelILi6EEEvN13tpuflows_nuts4ArgsENS0_9ChainListE",
     "chain d/32=6"),
    ("_ZN46_GLOBAL__N__6ef3eb06_13_rqs_spline_cu_57cc75a015rqs_grad_"
     "kernelILb0EEEvPKfS2_S2_S2_PfS3_xif", "K5 forward"),
    ("_ZN46_GLOBAL__N__6ef3eb06_13_rqs_spline_cu_57cc75a015rqs_eval_"
     "kernelILb1EEEvPKfS2_PfS3_xif", "K4 inverse")])
def test_ptxas_summary_names_every_kernel(name, key):
    log = (f"ptxas info    : Compiling entry function '{name}' for "
           "'sm_90a'\n    0 bytes stack frame, 0 bytes spill stores, 0 "
           "bytes spill loads\nptxas info    : Used 48 registers, used 0 "
           "barriers\n")
    assert chip_smoke.ptxas_summary(log) == {key: {
        "spill_stores": 0, "spill_loads": 0, "registers": 48,
        "static_smem": 0}}


def test_ptxas_summary_reads_nvcc_output():
    log = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122"
           "nuts_transition_kernelILi2EEEvNS_4ArgsE' for 'sm_90a'\n"
           "    136 bytes stack frame, 244 bytes spill stores, 296 bytes "
           "spill loads\n"
           "ptxas info    : Used 255 registers, used 0 barriers\n")
    assert chip_smoke.ptxas_summary(log) == {"d/32=2": {
        "spill_stores": 244, "spill_loads": 296, "registers": 255,
        "static_smem": 0}}


@pytest.mark.parametrize("schedule,adapt_mass", [("single", True),
                                                 ("stan", True),
                                                 ("single", False)])
def test_driver_warmup_schedules(schedule, adapt_mass):
    """NUTSDriver's warmup under both window schedules, and with the metric
    left alone; then a draw window continues the same chains."""
    from tpuflows_torch.flows import build_flow
    from tpuflows_torch.kernels.nuts_cuda import fused_nuts_for_flow
    from tpuflows_torch.mcmc import NUTSDriver
    from tpuflows_torch.targets import NealsFunnel

    g = torch.Generator().manual_seed(1)
    target = NealsFunnel(dim=4, sigma_v=1.0)
    flow = build_flow(torch.randn(256, 4, generator=g), g, kind="affine",
                      n_blocks=1, hidden=(8, 8), mask_scheme="leading",
                      clamp=8.0, device="cpu")
    driver = NUTSDriver(fused_nuts_for_flow(target, flow, max_depth=3),
                        adapt_mass=adapt_mass, warmup_schedule=schedule)
    state = driver.warmup(g, torch.randn(16, 4, generator=g), 60)
    assert torch.isfinite(state.q).all() and float(state.step_size) > 0
    unit = torch.equal(state.inv_mass, torch.ones(4))
    assert unit != adapt_mass
    new, z, info = driver.draws(g, state, 5)
    assert z.shape == (5, 16, 4) and torch.equal(new.q, z[-1])
    assert info.num_steps.shape == (5, 16)
    assert new.step_size is state.step_size


def test_driver_refuses_an_unknown_schedule():
    from tpuflows_torch.mcmc import NUTSDriver

    with pytest.raises(ValueError):
        NUTSDriver(lambda *a: None, warmup_schedule="doubling")


def test_kernel_shape_sweep_runs_on_the_cpu():
    """The chip run's shape sweep, on the CPU at two small shapes: there
    both sides are the plain version, so this checks the sweep's own code
    (leading and random masks, widths, depths) and the bar's bookkeeping."""
    rows = chip_smoke.kernel_shapes(
        "cpu", shapes=[(8, 16, 32, 3, 0.3, 16, "leading"),
                       (12, 8, 8, 5, 0.1, 8, "random")])
    assert [(r["d"], r["mask"]) for r in rows] == [(8, "leading"),
                                                  (12, "random")]
    assert all(r["passed"] and r["flips"] == 0 and r["max_dq"] == 0.0
               for r in rows)
    assert sum(rows[1]["depth_histogram"]) == 8
