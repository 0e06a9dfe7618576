"""The whole slice on the CPU at a small size: `chip_smoke.main_path` (the
path the chip run drives at full width), through the port's entry points.

  * the ceiling variant with d = 8, 64 chains and an MLP 8-16-16-16: a
    200-step reverse-KL/STL fit, 64 warmup steps and one draw window of
    64; the funnel's v must pass the 3-MC-sigma moment gate against N(0, 9);
  * the generic variant (the arqs flow, 3 x (affine + spline), mixed
    masks) with d = 4, K = 4, MLPs 4-8-8-*, 32 chains, a 200-step fit, 32
    warmup steps and one window of 32: the pipeline, its launch bookkeeping
    and the fit's quality (at this size the gates need more draws than a
    CPU test affords; the card runs them at full size); and the same on
    the fused spline tier with a 150-step fit;
  * the chip run's K6/K7 comparison and its bound arithmetic;
  * the portable route on the trained ceiling and generic flows:
    `main_path_portable` (NUTSDriver with K3 as its `logp_and_grad`)
    under the same gates, and the chip run's K3, portable-vs-K1 and HMC
    comparisons, where both sides are plain versions;
  * the window path on the trained ceiling flow: `main_path_window`
    (warmup through K1's plain version, draws through K2's in windows of
    16) under the same gates, and the chip run's K2 comparison, where the
    kernel's side is the plain version too.

On the CPU every transition and every spline runs its plain version, so
the launch counters of K1, K2, K3, K4, K5, K6 and K7 stay 0. The ceiling
and generic main paths run once each for the module (`main_path_once`).
About 3 minutes of CPU on one worker.
"""
import copy
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

CEILING = dict(dim=8, n_chains=64, hidden=(16, 16), train_steps=200,
               train_batch=256, num_warmup=64, window=64, max_windows=1,
               ess_gate=100.0)
GENERIC = dict(variant="generic", dim=4, n_chains=32, hidden=(8, 8),
               train_steps=200, train_batch=256, num_warmup=32, window=32,
               max_windows=1, ess_gate=50.0, knots=4)
_MAIN_PATHS = {}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small ops: one intra-op thread per test worker keeps parallel
    workers from oversubscribing the cores (under the suite's 6 workers
    this file's main paths ran up to 20x their time alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def main_path_once(**kw):
    """`chip_smoke.main_path("cpu", **kw)` after `torch.manual_seed(0)`,
    run once per module for each set of arguments: a deep copy of its
    (res, flow, warm_state), with torch's global generator set where the
    run left it, so that a test goes on exactly as after its own run."""
    key = repr(sorted(kw.items()))
    if key not in _MAIN_PATHS:
        torch.manual_seed(0)
        out = chip_smoke.main_path("cpu", **kw)
        _MAIN_PATHS[key] = (out, torch.get_rng_state())
    out, rng = _MAIN_PATHS[key]
    torch.set_rng_state(rng)
    return copy.deepcopy(out)


def test_slice_runs_end_to_end_on_the_cpu():
    res, flow, warm_state = main_path_once(**CEILING)
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
    res, flow, warm_state = main_path_once(**GENERIC)
    assert res["modules"] == 7 and res["launches"] == 0
    assert res["rqs_launches"] == res["rqs_launches_expected"] == {
        "k4_forward": 0, "k4_inverse": 0, "k5_forward": 0, "k5_inverse": 0}
    assert res["transitions"] == 64 and res["n_draws"] == 32
    assert math.isfinite(res["final_elbo"]) and res["final_elbo"] > -0.5
    assert sum(res["tree_depth_histogram"]) == 32 * 32
    assert res["v_z_mean"] < 5.0 and res["v_z_var"] < 5.0, res
    assert warm_state.q.shape == (32, 4)
    assert torch.isfinite(warm_state.inv_mass).all()


def test_generic_fused_slice_runs_end_to_end_on_the_cpu():
    """The generic variant with every spline block on the fused tier
    (use_pallas="fused", K6/K7 on the card; their plain version here): the
    same pipeline and fit quality, and the launch bookkeeping of both
    spline tiers stays 0 on the CPU."""
    torch.manual_seed(0)
    res, flow, warm_state = chip_smoke.main_path(
        "cpu", variant="generic", dim=4, n_chains=32, hidden=(8, 8),
        train_steps=150, train_batch=256, num_warmup=32, window=32,
        max_windows=1, ess_gate=50.0, knots=4, use_pallas="fused")
    assert res["modules"] == 7 and res["launches"] == 0
    assert res["use_pallas"] == "fused"
    assert all(t.use_pallas == "fused" for t in flow.transforms[2::2])
    zero6 = {"k6_forward": 0, "k6_inverse": 0, "k7_forward": 0,
             "k7_inverse": 0}
    assert res["coupling_launches"] == res["coupling_launches_expected"] \
        == res["coupling_launches_fit"] == zero6
    assert res["rqs_launches"] == res["rqs_launches_expected"] == {
        "k4_forward": 0, "k4_inverse": 0, "k5_forward": 0, "k5_inverse": 0}
    assert res["transitions"] == 64 and res["n_draws"] == 32
    assert math.isfinite(res["final_elbo"]) and res["final_elbo"] > -0.5
    assert res["v_z_mean"] < 5.0 and res["v_z_var"] < 5.0, res
    assert warm_state.q.shape == (32, 4)


def test_portable_slice_runs_end_to_end_on_the_cpu():
    """The ceiling fit of the first test, then NUTS through the portable
    route with K3's hook (its plain version here): the gates, the hook's
    call count, no K1 launch; and the chip run's comparisons at the
    post-warmup state, where kernel and plain are the same code."""
    _, flow, warm_state = main_path_once(**CEILING)
    res = chip_smoke.main_path_portable(
        "cpu", "ceiling", flow, n_chains=64, num_warmup=64, window=64,
        max_windows=1, ess_gate=100.0)
    chip_smoke.check_portable(res)
    assert res["transitions"] == 128 and res["n_draws"] == 64
    assert res["k3_launches"] == res["k3_launches_expected"] == 0
    assert res["k1_launches"] == 0
    assert res["hook_calls"] >= 2 * res["transitions"]
    assert res["leaf_steps_per_transition"] >= res["mean_leapfrogs_per_draw"]
    rows = chip_smoke.fused_logp_vs_plain("cpu", [
        ("ceiling", flow, 37, None), ("state", flow, 64, warm_state.q)])
    assert all(r["passed"] and r["g"]["max_abs"] == 0.0 for r in rows)
    vs_k1 = chip_smoke.portable_vs_k1(flow, warm_state, chip_smoke.MAX_DQ)
    assert vs_k1["passed"] and vs_k1["flips"] == 0
    hmc = chip_smoke.hmc_vs_plain(flow, warm_state)
    assert hmc["passed"] and hmc["flips"] == 0
    assert 0.0 < hmc["accept_rate"] < 1.0


def test_window_slice_runs_end_to_end_on_the_cpu():
    """The ceiling fit of the first test, then bench.py's window path:
    warmup through K1's plain version, draws through K2's (windows of 16
    transitions), under the gates with up to 3 draw windows of 64 (one
    window's R-hat over 64 chains spreads from seed to seed on the
    per-transition path as well); and the chip run's K2 comparison at the
    post-warmup state, slot by slot from the window's own draws: the
    window against itself one slot per call and against K1's plain version
    (the same decisions in every slot, the energy at slot 0 equal to the
    bit, at most K1's bar of one chain in a slot with another proposal:
    the window writes its draws through blends b + m (a - b), so a carried
    lp belongs to a point one rounding away from the draw, and a
    multinomial choice on a knife edge can part), and "K1" (on the CPU its
    plain version) against the latter."""
    _, flow, warm_state = main_path_once(**CEILING)
    res = chip_smoke.main_path_window(
        "cpu", "ceiling", flow, n_chains=64, num_warmup=64, window=64,
        max_windows=3, ess_gate=100.0, slots=16)
    chip_smoke.check_window(res)
    assert res["k1_launches"] == res["k2_launches"] == 0
    assert res["n_draws"] == 64 * res["windows"]
    assert res["transitions"] == 64 + res["n_draws"]
    assert res["v_z_mean"] < 3.0 and res["v_z_var"] < 3.0, res
    assert res["draw_ms_per_transition"] > 0
    st = warm_state
    rows = chip_smoke.window_vs_plain("cpu", [
        ("state", flow, st.q.contiguous(), st.inv_mass, st.step_size, 5, 4,
         8)], full_plain=True)
    r = rows[0]
    assert r["passed"] and r["vs_plain"]["passed_at_k1_bar"]
    for key in ("vs_plain", "vs_transition", "plain_spread"):
        assert r[key]["flips"] <= 1, key
        assert r[key]["flips_by_q_only"] == sum(r[key]["flips_per_slot"])
        assert r[key]["energy_equal_per_slot"][0], key
    # on the CPU "K1" is K1's plain version
    assert r["vs_k1"] == r["vs_transition"]
    # the whole plain window is the window itself
    assert r["free_running_vs_plain"]["bitwise"]
    assert r["plain_window_ms"] > 0 and r["plain_slots_ms"] > 0
    assert r["bar"]["max_dq"] >= chip_smoke.MAX_DQ
    assert r["bar"]["max_denergy"] >= chip_smoke.MAX_DENERGY
    assert sum(r["depth_histogram"]) == 4 * 64


def test_window_comparison_counts_chains_and_slots():
    """`compare_window` judges each slot on its own: a chain flips in a
    slot when it takes another decision there or ends more than 1e-3
    away; at most K1's bar of chains may flip in any slot; q and energy
    are judged on the (slot, chain) pairs that do not flip. `window_bar`
    widens K1's bar to twice the widest spread of plain versions."""
    S, n, d = 3, 8, 2
    a = [torch.zeros(S, n, d)] + [torch.zeros(S, n) for _ in range(7)]
    b = [t.clone() for t in a]
    b[3][2, 5] = 1.0  # chain 5 takes another leapfrog count in slot 2
    b[0][2, 5] = 9.0  # ... and ends elsewhere: not judged
    b[0][1, 6, 1] = 0.5  # chain 6 parts in slot 1 with the same decisions
    b[0][2, 6, 1] = 2e-4  # ... and is judged again in slot 2
    b[0][1, 1, 0] = 1e-4  # chain 1: within the bar
    a[5][0, 6] = 1.0  # chain 6 diverged in slot 0 (in both)
    b[5][0, 6] = 1.0
    res = chip_smoke.compare_window(a, b)
    assert res["flips_per_slot"] == [0, 1, 1] and res["flips"] == 1
    assert res["chains_with_a_flip"] == 2 and res["flips_by_q_only"] == 1
    assert res["divergent_transitions"] == 1
    assert res["max_dq"] == pytest.approx(2e-4)
    assert res["max_dq_per_slot"][1] == pytest.approx(1e-4)
    assert res["covers"] == pytest.approx(22 / 24)
    assert res["energy_equal_per_slot"] == [True, True, True]
    assert res["passed"]  # 1 flip of 8 chains in a slot: K1's bar
    b[3][1, 2] = 1.0  # a second chain flips in slot 1
    res = chip_smoke.compare_window(a, b)
    assert res["flips"] == 2 and not res["passed"]
    bar = chip_smoke.window_bar([{**res, "max_denergy": float("nan")},
                                 {**res, "flips": 0}], n)
    assert bar["max_flips"] == 4
    assert bar["max_dq"] == pytest.approx(4e-4)  # twice the spread's
    assert bar["max_denergy"] == chip_smoke.MAX_DENERGY
    assert chip_smoke.compare_window(a, b, **bar)["passed"]
    assert not res["bitwise"]
    b[7][0, 2] = 0.1  # an energy beyond the bar on a chain that agrees
    res = chip_smoke.compare_window(a, b, **bar)
    assert not res["passed"] and not res["energy_equal_per_slot"][0]


def test_generic_portable_slice_runs_on_the_cpu():
    """The generic variant's fit (as in the second test), then the
    portable route on its spline flow: the pipeline and its launch
    bookkeeping (at this size the gates need more draws than a CPU test
    affords, as for the generic main path)."""
    _, flow, _ = main_path_once(**GENERIC)
    res = chip_smoke.main_path_portable(
        "cpu", "generic", flow, n_chains=32, num_warmup=32, window=32,
        max_windows=1, ess_gate=50.0)
    assert res["k3_launches"] == res["k1_launches"] == 0
    assert res["rqs_launches"] == res["rqs_launches_expected"] == {
        "k4_forward": 0, "k4_inverse": 0, "k5_forward": 0, "k5_inverse": 0}
    assert res["transitions"] == 64 and res["n_draws"] == 32
    assert sum(res["tree_depth_histogram"]) == 32 * 32
    assert res["v_z_mean"] < 5.0 and res["v_z_var"] < 5.0, res


def test_coupling_comparison_runs_on_the_cpu():
    """The chip run's K6/K7 comparison, on the CPU at two small shapes:
    both sides are the plain version here, so this checks the comparison's
    own code (masks, heads, the float64 referee, every cotangent, the
    bitwise repeat) and the bar's bookkeeping."""
    rows = chip_smoke.coupling_vs_plain(
        "cpu", shapes=[(37, 8, (16, 12), 4, "alternating1", "n0.1", "silu"),
                       (20, 6, (8,), 5, "block0", "he0.01", "tanh")])
    assert [(r["n"], r["direction"]) for r in rows] == [
        (37, "forward"), (37, "inverse"), (20, "forward"), (20, "inverse")]
    assert all(r["passed"] and r["repeats_bitwise"] for r in rows)
    assert all(r[k]["max_abs"] == 0.0 for r in rows[:2]
               for k in ("z", "ladj", "dx", *chip_smoke.COUPLING_PARAMS))
    assert "w1" in rows[2] and "w2" not in rows[2]
    assert rows[0]["w2"]["quantile"] == chip_smoke.block_quantile(12 * 88)
    assert chip_smoke.param_names(4) == ("w0", "b0", "w1", "b1")


def test_coupling_work_counts_the_spline_dims_only():
    """K6's bound at the fit's shape: 2 flops per multiply-add of the
    hidden layers and of the spline dims' 23 x 32 last-layer columns, plus
    the spline; K7 recomputes (x1), pulls back (x2) and, with the weights'
    pass, forms H^T G (x3)."""
    k6_ops, k6_bytes, k7_ops, _, k7a_ops, _ = chip_smoke.coupling_work(
        1024, 64, (128, 128), 8, 32)
    mac = 64 * 128 + 128 * 128 + 128 * 23 * 32
    spline = 1024 * 32 * (25 * 8 + 30)
    assert k6_ops == 2 * 1024 * mac + spline
    assert k7a_ops == 4 * 1024 * mac + 1024 * 32 * (2 * 230 + 12 * 8 + 60)
    assert k7_ops == k7a_ops + 2 * 1024 * mac
    assert k6_bytes == 4 * (2 * 1024 * 64 + 1024 + 64
                            + mac + 256 + 23 * 32)


@pytest.mark.parametrize("kind,scheme,per_row", [
    # leading mask: 1 pass-through input, 7 transformed dims x 2 outputs
    ("affine", "leading", 4 * (1 * 16 + 16 * 16 + 16 * 2 * 7)),
    # mixed masks, 4 of 8 dims on each side; an arqs block is an affine
    # coupling and a spline coupling (3K - 1 = 11 outputs per dim)
    ("arqs", "mixed", 2 * 4 * (4 * 16 + 16 * 16 + 16 * 2 * 4)
     + 2 * 4 * (4 * 16 + 16 * 16 + 16 * 11 * 4)),
])
def test_mlp_flops_counts_the_live_inputs_and_outputs_only(kind, scheme,
                                                          per_row):
    """K1's and K3's bound: W1 over the mask's pass-through dims, W3 over
    the head columns of the transformed dims, forward and back."""
    from tpuflows_torch.flows import build_flow
    from tpuflows_torch.kernels import nuts_cuda
    from tpuflows_torch.targets import NealsFunnel

    g = torch.Generator().manual_seed(0)
    flow = build_flow(torch.randn(64, 8, generator=g), g, kind=kind,
                      n_blocks=2 if kind == "arqs" else 1, knots=4,
                      hidden=(16, 16), mask_scheme=scheme, device="cpu")
    model = nuts_cuda.pack_flow(flow, NealsFunnel(dim=8))
    assert chip_smoke.mlp_flops(model) == per_row


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
     "kernelILb0EEEvPKfS2_S2_S2_PfS3_xif", "K5 one-thread forward"),
    ("_ZN46_GLOBAL__N__6ef3eb06_13_rqs_spline_cu_57cc75a021rqs_grad_"
     "lanes_kernelILb1ELi2EEEvPKfS2_S2_S2_PfS3_xif", "K5 inverse L=2"),
    ("_ZN46_GLOBAL__N__0e4d4b43_13_fused_logp_cu_9a1b2c3d22fused_logp_"
     "tile_kernelILi2ELb1EEEvN13tpuflows_nuts4ArgsENS0_9ChainListEi",
     "K3 tile d/32=2 resident"),
    ("_ZN46_GLOBAL__N__6ef3eb06_13_rqs_spline_cu_57cc75a015rqs_eval_"
     "kernelILb1EEEvPKfS2_PfS3_xif", "K4 one-thread inverse"),
    ("_ZN46_GLOBAL__N__6ef3eb06_13_rqs_spline_cu_57cc75a021rqs_eval_"
     "lanes_kernelILb0ELi2EEEvPKfS2_PfS3_xif", "K4 forward L=2"),
    ("_ZN50_GLOBAL__N__570a5339_17_coupling_block_cu_3c6ffed619coupling_"
     "fwd_kernelILb1EEEvNS_6LayersENS_5BlockEPfS3_", "K6 inverse"),
    ("_ZN50_GLOBAL__N__570a5339_17_coupling_block_cu_3c6ffed619coupling_"
     "bwd_kernelILb0EEEvNS_6LayersENS_5BlockENS_7ScratchEPKfS5_Pf",
     "K7 pass 1 forward"),
    ("_ZN50_GLOBAL__N__570a5339_17_coupling_block_cu_3c6ffed618weight_"
     "grad_kernelENS_10WeightGradE", "K7 pass 2"),
    ("_ZN46_GLOBAL__N__0e4d4b43_13_fused_logp_cu_9a1b2c3d24fused_logp_"
     "affine_kernelILi2EEEvN13tpuflows_nuts4ArgsE", "K3 d/32=2"),
    ("_ZN46_GLOBAL__N__0e4d4b43_13_fused_logp_cu_9a1b2c3d23fused_logp_"
     "chain_kernelILi8EEEvN13tpuflows_nuts4ArgsENS0_9ChainListE",
     "K3 chain d/32=8"),
    ("_ZN46_GLOBAL__N__1f2e3d4c_14_nuts_window_cu_5a6b7c8d18nuts_window_"
     "kernelILi2EEEvN13tpuflows_nuts4ArgsEi", "K2 d/32=2"),
    ("_ZN46_GLOBAL__N__1f2e3d4c_14_nuts_window_cu_5a6b7c8d24nuts_window_"
     "chain_kernelILi5EEEvN13tpuflows_nuts4ArgsENS0_9ChainListEi",
     "K2 chain d/32=5")])
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
    driver = NUTSDriver(transition=fused_nuts_for_flow(target, flow,
                                                       max_depth=3),
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
        NUTSDriver(transition=lambda *a: None, warmup_schedule="doubling")


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
