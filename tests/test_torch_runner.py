"""The config runner of the port (`config.py`, `run.py`) against the JAX
package's:

  * `RunConfig.from_json` on all seven configs, field for field against
    `tpuflows.config` (the JAX package leaves `FlowSpec.hidden` the JSON
    list its string annotation misses; the port makes it the tuple both
    intend), and every spec's defaults;
  * `TargetSpec.build` for every kind (log density against the JAX
    target's; an unknown kind is refused); `to_smc_config` and
    `to_adaptive_config` build the JAX package's `SMCConfig` and
    `AdaptiveConfig` field for field;
  * every task through both runners at reduced size: `fit`, `vi`,
    `nuts`, `mh`, `pt`, `adaptive` and `smc` on c1, c2, c4, c6, c7, c3
    and c5: the same record keys, and results within the Monte-Carlo
    margins stated at each test (the two runners draw other random
    numbers, so they agree in distribution only); an unknown task is
    refused;
  * `nuts.fused_kernel` "auto" takes K1 (its plain version on the CPU)
    where `pack_flow` takes the flow and target, whatever the device,
    and the portable NUTS elsewhere, "on" raises there, naming the
    refusal; the nuts record says which transition ran;
  * `main` as `python -m tpuflows_torch.run`, and `output_dir`.
"""
import dataclasses as dc
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows import config as jconfig
from tpuflows import run as jrun

from tpuflows_torch import config as tconfig
from tpuflows_torch import run as trun
from tpuflows_torch.flows import Chain, Identity
from tpuflows_torch.io import load_pytree
from tpuflows_torch.kernels import nuts_cuda
from tpuflows_torch.kernels.nuts_cuda import FusedNUTS

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tasks here are many small ops: one intra-op thread per test
    worker keeps parallel workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
CONFIGS = sorted(p.stem for p in (ROOT / "configs").glob("*.json"))
SPECS = ["TargetSpec", "FlowSpec", "TrainSpec", "NUTSSpec", "MHSpec",
         "PTSpec", "SMCSpec", "AdaptiveSpec"]


def both(name):
    path = str(ROOT / "configs" / f"{name}.json")
    return (jconfig.RunConfig.from_json(path),
            tconfig.RunConfig.from_json(path))


def test_there_are_seven_configs():
    assert len(CONFIGS) == 7


@pytest.mark.parametrize("name", CONFIGS)
def test_configs_parse_as_the_jax_package_parses_them(name):
    jc, tc = both(name)
    assert [f.name for f in dc.fields(tc)] == [f.name for f in dc.fields(jc)]
    for f in dc.fields(jc):
        jv, tv = getattr(jc, f.name), getattr(tc, f.name)
        if not dc.is_dataclass(jv):
            assert tv == jv, f.name
            continue
        assert type(tv).__name__ == type(jv).__name__
        for g in dc.fields(jv):
            a, b = getattr(tv, g.name), getattr(jv, g.name)
            if g.name == "hidden":
                assert isinstance(a, tuple) and a == tuple(b)
            else:
                assert a == b, (f.name, g.name)


@pytest.mark.parametrize("spec", SPECS)
def test_spec_defaults_match(spec):
    jcls, tcls = getattr(jconfig, spec), getattr(tconfig, spec)
    jf = {f.name: f for f in dc.fields(jcls)}
    tf = {f.name: f for f in dc.fields(tcls)}
    assert list(tf) == list(jf)
    for name, f in jf.items():
        assert tf[name].default == f.default, name


def test_unknown_keys_are_refused():
    with pytest.raises(ValueError, match="unknown keys"):
        tconfig.RunConfig.from_dict({"name": "x", "task": "fit",
                                     "flow": {"kinds": "rqs"}})


@pytest.mark.parametrize("kind,dim", [("std_normal", 3), ("diag_normal", 3),
                                      ("correlated", 8), ("funnel", 8),
                                      ("mixture", 16), ("banana", 2),
                                      ("rosenbrock", 4), ("hierarchical", 18)])
def test_target_spec_builds_the_ported_kinds(kind, dim):
    jt = jconfig.TargetSpec(kind, dim).build()
    tt = tconfig.TargetSpec(kind, dim).build(device="cpu")
    x = np.random.default_rng(dim).normal(size=(16, dim)).astype(np.float32)
    np.testing.assert_allclose(tt.log_density(torch.from_numpy(x)).numpy(),
                               np.asarray(jt.log_density(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["hierarchical"])
def test_target_spec_names_the_roadmap_item(kind):
    """No target kind is left to port: the hierarchical target, the last
    one, builds (`test_target_spec_builds_the_ported_kinds` holds its
    log density against the JAX target's), and an unknown kind is
    refused."""
    tt = tconfig.TargetSpec(kind, 4).build(device="cpu")
    assert tt.dim == 4
    with pytest.raises(ValueError, match="unknown target"):
        tconfig.TargetSpec("gamma", 4).build(device="cpu")


def test_smc_and_adaptive_configs_name_their_items():
    """Both sampler configs are ported: c5's `to_smc_config` and c3's
    `to_adaptive_config` equal the JAX package's field for field
    (`tests/test_torch_adaptive.py` holds the adaptive one's other
    cases); the SMC one passes exactly the JAX package's fields, so the
    others keep `SMCConfig`'s defaults."""
    from tpuflows.smc import SMCConfig as JSMCConfig
    from tpuflows_torch.smc import SMCConfig

    jc, tc = both("c5_hierarchical_smc")
    ts, js = tc.smc.to_smc_config(), jc.smc.to_smc_config()
    assert isinstance(ts, SMCConfig) and isinstance(js, JSMCConfig)
    assert ts._asdict() == js._asdict()
    assert ts.resample_threshold == 0.5 and ts.retrain_epochs == 20
    jc, tc = both("c3_mixture_adaptive")
    ta = tc.adaptive.to_adaptive_config(tc.flow)
    ja = jc.adaptive.to_adaptive_config(jc.flow)
    assert ta._asdict() == {**ja._asdict(), "hidden": tuple(ja.hidden)}


@pytest.mark.parametrize("name", ["c5_hierarchical_smc"])
def test_unported_tasks_name_their_items(name, monkeypatch):
    """No task is left unported: c5 (the `smc` task, the last one) parses
    and runs at reduced size through both runners (d = 18, 1,024
    particles, a 2,048-draw and 20-epoch pretrain, 2 equilibration
    stages, unsharded: the sharded run goes over a process group of its
    own, tests/test_torch_dist_runs.py): the same record keys, both at
    beta = 1, log Z within 0.35 of
    each other (4 of the difference's standard deviations at the sigma
    such runs report, 0.04-0.06 each, + 0.05) and of the quadrature
    truth, mean acceptances within 0.05 (both adapt to 0.65). An unknown
    task is refused."""
    jout, tout = run_both(name, monkeypatch)
    truth = tconfig.TargetSpec("hierarchical", 18).build(
        device="cpu").log_evidence()
    for out in (jout, tout):
        assert out["final_beta"] == 1.0
        assert abs(out["log_z"] - truth) < 0.35
        assert 1 <= out["n_stages"] <= 100
    assert abs(tout["log_z"] - jout["log_z"]) < 0.35
    assert abs(tout["mean_accept"] - jout["mean_accept"]) < 0.05
    _, tc = both(name)
    with pytest.raises(ValueError, match="unknown task"):
        trun.run(dc.replace(tc, task="sample"), device="cpu")


# ---------------------------------------------------------------------------
# the three tasks through both runners, at reduced size
# ---------------------------------------------------------------------------
def reduce(cfg):
    if cfg.task == "fit":
        return dc.replace(cfg, train=dc.replace(cfg.train, nepochs=5))
    if cfg.task == "vi":
        return dc.replace(cfg, train=dc.replace(cfg.train, nsteps=40))
    if cfg.task == "mh":
        return dc.replace(cfg, mh=dc.replace(cfg.mh, num_warmup=500,
                                             num_samples=1000))
    if cfg.task == "pt":
        return dc.replace(cfg, pt=dc.replace(cfg.pt, num_warmup=300,
                                             num_samples=600))
    if cfg.task == "smc":
        return dc.replace(
            cfg, target=dc.replace(cfg.target, dim=18),
            smc=dc.replace(cfg.smc, n_particles=1024, pretrain_draws=2048,
                           pretrain_epochs=20,
                           final_equilibration_stages=2, sharded=False))
    if cfg.task == "adaptive":
        return dc.replace(
            cfg, target=dc.replace(cfg.target, dim=4),
            flow=dc.replace(cfg.flow, n_blocks=2, hidden=(16, 16)),
            adaptive=dc.replace(cfg.adaptive, max_rounds=2,
                                ess_threshold=1e9, n_chains=16,
                                num_warmup=50, num_samples=50,
                                train_epochs=3))
    return dc.replace(
        cfg, target=dc.replace(cfg.target, dim=8),
        train=dc.replace(cfg.train, nsteps=300, batch_size=256),
        nuts=dc.replace(cfg.nuts, n_chains=64, num_warmup=60,
                        num_samples=100))


def records(monkeypatch):
    """Sends both runners' JSONL records to a buffer each."""
    bufs = io.StringIO(), io.StringIO()
    monkeypatch.setattr(jrun._metrics, "_stream", bufs[0])
    monkeypatch.setattr(trun._metrics, "_stream", bufs[1])
    return [lambda b=b: b.getvalue().strip().splitlines()[-1] for b in bufs]


# the keys the port's records add to the JAX runner's
EXTRA_KEYS = {"nuts": {"transition"}}


def run_both(name, monkeypatch):
    jc, tc = both(name)
    jrec, trec = records(monkeypatch)
    jout = jrun._run_task(reduce(jc))
    jline = jrec()
    tout = trun.run(reduce(tc), device="cpu")
    tline = trec()
    # the emitted records: the returned ones and a timestamp
    assert json.loads(jline).keys() == {"ts", *jout}
    assert json.loads(tline) == {"ts": json.loads(tline)["ts"], **tout}
    assert tout.keys() == jout.keys() | EXTRA_KEYS.get(tout["task"], set())
    assert tout["name"] == jout["name"] and tout["task"] == jout["task"]
    return jout, tout


ENTROPY_2D = 1.0 + np.log(2.0 * np.pi)  # of N(0, I_2): the negll optimum


def test_fit_task_matches_jax(monkeypatch):
    """c1, 5 epochs: the flow starts at the optimum (its Standardize fits
    the standard-normal samples), so each loss is the negll of one batch
    of 512 rows, within 0.044 (its standard deviation at the optimum) of
    the entropy 2.838. Margin: 0.3 between the runners, 0.25 from the
    entropy (about 5 standard deviations)."""
    jout, tout = run_both("c1_std_normal_affine", monkeypatch)
    for key in ("final_loss", "initial_loss"):
        assert abs(tout[key] - jout[key]) < 0.3, key
        assert abs(tout[key] - ENTROPY_2D) < 0.25, key


def test_vi_task_matches_jax(monkeypatch):
    """c2, 40 steps: the final ELBO on 4096 draws. Over seeds 0-3 the JAX
    runner gave -0.533..-0.560, the port -0.538..-0.638 (a few hundredths
    of spread each); margin 0.25 between them, and both far from the
    ELBO of the unfitted flow."""
    jout, tout = run_both("c2_correlated_rqs", monkeypatch)
    assert abs(tout["final_elbo"] - jout["final_elbo"]) < 0.25
    assert -1.0 < tout["final_elbo"] < 0.05


def test_nuts_task_matches_jax(monkeypatch):
    """c4 at d = 8, 64 chains, a 300-step fit at batch 256, 60 warmup and
    100 draws; K1's plain version on the CPU ("auto"). Both runs must
    converge (max split-R-hat < 1.1) with few divergences; step sizes
    within a factor 1.5 and min ESS within a factor 3 of each other."""
    jout, tout = run_both("c4_funnel_nuts", monkeypatch)
    assert tout["transition"] == "fused"
    for out in (jout, tout):
        assert out["max_rhat"] < 1.1
        assert out["divergence_rate"] < 0.05
    assert 1 / 1.5 < tout["step_size"] / jout["step_size"] < 1.5
    assert 1 / 3 < tout["min_ess"] / jout["min_ess"] < 3


def test_mh_task_matches_jax(monkeypatch):
    """c6 (RWMH on the 2-d banana, 256 chains) with 500 warmup steps and
    1000 draws. On seeds 6-10 the JAX runner's acceptance rate was
    0.222-0.228 and the port's 0.222-0.229 (0.006 apart at most), max
    split-R-hat 1.06-1.12 in both, min ESS at most 1.8x apart. Margins:
    0.025 from the target 0.234 and 0.02 between them, R-hat below 1.2,
    min ESS within a factor 3."""
    jout, tout = run_both("c6_banana_mh", monkeypatch)
    for out in (jout, tout):
        assert abs(out["accept_rate"] - 0.234) < 0.025
        assert out["max_rhat"] < 1.2
    assert abs(tout["accept_rate"] - jout["accept_rate"]) < 0.02
    assert 1 / 3 < tout["min_ess"] / jout["min_ess"] < 3


def test_mh_task_with_a_flow_proposal_runs(capsys):
    """`mh.flow_proposal`: a VI-fitted flow (20 steps here) proposes
    independently; the record has the JAX runner's keys and a finite
    acceptance rate in (0, 1]."""
    _, tc = both("c6_banana_mh")
    tc = dc.replace(tc, flow=dc.replace(tc.flow, n_blocks=2, hidden=(8,)),
                    train=dc.replace(tc.train, nsteps=20, batch_size=64),
                    mh=dc.replace(tc.mh, n_chains=16, num_samples=50,
                                  flow_proposal=True))
    out = trun.run(tc, device="cpu")
    assert set(out) == {"min_ess", "max_rhat", "accept_rate", "name",
                        "task", "wall_s"}
    assert 0.0 < out["accept_rate"] <= 1.0


def test_pt_task_matches_jax(monkeypatch):
    """c7 (8 temperatures x 64 chains on the 8-d bimodal mixture) with
    300 warmup steps and 600 draws. On seeds 7-11 both runners' mean swap
    acceptance lay at 0.743-0.747 (0.003 apart at most), max split-R-hat
    1.08-1.14, min ESS at most 1.9x apart. Margins: 0.02 between the swap
    rates, R-hat below 1.25, min ESS within a factor 3."""
    jout, tout = run_both("c7_mixture_pt", monkeypatch)
    assert abs(tout["mean_swap_accept"] - jout["mean_swap_accept"]) < 0.02
    for out in (jout, tout):
        assert 0.5 < out["mean_swap_accept"] < 0.95
        assert out["max_rhat"] < 1.25
    assert 1 / 3 < tout["min_ess"] / jout["min_ess"] < 3


def test_adaptive_task_matches_jax(monkeypatch):
    """c3 cut to d = 4, 2 spline blocks of 16 x 16, 16 chains, 50 + 50
    NUTS steps and 3 epochs a round, two rounds forced (threshold 1e9):
    the same rounds and no convergence in both, the second round sampling
    through the flow. Over seeds 3-6 the best min ESS lay at 101-177 (JAX)
    and 61-258 (port), at most 2.5x apart, and the flow's relative IS-ESS
    at 0.80-0.88 in both, 0.05 apart at most: margins a factor 4 and
    0.25."""
    jout, tout = run_both("c3_mixture_adaptive", monkeypatch)
    assert tout["n_rounds"] == jout["n_rounds"] == 2
    assert tout["converged"] is jout["converged"] is False
    assert 1 / 4 < tout["best_min_ess"] / jout["best_min_ess"] < 4
    assert abs(tout["flow_is_ess"] - jout["flow_is_ess"]) < 0.25
    assert 0 < tout["flow_is_ess"] <= 1


# ---------------------------------------------------------------------------
# the fused transition's choice
# ---------------------------------------------------------------------------
def _nuts_cfg(fused_kernel, kind="funnel", preconditioned=True):
    _, tc = both("c4_funnel_nuts")
    return dc.replace(
        tc, target=dc.replace(tc.target, kind=kind, dim=8),
        nuts=dc.replace(tc.nuts, fused_kernel=fused_kernel,
                        preconditioned=preconditioned))


def _flow(cfg):
    g = torch.Generator().manual_seed(0)
    return trun._flow_from_spec(torch.randn(64, 8, generator=g), g,
                                cfg.flow, "cpu")


def test_auto_takes_k1_where_pack_flow_takes_the_flow():
    cfg = _nuts_cfg("auto")
    tr = trun._nuts_transition(cfg, cfg.target.build("cpu"), _flow(cfg))
    assert isinstance(tr, FusedNUTS) and tr.max_depth == cfg.nuts.max_depth
    # K1's launch checks take the d = 8 funnel: the flow is packed once at
    # the lane width 32, and the kernel masks the lanes past d
    nuts_cuda.check_widths(tr.model)
    assert (tr.model.d, tr.model.d_pad) == (8, 32)
    off = _nuts_cfg("off")
    assert trun._nuts_transition(off, off.target.build("cpu"),
                                 _flow(off)) is None


def _posterior():
    from tpuflows_torch.targets import IndependentPrior, Normal, Posterior

    prior = IndependentPrior([Normal(0.0, 1.0)] * 8, device="cpu")
    return Posterior(lambda theta: -0.5 * torch.sum(theta * theta, -1),
                     prior)


def test_auto_takes_k1_for_the_c1_nuts_variant():
    """chip_smoke.py's `c1_std_normal_affine_nuts` (c1's target and flow,
    a 2-layer conditioner, under the `nuts` task with fused_kernel
    "auto"): the runner takes FusedNUTS (K1's plain version on the CPU),
    whose module list carries the 2-layer form, and one transition runs
    through it."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    cfg = tconfig.RunConfig.from_dict(
        chip_smoke.run_config_dict("c1_std_normal_affine_nuts"))
    assert (cfg.task, cfg.nuts.fused_kernel) == ("nuts", "auto")
    assert tuple(cfg.flow.hidden) == (32,)
    g = torch.Generator().manual_seed(0)
    flow = trun._flow_from_spec(torch.randn(64, 2, generator=g), g,
                                cfg.flow, "cpu")
    tr = trun._nuts_transition(cfg, cfg.target.build("cpu"), flow)
    assert isinstance(tr, FusedNUTS)
    nuts_cuda.check_widths(tr.model)
    layers = [r[0] for r, m in zip(tr.model.forms.tolist(),
                                   tr.model.mods.tolist()) if m[0] in (1, 2)]
    assert layers == [2] and tr.model.general
    q = torch.randn(16, 2, generator=g)
    q_new, info = tr(g, q, torch.tensor(0.5), torch.ones(2))
    assert q_new.shape == (16, 2) and bool(torch.isfinite(q_new).all())


def test_auto_takes_k1_for_a_four_layer_conditioner():
    """A `hidden` of three widths (a 4-layer conditioner) goes to K1 under
    "auto" as the main paths' 3-layer one does."""
    cfg = _nuts_cfg("auto")
    cfg = dc.replace(cfg, flow=dc.replace(cfg.flow, hidden=(32, 32, 32)))
    tr = trun._nuts_transition(cfg, cfg.target.build("cpu"), _flow(cfg))
    assert isinstance(tr, FusedNUTS)
    nuts_cuda.check_widths(tr.model)
    assert tr.model.nhid == 3 and tr.model.general
    assert {r[0] for r, m in zip(tr.model.forms.tolist(),
                                 tr.model.mods.tolist()) if m[0]} == {4}


def test_auto_takes_the_portable_nuts_for_other_targets():
    """A target with no device form (a Posterior: its likelihood is user
    code) takes the portable NUTS under "auto"."""
    cfg = _nuts_cfg("auto")
    assert trun._nuts_transition(cfg, _posterior(), _flow(cfg)) is None


@pytest.mark.parametrize("kind", ["std_normal", "diag_normal", "correlated",
                                  "mixture", "funnel", "hierarchical",
                                  "banana", "rosenbrock"])
def test_auto_takes_k1_for_every_target_the_runner_builds(kind):
    cfg = _nuts_cfg("auto", kind=kind)
    tr = trun._nuts_transition(cfg, cfg.target.build("cpu"), _flow(cfg))
    assert isinstance(tr, FusedNUTS)
    nuts_cuda.check_widths(tr.model)
    assert tr.model.packed_target.kind == nuts_cuda.TARGET_KIND[
        type(cfg.target.build("cpu"))]


def _with_identity(flow):
    return Chain([Identity(), *flow.transforms])


@pytest.mark.parametrize("kind,edit,why", [
    ("posterior", None, "Posterior"),
    ("funnel", _with_identity, "module Identity")])
def test_on_raises_naming_the_refusal(kind, edit, why):
    cfg = _nuts_cfg("on", kind="funnel")
    target = _posterior() if kind == "posterior" else cfg.target.build("cpu")
    flow = _flow(cfg) if edit is None else edit(_flow(cfg))
    with pytest.raises(ValueError, match="fused_kernel='on'") as err:
        trun._nuts_transition(cfg, target, flow)
    assert why in str(err.value)


def test_on_requires_a_preconditioned_run():
    cfg = _nuts_cfg("on", preconditioned=False)
    with pytest.raises(ValueError, match="preconditioned=true"):
        trun.run(cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown nuts.fused_kernel"):
        trun._nuts_transition(_nuts_cfg("maybe"), None, None)
    # past K1's deepest tree "on" raises naming the limit, as the
    # transition is built; "auto" runs the portable NUTS
    for fk in ("on", "auto"):
        deep = _nuts_cfg(fk)
        deep = dc.replace(deep, nuts=dc.replace(
            deep.nuts, max_depth=nuts_cuda.MAX_DEPTH + 1))
        args = (deep, deep.target.build("cpu"), _flow(deep))
        if fk == "auto":
            assert trun._nuts_transition(*args) is None
            continue
        with pytest.raises(ValueError, match="max_depth in"):
            trun._nuts_transition(*args)


def test_nuts_task_without_preconditioning_runs_portable(capsys):
    cfg = _nuts_cfg("auto", kind="correlated", preconditioned=False)
    cfg = dc.replace(cfg, nuts=dc.replace(cfg.nuts, n_chains=16,
                                          num_warmup=20, num_samples=20))
    out = trun.run(cfg, device="cpu")
    assert out["max_rhat"] < 1.5 and out["step_size"] > 0
    assert out["transition"] == "portable"


# ---------------------------------------------------------------------------
# main and output_dir
# ---------------------------------------------------------------------------
def _small_c1(tmp_path, output_dir=None):
    cfg = json.loads((ROOT / "configs" /
                      "c1_std_normal_affine.json").read_text())
    cfg["train"]["nepochs"] = 2
    if output_dir:
        cfg["output_dir"] = output_dir
    path = tmp_path / "c1_small.json"
    path.write_text(json.dumps(cfg))
    return path


def test_main_runs_a_config_file(tmp_path, monkeypatch):
    _, trec = records(monkeypatch)
    trun.main(["--device", "cpu", str(_small_c1(tmp_path))])
    rec = json.loads(trec())
    assert rec["name"] == "c1_std_normal_affine" and rec["task"] == "fit"
    assert {"final_loss", "initial_loss", "wall_s", "ts"} <= set(rec)


def test_python_m_entry_point(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "tpuflows_torch.run", "--device", "cpu",
         str(_small_c1(tmp_path))], capture_output=True, text=True,
        timeout=300, cwd=str(tmp_path),
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "TPUFLOWS_METRICS": str(tmp_path / "m.jsonl")})
    assert proc.returncode == 0, proc.stderr
    rec = json.loads((tmp_path / "m.jsonl").read_text())
    assert rec["task"] == "fit"
    usage = subprocess.run(
        [sys.executable, "-m", "tpuflows_torch.run"], capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert usage.returncode == 2 and "config.json" in usage.stderr


def test_output_dir_saves_the_state(tmp_path, capsys):
    out_dir = tmp_path / "out"
    cfg = tconfig.RunConfig.from_json(str(_small_c1(tmp_path, str(out_dir))))
    trun.run(cfg, device="cpu")
    state = load_pytree(str(out_dir / "c1_std_normal_affine_state"))
    assert any(k.endswith("log_scale") for k in state.state_dict())


def test_chip_smoke_runner_phase_rehearses_on_the_cpu():
    """`chip_smoke.run_configs` at a cut size: the records, the phases'
    times and the gates. On the CPU no kernel launches (K1 and K4/K5 run
    their plain versions), and c2 after 10 steps is far from fitted, so
    the reference gate refuses it: the gate catches an under-fitted
    flow. c6 and c7 run 200 + 400 steps: their draws pass the moment
    gate, and the reference windows and the R-hat gate, set for the
    configs as written, may refuse so short a run. c3 runs its rounds cut
    to 40 + 40 NUTS steps of 16 chains at d = 4 with 2 epochs a round,
    as written with its threshold cut to 50 (it stops after round 0, as
    on the card) and its variant two rounds. c5 runs at d = 18 with 2,048
    particles and a 4,096-draw pretrain (c5's epochs, stages and
    equilibration kept): it passes every gate, its log Z against the
    quadrature truth and its moment gate included, and launches no
    kernel. The nuts variants (K1 over c2's, c5's and c1's targets, at
    their widths cut to 8 at most) run 8
    chains of 10 + 20 transitions at depth 4 (the one at 96 knots 5 + 10
    at depth 2: K1's plain version takes ~0.2 s a gradient call there):
    their reference windows (none for the 96-knot variant), R-hat and
    moment gates, set for the card's depth, may refuse so short a run. No
    config may fail a gate on its record's keys, its phases, a non-finite
    result or its launches."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    def cut(name, cfg):
        if cfg.task == "fit":
            return dc.replace(cfg, train=dc.replace(cfg.train, nepochs=3))
        if cfg.task == "vi":
            return dc.replace(cfg, train=dc.replace(cfg.train, nsteps=10))
        if cfg.task == "mh":
            return dc.replace(cfg, mh=dc.replace(cfg.mh, num_warmup=200,
                                                 num_samples=400))
        if cfg.task == "pt":
            return dc.replace(cfg, pt=dc.replace(cfg.pt, num_warmup=200,
                                                 num_samples=400))
        if cfg.task == "smc":
            return dc.replace(
                cfg, target=dc.replace(cfg.target, dim=18),
                smc=dc.replace(cfg.smc, n_particles=2048,
                               pretrain_draws=4096))
        if cfg.task == "adaptive":
            threshold = (50.0 if name == "c3_mixture_adaptive"
                         else cfg.adaptive.ess_threshold)
            return dc.replace(
                cfg, target=dc.replace(cfg.target, dim=4),
                flow=dc.replace(cfg.flow, n_blocks=2, hidden=(8,)),
                adaptive=dc.replace(cfg.adaptive, n_chains=16,
                                    num_warmup=40, num_samples=40,
                                    train_epochs=2,
                                    ess_threshold=threshold))
        if name in chip_smoke.RUN_RHAT_VARIANTS:  # K1 over other targets
            many = cfg.flow.knots > 8
            return dc.replace(
                cfg, target=dc.replace(cfg.target,
                                       dim=min(cfg.target.dim, 8)),
                train=dc.replace(cfg.train, nsteps=10, batch_size=64),
                nuts=dc.replace(cfg.nuts, n_chains=8,
                                num_warmup=5 if many else 10,
                                num_samples=10 if many else 20,
                                max_depth=2 if many else 4))
        return dc.replace(
            cfg, target=dc.replace(cfg.target, dim=8),
            train=dc.replace(cfg.train, nsteps=100, batch_size=128),
            nuts=dc.replace(cfg.nuts, n_chains=32, num_warmup=20,
                            num_samples=40))

    rows = {r["config"]: r for r in chip_smoke.run_configs("cpu",
                                                           overrides=cut)}
    assert list(rows) == list(chip_smoke.RUN_CONFIGS)
    assert rows["c1_std_normal_affine"]["passed"]
    assert rows["c4_funnel_nuts"]["passed"]
    assert set(rows["c4_funnel_nuts"]["phase_seconds"]) == {
        "fit", "warmup", "draws"}
    c2 = rows["c2_correlated_rqs"]
    assert not c2["passed"] and len(c2["failures"]) == 1
    assert c2["failures"][0].startswith("final_elbo")
    for name in ("c6_banana_mh", "c7_mixture_pt"):
        r = rows[name]
        assert set(r["phase_seconds"]) == {"warmup", "draws"}
        assert r["moment_gate"]["passed"], r["moment_gate"]
        assert set(r["reference"]) == set(chip_smoke.RUN_REFERENCE[name])
    assert rows["c3_mixture_adaptive"]["record"]["n_rounds"] == 1
    assert rows["c3_mixture_adaptive"]["latent_calls"] == 0
    c3 = rows["c3_mixture_adaptive_two_rounds"]
    assert c3["record"]["n_rounds"] == 2 and c3["latent_calls"] > 0
    assert set(c3["phase_seconds"]) == {"fit", "warmup", "draws"}
    assert c3["phase_calls"] == {"fit": 2, "warmup": 2, "draws": 2}
    assert len(c3["rounds"]) == 2
    assert c3["rqs_launches_expected"] == dict.fromkeys(
        ("k4_forward", "k4_inverse", "k5_forward", "k5_inverse"), 0)
    c5 = rows["c5_hierarchical_smc"]
    assert c5["passed"], c5["failures"]
    assert set(c5["phase_seconds"]) == {"fit", "stages", "retrain"}
    assert c5["phase_calls"]["stages"] == c5["record"]["n_stages"] + 8
    assert not any(c5["kernel_launches"].values())
    assert c5["smc"]["moment_gate"]["passed"]
    assert not any(f.startswith(("record keys", "phases", "K4/K5",
                                 "a non-finite", "moment gate"))
                   for r in rows.values() for f in r["failures"]
                   if r["config"] not in chip_smoke.RUN_RHAT_VARIANTS)
    assert not any(f.startswith(("record keys", "phases", "a non-finite"))
                   for n in chip_smoke.RUN_RHAT_VARIANTS
                   for f in rows[n]["failures"])
    for r in rows.values():
        assert r["k1_launches"] == 0 and not any(r["rqs_launches"].values())
        assert r["record"]["name"] == r["config"]
    for name in chip_smoke.RUN_RHAT_VARIANTS:  # K1's plain version ran
        assert rows[name]["record"]["transition"] == "fused"
        assert set(rows[name]["reference"]) == set(
            chip_smoke.RUN_REFERENCE.get(name, {}))


def test_adaptive_launches_follow_the_path():
    """The K4/K5 launches `chip_smoke.adaptive_launches` derives for c3:
    one round (no flow to sample through: the fit's forward pairs and the
    IS-ESS's inverse launch), and two (the latent NUTS's gradient calls,
    the latent start and the draws' inverse)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    _, tc = both("c3_mixture_adaptive")
    steps = 60 * 16
    assert chip_smoke.adaptive_launches(tc, 1, 0) == {
        "k4_forward": 4 * steps, "k4_inverse": 4, "k5_forward": 4 * steps,
        "k5_inverse": 0}
    assert chip_smoke.adaptive_launches(tc, 2, 1000) == {
        "k4_forward": 4 * (2 * steps + 1), "k4_inverse": 4 * (1000 + 3),
        "k5_forward": 4 * 2 * steps, "k5_inverse": 4 * 1000}
