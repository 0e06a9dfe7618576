"""`chip_smoke.dist_world_of_one`, the card's distributed phase, rehearsed
in one process on the CPU at a cut size: `worker_mesh(device="cpu")`
forms a gloo world of one over an in-process store (the card forms a NCCL
one), then (a)-(e) run with their gates: the collectives against their
local math, the sharded resampler at 512 x 18 through both transports, one
sharded stage of c5's configuration against the unsharded one (equal to
the bit at a world of one), one data-parallel step against one plain
step (and c5's retrain timed each way once), and the sharded NUTS
through K1's plain version (no launch on CPU tensors) on a fitted
ceiling flow at d = 8: 32 chains, 64 warmup transitions and 320 draws,
which the R-hat gate needs at this size (128 draws of 64 chains gave
1.10, 256 of 32 gave 1.038, 320 of 32 1.029), trees of depth 4 (a
quarter of depth 6's gradient calls; R-hat 1.0165 against 1.0058 at
depth 6 on one seed).

The world of one lives in a child process, so the pytest worker's
`torch.distributed` state stays as it was."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {root!r})
    sys.path.insert(0, {src!r})
    import torch
    torch.set_num_threads(2)
    import chip_smoke
    from tpuflows_torch.flows import Adam, build_flow, optimize_flow
    from tpuflows_torch.targets import HierarchicalGaussian

    torch.manual_seed(0)
    _, flow, warm_state = chip_smoke.main_path(
        "cpu", dim=8, n_chains=64, hidden=(16, 16), train_steps=200,
        train_batch=256, num_warmup=64, window=64, max_windows=1,
        ess_gate=100.0)
    target = HierarchicalGaussian.standard(dim=18, device="cpu")
    prior = target.sample_prior(torch.Generator().manual_seed(1), 1024,
                                device="cpu")
    c5_flow = build_flow(prior, torch.Generator().manual_seed(2),
                         kind="affine", n_blocks=2, hidden=(32, 32),
                         mask_scheme="leading", n_leading=2, clamp=8.0,
                         device="cpu")
    optimize_flow(torch.Generator().manual_seed(3), prior, c5_flow,
                  Adam(2e-3), nbatches=8, nepochs=5)
    res, failures = chip_smoke.dist_world_of_one(
        "cpu", flow, warm_state, c5_flow, n=512, d=18, n_chains=32,
        num_warmup=64, num_samples=320, max_depth=4, repeats=1)
    torch.distributed.destroy_process_group()
    print(json.dumps({{"res": res, "failures": failures}}))
""")


def test_dist_world_of_one_rehearses_on_the_cpu(tmp_path):
    script = tmp_path / "rehearse.py"
    script.write_text(SCRIPT.format(root=str(ROOT), src=str(ROOT / "src")))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    res = got["res"]
    assert got["failures"] == [], got["failures"]
    assert res["world"] == 1 and res["backend"] == "gloo"
    assert all(c["passed"] for c in res["collectives"].values())
    assert set(res["collectives"]) == {
        "psum", "pmean", "pmax", "logsumexp_g", "kish_ess_g", "all_gather",
        "broadcast", "replicate"}
    assert len(res["heartbeat_s"]) == 5
    assert all(r["passed"] for r in res["resample"].values())
    stage = res["stage"]
    assert stage["resampled"] == [True, True] and stage["ancestors_equal"]
    assert stage["beta"][0] == stage["beta"][1]
    # a world of one computes the same operations: equal to the bit
    assert stage["bits_differ_x"] == 0 and stage["max_abs_dlog_w"] == 0.0
    assert res["dp_step"]["bits_differ"] == 0
    assert len(stage["seconds_sharded"]) == len(stage["seconds_unsharded"]) \
        == 1
    retrain = res["retrain"]
    assert retrain["steps"] == 160 and retrain["rows"] == 512
    assert all(t > 0 for t in retrain["ms_per_step_unsharded"]
               + retrain["ms_per_step_sharded"])
    nuts = res["nuts"]
    assert nuts["launches"] == 0 and nuts["launches_expected"] == 0
    assert nuts["transitions"] == 384 and nuts["max_rhat"] < 1.05
    assert nuts["moment_check_passed"] and nuts["finite"]
