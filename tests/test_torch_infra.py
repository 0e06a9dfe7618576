"""The single-process infrastructure of the port: `io/checkpoint.py`
(atomic save, load, latest; NamedTuples, generators and flows round-trip,
loaded with `weights_only=True`), `dist/failures.py` (`run_with_timeout`,
`CollectiveTimeout`, `FailurePolicy` with its environment and both
actions) and `util/profiling.py` (`Timer`, `MetricsLogger`, `trace`).
"""
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

from tpuflows_torch.dist import (EXIT_PEER_LOSS, CollectiveTimeout,
                                 FailurePolicy, run_with_timeout)
from tpuflows_torch.convert import flow_from_jax_modules, module_spec
from tpuflows_torch.flows import (Chain, Identity, RQSCouplingBlock,
                                  ScannedRepeat, Whiten, build_flow)
from tpuflows_torch.io import checkpoint, latest_checkpoint, load_pytree, \
    save_pytree
from tpuflows_torch.util.profiling import MetricsLogger, Timer, trace

ROOT = Path(__file__).resolve().parents[1]


def small_flow(seed, kind="rqs"):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(64, 4, generator=g)
    return build_flow(x, g, kind=kind, n_blocks=2, knots=4, hidden=(8,),
                      device="cpu")


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["rqs", "affine", "arqs"])
def test_flow_state_round_trip(tmp_path, kind):
    """A flow comes back as a flow; its state loads into another."""
    flow = small_flow(1, kind)
    with torch.no_grad():
        for p in flow.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator()
                                     .manual_seed(p.numel())))
    save_pytree(str(tmp_path / "run" / "flow"), flow)
    assert sorted(os.listdir(tmp_path / "run")) == ["flow.pt"]
    other = small_flow(2, kind)
    other.load_state_dict(load_pytree(str(tmp_path / "run" /
                                          "flow")).state_dict())
    z = torch.randn(16, 4, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(other.inverse(z), flow.inverse(z), rtol=0,
                               atol=0)


class Pair(NamedTuple):
    first: torch.Tensor
    second: object


class Outer:
    class Inner(NamedTuple):
        x: int
        y: tuple


def test_namedtuples_round_trip(tmp_path):
    """NamedTuples, nested in dicts and in each other (a class nested in
    a class too), come back as themselves."""
    tree = {"a": Pair(torch.arange(3.0), Pair(torch.ones(2, 2), "s")),
            "b": [Outer.Inner(4, (Pair(torch.zeros(1), None), 5))]}
    save_pytree(str(tmp_path / "nt"), tree)
    back = load_pytree(str(tmp_path / "nt"))
    assert type(back["a"]) is Pair and type(back["a"].second) is Pair
    torch.testing.assert_close(back["a"].first, torch.arange(3.0))
    torch.testing.assert_close(back["a"].second.first, torch.ones(2, 2))
    assert back["a"].second.second == "s"
    inner = back["b"][0]
    assert type(inner) is Outer.Inner and inner.x == 4
    assert type(inner.y) is tuple and type(inner.y[0]) is Pair
    assert inner.y[1] == 5 and inner.y[0].second is None


def test_a_record_naming_another_class_is_refused(tmp_path):
    torch.save({checkpoint.TAG: "namedtuple", "module": "os",
                "name": "path", "fields": []}, str(tmp_path / "x.pt"))
    with pytest.raises(TypeError, match="not a NamedTuple"):
        load_pytree(str(tmp_path / "x"))


def test_generator_round_trip(tmp_path):
    """A CPU generator saved mid-stream gives back a generator whose next
    draws are the saved one's."""
    g = torch.Generator().manual_seed(11)
    torch.randn(100, generator=g)
    save_pytree(str(tmp_path / "g"), {"key": g, "step": 3})
    back = load_pytree(str(tmp_path / "g"))["key"]
    assert isinstance(back, torch.Generator) and back.device.type == "cpu"
    torch.testing.assert_close(torch.randn(50, generator=back),
                               torch.randn(50, generator=g), rtol=0, atol=0)
    torch.testing.assert_close(torch.rand(7, generator=back),
                               torch.rand(7, generator=g), rtol=0, atol=0)


def test_load_is_weights_only(tmp_path, monkeypatch):
    seen = []
    load = torch.load
    monkeypatch.setattr(torch, "load", lambda *a, **k: seen.append(k)
                        or load(*a, **k))
    save_pytree(str(tmp_path / "w"), {"g": torch.Generator(),
                                      "f": small_flow(0)})
    load_pytree(str(tmp_path / "w"))
    assert seen and all(k["weights_only"] is True for k in seen)


def _whiten():
    x = torch.randn(256, 4, generator=torch.Generator().manual_seed(4))
    return Whiten.from_samples(x @ torch.tensor([[1.0, 0.3, 0, 0],
                                                 [0, 1.0, 0.2, 0],
                                                 [0, 0, 2.0, 0],
                                                 [0.1, 0, 0, 0.5]]))


def _scanned():
    g = torch.Generator().manual_seed(8)
    return ScannedRepeat.from_blocks([
        RQSCouplingBlock.init(g, (1, 0, 1, 0), knots=4, hidden=(8,),
                              use_pallas=False) for _ in range(3)])


MODULES = {
    "standardize": lambda: small_flow(6, "affine").transforms[0],
    "whiten": _whiten,
    "identity": Identity,
    "affine": lambda: small_flow(6, "affine").transforms[1],
    "rqs": lambda: small_flow(6, "rqs").transforms[1],
    "scanned": _scanned,
}


def _perturbed(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.2 * torch.randn(p.shape, generator=g))
    return module


def _same_function(a, b):
    x = 1.5 * torch.randn(32, 4, generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        for method in ("forward_and_ladj", "inverse_and_ladj"):
            for u, v in zip(getattr(a, method)(x), getattr(b, method)(x)):
                torch.testing.assert_close(u, v, rtol=0, atol=0)


@pytest.mark.parametrize("kind", sorted(MODULES))
def test_a_flow_of_every_module_kind_round_trips(tmp_path, kind):
    """Each kind, alone (it comes back as a Chain of one) and in a Chain
    inside a tree, computes the same forward and ladj, inverse and ladj,
    to the bit; `module_spec` is `module_from_jax_spec`'s inverse."""
    module = _perturbed(MODULES[kind](), 1)
    assert module_spec(module)["kind"] == kind
    flow = Chain([small_flow(7, "affine").transforms[0], module])
    save_pytree(str(tmp_path / "m"), {"alone": module, "chain": [flow]})
    back = load_pytree(str(tmp_path / "m"))
    assert isinstance(back["alone"], Chain) and len(back["alone"]) == 1
    _same_function(back["alone"], module)
    assert isinstance(back["chain"][0], Chain)
    _same_function(back["chain"][0], flow)
    rebuilt = flow_from_jax_modules([module_spec(module)], device="cpu")
    _same_function(rebuilt, module)
    if kind == "rqs":
        assert back["alone"].transforms[0].use_pallas == module.use_pallas


def test_a_grown_flow_round_trips(tmp_path):
    flow = small_flow(3, "arqs")
    g = torch.Generator().manual_seed(5)
    grown = flow.append(_perturbed(RQSCouplingBlock.init(
        g, (0, 0, 1, 1), knots=4, hidden=(8,)), 2))
    save_pytree(str(tmp_path / "grown"), {"flow": grown, "old": flow})
    back = load_pytree(str(tmp_path / "grown"))
    assert len(back["flow"]) == len(flow) + 1 == 6
    assert len(back["old"]) == len(flow)
    assert back["flow"].transforms[-1].mask == (0, 0, 1, 1)
    _same_function(back["flow"], grown)


def test_other_modules_keep_their_state_dict(tmp_path):
    """A Chain inside a Chain is not a flow `module_spec` describes: it is
    saved as its state_dict."""
    nested = Chain([small_flow(1), Identity()])
    save_pytree(str(tmp_path / "n"), nested)
    state = load_pytree(str(tmp_path / "n"))
    assert not isinstance(state, torch.nn.Module)
    assert list(state) == list(nested.state_dict())


def test_tree_round_trip(tmp_path):
    tree = {"q": torch.arange(6.0).reshape(2, 3), "step": 7,
            "hist": [torch.ones(2), (torch.zeros(1, dtype=torch.int64),
                                     "tag")]}
    save_pytree(str(tmp_path / "state"), tree)
    back = load_pytree(str(tmp_path / "state"))
    assert back["step"] == 7 and back["hist"][1][1] == "tag"
    torch.testing.assert_close(back["q"], tree["q"])
    assert back["hist"][1][0].dtype == torch.int64
    t = torch.linspace(0, 1, 5)
    save_pytree(str(tmp_path / "draws"), t)
    torch.testing.assert_close(load_pytree(str(tmp_path / "draws")), t)


def test_save_replaces_atomically(tmp_path):
    """A second save replaces the first through a temporary file; a
    stale temporary file from a killed writer is never read."""
    path = str(tmp_path / "ckpt_3")
    save_pytree(path, torch.zeros(3))
    Path(path + ".pt.tmp").write_bytes(b"torn")
    save_pytree(path, torch.ones(3))
    torch.testing.assert_close(load_pytree(path), torch.ones(3))
    assert not Path(path + ".pt.tmp").exists()


def test_latest_checkpoint(tmp_path):
    assert latest_checkpoint(str(tmp_path / "absent")) is None
    assert latest_checkpoint(str(tmp_path)) is None
    for step in (2, 10, 9):
        save_pytree(str(tmp_path / f"ckpt_{step}"), torch.tensor(step))
    save_pytree(str(tmp_path / "other_99"), torch.tensor(0))
    (tmp_path / "ckpt_50.pt.tmp").write_bytes(b"")
    latest = latest_checkpoint(str(tmp_path))
    assert latest == str(tmp_path / "ckpt_10")
    assert int(load_pytree(latest)) == 10
    assert latest_checkpoint(str(tmp_path), prefix="other_") == \
        str(tmp_path / "other_99")


# ---------------------------------------------------------------------------
# failures
# ---------------------------------------------------------------------------
def test_run_with_timeout_passes_values_and_errors():
    assert run_with_timeout(lambda a, b=1: a + b, 2, b=3, timeout_s=5) == 5
    out = run_with_timeout(lambda: {"x": torch.ones(2)}, timeout_s=5)
    torch.testing.assert_close(out["x"], torch.ones(2))
    with pytest.raises(KeyError, match="boom"):
        run_with_timeout(lambda: {}["boom"], timeout_s=5)


def test_run_with_timeout_raises_collective_timeout():
    release = threading.Event()
    t0 = time.perf_counter()
    with pytest.raises(CollectiveTimeout, match="0.2s"):
        run_with_timeout(release.wait, 30, timeout_s=0.2)
    assert time.perf_counter() - t0 < 5
    release.set()  # let the daemon thread finish


def test_failure_policy_from_env(monkeypatch):
    monkeypatch.delenv("TPUFLOWS_COLLECTIVE_TIMEOUT_S", raising=False)
    assert FailurePolicy.from_env() == FailurePolicy(None, "raise")
    monkeypatch.setenv("TPUFLOWS_COLLECTIVE_TIMEOUT_S", "2.5")
    assert FailurePolicy.from_env() == FailurePolicy(2.5, "exit")
    monkeypatch.setenv("TPUFLOWS_ON_PEER_LOSS", "raise")
    assert FailurePolicy.from_env() == FailurePolicy(2.5, "raise")


def test_failure_policy_guard_raise():
    assert FailurePolicy().guard(lambda x: 2 * x, 4, phase="p") == 8
    assert FailurePolicy(5.0).guard(lambda x: 2 * x, 4) == 8
    release = threading.Event()
    with pytest.raises(CollectiveTimeout):
        FailurePolicy(0.2, "raise").guard(release.wait, 30, phase="t")
    release.set()


def test_failure_policy_guard_exit():
    """"exit" ends the process with EXIT_PEER_LOSS and a JSON event on
    stderr, even though the hung thread can never be joined."""
    code = ("import threading\n"
            "from tpuflows_torch.dist import FailurePolicy\n"
            "FailurePolicy(0.2, 'exit').guard(threading.Event().wait, "
            "phase='task:nuts')\n"
            "print('not reached')\n")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, env={**os.environ,
                          "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == EXIT_PEER_LOSS == 43
    assert "not reached" not in proc.stdout
    event = json.loads(proc.stderr.strip().splitlines()[-1])
    assert event == {"event": "peer_loss", "phase": "task:nuts",
                     "timeout_s": 0.2, "process": 0}


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------
def test_timer_measures_and_syncs():
    timer = Timer()
    time.sleep(0.05)
    flow = small_flow(4)
    dt = timer.stop(sync_on={"flow": flow, "x": [torch.ones(1)]})
    assert 0.05 <= dt < 30
    assert timer.stop() >= dt


def test_metrics_logger_stream_and_file(tmp_path):
    import io

    buf = io.StringIO()
    MetricsLogger(stream=buf).log(a=1, loss=torch.tensor(2.5), name="x")
    rec = json.loads(buf.getvalue())
    assert rec["a"] == 1 and rec["loss"] == 2.5 and rec["name"] == "x"
    assert isinstance(rec["ts"], float)
    path = tmp_path / "m.jsonl"
    log = MetricsLogger(path=str(path))
    log.log(step=1)
    log.log(step=2)
    log.close()
    lines = [json.loads(s) for s in path.read_text().splitlines()]
    assert [r["step"] for r in lines] == [1, 2]


def test_trace_writes_a_chrome_trace(tmp_path):
    flow = small_flow(5)
    with trace(str(tmp_path / "tr")) as prof:
        flow.inverse(torch.randn(32, 4, generator=torch.Generator()
                                 .manual_seed(0)))
    assert prof is not None
    data = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert data["traceEvents"]
