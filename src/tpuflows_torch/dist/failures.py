"""Failure detection for multi-process runs (port of
`tpuflows/dist/failures.py`: `heartbeat`, `CollectiveTimeout`,
`run_with_timeout`, `FailurePolicy`).

When a peer process dies, the others block for ever in the next
collective: the call never raises and cannot be cancelled. So a phase runs
in a worker thread under a time budget; past it, the policy either raises
`CollectiveTimeout` or exits the process with `EXIT_PEER_LOSS` so that a
supervisor restarts every worker from the last checkpoint. `heartbeat` is
the cheapest such phase, a one-element `all_reduce` over the mesh, which
`run_smc` runs under the policy before each stage of a multi-process run.
`run.py` runs every task under `FailurePolicy.from_env()`
(TPUFLOWS_COLLECTIVE_TIMEOUT_S, TPUFLOWS_ON_PEER_LOSS).
"""
from __future__ import annotations

import os
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from tpuflows_torch.dist.collectives import psum
from tpuflows_torch.util.profiling import process_index, synchronize

EXIT_PEER_LOSS = 43  # distinct from generic-error exit codes


class CollectiveTimeout(RuntimeError):
    """A device computation (usually a collective) did not complete in time.

    The call is still blocked in its worker thread and cannot be cancelled;
    the process should checkpoint nothing further and restart."""


def heartbeat(mesh) -> float:
    """Liveness probe: a one-element `all_reduce` of ones over the mesh.

    Returns its wall-clock latency in seconds (the host read of the sum
    waits for it). If a rank has died this call hangs: run it under
    `run_with_timeout` to get an exception instead. A sum other than the
    world size raises RuntimeError."""
    t0 = time.perf_counter()
    total = float(psum(torch.ones((), device=mesh.device), mesh))
    dt = time.perf_counter() - t0
    if total != float(mesh.size):
        raise RuntimeError(f"heartbeat all_reduce returned {total}, "
                           f"expected {mesh.size}: mesh corrupt")
    return dt


def run_with_timeout(fn: Callable[..., Any], *args: Any,
                     timeout_s: float, **kwargs: Any) -> Any:
    """Run `fn(*args, **kwargs)` in a worker thread, waiting there for the
    devices of the tensors it returns; raise `CollectiveTimeout` if that
    takes more than `timeout_s` seconds.

    The worker thread is a daemon: if the device call is truly hung it can
    never be joined, and the process must exit to recover."""
    result: dict = {}

    def _target():
        try:
            value = fn(*args, **kwargs)
            synchronize(value)  # the device work, not only its launch
            result["value"] = value
        except BaseException as e:  # noqa: BLE001 — reraised below
            result["error"] = e

    t = threading.Thread(target=_target, daemon=True,
                         name="tpuflows-collective")
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise CollectiveTimeout(
            f"device step did not complete within {timeout_s}s — on a "
            f"multi-process run this is the peer-loss signature; restart "
            f"from the last checkpoint")
    if "error" in result:
        raise result["error"]
    return result["value"]


@dataclass(frozen=True)
class FailurePolicy:
    """How a long-running driver reacts to a collective timeout.

    timeout_s: per-phase budget (None disables detection entirely).
    action: "raise" -> propagate CollectiveTimeout to the caller;
            "exit"  -> log to stderr and os._exit(EXIT_PEER_LOSS) so the
                       supervisor restarts all workers from the checkpoint
                       (sys.exit would block joining the hung thread).
    """

    timeout_s: Optional[float] = None
    action: str = "raise"

    @staticmethod
    def from_env() -> "FailurePolicy":
        raw = os.environ.get("TPUFLOWS_COLLECTIVE_TIMEOUT_S")
        if not raw:
            return FailurePolicy(timeout_s=None)
        return FailurePolicy(
            timeout_s=float(raw),
            action=os.environ.get("TPUFLOWS_ON_PEER_LOSS", "exit"))

    def guard(self, fn: Callable[..., Any], *args: Any,
              phase: str = "step", **kwargs: Any) -> Any:
        """Run one phase under the policy; a plain call when detection is
        disabled."""
        if self.timeout_s is None:
            return fn(*args, **kwargs)
        try:
            return run_with_timeout(fn, *args, timeout_s=self.timeout_s,
                                    **kwargs)
        except CollectiveTimeout:
            if self.action == "exit":
                print(f'{{"event": "peer_loss", "phase": "{phase}", '
                      f'"timeout_s": {self.timeout_s}, '
                      f'"process": {process_index()}}}',
                      file=sys.stderr, flush=True)
                os._exit(EXIT_PEER_LOSS)
            raise
