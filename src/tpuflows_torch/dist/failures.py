"""Failure detection, the single-process part (port of
`tpuflows/dist/failures.py`: `CollectiveTimeout`, `run_with_timeout`,
`FailurePolicy`; `heartbeat` waits for `dist/`, ROADMAP Queue 1 item 11).

When a peer process dies, the others block for ever in the next
collective: the call never raises and cannot be cancelled. So a phase runs
in a worker thread under a time budget; past it, the policy either raises
`CollectiveTimeout` or exits the process with `EXIT_PEER_LOSS` so that a
supervisor restarts every worker from the last checkpoint. `run.py` runs
every task under `FailurePolicy.from_env()`
(TPUFLOWS_COLLECTIVE_TIMEOUT_S, TPUFLOWS_ON_PEER_LOSS).
"""
from __future__ import annotations

import os
import sys
import threading
from dataclasses import dataclass
from typing import Any, Callable, Optional

from tpuflows_torch.util.profiling import process_index, synchronize

EXIT_PEER_LOSS = 43  # distinct from generic-error exit codes


class CollectiveTimeout(RuntimeError):
    """A device computation (usually a collective) did not complete in time.

    The call is still blocked in its worker thread and cannot be cancelled;
    the process should checkpoint nothing further and restart."""


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
