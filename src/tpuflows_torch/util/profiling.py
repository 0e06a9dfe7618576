"""Tracing, timing and metrics (port of `tpuflows/util/profiling.py`).

  - `trace(logdir)`: a `torch.profiler` trace of the block (CPU and, where
    there is one, CUDA activity), written as a Chrome trace to
    `logdir/trace.json`;
  - `Timer`: a wall-clock phase timer whose `stop(sync_on=)` first waits
    for the devices of the tensors it is given, so that queued kernels
    count;
  - `MetricsLogger`: structured JSONL records from process 0, to stdout or
    a file; `run.py` writes its records through it.
"""
from __future__ import annotations

import json
import os
import sys
import time
from contextlib import contextmanager
from typing import Any, Optional

import torch


@contextmanager
def trace(logdir: str):
    """Profile the block; yields the `torch.profiler.profile` object."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _tensors(tree):
    """The tensors of a tensor, module, dict, list or tuple."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def synchronize(tree) -> None:
    """Wait for the work queued on every CUDA device that holds a tensor
    of `tree`."""
    for dev in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class Timer:
    """Wall-clock phase timer with a device sync at stop."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_on: Optional[Any] = None) -> float:
        if sync_on is not None:
            synchronize(sync_on)
        return time.perf_counter() - self._t0


def process_index() -> int:
    """This process's rank, 0 outside `torch.distributed`."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class MetricsLogger:
    """JSONL metrics on process 0. Each record gets a wall timestamp."""

    def __init__(self, path: Optional[str] = None, stream=None):
        """`path`: append JSONL to a file, opened at the first record;
        otherwise write to `stream` (default stderr). Only process 0
        emits."""
        self._path = path
        self._fh = None
        self._stream = stream

    def log(self, **record) -> None:
        if process_index() != 0:
            return
        record = {"ts": round(time.time(), 3), **{
            k: (float(v) if isinstance(v, torch.Tensor) else v)
            for k, v in record.items()}}
        line = json.dumps(record)
        if self._path:
            if self._fh is None:
                self._fh = open(self._path, "a")
            self._fh.write(line + "\n")
            self._fh.flush()
        else:
            print(line, file=self._stream or sys.stderr, flush=True)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
