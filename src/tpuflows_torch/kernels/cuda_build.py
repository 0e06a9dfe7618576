"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `CudaLibrary` is one shared library with a plain C interface, made
from one `.cu` source compiled as one or more translation units (one per
set of `-D` flags), linked together and written to `build/kernels/` at the
repository root under a name that carries a hash of the sources, the
headers they include and the flags. A library is rebuilt only when that
hash changes. `build(*libs)` starts one nvcc process for every unit of
every library that is not built yet, all at once, then links each; nothing
is compiled or loaded when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# no --use_fast_math: the spline and the NUTS energies need IEEE expf/logf
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


class BuildInfo(NamedTuple):
    path: str
    seconds: float  # wall time of the build that made it; 0.0 if reused
    log: str  # nvcc / ptxas output (-Xptxas -v), empty when reused


class CudaLibrary:
    """One shared library: `source` compiled once per entry of `units`
    (name, extra nvcc flags), with `deps` (included headers) in the hash;
    `bind(lib)` sets the ctypes signatures after loading."""

    def __init__(self, name: str, source: str,
                 units: Sequence[tuple[str, list]], deps: Sequence[str],
                 bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = CSRC / source
        self.units = list(units)
        self.deps = [CSRC / d for d in deps]
        self.bind = bind
        self.lib: ctypes.CDLL | None = None
        self.info: BuildInfo | None = None

    def path(self) -> Path:
        h = hashlib.sha256()
        for f in (self.source, *self.deps):
            h.update(f.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        h.update(repr(self.units).encode())
        return BUILD_DIR / f"lib{self.name}_{h.hexdigest()[:16]}.so"

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first if needed."""
        if self.lib is None:
            build(self)
        return self.lib


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "tpuflows_torch are built on the GPU machine")
    return nvcc


def _run_all(jobs):
    """Runs every (argv, log_path) job at once; returns their exit codes.
    Kills whatever still runs if waiting is interrupted."""
    procs = []
    try:
        for argv, log in jobs:
            with open(log, "w") as f:
                procs.append(subprocess.Popen(argv, stdout=f,
                                              stderr=subprocess.STDOUT))
        return [p.wait() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def build(*libs: CudaLibrary) -> dict:
    """Compile and link every library of `libs` that is not on disk yet
    (all units in parallel), load all of them, and return {name:
    BuildInfo}. nvcc's output goes to stderr."""
    todo = [lib for lib in libs if lib.lib is None and not lib.path().exists()]
    seconds, logs = 0.0, {}
    if todo:
        nvcc = _nvcc()
        t0 = time.perf_counter()
        tmps, jobs = {}, []
        for lib in todo:
            out = lib.path()
            tmp = BUILD_DIR / f"tmp_{out.stem}_{os.getpid()}"
            tmp.mkdir(parents=True, exist_ok=True)
            tmps[lib.name] = tmp
            for unit, defs in lib.units:
                jobs.append(([nvcc, *NVCC_FLAGS, *defs, "-c", "-o",
                              str(tmp / f"{unit}.o"), str(lib.source)],
                             tmp / f"{unit}.log"))
        rcs = _run_all(jobs)
        for lib in todo:
            tmp = tmps[lib.name]
            logs[lib.name] = "".join((tmp / f"{u}.log").read_text()
                                     for u, _ in lib.units)
        if any(rcs):
            sys.stderr.write("".join(logs.values()))
            raise RuntimeError(f"nvcc failed (exit codes {rcs})")
        links = [([nvcc, *ARCH, "-shared", "-o",
                   str(tmps[lib.name] / lib.path().name),
                   *(str(tmps[lib.name] / f"{u}.o") for u, _ in lib.units)],
                  tmps[lib.name] / "link.log") for lib in todo]
        rcs = _run_all(links)
        for lib, (_, log) in zip(todo, links):
            logs[lib.name] += log.read_text()
        if any(rcs):
            sys.stderr.write("".join(logs.values()))
            raise RuntimeError(f"nvcc link failed (exit codes {rcs})")
        seconds = time.perf_counter() - t0
        for lib in todo:
            sys.stderr.write(logs[lib.name])
            os.replace(tmps[lib.name] / lib.path().name, lib.path())
            shutil.rmtree(tmps[lib.name], ignore_errors=True)
    for lib in libs:
        if lib.lib is None:
            path = lib.path()
            cdll = ctypes.CDLL(str(path))
            lib.bind(cdll)
            lib.lib = cdll
            built = lib.name in logs
            lib.info = BuildInfo(str(path), seconds if built else 0.0,
                                 logs.get(lib.name, ""))
    return {lib.name: lib.info for lib in libs}
