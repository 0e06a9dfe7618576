"""Where K6 and K7 (csrc/coupling_tile.cu) spend their time, by phase.

    python3 scripts/coupling_tile_phases.py     # on a machine with the card

Builds csrc/coupling_tile.cu with -DCOUPLING_TILE_PROFILE (thread 0 of
each CTA stamps clock64() at the phase marks of the source) beside the
library the wrappers load, runs K6 forward, K7 forward without the
weights' pass and K7 inverse with it at the fit's shape (1024 x 64,
hidden 128 x 128, K = 8, alternating mask) with the wrappers' default
plan, and prints one JSON line per kernel: the SM cycles between
consecutive marks, averaged over the CTAs, and the card's name and power
limit. Marks: 0 start, 1 input loaded, 4 + 2 l / 5 + 2 l hidden layer l's
product / gather done, 20 hidden layers done, 21 first chunk's raw values,
22 its spline, 23 its pullback through the last layer (K7), 24 all
chunks, 25-26 ladj (K6) or the cluster's sum of the partial cotangents
(K7), 27-28 and 31 K7's pullback down the hidden layers and its end.
"""
import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

MARKS = 32
MAX_CTAS = 4096


def main():
    import torch

    import chip_smoke as cs
    from tpuflows_torch.kernels import coupling_cuda as cc
    from tpuflows_torch.kernels.cuda_build import CudaLibrary, build

    if not torch.cuda.is_available():
        print("coupling_tile_phases.py: no CUDA device", file=sys.stderr)
        return 1

    def bind(lib):
        cc._bind(lib)
        lib.coupling_tile_profile.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.coupling_tile_profile.restype = ctypes.c_int

    prof = CudaLibrary("coupling_tile_profile", "coupling_tile.cu",
                       [("coupling_tile", ["-DCOUPLING_TILE_PROFILE"])],
                       ["rqs_math.cuh"], bind)
    build(prof)
    smi = cs.nvidia_smi_line()
    n, d, hidden, K, mask_name = cs.COUPLING_TIMING_SHAPES[0]
    mask = cs.coupling_mask(mask_name, d)
    nt = sum(1 for m in mask if m == 0)
    widths = [d, *hidden, (3 * K - 1) * d]
    x, params, gz, gl = cs.coupling_inputs("cuda", n, d, hidden, K, "n0.1",
                                           seed=n + d + K)
    real, cc.LIBRARY = cc.LIBRARY, prof
    try:
        for name, inverse, grad, need in (("k6_forward", False, False, False),
                                          ("k7_forward", False, True, False),
                                          ("k7_inverse", True, True, True)):
            spec = cc.BlockSpec(mask, K, 4.0, "silu", inverse)
            plan = cc.tile_plan(widths, K, nt, n, grad)
            for _ in range(3):  # warm, then keep the last launch's marks
                if grad:
                    cc._pass1(x, params, spec, widths, gz, gl, plan, need)
                else:
                    cc._launch_eval(x, params, spec, widths)
            torch.cuda.synchronize()
            host = torch.zeros(MAX_CTAS * MARKS, dtype=torch.int64)
            rc = prof.load().coupling_tile_profile(host.data_ptr(),
                                                   MAX_CTAS * MARKS)
            if rc != 0:
                raise RuntimeError(f"coupling_tile_profile: cudaError {rc}")
            ctas = -(-n // plan.rows) * cc.CLUSTER
            m = host[:ctas * MARKS].reshape(ctas, MARKS).double()
            seen = [k for k in range(MARKS) if bool((m[:, k] > 0).all())]
            seen.sort(key=lambda k: float(m[0, k]))
            phases = {f"{a}->{b}": float((m[:, b] - m[:, a]).mean())
                      for a, b in zip(seen[:-1], seen[1:])}
            print(json.dumps({
                "kernel": name, "plan": plan._asdict(), "ctas": ctas,
                "cycles": phases,
                "total_cycles": float((m[:, seen[-1]] - m[:, seen[0]])
                                      .mean()),
                "nvidia_smi": smi}), flush=True)
    finally:
        cc.LIBRARY = real
    return 0


if __name__ == "__main__":
    sys.exit(main())
