"""The wall time of the port's default build (the six libraries that
chip_smoke.py's build phase builds: K1, K4/K5, K6/K7 and their earlier
kernels, K3, K2; not the wide units, which build on first use) for each
source tree given, one after the other in the given order, each from an
empty build directory (`<tree>/build/kernels`), each in a process of its
own. Prints the card's name and power limit, then one JSON line per
build. To compare two commits, unpack each one's `src/` into a directory
and give both, in turns: A B B A.

    python scripts/build_time.py build/parent/src src src build/parent/src
"""
import json
import os
import shutil
import subprocess
import sys
import time

BUILD = r'''
import json, sys, time
sys.path.insert(0, sys.argv[1])
from tpuflows_torch.kernels import (coupling_cuda, cuda_build, fused_logp_cuda,
                                    nuts_cuda, nuts_window_cuda, rqs_cuda)
t = time.perf_counter()
infos = cuda_build.build(nuts_cuda.LIBRARY, rqs_cuda.LIBRARY,
                         coupling_cuda.LIBRARY, coupling_cuda.EARLIER,
                         fused_logp_cuda.LIBRARY, nuts_window_cuda.LIBRARY)
print(json.dumps({"seconds": time.perf_counter() - t,
                  "nvcc_seconds": max(i.seconds for i in infos.values())}))
'''


def main(trees):
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for src in trees:
        src = os.path.abspath(src)
        shutil.rmtree(os.path.join(os.path.dirname(src), "build", "kernels"),
                      ignore_errors=True)
        t = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", BUILD, src],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stderr[-2000:], file=sys.stderr)
            return out.returncode
        print(json.dumps({"tree": src, "wall_s": time.perf_counter() - t,
                          **json.loads(out.stdout.strip().splitlines()[-1])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
