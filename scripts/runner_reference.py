#!/usr/bin/env python3
"""Reference results of the config runners on the CPU, for the gates of
`chip_smoke.py`'s `run_configs` phase (`RUN_REFERENCE`).

    JAX_PLATFORMS=cpu python3 scripts/runner_reference.py [config ...]

Runs each config (default: c1_std_normal_affine and c2_correlated_rqs) as
written, at its own seed and the next two, through the JAX package's
runner (`tpuflows.run`) and through the port's (`tpuflows_torch.run`,
device "cpu"), and prints one JSON line per run. Needs JAX: run it where
the tests run, not on the card's machine. c2 takes about 2 minutes a run
in each package.
"""
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
CONFIGS = ("c1_std_normal_affine", "c2_correlated_rqs")
SEEDS = 3


def main(argv):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tpuflows import run as jax_run
    from tpuflows.config import RunConfig as JaxConfig
    from tpuflows_torch import run as port_run
    from tpuflows_torch.config import RunConfig as PortConfig

    for name in argv or CONFIGS:
        path = os.path.join(ROOT, "configs", f"{name}.json")
        for package, load, run in (
                ("tpuflows", JaxConfig.from_json, jax_run._run_task),
                ("tpuflows_torch", PortConfig.from_json,
                 lambda c: port_run._run_task(c, device="cpu"))):
            cfg = load(path)
            for k in range(SEEDS):
                seeded = dataclasses.replace(cfg, seed=cfg.seed + k)
                t = time.perf_counter()
                out = run(seeded)
                print(json.dumps({"package": package, "config": name,
                                  "seed": seeded.seed, **out,
                                  "seconds": time.perf_counter() - t}),
                      flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
