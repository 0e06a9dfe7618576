#!/usr/bin/env python3
"""Reference results of the config runners on the CPU, for the gates of
`chip_smoke.py`'s `run_configs` phase (`RUN_REFERENCE`).

    JAX_PLATFORMS=cpu python3 scripts/runner_reference.py \
        [--package tpuflows|tpuflows_torch] [config ...]

Runs each config (default: the configs of `chip_smoke.RUN_REFERENCE`) as
written, or as a `chip_smoke.RUN_VARIANTS` entry changes it, at its own
seed and the next two, through the JAX package's runner (`tpuflows.run`)
and through the port's (`tpuflows_torch.run`, device "cpu"), or through
the one `--package` names, and prints one JSON line per run. For the
configs of `chip_smoke.RUN_MOMENTS` the line adds the package's own
`moment_gate` of the draws against the target's analytic mean and
variance, at the n_sigma given there (against its family threshold for
the configs of `chip_smoke.RUN_MOMENT_FAMILY`). Needs JAX:
run it where the tests run, not on the card's machine. On 8 CPU cores a
run takes, JAX / port: c2 about 2 minutes each, c6 and c7 seconds, c3
about 1 minute / 3 minutes, its two-round variant several minutes.
"""
import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
SEEDS = 3


def main(argv):
    import jax

    import chip_smoke

    parser = argparse.ArgumentParser()
    parser.add_argument("--package", choices=("tpuflows", "tpuflows_torch"))
    parser.add_argument("configs", nargs="*",
                        default=list(chip_smoke.RUN_REFERENCE))
    args = parser.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch
    from tpuflows import diagnostics as jax_diag
    from tpuflows import io as jax_io
    from tpuflows import run as jax_run
    from tpuflows.config import RunConfig as JaxConfig
    from tpuflows_torch import diagnostics as port_diag
    from tpuflows_torch import io as port_io
    from tpuflows_torch import run as port_run
    from tpuflows_torch.config import RunConfig as PortConfig

    def family(cfg):
        return cfg.name in chip_smoke.RUN_MOMENT_FAMILY

    def jax_moments(cfg, path, n_sigma):
        t = cfg.target.build()
        return jax_diag.moment_gate(jax_io.load_pytree(path), t.mean(),
                                    jnp.diagonal(t.cov()), n_sigma=n_sigma,
                                    family_correction=family(cfg))

    def port_moments(cfg, path, n_sigma):
        t = cfg.target.build(device="cpu")
        return port_diag.moment_gate(port_io.load_pytree(path),
                                     t.mean("cpu"),
                                     torch.diagonal(t.cov("cpu")),
                                     n_sigma=n_sigma,
                                     family_correction=family(cfg))

    runners = (("tpuflows", JaxConfig, jax_run._run_task, jax_moments),
               ("tpuflows_torch", PortConfig,
                lambda c: port_run._run_task(c, device="cpu"),
                port_moments))
    for name in args.configs:
        n_sigma = chip_smoke.RUN_MOMENTS.get(name)
        for package, config, run, moments in runners:
            if args.package not in (None, package):
                continue
            cfg = config.from_dict(chip_smoke.run_config_dict(name))
            for k in range(SEEDS):
                seeded = dataclasses.replace(cfg, seed=cfg.seed + k)
                with tempfile.TemporaryDirectory() as tmp:
                    if n_sigma is not None:
                        seeded = dataclasses.replace(seeded, output_dir=tmp)
                    t = time.perf_counter()
                    out = run(seeded)
                    seconds = time.perf_counter() - t
                    if n_sigma is not None:
                        out["moment_gate"] = moments(
                            seeded, f"{tmp}/{seeded.name}_state",
                            n_sigma)._asdict()
                print(json.dumps({"package": package, "config": name,
                                  "seed": seeded.seed, **out,
                                  "seconds": seconds}, default=float),
                      flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
