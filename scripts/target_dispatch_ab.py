"""Where the funnel's K1 and K3 lose time to the target library: the
kernels as they are (A: a funnel's K1 and K3 tile kernels from their
funnel-only units, -DTARGETS_FUNNEL_ONLY) against copies of their sources
with changes, built at DPL 1, 2 and 8 only (d = 8, 64, 256) and timed
from CUDA graphs in turns (A G M S F I I F S M G A) at the funnel rows of
chip_smoke.py (the ceiling's affine flow and the generic arqs flow, 1024
chains, depth 6, random inputs) and at targets_vs_plain's rows under the
runner's nuts variants' flows (correlated d = 8 under c2's, hierarchical
d = 256 under c5's; depth 4):

  G  every target through the generic units' dispatch, the funnel too
     (the kernels before the funnel-only units); each variant below is G
     with one more change:
  M  loads and stores without the lane mask (rows with d = d_pad only);
  S  the funnel's sigma_v read from the launch arguments (an Args field,
     as before the target library) instead of the packed buffer;
  F  M and S, and the dispatch cut to the funnel alone (the kernels'
     shape before the target library; funnel rows only);
  I  every target's function inlined into the dispatch (no call left
     in it).

Every variant must give the same bits as A. Prints the card's name and
power limit, one JSON line per row, and writes them to
chiprun_out/target_dispatch_ab.json.

    python scripts/target_dispatch_ab.py
"""
import json
import os
import re
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tpuflows_torch.kernels import cuda_build, fused_logp_cuda  # noqa: E402
from tpuflows_torch.kernels import nuts_cuda  # noqa: E402
from tpuflows_torch.kernels.cuda_build import CudaLibrary  # noqa: E402
from tpuflows_torch.targets import NealsFunnel  # noqa: E402

SRC = os.path.join(ROOT, "src", "tpuflows_torch", "csrc")
SIGMA_V = 3.0  # NealsFunnel's default, the rows' target


def sub(path, old, new, count=None):
    """Replace `old` by `new` in the file, `count` times (every time when
    None); raises where the text is not there as often."""
    s = open(path).read()
    n = s.count(old)
    if n == 0 or (count is not None and n != count):
        raise RuntimeError(f"{os.path.basename(path)}: {old!r} found {n} "
                           f"times")
    open(path, "w").write(s.replace(old, new))


def generic(d):
    for f in ("nuts_transition.cu", "fused_logp.cu"):
        sub(f"{d}/{f}", "return a.kind == kFunnel", "return false", 1)


def unmasked(d):
    sub(f"{d}/nuts_tree_body.inc", "const bool in = i < dim;",
        "const bool in = true;", 1)
    sub(f"{d}/nuts_tree_body.inc", "if (lane + 32 * j < dim)", "if (true)",
        1)
    sub(f"{d}/fused_logp.cu", "z[j] = lane + 32 * j < a.dim",
        "z[j] = true")
    sub(f"{d}/fused_logp.cu", "if (lane + 32 * j < a.dim)", "if (true)")


def sigma_by_value(d):
    sub(f"{d}/latent_grad.cuh", "  float max_delta_energy;\n",
        "  float max_delta_energy;\n  float sv;\n", 1)
    sub(f"{d}/targets.cuh", "const float sv = __ldg(a.target);",
        "const float sv = a.sv;", 1)
    for f in ("nuts_transition.cu", "fused_logp.cu"):
        sub(f"{d}/{f}", "a.dim = dim;", f"a.dim = dim; a.sv = {SIGMA_V}f;")


def funnel_only(d):
    sub(f"{d}/targets.cuh", "#ifdef TARGETS_FUNNEL_ONLY", "#if 1", 1)


def all_inlined(d):
    sub(f"{d}/targets.cuh", "__device__ __noinline__ float",
        "__device__ __forceinline__ float")


VARIANTS = {"G": (generic,), "M": (generic, unmasked),
            "S": (generic, sigma_by_value),
            "F": (generic, unmasked, sigma_by_value, funnel_only),
            "I": (generic, all_inlined)}
DPLS = ("1", "2", "8")


def variant_libs(key, edits):
    """K1's and K3's libraries from a copy of csrc/ with `edits`, built
    at DPLS alone: the entry points launch DPL 2 at any other width."""
    d = os.path.join(ROOT, "build", f"csrc_ab_{key}")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(SRC, d)
    for f in ("nuts_transition.cu", "fused_logp.cu"):
        s = open(f"{d}/{f}").read()
        open(f"{d}/{f}", "w").write(re.sub(
            r"(launch_(?:tile_for|chain))<[34567]>", r"\1<2>", s))
    for e in edits:
        e(d)
    libs = []
    for lib in (nuts_cuda.LIBRARY, fused_logp_cuda.LIBRARY):
        units = [u for u in lib.units if u[0] == "entry"
                 or u[0].rstrip("f")[3:] in DPLS]
        libs.append(CudaLibrary(
            f"{lib.name}_ab_{key}", os.path.join(d, lib.source.name), units,
            [os.path.join(d, x.name) for x in lib.deps], lib.bind))
    return tuple(libs)


def model_dim(flow):
    return flow.transforms[0].loc.numel()


def main():
    print(cs.nvidia_smi_line(), flush=True)
    libs = {"A": (nuts_cuda.LIBRARY, fused_logp_cuda.LIBRARY)}
    for key, edits in VARIANTS.items():
        libs[key] = variant_libs(key, edits)
    t = time.time()
    infos = cuda_build.build(*(x for pair in libs.values() for x in pair))
    print(json.dumps({"build_s": time.time() - t}), flush=True)
    ptx = {name: {k: v for k, v in cs.ptxas_summary(info.log).items()
                  if "tile" in k}
           for name, info in infos.items()}

    def use(key):
        nuts_cuda.LIBRARY, fused_logp_cuda.LIBRARY = libs[key]

    dev = "cuda"
    rows = [("funnel 64 ceiling affine",
             cs.bench_flow_with_random_head(dev, 2), None),
            ("funnel 64 generic arqs", cs.spline_flow_with_random_heads(
                dev, 74), None)]
    for (kind, _), config in cs.TARGET_TILE_ROWS.items():
        rows.append((f"{kind} under {config}'s flow",
                     cs.config_flow(dev, config, 7000), kind))
    out = {"card": cs.nvidia_smi_line(), "ptxas": ptx, "rows": []}
    for label, flow, kind in rows:
        if kind is None:
            target, depth = NealsFunnel(64), 6
            model = nuts_cuda.pack_flow(flow, target)
            q, im, *rnd = cs.card_inputs(dev, 1024, 64, depth, 3, True)
            e = torch.tensor(0.3, device=dev)
        else:
            target = cs.smoke_target(kind, model_dim(flow), dev)
            depth = cs.TARGET_DEPTH
            model = nuts_cuda.pack_flow(flow, target)
            q = cs.target_start(target, flow, kind, 1024, 7000, dev)
            g = torch.Generator(device=dev).manual_seed(7000)
            im = 0.5 + torch.rand(model.d, generator=g, device=dev)
            rnd = nuts_cuda.draw_randomness(g, 1024, model.d, depth, im)
            e = torch.tensor(cs.TARGET_EPS[kind], device=dev)
        keys = [k for k in libs if k == "A" or (
            (k != "M" or model.d == model.d_pad)
            and (k != "F" or kind is None))]
        res, outs = {"label": label, "variants": keys}, {}
        for key in keys + keys[::-1]:
            use(key)
            k1 = cs.graph_ms(lambda: nuts_cuda._launch(
                q, *rnd, e, im, model, depth), reps=10, replays=3)
            k3 = cs.graph_ms(lambda: fused_logp_cuda._launch(q, model),
                             reps=20, replays=5)
            res.setdefault(key, []).append((k1, k3))
            outs[key] = (*nuts_cuda._launch(q, *rnd, e, im, model, depth),
                         *fused_logp_cuda._launch(q, model))
        use("A")
        for key in keys:
            res[key + "_k1_ms"] = sum(x[0] for x in res[key]) / 2
            res[key + "_k3_ms"] = sum(x[1] for x in res[key]) / 2
            res[key + "_same_bits"] = all(
                torch.equal(a, b) for a, b in zip(outs["A"], outs[key]))
        print(json.dumps(res), flush=True)
        out["rows"].append(res)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "target_dispatch_ab.json"),
              "w") as f:
        json.dump(out, f)
    if not all(r[k + "_same_bits"] for r in out["rows"]
               for k in r["variants"]):
        raise SystemExit("a variant gave other bits than A")


if __name__ == "__main__":
    main()
