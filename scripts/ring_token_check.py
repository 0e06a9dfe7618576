"""Token check of the port's CUDA units against an earlier revision.

    git archive <rev> src/tpuflows_torch/csrc | tar -x -C <dir>
    python3 scripts/ring_token_check.py <dir>/src/tpuflows_torch/csrc
    python3 scripts/ring_token_check.py --as-is <dir>/src/tpuflows_torch/csrc

Preprocesses every unit of K1 (nuts_transition.cu), K2 (nuts_window.cu)
and K3 (fused_logp.cu), per DPL and the entry unit, and the single units
of K4/K5 (rqs_spline.cu) and K6/K7 (coupling_tile.cu), at the old and the
current revision (`g++ -E -P` with empty `cuda_runtime.h` and
`cooperative_groups.h`), specializes the current tokens to the tile
kernels' ring instantiation (kResident = false: `if constexpr (kResident)
{...}` and the template parameter dropped, as csrc/tile_grad.cuh writes
them; not with `--as-is`, for an old revision that has the resident
instantiation too), splits both into top-level definitions (namespaces
transparent) and prints, per unit, whether the whole units' tokens are
equal, else the old definitions that no longer appear unchanged. Needs
g++; no nvcc.
"""
import re
import subprocess
import sys
import tempfile
from pathlib import Path

TOK = re.compile(r'"(?:\\.|[^"\\])*"|\'(?:\\.|[^\'\\])*\'|[A-Za-z_]\w*|'
                 r'\d[\w.]*(?:[eE][+-]\d+)?\w*|::|->|<<=|>>=|<<|>>|<=|>=|==|'
                 r'!=|&&|\|\||\+\+|--|[-+*/%&|^!=]=|\S')


def tokens(path, defs, inc, stub):
    out = subprocess.run(["g++", "-E", "-P", "-x", "c++", "-I", inc,
                          "-I", stub, *defs, path],
                         capture_output=True, text=True, check=True).stdout
    return TOK.findall(out)


def balanced(t, i):
    """The index after the balanced {...} that starts at t[i] == '{'."""
    assert t[i] == "{"
    depth = 0
    for j in range(i, len(t)):
        depth += t[j] == "{"
        depth -= t[j] == "}"
        if depth == 0:
            return j + 1
    raise ValueError


def ring(t):
    """The tokens of the ring instantiation (kResident = false)."""
    out, i = [], 0
    while i < len(t):
        if t[i:i + 5] == ["if", "constexpr", "(", "kResident", ")"]:
            j = balanced(t, i + 5)
            if j < len(t) and t[j] == "else":
                k = balanced(t, j + 1)
                t = t[:i] + t[j + 2:k - 1] + t[k:]
            else:
                t = t[:i] + t[j:]
            continue
        if t[i:i + 7] == ["template", "<", "bool", "kResident", "=",
                          "false", ">"]:
            i += 7
            continue
        for pat in ([",", "bool", "kResident", "=", "false"],
                    [",", "bool", "kResident"], [",", "kResident"]):
            if t[i:i + len(pat)] == pat:
                i += len(pat)
                break
        else:
            if t[i:i + 3] == ["<", "kResident", ">"]:
                i += 3
                continue
            out.append(t[i])
            i += 1
    return out


def definitions(t):
    """Top-level definitions and declarations, namespaces transparent."""
    defs, cur, depth, i = [], [], 0, 0
    while i < len(t):
        if depth == 0 and t[i] == "namespace":
            j = i + 1
            while t[j] != "{":
                j += 1
            i = j + 1
            continue  # transparent
        if depth == 0 and t[i] == "}" and not cur:
            i += 1  # a namespace's end
            continue
        cur.append(t[i])
        depth += t[i] == "{"
        depth -= t[i] == "}"
        if depth == 0 and t[i] in ("}", ";"):
            if t[i] == "}" and i + 1 < len(t) and t[i + 1] == ";":
                cur.append(";")
                i += 1
            defs.append(" ".join(cur))
            cur = []
        i += 1
    return defs


def name_of(d):
    m = re.findall(r"(\w+) \(", d)
    return m[0] if m else d[:60]


def check(unit, defs, old_dir, new_dir, stub, as_is):
    old = tokens(f"{old_dir}/{unit}", defs, old_dir, stub)
    new = tokens(f"{new_dir}/{unit}", defs, new_dir, stub)
    rn = new if as_is else ring(new)
    od, nd = definitions(old), set(definitions(rn))
    missing = [d for d in od if d not in nd]
    equal = old == rn
    return equal, [name_of(d) for d in missing], len(od)


def main(old_dir, new_dir, as_is):
    with tempfile.TemporaryDirectory() as stub:
        for header in ("cuda_runtime.h", "cooperative_groups.h"):
            (Path(stub) / header).touch()
        for unit, macro in (("nuts_transition.cu", "NUTS_DPL"),
                            ("nuts_window.cu", "NUTS_DPL"),
                            ("fused_logp.cu", "LATENT_DPL"),
                            ("rqs_spline.cu", None),
                            ("coupling_tile.cu", None)):
            for k in ["entry"] + (list(range(1, 9)) if macro else []):
                defs = [] if k == "entry" else [f"-D{macro}={k}"]
                eq, missing, n = check(unit, defs, old_dir, new_dir, stub,
                                       as_is)
                print(unit, k, "whole unit equal" if eq else
                      f"{n} old definitions, missing"
                      f"{'' if as_is else ' after ring'}: {missing}")


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--as-is"]
    main(args[0], args[1] if len(args) > 1 else
         str(Path(__file__).resolve().parents[1] / "src" / "tpuflows_torch"
             / "csrc"), "--as-is" in sys.argv[1:])
