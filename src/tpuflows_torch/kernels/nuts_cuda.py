"""K1 on Hopper: the fused NUTS transition (port of
`tpuflows/kernels/nuts_pallas.py`, `make_fused_nuts_transition` and
`fused_nuts_for_flow`).

Three pieces:
  * `transition_math_torch` — the plain PyTorch version: the portable
    NUTS transition `mcmc.nuts.nuts_transition_math` (a step-by-step port
    of `_transition_math`, one batched transition with masked lockstep over
    the whole batch) with a divergent leaf's non-finite values zeroed, as
    the kernel does. Its gradient (`plain_logp_grad`) comes from
    `torch.autograd.grad` on the port's own flow modules, or, for flows
    with spline couplings, from `tile_flow.tile_logp_and_grad_streamed` on
    the p-major relayout, as in the JAX package. It runs on any device;
  * `nuts_transition` — the wrapper. A CPU tensor goes to the plain
    version; a CUDA tensor goes to the hand-written kernel
    `csrc/nuts_transition.cu` (the flow as a module list on tiles of
    `tile_rows(model)` chains in lockstep, `csrc/tile_grad.cuh`, its
    weights through a ring or, for a small flow, resident in shared
    memory: `launch_resident`), or the wrapper raises. There is no
    fallback from one to the other. `LAUNCHES` counts the kernel's
    launches;
  * `FusedNUTS` / `fused_nuts_for_flow` — the batched transition that
    `NUTSDriver(transition=...)` calls: it draws the randomness (momenta,
    direction signs, acceptance uniforms, one uniform per potential leaf)
    with a `torch.Generator` on the chains' device (`draw_randomness`) and
    calls the wrapper.

`pack_flow` checks a flow and packs its leaves for the kernel: any Chain
of Standardize, AffineCoupling and RQSCouplingBlock modules goes to
`nuts_chain_tile_kernel` as a module list. `chain_transition_warp` runs
the per-warp module-list kernel (`nuts_chain_kernel`) and
`affine_transition_warp` the per-warp kernel of Standardize + one
AffineCoupling (`nuts_transition_kernel`, which ran the ceiling path
before the tile kernel took it); neither is on a path: they are
`chip_smoke.py`'s oracle and yardstick for the tile kernel.
The library is built with nvcc into `build/kernels/` at the repository
root on first use (`cuda_build`); nothing is compiled or loaded at
import time.
"""
from __future__ import annotations

import ctypes
import struct
from typing import Callable, NamedTuple

import torch

from tpuflows_torch.flows.affine import AffineCoupling, Standardize
from tpuflows_torch.flows.core import Chain
from tpuflows_torch.flows.coupling import RQSCouplingBlock
from tpuflows_torch.kernels.cuda_build import CudaLibrary
from tpuflows_torch.kernels.tile_flow import (p_major, permute_for_tiles,
                                              tile_logp_and_grad_streamed)
from tpuflows_torch.mcmc.hmc import value_and_grad
from tpuflows_torch.mcmc.nuts import (draw_randomness, nuts_info,
                                      nuts_transition_math)
from tpuflows_torch.mcmc.preconditioned import flow_reparameterized
from tpuflows_torch.targets.funnel import NealsFunnel

# kernel launches since the last reset (the main path's proof of use)
LAUNCHES = 0

MAX_DIM = 256
MAX_DEPTH = 10
MAX_MODULES = 16
MOD_INTS = 8  # ints per module in the kernel's module list
KIND = {Standardize: 0, AffineCoupling: 1, RQSCouplingBlock: 2}
SMEM_LIMIT = 232448  # dynamic shared memory one block may use (bytes)
# the most rows (chains) of a tile of the module-list kernels: 8 warps of
# K1's up to 255 registers a thread fill the SM's 65,536
MAX_TILE_ROWS = 8
# a tile's weight ring (csrc/tile_grad.cuh kRingStages, kRingStageFloats):
# 3 stages of 32 KB, smaller only where one row leaves less room
RING_STAGES = 3
RING_STAGE_FLOATS = 8192
# energy error above which a leaf counts as divergent (the JAX kernel's
# default)
MAX_DELTA_ENERGY = 1000.0
# one translation unit per instantiation (d / 32 dims per lane) plus the
# C entry points, compiled in parallel
_UNITS = [("entry", [])] + [(f"dpl{k}", [f"-DNUTS_DPL={k}"])
                             for k in range(1, MAX_DIM // 32 + 1)]


def _bind(lib):
    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.nuts_transition_f32
    fn.argtypes = [p] * 8 + [i32] * 5 + [f32] * 3 + [p] * 3
    fn.restype = i32
    fn = lib.nuts_chain_transition_f32
    fn.argtypes = [p] * 9 + [i32] * 6 + [f32] * 2 + [p] * 2 + [i32, i32, p]
    fn.restype = i32
    fn = lib.nuts_chain_transition_warp_f32
    fn.argtypes = [p] * 9 + [i32] * 6 + [f32] * 2 + [p] * 3
    fn.restype = i32


LIBRARY = CudaLibrary("nuts_transition", "nuts_transition.cu", _UNITS,
                      ["latent_grad.cuh", "tile_grad.cuh", "nuts_tree.cuh",
                       "nuts_tree_body.inc", "rqs_math.cuh"], _bind)


def _float_bits(x: float) -> int:
    return struct.unpack("<i", struct.pack("<f", float(x)))[0]


class PackedFlow(NamedTuple):
    """A flow over Neal's funnel, checked and packed for K1."""

    flow: Chain
    target: NealsFunnel
    params: torch.Tensor  # packed leaves, see csrc/nuts_transition.cu
    mods: torch.Tensor  # (n_modules, MOD_INTS) int32: the module list
    d: int
    h1: int  # widths and clamp of the first coupling (the ones
    h2: int  # the per-warp affine kernels take)
    clamp: float
    hidden: tuple  # every coupling's hidden widths
    hmax: int  # widest hidden layer
    head: int  # widest conditioner output
    affine: bool  # Standardize + one AffineCoupling (the per-warp yardsticks)
    flow_p: Chain | None  # p-major relayout (flows with splines)
    resident_floats: int  # the resident layers' floats, 0 if not one coupling


def _unsupported(msg):
    return ValueError(
        "the fused NUTS kernel takes a Chain of Standardize, AffineCoupling "
        f"and RQSCouplingBlock with 3-layer float32 silu MLPs over a funnel "
        f"of the flow's width: {msg}")


def _unported(what):
    """A module or conditioner the JAX package's in-kernel flow math takes
    and the port's does not yet (ROADMAP Queue 2 item B)."""
    return _unsupported(f"{what} (ROADMAP Queue 2 item B)")


def _coupling_leaves(t, d):
    """(leaves, h1, h2, n_out) of a coupling, the spline's last layer
    relaid out p-major; transposed weight copies for the backward."""
    ws, bs = list(t.net.weights), list(t.net.biases)
    if t.net.compute_dtype != "f32":
        raise _unported(f"a conditioner with compute_dtype="
                        f"{t.net.compute_dtype!r}")
    if t.net.activation not in ("silu", "tanh", "relu"):
        raise _unported(f"a {t.net.activation} conditioner")
    if len(ws) != 3 or t.net.activation != "silu":
        raise _unsupported("its conditioner must be a 3-layer silu MLP")
    if len(t.mask) != d:
        raise _unsupported(f"a mask of width {len(t.mask)} in a flow of "
                           f"width {d}")
    h1, h2 = ws[0].shape[1], ws[1].shape[1]
    spline = isinstance(t, RQSCouplingBlock)
    n_out = (3 * t.knots - 1) * d if spline else 2 * d
    if (ws[0].shape != (d, h1) or ws[1].shape != (h1, h2)
            or ws[2].shape != (h2, n_out)):
        raise _unsupported(f"MLP widths {[tuple(w.shape) for w in ws]} do "
                           f"not match the flow width d={d}")
    w3, b3 = ws[2], bs[2]
    if spline:
        w3, b3 = p_major(w3, d, 3 * t.knots - 1), p_major(b3, d,
                                                         3 * t.knots - 1)
    leaves = [t.mask_f, ws[0], bs[0], ws[1], bs[1], w3, b3, ws[0].t(),
              ws[1].t(), w3.t()]
    return leaves, h1, h2, n_out


def _pad32(n: int) -> int:
    return -(-n // 32) * 32


def _compact_leaves(t, d, w3, b3):
    """The tile kernels' copies of a coupling's first and last layers,
    without the work that cannot reach lp or g (the conditioner sees
    z * mask; only the transformed dims' head parameters are used): W1's
    rows and W1^T's columns of the pass-through dims in dim order, and
    W3's columns, b3's entries and W3^T's rows of the transformed dims'
    head parameters, p-major over those dims (column p n_t + t for the
    t-th transformed dim; w3, b3 come p-major over all d dims). Each
    compact width is padded with zeros to a multiple of 32. Returns
    (leaves, number of pass-through dims)."""
    dev = w3.device
    mask = torch.as_tensor(t.mask, device=dev).bool()
    keep = torch.nonzero(mask).flatten()
    moved = torch.nonzero(~mask).flatten()
    n_p, n_t = keep.numel(), moved.numel()
    n_param = w3.shape[1] // d
    cols = (torch.arange(n_param, device=dev)[:, None] * d
            + moved[None, :]).reshape(-1)
    w1 = t.net.weights[0].detach().float()
    w1c = torch.zeros((_pad32(n_p), w1.shape[1]), device=dev)
    w1c[:n_p] = w1[keep]
    w3c = torch.zeros((w3.shape[0], _pad32(n_param * n_t)), device=dev)
    w3c[:, :cols.numel()] = w3.detach().float()[:, cols]
    b3c = torch.zeros(w3c.shape[1], device=dev)
    b3c[:cols.numel()] = b3.detach().float()[cols]
    return [w1c, w1c.t(), w3c, b3c, w3c.t()], n_p


def _resident_floats(n_in: int, h1: int, h2: int, n_head: int) -> int:
    """Floats of the resident copy of a coupling's compact forward layers
    (csrc/tile_grad.cuh `tile_resident_floats`): W1 (n_in x h1), W2 (h1 x
    h2) and W3 (h2 x n_head), each row padded by one float so that a warp
    reading a layer transposed hits 32 banks."""
    return n_in * (h1 + 1) + h1 * (h2 + 1) + h2 * (n_head + 1)


def pack_flow(flow: Chain, target: NealsFunnel) -> PackedFlow:
    """Check that K1 computes `flow` (a Chain of Standardize,
    AffineCoupling and RQSCouplingBlock modules whose conditioners are
    3-layer float32 silu MLPs, over a funnel of the flow's width; any other
    module, Whiten, Identity and ScannedRepeat included, and a gelu or
    bf16 conditioner raise ValueError, naming ROADMAP Queue 2 item B where
    the JAX package's kernel takes them) and pack its
    leaves in chain order: Standardize loc, log_scale; a coupling's mask,
    W1, b1, W2, b2, W3, b3, W1^T, W2^T, W3^T, a spline's last layer in
    p-major columns; each coupling's leaves are followed by the tile
    kernels' compact copies of its first and last layers
    (`_compact_leaves`), at the offset its row of the module list holds in
    column 6, with the number of pass-through dims in column 7; the
    per-warp kernels read neither. For Standardize + one AffineCoupling
    the buffer up to the compact copies is the per-warp affine kernels'
    `Net` (the per-warp affine kernels, yardsticks now, read it)."""
    if not isinstance(flow, Chain):
        raise _unported(f"a {type(flow).__name__} that is not in a Chain")
    ts = list(flow.transforms)
    if not 1 <= len(ts) <= MAX_MODULES:
        raise _unsupported(f"{len(ts)} modules (1 to {MAX_MODULES})")
    for t in ts:
        if type(t) not in KIND:
            raise _unported(f"module {type(t).__name__}")
    first = ts[0]
    d = (first.loc.numel() if isinstance(first, Standardize)
         else len(getattr(first, "mask", ())))
    if not isinstance(target, NealsFunnel) or target.dim != d:
        raise _unsupported("the target must be a NealsFunnel of the flow's "
                           "width")
    affine = (len(ts) == 2 and isinstance(ts[0], Standardize)
              and isinstance(ts[1], AffineCoupling))
    parts, rows, widths, resident, off = [], [], [], [], 0
    for t in ts:
        kind = KIND[type(t)]
        if kind == 0:
            if t.loc.numel() != d:
                raise _unsupported(f"a Standardize of width "
                                   f"{t.loc.numel()} in a flow of width {d}")
            leaves, row = [t.loc, t.log_scale], [0, off, 0, 0, 0, 0]
        else:
            leaves, h1, h2, n_out = _coupling_leaves(t, d)
            spline = kind == 2
            row = [kind, off, h1, h2, t.knots if spline else 0,
                   _float_bits(t.range_limit if spline else t.clamp)]
            compact, n_pass = _compact_leaves(t, d, leaves[5], leaves[6])
            row += [off + sum(x.numel() for x in leaves), n_pass]
            leaves = leaves + compact
            widths.append((h1, h2, n_out, t.range_limit if spline
                           else t.clamp))
            resident.append(_resident_floats(
                _pad32(n_pass), h1, h2,
                _pad32(n_out // d * (d - n_pass))))
        parts += leaves
        rows.append(row + [0] * (MOD_INTS - len(row)))
        off += sum(x.numel() for x in leaves)
    if off >= 2 ** 31:
        raise _unsupported(f"{off} parameters (the kernel indexes them "
                           f"with 32-bit ints)")
    with torch.no_grad():
        params = torch.cat([p.detach().float().reshape(-1) for p in parts])
    mods = torch.tensor(rows, dtype=torch.int32, device=params.device)
    h1, h2, _, clamp = widths[0] if widths else (0, 0, 0, 0.0)
    has_spline = any(isinstance(t, RQSCouplingBlock) for t in ts)
    hidden = tuple(h for w in widths for h in w[:2])
    return PackedFlow(
        flow, target, params.contiguous(), mods, d, h1, h2, clamp, hidden,
        max(hidden, default=0),
        max((w[2] for w in widths), default=0), affine,
        permute_for_tiles(flow) if has_spline else None,
        resident[0] if len(resident) == 1 else 0)


def autograd_logp_grad(flow: Chain, log_density: Callable) -> Callable:
    """z (T, d) -> (lp (T, 1), d lp / dz (T, d)) for
    lp = log_density(f^-1(z)) + ladj, by torch.autograd."""
    value_grad = value_and_grad(flow_reparameterized(log_density, flow))

    def logp_grad(z):
        lp, g = value_grad(z)
        return lp[:, None], g

    return logp_grad


def transition_math_torch(q, p0, dirs, u_acc, u_take, eps, inv_mass,
                          logp_grad, max_depth):
    """K1's plain version: `mcmc.nuts.nuts_transition_math` (the JAX
    package's `_transition_math`, step by step, with exact selects) with
    the non-finite values of a divergent leaf zeroed, as the kernel does.

    logp_grad: (n, d) -> ((n, 1), (n, d)). Same returns as
    `nuts_transition_math`."""
    return nuts_transition_math(q, p0, dirs, u_acc, u_take, eps, inv_mass,
                                logp_grad, max_depth, MAX_DELTA_ENERGY,
                                zero_nonfinite=True)


def check_inputs(q, p0, dirs, u_acc, u_take, eps, inv_mass, model,
                  max_depth, window=1, out=None):
    """Shapes, dtypes and devices of K1's inputs, and of K2's for a
    window of `window` slots: then p0, dirs, u_acc and u_take are `window`
    times as wide (slot-major in each row) and the draws go to `out`
    (window, n, d) when it is given."""
    if not 1 <= max_depth <= MAX_DEPTH:
        raise ValueError(f"max_depth must be in [1, {MAX_DEPTH}], got "
                         f"{max_depth}")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.ndim != 2:
        raise ValueError(f"q must be (n, d), got {tuple(q.shape)}")
    n, d = q.shape
    if d != model.d:
        raise ValueError(f"q has width {d}, the flow takes {model.d}")
    S, D = window, max_depth
    want = {"q": (n, d), "p0": (n, S * d), "dirs": (n, S * D),
            "u_acc": (n, S * D), "u_take": (n, S << D), "eps": (),
            "inv_mass": (d,)}
    got = {"q": q, "p0": p0, "dirs": dirs, "u_acc": u_acc,
           "u_take": u_take, "eps": eps, "inv_mass": inv_mass}
    if out is not None:
        got["out"], want["out"] = out, (S, n, d)
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def check_launch(q, tensors, model: PackedFlow):
    """Raises unless the kernel takes the packed flow's widths, every one
    of `tensors` is contiguous and the packed flow is on q's device (K1's
    and K2's launches)."""
    check_widths(model)
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
    if model.params.device != q.device or model.mods.device != q.device:
        raise ValueError("the packed flow is on another device than q")


def smem_bytes(model: PackedFlow) -> int:
    """Dynamic shared memory of one row of the module-list kernels (one
    warp of the per-warp kernels, one row of a tile of the tile kernels:
    K1's, K2's and K3's)."""
    return 4 * ((model.mods.shape[0] + 1) * model.d + 4 * model.hmax
                + model.head)


def ring_stage_floats(model: PackedFlow, rows: int) -> int:
    """Floats of one stage of the weight ring of a tile of `rows` rows
    (csrc/tile_grad.cuh `tile_ring_stage`): RING_STAGE_FLOATS, or, where
    that does not fit in SMEM_LIMIT beside the rows, the most that does in
    a multiple of 256 rows floats (a chunk of at least 4 rows of the
    widest panel); 0 where not even that fits."""
    room = (SMEM_LIMIT - rows * smem_bytes(model)) // 4
    stage = min(RING_STAGE_FLOATS, max(room, 0) // RING_STAGES)
    return stage - stage % (256 * rows)


def tile_smem_bytes(model: PackedFlow, rows: int) -> int:
    """Dynamic shared memory of a tile of `rows` rows of the tile kernels:
    each row's scratch and the weight ring (csrc/tile_grad.cuh
    `tile_smem_bytes`)."""
    return rows * smem_bytes(model) + 4 * RING_STAGES * ring_stage_floats(
        model, rows)


def tile_rows(model: PackedFlow) -> int:
    """Rows R of a tile of the module-list kernels (K1's, K2's and K3's),
    which share every weight read over their R rows: the largest power of
    two up to MAX_TILE_ROWS whose R rows of scratch leave room for the
    whole 96 KB weight ring in SMEM_LIMIT. 8 at the generic arqs flow (~10 KB a
    row), 2 at d = 256, K = 16 (~54 KB a row); 1, with a smaller ring,
    where one row leaves less room (d = 256, K > 40)."""
    rows = 1
    while (rows * 2 <= MAX_TILE_ROWS
           and ring_stage_floats(model, 2 * rows) == RING_STAGE_FLOATS):
        rows *= 2
    return rows


def check_tile(model: PackedFlow, rows: int):
    """Raises unless a tile of `rows` rows of the module-list tile kernels
    fits in a block: the rows' scratch and a weight ring of at least one
    chunk a stage (`ring_stage_floats`)."""
    if not 1 <= rows <= MAX_TILE_ROWS or rows & (rows - 1):
        raise ValueError(f"tile rows must be a power of two up to "
                         f"{MAX_TILE_ROWS}, got {rows}")
    if ring_stage_floats(model, rows) == 0:
        raise ValueError(
            f"a tile of {rows} rows needs {rows * smem_bytes(model)} bytes "
            f"of shared memory and a weight ring of at least "
            f"{4 * RING_STAGES * 256 * rows} bytes, over {SMEM_LIMIT}")


def launch_rows(model: PackedFlow, rows: int | None = None) -> int:
    """The tile rows a launch of the tile kernels takes (K1's, K2's and
    K3's, for every flow): `tile_rows(model)` unless `rows` is given,
    refused where `check_tile` refuses it."""
    rows = tile_rows(model) if rows is None else rows
    check_tile(model, rows)
    return rows


def resident_fits(model: PackedFlow, rows: int) -> bool:
    """Whether the tile kernels can keep the flow's weights resident in
    shared memory at a tile of `rows` rows (csrc/tile_grad.cuh
    `tile_resident_fits`): the module list has one coupling and its
    compact forward layers fit beside the rows' scratch in SMEM_LIMIT.
    True at the ceiling's affine flow at R = 8; false at the generic arqs
    flow (six couplings) and at h = 256 (W2 alone is 263 KB)."""
    return (model.resident_floats > 0
            and rows * smem_bytes(model) + 4 * model.resident_floats
            <= SMEM_LIMIT)


def launch_resident(model: PackedFlow, rows: int,
                    resident: bool | None = None) -> int:
    """The `resident` argument of a tile launch of K1, K2 or K3: the
    resident layers' floats where they fit at `rows` (`resident_fits`),
    else 0 (the ring). `resident` True asks for the resident mode and
    raises where it does not fit; False asks for the ring (`chip_smoke.py`
    times both)."""
    fits = resident_fits(model, rows)
    if resident and not fits:
        raise ValueError(f"the flow's weights do not stay resident beside "
                         f"a tile of {rows} rows in {SMEM_LIMIT} bytes")
    return model.resident_floats if fits and resident is not False else 0


def lockstep_gradients(n_steps: torch.Tensor, rows: int) -> int:
    """Latent gradients a tile lockstep of `rows` chains computes for one
    transition with these leapfrog counts (info's n_steps, chains in tile
    order), counted per tile, not per row: one at the start point, then in
    doubling i the most leaves of any chain of the tile, where a chain's
    doubling i has min(2^i, max(0, n_steps - (2^i - 1))) leaves. With
    one tile of the whole batch this is the number of gradient calls of
    `transition_math_torch`; with rows = 1 it is sum(n_steps) + n. A
    ragged last tile counts as a whole one."""
    steps = n_steps.detach().to("cpu", torch.int64).reshape(-1)
    n = steps.numel()
    pad = (-n) % rows
    if pad:  # padding chains repeat the last one, as the kernel's do
        steps = torch.cat([steps, steps[-1:].expand(pad)])
    tiles = steps.reshape(-1, rows)
    calls = tiles.shape[0]
    i = 0
    while bool((tiles >= (1 << i)).any()):  # some chain reached doubling i
        leaves = torch.clamp(tiles - ((1 << i) - 1), 0, 1 << i)
        calls += int(leaves.amax(dim=1).sum())
        i += 1
    return calls


def check_widths(model: PackedFlow):
    """Raises unless the warp-per-row device code (K1's, and K3's, which
    shares its gradient) takes the packed flow's widths."""
    if model.d > MAX_DIM or model.d % 32:
        raise ValueError(f"the kernel takes d % 32 == 0 and d <= {MAX_DIM},"
                         f" got d={model.d}")
    for w in model.hidden:
        if w > MAX_DIM or w % 32:
            raise ValueError(f"the kernel takes hidden widths % 32 == 0 and "
                             f"<= {MAX_DIM}, got {w}")
    if smem_bytes(model) > SMEM_LIMIT:
        raise ValueError(f"the flow needs {smem_bytes(model)} bytes of "
                         f"shared memory per chain, over {SMEM_LIMIT}")


def _call(name, q, args):
    """Entry point `name` of the library with `args` and q's stream, on
    q's card; raises if the launch failed."""
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        rc = getattr(lib, name)(
            *args, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _outputs(q, model, ins):
    """K1's outputs (q', info (7, n)) and the pointer arguments of a
    module-list launch up to info."""
    n, d = q.shape
    check_launch(q, ins, model)
    q_out = torch.empty_like(q)
    info = torch.empty((7, n), device=q.device, dtype=torch.float32)
    return q_out, info, [t.data_ptr() for t in ins]


def _launch(q, p0, dirs, u_acc, u_take, eps, inv_mass, model, max_depth,
            rows=None, resident=None):
    """K1 on the card: the tile kernel on tiles of `rows` chains, its
    weights resident where they fit (the wrapper's `tile_rows(model)` and
    `launch_resident`; `chip_smoke.py` times other R and the ring)."""
    global LAUNCHES
    n, d = q.shape
    ins = (q, p0, dirs, u_acc, u_take, eps, inv_mass, model.params)
    q_out, info, ptrs = _outputs(q, model, ins)
    rows = launch_rows(model, rows)
    _call("nuts_chain_transition_f32", q, [
        *ptrs, model.mods.data_ptr(), model.mods.shape[0], n, d,
        model.hmax, model.head, max_depth, model.target.sigma_v,
        MAX_DELTA_ENERGY, q_out.data_ptr(), info.data_ptr(), rows,
        launch_resident(model, rows, resident)])
    LAUNCHES += 1
    return (q_out, *info.unbind(0))


def _yardstick(q, p0, dirs, u_acc, u_take, eps, inv_mass, model,
               max_depth):
    """Checks of the per-warp kernels' launches; their pointers and
    outputs."""
    if q.device.type != "cuda":
        raise ValueError("the per-warp kernels take CUDA tensors")
    check_inputs(q, p0, dirs, u_acc, u_take, eps, inv_mass, model,
                 max_depth)
    return _outputs(q, model, (q, p0, dirs, u_acc, u_take, eps, inv_mass,
                               model.params))


def chain_transition_warp(q, p0, dirs, u_acc, u_take, eps, inv_mass,
                          model: PackedFlow, max_depth: int):
    """The per-warp module-list kernel (`nuts_chain_kernel`) on CUDA
    tensors: `chip_smoke.py`'s oracle and yardstick for the tile kernel,
    which must equal it in value, on every flow. On no path, and not
    counted in LAUNCHES. Same returns as `nuts_transition`."""
    q_out, info, ptrs = _yardstick(q, p0, dirs, u_acc, u_take, eps,
                                   inv_mass, model, max_depth)
    n, d = q.shape
    _call("nuts_chain_transition_warp_f32", q, [
        *ptrs, model.mods.data_ptr(), model.mods.shape[0], n, d,
        model.hmax, model.head, max_depth, model.target.sigma_v,
        MAX_DELTA_ENERGY, q_out.data_ptr(), info.data_ptr()])
    return (q_out, *info.unbind(0))


def affine_transition_warp(q, p0, dirs, u_acc, u_take, eps, inv_mass,
                           model: PackedFlow, max_depth: int):
    """The per-warp kernel of Standardize + one AffineCoupling
    (`nuts_transition_kernel`, `logp_grad` on the `Net` prefix of the
    packed buffer), which ran the ceiling path before the tile kernel:
    `chip_smoke.py`'s yardstick of the earlier design. On no path, and not
    counted in LAUNCHES. Same returns as `nuts_transition`."""
    if not model.affine:
        raise ValueError("the per-warp affine kernel takes Standardize + "
                         "one AffineCoupling")
    q_out, info, ptrs = _yardstick(q, p0, dirs, u_acc, u_take, eps,
                                   inv_mass, model, max_depth)
    n, d = q.shape
    _call("nuts_transition_f32", q, [
        *ptrs, n, d, model.h1, model.h2, max_depth, model.clamp,
        model.target.sigma_v, MAX_DELTA_ENERGY, q_out.data_ptr(),
        info.data_ptr()])
    return (q_out, *info.unbind(0))


def plain_logp_grad(model: PackedFlow) -> Callable:
    """The plain version's gradient: the streamed per-block backward on
    the p-major relayout for flows with splines (as the JAX package's
    `fused_nuts_for_flow`), else autograd through the whole flow."""
    if model.flow_p is not None:
        return lambda z: tile_logp_and_grad_streamed(
            model.flow_p, z, model.target.log_density)
    return autograd_logp_grad(model.flow, model.target.log_density)


def nuts_transition(q, p0, dirs, u_acc, u_take, eps, inv_mass,
                    model: PackedFlow, max_depth: int):
    """One NUTS transition of every chain, with the randomness given.

    A CPU tensor runs `transition_math_torch` with `plain_logp_grad`; a
    CUDA tensor launches K1's tile kernel on tiles of `tile_rows(model)`
    chains, the weights resident where they fit (`launch_resident`). Same
    returns as `transition_math_torch`."""
    check_inputs(q, p0, dirs, u_acc, u_take, eps, inv_mass, model,
                  max_depth)
    if q.device.type == "cpu":
        return transition_math_torch(q, p0, dirs, u_acc, u_take, eps,
                                     inv_mass, plain_logp_grad(model),
                                     max_depth)
    if q.device.type == "cuda":
        return _launch(q, p0, dirs, u_acc, u_take, eps, inv_mass, model,
                       max_depth)
    raise ValueError(f"no NUTS transition for device {q.device}")


class FusedNUTS:
    """Batched flow-preconditioned NUTS transition for
    `NUTSDriver(transition=...)`: `(generator, q, eps, inv_mass) ->
    (q_new, NUTSInfo)` on the latent density log p(f^-1(z)) + ladj.

    The flow's parameters are packed for K1 when this is constructed, so
    build it after the flow is trained."""

    def __init__(self, target: NealsFunnel, flow: Chain, max_depth: int = 8):
        self.model = pack_flow(flow, target)
        self.max_depth = max_depth

    def __call__(self, generator, q, eps, inv_mass):
        n, d = q.shape
        eps = torch.as_tensor(eps, dtype=torch.float32, device=q.device)
        p0, dirs, u_acc, u_take = draw_randomness(
            generator, n, d, self.max_depth, inv_mass)
        q_prop, lp, sum_acc, n_steps, depth, div, turn, h0 = nuts_transition(
            q, p0, dirs, u_acc, u_take, eps, inv_mass, self.model,
            self.max_depth)
        return q_prop, nuts_info(lp, sum_acc, n_steps, depth, div, turn, h0)


def fused_nuts_for_flow(target: NealsFunnel, flow: Chain,
                        max_depth: int = 8) -> FusedNUTS:
    """The fused transition for flow-preconditioned NUTS on `target`
    (the north-star path); drop into `NUTSDriver(transition=...)`."""
    return FusedNUTS(target, flow, max_depth=max_depth)
