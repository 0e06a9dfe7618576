"""K6 and K7 on Hopper: one whole RQS coupling block per tile of rows, and
its pullback (port of `tpuflows/kernels/coupling_pallas.py`).

  * the plain PyTorch version: `flatten_params` (the conditioner's flat
    parameters with the last layer relaid to p-major columns, a
    differentiable reshape outside the kernel), `block_math` (the Pallas
    body on a (T, d) tile, on top of `rqs_cuda`'s tile math), and
    `plain_block` / `plain_block_vjp`, its pullback by torch.autograd;
  * K6 and K7, hand-written CUDA (`csrc/coupling_tile.cu`): the
    conditioner, the spline and the masked ladj sum per row in one kernel,
    on tiles of rows whose cluster of CTAs shares every weight read; its
    pullback in two launches, per-row cotangents, then the weights'
    cotangents, a GEMM over the rows summed in a fixed order;
  * `tile_plan`, the launch plan (rows per tile, spline dims per chunk,
    the weight ring's stage, shared memory, pass 2's row slices), in
    Python so that the CPU tests reach it, made once per shapes;
  * `block_eval` / `block_grad`, the wrappers: a CPU tensor runs the plain
    version (in its own dtype), a CUDA tensor launches the kernel or the
    wrapper raises; `LAUNCHES` counts the kernels' launches (K7's second
    launch, when a weight needs its cotangent, counts too);
  * `earlier_block_eval` / `earlier_block_grad`: the kernels the tile
    design replaced (`csrc/coupling_block.cu`, 8 rows a block), kept built
    as the yardstick of the card's comparison and timing; no path calls
    them, and `EARLIER_LAUNCHES` counts their launches;
  * `FusedCouplingBlock`, the `torch.autograd.Function` whose forward is K6
    and whose backward is K7, and `fused_coupling_forward` /
    `fused_coupling_inverse` with the JAX package's signatures.

The conditioner computes in float32 (`flows/nets.py`); the JAX package's
opt-in bf16 operands (`compute_dtype`) and its "gelu" wait for ROADMAP
Queue 1 item 3. Importing this module compiles nothing.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from tpuflows_torch.flows.nets import _ACTIVATIONS
from tpuflows_torch.flows.rqs_ref import (
    DEFAULT_MIN_BIN,
    DEFAULT_MIN_DERIV,
    DEFAULT_RANGE,
)
from tpuflows_torch.kernels.cuda_build import CudaLibrary
from tpuflows_torch.kernels.rqs_cuda import (
    MAX_KNOTS,
    _fwd_tile_math,
    _inv_tile_math,
)
from tpuflows_torch.kernels.tile_flow import p_major

# kernel launches since the last reset, by kernel and direction
LAUNCHES = {"k6_forward": 0, "k6_inverse": 0, "k7_forward": 0,
            "k7_inverse": 0}
# launches of the earlier kernels (the yardstick), by the same keys
EARLIER_LAUNCHES = dict(LAUNCHES)
# K7's launches per call: pass 1, and pass 2 when a weight needs its
# cotangent
K7_LAUNCHES = {False: 1, True: 2}
MAX_LAYERS = 8
MAX_SMEM = 232448  # bytes of shared memory a block may opt in to
ACTIVATION_CODES = {"silu": 0, "tanh": 1, "relu": 2}


def _bind(lib):
    # pointers, host arrays of pointers or ints and streams are c_void_p
    p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
    lib.coupling_tile_smem.argtypes = [p] + [i32] * 6
    lib.coupling_tile_smem.restype = i64
    # x, mask, idx, ws, bs, widths, n_layers, N, d, nt, knots, range_limit,
    # activation, inverse, rows, dc, stage
    block = [p, p, p, p, p, p, i32, i64, i32, i32, i32, f32, i32, i32, i32,
             i32, i32]
    lib.coupling_tile_fwd_f32.argtypes = block + [p, p, p]
    lib.coupling_tile_fwd_f32.restype = i32
    lib.coupling_tile_bwd_f32.argtypes = block + [p] * 6
    lib.coupling_tile_bwd_f32.restype = i32
    lib.coupling_tile_wgrad_f32.argtypes = [p] * 5 + [i32, i64, i32, i32,
                                                      i32, p, i32, p]
    lib.coupling_tile_wgrad_f32.restype = i32


def _bind_earlier(lib):
    p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
    lib.coupling_rows8_smem.argtypes = [p, i32, i32, i32, i32, i32]
    lib.coupling_rows8_smem.restype = i64
    block = [p, p, p, p, p, p, i32, i64, i32, i32, i32, f32, i32, i32, i32]
    lib.coupling_rows8_fwd_f32.argtypes = block + [p, p, p]
    lib.coupling_rows8_fwd_f32.restype = i32
    lib.coupling_rows8_bwd_f32.argtypes = block + [p] * 6
    lib.coupling_rows8_bwd_f32.restype = i32
    lib.coupling_rows8_wgrad_f32.argtypes = [p] * 5 + [i32, i64, i32, i32,
                                                       i32, p, p]
    lib.coupling_rows8_wgrad_f32.restype = i32


LIBRARY = CudaLibrary("coupling_tile", "coupling_tile.cu",
                      [("coupling_tile", [])], ["rqs_math.cuh"], _bind)
EARLIER = CudaLibrary("coupling_rows8", "coupling_block.cu",
                      [("coupling_block", [])], ["rqs_math.cuh"],
                      _bind_earlier)


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        EARLIER_LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------
def _activation(name):
    if name not in _ACTIVATIONS:
        raise ValueError(f"activation {name!r} is not ported (the JAX "
                         f"package's 'gelu' waits for ROADMAP Queue 1 item "
                         f"3)")
    return _ACTIVATIONS[name]


def flatten_params(net, d: int, knots: int) -> tuple:
    """The conditioner as the flat tuple (w0, b0, w1, b1, ...), biases as
    (1, n) rows, with the last layer's columns relaid from d-major
    (j (3K-1) + p) to p-major (p d + j), so that spline parameter p of all
    dims is one contiguous slice. The relayout is differentiable: the
    cotangents reach the module's own parameters."""
    P = 3 * knots - 1
    ws, bs = list(net.weights), list(net.biases)
    ws[-1] = p_major(ws[-1], d, P)
    bs[-1] = p_major(bs[-1], d, P)
    out = []
    for w, b in zip(ws, bs):
        out.append(w)
        out.append(b.reshape(1, -1))
    return tuple(out)


def block_math(x2d, params, mask_vec, K, B, activation, inverse):
    """One coupling block on a (T, d) tile, as the Pallas body computes it:
    the conditioner on x * b, p-major slices of its last layer, the spline
    (forward, or inverse when `inverse`), z = b x + (1 - b) y and the
    masked ladj summed per row. Returns (z (T, d), ladj (T, 1)); `params`
    as `flatten_params` gives them, `mask_vec` (d,) or (1, d)."""
    act = _activation(activation)
    d = x2d.shape[-1]
    ws, bs = params[0::2], params[1::2]
    h = x2d * mask_vec
    for w, b in zip(ws[:-1], bs[:-1]):
        h = act(h @ w + b)
    raw_t = h @ ws[-1] + bs[-1]  # (T, P d), p-major
    P = 3 * K - 1
    raw = [raw_t[:, p * d:(p + 1) * d] for p in range(P)]
    tile_math = _inv_tile_math if inverse else _fwd_tile_math
    y, ladj_el = tile_math(x2d, raw, K, B, DEFAULT_MIN_BIN,
                           DEFAULT_MIN_DERIV)
    z = mask_vec * x2d + (1.0 - mask_vec) * y
    ladj = torch.sum((1.0 - mask_vec) * ladj_el, dim=-1, keepdim=True)
    return z, ladj


def plain_block(x2d, params, mask_vec, K, B, activation, inverse):
    """The plain version of K6 on any device: (z (T, d), ladj (T,))."""
    with torch.no_grad():
        z, ladj = block_math(x2d, params, mask_vec, K, B, activation,
                             inverse)
    return z, ladj[:, 0]


def plain_block_vjp(x2d, params, mask_vec, gz, gladj, K, B, activation,
                    inverse):
    """The plain version of K7: (dx, dparams), the autograd pullback of
    `block_math` with cotangents gz (T, d) and gladj (T,)."""
    with torch.enable_grad():
        xg = x2d.detach().requires_grad_(True)
        pg = [p.detach().requires_grad_(True) for p in params]
        z, ladj = block_math(xg, pg, mask_vec, K, B, activation, inverse)
        dx, *dps = torch.autograd.grad((z, ladj), (xg, *pg),
                                       (gz, gladj[:, None]))
    return dx, tuple(dps)


# ---------------------------------------------------------------------------
# The kernels and their wrappers
# ---------------------------------------------------------------------------
class BlockSpec(NamedTuple):
    """The static fields of a block: what the pullback needs besides the
    tensors."""
    mask: tuple
    knots: int
    range_limit: float
    activation: str
    inverse: bool


_MASKS = {}


def _mask_tensors(mask, device, dtype):
    """(mask (d,) in `dtype`, the spline dims (nt,) int32) on `device`,
    made once per mask and device."""
    key = (tuple(mask), str(device), dtype)
    if key not in _MASKS:
        m = torch.tensor(mask, dtype=dtype, device=device)
        idx = torch.tensor([j for j, b in enumerate(mask) if b == 0],
                           dtype=torch.int32, device=device)
        _MASKS[key] = (m, idx)
    return _MASKS[key]


def _check(x2d, params, spec, *cots):
    """Shapes, devices and dtypes of a call (one floating dtype for all),
    for the plain version and the kernels alike; returns the layer
    widths."""
    if x2d.dim() != 2:
        raise ValueError(f"x must be (N, d), got {tuple(x2d.shape)}")
    N, d = x2d.shape
    K = spec.knots
    if len(spec.mask) != d:
        raise ValueError(f"mask of {len(spec.mask)} dims for x of {d}")
    if not 2 <= K <= MAX_KNOTS:
        raise ValueError(f"the kernels take 2..{MAX_KNOTS} knots, got {K}")
    if len(params) % 2 or not 2 <= len(params) <= 2 * MAX_LAYERS:
        raise ValueError(f"the kernels take 1..{MAX_LAYERS} layers as (w, "
                         f"b) pairs, got {len(params)} tensors")
    widths = [d]
    for w, b in zip(params[0::2], params[1::2]):
        if w.dim() != 2 or w.shape[0] != widths[-1]:
            raise ValueError(f"weight {tuple(w.shape)} does not follow a "
                             f"layer of width {widths[-1]}")
        if b.numel() != w.shape[1]:
            raise ValueError(f"bias of {b.numel()} values for weight "
                             f"{tuple(w.shape)}")
        widths.append(int(w.shape[1]))
    if widths[-1] != (3 * K - 1) * d:
        raise ValueError(f"the last layer has {widths[-1]} columns, not "
                         f"(3 K - 1) d = {(3 * K - 1) * d}")
    if not x2d.dtype.is_floating_point:
        raise TypeError(f"the block takes floating tensors, got {x2d.dtype}")
    for t in (*params, *cots):
        if t.device != x2d.device:
            raise ValueError(f"a tensor is on {t.device}, x on {x2d.device}")
        if t.dtype != x2d.dtype:
            raise TypeError(f"a tensor is {t.dtype}, x {x2d.dtype}")
    for t, shape in zip(cots, ((N, d), (N,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"cotangent {tuple(t.shape)} is not {shape}")
    _activation(spec.activation)
    return widths


def _check_kernel(x2d, params, *cots):
    for t in (x2d, *params, *cots):
        if t.dtype != torch.float32:
            raise TypeError(f"the coupling-block kernels take float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the coupling-block kernels take contiguous "
                             "tensors")


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _ints(xs):
    return (ctypes.c_int * len(xs))(*xs)


# ---------------------------------------------------------------------------
# The launch plan of the tile kernels (csrc/coupling_tile.cu `make_layout`,
# `col_groups`, `stage_rows`, `ct_of`; the card checks that both sides
# agree on the shared memory)
# ---------------------------------------------------------------------------
# rows of a tile in the plan's order of preference: 16, the fastest on the
# card at the fit's shape and at d = 256 (PERF.md §6), halved where
# the shared memory requires it
TILE_ROWS = (16, 8)
CLUSTER = 2  # CTAs of a cluster, each over a slice of every layer
THREADS = 256
RING_STAGES = 4
# floats of a ring stage, in the plan's order of preference; 0: no ring,
# K6's weights read from L2 (where wide activations leave it no room)
STAGE_FLOATS = (8448, 4224, 2112)
WGRAD_TILE = 64  # pass 2's output tiles, WGRAD_TILE^2 weights each
WGRAD_SLICES = (1, 2, 4, 8)
CARD_SMS = 132  # streaming multiprocessors of an H100 SXM


class TilePlan(NamedTuple):
    rows: int  # rows of a tile
    dc: int  # spline dims per chunk of the last layer
    stage: int  # floats of a weight-ring stage, 0 without a ring
    smem: int  # bytes of dynamic shared memory a CTA takes
    slices: int  # pass 2: CTAs of a cluster over the rows


def _up4(n):
    return (n + 3) & ~3


def col_groups(rows):
    """Column groups of a product: 256 threads over rows / 4 row groups."""
    return THREADS * 4 // rows


def stage_rows(stage, ow):
    """Reduction rows of a ring stage of `stage` floats for panels of ow
    outputs (at a pitch of ow + 4): a multiple of 16, at most 128."""
    return min(128, (stage // (ow + 4)) & ~15)


def ct_of(rows, n_out, stage):
    """Columns per thread of a product of n_out outputs (csrc `ct_of`):
    of 1, 2 and 4, the fewest padded columns x (4 + 2 / CT) instructions
    per reduction step, among those whose panel is at most one column per
    thread and leaves a stage 16 rows; the wider on a tie."""
    tc, best, cost = col_groups(rows), 1, None
    for ct in (1, 2, 4):
        ow = ct * tc
        if ow > THREADS or stage_rows(stage, ow) < 16:
            break
        c = -(-n_out // ow) * ow * (8 + 4 // ct)
        if cost is None or c <= cost:
            best, cost = ct, c
    return best


def tile_smem(widths, knots, rows, dc, stage, grad):
    """Bytes of dynamic shared memory of a K6 (grad False) or K7 pass-1
    CTA: the chunk's column map, two activation buffers of rows x the
    widest layer input, the chunk's raw values, K6's ladj slots or K7's
    act'(a) of each hidden layer over the CTA's slice, and the ring."""
    P = 3 * knots - 1
    n = len(widths) - 1
    floats = _up4(P * dc) + 2 * rows * max(widths[:-1]) + rows * P * dc
    if grad:
        floats += sum(rows * -(-widths[l + 1] // CLUSTER)
                      for l in range(n - 1))
    else:
        floats += rows * dc + rows
    floats += RING_STAGES * stage
    return 4 * floats


def wgrad_tiles(widths, knots, nt):
    """Pass 2's output tiles: (in_l + 1) x out_l per layer, the last
    layer's over the spline dims' P nt columns."""
    outs = [*widths[1:-1], (3 * knots - 1) * nt]
    return sum(-(-(a + 1) // WGRAD_TILE) * -(-b // WGRAD_TILE)
               for a, b in zip(widths[:-1], outs))


def wgrad_slices(widths, knots, nt, n_rows):
    """Pass 2's row slices: doubled until the tiles times the slices fill
    two CTAs per SM, at most 8, and at least 64 rows a slice."""
    tiles, S = wgrad_tiles(widths, knots, nt), 1
    while S < WGRAD_SLICES[-1] and tiles * S < 2 * CARD_SMS \
            and n_rows >= 64 * 2 * S:
        S *= 2
    return S


def tile_plan(widths, knots, nt, n_rows, grad):
    """The launch plan of K6 (grad False) or K7 (grad True) for a block of
    layer widths `widths` with nt spline dims on n_rows rows, made once
    per shapes (`_tile_plan`). Raises where nothing fits."""
    return _tile_plan(tuple(widths), knots, nt, n_rows, bool(grad))


@functools.lru_cache(maxsize=256)
def _tile_plan(widths, knots, nt, n_rows, grad):
    """The first plan whose shared memory fits: 16 rows a tile, else 8;
    the spline dims of a chunk at most 32 and at most a CTA's share; the
    largest ring stage with which the chunk keeps at least 8 dims (or all
    of a smaller share), else the chunk halved down to 1 dim with the
    smallest stage. K6 then drops the ring (stage 0: its weights read from
    L2), which takes every shape the earlier 8-row layout took."""
    dc0 = min(32, max(1, -(-nt // CLUSTER)))
    dcs = [dc0]
    while dcs[-1] > 1:
        dcs.append((dcs[-1] + 1) // 2)
    tries = []
    for R in TILE_ROWS:
        tries += [(R, st, dc) for st in STAGE_FLOATS for dc in dcs
                  if dc >= min(dc0, 8)]
        tries += [(R, STAGE_FLOATS[-1], dc) for dc in dcs
                  if dc < min(dc0, 8)]
    if not grad:
        tries += [(R, 0, dc) for R in TILE_ROWS for dc in dcs]
    for R, stage, dc in tries:
        smem = tile_smem(widths, knots, R, dc, stage, grad)
        if smem <= MAX_SMEM:
            return TilePlan(R, dc, stage, smem,
                            wgrad_slices(widths, knots, nt, n_rows))
    raise ValueError(f"a coupling block of widths {list(widths)} needs more "
                     f"than {MAX_SMEM} bytes of shared memory per CTA at "
                     f"every tile of {TILE_ROWS} rows")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launched(rc, name, key, counts=LAUNCHES):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    counts[key] += 1


def _common(x2d, params, spec, widths):
    """The leading arguments shared by K6 and K7 pass 1."""
    N, d = x2d.shape
    mask, idx = _mask_tensors(spec.mask, x2d.device, torch.float32)
    ws, bs = params[0::2], params[1::2]
    return [x2d.data_ptr(), mask.data_ptr(), idx.data_ptr(), _ptrs(ws),
            _ptrs(bs), _ints(widths), len(ws), N, d, idx.numel(),
            spec.knots, float(spec.range_limit),
            ACTIVATION_CODES[spec.activation], int(spec.inverse)]


def _spline_dims(spec, device):
    return _mask_tensors(spec.mask, device, torch.float32)[1].numel()


def _launch_eval(x2d, params, spec, widths):
    _check_kernel(x2d, params)
    z = torch.empty_like(x2d)
    ladj = torch.empty(x2d.shape[0], dtype=x2d.dtype, device=x2d.device)
    N = x2d.shape[0]
    if N == 0:
        return z, ladj
    plan = tile_plan(widths, spec.knots, _spline_dims(spec, x2d.device), N,
                     False)
    lib = LIBRARY.load()
    with torch.cuda.device(x2d.device):
        rc = lib.coupling_tile_fwd_f32(
            *_common(x2d, params, spec, widths), plan.rows, plan.dc,
            plan.stage, z.data_ptr(), ladj.data_ptr(),
            _stream(x2d))
    _launched(rc, "coupling_tile_fwd_f32 (K6)",
              "k6_inverse" if spec.inverse else "k6_forward")
    return z, ladj


def _k7_key(spec):
    return "k7_inverse" if spec.inverse else "k7_forward"


def _pass1(x2d, params, spec, widths, gz, gladj, plan, need_params):
    """K7's first launch: dx and, when `need_params`, the transposed scratch
    of every layer's input H_l (in_l, N) and pre-activation cotangent G_l
    (out_l, N; the last layer's over the spline dims, P nt rows)."""
    N = x2d.shape[0]
    nt = _spline_dims(spec, x2d.device)
    dx = torch.empty_like(x2d)
    Hs = Gs = None
    if need_params:
        outs = [*widths[1:-1], (3 * spec.knots - 1) * nt]
        Hs = [torch.empty((w, N), dtype=x2d.dtype, device=x2d.device)
              for w in widths[:-1]]
        Gs = [torch.empty((w, N), dtype=x2d.dtype, device=x2d.device)
              for w in outs]
    lib = LIBRARY.load()
    with torch.cuda.device(x2d.device):
        rc = lib.coupling_tile_bwd_f32(
            *_common(x2d, params, spec, widths), plan.rows, plan.dc,
            plan.stage, gz.data_ptr(), gladj.data_ptr(),
            dx.data_ptr(),
            _ptrs(Hs) if Hs else None, _ptrs(Gs) if Gs else None,
            _stream(x2d))
    _launched(rc, "coupling_tile_bwd_f32 (K7, pass 1)", _k7_key(spec))
    return dx, Hs, Gs


def _pass2(x2d, params, spec, widths, plan, Hs, Gs):
    """K7's second launch: every weight's and bias's cotangent from pass
    1's scratch, the last layer's pass-through columns 0."""
    N, d = x2d.shape
    _, idx = _mask_tensors(spec.mask, x2d.device, torch.float32)
    dps = [torch.empty_like(p) for p in params[:-2]]
    dps += [torch.zeros_like(params[-2]), torch.zeros_like(params[-1])]
    lib = LIBRARY.load()
    with torch.cuda.device(x2d.device):
        rc = lib.coupling_tile_wgrad_f32(
            _ptrs(Hs), _ptrs(Gs), _ptrs(dps[0::2]), _ptrs(dps[1::2]),
            _ints(widths), len(Hs), N, d, idx.numel(), spec.knots,
            idx.data_ptr(), plan.slices, _stream(x2d))
    _launched(rc, "coupling_tile_wgrad_f32 (K7, pass 2)", _k7_key(spec))
    return tuple(dps)


def _launch_grad(x2d, params, spec, widths, gz, gladj, need_params):
    _check_kernel(x2d, params, gz, gladj)
    N = x2d.shape[0]
    if N == 0:
        return (torch.empty_like(x2d),
                tuple(torch.zeros_like(p) for p in params)
                if need_params else None)
    plan = tile_plan(widths, spec.knots, _spline_dims(spec, x2d.device), N,
                     True)
    dx, Hs, Gs = _pass1(x2d, params, spec, widths, gz, gladj, plan,
                        need_params)
    if not need_params:
        return dx, None
    return dx, _pass2(x2d, params, spec, widths, plan, Hs, Gs)


# ---------------------------------------------------------------------------
# The earlier kernels (csrc/coupling_block.cu): the yardstick, on no path
# ---------------------------------------------------------------------------
def _rows8_dc(lib, widths, d, K, grad):
    """Spline dims per chunk of an earlier kernel's launch: 32, halved
    until its tile's shared memory fits."""
    dc = 32
    while True:
        smem = lib.coupling_rows8_smem(_ints(widths), len(widths) - 1, d,
                                       K, dc, int(grad))
        if smem <= MAX_SMEM or dc == 1:
            break
        dc //= 2
    if smem > MAX_SMEM:
        raise ValueError(f"a coupling block of widths {widths} needs {smem} "
                         f"bytes of shared memory, above {MAX_SMEM}")
    return dc


def _earlier_check(x2d, params, spec, *cots):
    widths = _check(x2d, params, spec, *cots)
    if x2d.device.type != "cuda":
        raise ValueError("the earlier coupling-block kernels run on a CUDA "
                         f"device only, not {x2d.device}")
    _check_kernel(x2d, params, *cots)
    return widths


def earlier_block_eval(x2d, params, spec: BlockSpec):
    """(z, ladj) by the earlier K6 (8 rows a block), on a CUDA tensor."""
    widths = _earlier_check(x2d, params, spec)
    z = torch.empty_like(x2d)
    ladj = torch.empty(x2d.shape[0], dtype=x2d.dtype, device=x2d.device)
    if x2d.shape[0] == 0:
        return z, ladj
    lib = EARLIER.load()
    dc = _rows8_dc(lib, widths, x2d.shape[1], spec.knots, False)
    with torch.cuda.device(x2d.device):
        rc = lib.coupling_rows8_fwd_f32(
            *_common(x2d, params, spec, widths), dc, z.data_ptr(),
            ladj.data_ptr(), _stream(x2d))
    _launched(rc, "coupling_rows8_fwd_f32 (earlier K6)",
              "k6_inverse" if spec.inverse else "k6_forward",
              EARLIER_LAUNCHES)
    return z, ladj


def earlier_block_grad(x2d, params, spec: BlockSpec, gz, gladj,
                       need_params=True):
    """(dx, dparams) by the earlier K7 (two launches), on CUDA tensors."""
    widths = _earlier_check(x2d, params, spec, gz, gladj)
    N, d = x2d.shape
    if N == 0:
        return (torch.empty_like(x2d),
                tuple(torch.zeros_like(p) for p in params)
                if need_params else None)
    lib = EARLIER.load()
    key = _k7_key(spec)
    dc = _rows8_dc(lib, widths, d, spec.knots, True)
    _, idx = _mask_tensors(spec.mask, x2d.device, torch.float32)
    nt, P = idx.numel(), 3 * spec.knots - 1
    dx = torch.empty_like(x2d)
    Hs = Gs = None
    if need_params:
        outs = [*widths[1:-1], P * nt]
        Hs = [torch.empty((N, w), dtype=x2d.dtype, device=x2d.device)
              for w in widths[:-1]]
        Gs = [torch.empty((N, w), dtype=x2d.dtype, device=x2d.device)
              for w in outs]
    with torch.cuda.device(x2d.device):
        rc = lib.coupling_rows8_bwd_f32(
            *_common(x2d, params, spec, widths), dc, gz.data_ptr(),
            gladj.data_ptr(), dx.data_ptr(),
            _ptrs(Hs) if Hs else None, _ptrs(Gs) if Gs else None,
            _stream(x2d))
    _launched(rc, "coupling_rows8_bwd_f32 (earlier K7, pass 1)", key,
              EARLIER_LAUNCHES)
    if not need_params:
        return dx, None
    dps = [torch.empty_like(p) for p in params[:-2]]
    dps += [torch.zeros_like(params[-2]), torch.zeros_like(params[-1])]
    with torch.cuda.device(x2d.device):
        rc = lib.coupling_rows8_wgrad_f32(
            _ptrs(Hs), _ptrs(Gs), _ptrs(dps[0::2]), _ptrs(dps[1::2]),
            _ints(widths), len(Hs), N, d, nt, spec.knots, idx.data_ptr(),
            _stream(x2d))
    _launched(rc, "coupling_rows8_wgrad_f32 (earlier K7, pass 2)", key,
              EARLIER_LAUNCHES)
    return dx, tuple(dps)


def block_eval(x2d, params, spec: BlockSpec):
    """(z (N, d), ladj (N,)) of the block: the plain version for a CPU
    tensor (in its dtype), K6 for a CUDA tensor."""
    widths = _check(x2d, params, spec)
    if x2d.device.type == "cpu":
        mask, _ = _mask_tensors(spec.mask, x2d.device, x2d.dtype)
        return plain_block(x2d, params, mask, spec.knots,
                           float(spec.range_limit), spec.activation,
                           spec.inverse)
    if x2d.device.type == "cuda":
        return _launch_eval(x2d, params, spec, widths)
    raise ValueError(f"no coupling-block kernel for device {x2d.device}")


def block_grad(x2d, params, spec: BlockSpec, gz, gladj, need_params=True):
    """(dx, dparams) of the block's pullback, dparams None unless
    `need_params`: the plain version for a CPU tensor, K7 for a CUDA
    tensor."""
    widths = _check(x2d, params, spec, gz, gladj)
    if x2d.device.type == "cpu":
        mask, _ = _mask_tensors(spec.mask, x2d.device, x2d.dtype)
        dx, dps = plain_block_vjp(x2d, params, mask, gz, gladj, spec.knots,
                                  float(spec.range_limit), spec.activation,
                                  spec.inverse)
        return dx, (dps if need_params else None)
    if x2d.device.type == "cuda":
        return _launch_grad(x2d, params, spec, widths, gz, gladj,
                            need_params)
    raise ValueError(f"no coupling-block kernel for device {x2d.device}")


class FusedCouplingBlock(torch.autograd.Function):
    """(z, ladj) = block(x2d; params), forward or inverse as `spec` says;
    its backward recomputes the block in K7 from (x2d, params) and the
    cotangents, and gives the parameters' cotangents only when one of them
    needs it (not in the STL loss's forward pass, whose parameters are
    detached)."""

    @staticmethod
    def forward(ctx, x2d, spec, *params):
        x2d = x2d.contiguous()
        params = tuple(p.contiguous() for p in params)
        ctx.save_for_backward(x2d, *params)
        ctx.spec = spec
        return block_eval(x2d, params, spec)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gz, gladj):
        x2d, *params = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dps = block_grad(x2d, tuple(params), ctx.spec, gz.contiguous(),
                             gladj.contiguous(), need_params=any(need[2:]))
        if dps is None:
            dps = (None,) * len(params)
        return (dx if need[0] else None, None,
                *(g if n else None for g, n in zip(dps, need[2:])))


def _apply(x, net, mask, knots, range_limit, inverse):
    d = len(mask)
    lead = x.shape[:-1]
    spec = BlockSpec(tuple(int(m) for m in mask), int(knots),
                     float(range_limit), net.activation, inverse)
    z2d, ladj = FusedCouplingBlock.apply(
        x.reshape(-1, d), spec, *flatten_params(net, d, knots))
    return z2d.reshape(*lead, d), ladj.reshape(lead)


def fused_coupling_forward(x, net, mask, knots,
                           range_limit: float = DEFAULT_RANGE):
    """Whole-block forward: z = b x + (1 - b) spline(x; net(x b)) and the
    masked ladj, for x of shape (..., d). Drop-in for
    `RQSCouplingBlock.forward_and_ladj`."""
    return _apply(x, net, mask, knots, range_limit, False)


def fused_coupling_inverse(z, net, mask, knots,
                           range_limit: float = DEFAULT_RANGE):
    """Whole-block analytic inverse and its ladj (the conditioner sees
    z b == x b)."""
    return _apply(z, net, mask, knots, range_limit, True)
