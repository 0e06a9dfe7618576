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
    memory: `launch_resident`) or, past the tile kernels' reach
    (`wide_path`: d > 256, max_depth > 10, a row too wide for shared
    memory), to K1's wide unit `csrc/nuts_transition_wide.cu` (one warp a
    chain, its vectors in a per-launch work buffer), or the wrapper
    raises. There is no fallback from one to the other. `LAUNCHES` counts
    the tile kernel's launches, `WIDE_LAUNCHES` the wide unit's;
  * `FusedNUTS` / `fused_nuts_for_flow` — the batched transition that
    `NUTSDriver(transition=...)` calls: it draws the randomness (momenta,
    direction signs, acceptance uniforms, one uniform per potential leaf)
    with a `torch.Generator` on the chains' device (`draw_randomness`) and
    calls the wrapper.

`pack_flow` checks a flow and packs its leaves for the kernel: any Chain
of Standardize, Whiten, AffineCoupling and RQSCouplingBlock modules whose
conditioners are MLPs of 1 to 8 layers of any hidden widths up to
MAX_HIDDEN with any activation of `flows/nets.py` and float32 or bf16
operands, as the JAX package's in-kernel flow math takes them (or none:
the flow-less transition), goes to the kernels as a module list, padded
once to the lane width `_pad32(d)` and each hidden width to a multiple of
32, over any closed-form target of the port (`pack_target`:
`csrc/targets.cuh` on the card, its mirror `packed_log_density` in the
plain version), at any d <= MAX_DIM = 1024, for trees of max_depth up to
MAX_DEPTH = 16. What it packs, the kernels launch; what they do not take
it refuses.
`chain_transition_warp` runs the per-warp module-list kernel
(`nuts_chain_kernel`), on no path: `chip_smoke.py`'s oracle and
yardstick for the tile kernel.
The library is built with nvcc into `build/kernels/` at the repository
root on first use (`cuda_build`), the wide unit (WIDE_LIBRARY) on the
first launch that needs it; nothing is compiled or loaded at import
time.
"""
from __future__ import annotations

import ctypes
import math
import struct
from typing import Callable, NamedTuple

import torch

from tpuflows_torch.flows.affine import AffineCoupling, Standardize, Whiten
from tpuflows_torch.flows.core import Chain
from tpuflows_torch.flows.coupling import RQSCouplingBlock
from tpuflows_torch.kernels.cuda_build import CudaLibrary
from tpuflows_torch.kernels.tile_flow import (p_major, permute_for_tiles,
                                              tile_logp_and_grad_streamed)
from tpuflows_torch.mcmc.hmc import value_and_grad
from tpuflows_torch.mcmc.nuts import (draw_randomness, nuts_info,
                                      nuts_transition_math)
from tpuflows_torch.mcmc.preconditioned import flow_reparameterized
from tpuflows_torch.flows.nets import MLP
from tpuflows_torch.targets import (Banana, CorrelatedGaussian, DiagNormal,
                                    GaussianMixture, HierarchicalGaussian,
                                    MultimodalCauchy, NealsFunnel,
                                    Rosenbrock, StandardNormal)

# kernel launches since the last reset (the main path's proof of use):
# the tile kernel's, and the wide unit's
LAUNCHES = 0
WIDE_LAUNCHES = 0

# the widest flow (d), the deepest tree and the widest hidden layer that K1,
# K2 and K3 take (the wide units', csrc/wide_grad.cuh kWideMaxDim,
# kWideMaxDepth, kMaxHidden); the register units of the tile kernels take d
# up to TILE_MAX_DIM and max_depth up to TILE_MAX_DEPTH, and the wide units
# the rest (`wide_path`)
MAX_DIM = 1024
MAX_DEPTH = 16
MAX_HIDDEN = 4096
TILE_MAX_DIM = 256
TILE_MAX_DEPTH = 10
MAX_MODULES = 16
MOD_INTS = 8  # ints per module in the kernel's module list
# ints per module of its conditioner's form: layers, activation, flags, and
# the hidden widths h_1 .. h_7 (csrc/latent_grad.cuh kFormInts); the flags:
# bf16 operands, and a flow not of the main paths' form, whose every
# coupling runs the general path (double sums; kFormBf16, kFormGeneral)
FORM_INTS = 10
FORM_BF16 = 1
FORM_GENERAL = 2
MAX_LAYERS = 8  # layers of a conditioner (K6/K7 tiles: TILE_MAX_LAYERS)
KIND = {Standardize: 0, AffineCoupling: 1, RQSCouplingBlock: 2, Whiten: 3}
# csrc/latent_grad.cuh Activation (coupling_cuda.ACTIVATION_CODES)
ACTIVATION_CODES = {"silu": 0, "tanh": 1, "relu": 2, "gelu": 3}
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
# the targets with a device form, by exact type (csrc/targets.cuh
# TargetKind): a subclass, or a Posterior, whose log density is user code,
# has none
TARGET_KIND = {StandardNormal: 0, DiagNormal: 1, CorrelatedGaussian: 2,
               GaussianMixture: 3, NealsFunnel: 4, HierarchicalGaussian: 5,
               Banana: 6, Rosenbrock: 7, MultimodalCauchy: 8}
_LOG2PI = math.log(2.0 * math.pi)
# one translation unit per instantiation (d / 32 dims per lane) plus the
# C entry points, compiled in parallel; per DPL a unit of every target and
# one of the funnel's alone (its tile kernel, which the entry point
# launches for a funnel: csrc/targets.cuh)
_UNITS = [("entry", [])] + [
    (f"dpl{k}{f}", [f"-DNUTS_DPL={k}", *flag])
    for k in range(1, TILE_MAX_DIM // 32 + 1)
    for f, flag in (("", []), ("f", ["-DTARGETS_FUNNEL_ONLY"]))]
# the headers of the wide units (csrc/wide_grad.cuh), K1's, K2's and K3's
WIDE_DEPS = ["wide_grad.cuh", "latent_grad.cuh", "targets.cuh",
             "rqs_math.cuh"]
# d-wide vectors of a row of the wide units' work buffer before its
# checkpoints (csrc/wide_grad.cuh kWideVectors)
WIDE_VECTORS = 23


def _bind(lib):
    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ml = [p] * 2 + [i32] * 7 + [p] + [i32] * 2  # module_list_args
    fn = lib.nuts_chain_transition_f32
    fn.argtypes = [p] * 8 + ml + [i32, f32] + [p] * 2 + [i32, i32, p]
    fn.restype = i32
    fn = lib.nuts_chain_transition_warp_f32
    fn.argtypes = [p] * 8 + ml + [i32, f32] + [p] * 3
    fn.restype = i32


LIBRARY = CudaLibrary("nuts_transition", "nuts_transition.cu", _UNITS,
                      ["latent_grad.cuh", "targets.cuh", "tile_grad.cuh",
                       "nuts_tree.cuh", "nuts_tree_body.inc",
                       "rqs_math.cuh"], _bind)


def _bind_wide(lib):
    p, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_float)
    ml = [p] * 2 + [i32] * 7 + [p] + [i32] * 2  # module_list_args
    fn = lib.nuts_wide_transition_f32
    fn.argtypes = [p] * 8 + ml + [i32, f32] + [p] * 3 + [i64, p]
    fn.restype = i32


# K1's wide unit (csrc/nuts_transition_wide.cu), one translation unit,
# built on the first launch that needs it (`wide_path`)
WIDE_LIBRARY = CudaLibrary("nuts_transition_wide", "nuts_transition_wide.cu",
                           [("wide", [])],
                           [*WIDE_DEPS, "nuts_wide_tree.cuh", "nuts_tree.cuh"],
                           _bind_wide)


def _float_bits(x: float) -> int:
    return struct.unpack("<i", struct.pack("<f", float(x)))[0]


class PackedTarget(NamedTuple):
    """A closed-form target packed for csrc/targets.cuh: its kind, its
    parameters in one float32 buffer (every d-wide vector padded with
    neutral values to the lane width d_pad), its width and the lane
    width."""

    target: object
    kind: int
    params: torch.Tensor
    dim: int
    d_pad: int


class PackedFlow(NamedTuple):
    """A flow over a closed-form target, checked and packed for K1."""

    flow: Chain | None  # None: the flow-less transition
    target: object
    params: torch.Tensor  # packed leaves at d_pad, see csrc/latent_grad.cuh
    mods: torch.Tensor  # (n_modules, MOD_INTS) int32: the module list
    d: int  # the target's width, the row length of q and p0
    hidden: tuple  # every coupling's hidden widths
    hmax: int  # widest hidden layer
    head: int  # widest conditioner output, at least d_pad with a Whiten
    flow_p: Chain | None  # p-major relayout (flows with splines)
    resident_floats: int  # the resident layers' floats, 0 if not one coupling
    packed_target: PackedTarget
    d_pad: int  # the lane width, _pad32(d): the kernels' layout
    forms: torch.Tensor  # (n_modules, FORM_INTS) int32: the conditioners
    nhid: int  # the most hidden layers of any conditioner
    general: bool  # a Whiten, or a conditioner not 3-layer float32 silu


def _unsupported(msg):
    return ValueError(
        "the fused NUTS kernel takes a Chain of Standardize, Whiten, "
        "AffineCoupling and RQSCouplingBlock modules whose conditioners are "
        f"MLPs of 1 to {MAX_LAYERS} layers: {msg}")


def _not_in_kernel(what):
    """A module that neither the JAX package's in-kernel flow math
    (`tile_flow._block_inverse_2d`) nor the port's kernels compute."""
    return _unsupported(f"{what}, which the JAX package's in-kernel flow "
                        f"math does not take either")


def _pad32(n: int) -> int:
    return -(-n // 32) * 32


def _padded(v, n: int, fill: float):
    """float64 copy of v (k,) or (r, k) padded with `fill` to n columns."""
    v = torch.as_tensor(v).detach().to("cpu", torch.float64)
    out = torch.full((*v.shape[:-1], n), fill, dtype=torch.float64)
    out[..., :v.shape[-1]] = v
    return out


def _f64(x) -> float:
    return float(torch.as_tensor(x).detach().to("cpu", torch.float64))


def pack_target(target, d_pad: int | None = None,
                device=None) -> PackedTarget:
    """The target's kind and its parameters in one float32 buffer on
    `device`, as csrc/targets.cuh reads them at the lane width `d_pad`
    (default `_pad32(dim)`), with its log normaliser precomputed in
    float64. Raises ValueError, naming the target, for a target with no
    device form: any type but those of TARGET_KIND (a `Posterior`, whose
    likelihood is user code, and any user `Target` subclass)."""
    kind = TARGET_KIND.get(type(target))
    if kind is None:
        names = ", ".join(t.__name__ for t in TARGET_KIND)
        raise ValueError(
            f"the fused NUTS kernels have no device form of the target "
            f"{type(target).__name__}: they take {names} (a Posterior's "
            f"likelihood and a Target subclass's log density are user code)")
    dim = int(target.dim)
    dp = _pad32(dim) if d_pad is None else int(d_pad)
    if not 1 <= dim <= dp < dim + 32 or dp % 32 or dp > MAX_DIM:
        raise ValueError(f"a {type(target).__name__} of width {dim} at a "
                         f"lane width of {dp} (a multiple of 32 up to "
                         f"{MAX_DIM}, less than 32 past the width)")
    if kind == 6 and dim < 2 or kind == 5 and dim < 3 \
            or kind == 7 and dim % 2:
        raise ValueError(f"a {type(target).__name__} of width {dim}")
    half_log2pi = 0.5 * dim * _LOG2PI
    if kind == 0:
        parts = [[-half_log2pi]]
    elif kind == 1:
        scale = _padded(target.scale, dp, 1.0)
        c0 = -float(torch.log(scale).sum()) - half_log2pi
        parts = [[c0], _padded(target.loc, dp, 0.0), scale]
    elif kind == 2:
        chol = torch.as_tensor(target.chol).detach().to("cpu",
                                                        torch.float64)
        inv = torch.linalg.inv(chol)
        prec = torch.zeros((dp, dp), dtype=torch.float64)
        prec[:dim, :dim] = inv.T @ inv
        c0 = -float(torch.log(torch.diagonal(chol)).sum()) - half_log2pi
        parts = [[c0], _padded(target.loc, dp, 0.0), prec]
    elif kind == 3:
        scales = _padded(target.scales, dp, 1.0)
        lw = (torch.as_tensor(target.log_weights).detach().to(
            "cpu", torch.float64) - torch.log(scales).sum(-1) - half_log2pi)
        parts = [[float(lw.numel())], lw, _padded(target.means, dp, 0.0),
                 scales]
    elif kind == 4:  # the device reads sigma_v; the mirror log sigma_v too
        parts = [[target.sigma_v, math.log(target.sigma_v)]]
    elif kind == 5:
        J, pms, noise = dim - 2, _f64(target.prior_mu_scale), \
            _f64(target.noise)
        y = torch.zeros(dp, dtype=torch.float64)
        y[2:dim] = torch.as_tensor(target.y).detach().to("cpu",
                                                         torch.float64)
        c0 = -math.log(pms) - J * math.log(noise) - (J + 1) * _LOG2PI
        parts = [[c0, pms, noise], y]
    elif kind == 6:
        parts = [[-math.log(target.sigma1) - half_log2pi, target.b,
                  target.sigma1]]
    elif kind == 7:
        c0 = (-(dim // 2) * (math.log(target.s1) + math.log(target.s2))
              - half_log2pi)
        parts = [[c0, target.mu, target.s1, target.s2]]
    else:
        sigma = _f64(target.sigma)
        c0 = -dim * math.log(math.pi * sigma) - min(dim, 2) * math.log(2.0)
        parts = [[c0, _f64(target.mu), sigma]]
    params = torch.cat([torch.as_tensor(x, dtype=torch.float64).reshape(-1)
                        for x in parts]).to(torch.float32)
    return PackedTarget(target, kind, params.to(device or "cpu"), dim, dp)


def packed_log_density(pt: PackedTarget, x: torch.Tensor) -> torch.Tensor:
    """log p(x) read from the packed buffer: the plain PyTorch mirror of
    csrc/targets.cuh, differentiable by autograd. x (..., w) at the
    target's width or at the lane width (w = dim or d_pad); at d_pad the
    dims past dim must hold zeros, add nothing and get a gradient of 0.
    The buffer's float32 values are read in x's dtype (float64: the exact
    referee of the float32 evaluations)."""
    p = pt.params.to(device=x.device, dtype=x.dtype)
    w, dim, dp = x.shape[-1], pt.dim, pt.d_pad
    if w not in (dim, dp):
        raise ValueError(f"x has width {w}, the target {dim} (lanes {dp})")
    on = torch.arange(w, device=x.device) < dim
    c0 = p[0]

    def vec(k):  # the k-th d_pad-wide vector after c0, cut to w
        return p[1 + k * dp:1 + (k + 1) * dp][:w]

    def zeros():
        return torch.zeros((), dtype=x.dtype, device=x.device)

    if pt.kind == 0:
        return -0.5 * torch.sum(x * x, -1) + c0
    if pt.kind == 1:
        z = (x - vec(0)) / vec(1)
        return -0.5 * torch.sum(z * z, -1) + c0
    if pt.kind == 2:
        r = x - vec(0)
        prec = p[1 + dp:].reshape(dp, dp)[:w, :w]
        return -0.5 * torch.sum(r * (r @ prec), -1) + c0
    if pt.kind == 3:
        K = (p.numel() - 1) // (1 + 2 * dp)  # [K, lw, means, scales]
        lw = p[1:1 + K]
        mean = p[1 + K:1 + K + K * dp].reshape(K, dp)[:, :w]
        scale = p[1 + K + K * dp:].reshape(K, dp)[:, :w]
        z = (x[..., None, :] - mean) / scale
        return torch.logsumexp(-0.5 * torch.sum(z * z, -1) + lw, -1)
    if pt.kind == 4:  # NealsFunnel.log_density's operations, in its order
        k = dim - 1
        v, rest = x[..., 0], x[..., 1:]
        lp_v = -0.5 * (v / p[0]) ** 2 - p[1] - 0.5 * _LOG2PI
        lp_rest = (-0.5 * torch.sum(rest * rest, dim=-1) * torch.exp(-v)
                   - 0.5 * k * v - 0.5 * k * _LOG2PI)
        return lp_v + lp_rest
    if pt.kind == 5:
        pms, noise, y = p[1], p[2], p[3:3 + dp][:w]
        mu, lt, m = x[..., 0], x[..., 1], on[2:]
        dt = torch.where(m, x[..., 2:] - mu[..., None], zeros())
        dy = torch.where(m, y[2:] - x[..., 2:], zeros())
        return (c0 - 0.5 * (mu / pms) ** 2 - 0.5 * lt * lt
                - 0.5 * torch.sum(dt * dt, -1) * torch.exp(-2.0 * lt)
                - (dim - 2) * lt
                - 0.5 * torch.sum(dy * dy, -1) / (noise * noise))
    if pt.kind == 6:
        b, s1 = p[1], p[2]
        x0, x1 = x[..., 0], x[..., 1]
        z1 = x1 - b * (x0 * x0 - s1 * s1)
        quad = ((x0 / s1) ** 2 + z1 * z1
                + torch.sum(x[..., 2:] * x[..., 2:], -1))
        return -0.5 * quad + c0
    if pt.kind == 7:
        mu, s1, s2 = p[1], p[2], p[3]
        xe, xo = x[..., 0::2], x[..., 1::2]
        u, t = (xe - mu) / s1, (xo - xe * xe) / s2
        quad = torch.where(on[0::2], u * u + t * t, zeros())
        return -0.5 * torch.sum(quad, -1) + c0
    mu, s = p[1], p[2]

    def term(v, loc):
        z = (v - loc) / s
        return -torch.log1p(z * z)

    two = x[..., :2]
    bimodal = torch.where(on[:2], torch.logaddexp(term(two, -mu),
                                                  term(two, mu)), zeros())
    rest = torch.where(on[2:], term(x[..., 2:], 0.0), zeros())
    return torch.sum(bimodal, -1) + torch.sum(rest, -1) + c0


def _operand(w, net):
    """A weight as the kernels read it: rounded to bf16 (held as float32)
    for a bf16 conditioner, as `MLP` rounds its operands."""
    w = w.detach().float()
    return w.bfloat16().float() if net.compute_dtype == "bf16" else w


def _coupling_leaves(t, d):
    """(leaves, widths) of a coupling at flow width d: its mask, each
    layer's weight and bias, then each weight transposed (for the
    backward), the spline's last layer relaid out p-major and a bf16
    conditioner's weights rounded (`_operand`); widths [d, h_1, ...,
    n_out]. Raises ValueError where the kernels do not take the
    conditioner (`MLP` admits only the activations and compute dtypes the
    kernels take)."""
    net = t.net
    ws, bs = list(net.weights), list(net.biases)
    if not 1 <= len(ws) <= MAX_LAYERS:
        raise _unsupported(f"a conditioner of {len(ws)} layers, past the "
                           f"limit of {MAX_LAYERS}")
    if len(t.mask) != d:
        raise _unsupported(f"a mask of width {len(t.mask)} in a flow of "
                           f"width {d}")
    spline = isinstance(t, RQSCouplingBlock)
    n_out = (3 * t.knots - 1) * d if spline else 2 * d
    widths = [d] + [int(w.shape[1]) for w in ws[:-1]] + [n_out]
    if any(tuple(w.shape) != (a, b) or b_.numel() != b
           for w, b_, a, b in zip(ws, bs, widths[:-1], widths[1:])):
        raise _unsupported(f"MLP widths {[tuple(w.shape) for w in ws]} do "
                           f"not match the flow width d={d}")
    ws = [_operand(w, net) for w in ws]
    bs = [b.detach().float() for b in bs]
    if spline:
        P = 3 * t.knots - 1
        ws[-1], bs[-1] = p_major(ws[-1], d, P), p_major(bs[-1], d, P)
    leaves = [t.mask_f] + [x for w, b in zip(ws, bs) for x in (w, b)]
    return leaves + [w.t() for w in ws], widths


def _form_row(t, widths, general):
    """A coupling's row of the conditioners' forms: layers, activation
    code, flags (FORM_BF16, and FORM_GENERAL in a flow that is not of the
    main paths' form), hidden widths (zeros past them)."""
    hidden = widths[1:-1]
    flags = ((FORM_BF16 if t.net.compute_dtype == "bf16" else 0)
             | (FORM_GENERAL if general else 0))
    row = [len(widths) - 1, ACTIVATION_CODES[t.net.activation], flags,
           *hidden]
    return row + [0] * (FORM_INTS - len(row))


def _main_form(t) -> bool:
    """Whether a module has the main paths' form: a coupling with a 3-layer
    float32 silu conditioner of hidden widths up to TILE_MAX_DIM, or a
    Standardize. A flow of such modules alone runs the 3-layer code with
    float32 sums (the funnel's own units of K1 and K3 compute only those:
    csrc/tile_grad.cuh `main_form`); any other flow runs the general path,
    summed in double, in every coupling (at hidden widths of 512 float32
    sums in the main paths' order missed the bar of float64 on 1.7x as many
    gradient values as cuBLAS's float32 products: PERF.md §6)."""
    if isinstance(t, Standardize):
        return True
    if isinstance(t, Whiten):
        return False
    return (len(t.net.weights) == 3 and t.net.activation == "silu"
            and t.net.compute_dtype == "f32"
            and all(w.shape[1] <= TILE_MAX_DIM for w in t.net.weights[:-1]))


@torch.no_grad()
def _pad_module(t, d: int, dp: int):
    """Module t of a flow of width d at the lane width dp, each hidden
    width of its conditioner rounded up to a multiple of 32: a padded dim
    has Standardize loc 0 and log scale 0, Whiten loc 0 and the identity's
    row and column in chol and its inverse (log 1 = 0 to the ladj), mask 1
    (it passes through every coupling), a zero row of the first layer's
    weight and zero head columns at any depth, so that it holds exact
    zeros throughout; a padded hidden unit has zero weights in and out and
    a zero bias, so that it holds act(0) = 0 (silu, tanh, relu and gelu
    alike) and adds exact zeros to every sum."""
    if isinstance(t, Standardize):
        return Standardize(_padded(t.loc, dp, 0.0).float(),
                           _padded(t.log_scale, dp, 0.0).float()).to(
                               t.loc.device)
    if isinstance(t, Whiten):
        def square(m):
            out = torch.eye(dp, dtype=torch.float64)
            out[:d, :d] = m.detach().to("cpu", torch.float64)
            return out.float()

        return Whiten(_padded(t.loc, dp, 0.0).float(), square(t.inv_chol),
                      square(t.chol)).to(t.loc.device)
    ws = [w.detach() for w in t.net.weights]
    bs = [b.detach() for b in t.net.biases]
    P = 3 * t.knots - 1 if isinstance(t, RQSCouplingBlock) else None

    def head(v):  # (..., n_out) at d -> at dp, zeros in the new columns
        if P is None:  # affine: [shift (d), raw scale (d)]
            lead = v.shape[:-1]
            out = v.new_zeros((*lead, 2, dp))
            out[..., :d] = v.reshape(*lead, 2, d)
            return out.reshape(*lead, 2 * dp)
        lead = v.shape[:-1]  # spline: d-major, column i P + p
        out = v.new_zeros((*lead, dp, P))
        out[..., :d, :] = v.reshape(*lead, d, P)
        return out.reshape(*lead, dp * P)

    # each layer's input at its padded width (dp, then each hidden width
    # rounded up to 32: zero units, zero bias, zero weights either side, so
    # that an added unit's activation is act(0) = 0 and its cotangent 0)
    ins = [dp] + [_pad32(w.shape[1]) for w in ws[:-1]]
    for k, (w, b) in enumerate(zip(ws, bs)):
        hidden = k < len(ws) - 1
        out = w.new_zeros((ins[k], ins[k + 1] if hidden else w.shape[1]))
        out[:w.shape[0], :w.shape[1]] = w
        ws[k] = out
        if hidden:
            bs[k] = b.new_zeros(ins[k + 1])
            bs[k][:b.numel()] = b
    ws[-1], bs[-1] = head(ws[-1]), head(bs[-1])
    net = MLP(ws, bs, activation=t.net.activation,
              compute_dtype=t.net.compute_dtype)
    mask = tuple(t.mask) + (1,) * (dp - d)
    if P is None:
        return AffineCoupling(mask, net, clamp=t.clamp)
    return RQSCouplingBlock(mask, net, knots=t.knots,
                            range_limit=t.range_limit,
                            use_pallas=t.use_pallas)


def _needs_pad(t, d: int, dp: int) -> bool:
    """Whether module t of a flow of width d changes at the lane width dp:
    a padded dim, or a hidden width that is not a multiple of 32."""
    return dp != d or any(int(w.shape[1]) % 32 for w in getattr(
        getattr(t, "net", None), "weights", ())[:-1])


def _compact_leaves(t, d, w_first, w_last, b_last, dim):
    """The tile kernels' copies of a coupling's first and last layers,
    without the work that cannot reach lp or g (the conditioner sees
    z * mask; only the transformed dims' head parameters are used): the
    first layer's rows (and its transpose's columns) of the pass-through
    dims below the target's width `dim` in dim order (a padded dim past it
    has none), and the last layer's columns, bias entries and transposed
    rows of the transformed dims' head parameters, p-major over those dims
    (column p n_t + t for the t-th transformed dim; w_last, b_last come
    p-major over all d dims), both as packed (a bf16 conditioner's
    rounded). Each compact width is padded with zeros to a multiple of 32.
    Of a conditioner of L >= 2 layers: [W_1, W_1^T, W_L, b_L, W_L^T]; of
    one layer, the layer compact both ways: [W, b, W^T]. Returns (leaves,
    number of pass-through dims)."""
    dev = w_last.device
    mask = torch.as_tensor(t.mask, device=dev).bool()
    keep = torch.nonzero(mask[:dim]).flatten()
    moved = torch.nonzero(~mask).flatten()
    n_p, n_t = keep.numel(), moved.numel()
    n_param = w_last.shape[1] // d
    cols = (torch.arange(n_param, device=dev)[:, None] * d
            + moved[None, :]).reshape(-1)

    def rows(w):
        out = torch.zeros((_pad32(n_p), w.shape[1]), device=dev)
        out[:n_p] = w[keep]
        return out

    def columns(w, b):
        wc = torch.zeros((w.shape[0], _pad32(n_param * n_t)), device=dev)
        wc[:, :cols.numel()] = w[:, cols]
        bc = torch.zeros(wc.shape[1], device=dev)
        bc[:cols.numel()] = b[cols]
        return wc, bc

    if w_first is w_last:  # one layer
        wc, bc = columns(rows(w_last), b_last)
        return [wc, bc, wc.t()], n_p
    w1c = rows(w_first)
    wlc, blc = columns(w_last, b_last)
    return [w1c, w1c.t(), wlc, blc, wlc.t()], n_p


def _resident_floats(*widths: int) -> int:
    """Floats of the resident copy of a coupling's compact forward layers
    of widths [n_in, h_1, ..., n_head] (csrc/tile_grad.cuh
    `tile_resident_floats` for 3 layers, `tile_resident_before` for any):
    each layer (widths[k] x widths[k + 1]) with its rows padded by one
    float, so that a warp reading a layer transposed hits 32 banks."""
    return sum(a * (b + 1) for a, b in zip(widths[:-1], widths[1:]))


def _flow_width(ts, target) -> int:
    if not ts:
        return int(target.dim)
    first = ts[0]
    return (first.loc.numel() if isinstance(first, (Standardize, Whiten))
            else len(getattr(first, "mask", ())))


def pack_flow(flow: Chain | None, target, device=None) -> PackedFlow:
    """Check that K1, K2 and K3 compute `flow` over `target` and pack
    both. `flow`: a Chain of Standardize, Whiten, AffineCoupling and
    RQSCouplingBlock modules whose conditioners are MLPs of 1 to
    MAX_LAYERS layers of any hidden widths up to MAX_HIDDEN, with a silu,
    tanh, relu or gelu activation and float32 or bf16 operands, as the JAX
    package's in-kernel flow math takes them (Identity and ScannedRepeat,
    which that math refuses too, and any other module raise ValueError
    naming it; so do more layers and wider ones), or None for the
    flow-less transition (an empty module list); `target`: any target that
    `pack_target` packs, of the flow's width d <= MAX_DIM (else
    ValueError, naming it). This is where the kernels refuse a flow: a
    flow that packs launches (`wide_path` sends what the tile kernels do
    not take to the wide units). The flow is padded once to the lane width
    d_pad = `_pad32(d)`, each hidden width to a multiple of 32
    (`_pad_module`), and its leaves packed at d_pad in chain order:
    Standardize loc, log_scale; Whiten loc, chol^T, chol, its constant
    ladj sum(log diag chol) (as `Whiten.inverse_and_ladj` computes it, at
    the true width) in the bits of its row's column 5; a
    coupling's mask, W_1, b_1, ..., W_L, b_L, W_1^T, ..., W_L^T
    (`_coupling_leaves`), a spline's last layer in p-major columns, a
    bf16 conditioner's weights rounded; each coupling's leaves are
    followed by the tile kernels' compact copies of its first and last
    layers (`_compact_leaves`), at the offset its row of the module list
    holds in column 6, with the number of pass-through dims below d in
    column 7; the per-warp kernels read neither. Each module's row of
    `forms` holds its conditioner's layers, activation, flags (FORM_BF16;
    FORM_GENERAL on every coupling of a flow that is not of the main
    paths' form, `_main_form`) and hidden widths. The packed tensors live
    on the flow's device, or on `device` for the flow-less transition."""
    if flow is None:
        ts = []
    elif not isinstance(flow, Chain):
        raise _not_in_kernel(f"a {type(flow).__name__} that is not in a "
                             f"Chain")
    else:
        ts = list(flow.transforms)
        if not 1 <= len(ts) <= MAX_MODULES:
            raise _unsupported(f"{len(ts)} modules (1 to {MAX_MODULES})")
        for t in ts:
            if type(t) not in KIND:
                raise _not_in_kernel(f"module {type(t).__name__}")
    d = _flow_width(ts, target)
    if d > MAX_DIM:
        raise _unsupported(f"a flow of width {d} (at most {MAX_DIM})")
    dp = _pad32(d)
    if ts:
        device = next(iter(flow.parameters())).device
    pt = pack_target(target, dp, device=device)
    if pt.dim != d:
        raise _unsupported(f"a {type(target).__name__} of width {pt.dim} "
                           f"under a flow of width {d}")
    for t in ts:
        if isinstance(t, (Standardize, Whiten)):
            width = t.loc.numel()
            if width != d:
                raise _unsupported(f"a {type(t).__name__} of width {width} "
                                   f"in a flow of width {d}")
        else:
            _, w = _coupling_leaves(t, d)  # checks the conditioner at d
            if any(_pad32(h) > MAX_HIDDEN for h in w[1:-1]):
                raise _unsupported(f"hidden widths {w[1:-1]} (each at most "
                                   f"{MAX_HIDDEN})")
    padded = [_pad_module(t, d, dp) if _needs_pad(t, d, dp) else t
              for t in ts]
    general = not all(_main_form(t) for t in ts)
    parts, rows, forms, widths, resident, off = [], [], [], [], [], 0
    head = 0
    for t, t_true in zip(padded, ts):
        kind = KIND[type(t)]
        form = [0] * FORM_INTS
        if kind == 0:
            leaves, row = [t.loc, t.log_scale], [0, off, 0, 0, 0, 0]
        elif kind == 3:
            with torch.no_grad():
                ladj = torch.sum(torch.log(torch.diagonal(t_true.chol)))
            leaves = [t.loc, t.chol.t(), t.chol]
            row = [3, off, 0, 0, 0, _float_bits(float(ladj))]
            head = max(head, dp)
        else:
            leaves, w = _coupling_leaves(t, dp)
            spline = kind == 2
            L = len(w) - 1
            row = [kind, off, w[1] if L > 1 else 0, w[-2] if L > 1 else 0,
                   t.knots if spline else 0,
                   _float_bits(t.range_limit if spline else t.clamp)]
            compact, n_pass = _compact_leaves(
                t, dp, leaves[1], leaves[2 * L - 1], leaves[2 * L], d)
            row += [off + sum(x.numel() for x in leaves), n_pass]
            leaves = leaves + compact
            widths.append(w)
            form = _form_row(t, w, general)
            head = max(head, w[-1])
            resident.append(_resident_floats(
                _pad32(n_pass), *w[1:-1],
                _pad32(w[-1] // dp * (d - n_pass))))
        parts += leaves
        rows.append(row + [0] * (MOD_INTS - len(row)))
        forms.append(form)
        off += sum(x.numel() for x in leaves)
    if off >= 2 ** 31:
        raise _unsupported(f"{off} parameters (the kernel indexes them "
                           f"with 32-bit ints)")
    with torch.no_grad():
        params = (torch.cat([p.detach().float().reshape(-1) for p in parts])
                  if parts else torch.zeros(0, device=pt.params.device))
    mods = torch.tensor(rows, dtype=torch.int32,
                        device=params.device).reshape(-1, MOD_INTS)
    form_t = torch.tensor(forms, dtype=torch.int32,
                          device=params.device).reshape(-1, FORM_INTS)
    has_spline = any(isinstance(t, RQSCouplingBlock) for t in ts)
    hidden = tuple(h for w in widths for h in w[1:-1])
    # the resident mode: one module besides Standardize, and a coupling
    others = [t for t in ts if not isinstance(t, Standardize)]
    one = len(others) == 1 and len(resident) == 1
    return PackedFlow(
        flow, target, params.contiguous(), mods, d, hidden,
        max(hidden, default=0), head,
        permute_for_tiles(flow) if has_spline else None,
        resident[0] if one else 0, pt, dp, form_t,
        max((len(w) - 2 for w in widths), default=0), general)


def autograd_logp_grad(flow: Chain | None,
                       log_density: Callable) -> Callable:
    """z (T, d) -> (lp (T, 1), d lp / dz (T, d)) for
    lp = log_density(f^-1(z)) + ladj (log_density(z) without a flow), by
    torch.autograd."""
    value_grad = value_and_grad(log_density if flow is None else
                                flow_reparameterized(log_density, flow))

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


def check_depth(max_depth: int):
    """Raises unless K1 and K2 take trees of `max_depth` doublings: 1 to
    MAX_DEPTH (the tile kernels up to TILE_MAX_DEPTH, the wide units the
    rest). The transitions call it when they are built."""
    if not 1 <= max_depth <= MAX_DEPTH:
        raise ValueError(f"the fused NUTS kernels take max_depth in [1, "
                         f"{MAX_DEPTH}], got {max_depth}")


def check_inputs(q, p0, dirs, u_acc, u_take, eps, inv_mass, model,
                  max_depth, window=1, out=None):
    """Shapes, dtypes and devices of K1's inputs, and of K2's for a
    window of `window` slots: then p0, dirs, u_acc and u_take are `window`
    times as wide (slot-major in each row) and the draws go to `out`
    (window, n, d) when it is given."""
    check_depth(max_depth)
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
    if any(t.device != q.device for t in (model.params, model.mods,
                                          model.forms,
                                          model.packed_target.params)):
        raise ValueError("the packed flow is on another device than q")


def smem_bytes(model: PackedFlow) -> int:
    """Dynamic shared memory of one row of the module-list kernels (one
    warp of the per-warp kernels, one row of a tile of the tile kernels:
    K1's, K2's and K3's; csrc/latent_grad.cuh `row_floats`): each module's
    input and the conditioner's, two buffers of the widest hidden layer
    for each hidden layer of the deepest conditioner, and the head."""
    return 4 * ((model.mods.shape[0] + 1) * model.d_pad
                + 2 * model.nhid * model.hmax + model.head)


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
    """Raises unless K1's, K2's and K3's device code takes the packed
    flow's widths, as `pack_flow` leaves them: any d up to MAX_DIM packed
    at the lane width `_pad32(d)`, every hidden width a multiple of 32 up
    to MAX_HIDDEN (`pack_flow` pads each to one). The launches assert it;
    a flow that packs passes. A row too wide for the tile kernels' shared
    memory runs the wide units (`wide_path`)."""
    if not 1 <= model.d <= MAX_DIM or model.d_pad != _pad32(model.d):
        raise ValueError(f"the kernel takes d <= {MAX_DIM} packed at "
                         f"{_pad32(model.d)} lanes, got d={model.d} at "
                         f"{model.d_pad}")
    for w in model.hidden:
        if w > MAX_HIDDEN or w % 32:
            raise ValueError(f"the kernel takes hidden widths % 32 == 0 and "
                             f"<= {MAX_HIDDEN}, got {w}")


def wide_path(model: PackedFlow, max_depth: int = 1) -> bool:
    """Whether a launch of K1, K2 (trees of `max_depth`) or K3 (depth 1)
    runs the kernel's wide unit (csrc/nuts_transition_wide.cu,
    nuts_window_wide.cu, fused_logp_wide.cu) rather than its tile kernel:
    a lane width past TILE_MAX_DIM, a depth past TILE_MAX_DEPTH, or a row
    whose scratch leaves no room for a weight ring in shared memory at a
    tile of one row (`ring_stage_floats`)."""
    return (model.d_pad > TILE_MAX_DIM or max_depth > TILE_MAX_DEPTH
            or ring_stage_floats(model, 1) == 0)


def wide_row_floats(model: PackedFlow, max_depth: int) -> int:
    """Floats of one row's slice of a wide unit's work buffer
    (csrc/wide_grad.cuh `wide_row_floats`): WIDE_VECTORS d_pad-wide
    vectors, 2 max_depth checkpoints (K3: depth 0) and one row's gradient
    scratch (`smem_bytes`)."""
    return ((WIDE_VECTORS + 2 * max_depth) * model.d_pad
            + smem_bytes(model) // 4)


def wide_work(q, model: PackedFlow, max_depth: int) -> torch.Tensor:
    """A wide unit's work buffer for q's n rows, on q's device."""
    return torch.empty(q.shape[0] * wide_row_floats(model, max_depth),
                       device=q.device, dtype=torch.float32)


def module_list_args(model: PackedFlow, n: int) -> list:
    """The module-list entry points' arguments from `mods` to `general`
    for n rows (K1's, K2's and K3's): the module list, the packed target,
    the lane width, the target's width and kind, the widest layers, then
    the conditioners' forms, the most hidden layers of one and whether a
    module leaves the main paths' form."""
    pt = model.packed_target
    return [model.mods.data_ptr(), pt.params.data_ptr(), model.mods.shape[0],
            n, model.d_pad, model.d, pt.kind, model.hmax, model.head,
            model.forms.data_ptr(), model.nhid, int(model.general)]


def _call(name, q, args, library=None):
    """Entry point `name` of the library (LIBRARY, or `library`) with
    `args` and q's stream, on q's card; raises if the launch failed."""
    lib = (library or LIBRARY).load()
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
            rows=None, resident=None, wide=None):
    """K1 on the card: the tile kernel on tiles of `rows` chains, its
    weights resident where they fit (the wrapper's `tile_rows(model)` and
    `launch_resident`; `chip_smoke.py` times other R and the ring), or,
    where `wide_path` says so and no `rows` is asked for, the wide unit
    (`wide` True asks for it on any flow: `chip_smoke.py` holds it to the
    per-warp kernel)."""
    global LAUNCHES
    n, d = q.shape
    ins = (q, p0, dirs, u_acc, u_take, eps, inv_mass, model.params)
    q_out, info, ptrs = _outputs(q, model, ins)
    if wide or (wide is None and rows is None and resident is None
                and wide_path(model, max_depth)):
        return _launch_wide(q, model, max_depth, q_out, info, ptrs)
    rows = launch_rows(model, rows)
    _call("nuts_chain_transition_f32", q, [
        *ptrs, *module_list_args(model, n), max_depth, MAX_DELTA_ENERGY,
        q_out.data_ptr(), info.data_ptr(), rows,
        launch_resident(model, rows, resident)])
    LAUNCHES += 1
    return (q_out, *info.unbind(0))


def _launch_wide(q, model, max_depth, q_out, info, ptrs):
    """K1's wide unit on the card (`wide_path`): one warp per chain, its
    vectors in a per-launch work buffer (`wide_work`). Built on its first
    launch (WIDE_LIBRARY). Same returns as `_launch`."""
    global WIDE_LAUNCHES
    work = wide_work(q, model, max_depth)
    _call("nuts_wide_transition_f32", q, [
        *ptrs, *module_list_args(model, q.shape[0]), max_depth,
        MAX_DELTA_ENERGY, q_out.data_ptr(), info.data_ptr(), work.data_ptr(),
        work.numel()], library=WIDE_LIBRARY)
    WIDE_LAUNCHES += 1
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
        *ptrs, *module_list_args(model, n), max_depth, MAX_DELTA_ENERGY,
        q_out.data_ptr(), info.data_ptr()])
    return (q_out, *info.unbind(0))


def plain_logp_grad(model: PackedFlow) -> Callable:
    """The plain version's gradient, the target read from the packed
    buffer (`packed_log_density`): the streamed per-block backward on the
    p-major relayout for flows with splines (as the JAX package's
    `fused_nuts_for_flow`), else autograd through the whole flow, or
    through the target alone for the flow-less transition."""
    pt = model.packed_target

    def log_density(x):
        return packed_log_density(pt, x)

    if model.flow_p is not None:
        return lambda z: tile_logp_and_grad_streamed(model.flow_p, z,
                                                     log_density)
    return autograd_logp_grad(model.flow, log_density)


def pad_lanes(x: torch.Tensor, d_pad: int) -> torch.Tensor:
    """x (..., d) with zeros appended to d_pad: a row as the kernels hold
    it in their lanes."""
    return torch.nn.functional.pad(x, (0, d_pad - x.shape[-1]))


def nuts_transition(q, p0, dirs, u_acc, u_take, eps, inv_mass,
                    model: PackedFlow, max_depth: int):
    """One NUTS transition of every chain, with the randomness given.

    A CPU tensor runs `transition_math_torch` with `plain_logp_grad`; a
    CUDA tensor launches K1's tile kernel on tiles of `tile_rows(model)`
    chains, the weights resident where they fit (`launch_resident`), or
    K1's wide unit where `wide_path(model, max_depth)` says so. Same
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
    (q_new, NUTSInfo)` on the latent density log p(f^-1(z)) + ladj, or on
    the target's own density when `flow` is None (K1 over an empty module
    list, its packed target on `device`).

    The flow's parameters are packed for K1 when this is constructed, so
    build it after the flow is trained; a flow, a target or a depth that
    K1 does not take is refused then (`pack_flow`, `check_depth`), not at
    a launch."""

    def __init__(self, target, flow: Chain | None = None,
                 max_depth: int = 8, device=None):
        check_depth(max_depth)
        self.model = pack_flow(flow, target, device=device)
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


def fused_nuts_for_flow(target, flow: Chain | None,
                        max_depth: int = 8) -> FusedNUTS:
    """The fused transition for flow-preconditioned NUTS on `target`, any
    closed-form target of the port (`pack_target`) at any d <= MAX_DIM,
    under any flow `pack_flow` takes (hidden widths up to MAX_HIDDEN), at
    any max_depth up to MAX_DEPTH (the north-star path); drop into
    `NUTSDriver(transition=...)`. Raises ValueError, naming the limit,
    for anything else."""
    return FusedNUTS(target, flow, max_depth=max_depth)
