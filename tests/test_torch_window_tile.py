"""K2's module-list window on the tile gradient (`nuts_window_tile_kernel`
in `csrc/nuts_window.cu`), on the CPU: what the host decides and what the
design rests on. The kernel runs only on the card, where `chip_smoke.py`
(phase `tile_vs_warp`) holds it to the per-warp window bit for bit.

  * `nuts_window_cuda.window_lockstep_gradients`, the gradient count of
    K2's tile schedule (one call per tile at the window's start, then in
    every slot the most leaves of any chain of the tile in each doubling),
    is the number of calls the plain version makes tile by tile:
    `chain_slots` over `transition_math_torch` with a counting gradient,
    each slot after the first started from the carried point (so less one
    start call per later slot), a ragged last tile included; at one row
    it is sum(n_steps) + n;
  * the wrapper's host-side choices: a module list launches the tile
    entry point at `tile_rows(model)` (8 at the generic arqs flow, 1 at
    d = 256, K = 64 on a smaller ring), other R only when asked, and
    nothing that `check_tile` refuses; the affine flow keeps its own
    kernel; the per-warp window refuses CPU tensors and affine flows;
  * `chip_smoke.py`'s accounting: `_kernel_key` names the new kernel, and
    `lockstep_efficiency` counts a window's lockstep;
  * a window's chains are independent on a module-list (arqs, mixed-mask)
    flow, on both sides: the JAX package's `_window_math` (the plain
    reference of its Pallas window) with the streamed per-block gradient,
    and the port's wrapper on the CPU. K2's tile lockstep rests on it: a
    chain's window must not depend on its tile-mates. Discrete outputs
    exactly, the others to 1e-5 (float32 rounding of batched against
    single-row products), at the window tests' spline setting (eps 0.1,
    4 slots, depth 4, last layers 0.03 x He), where rounding does not
    part trajectories.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows.kernels.nuts_pallas import _window_math
from tpuflows.kernels.tile_flow import permute_for_tiles as j_permute
from tpuflows.kernels.tile_flow import (
    tile_logp_and_grad_streamed as j_streamed)
from tpuflows.targets import NealsFunnel as JFunnel

from tpuflows_torch.flows import build_flow
from tpuflows_torch.kernels import nuts_cuda
from tpuflows_torch.kernels import nuts_window_cuda as nw
from tpuflows_torch.targets import NealsFunnel

from test_torch_coupling import carry, jax_arqs_flow
from test_torch_nuts_window import KEYS, window_inputs

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

D = 8


def _arqs(d, hidden, knots, n_blocks, seed=0):
    g = torch.Generator().manual_seed(seed)
    init = torch.randn((256, d), generator=g)
    return build_flow(init, g, kind="arqs", n_blocks=n_blocks, knots=knots,
                      hidden=hidden, mask_scheme="mixed", clamp=8.0,
                      use_pallas="auto", device="cpu")


def _affine(d, hidden, seed=0):
    g = torch.Generator().manual_seed(seed)
    init = torch.randn((256, d), generator=g)
    return build_flow(init, g, kind="affine", n_blocks=1, hidden=hidden,
                      mask_scheme="leading", clamp=8.0, device="cpu")


def _model(flow):
    d = flow.transforms[0].loc.numel()
    return nuts_cuda.pack_flow(flow, NealsFunnel(dim=d))


# ---------------------------------------------------------------------------
# window_lockstep_gradients against the plain version's gradient calls
# ---------------------------------------------------------------------------
def _counted(fn):
    calls = [0]

    def wrapped(z):
        calls[0] += 1
        return fn(z)

    return wrapped, calls


def _window_inputs(kind, n=21, window=3, depth=4, seed=3):
    flow = (_affine(D, (16, 16), seed) if kind == "affine"
            else _arqs(D, (16, 16), 4, 2, seed))
    model = _model(flow)
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((n, D), generator=g)
    im = 0.5 + torch.rand(D, generator=g)
    rnd = nw.draw_window_randomness(g, n, D, window, depth, im)
    return model, q, rnd, torch.tensor(0.35), im, window, depth


def _plain_slots(model, q, rnd, eps, im, window, depth):
    """The window as S chained plain transitions, each slot after the
    first from the previous slot's draw, and the gradient calls a window
    makes for it: every call, less each later slot's start call (the
    window carries lp and g there)."""
    grad, calls = _counted(nuts_cuda.plain_logp_grad(model))
    out = nw.chain_slots(
        lambda z, *r: nuts_cuda.transition_math_torch(z, *r, eps, im, grad,
                                                      depth),
        q, *rnd, window, depth)
    return out, calls[0] - (window - 1)


@pytest.mark.parametrize("kind", ["affine", "spline"])
@pytest.mark.parametrize("rows", [1, 2, 4, 8])
def test_window_lockstep_count_is_the_plain_calls_tile_by_tile(kind, rows):
    """Tiles of `rows` chains in batch order, the last one ragged (21
    chains): the plain window of each tile alone makes as many gradient
    calls as K2's tile lockstep does there."""
    model, q, rnd, eps, im, S, depth = _window_inputs(kind)
    steps = _plain_slots(model, q, rnd, eps, im, S, depth)[0][3]
    assert steps.shape == (S, q.shape[0])
    assert len(torch.unique(steps)) >= 3  # trees of different sizes
    total = 0
    for lo in range(0, q.shape[0], rows):
        sl = slice(lo, lo + rows)
        out, calls = _plain_slots(model, q[sl], [r[sl] for r in rnd], eps,
                                  im, S, depth)
        torch.testing.assert_close(out[3], steps[:, sl], rtol=0, atol=0)
        total += calls
    assert nw.window_lockstep_gradients(steps, rows) == total


@pytest.mark.parametrize("kind", ["affine", "spline"])
def test_window_lockstep_count_at_one_row_is_every_leapfrog(kind):
    model, q, rnd, eps, im, S, depth = _window_inputs(kind, seed=5)
    out, whole = _plain_slots(model, q, rnd, eps, im, S, depth)
    steps, n = out[3], q.shape[0]
    assert nw.window_lockstep_gradients(steps, 1) == int(steps.sum()) + n
    # a tile of the whole batch shares its leaf steps
    assert nw.window_lockstep_gradients(steps, n) == whole
    assert whole < int(steps.sum()) + n


def test_window_lockstep_count_of_one_slot_is_k1s():
    steps = torch.tensor([[1.0, 7.0, 3.0, 2.0, 15.0]])
    for rows in (1, 2, 4, 8):
        assert nw.window_lockstep_gradients(steps, rows) == \
            nuts_cuda.lockstep_gradients(steps[0], rows)


# ---------------------------------------------------------------------------
# the wrapper's host-side choices
# ---------------------------------------------------------------------------
def _generic():
    """The generic arqs flow's widths (bench.py `make_flow0`)."""
    return _arqs(64, (128, 128), 8, 3)


def _launched(monkeypatch, flow, rows=None):
    """(entry point, extra arguments, launch count) of one `_launch` of K2
    on the flow, the library call replaced by a recorder."""
    seen = []

    def record(name, *args, extra=()):
        seen.append((name, extra))
        return "result"

    monkeypatch.setattr(nw, "_call", record)
    monkeypatch.setattr(nw, "LAUNCHES", 0)
    model = _model(flow)
    d, S, depth = model.d, 2, 3
    q = torch.zeros((5, d))
    g = torch.Generator().manual_seed(0)
    rnd = nw.draw_window_randomness(g, 5, d, S, depth, torch.ones(d))
    res = nw._launch(q, *rnd, torch.tensor(0.1), torch.ones(d), model,
                     depth, S, None, rows=rows)
    assert res == "result" and len(seen) == 1
    return (*seen[0], nw.LAUNCHES)


@pytest.mark.parametrize("flow,rows,want", [
    ("generic", None, 8), ("generic", 4, 4), ("generic", 1, 1),
    ("d256 k64", None, 1)])
def test_module_list_window_launches_the_tile_kernel(monkeypatch, flow,
                                                     rows, want):
    f = _generic() if flow == "generic" else _arqs(256, (64, 128), 64, 1)
    if rows is None:
        assert nuts_cuda.tile_rows(_model(f)) == want
    assert _launched(monkeypatch, f, rows) == ("nuts_chain_window_f32",
                                               (want, 0), 1)


@pytest.mark.parametrize("flow,rows", [("generic", 3), ("generic", 16),
                                       ("d256 k64", 2)])
def test_module_list_window_refuses_what_check_tile_refuses(monkeypatch,
                                                            flow, rows):
    f = _generic() if flow == "generic" else _arqs(256, (64, 128), 64, 1)
    with pytest.raises(ValueError):
        nuts_cuda.check_tile(_model(f), rows)
    with pytest.raises(ValueError):
        _launched(monkeypatch, f, rows)
    assert nw.LAUNCHES == 0


def test_affine_window_keeps_its_kernel(monkeypatch):
    """The ceiling's affine flow runs on K2's tile kernel at R = 8, its
    weights resident; the per-warp window is on no path."""
    model = _model(_affine(64, (128, 128)))
    assert _launched(monkeypatch, _affine(64, (128, 128))) == (
        "nuts_chain_window_f32", (8, model.resident_floats), 1)
    assert model.resident_floats > 0


@pytest.mark.parametrize("kind", ["affine", "cpu"])
def test_per_warp_window_refuses_affine_flows_and_cpu_tensors(kind):
    model = _model(_affine(D, (16, 16)) if kind == "affine"
                   else _arqs(D, (16, 16), 4, 2))
    g = torch.Generator().manual_seed(0)
    q = torch.randn((4, D), generator=g)
    rnd = nw.draw_window_randomness(g, 4, D, 2, 3, torch.ones(D))
    with pytest.raises(ValueError, match="CUDA"):
        nw.chain_window_warp(q, *rnd, torch.tensor(0.3), torch.ones(D),
                             model, 3, 2)


# ---------------------------------------------------------------------------
# chip_smoke.py's accounting of the tile window
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,key", [
    ("_ZN55_GLOBAL__N__5c1e2b0a_14_nuts_window_cu_4f5d8e21_31123nuts_"
     "window_tile_kernelILi2EEEvN13tpuflows_nuts4ArgsENS1_9ChainListEii",
     "K2 tile d/32=2"),
    ("_ZN55_GLOBAL__N__5c1e2b0a_14_nuts_window_cu_4f5d8e21_31124nuts_"
     "window_chain_kernelILi8EEEvN13tpuflows_nuts4ArgsENS1_9ChainListEi",
     "K2 chain d/32=8")])
def test_ptxas_summary_names_the_window_kernels(name, key):
    log = (f"ptxas info    : Compiling entry function '{name}' for "
           "'sm_90a'\n    0 bytes stack frame, 0 bytes spill stores, 0 "
           "bytes spill loads\nptxas info    : Used 255 registers, used 1 "
           "barriers\n")
    assert chip_smoke.ptxas_summary(log) == {key: {
        "spill_stores": 0, "spill_loads": 0, "registers": 255,
        "static_smem": 0}}


def test_lockstep_efficiency_of_a_window():
    # one tile of two chains: 1 start gradient, then slot 0 computes 1 +
    # 2 + 4 leaves for (1, 7) and slot 1 1 + 2 for (3, 3): 11 per row for
    # 1 + 7 + 3 + 3 leapfrogs and 2 start points
    steps = torch.tensor([[1.0, 7.0], [3.0, 3.0]])
    assert nw.window_lockstep_gradients(steps, 2) == 11
    assert chip_smoke.lockstep_efficiency(steps, 2) == 16 / 22
    assert chip_smoke.lockstep_efficiency(steps, 1) == 1.0


# ---------------------------------------------------------------------------
# a window's chains are independent on module-list flows (the premise of
# K2's tile lockstep)
# ---------------------------------------------------------------------------
def _chain_by_chain(run, n):
    outs = [run(slice(i, i + 1)) for i in range(n)]
    return tuple(np.concatenate([o[j] for o in outs], axis=1)
                 for j in range(8))


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_module_list_window_chains_are_independent(side):
    jf = jax_arqs_flow(0, d=D, n_blocks=3, knots=8, scale=0.03)
    n, S, depth, eps = 12, 4, 4, 0.1
    inp, im = window_inputs(3, D, S, depth, n=n)
    if side == "jax":
        jp, jtarget = j_permute(jf), JFunnel(dim=D)

        def jgrad(z):
            return j_streamed(jp, z, jtarget.log_density)

        fn = jax.jit(lambda q, p0c, dd, ua, ut: _window_math(
            q, p0c, dd, ua, ut, jnp.asarray(eps, jnp.float32),
            jnp.asarray(im).reshape(1, -1), jgrad, S, depth, 1000.0))

        def run(sl):
            out = fn(*(jnp.asarray(inp[k][sl]) for k in KEYS))
            draws = np.stack([np.asarray(o) for o in out[:S]])
            return (draws, *(np.asarray(o).T for o in out[S:]))
    else:
        model = _model(carry(jf, use_pallas="auto"))

        def run(sl):
            out = nw.nuts_window(
                *(torch.from_numpy(inp[k][sl]) for k in KEYS),
                torch.tensor(eps), torch.from_numpy(im), model, depth, S)
            return tuple(o.numpy() for o in out)
    batch = run(slice(0, n))
    single = _chain_by_chain(run, n)
    assert batch[0].shape == (S, n, D) and batch[1].shape == (S, n)
    assert len(np.unique(batch[4])) >= 2  # trees of different depths
    for j in (3, 4, 5, 6):  # leapfrogs, depth, divergence, U-turn
        np.testing.assert_array_equal(single[j], batch[j])
    for j in (0, 1, 2, 7):  # draws, logp, acceptance, energy
        np.testing.assert_allclose(single[j], batch[j], rtol=1e-5,
                                   atol=1e-5)
