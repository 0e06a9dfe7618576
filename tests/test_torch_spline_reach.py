"""Splines of any knot count and coupling blocks past shared memory, on
the CPU: the port against the JAX package on the same seeded numpy inputs.

  * `RQSCouplingBlock` at K = 96 under every tier (False, True, "auto",
    "fused"), forward, inverse and the gradients of x and of every weight
    and bias, against the JAX package's oracle block with the same leaves:
    values within JAX_BAR (tests/test_torch_rqs.py), gradients within the
    JAX package's relative bar max|a - b| / (1 + max|a|) < 1e-4 wherever
    both float32 evaluations lie that close to a float64 one (`_agree`,
    as tests/test_torch_coupling_fused.py holds the inverse: at least 95%
    of the values);
  * K4/K5's plain versions (`plain_eval`, `plain_grad`): values against
    the JAX kernel `_pallas_eval` in interpret mode at K = 65; values and
    pullbacks against the JAX oracle (`tpuflows.flows.rqs_ref`) at K =
    128 in float64 (1e-9), and in float32 y and ladj by `_judge` (about
    as accurate as the port's oracle against float64, in units of
    JAX_BAR); at K = 257
    and 1000 y and ladj in float64 against the JAX oracle run op by op
    (1e-9), and the rest against the port's oracle, which
    tests/test_torch_rqs.py holds to the JAX one. The JAX package's
    spline compiles its K-unrolled math for each K on the CPU: the Pallas
    pullback took minutes at K = 65, the oracle's vjp minutes at K =
    1000;
  * K6/K7's plain block against the JAX block op (`coupling_pallas`,
    interpret mode) with 10 layers, JAX_BAR on the values and the
    relative bar on the pullback (the K = 96 block, every tier, against
    the JAX oracle block above);
  * the host planners: `tile_plan` gives the wide unit's plan where no
    tile takes the block (more than 8 layers, a tile past shared memory),
    with the tile plan's chunk where it is forced at a shape both take;
    `rqs_cuda.spline_plan`'s elements a block and its one refusal point;
    the refusal when a block is built for a CUDA device;
  * `pack_flow` and `wide_path` at K = 96 (the tile kernels) and 1000 (the
    wide units);
  * chip_smoke.py's float32 witnesses compute the function they witness
    (in float64): the block with its hidden units reordered, the flow
    reordered, and the flow summing in the tile gradient's order.

About 58 s on one CPU worker (pytest, imports included).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows.flows import rqs_ref as j_ref
from tpuflows.flows.coupling import RQSCouplingBlock as JRQS
from tpuflows.flows.nets import MLP as JMLP
from tpuflows.kernels import coupling_pallas as j_coupling
from tpuflows.kernels import rqs_pallas as j_pallas

from tpuflows_torch.flows import MLP, RQSCouplingBlock
from tpuflows_torch.flows.core import Chain
from tpuflows_torch.kernels import coupling_cuda as cc
from tpuflows_torch.kernels import nuts_cuda, rqs_cuda
from tpuflows_torch.kernels.tile_flow import tile_logp_and_grad_streamed
from tpuflows_torch.targets import NealsFunnel
from tpuflows_torch.util.shapes import alternating_mask

from test_torch_coupling_fused import leaves
from test_torch_rqs import JAX_BAR, _inputs, _torch_grads

B = 4.0
REL_BAR = 1e-4  # max|a - b| / (1 + max|a|), the JAX package's grad bar


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (1.0 + np.max(np.abs(a))))


def _blocks(seed, d, hidden, knots, tier):
    """(JAX oracle block, port block under `tier`) with the same leaves."""
    mask = alternating_mask(d, 0)
    ws, bs = leaves(seed, d, hidden, knots)
    jb = JRQS(mask=tuple(mask), net=JMLP(
        weights=tuple(jnp.asarray(w) for w in ws),
        biases=tuple(jnp.asarray(b) for b in bs)), knots=knots,
        use_pallas=False)
    tb = RQSCouplingBlock(tuple(mask), MLP(
        [torch.from_numpy(w).requires_grad_(True) for w in ws],
        [torch.from_numpy(b).requires_grad_(True) for b in bs]),
        knots=knots, use_pallas=tier)
    return jb, tb


BLOCK_SHAPE = (6, (16,), 96, 12)  # d, hidden, K, rows


def _block_x():
    d, _, _, n = BLOCK_SHAPE
    return (2.0 * np.random.default_rng(7).normal(size=(n, d))).astype(
        np.float32)


@functools.lru_cache(maxsize=2)
def _jax_block_grads(inverse):
    """(z, ladj, (dx, d weights, d biases)) of sum(z * c) + sum(ladj), c a
    fixed pattern, by jax.grad of the JAX oracle block, once per
    direction."""
    d, hidden, K, _ = BLOCK_SHAPE
    jb, _ = _blocks(5, d, hidden, K, False)
    x = _block_x()
    c = np.cos(np.arange(x.size, dtype=np.float32)).reshape(x.shape)

    def loss(xx, ws, bs):
        blk = JRQS(mask=jb.mask, net=JMLP(weights=ws, biases=bs),
                   knots=jb.knots, use_pallas=False)
        f = blk.inverse_and_ladj if inverse else blk.forward_and_ladj
        z, ladj = f(xx)
        return jnp.sum(z * c) + jnp.sum(ladj), (z, ladj)

    (_, (z, ladj)), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jb.net.weights, jb.net.biases)
    return z, ladj, grads


def _agree(port, jax32, exact, atol, rtol, share=0.95):
    """The port's float32 values against the JAX package's, as
    tests/test_torch_coupling_fused.py holds the inverse: within atol +
    rtol |b| of them wherever both float32 evaluations lie that close to
    the float64 referee `exact`, which must be at least `share` of the
    values. Float32 resolves a few values of a pullback (narrow bins, the
    inverse's root) to no such bar in either package, each rounding its
    own way."""
    port, jax32, exact = (np.asarray(a, np.float64)
                          for a in (port, jax32, exact))
    assert np.all(np.isfinite(port))
    bar = atol + rtol * np.abs(exact)
    ok = (np.abs(port - exact) <= bar) & (np.abs(jax32 - exact) <= bar)
    assert ok.mean() >= share, ok.mean()
    np.testing.assert_allclose(port[ok], jax32[ok], atol=atol, rtol=rtol)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("tier", [False, True, "auto", "fused"])
def test_block_of_96_knots_runs_every_tier(tier, inverse):
    """Every tier takes K > 64 on the CPU: the plain versions share no knot
    limit with the kernels. The values within JAX_BAR of the JAX oracle
    block; the gradients within
    the relative bar of it (`_agree`, the port's block in float64 as the
    referee)."""
    d, hidden, K, _ = BLOCK_SHAPE
    x = _block_x()
    _, tb = _blocks(5, d, hidden, K, tier)
    z_j, ladj_j, (gx_j, gw_j, gb_j) = _jax_block_grads(inverse)
    got = _port_block_grads(tb, x, inverse)
    np.testing.assert_allclose(got[0], np.asarray(z_j), **JAX_BAR)
    np.testing.assert_allclose(got[1], np.asarray(ladj_j), **JAX_BAR)
    _, t64 = _blocks(5, d, hidden, K, False)
    exact = _port_block_grads(t64.double(), x.astype(np.float64), inverse)
    for a, j, e in zip(got[2:], [gx_j, *gw_j, *gb_j], exact[2:]):
        _agree(a, j, e, REL_BAR * (1.0 + np.abs(e).max()), 0.0)


def _port_block_grads(tb, x, inverse):
    """(z, ladj, dx, d weights..., d biases...) of the port's block for
    the loss `_jax_block_grads` differentiates."""
    xt = torch.from_numpy(x).requires_grad_(True)
    f = tb.inverse_and_ladj if inverse else tb.forward_and_ladj
    z, ladj = f(xt)
    c = torch.cos(torch.arange(x.size, dtype=xt.dtype)).reshape(x.shape)
    params = [*tb.net.weights, *tb.net.biases]
    grads = torch.autograd.grad((z * c).sum() + ladj.sum(), [xt, *params])
    return [t.detach().numpy() for t in (z, ladj, *grads)]


def _with_x64(fn):
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        return fn()
    finally:
        jax.config.update("jax_enable_x64", prev)


@pytest.mark.parametrize("inverse", [False, True])
def test_plain_spline_matches_pallas_interpret(inverse):
    """y and ladj at K = 65 (past the old 64) against the JAX kernel
    `_pallas_eval` in interpret mode (jit: one compile of its K-unrolled
    tile math, ~9 s a direction here; its pullback took minutes, and K =
    96 twice as long, so the pullbacks are held to the JAX oracle)."""
    K = 65
    x, raw, _, _ = _inputs(465, (6, 3), K)
    name = "rqs_inverse_from_raw" if inverse else "rqs_forward_from_raw"
    want = jax.jit(getattr(j_pallas, name))(jnp.asarray(x), jnp.asarray(raw))
    got = rqs_cuda.plain_eval(torch.from_numpy(x), torch.from_numpy(raw), B,
                              inverse)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **JAX_BAR)


def _judge(port, other, exact, atol, rtol):
    """chip_smoke.py's `judge`, with its own factor: the port's float32
    values against another float32 evaluation of the spline, both
    against the float64 referee `exact`, errors counted in units of atol
    + rtol |exact|: the port's count of values beyond one unit and its
    error at the quantile of `chip_smoke.block_quantile` at most 2.5
    times the other's, plus 2 values and 0.5 unit. Past a hundred knots
    float32 places the knots, summed one bin after another, only to
    about K ulps of B in either package, and the tile math (the plain
    version's, and the JAX Pallas kernel's) rounds them in units of B
    where the oracle sums bin widths: its float32 errors there ran to
    about twice the oracle's (1.8 at K = 257)."""
    port, other, exact = (np.asarray(a, np.float64).ravel()
                          for a in (port, other, exact))
    assert np.all(np.isfinite(port))
    unit = atol + rtol * np.abs(exact)
    ep, eo = np.abs(port - exact) / unit, np.abs(other - exact) / unit
    q = max(0.5, min(0.999, 1.0 - 10.0 / ep.size))
    assert (ep > 1).sum() <= 2.5 * (eo > 1).sum() + 2
    assert np.quantile(ep, q) <= 2.5 * np.quantile(eo, q) + 0.5


def _spline_referee(x, raw, gy, gl, inverse, oracle, exact_fn):
    """The plain K4/K5 in float64 equal to `exact_fn` (the oracle in
    float64: y, ladj, dx, draw) within 1e-9, the math at this K; in
    float32, y and ladj against `oracle` (the oracle in float32) by
    `_judge` at JAX_BAR, dx and draw finite (the tile math's float32
    pullback at hundreds of knots missed the bar of float64 on up to 3.4
    times as many draw values as the oracle's; chip_smoke.py's `judge`
    holds the kernels to the plain version there). Returns the float32
    plain outputs."""
    got = _torch_grads(
        lambda xt, rt: rqs_cuda.plain_eval(xt, rt, B, inverse), x, raw, gy,
        gl)
    f64 = [t.astype(np.float64) for t in (x, raw, gy, gl)]
    exact = exact_fn(*f64)
    got64 = _torch_grads(
        lambda xt, rt: rqs_cuda.plain_eval(xt, rt, B, inverse), *f64)
    for i, (a, b, e, a64) in enumerate(zip(got, oracle, exact, got64)):
        np.testing.assert_allclose(a64, e, rtol=1e-9, atol=1e-9)
        if i < 2:
            _judge(a, b, e, **JAX_BAR)
        assert np.all(np.isfinite(a))
    return got


@pytest.mark.parametrize("inverse", [False, True])
def test_plain_spline_matches_jax_oracle(inverse):
    """K = 128: y, ladj, dx and draw of the plain K4/K5 against the JAX
    oracle (`jax.vjp`, jitted: op by op its forward pullback took ~14 s
    here, compiled ~5 s) in float64; in float32 against the port's
    oracle (one JAX compile of the 128 knot steps, not two)."""
    from tpuflows_torch.flows import rqs_ref

    K = 128
    x, raw, gy, gl = _inputs(500 + K, (20, 4), K)
    name = "rqs_inverse_from_raw" if inverse else "rqs_forward_from_raw"
    fn = getattr(j_ref, name)

    @jax.jit
    def pullback(x, raw, gy, gl):
        out, pull = jax.vjp(fn, x, raw)
        return (*out, *pull((gy, gl)))

    _spline_referee(x, raw, gy, gl, inverse,
                    _torch_grads(getattr(rqs_ref, name), x, raw, gy, gl),
                    lambda *a: _with_x64(lambda: tuple(
                        np.asarray(t) for t in pullback(
                            *(jnp.asarray(v) for v in a)))))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("K", [257, 1000])
def test_plain_spline_at_hundreds_of_knots(K, inverse):
    """K = 257 and 1000: y and ladj of the plain K4 in float64 against
    the JAX oracle (`tpuflows.flows.rqs_ref`, run op by op without jit:
    ~1-3 s a call here, where its jitted knot steps, and its vjp's in
    either mode, compile or run for minutes: 20 s and 76 s for the
    forward vjp at K = 257 and 1000) within 1e-9; the pullbacks, and the
    float32 values, against the port's oracle (`flows/rqs_ref.py`, held
    to the JAX one by tests/test_torch_rqs.py and by these values). At K
    = 1000 min_bin K = 1: every bin is min_bin wide whatever the raw
    values, and the widths' and heights' cotangents are 0."""
    from tpuflows_torch.flows import rqs_ref

    x, raw, gy, gl = _inputs(500 + K, (20, 4), K)
    name = "rqs_inverse_from_raw" if inverse else "rqs_forward_from_raw"
    fn = getattr(rqs_ref, name)
    got = _spline_referee(x, raw, gy, gl, inverse,
                          _torch_grads(fn, x, raw, gy, gl),
                          lambda *a: _torch_grads(fn, *a))
    x64, raw64 = x.astype(np.float64), raw.astype(np.float64)
    want = _with_x64(lambda: [np.asarray(t) for t in getattr(j_ref, name)(
        jnp.asarray(x64), jnp.asarray(raw64))])
    mine = rqs_cuda.plain_eval(torch.from_numpy(x64), torch.from_numpy(raw64),
                               B, inverse)
    for a, b in zip(mine, want):
        assert b.dtype == np.float64
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-9, atol=1e-9)
    if K == 1000:
        assert not got[3][..., :2 * K].any()


def _flat(seed, d, hidden, K):
    ws, bs = leaves(seed, d, hidden, K)
    jw = tuple(jnp.asarray(w) for w in ws)
    jbias = tuple(jnp.asarray(b) for b in bs)
    net = MLP([torch.from_numpy(w) for w in ws],
              [torch.from_numpy(b) for b in bs])
    return (j_coupling._flatten_params(JMLP(weights=jw, biases=jbias), d, K),
            cc.flatten_params(net, d, K))


@pytest.mark.parametrize("inverse", [False, True])
def test_plain_block_of_ten_layers_matches_the_jax_block_op(inverse):
    """10 layers (9 hidden): z, ladj, dx and every weight's cotangent of
    the plain K6/K7 against the JAX block op on one grid step of 128 rows,
    whose VJP is the Pallas backward kernel (interpret mode): JAX_BAR on
    the values, the relative bar on the pullback. (At K = 96 the block op
    compiles for minutes; the K = 96 block is held to the JAX oracle block
    by `test_block_of_96_knots_runs_every_tier`.)"""
    d, n, K, hidden = 4, j_coupling.TILE_B, 4, (8,) * 9
    mask = alternating_mask(d, 1)
    jflat, tflat = _flat(11, d, hidden, K)
    x = (2.0 * np.random.default_rng(K).normal(size=(n, d))).astype(
        np.float32)
    rng = np.random.default_rng(K + 1)
    gz = rng.normal(size=(n, d)).astype(np.float32)
    gl = rng.normal(size=n).astype(np.float32)
    op = j_coupling._inv_block_op if inverse else j_coupling._fwd_block_op
    (jz, jl), pull = jax.vjp(
        lambda xx, ps: op(xx, ps, tuple(mask), K, B, 1e-3, 1e-3, "silu",
                          "f32"), jnp.asarray(x), jflat)
    jdx, jdp = pull((jnp.asarray(gz), jnp.asarray(gl)[:, None]))
    m = torch.tensor(mask, dtype=torch.float32)
    tz, tl = cc.plain_block(torch.from_numpy(x), tflat, m, K, B, "silu",
                            inverse)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **JAX_BAR)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[:, 0], **JAX_BAR)
    tdx, tdp = cc.plain_block_vjp(torch.from_numpy(x), tflat, m,
                                  torch.from_numpy(gz), torch.from_numpy(gl),
                                  K, B, "silu", inverse)
    assert _rel(jdx, tdx.numpy()) < REL_BAR
    for a, b in zip(jdp, tdp):
        assert _rel(a, b.numpy()) < REL_BAR


def test_tile_plan_falls_to_the_wide_unit():
    """Where no tile fits (or the block has more than 8 layers) the plan
    is the wide unit's; forced at a shape the tile kernels take, it keeps
    their chunk of spline dims (one order of sums) and pass 2's slices."""
    fit = [64, 128, 128, 23 * 64]
    for grad in (False, True):
        tile = cc.tile_plan(fit, 8, 32, 1024, grad)
        forced = cc.tile_plan(fit, 8, 32, 1024, grad, wide=True)
        assert not tile.wide and forced.wide
        assert (forced.rows, forced.stage, forced.smem) == (cc.WIDE_ROWS, 0,
                                                            0)
        assert (forced.dc, forced.slices) == (tile.dc, tile.slices)
    for widths, nt, grad in (([64, 3648, 23 * 64], 32, False),
                             ([64, 2496, 23 * 64], 32, True),
                             ([64, 1568, 1568, 1568, 1568, 23 * 64], 32,
                              True),
                             ([4096, 128, 23 * 4096], 2048, False),
                             ([64, *[256] * 9, 23 * 64], 32, False)):
        plan = cc.tile_plan(widths, 8, nt, 1024, grad)
        assert plan.wide and plan.dc == min(32, -(-nt // 2)), widths
    # one step narrower, the tile kernels take them
    assert not cc.tile_plan([64, 3616, 23 * 64], 8, 32, 1024, False).wide
    assert not cc.tile_plan([64, 2464, 23 * 64], 8, 32, 1024, True).wide
    assert not cc.tile_plan([64, *[256] * 7, 23 * 64], 8, 32, 1024,
                            False).wide
    # the work buffer: two activation buffers of 16 rows x the widest
    # input, K7's act'(a), two CTAs' regions; one cluster a tile, at most 66
    w = [64, 3200, 23 * 64]
    per = cc.wide_floats(w, 8, 16, True, 16)
    assert per == 2 * 16 * 3200 + 16 * 3200 + 2 * (16 * 23 * 16 + 23 * 16
                                                    + 16 * 3200)
    assert cc.wide_floats(w, 8, 16, True, 1024) == 64 * per
    assert cc.wide_floats(w, 8, 16, True, 10 ** 6) == cc.WIDE_CLUSTERS * per


def test_spline_plan_elements_and_refusal():
    """Below 32 lanes a block is 256 / L elements; at 32, 8 elements up
    to K = 1,208 (K5) and 1,452 (K4), then 4, 2 and one, up to K = 9,684
    (K5) and 11,620 (K4); past that the kernels refuse, naming shared
    memory. The plain versions take any K."""
    for grad, edges, last in ((True, (1208, 2420, 4840), 9684),
                              (False, (1452, 2904, 5809), 11620)):
        for K in (8, 64, 96, 128):
            plan = rqs_cuda.spline_plan(K, grad)
            L = rqs_cuda.lane_layout(K, rqs_cuda.LANE_BINS if grad else
                                     rqs_cuda.EVAL_LANE_BINS)[0]
            assert plan.lanes == L and plan.lanes * plan.elements in (256,)
        for E, K in zip((8, 4, 2), edges):
            assert rqs_cuda.spline_plan(K, grad).elements == E
            assert rqs_cuda.spline_plan(K + 1, grad).elements == E // 2
        plan = rqs_cuda.spline_plan(last, grad)
        assert (plan.lanes, plan.elements) == (32, 1)
        assert plan.smem <= rqs_cuda.MAX_SMEM
        with pytest.raises(ValueError, match="shared memory"):
            rqs_cuda.spline_plan(last + 1, grad)
    # past min_bin K = 1 a bin is min_bin - (min_bin K - 1) softmax: raw
    # logits near 0 keep every bin positive
    x, raw, _, _ = _inputs(9, (2, 1), 11621)
    y, ladj = rqs_cuda.spline_eval(torch.from_numpy(x),
                                   0.01 * torch.from_numpy(raw))
    assert torch.isfinite(y).all() and torch.isfinite(ladj).all()


class _OnCuda:
    """A conditioner that reports a CUDA device (its weights' device is
    all that a block reads when it is built)."""
    weights = [type("W", (), {"device": torch.device("cuda")})()]


@pytest.mark.parametrize("tier,refused", [(True, True), ("auto", True),
                                          ("fused", False), (False, False)])
def test_blocks_past_the_kernel_limit_are_refused_when_built(
        monkeypatch, tier, refused):
    """A block whose K4/K5 cannot be planned is refused when it is built
    for a CUDA device under True or "auto" (never at a launch), naming
    the shared memory; "fused" and False build it, and so does the CPU
    under every tier."""
    monkeypatch.setattr("tpuflows_torch.flows.coupling.mask_array",
                        lambda mask, device=None: torch.tensor(mask))
    K = 9685
    RQSCouplingBlock.init(torch.Generator().manual_seed(0), (1, 0), knots=K,
                          hidden=(2,), use_pallas=tier, device="cpu")
    if refused:
        with pytest.raises(ValueError, match="shared memory"):
            RQSCouplingBlock((1, 0), _OnCuda(), knots=K, use_pallas=tier)
    else:
        RQSCouplingBlock((1, 0), _OnCuda(), knots=K, use_pallas=tier)
    RQSCouplingBlock((1, 0), _OnCuda(), knots=K - 1, use_pallas=tier)


@pytest.mark.parametrize("K,wide", [(96, False), (1000, True)])
def test_pack_flow_and_wide_path_at_large_knots(K, wide):
    """The 64-d funnel under 2 rqs blocks of hidden [64, 64]: K = 96 packs
    onto the tile kernels at R = 1, K = 1000 onto the wide units (one row
    leaves no room for a weight ring)."""
    g = torch.Generator().manual_seed(K)
    flow = Chain([RQSCouplingBlock.init(g, alternating_mask(64, i % 2),
                                        knots=K, hidden=(64, 64),
                                        use_pallas="auto", device="cpu")
                  for i in range(2)])
    model = nuts_cuda.pack_flow(flow, NealsFunnel(dim=64))
    assert nuts_cuda.wide_path(model, 4) == wide
    if not wide:
        assert nuts_cuda.tile_rows(model) == 1


@pytest.mark.parametrize("name,key", [
    ("_ZN46_GLOBAL__N__6ef3eb06_13_rqs_spline_cu_57cc75a021rqs_grad_"
     "lanes_kernelILb1ELi2ELi128EEEvPKfS2_S2_S2_PfS3_xif", "K5 inverse L=2"),
    ("_ZN46_GLOBAL__N__6ef3eb06_13_rqs_spline_cu_57cc75a021rqs_grad_"
     "lanes_kernelILb0ELi32ELi8EEEvPKfS2_S2_S2_PfS3_xif", "K5 forward L=32"),
    ("_ZN46_GLOBAL__N__6ef3eb06_13_rqs_spline_cu_57cc75a021rqs_eval_"
     "lanes_kernelILb1ELi32ELi1EEEvPKfS2_PfS3_xif", "K4 inverse L=32 E=1"),
    ("_ZN46_GLOBAL__N__5d1c2b3a_16_coupling_wide_cu_0a1b2c3d24coupling_wide_"
     "fwd_kernelILb1ELb0EEEvNS_4WideEPfS2_", "K6 wide inverse"),
    ("_ZN46_GLOBAL__N__5d1c2b3a_16_coupling_wide_cu_0a1b2c3d24coupling_wide_"
     "bwd_kernelILb0ELb1EEEvNS_4WideEPKfS3_PfS4_S4_",
     "K7 wide pass 1 forward bf16")])
def test_ptxas_summary_names_the_new_units(name, key):
    """chip_smoke.py's ptxas keys: the lane units by L, and by their
    elements a block where that is not 256 / L; the wide unit's K6 and
    K7 pass 1 by direction and dtype."""
    import chip_smoke

    assert chip_smoke._kernel_key(name) == key


def test_block_witnesses_compute_the_same_block():
    """chip_smoke.py's float32 witnesses of a block row in float64: the
    plain block under `permuted_params` (its hidden units reordered)
    gives the same z and ladj, and its cotangents, put back by
    `unpermute_cotangents`, the same dx and weight cotangents (1e-12)."""
    import chip_smoke

    x, params, gz, gl = chip_smoke.coupling_inputs(
        "cpu", 16, 8, (12, 10), 5, "he0.01", 1)
    x, gz, gl = x.double(), gz.double(), gl.double()
    params = tuple(p.double() for p in params)
    perms = chip_smoke.hidden_perms([8, 12, 10, 14 * 8], 3, "cpu")
    assert all(not torch.equal(p, torch.arange(p.numel())) for p in perms)
    wp = chip_smoke.permuted_params(params, perms)
    m = torch.tensor(alternating_mask(8, 0), dtype=torch.float64)
    for inverse in (False, True):
        want = cc.plain_block(x, params, m, 5, B, "silu", inverse)
        got = cc.plain_block(x, wp, m, 5, B, "silu", inverse)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
        wdx, wdp = cc.plain_block_vjp(x, params, m, gz, gl, 5, B, "silu",
                                      inverse)
        gdx, gdp = cc.plain_block_vjp(x, wp, m, gz, gl, 5, B, "silu",
                                      inverse)
        np.testing.assert_allclose(gdx, wdx, rtol=1e-12, atol=1e-12)
        for a, b in zip(chip_smoke.unpermute_cotangents(gdp, perms), wdp):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def test_nuts_witnesses_compute_the_same_gradient():
    """chip_smoke.py's float32 witnesses of a K1 row in float64, at 12
    knots on the funnel's d = 8: `permuted_flow` (hidden units
    reordered) and `kernel_order_flow` (each product summed input by
    input, the tile gradient's order) give the plain version's log
    density and gradient (1e-10)."""
    import chip_smoke

    target = NealsFunnel(dim=8)
    flow = chip_smoke.reach_flow("cpu", "rqs", 8, (6, 6), 5, 12)
    z = torch.randn(6, 8, generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64)
    model = chip_smoke.f64_model(flow, target)
    lp, g = nuts_cuda.plain_logp_grad(model)(z)
    perm = chip_smoke.f64_model(chip_smoke.permuted_flow(flow, 3), target)
    pt = model.packed_target
    ordered = chip_smoke.kernel_order_flow(model.flow_p)
    for got in (nuts_cuda.plain_logp_grad(perm)(z),
                tile_logp_and_grad_streamed(
                    ordered, z,
                    lambda x: nuts_cuda.packed_log_density(pt, x))):
        np.testing.assert_allclose(got[0], lp, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(got[1], g, rtol=1e-10, atol=1e-10)
