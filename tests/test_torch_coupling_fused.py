"""The fused coupling-block tier of the port (use_pallas="fused", K6/K7 in
`tpuflows_torch.kernels.coupling_cuda`) against the JAX package's, on the
same numpy leaves and inputs. On the CPU the tier runs its plain version
(`block_math` with autograd); the JAX side runs its Pallas block kernel in
interpret mode, as tests/test_pallas.py does, or its oracle block.

  * `flatten_params` against JAX's `_flatten_params`: the same p-major
    relayout, exactly;
  * the block's values, forward and inverse, at (d, batch) = (4, 37) and
    (8, 256), hidden (16,), K = 4, last layer 0.1 N(0, 1), against the JAX
    fused block to JAX's own bar (atol 1e-4), and the inverse against the
    JAX oracle to its 5e-3 (tests/test_pallas.py);
  * the gradients of x and of every weight and bias, both directions,
    against jax.grad of the JAX oracle block (the fused VJP in interpret
    mode is the slow tier's), to JAX's relative bar max|a - b| / (1 +
    max|a|) < 1e-4, for each ported activation and one and two hidden
    layers;
  * the single-vector rule, the converter carrying "fused", the STL
    gradients of an arqs flow on this tier, and which pullbacks ask for
    the weights' cotangents (what K7's launch count on the card follows);
  * a torch mirror of K7's two-pass design (per-row cotangents of each
    layer, then H^T G summed over the rows), over the spline dims only,
    against autograd in float64;
  * the float64 repair of the K4/K5 tier on the CPU, against the JAX
    oracle block in float64;
  * no launch is counted on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows.flows.coupling import RQSCouplingBlock as JRQS
from tpuflows.flows.nets import MLP as JMLP
from tpuflows.kernels.coupling_pallas import _flatten_params

from tpuflows_torch.flows import MLP, RQSCouplingBlock
from tpuflows_torch.flows.rqs_ref import DEFAULT_RANGE
from tpuflows_torch.kernels import coupling_cuda, rqs_cuda
from tpuflows_torch.util.shapes import alternating_mask, block_mask

JAX_BAR = dict(rtol=1e-5, atol=1e-4)


def leaves(seed, d, hidden, knots, last_scale=0.1, bias_scale=0.1):
    """Numpy weights and biases of a conditioner d -> hidden -> d (3K-1):
    He-scaled hidden layers, the last layer `last_scale` N(0, 1) (the JAX
    tests' non-zero head), biases `bias_scale` N(0, 1)."""
    rng = np.random.default_rng(seed)
    sizes = (d, *hidden, d * (3 * knots - 1))
    ws = [rng.normal(0.0, np.sqrt(2.0 / a), (a, b))
          for a, b in zip(sizes[:-1], sizes[1:])]
    ws[-1] = last_scale * rng.normal(size=ws[-1].shape)
    bs = [bias_scale * rng.normal(size=b) for b in sizes[1:]]
    return ([w.astype(np.float32) for w in ws],
            [b.astype(np.float32) for b in bs])


def pair(seed, mask, hidden=(16,), knots=4, activation="silu",
         jax_tier="fused", torch_tier="fused", **kw):
    """(JAX block, port block) with the same leaves."""
    ws, bs = leaves(seed, len(mask), hidden, knots, **kw)
    jb = JRQS(mask=tuple(mask), net=JMLP(
        weights=tuple(jnp.asarray(w) for w in ws),
        biases=tuple(jnp.asarray(b) for b in bs), activation=activation),
        knots=knots, use_pallas=jax_tier)
    tb = RQSCouplingBlock(tuple(mask), MLP(
        [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs],
        activation=activation), knots=knots, use_pallas=torch_tier)
    return jb, tb


def _x(seed, n, d, scale=2.0):
    return (scale * np.random.default_rng(100 + seed).normal(
        size=(n, d))).astype(np.float32)


def _run(blk, x, inverse):
    with torch.no_grad():
        f = blk.inverse_and_ladj if inverse else blk.forward_and_ladj
        z, ladj = f(torch.from_numpy(x))
    return z.numpy(), ladj.numpy()


def _jrun(blk, x, inverse):
    f = blk.inverse_and_ladj if inverse else blk.forward_and_ladj
    z, ladj = f(jnp.asarray(x))
    return np.asarray(z), np.asarray(ladj)


@pytest.mark.parametrize("d,knots,hidden", [(4, 4, (16,)), (8, 8, (16, 12)),
                                            (6, 5, ())])
def test_flatten_params_matches_jax(d, knots, hidden):
    jb, tb = pair(d, alternating_mask(d, 0), hidden=hidden, knots=knots)
    want = _flatten_params(jb.net, d, knots)
    got = coupling_cuda.flatten_params(tb.net, d, knots)
    assert len(got) == len(want) == 2 * (len(hidden) + 1)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))


def test_flatten_params_is_differentiable():
    """The relayout carries cotangents back to the module's d-major
    parameters: a cotangent on p-major column p d + j lands on column
    j (3K-1) + p."""
    d, knots = 3, 2
    _, tb = pair(0, (1, 0, 0), hidden=(4,), knots=knots)
    P = 3 * knots - 1
    flat = coupling_cuda.flatten_params(tb.net, d, knots)
    p, j = 2, 1
    (gw,) = torch.autograd.grad(flat[-2][:, p * d + j].sum(),
                                tb.net.weights[-1])
    hot = torch.zeros_like(gw)
    hot[:, j * P + p] = 1.0
    assert torch.equal(gw, hot)


@pytest.mark.parametrize("d,batch", [(4, 37), (8, 256)])
@pytest.mark.parametrize("inverse", [False, True])
def test_fused_block_values_match_jax_fused_block(d, batch, inverse):
    """JAX's fused block in interpret mode (batch 37 is ragged: JAX pads
    to 128 rows, the port masks its own edge), with the JAX test's block:
    He-initialised hidden layer, zero biases, last layer 0.1 N(0, 1), and
    its bars: atol 1e-4 against the fused kernel, 5e-3 for the inverse
    against the oracle. The inverse is ill-conditioned in float32 at a few
    points (narrow bins): there the port's and JAX's conditioners, which
    round their products differently, move x by more than 1e-4, as far as
    either is from a float64 evaluation. So the inverse is held to 1e-4
    where both float32 evaluations are within 1e-4 of float64 (all but at
    most 1% of the values), and to 5e-3 everywhere."""
    jb, tb = pair(0, alternating_mask(d, 0), bias_scale=0.0)
    jo = JRQS(mask=jb.mask, net=jb.net, knots=jb.knots, use_pallas=False)
    x = _x(d, batch, d)
    if inverse:  # latent points: the forward image of x
        x = _jrun(jo, x, False)[0]
    z, ladj = _run(tb, x, inverse)
    jz, jl = _jrun(jb, x, inverse)
    assert z.shape == (batch, d) and ladj.shape == (batch,)
    if inverse:
        ez, el = _run(tb.double(), x.astype(np.float64), inverse)
        for a, b, e in ((z, jz, ez), (ladj, jl, el)):
            ok = (np.abs(a - e) <= 1e-4) & (np.abs(b - e) <= 1e-4)
            assert ok.mean() >= 0.99
            np.testing.assert_allclose(a[ok], b[ok], **JAX_BAR)
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=5e-3)
    else:
        np.testing.assert_allclose(z, jz, **JAX_BAR)
        np.testing.assert_allclose(ladj, jl, **JAX_BAR)
    oz, ol = _jrun(jo, x, inverse)
    atol = 5e-3 if inverse else 1e-4
    np.testing.assert_allclose(z, oz, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(ladj, ol, rtol=1e-5, atol=atol)


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / (1.0 + np.max(np.abs(a))))


def _grads(jb, tb, x, inverse):
    """(port grads, JAX oracle grads) of sum(sin z) + sum(ladj^2) for x
    and every weight and bias, in (x, w0, b0, w1, b1, ...) order."""
    jo = JRQS(mask=jb.mask, net=jb.net, knots=jb.knots, use_pallas=False)

    def j_loss(net, xx):
        b = JRQS(mask=jo.mask, net=net, knots=jo.knots, use_pallas=False)
        f = b.inverse_and_ladj if inverse else b.forward_and_ladj
        z, ladj = f(xx)
        return jnp.sum(jnp.sin(z)) + jnp.sum(ladj * ladj)

    gnet, gx = jax.grad(j_loss, argnums=(0, 1))(jo.net, jnp.asarray(x))
    want = [np.asarray(gx)]
    for w, b in zip(gnet.weights, gnet.biases):
        want += [np.asarray(w), np.asarray(b)]
    xt = torch.from_numpy(x).requires_grad_(True)
    f = tb.inverse_and_ladj if inverse else tb.forward_and_ladj
    z, ladj = f(xt)
    params = [p for w, b in zip(tb.net.weights, tb.net.biases)
              for p in (w, b)]
    got = torch.autograd.grad(torch.sum(torch.sin(z))
                              + torch.sum(ladj * ladj), [xt, *params])
    return [g.numpy() for g in got], want


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("activation,hidden", [
    ("silu", (16,)), ("tanh", (16,)), ("relu", (12, 10)), ("silu", (8, 8))])
def test_fused_block_gradients_match_jax_oracle(activation, hidden,
                                                inverse):
    """d = 6, batch 160, K = 4, x ~ 1.5 N(0, 1): the setting of the JAX
    package's own (slow-tier) fused VJP test."""
    mask = block_mask(6, 1) if len(hidden) > 1 else alternating_mask(6, 1)
    jb, tb = pair(5, mask, hidden=hidden, activation=activation)
    x = _x(7, 160, 6, scale=1.5)
    got, want = _grads(jb, tb, x, inverse)
    assert len(got) == len(want) == 1 + 2 * (len(hidden) + 1)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(w, g) < 1e-4


def test_single_vector_takes_the_oracle(monkeypatch):
    """A 1-D input under "fused" or "auto" runs the oracle (JAX's rule:
    a fused call per vector would pad each to a whole tile)."""
    jb, tb = pair(1, alternating_mask(6, 0), jax_tier="fused")
    x = _x(1, 1, 6)[0]

    def refuse(*a, **k):
        raise AssertionError("a kernel tier ran on a single vector")

    monkeypatch.setattr(coupling_cuda, "fused_coupling_forward", refuse)
    monkeypatch.setattr(coupling_cuda, "fused_coupling_inverse", refuse)
    monkeypatch.setattr(rqs_cuda, "rqs_forward_from_raw", refuse)
    monkeypatch.setattr(rqs_cuda, "rqs_inverse_from_raw", refuse)
    for tier in ("fused", "auto"):
        tb.use_pallas = tier
        for inverse in (False, True):
            z, ladj = _run(tb, x, inverse)
            jz, jl = _jrun(jb, x, inverse)
            assert z.shape == (6,) and ladj.shape == ()
            np.testing.assert_allclose(z, jz, **JAX_BAR)
            np.testing.assert_allclose(ladj, jl, **JAX_BAR)
    assert tb._kernel_choice(torch.zeros(3, 6)) == True  # noqa: E712
    tb.use_pallas = "fused"
    assert tb._kernel_choice(torch.zeros(3, 6)) == "fused"
    assert tb._kernel_choice(torch.zeros(2, 3, 6)) == "fused"


def test_leading_batch_dims_and_no_launch_on_the_cpu():
    """(..., d) inputs are flattened to rows and back; on the CPU the
    plain version runs and no kernel launch is counted."""
    coupling_cuda.reset_launches()
    jb, tb = pair(2, block_mask(6, 0))
    x = _x(2, 12, 6).reshape(3, 4, 6)
    xt = torch.from_numpy(x).requires_grad_(True)
    z, ladj = tb.forward_and_ladj(xt)
    assert z.shape == (3, 4, 6) and ladj.shape == (3, 4)
    torch.autograd.grad(z.sum() + ladj.sum(), [xt, *tb.net.parameters()])
    jz, jl = _jrun(jb, x, False)
    np.testing.assert_allclose(z.detach().numpy(), jz, **JAX_BAR)
    np.testing.assert_allclose(ladj.detach().numpy(), jl, **JAX_BAR)
    assert coupling_cuda.LAUNCHES == {"k6_forward": 0, "k6_inverse": 0,
                                      "k7_forward": 0, "k7_inverse": 0}


def test_converter_carries_the_fused_tier():
    from test_torch_coupling import carry, jax_arqs_flow

    jf = jax_arqs_flow(3, n_blocks=2, use_pallas="fused")
    tf = carry(jf)
    tiers = [getattr(t, "use_pallas", None) for t in tf.transforms]
    assert tiers == [None, None, "fused", None, "fused"]
    z = (1.5 * np.random.default_rng(30).normal(size=(64, 8))).astype(
        np.float32)
    jx, jl = jf.inverse_and_ladj(jnp.asarray(z))
    with torch.no_grad():
        tx, tl = tf.inverse_and_ladj(torch.from_numpy(z))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **JAX_BAR)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **JAX_BAR)


def test_stl_gradients_on_an_arqs_flow_match_jax_on_the_fused_tier():
    """The STL loss and its gradient on every leaf of an arqs flow whose
    spline blocks are fused (the generic fit's path), against the JAX
    package's STL loss on its oracle flow, to JAX's spline bar."""
    from test_torch_coupling import carry, jax_arqs_flow
    from test_torch_train import D, _stl_loss_jax

    from tpuflows.targets import NealsFunnel as JFunnel
    from tpuflows_torch.flows.train import reverse_kl_stl_loss
    from tpuflows_torch.targets import NealsFunnel

    jf = jax_arqs_flow(7, d=D, n_blocks=2, knots=4, hidden=(16, 16))
    tf = carry(jf, use_pallas="fused")
    z = np.random.default_rng(70).normal(size=(128, D)).astype(np.float32)
    j_loss, j_grads = jax.value_and_grad(_stl_loss_jax)(
        jf, jnp.asarray(z), JFunnel(dim=D).log_density)
    t_loss = reverse_kl_stl_loss(tf, NealsFunnel(dim=D).log_density,
                                 torch.from_numpy(z))
    t_grads = torch.autograd.grad(t_loss, list(tf.parameters()))
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss),
                               **JAX_BAR)
    for tg, jg in zip(t_grads, jax.tree_util.tree_leaves(j_grads)):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **JAX_BAR)


def test_stl_asks_for_weight_cotangents_only_on_the_sample_path(
        monkeypatch):
    """In the STL loss the inverse (the sample path) trains the weights and
    the forward (log q) sees them detached: K7 takes its weights' pass for
    the inverse only, which is the launch count the card checks."""
    from test_torch_coupling import carry, jax_arqs_flow

    from tpuflows_torch.flows.train import reverse_kl_stl_loss
    from tpuflows_torch.targets import NealsFunnel

    seen = []
    grad = coupling_cuda.block_grad

    def spy(x2d, params, spec, gz, gladj, need_params=True):
        seen.append((spec.inverse, need_params))
        return grad(x2d, params, spec, gz, gladj, need_params)

    monkeypatch.setattr(coupling_cuda, "block_grad", spy)
    tf = carry(jax_arqs_flow(8, d=4, n_blocks=3, knots=4, hidden=(8, 8)),
               use_pallas="fused")
    z = torch.from_numpy(np.random.default_rng(80).normal(
        size=(32, 4)).astype(np.float32))
    torch.autograd.grad(reverse_kl_stl_loss(
        tf, NealsFunnel(dim=4).log_density, z), list(tf.parameters()))
    assert sorted(seen) == [(False, False)] * 3 + [(True, True)] * 3


# ---------------------------------------------------------------------------
# K7's two passes, mirrored in torch
# ---------------------------------------------------------------------------
def _act_grad(a, activation):
    if activation == "silu":
        s = 1.0 / (1.0 + torch.exp(-a))
        return s * (1.0 + a * (1.0 - s))
    if activation == "tanh":
        return 1.0 - torch.tanh(a) ** 2
    return (a > 0).to(a.dtype)


def mirror_k7(x, params, mask, gz, gladj, K, B, activation, inverse):
    """csrc/coupling_block.cu's K7 on (N, d) tensors: (dx, dparams).

    Pass 1, per row: the conditioner again (keeping each layer's input H_l
    and pre-activation), the last layer over the spline dims only (columns
    p d + idx[t]), the spline's pullback there, the cotangents G_l of each
    pre-activation walking down, and dx (the spline's on spline dims,
    gz + the conditioner input's cotangent on pass-through dims). Pass 2:
    dW_l = H_l^T G_l and db_l = sum over rows of G_l; the last layer's
    pass-through columns stay 0."""
    act = coupling_cuda._activation(activation)
    N, d = x.shape
    P = 3 * K - 1
    idx = [j for j, b in enumerate(mask) if b == 0]
    keep = [j for j, b in enumerate(mask) if b == 1]
    nt = len(idx)
    cols = torch.tensor([p * d + j for p in range(P) for j in idx],
                        dtype=torch.long)
    ws, bs = list(params[0::2]), [b.reshape(-1) for b in params[1::2]]
    b_t = torch.tensor(mask, dtype=x.dtype)
    H, pre = [x * b_t], []
    for w, b in zip(ws[:-1], bs[:-1]):
        pre.append(H[-1] @ w + b)
        H.append(act(pre[-1]))
    raw = H[-1] @ ws[-1][:, cols] + bs[-1][cols]  # (N, P nt), p-major
    raw = raw.reshape(N, P, nt).transpose(1, 2)  # (N, nt, P)
    dxs, draw = rqs_cuda.plain_grad(x[:, idx], raw, gz[:, idx],
                                    gladj[:, None].expand(N, nt), B, inverse)
    G = [None] * len(ws)
    G[-1] = draw.transpose(1, 2).reshape(N, P * nt)
    gh = G[-1] @ ws[-1][:, cols].T
    for l in range(len(ws) - 2, -1, -1):
        G[l] = gh * _act_grad(pre[l], activation)
        gh = G[l] @ ws[l].T
    dx = torch.zeros_like(x)
    dx[:, idx] = dxs
    dx[:, keep] = gz[:, keep] + gh[:, keep]
    dps = []
    for l, (h, g) in enumerate(zip(H, G)):
        dw, db = h.T @ g, g.sum(0)
        if l == len(ws) - 1:
            full_w = torch.zeros_like(ws[-1])
            full_b = torch.zeros_like(bs[-1])
            full_w[:, cols], full_b[cols] = dw, db
            dw, db = full_w, full_b
        dps += [dw, db.reshape(1, -1)]
    return dx, tuple(dps)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("activation,hidden,mask", [
    ("silu", (16, 12), "alternating"), ("tanh", (10,), "block"),
    ("relu", (), "block"), ("silu", (8,), "all-pass")])
def test_two_pass_pullback_mirror_matches_autograd(activation, hidden, mask,
                                                   inverse):
    """In float64, so that the two agree to rounding and the comparison
    tests the design, not float32."""
    d, K, n = 7, 4, 45
    m = {"alternating": alternating_mask(d, 1), "block": block_mask(d, 0),
         "all-pass": (1,) * d}[mask]
    ws, bs = leaves(11, d, hidden, K, last_scale=0.3)
    params = coupling_cuda.flatten_params(MLP(
        [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs],
        activation=activation).double(), d, K)
    params = tuple(p.detach() for p in params)
    rng = np.random.default_rng(12)
    x = torch.from_numpy(2.5 * rng.normal(size=(n, d)))
    gz = torch.from_numpy(rng.normal(size=(n, d)))
    gl = torch.from_numpy(rng.normal(size=n))
    mv = torch.tensor(m, dtype=torch.float64)
    want = coupling_cuda.plain_block_vjp(x, params, mv, gz, gl, K,
                                         DEFAULT_RANGE, activation, inverse)
    got = mirror_k7(x, params, m, gz, gl, K, DEFAULT_RANGE, activation,
                    inverse)
    torch.testing.assert_close(got[0], want[0], rtol=1e-9, atol=1e-9)
    for g, w in zip(got[1], want[1]):
        torch.testing.assert_close(g, w, rtol=1e-9, atol=1e-9)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    _, tb = pair(3, alternating_mask(6, 0))
    params = coupling_cuda.flatten_params(tb.net, 6, 4)
    spec = coupling_cuda.BlockSpec(tb.mask, 4, 4.0, "silu", False)
    x = torch.zeros(5, 6)
    with pytest.raises(ValueError, match="mask"):
        coupling_cuda.block_eval(torch.zeros(5, 7), params, spec)
    with pytest.raises(ValueError, match="columns"):
        coupling_cuda.block_eval(x, params, spec._replace(knots=5))
    with pytest.raises(ValueError, match="cotangent"):
        coupling_cuda.block_grad(x, params, spec, torch.zeros(5, 5),
                                 torch.zeros(5))
    with pytest.raises(ValueError, match="device"):
        coupling_cuda.block_eval(x.to("meta"), tuple(
            p.detach().to("meta") for p in params), spec)
    with pytest.raises(TypeError, match="float64"):
        coupling_cuda.block_eval(x.double(), params, spec)
    # gelu is plain math in the plain version, and the kernels take it
    # (and bf16); they refuse what `flows/nets.py` does not build
    coupling_cuda.block_math(x, params, torch.zeros(6), 4, 4.0, "gelu",
                             False)
    coupling_cuda.check_kernel_spec(spec._replace(activation="gelu"))
    coupling_cuda.check_kernel_spec(spec._replace(compute_dtype="bf16"))
    with pytest.raises(ValueError, match="swish"):
        coupling_cuda.check_kernel_spec(spec._replace(activation="swish"))
    with pytest.raises(ValueError, match="f16"):
        coupling_cuda.check_kernel_spec(spec._replace(compute_dtype="f16"))
    with pytest.raises(ValueError, match="swish"):
        coupling_cuda.block_math(x, params, torch.zeros(6), 4, 4.0, "swish",
                                 False)
    # what the CUDA path checks before a launch: float32 and contiguous
    with pytest.raises(TypeError, match="float32"):
        coupling_cuda._check_kernel(x.double(), params)
    with pytest.raises(ValueError, match="contiguous"):
        coupling_cuda._check_kernel(torch.zeros(6, 5).t(), params)


# ---------------------------------------------------------------------------
# the float64 repair of the K4/K5 tier on the CPU
# ---------------------------------------------------------------------------
def _dyadic(rng, shape, bits, bound):
    """Values on the grid 2^-bits within +-bound."""
    v = np.clip(rng.normal(0.0, bound / 2.5, shape), -bound, bound)
    return np.round(v * 2.0 ** bits) / 2.0 ** bits


@pytest.mark.parametrize("tier", ["auto", True])
@pytest.mark.parametrize("hidden", [(), (8,)])
def test_float64_kernel_tier_on_the_cpu_matches_jax_oracle(tier, hidden):
    """A float64 block on the CPU under "auto" or True returns float64 and
    matches the JAX oracle block in float64 to 1e-10. The JAX MLP pins its
    products to float32 (`preferred_element_type`), so the conditioner's
    leaves and the pass-through inputs lie on a dyadic grid on which every
    product and sum of the relu conditioner is exact in float32; the
    spline dims' inputs are any float64 values (the conditioner sees them
    times 0)."""
    d, K = 6, 4
    mask = alternating_mask(d, 0)
    rng = np.random.default_rng(21)
    sizes = (d, *hidden, d * (3 * K - 1))
    ws = [_dyadic(rng, (a, b), 6, 0.5 if i == 0 else 0.25)
          for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))]
    bs = [_dyadic(rng, (b,), 12 if i == 0 else 18, 0.5)
          for i, b in enumerate(sizes[1:])]
    x = 2.5 * rng.normal(size=(64, d))
    keep = np.array(mask) == 1
    x[:, keep] = _dyadic(rng, (64, int(keep.sum())), 6, 3.9)
    tb = RQSCouplingBlock(mask, MLP([torch.from_numpy(w) for w in ws],
                                    [torch.from_numpy(b) for b in bs],
                                    activation="relu"),
                          knots=K, use_pallas=tier).double()
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        jb = JRQS(mask=mask, net=JMLP(
            weights=tuple(jnp.asarray(w) for w in ws),
            biases=tuple(jnp.asarray(b) for b in bs), activation="relu"),
            knots=K, use_pallas=False)
        for inverse in (False, True):
            with torch.no_grad():
                f = tb.inverse_and_ladj if inverse else tb.forward_and_ladj
                z, ladj = f(torch.from_numpy(x))
            jz, jl = _jrun(jb, x, inverse)
            assert z.dtype == ladj.dtype == torch.float64
            assert jz.dtype == np.float64
            np.testing.assert_allclose(z.numpy(), jz, rtol=0, atol=1e-10)
            np.testing.assert_allclose(ladj.numpy(), jl, rtol=0, atol=1e-10)
    finally:
        jax.config.update("jax_enable_x64", prev)


def test_spline_kernel_wrappers_take_any_float_on_the_cpu_only():
    """`spline_eval` / `spline_grad` run the plain version in the input's
    dtype on the CPU; the launch path still takes float32 only."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(3.0 * rng.normal(size=(9, 4)))
    raw = torch.from_numpy(rng.normal(size=(9, 4, 11)))
    y, ladj = rqs_cuda.spline_eval(x, raw)
    dx, draw = rqs_cuda.spline_grad(x, raw, torch.ones_like(x),
                                    torch.ones_like(x))
    assert {t.dtype for t in (y, ladj, dx, draw)} == {torch.float64}
    y32, _ = rqs_cuda.spline_eval(x.float(), raw.float())
    np.testing.assert_allclose(y.numpy(), y32.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(TypeError, match="float32"):
        rqs_cuda._check_kernel("K4", x, raw)
