"""What the kernel tiers take and what they refuse:

  * K1, K2 and K3 (`pack_flow`, through `FusedNUTS`, `FusedNUTSWindow` and
    `FusedLatentLogpAndGrad`) take a bf16 or gelu conditioner and a
    Whiten, as the JAX package's in-kernel flow math does (their plain
    versions then match the JAX package's fused math: K1 within 1e-4,
    K3 within rtol 1e-5 / atol 1e-4, bf16 1e-4 / 1e-3), and raise
    ValueError, naming the module, for Identity and ScannedRepeat, in a
    Chain or as the flow itself, which that math refuses too;
  * K6/K7's kernel path (`check_kernel_spec`, which `_launch_eval` and
    `_launch_grad` call before anything else) takes a gelu or bf16
    conditioner, and the plain block's pullback (the kernels' plain
    version) matches the JAX package's block math under `jax.vjp`;
  * the plain coupling block (the fused tier on the CPU) computes a gelu
    conditioner and bf16 operands as the JAX package's block math does
    (`coupling_pallas._block_math`, plain jnp): gelu to rtol 1e-5 / atol
    1e-5, bf16 to 1e-3 (its operands round alike, its sums run in
    another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows import targets as J
from tpuflows.flows.affine import AffineCoupling as JAffine
from tpuflows.flows.affine import Standardize as JStandardize
from tpuflows.flows.affine import Whiten as JWhiten
from tpuflows.flows.core import Chain as JChain
from tpuflows.flows.nets import MLP as JMLP
from tpuflows.kernels.coupling_pallas import _block_math as j_block_math
from tpuflows.kernels.fused_logp import (
    fused_latent_logp_and_grad as j_fused_logp)

from tpuflows_torch.flows import (AffineCoupling, Chain, Identity, MLP,
                                  RQSCouplingBlock, ScannedRepeat,
                                  Standardize, Whiten)
from tpuflows_torch.flows.rqs_ref import (DEFAULT_MIN_BIN,
                                          DEFAULT_MIN_DERIV)
from tpuflows_torch.kernels import coupling_cuda, fused_logp_cuda, nuts_cuda
from tpuflows_torch.kernels import nuts_window_cuda
from tpuflows_torch.targets import NealsFunnel
from tpuflows_torch.util.shapes import leading_mask

D = 32


def affine(activation="silu", compute_dtype="f32", hidden=(32, 32)):
    net = MLP.init((D, *hidden, 2 * D), torch.Generator().manual_seed(1),
                   activation=activation, final_zero=False,
                   compute_dtype=compute_dtype)
    return AffineCoupling(leading_mask(D), net, clamp=8.0)


def standardize():
    return Standardize.identity(D, device="cpu")


def flow_of(case):
    """(flow, what a refusal names)."""
    if case == "bf16":
        return Chain([standardize(), affine(compute_dtype="bf16")]), "bf16"
    if case == "gelu":
        return Chain([standardize(), affine("gelu")]), "gelu"
    if case == "whiten":
        w = Whiten(torch.zeros(D), torch.eye(D), torch.eye(D))
        return Chain([w, affine()]), "Whiten"
    if case == "identity":
        return Chain([standardize(), Identity(), affine()]), "Identity"
    if case == "scanned":
        rep = ScannedRepeat.from_blocks([affine(), affine()])
        return Chain([standardize(), rep]), "ScannedRepeat"
    if case == "scanned_alone":
        return ScannedRepeat.from_blocks([affine(), affine()]), \
            "ScannedRepeat"
    raise ValueError(case)


CASES = ["bf16", "gelu", "whiten", "identity", "scanned", "scanned_alone"]
# the cases the kernels take, as the JAX package's in-kernel flow math does
TAKEN = ("bf16", "gelu", "whiten")
WRAPPERS = {
    "K1": lambda t, f: nuts_cuda.fused_nuts_for_flow(t, f, max_depth=4),
    "K2": lambda t, f: nuts_window_cuda.fused_nuts_window_for_flow(
        t, f, window=4, max_depth=4),
    "K3": lambda t, f: fused_logp_cuda.fused_latent_logp_and_grad(t, f),
}


def jax_of(flow):
    """The JAX package's Chain with the port flow's leaves."""
    mods = []
    for t in flow.transforms:
        if isinstance(t, Standardize):
            mods.append(JStandardize(loc=jnp.asarray(t.loc.detach()),
                                     log_scale=jnp.asarray(
                                         t.log_scale.detach())))
        elif isinstance(t, Whiten):
            mods.append(JWhiten(loc=jnp.asarray(t.loc.detach()),
                                inv_chol=jnp.asarray(t.inv_chol.detach()),
                                chol=jnp.asarray(t.chol.detach())))
        else:
            net = JMLP(weights=tuple(jnp.asarray(w.detach())
                                     for w in t.net.weights),
                       biases=tuple(jnp.asarray(b.detach())
                                    for b in t.net.biases),
                       activation=t.net.activation,
                       compute_dtype=t.net.compute_dtype)
            mods.append(JAffine(mask=t.mask, net=net, clamp=t.clamp))
    return JChain(transforms=tuple(mods))


def taken_flow(case):
    """The case's flow with a Whiten fitted from correlated draws (a
    non-trivial chol) and a leading half of pass-through dims."""
    flow, _ = flow_of(case)
    if case == "whiten":
        g = torch.Generator().manual_seed(3)
        a = torch.eye(D) + 0.2 * torch.randn((D, D), generator=g) / D ** 0.5
        draws = torch.randn((512, D), generator=g) @ a.T
        flow = Chain([Whiten.from_samples(draws), affine()])
    return flow


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_nuts_kernels_refuse_unported_modules(kernel, case):
    """Identity and ScannedRepeat are refused, naming the module and that
    the JAX package's in-kernel math refuses them too; a bf16 or gelu
    conditioner and a Whiten are taken (since the kernels compute them),
    and the wrapper's plain version matches the JAX package's: its packed
    flow's latent log density and gradient (K3's plain version, which K1
    and K2 call) against `fused_latent_logp_and_grad` in interpret mode."""
    if case not in TAKEN:
        flow, name = flow_of(case)
        with pytest.raises(ValueError, match=name) as err:
            WRAPPERS[kernel](NealsFunnel(D), flow)
        assert "does not take either" in str(err.value)
        return
    flow = taken_flow(case)
    made = WRAPPERS[kernel](NealsFunnel(D), flow)
    model = made.model
    assert model.general and model.flow is flow
    z = np.random.default_rng(5).normal(size=(16, D)).astype(np.float32)
    lp, g = nuts_cuda.plain_logp_grad(model)(torch.from_numpy(z))
    jt = J.NealsFunnel(dim=D)
    jlp, jg = jax.vmap(j_fused_logp(jt.log_density, jax_of(flow), tile_b=8,
                                    interpret=True))(jnp.asarray(z))
    tol = (dict(rtol=1e-4, atol=1e-3) if case == "bf16"
           else dict(rtol=1e-5, atol=1e-4))
    np.testing.assert_allclose(lp[:, 0].numpy(), np.asarray(jlp), **tol)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **tol)


def test_nuts_kernels_still_take_the_silu_flow():
    flow = Chain([standardize(), affine()])
    for make in WRAPPERS.values():
        assert not make(NealsFunnel(D), flow).model.general
    # a tanh conditioner: float32, taken by K1, K2 and K3 too
    tanh = Chain([standardize(), affine("tanh")])
    for make in WRAPPERS.values():
        model = make(NealsFunnel(D), tanh).model
        assert model.general and model.forms[1, :2].tolist() == [3, 1]


def block_inputs(activation, compute_dtype, seed=0, d=6, K=4):
    rng = np.random.default_rng(seed)
    sizes = (d, 16, d * (3 * K - 1))
    ws = [(rng.normal(0, np.sqrt(2.0 / a), (a, b)) * (0.3 if i else 1.0))
          .astype(np.float32) for i, (a, b) in enumerate(zip(sizes[:-1],
                                                            sizes[1:]))]
    bs = [rng.normal(0, 0.1, b).astype(np.float32) for b in sizes[1:]]
    net = MLP(ws, bs, activation=activation, compute_dtype=compute_dtype)
    mask = (1, 0) * (d // 2)
    x = (1.5 * rng.normal(size=(40, d))).astype(np.float32)
    return net, mask, x


@pytest.mark.parametrize("activation,compute_dtype",
                         [("gelu", "f32"), ("silu", "bf16"),
                          ("gelu", "bf16")])
def test_coupling_kernel_path_refuses_gelu_and_bf16(activation,
                                                    compute_dtype):
    """K6/K7's kernel path takes gelu and bf16 (`check_kernel_spec`
    passes, a bf16 conditioner's weights go to the kernels rounded), the
    earlier kernels, a yardstick only, still refuse them, and the plain
    block's pullback (the kernels' plain version) matches the JAX
    package's block math under `jax.vjp`: gelu to rtol 1e-5 / atol 1e-5,
    bf16 to 1e-3 (sums in another order can round an operand apart)."""
    net, mask, x = block_inputs(activation, compute_dtype)
    spec = coupling_cuda.BlockSpec(mask, 4, 4.0, activation, False,
                                   compute_dtype)
    params = coupling_cuda.flatten_params(net, 6, 4)
    coupling_cuda._check(torch.from_numpy(x), params, spec)
    coupling_cuda.check_kernel_spec(spec)
    rounded = coupling_cuda.kernel_params(params, spec)
    for i, (p, r) in enumerate(zip(params, rounded)):
        want = p.bfloat16().float() if i % 2 == 0 and \
            compute_dtype == "bf16" else p
        assert torch.equal(r, want)
    with pytest.raises(ValueError, match="float32 silu, tanh or relu"):
        coupling_cuda._earlier_check(torch.from_numpy(x), params, spec)
    rng = np.random.default_rng(1)
    gz = rng.normal(size=x.shape).astype(np.float32)
    gl = rng.normal(size=x.shape[0]).astype(np.float32)
    m = torch.tensor(mask, dtype=torch.float32)
    dx, dps = coupling_cuda.plain_block_vjp(
        torch.from_numpy(x), tuple(p.detach() for p in params), m,
        torch.from_numpy(gz), torch.from_numpy(gl), 4, 4.0, activation,
        False, compute_dtype)
    jparams = [jnp.asarray(p.detach().numpy()) for p in params]
    jmask = jnp.asarray(np.array(mask, np.float32))[None]
    _, pull = jax.vjp(lambda xx, ps: j_block_math(
        xx, ps, jmask, 4, 4.0, DEFAULT_MIN_BIN, DEFAULT_MIN_DERIV,
        activation, False, compute_dtype=compute_dtype),
        jnp.asarray(x), jparams)
    jdx, jdps = pull((jnp.asarray(gz), jnp.asarray(gl)[:, None]))
    tol = 1e-5 if compute_dtype == "f32" else 1e-3
    for got, want in ((dx, jdx), *zip(dps, jdps)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy().reshape(want.shape), want,
                                   rtol=tol,
                                   atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("activation,compute_dtype,tol",
                         [("gelu", "f32", 1e-5), ("silu", "bf16", 1e-3),
                          ("gelu", "bf16", 1e-3)])
def test_plain_block_computes_gelu_and_bf16_as_jax(activation,
                                                   compute_dtype, tol,
                                                   inverse):
    net, mask, x = block_inputs(activation, compute_dtype, seed=3)
    block = RQSCouplingBlock(mask, net, knots=4, use_pallas="fused")
    z, ladj = (block.inverse_and_ladj if inverse
               else block.forward_and_ladj)(torch.from_numpy(x))
    params = [jnp.asarray(p.detach().numpy())
              for p in coupling_cuda.flatten_params(net, 6, 4)]
    jz, jl = j_block_math(jnp.asarray(x), params,
                          jnp.asarray(np.array(mask, np.float32))[None],
                          4, 4.0, DEFAULT_MIN_BIN, DEFAULT_MIN_DERIV,
                          activation, inverse, compute_dtype=compute_dtype)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(jz),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(ladj.detach().numpy(),
                               np.asarray(jl)[:, 0], rtol=tol, atol=tol)
    # the fused tier's plain block equals the conditioner-in-torch tier
    zo, lo = (RQSCouplingBlock(mask, net, knots=4, use_pallas=False)
              .inverse_and_ladj if inverse else
              RQSCouplingBlock(mask, net, knots=4, use_pallas=False)
              .forward_and_ladj)(torch.from_numpy(x))
    torch.testing.assert_close(z, zo, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ladj, lo, rtol=1e-4, atol=1e-4)
