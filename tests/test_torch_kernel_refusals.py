"""The kernel tiers refuse what they do not compute (gelu and bf16 on the
kernels are ROADMAP Queue 2 item B), and the plain versions compute it:

  * K1, K2 and K3 (`pack_flow`, through `FusedNUTS`, `FusedNUTSWindow` and
    `FusedLatentLogpAndGrad`) raise ValueError, naming the module or the
    conditioner, for a bf16 or gelu conditioner, Whiten, Identity and
    ScannedRepeat, in a Chain or as the flow itself;
  * K6/K7's kernel path (`check_kernel_spec`, which `_launch_eval`,
    `_launch_grad` and the earlier kernels call before anything else)
    raises ValueError, not KeyError, for a gelu or bf16 conditioner, so a
    flow that asks for bf16 never runs in float32 on a kernel;
  * the plain coupling block (the fused tier on the CPU) computes a gelu
    conditioner and bf16 operands as the JAX package's block math does
    (`coupling_pallas._block_math`, plain jnp): gelu to rtol 1e-5 / atol
    1e-5, bf16 to 1e-3 (its operands round alike, its sums run in
    another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows.kernels.coupling_pallas import _block_math as j_block_math

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
    """(flow, what the refusal must name)."""
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
WRAPPERS = {
    "K1": lambda t, f: nuts_cuda.fused_nuts_for_flow(t, f, max_depth=4),
    "K2": lambda t, f: nuts_window_cuda.fused_nuts_window_for_flow(
        t, f, window=4, max_depth=4),
    "K3": lambda t, f: fused_logp_cuda.fused_latent_logp_and_grad(t, f),
}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_nuts_kernels_refuse_unported_modules(kernel, case):
    flow, name = flow_of(case)
    with pytest.raises(ValueError, match=name) as err:
        WRAPPERS[kernel](NealsFunnel(D), flow)
    assert "Queue 2 item B" in str(err.value)


def test_nuts_kernels_still_take_the_silu_flow():
    flow = Chain([standardize(), affine()])
    for make in WRAPPERS.values():
        make(NealsFunnel(D), flow)
    # a tanh conditioner is float32 and ported, but not on K1
    with pytest.raises(ValueError, match="3-layer silu"):
        nuts_cuda.pack_flow(Chain([standardize(), affine("tanh")]),
                            NealsFunnel(D))


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
    net, mask, x = block_inputs(activation, compute_dtype)
    spec = coupling_cuda.BlockSpec(mask, 4, 4.0, activation, False,
                                   compute_dtype)
    params = coupling_cuda.flatten_params(net, 6, 4)
    widths = coupling_cuda._check(torch.from_numpy(x), params, spec)
    match = "gelu" if activation == "gelu" else "bf16"
    for call in (
            lambda: coupling_cuda.check_kernel_spec(spec),
            lambda: coupling_cuda._launch_eval(torch.from_numpy(x), params,
                                               spec, widths),
            lambda: coupling_cuda._launch_grad(
                torch.from_numpy(x), params, spec, widths,
                torch.zeros(40, 6), torch.zeros(40), True)):
        with pytest.raises(ValueError, match=match) as err:
            call()
        assert "Queue 2 item B" in str(err.value)


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
