"""K3, the fused latent log density and gradient
(`tpuflows_torch.kernels.fused_logp_cuda`), on the CPU, where the wrapper
runs its plain version (`nuts_cuda.plain_logp_grad`).

  * against the JAX package's K3, `fused_latent_logp_and_grad(...,
    tile_b=16, interpret=True)`: the Pallas kernel in interpret mode, at
    the small affine shape of tests/test_pallas.py (d = 8, 48 rows,
    hidden 16 x 16, leading mask, clamp 8) and with random non-zero heads;
    atol 1e-4 (the JAX test's bar for its kernel against its oracle);
  * on arqs flows (Standardize + 2-3 x (affine + spline), mixed masks,
    non-zero heads) against `jax.vmap(jax.value_and_grad(
    flow_reparameterized(...)))`, 1e-4 relative and absolute (|g| reaches
    ~3e3 there, and a gradient pulled back through the spline pullbacks
    in another order differs by up to ~2e-6 relative). Float32 resolves
    these cases to that bar (a float64 referee, as the spline kernels'
    tests need, is not called for);
  * K3's CUDA math is K1's `chain_logp_grad` (`csrc/latent_grad.cuh`):
    its torch mirror `kernel_chain_logp_grad` in
    tests/test_torch_nuts_spline.py agrees with the plain version here;
  * the CPU wrapper counts no launch; it rejects another target, another
    dtype, a wrong shape and a tensor on another device;
  * the port of tests/test_pallas.py's driver test: `NUTSDriver(logp,
    logp_and_grad=K3)` gives the draws of `NUTSDriver(logp)`, bit for bit
    on the CPU (there both are autograd through the same flow). K3 takes
    3-layer MLPs, so the flow has hidden widths 16 x 16 where the JAX test
    has one layer of 16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows.flows import build_flow as j_build_flow
from tpuflows.kernels.fused_logp import (
    fused_latent_logp_and_grad as j_fused)
from tpuflows.mcmc.preconditioned import flow_reparameterized as j_reparam
from tpuflows.targets import NealsFunnel as JFunnel

from tpuflows_torch.convert import flow_from_jax_params
from tpuflows_torch.flows import build_flow
from tpuflows_torch.kernels import fused_logp_cuda, nuts_cuda
from tpuflows_torch.kernels.fused_logp_cuda import fused_latent_logp_and_grad
from tpuflows_torch.mcmc import NUTSDriver, flow_reparameterized
from tpuflows_torch.targets import NealsFunnel
from tpuflows_torch.targets.base import Target

from test_torch_coupling import carry, jax_arqs_flow
from test_torch_nuts import flow_leaves, jax_flow, torch_flow
from test_torch_nuts_spline import kernel_chain_logp_grad


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small ops: one intra-op thread per test worker keeps parallel
    workers from oversubscribing the cores (under the suite's 6 workers
    this file's `NUTSDriver` runs took up to 20x their time alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _z(seed, n, d, scale=0.8):
    rng = np.random.default_rng(seed)
    return (scale * rng.normal(size=(n, d))).astype(np.float32)


def _k3(jf, tf, d, z):
    """(port, JAX interpret-mode kernel) outputs on the same rows."""
    lp, g = fused_latent_logp_and_grad(NealsFunnel(dim=d), tf)(
        torch.from_numpy(z))
    fused = j_fused(JFunnel(dim=d).log_density, jf, tile_b=16,
                    interpret=True)
    jlp, jg = jax.vmap(fused)(jnp.asarray(z))
    return (lp.numpy(), g.numpy()), (np.asarray(jlp), np.asarray(jg))


def test_matches_jax_k3_in_interpret_mode_at_the_jax_tests_shape():
    dim = 8
    init = jax.random.normal(jax.random.key(1), (64, dim), jnp.float32)
    jf = j_build_flow(init, jax.random.key(2), kind="affine", n_blocks=1,
                      hidden=(16, 16), mask_scheme="leading", clamp=8.0)
    std, cp = jf.transforms
    tf = flow_from_jax_params(
        np.asarray(std.loc), np.asarray(std.log_scale),
        [np.asarray(w) for w in cp.net.weights],
        [np.asarray(b) for b in cp.net.biases], cp.mask, cp.clamp,
        device="cpu")
    z = 0.8 * np.asarray(jax.random.normal(jax.random.key(4), (48, dim),
                                           jnp.float32))
    (lp, g), (jlp, jg) = _k3(jf, tf, dim, z)
    assert lp.shape == (48,) and g.shape == (48, dim)
    np.testing.assert_allclose(lp, jlp, rtol=0, atol=1e-4)
    np.testing.assert_allclose(g, jg, rtol=0, atol=1e-4)


@pytest.mark.parametrize("seed,random_mask", [(0, False), (1, True),
                                              (2, True)])
def test_matches_jax_k3_in_interpret_mode_with_random_heads(seed,
                                                            random_mask):
    d = 8
    mask = None
    if random_mask:
        mask = tuple(int(m) for m in
                     np.random.default_rng(seed).integers(0, 2, d))
    jf = jax_flow(flow_leaves(seed, mask=mask))
    tf = torch_flow(jf)
    (lp, g), (jlp, jg) = _k3(jf, tf, d, _z(seed, 37, d))  # ragged: 37 rows
    np.testing.assert_allclose(lp, jlp, rtol=0, atol=1e-4)
    np.testing.assert_allclose(g, jg, rtol=0, atol=1e-4)
    assert np.abs(g).max() > 1.0  # the MLP path carries weight


def _jax_value_and_grad(jf, d, z):
    logp = j_reparam(JFunnel(dim=d).log_density, jf)
    lp, g = jax.vmap(jax.value_and_grad(logp))(jnp.asarray(z))
    return np.asarray(lp), np.asarray(g)


@pytest.mark.parametrize("seed,n_blocks,knots", [(0, 2, 4), (1, 3, 8),
                                                 (2, 2, 6)])
def test_matches_jax_value_and_grad_on_arqs_flows(seed, n_blocks, knots):
    d = 8
    jf = jax_arqs_flow(seed, d=d, n_blocks=n_blocks, knots=knots)
    tf = carry(jf, use_pallas="auto")
    z = _z(10 + seed, 64, d, scale=1.0)
    lp, g = fused_latent_logp_and_grad(NealsFunnel(dim=d), tf)(
        torch.from_numpy(z))
    lp, g = lp.numpy(), g.numpy()
    jlp, jg = _jax_value_and_grad(jf, d, z)
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lp, jlp, **tol)
    np.testing.assert_allclose(g, jg, **tol)


def test_plain_version_matches_the_kernels_torch_mirror():
    """K3's device code is K1's `chain_logp_grad`; its torch mirror
    (tests/test_torch_nuts_spline.py) agrees with K3's plain version."""
    jf = jax_arqs_flow(3, d=8, n_blocks=2, knots=4)
    tf = carry(jf, use_pallas="auto")
    hook = fused_latent_logp_and_grad(NealsFunnel(dim=8), tf)
    z = torch.from_numpy(_z(3, 64, 8))
    lp, g = hook(z)
    mlp, mg = kernel_chain_logp_grad(hook.model)(z)
    torch.testing.assert_close(mlp[:, 0], lp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(mg, g, rtol=1e-4, atol=1e-4)


def test_cpu_wrapper_runs_the_plain_version_and_counts_no_launch():
    tf = torch_flow(jax_flow(flow_leaves(4)))
    hook = fused_latent_logp_and_grad(NealsFunnel(dim=8), tf)
    fused_logp_cuda.reset_launches()
    z = torch.from_numpy(_z(4, 16, 8))
    lp, g = hook(z)
    plain_lp, plain_g = nuts_cuda.plain_logp_grad(hook.model)(z)
    assert torch.equal(lp, plain_lp[:, 0]) and torch.equal(g, plain_g)
    assert fused_logp_cuda.LAUNCHES == 0


class _OtherTarget(Target):
    dim = 8

    def log_density(self, x):
        return -0.5 * (x * x).sum(-1)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    tf = torch_flow(jax_flow(flow_leaves(5)))
    with pytest.raises(ValueError, match="NealsFunnel"):
        fused_latent_logp_and_grad(_OtherTarget(), tf)
    with pytest.raises(ValueError, match="NealsFunnel"):
        fused_latent_logp_and_grad(NealsFunnel(dim=6), tf)
    hook = fused_latent_logp_and_grad(NealsFunnel(dim=8), tf)
    z = torch.from_numpy(_z(5, 4, 8))
    with pytest.raises(TypeError, match="float32"):
        hook(z.double())
    for bad in (z[:, :7], z[0], z[None]):
        with pytest.raises(ValueError, match="must be"):
            hook(bad)
    with pytest.raises(ValueError, match="is on"):
        hook(torch.empty((4, 8), device="meta"))


def test_driver_with_k3_gives_the_draws_of_the_autograd_driver():
    dim = 4
    target = NealsFunnel(dim=dim)
    g = torch.Generator().manual_seed(1)
    flow = build_flow(torch.randn(128, dim, generator=g), g, kind="affine",
                      n_blocks=1, hidden=(16, 16), mask_scheme="leading",
                      clamp=8.0, device="cpu")
    fused = fused_latent_logp_and_grad(target, flow)
    # the autograd NUTSDriver differentiates the density K3's plain version
    # reads: the target from its packed buffer
    logp = flow_reparameterized(
        lambda x: nuts_cuda.packed_log_density(fused.model.packed_target,
                                               x), flow)
    q0 = torch.randn(64, dim, generator=torch.Generator().manual_seed(3))
    d_ref = NUTSDriver(logp, max_depth=5)
    d_fus = NUTSDriver(logp, max_depth=5, logp_and_grad=fused)
    st_r = d_ref.warmup(torch.Generator().manual_seed(5), q0, 64)
    st_f = d_fus.warmup(torch.Generator().manual_seed(5), q0, 64)
    _, z_r, _ = d_ref.draws(torch.Generator().manual_seed(6), st_r, 64)
    _, z_f, _ = d_fus.draws(torch.Generator().manual_seed(6), st_f, 64)
    assert torch.equal(z_f, z_r)
    assert d_fus.transition.grad_calls >= 128 * 2
