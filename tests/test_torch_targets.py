"""Neal's funnel and the latent gradient of the flow-preconditioned density.

The funnel's log density and its autograd gradient against the JAX
package (to 1e-5 relative), and the hand-written gradient formulas of K1
(`csrc/latent_grad.cuh`, `logp_grad`) as a plain-torch mirror of the
kernel's arithmetic, line by line, against torch.autograd (to 1e-5): a
formula error shows here before the card ever runs the kernel.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows.targets import NealsFunnel as JFunnel
from tpuflows.targets.base import std_normal_logpdf as j_std_normal_logpdf

from tpuflows_torch.flows import AffineCoupling, Chain, MLP, Standardize
from tpuflows_torch.kernels.nuts_cuda import autograd_logp_grad
from tpuflows_torch.targets import NealsFunnel, std_normal_logpdf

TOL = dict(rtol=1e-5, atol=1e-5)


def _x(seed, n, d, v_scale=2.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:, 0] *= v_scale
    return x


@pytest.mark.parametrize("dim,sigma_v", [(2, 1.0), (8, 3.0), (64, 3.0),
                                         (16, 2.0)])
def test_funnel_log_density_matches_jax(dim, sigma_v):
    x = _x(dim, 32, dim)
    want = np.asarray(JFunnel(dim=dim, sigma_v=sigma_v).log_density(
        jnp.asarray(x)))
    got = NealsFunnel(dim=dim, sigma_v=sigma_v).log_density(
        torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("dim,sigma_v", [(2, 1.0), (8, 3.0), (64, 3.0)])
def test_funnel_gradient_matches_jax(dim, sigma_v):
    x = _x(dim + 1, 32, dim)
    jt = JFunnel(dim=dim, sigma_v=sigma_v)
    want = np.asarray(jax.grad(lambda y: jnp.sum(jt.log_density(y)))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    NealsFunnel(dim=dim, sigma_v=sigma_v).log_density(xt).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, **TOL)


def test_funnel_moments_match_jax():
    jt, t = JFunnel(dim=8), NealsFunnel(dim=8)
    np.testing.assert_allclose(t.mean("cpu").numpy(), np.asarray(jt.mean()))
    np.testing.assert_allclose(t.cov("cpu").numpy(), np.asarray(jt.cov()),
                               rtol=1e-6)
    g = torch.Generator().manual_seed(0)
    s = t.sample(g, 20000, device="cpu")
    assert s.shape == (20000, 8)
    # v ~ N(0, 9): 5-sigma bounds on its mean and variance
    v = s[:, 0].double()
    assert abs(float(v.mean())) < 5 * 3.0 / math.sqrt(20000)
    assert abs(float(v.var()) - 9.0) < 5 * 9.0 * math.sqrt(2.0 / 20000)


def test_std_normal_logpdf_matches_jax():
    x = _x(5, 16, 6)
    np.testing.assert_allclose(
        std_normal_logpdf(torch.from_numpy(x)).numpy(),
        np.asarray(j_std_normal_logpdf(jnp.asarray(x))), **TOL)


def kernel_logp_grad(flow, target):
    """The arithmetic of the kernel's `logp_grad`, written out with the
    same formulas and in the same order, batched over rows. No autograd."""
    std, cp = flow.transforms
    w1, w2, w3 = (w.detach() for w in cp.net.weights)
    b1, b2, b3 = (b.detach() for b in cp.net.biases)
    loc, log_scale = std.loc.detach(), std.log_scale.detach()
    m = cp.mask_f
    c, sv, d = cp.clamp, target.sigma_v, target.dim

    def fn(z):
        xin = z * m
        a1 = xin @ w1 + b1
        v1 = a1 * torch.sigmoid(a1)
        a2 = v1 @ w2 + b2
        v2 = a2 * torch.sigmoid(a2)
        out = v2 @ w3 + b3
        shift, raw = out[:, :d], out[:, d:]
        th = torch.tanh(raw / c)
        s = c * th
        e = torch.exp(-s)
        yt = (z - shift) * e
        y = m * z + (1.0 - m) * yt
        sc = torch.exp(log_scale)
        x = y * sc + loc
        ladj = torch.sum(log_scale - (1.0 - m) * s, dim=-1)
        sq = torch.sum(x[:, 1:] * x[:, 1:], dim=-1)
        v = x[:, 0]
        k = float(d - 1)
        env = torch.exp(-v)
        vs = v / sv
        log2pi = math.log(2.0 * math.pi)
        lp_v = -0.5 * vs * vs - math.log(sv) - 0.5 * log2pi
        lp_rest = -0.5 * sq * env - 0.5 * k * v - 0.5 * k * log2pi
        lp = lp_v + lp_rest + ladj
        gv = -v / (sv * sv) + 0.5 * sq * env - 0.5 * k
        gx = -x * env[:, None]
        gx[:, 0] = gv
        gy = gx * sc
        om = 1.0 - m
        gout = torch.cat([-om * gy * e,
                          -om * (gy * yt + 1.0) * (1.0 - th * th)], dim=-1)
        g = gy * (m + om * e)
        sg2 = torch.sigmoid(a2)
        g2 = (gout @ w3.t()) * sg2 * (1.0 + a2 * (1.0 - sg2))
        sg1 = torch.sigmoid(a1)
        g1 = (g2 @ w2.t()) * sg1 * (1.0 + a1 * (1.0 - sg1))
        g = g + m * (g1 @ w1.t())
        return lp[:, None], g

    return fn


def _random_flow(seed, d, hidden, mask):
    g = torch.Generator().manual_seed(seed)
    sizes = (d, *hidden, 2 * d)
    ws = [torch.randn(a, b, generator=g) * math.sqrt(2.0 / a)
          for a, b in zip(sizes[:-1], sizes[1:])]
    ws[-1] = ws[-1] * 0.3  # non-zero last layer
    bs = [0.1 * torch.randn(b, generator=g) for b in sizes[1:]]
    std = Standardize(0.3 * torch.randn(d, generator=g),
                      0.2 * torch.randn(d, generator=g))
    return Chain([std, AffineCoupling(mask, MLP(ws, bs), clamp=8.0)])


@pytest.mark.parametrize("seed,d,hidden,mask_kind", [
    (0, 8, (16, 16), "leading"), (1, 8, (16, 32), "random"),
    (2, 64, (128, 128), "leading"), (3, 32, (32, 64), "random"),
    (4, 64, (128, 128), "random")])
def test_hand_written_gradient_matches_autograd(seed, d, hidden, mask_kind):
    if mask_kind == "leading":
        mask = tuple(1 if j == 0 else 0 for j in range(d))
    else:
        mask = tuple(int(b) for b in
                     np.random.default_rng(seed).integers(0, 2, d))
    flow = _random_flow(seed, d, hidden, mask)
    target = NealsFunnel(dim=d)
    z = torch.from_numpy(_x(seed, 64, d, v_scale=1.0))
    lp_a, g_a = autograd_logp_grad(flow, target.log_density)(z)
    lp_k, g_k = kernel_logp_grad(flow, target)(z)
    torch.testing.assert_close(lp_k, lp_a, **TOL)
    torch.testing.assert_close(g_k, g_a, **TOL)
