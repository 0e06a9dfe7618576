"""The evidence estimators of the port (`tpuflows_torch.integration`)
against the JAX package's (`tpuflows.integration`), on the CPU:

  * on the same inputs and the JAX estimators' own base draws (replayed
    into `_is_math` and `_bridge_math`), through an affine flow fitted by
    the JAX package and carried across: every log Z and weight ESS within
    1e-5 (relative, and absolute for log Z near 0), at d = 2 and d = 16,
    on a normalized target and on one scaled by a constant;
  * the port's own estimators with the port's own fits, on the JAX
    package's checks (`tests/test_ensemble_evidence.py`): a normalized
    target has log Z = 0 (IS and bridge within 0.05, the harmonic mean
    within 0.1, the IS weight ESS above half of n), a target scaled by c
    has log Z = log c, and at d = 16 IS and bridge recover log c within
    0.05 with a weight ESS above 0.2 n.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpuflows.flows import build_flow as j_build_flow
from tpuflows.flows import optimize_flow as j_fit
from tpuflows.integration import log_evidence_bridge as j_bridge
from tpuflows.integration import log_evidence_harmonic as j_harmonic
from tpuflows.integration import log_evidence_is as j_is
from tpuflows.targets import DiagNormal as JDiagNormal

from tpuflows_torch.flows import Adam, build_flow, optimize_flow
from tpuflows_torch.integration import (EvidenceResult, log_evidence_bridge,
                                        log_evidence_harmonic,
                                        log_evidence_is)
from tpuflows_torch.integration.evidence import _bridge_math, _is_math
from tpuflows_torch.targets import DiagNormal
from tpuflows_torch.vi import fit_vi, vi_sample

from test_torch_coupling import carry

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(a):
    return torch.from_numpy(np.array(a))


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


def scale_of(dim):
    return np.exp(0.4 * np.sin(np.arange(dim))).astype(np.float32)


@pytest.fixture(scope="module", params=[2, 16])
def problem(request):
    """An anisotropic Gaussian in both packages and a JAX affine flow fitted
    to its draws (30 epochs: a real, imperfect fit), carried across."""
    dim = request.param
    loc, scale = 0.3 * np.ones(dim, np.float32), scale_of(dim)
    jt = JDiagNormal(loc=jnp.asarray(loc), scale=jnp.asarray(scale))
    draws = jt.sample(jax.random.key(20), 4096)
    jf = j_build_flow(draws, jax.random.key(21), kind="affine", n_blocks=2,
                      hidden=(32,))
    jf = j_fit(jax.random.key(22), draws, jf, optax.adam(5e-3), nbatches=8,
               nepochs=30).result
    tt = DiagNormal(loc=torch.from_numpy(loc), scale=torch.from_numpy(scale))
    return dim, jt, tt, jf, carry(jf)


@pytest.mark.parametrize("log_c", [0.0, -2.4])
def test_is_and_bridge_and_harmonic_match_jax(problem, log_c):
    dim, jt, tt, jf, tf = problem

    def jl(x):
        return jt.log_density(x) + log_c

    def tl(x):
        return tt.log_density(x) + log_c

    key = jax.random.key(23)
    want = j_is(key, jl, jf, dim, n=4096)
    got = _is_math(t(jax.random.normal(key, (4096, dim), jnp.float32)), tl,
                   tf)
    assert isinstance(got, EvidenceResult) and got.n == want.n
    close(got.log_z, want.log_z)
    close(got.ess, want.ess)

    post = jt.sample(jax.random.key(24), 2048)
    key = jax.random.key(25)
    want = j_bridge(key, jl, jf, post, n_proposal=4096)
    z = jax.random.normal(key, (4096, dim), jnp.float32)
    got = _bridge_math(t(z), tl, tf, t(post))
    assert got.n == want.n
    close(got.log_z, want.log_z)
    close(got.ess, want.ess)

    close(log_evidence_harmonic(tl, tf, t(post)), j_harmonic(jl, jf, post))


def test_the_draws_come_from_the_generator(problem):
    dim, _, tt, _, tf = problem
    a = log_evidence_is(torch.Generator().manual_seed(1), tt.log_density,
                        tf, dim, n=512)
    b = _is_math(torch.randn((512, dim),
                             generator=torch.Generator().manual_seed(1)),
                 tt.log_density, tf)
    assert torch.equal(a.log_z, b.log_z) and a.n == 512
    post = tt.sample(torch.Generator().manual_seed(2), 256, device="cpu")
    a = log_evidence_bridge(torch.Generator().manual_seed(3),
                            tt.log_density, tf, post, n_proposal=512,
                            n_iter=4)
    b = _bridge_math(torch.randn((512, dim),
                                 generator=torch.Generator().manual_seed(3)),
                     tt.log_density, tf, post, n_iter=4)
    assert torch.equal(a.log_z, b.log_z) and a.n == 512


# ---------------------------------------------------------------------------
# the port's own fits, on the JAX package's checks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fitted():
    target = DiagNormal(loc=torch.tensor([1.0, -0.5]),
                        scale=torch.tensor([0.8, 1.2]))
    init = torch.randn((256, 2), generator=torch.Generator().manual_seed(4))
    flow = build_flow(init, torch.Generator().manual_seed(5), kind="affine",
                      n_blocks=2, hidden=(16,), device="cpu")
    flow = fit_vi(torch.Generator().manual_seed(6), target.log_density, flow,
                  2, optimizer=Adam(5e-3), batch_size=256, nsteps=400,
                  device="cpu").flow
    return flow, target


def test_normalized_target_has_log_z_zero(fitted):
    flow, target = fitted
    g = torch.Generator().manual_seed(7)
    res = log_evidence_is(g, target.log_density, flow, 2)
    assert abs(float(res.log_z)) < 0.05
    assert float(res.ess) > 0.5 * res.n
    bridge = log_evidence_bridge(
        g, target.log_density, flow, vi_sample(g, flow, 2, 4096,
                                               device="cpu"))
    assert abs(float(bridge.log_z)) < 0.05
    hm = log_evidence_harmonic(target.log_density, flow,
                               target.sample(g, 4096, device="cpu"))
    assert abs(float(hm)) < 0.1


def test_scaled_target_has_log_z_log_c(fitted):
    flow, target = fitted
    log_c = 3.7

    def scaled(x):
        return target.log_density(x) + log_c

    g = torch.Generator().manual_seed(11)
    res = log_evidence_is(g, scaled, flow, 2)
    assert abs(float(res.log_z) - log_c) < 0.05
    bridge = log_evidence_bridge(g, scaled, flow,
                                 vi_sample(g, flow, 2, 4096, device="cpu"))
    assert abs(float(bridge.log_z) - log_c) < 0.05


def test_is_and_bridge_at_d16():
    dim, log_c = 16, -2.4
    scale = torch.from_numpy(scale_of(dim))
    target = DiagNormal(loc=0.3 * torch.ones(dim), scale=scale)

    def scaled(x):
        return target.log_density(x) + log_c

    g = torch.Generator().manual_seed(20)
    draws = target.sample(g, 4096, device="cpu")
    flow = build_flow(draws, torch.Generator().manual_seed(21),
                      kind="affine", n_blocks=2, hidden=(32,), device="cpu")
    flow = optimize_flow(torch.Generator().manual_seed(22), draws, flow,
                         Adam(5e-3), nbatches=8, nepochs=30).result
    res = log_evidence_is(g, scaled, flow, dim, n=16384)
    assert float(res.ess) > 0.2 * res.n
    assert abs(float(res.log_z) - log_c) < 0.05
    bridge = log_evidence_bridge(g, scaled, flow,
                                 target.sample(g, 4096, device="cpu"),
                                 n_proposal=8192)
    assert abs(float(bridge.log_z) - log_c) < 0.05
    assert math.isfinite(float(bridge.ess))
