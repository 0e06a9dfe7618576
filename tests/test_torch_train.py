"""Training of the port against the JAX package: the reverse-KL losses
(STL and plain) and their gradients on the same noise to 1e-5, the written
out optimizer against optax over 5 steps to 1e-5, and the ELBO on the same
noise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpuflows.flows.affine import AffineCoupling as JAffine
from tpuflows.flows.affine import Standardize as JStandardize
from tpuflows.flows.core import Chain as JChain
from tpuflows.flows.nets import MLP as JMLP
from tpuflows.flows.train import make_reverse_kl_trainer as j_trainer
from tpuflows.flows.train import reverse_kl_loss as j_reverse_kl_loss
from tpuflows.targets import NealsFunnel as JFunnel
from tpuflows.targets.base import std_normal_logpdf as j_std_normal
from tpuflows.vi.elbo import _base_entropy as j_base_entropy

from tpuflows_torch.convert import flow_from_jax_params
from tpuflows_torch.flows import (ClipAdamCosine, make_reverse_kl_trainer,
                                  reverse_kl_loss, reverse_kl_stl_loss)
from tpuflows_torch.targets import NealsFunnel
from tpuflows_torch.util.shapes import leading_mask
from tpuflows_torch.vi import elbo, vi_sample

TOL = dict(rtol=1e-5, atol=1e-5)
D, HIDDEN = 8, (16, 16)


def jax_flow(seed):
    rng = np.random.default_rng(seed)
    sizes = (D, *HIDDEN, 2 * D)
    f32 = jnp.float32
    net = JMLP(weights=tuple(jnp.asarray(0.5 * rng.normal(
        0, np.sqrt(2.0 / a), (a, b)), f32) for a, b in zip(sizes[:-1],
                                                            sizes[1:])),
        biases=tuple(jnp.asarray(rng.normal(0, 0.1, b), f32)
                     for b in sizes[1:]))
    std = JStandardize(loc=jnp.asarray(rng.normal(0, 0.3, D), f32),
                       log_scale=jnp.asarray(rng.normal(0, 0.2, D), f32))
    return JChain(transforms=(std, JAffine(mask=leading_mask(D), net=net,
                                           clamp=8.0)))


def carry(jf):
    std, cp = jf.transforms
    return flow_from_jax_params(
        np.asarray(std.loc), np.asarray(std.log_scale),
        [np.asarray(w) for w in cp.net.weights],
        [np.asarray(b) for b in cp.net.biases], cp.mask, cp.clamp,
        device="cpu")


def jax_leaves(tree):
    """The JAX flow's leaves in the port's parameter order (loc,
    log_scale, then each layer's weight and bias)."""
    std, cp = tree.transforms
    return [std.loc, std.log_scale, *cp.net.weights, *cp.net.biases]


def torch_params(tf):
    std, cp = tf.transforms
    return [std.loc, std.log_scale, *cp.net.weights, *cp.net.biases]


def _stl_loss_jax(f, z, log_density):
    """flows/train.py's STL loss (the closure in make_reverse_kl_trainer),
    spelled out for jax.value_and_grad."""
    x, _ = f.inverse_and_ladj(z)
    f_sg = jax.tree_util.tree_map(jax.lax.stop_gradient, f)
    z_sg, ladj_fwd = f_sg.forward_and_ladj(x)
    log_q = j_std_normal(z_sg) + ladj_fwd
    return -jnp.mean(log_density(x) - log_q)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stl_loss_and_gradients_match_jax(seed):
    jf = jax_flow(seed)
    tf = carry(jf)
    z = np.random.default_rng(50 + seed).normal(size=(128, D)).astype(
        np.float32)
    jt, tt = JFunnel(dim=D), NealsFunnel(dim=D)
    j_loss, j_grads = jax.value_and_grad(_stl_loss_jax)(
        jf, jnp.asarray(z), jt.log_density)
    t_loss = reverse_kl_stl_loss(tf, tt.log_density, torch.from_numpy(z))
    t_grads = torch.autograd.grad(t_loss, torch_params(tf))
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), **TOL)
    for tg, jg in zip(t_grads, jax_leaves(j_grads)):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("seed", [0, 3])
def test_reverse_kl_loss_and_gradients_match_jax(seed):
    jf = jax_flow(seed)
    tf = carry(jf)
    z = np.random.default_rng(60 + seed).normal(size=(128, D)).astype(
        np.float32)
    jt, tt = JFunnel(dim=D), NealsFunnel(dim=D)
    j_loss, j_grads = jax.value_and_grad(j_reverse_kl_loss)(
        jf, jt.log_density, jnp.asarray(z))
    t_loss = reverse_kl_loss(tf, tt.log_density, torch.from_numpy(z))
    t_grads = torch.autograd.grad(t_loss, torch_params(tf))
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), **TOL)
    for tg, jg in zip(t_grads, jax_leaves(j_grads)):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("grad_scale", [0.1, 30.0])
def test_optimizer_matches_optax_over_five_steps(grad_scale):
    """The bench optimizer (clip by global norm 10, Adam, cosine decay
    1e-2 -> alpha 0.03) fed the same gradients in both frameworks; a scale
    of 30 makes the global norm exceed 10 so the clip acts."""
    rng = np.random.default_rng(int(grad_scale * 10))
    shapes = [(D,), (D,), (D, 16), (16,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(grad_scale * rng.normal(size=s)).astype(np.float32)
              for s in shapes] for _ in range(5)]
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(
        optax.cosine_decay_schedule(1e-2, 6, alpha=0.03)))
    jp = [jnp.asarray(p) for p in params]
    js = tx.init(jp)
    opt = ClipAdamCosine(lr=1e-2, decay_steps=6, alpha=0.03, max_norm=10.0)
    tp = [torch.tensor(p) for p in params]
    ts = opt.init(tp)
    for g in grads:
        upd, js = tx.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = opt.update(tp, [torch.tensor(x) for x in g], ts)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert ts.count == 5


@pytest.mark.parametrize("count", [0, 1, 3, 6, 9])
def test_learning_rate_schedule_matches_optax(count):
    sched = optax.cosine_decay_schedule(1e-2, 6, alpha=0.03)
    opt = ClipAdamCosine(lr=1e-2, decay_steps=6, alpha=0.03)
    np.testing.assert_allclose(opt.learning_rate(count), float(sched(count)),
                               rtol=1e-6)


def test_one_trainer_step_matches_jax_trainer():
    """One step of each package's trainer from the same flow, with the port
    fed the noise the JAX trainer draws: same loss and same new leaves."""
    jf = jax_flow(4)
    tf = carry(jf)
    jt, tt = JFunnel(dim=D), NealsFunnel(dim=D)
    key = jax.random.key(0)
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(
        optax.cosine_decay_schedule(1e-2, 10, alpha=0.03)))
    res = j_trainer(jt.log_density, D, tx, batch_size=64, stl=True)(
        key, jf, 1)
    z = jax.random.normal(jax.random.split(key, 1)[0], (64, D), jnp.float32)
    opt = ClipAdamCosine(lr=1e-2, decay_steps=10, alpha=0.03)
    params = torch_params(tf)
    loss = reverse_kl_stl_loss(tf, tt.log_density,
                               torch.from_numpy(np.array(z)))
    opt.update(params, torch.autograd.grad(loss, params), opt.init(params))
    np.testing.assert_allclose(float(loss.detach()), float(res.loss_hist[0]), **TOL)
    for tp_, jp_ in zip(params, jax_leaves(res.result)):
        np.testing.assert_allclose(tp_.detach().numpy(), np.asarray(jp_),
                                   **TOL)


def test_trainer_runs_and_lowers_the_loss():
    tt = NealsFunnel(dim=D)
    tf = carry(jax_flow(5))
    train = make_reverse_kl_trainer(
        tt.log_density, D, ClipAdamCosine(lr=1e-2, decay_steps=60),
        batch_size=128, stl=True, device="cpu")
    res = train(torch.Generator().manual_seed(0), tf, 60)
    assert res.result is tf and res.loss_hist.shape == (60,)
    assert torch.isfinite(res.loss_hist).all()
    assert float(res.loss_hist[-10:].mean()) < float(res.loss_hist[:10].mean())
    # a second call continues from the optimizer state
    res2 = train(torch.Generator().manual_seed(1), tf, 5,
                 opt_state=res.optimizer_state)
    assert res2.optimizer_state.count == 65


def test_trainer_refuses_a_diverged_loss():
    tf = carry(jax_flow(6))

    def bad_density(x):
        return x[..., 0] * float("nan")

    train = make_reverse_kl_trainer(bad_density, D, ClipAdamCosine(),
                                    batch_size=16, device="cpu")
    with pytest.raises(FloatingPointError, match="step 0"):
        train(torch.Generator().manual_seed(0), tf, 3)


def test_elbo_and_vi_sample_match_jax_on_the_same_noise():
    jf = jax_flow(7)
    tf = carry(jf)
    jt, tt = JFunnel(dim=D), NealsFunnel(dim=D)
    got = float(elbo(torch.Generator().manual_seed(3), tf, tt.log_density,
                     D, n=256, device="cpu"))
    z = torch.randn((256, D), generator=torch.Generator().manual_seed(3))
    want = (-float(j_reverse_kl_loss(jf, jt.log_density,
                                     jnp.asarray(z.numpy())))
            + float(j_base_entropy(D)))
    np.testing.assert_allclose(got, want, **TOL)
    x = vi_sample(torch.Generator().manual_seed(3), tf, D, 256, device="cpu")
    np.testing.assert_allclose(x.numpy(),
                               np.asarray(jf.inverse(jnp.asarray(z.numpy()))),
                               **TOL)


# ---------------------------------------------------------------------------
# the arqs spline flow of the generic path
# ---------------------------------------------------------------------------
def _arqs(seed, tier):
    from test_torch_coupling import carry, jax_arqs_flow

    jf = jax_arqs_flow(seed, d=D, n_blocks=2, knots=4, hidden=HIDDEN)
    return jf, carry(jf, use_pallas=tier)


def test_stl_steps_on_an_arqs_flow_match_jax_trainer():
    """Three steps of each package's STL trainer from the same arqs flow
    (oracle spline tier on both sides), the port fed the noise the JAX
    trainer draws: the same losses and the same new leaves to 1e-5."""
    jf, tf = _arqs(6, False)
    jt, tt = JFunnel(dim=D), NealsFunnel(dim=D)
    key, nsteps = jax.random.key(1), 3
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(
        optax.cosine_decay_schedule(1e-2, 10, alpha=0.03)))
    res = j_trainer(jt.log_density, D, tx, batch_size=64, stl=True)(
        key, jf, nsteps)
    opt = ClipAdamCosine(lr=1e-2, decay_steps=10, alpha=0.03)
    params = list(tf.parameters())
    state = opt.init(params)
    for i, k in enumerate(jax.random.split(key, nsteps)):
        z = np.array(jax.random.normal(k, (64, D), jnp.float32))
        loss = reverse_kl_stl_loss(tf, tt.log_density, torch.from_numpy(z))
        state = opt.update(params, torch.autograd.grad(loss, params), state)
        np.testing.assert_allclose(float(loss.detach()),
                                   float(res.loss_hist[i]), **TOL)
    leaves = jax.tree_util.tree_leaves(res.result)
    assert len(leaves) == len(params)
    for tp_, jp_ in zip(params, leaves):
        np.testing.assert_allclose(tp_.detach().numpy(), np.asarray(jp_),
                                   **TOL)


@pytest.mark.parametrize("tier", [False, "auto"])
def test_stl_gradients_on_an_arqs_flow_match_jax(tier):
    """The STL loss and its gradient on every leaf; the K4/K5 tier runs
    their plain version on the CPU, against the JAX oracle to the JAX
    package's spline bar (atol 1e-4)."""
    jf, tf = _arqs(7, tier)
    z = np.random.default_rng(70).normal(size=(128, D)).astype(np.float32)
    jt, tt = JFunnel(dim=D), NealsFunnel(dim=D)
    j_loss, j_grads = jax.value_and_grad(_stl_loss_jax)(
        jf, jnp.asarray(z), jt.log_density)
    t_loss = reverse_kl_stl_loss(tf, tt.log_density, torch.from_numpy(z))
    params = list(tf.parameters())
    t_grads = torch.autograd.grad(t_loss, params)
    tol = TOL if tier is False else dict(rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), **tol)
    for tg, jg in zip(t_grads, jax.tree_util.tree_leaves(j_grads)):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **tol)


def test_stl_forward_pass_conditioners_get_no_gradient(monkeypatch):
    """The STL loss evaluates log q(x) with the flow's parameters detached
    (`functional_call`): every conditioner the forward pass runs, the
    spline blocks' included, computes with weights that need no gradient
    (the gradient still flows through x into its masked input), while the
    inverse pass's weights need one. And the gradient equals that of the
    loss with log q taken through a frozen copy of the flow."""
    import copy

    from tpuflows_torch.flows import MLP, AffineCoupling, RQSCouplingBlock
    from tpuflows_torch.targets import std_normal_logpdf

    _, tf = _arqs(8, "auto")
    seen = []
    forward = MLP.forward

    def spy(self, x):
        seen.append((self.weights[-1].shape[1] > 2 * D,
                     all(w.requires_grad for w in self.weights)))
        return forward(self, x)

    monkeypatch.setattr(MLP, "forward", spy)
    tt = NealsFunnel(dim=D)
    z = torch.from_numpy(np.random.default_rng(80).normal(
        size=(64, D)).astype(np.float32))
    params = list(tf.parameters())
    grads = torch.autograd.grad(reverse_kl_stl_loss(tf, tt.log_density, z),
                                params)
    n_mlp = sum(isinstance(t, (AffineCoupling, RQSCouplingBlock))
                for t in tf.transforms)
    # the inverse pass (weights live), then the forward pass (detached),
    # for the affine and the spline conditioners alike
    assert [g for _, g in seen] == [True] * n_mlp + [False] * n_mlp
    assert sum(spline for spline, _ in seen) == 4
    monkeypatch.setattr(MLP, "forward", forward)
    frozen = copy.deepcopy(tf).requires_grad_(False)
    x, _ = tf.inverse_and_ladj(z)
    z_sg, ladj_fwd = frozen.forward_and_ladj(x)
    loss = -torch.mean(tt.log_density(x)
                       - (std_normal_logpdf(z_sg) + ladj_fwd))
    for a, b in zip(grads, torch.autograd.grad(loss, params)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
