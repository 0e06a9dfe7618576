"""The rest of training and VI of the port against the JAX package, on the
same flows (numpy leaves carried across) and the same batches and noise:

  * `negll_flow_loss` and its gradient, `make_train_step`, `Adam` against
    `optax.adam`;
  * `optimize_flow`, 3 epochs unshuffled, and shuffled with the JAX
    package's permutations fed to `_fit_epochs`, the helper the public
    function calls; with `val_frac`, the JAX package's split fed to
    `_split_validation`: the best epoch, `val_hist`, the best epoch's
    leaves and the final optimizer state (the reference's quirk);
  * `optimize_flow_sequentially`, 1 epoch per module;
  * annealed reverse KL (`optimize_flow_reverse_kl`, plain and STL, and
    the trainer's `anneal_steps`), 5 steps on the JAX package's z;
  * `fit_vi`'s ELBO history and final ELBO (through `_vi_result` on the
    same noise) and `vi_log_q`.

Every loss, history and leaf to rtol 1e-5 / atol 1e-5 unless a test says
otherwise. The flows are Standardize + affine coupling + spline coupling
(the oracle tier on both sides) at d = 4; the reverse-KL target is the
ported AR(1) Gaussian.
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
from tpuflows.flows.coupling import RQSCouplingBlock as JRQS
from tpuflows.flows.nets import MLP as JMLP
from tpuflows.flows import train as jtrain
from tpuflows.targets import CorrelatedGaussian as JCorrelated
from tpuflows.vi.elbo import fit_vi as j_fit_vi
from tpuflows.vi.elbo import vi_log_q as j_vi_log_q

from tpuflows_torch.convert import flow_from_jax_modules
from tpuflows_torch.flows import Adam, train as ttrain
from tpuflows_torch.targets import CorrelatedGaussian
from tpuflows_torch.vi.elbo import _vi_result, fit_vi, vi_log_q

TOL = dict(rtol=1e-5, atol=1e-5)
D = 4


def _mlp(rng, n_out, scale):
    sizes = (D, 8, n_out)
    f32 = jnp.float32
    return JMLP(weights=tuple(jnp.asarray(scale * rng.normal(
        0, np.sqrt(2.0 / a), (a, b)), f32) for a, b in zip(sizes[:-1],
                                                           sizes[1:])),
        biases=tuple(jnp.asarray(rng.normal(0, 0.05, b), f32)
                     for b in sizes[1:]))


def jax_flow(seed, spline=True):
    rng = np.random.default_rng(seed)
    f32 = jnp.float32
    mods = [JStandardize(loc=jnp.asarray(rng.normal(0, 0.3, D), f32),
                         log_scale=jnp.asarray(rng.normal(0, 0.2, D), f32)),
            JAffine(mask=(1, 0, 1, 0), net=_mlp(rng, 2 * D, 0.3), clamp=4.0)]
    if spline:
        mods.append(JRQS(mask=(0, 1, 0, 1), net=_mlp(rng, D * 11, 0.3),
                         knots=4, use_pallas=False))
    return JChain(transforms=tuple(mods))


def carry(jf):
    specs = []
    for t in jf.transforms:
        if isinstance(t, JStandardize):
            specs.append({"kind": "standardize", "loc": np.asarray(t.loc),
                          "log_scale": np.asarray(t.log_scale)})
            continue
        spec = {"mask": t.mask,
                "weights": [np.asarray(w) for w in t.net.weights],
                "biases": [np.asarray(b) for b in t.net.biases]}
        if isinstance(t, JAffine):
            spec.update(kind="affine", clamp=t.clamp)
        else:
            spec.update(kind="rqs", knots=t.knots, use_pallas=False)
        specs.append(spec)
    return flow_from_jax_modules(specs, device="cpu")


def same_leaves(tf, jtree, tol=TOL):
    leaves = jax.tree_util.tree_leaves(jtree)
    params = list(tf.parameters())
    assert len(params) == len(leaves)
    for p, leaf in zip(params, leaves):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(leaf),
                                   **tol)


def samples(seed, n=96):
    """A skewed cloud, so that the flow has something to fit."""
    rng = np.random.default_rng(200 + seed)
    x = rng.normal(size=(n, D))
    x[:, 1] += 0.5 * x[:, 0] ** 2
    return x.astype(np.float32)


def j_correlated():
    return JCorrelated.ar1(dim=D, rho=0.8)


def t_correlated():
    return CorrelatedGaussian.ar1(dim=D, rho=0.8, device="cpu")


# ---------------------------------------------------------------------------
# losses, steps, Adam
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
def test_negll_loss_and_gradient_match_jax(seed):
    jf = jax_flow(seed)
    tf = carry(jf)
    x = samples(seed)
    j_loss, j_grads = jax.value_and_grad(jtrain.negll_flow_loss)(
        jf, jnp.asarray(x))
    t_loss = ttrain.negll_flow_loss(tf, torch.from_numpy(x))
    t_grads = torch.autograd.grad(t_loss, list(tf.parameters()))
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), **TOL)
    for tg, jg in zip(t_grads, jax.tree_util.tree_leaves(j_grads)):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    assert ttrain.mvnormal_negll_flow is ttrain.negll_flow_loss


def test_adam_matches_optax_over_five_steps():
    rng = np.random.default_rng(5)
    shapes = [(D,), (D, 3), (3,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    tx = optax.adam(3e-2)
    jp = [jnp.asarray(p) for p in params]
    js = tx.init(jp)
    opt = Adam(3e-2)
    tp = [torch.tensor(p) for p in params]
    ts = opt.init(tp)
    for g in grads:
        upd, js = tx.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = opt.update(tp, [torch.tensor(x) for x in g], ts)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert ts.count == 5 and opt.learning_rate(3) == 3e-2


def test_train_step_matches_jax():
    jf = jax_flow(2)
    tf = carry(jf)
    x = samples(2)
    tx = optax.adam(1e-2)
    jstep = jtrain.make_train_step(tx, jtrain.negll_flow_loss)
    jf2, _, jl = jstep(jf, tx.init(jf), jnp.asarray(x))
    opt = Adam(1e-2)
    tstep = ttrain.make_train_step(opt, ttrain.negll_flow_loss)
    tf2, ts, tl = tstep(tf, opt.init(list(tf.parameters())),
                        torch.from_numpy(x))
    assert tf2 is tf and ts.count == 1
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    same_leaves(tf, jf2)


def test_train_step_gives_an_unreached_parameter_a_zero_gradient():
    tf = carry(jax_flow(3))
    frozen = ttrain._freeze_all_but(tf, 1)
    opt = Adam(1e-2)
    step = ttrain.make_train_step(
        opt, lambda f, x: ttrain.negll_flow_loss(ttrain._freeze_all_but(
            f, 1), x))
    before = [p.detach().clone() for p in tf.parameters()]
    step(tf, opt.init(list(tf.parameters())), torch.from_numpy(samples(3)))
    moved = [not torch.equal(a, b.detach())
             for a, b in zip(before, tf.parameters())]
    # Standardize (2 leaves) and the spline (4) stay; the affine (4) moves
    assert moved == [False] * 2 + [True] * 4 + [False] * 4
    assert len(frozen.transforms) == 3


# ---------------------------------------------------------------------------
# optimize_flow
# ---------------------------------------------------------------------------
def test_optimize_flow_unshuffled_matches_jax():
    jf = jax_flow(4)
    tf = carry(jf)
    x = samples(4)
    jres = jtrain.optimize_flow(jax.random.key(0), jnp.asarray(x), jf,
                                optax.adam(1e-2), nbatches=4, nepochs=3,
                                shuffle_samples=False)
    tres = ttrain.optimize_flow(torch.Generator().manual_seed(0),
                                torch.from_numpy(x), tf, Adam(1e-2),
                                nbatches=4, nepochs=3, shuffle_samples=False)
    assert tres.result is tf and tres.val_hist is None
    assert tres.best_epoch is None and tres.loss_hist.shape == (12,)
    np.testing.assert_allclose(tres.loss_hist.numpy(),
                               np.asarray(jres.loss_hist), **TOL)
    same_leaves(tf, jres.result)
    for a, b in zip(tres.optimizer_state.mu, jax.tree_util.tree_leaves(
            jres.optimizer_state[0].mu)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def _jax_epoch_perms(key, n, nepochs, val):
    """The permutations the JAX package's optimize_flow draws: the split's
    (with val) and each epoch's."""
    split = None
    if val:
        k_split, key = jax.random.split(key)
        split = np.asarray(jax.random.permutation(k_split, n))
        n = n - max(int(n * 0.25), 1)
    keys = jax.random.split(key, nepochs)
    return split, [np.asarray(jax.random.permutation(k, n)) for k in keys]


def test_optimize_flow_shuffled_matches_jax_on_its_permutations():
    jf = jax_flow(5)
    tf = carry(jf)
    x = samples(5, n=90)  # 90 rows in 4 batches: 2 rows dropped an epoch
    key = jax.random.key(3)
    jres = jtrain.optimize_flow(key, jnp.asarray(x), jf, optax.adam(1e-2),
                                nbatches=4, nepochs=3)
    _, perms = _jax_epoch_perms(key, 90, 3, val=False)
    tres = ttrain._fit_epochs(torch.from_numpy(x), None, tf, Adam(1e-2),
                              ttrain.negll_flow_loss, 4, 3,
                              lambda e: torch.from_numpy(perms[e]), None)
    np.testing.assert_allclose(tres.loss_hist.numpy(),
                               np.asarray(jres.loss_hist), **TOL)
    same_leaves(tf, jres.result)


def test_optimize_flow_shuffles_from_its_generator():
    x = torch.from_numpy(samples(6))
    runs = [ttrain.optimize_flow(torch.Generator().manual_seed(s),
                                 x, carry(jax_flow(6)), Adam(1e-2),
                                 nbatches=4, nepochs=2).loss_hist
            for s in (1, 1, 2)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert not torch.equal(runs[0], runs[2])


@pytest.mark.parametrize("shuffle", [False, True])
def test_optimize_flow_val_frac_matches_jax(shuffle):
    """Early stopping: the best epoch, the held-out loss per epoch, the
    best epoch's leaves and the final epoch's optimizer state. Ten epochs
    at learning rate 0.03 on 48 training rows overfit, so the best epoch
    is not the last."""
    jf = jax_flow(8)
    tf = carry(jf)
    x = samples(8, n=64)
    key = jax.random.key(11)
    nepochs = 10
    jres = jtrain.optimize_flow(key, jnp.asarray(x), jf, optax.adam(0.03),
                                nbatches=2, nepochs=nepochs,
                                shuffle_samples=shuffle, val_frac=0.25)
    split, perms = _jax_epoch_perms(key, 64, nepochs, val=True)
    train, val = ttrain._split_validation(torch.from_numpy(x), 0.25,
                                          torch.from_numpy(split))
    assert train.shape == (48, D) and val.shape == (16, D)
    tres = ttrain._fit_epochs(
        train, val, tf, Adam(0.03), ttrain.negll_flow_loss, 2, nepochs,
        (lambda e: torch.from_numpy(perms[e])) if shuffle else None, None)
    assert int(tres.best_epoch) == int(jres.best_epoch)
    assert 0 <= int(tres.best_epoch) < nepochs - 1
    np.testing.assert_allclose(tres.val_hist.numpy(),
                               np.asarray(jres.val_hist), **TOL)
    np.testing.assert_allclose(tres.loss_hist.numpy(),
                               np.asarray(jres.loss_hist), **TOL)
    same_leaves(tf, jres.result)  # the best epoch's leaves
    # the optimizer state is the final epoch's, not the best epoch's
    for a, b in zip(tres.optimizer_state.nu, jax.tree_util.tree_leaves(
            jres.optimizer_state[0].nu)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert tres.optimizer_state.count == nepochs * 2


def test_optimize_flow_refuses_what_the_reference_refuses():
    x = torch.from_numpy(samples(8, n=8))
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="no training data"):
        ttrain.optimize_flow(g, x, carry(jax_flow(8)), val_frac=1.0)
    with pytest.raises(ValueError, match="batches"):
        ttrain.optimize_flow(g, x, carry(jax_flow(8)), nbatches=9)
    with pytest.raises(ValueError, match=r"\(N, d\)"):
        ttrain.optimize_flow(g, x[0], carry(jax_flow(8)))


def test_optimize_flow_sequentially_matches_jax():
    jf = jax_flow(9)
    tf = carry(jf)
    x = samples(9)
    jres = jtrain.optimize_flow_sequentially(
        jax.random.key(0), jnp.asarray(x), jf, optax.adam(1e-2), nbatches=3,
        nepochs=1, shuffle_samples=False)
    tres = ttrain.optimize_flow_sequentially(
        torch.Generator().manual_seed(0), torch.from_numpy(x), tf,
        Adam(1e-2), nbatches=3, nepochs=1, shuffle_samples=False)
    assert tres.loss_hist.shape == (9,)
    np.testing.assert_allclose(tres.loss_hist.numpy(),
                               np.asarray(jres.loss_hist), **TOL)
    same_leaves(tf, jres.result)


# ---------------------------------------------------------------------------
# reverse KL and VI
# ---------------------------------------------------------------------------
def _jax_zs(key, nsteps, batch):
    return [np.asarray(jax.random.normal(k, (batch, D), jnp.float32))
            for k in jax.random.split(key, nsteps)]


@pytest.mark.parametrize("i,anneal", [(0, 0), (0, 8), (3, 8), (8, 8),
                                      (11, 8), (7, 1000)])
def test_anneal_beta_matches_jax(i, anneal):
    want = (1.0 if anneal == 0 else float(jnp.clip(
        0.2 + 0.8 * jnp.asarray(i).astype(jnp.float32) / anneal, 0.2, 1.0)))
    assert ttrain.anneal_beta(i, anneal) == want


@pytest.mark.parametrize("stl", [False, True])
def test_annealed_reverse_kl_matches_jax(stl):
    jf = jax_flow(10 + stl)
    tf = carry(jf)
    key = jax.random.key(5)
    jres = jtrain.optimize_flow_reverse_kl(
        key, j_correlated().log_density, jf, D, optax.adam(1e-2),
        batch_size=32, nsteps=5, anneal_steps=3, stl=stl)
    zs = _jax_zs(key, 5, 32)
    tres = ttrain._reverse_kl_steps(
        tf, t_correlated().log_density, Adam(1e-2), None,
        lambda i: torch.from_numpy(zs[i]), 5, 3, stl, "cpu")
    np.testing.assert_allclose(tres.loss_hist.numpy(),
                               np.asarray(jres.loss_hist), **TOL)
    same_leaves(tf, jres.result)


def test_trainer_anneals_like_jax_trainer():
    jf = jax_flow(12)
    tf = carry(jf)
    key = jax.random.key(6)
    jtrainer = jtrain.make_reverse_kl_trainer(
        j_correlated().log_density, D, optax.adam(1e-2), batch_size=16,
        anneal_steps=4)
    jres = jtrainer(key, jf, 5)
    zs = _jax_zs(key, 5, 16)
    tres = ttrain._reverse_kl_steps(
        tf, t_correlated().log_density, Adam(1e-2), None,
        lambda i: torch.from_numpy(zs[i]), 5, 4, False, "cpu")
    np.testing.assert_allclose(tres.loss_hist.numpy(),
                               np.asarray(jres.loss_hist), **TOL)
    same_leaves(tf, jres.result)
    # the public trainer takes the same path, from its own generator
    trainer = ttrain.make_reverse_kl_trainer(
        t_correlated().log_density, D, Adam(1e-2), batch_size=16,
        anneal_steps=4, device="cpu")
    res = trainer(torch.Generator().manual_seed(0), carry(jf), 5)
    assert res.loss_hist.shape == (5,) and res.optimizer_state.count == 5


def test_optimize_flow_reverse_kl_draws_from_its_generator():
    tgt = t_correlated()
    runs = [ttrain.optimize_flow_reverse_kl(
        torch.Generator().manual_seed(s), tgt.log_density,
        carry(jax_flow(13)), D, batch_size=16, nsteps=4, chunk_size=2,
        device="cpu").loss_hist for s in (4, 4)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)


@pytest.mark.parametrize("stl", [False, True])
def test_fit_vi_elbo_history_matches_jax(stl):
    jf = jax_flow(14 + stl)
    tf = carry(jf)
    key = jax.random.key(7)
    jres = j_fit_vi(key, j_correlated().log_density, jf, D,
                        optimizer=optax.adam(1e-2), batch_size=32, nsteps=5,
                        anneal_steps=2, stl=stl)
    k_train, k_eval = jax.random.split(key)
    zs = _jax_zs(k_train, 5, 32)
    z_eval = np.asarray(jax.random.normal(k_eval, (4096, D), jnp.float32))
    tgt = t_correlated()
    res = ttrain._reverse_kl_steps(
        tf, tgt.log_density, Adam(1e-2), None,
        lambda i: torch.from_numpy(zs[i]), 5, 2, stl, "cpu")
    vres = _vi_result(res, tgt.log_density, stl,
                            torch.from_numpy(z_eval))
    np.testing.assert_allclose(vres.elbo_hist.numpy(),
                               np.asarray(jres.elbo_hist), **TOL)
    np.testing.assert_allclose(float(vres.final_elbo),
                               float(jres.final_elbo), **TOL)
    same_leaves(vres.flow, jres.flow)


def test_fit_vi_runs_from_its_generator():
    tgt = t_correlated()
    res = fit_vi(torch.Generator().manual_seed(0), tgt.log_density,
                       carry(jax_flow(16)), D, batch_size=64, nsteps=30,
                       stl=True, device="cpu")
    assert res.elbo_hist.shape == (30,)
    assert torch.isfinite(res.final_elbo)
    # log Z = 0 for the normalized target: the ELBO is at most 0, up to
    # its Monte-Carlo error
    assert float(res.final_elbo) < 0.1


@pytest.mark.parametrize("seed", [0, 1])
def test_vi_log_q_matches_jax(seed):
    jf = jax_flow(17 + seed)
    x = samples(17 + seed)
    np.testing.assert_allclose(
        vi_log_q(carry(jf), torch.from_numpy(x)).detach().numpy(),
        np.asarray(j_vi_log_q(jf, jnp.asarray(x))), **TOL)
