"""The adaptive loop of the port (`tpuflows_torch.adaptive.loop`) against
the JAX package's (`tpuflows.adaptive.loop`) on the CPU:

  * `AdaptiveConfig`'s fields and defaults, and
    `AdaptiveSpec.to_adaptive_config` field for field (it passes neither
    `mask_scheme` nor `clamp`, so c3 keeps the loop's defaults);
  * the growth menu, `_next_growth_mask` and `_n_grown_units` on flows
    of the same masks, and `maybe_grow_flow`'s decisions on given round
    records (which trigger fires, which mask, which modules are
    appended), with `Chain.append` leaving the old chain as it was;
  * `_flow_is_ess` on the JAX package's own base draws z (`_is_ess_on`):
    rtol 1e-5 on an affine flow; 1e-4 on a spline flow, through both
    packages' spline oracles, whose float32 values agree to atol 1e-4
    (`test_torch_coupling.JAX_BAR`);
  * `best_flow` is the flow its best round sampled through, a copy taken
    before that round's refit, and differs from the refit flow;
  * a tiny run (d = 2, 8 chains, 50 + 50 NUTS steps, three rounds)
    interrupted after round 1 and resumed from its checkpoint equals the
    uninterrupted run to the bit: every round record, the flow, the draws
    and the best flow; with growth on, the grown flow too;
  * the reverse-KL and hybrid fits record the negated final ELBO, and an
    unknown `fit_method` is refused before any work.
"""
import dataclasses as dc
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflows import config as jconfig
from tpuflows.adaptive import loop as jloop
from tpuflows.flows import build_flow as j_build_flow
from tpuflows.targets import DiagNormal as JDiagNormal
from tpuflows.targets import GaussianMixture as JMixture

from tpuflows_torch import config as tconfig
from tpuflows_torch.adaptive import AdaptiveConfig, adaptive_fit
from tpuflows_torch.adaptive import loop
from tpuflows_torch.flows import (AffineCoupling, Chain, RQSCouplingBlock,
                                  build_flow)
from tpuflows_torch.io import load_pytree
from tpuflows_torch.targets import DiagNormal, GaussianMixture

from test_torch_coupling import JAX_BAR, carry, jax_arqs_flow

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------
def test_adaptive_config_fields_and_defaults_match_jax():
    assert AdaptiveConfig._fields == jloop.AdaptiveConfig._fields
    assert AdaptiveConfig() == jloop.AdaptiveConfig()
    assert loop.AdaptiveRound._fields == jloop.AdaptiveRound._fields
    assert loop.AdaptiveResult._fields == jloop.AdaptiveResult._fields


@pytest.mark.parametrize("flow", [
    None, dict(kind="arqs", n_blocks=3, knots=6, hidden=[32, 16],
               use_pallas=False, mask_scheme="mixed", clamp=8.0)])
def test_to_adaptive_config_matches_jax(flow):
    path = os.path.join(ROOT, "configs", "c3_mixture_adaptive.json")
    jc = jconfig.RunConfig.from_json(path)
    tc = tconfig.RunConfig.from_json(path)
    if flow is not None:
        jc = dc.replace(jc, flow=jconfig.FlowSpec(
            **{**flow, "hidden": tuple(flow["hidden"])}))
        tc = dc.replace(tc, flow=tconfig.FlowSpec(
            **{**flow, "hidden": tuple(flow["hidden"])}))
    ja = jc.adaptive.to_adaptive_config(jc.flow)
    ta = tc.adaptive.to_adaptive_config(tc.flow)
    assert isinstance(ta, AdaptiveConfig)
    for name in AdaptiveConfig._fields:
        a, b = getattr(ta, name), getattr(ja, name)
        assert a == (tuple(b) if name == "hidden" else b), name
    assert ta.mask_scheme == "alternating" and ta.clamp == 4.0
    assert isinstance(ta.hidden, tuple)


# ---------------------------------------------------------------------------
# growth
# ---------------------------------------------------------------------------
def flows(kind, d, n_blocks, mask_scheme="alternating"):
    x = np.random.default_rng(d).normal(size=(64, d)).astype(np.float32)
    jf = j_build_flow(jnp.asarray(x), jax.random.key(0), kind=kind,
                      n_blocks=n_blocks, knots=4, hidden=(8,),
                      mask_scheme=mask_scheme)
    tf = build_flow(torch.from_numpy(x), torch.Generator().manual_seed(0),
                    kind=kind, n_blocks=n_blocks, knots=4, hidden=(8,),
                    mask_scheme=mask_scheme, device="cpu")
    return jf, tf


def masks(flow):
    return [tuple(t.mask) for t in flow.transforms
            if getattr(t, "mask", None) is not None]


@pytest.mark.parametrize("d", [2, 5, 16])
def test_growth_menu_matches_jax(d):
    assert loop._growth_mask_menu(d) == [tuple(m) for m in
                                         jloop._growth_mask_menu(d)]


@pytest.mark.parametrize("kind,n_blocks,scheme", [
    ("rqs", 4, "alternating"), ("arqs", 2, "alternating"),
    ("rqs", 3, "mixed"), ("affine", 2, "mixed")])
def test_next_mask_and_grown_units_match_jax(kind, n_blocks, scheme):
    jf, tf = flows(kind, 6, n_blocks, scheme)
    assert masks(tf) == [tuple(m) for m in masks(jf)]
    assert loop._next_growth_mask(6, tf) == tuple(
        jloop._next_growth_mask(6, jf))
    for cfg_blocks in (n_blocks, 1):
        jcfg = jloop.AdaptiveConfig(flow_kind=kind, n_blocks=cfg_blocks)
        tcfg = AdaptiveConfig(flow_kind=kind, n_blocks=cfg_blocks)
        assert loop._n_grown_units(tf, tcfg) == \
            jloop._n_grown_units(jf, jcfg)
    assert loop._n_grown_units(None, AdaptiveConfig()) == 0


def records(rnd_cls, pairs):
    return [rnd_cls(min_ess=m, max_rhat=1.0, flow_is_ess=i,
                    accept_rate=0.8, divergence_rate=0.0, final_loss=0.0)
            for m, i in pairs]


GROWTH_CASES = {
    # (config changes, (min_ess, flow_is_ess) per round)
    "off": ({}, [(100, 0.2), (100, 0.2)]),
    "is_stall": ({"grow_on_stall": True}, [(100, 0.30), (120, 0.31)]),
    "is_gain": ({"grow_on_stall": True}, [(100, 0.20), (120, 0.30)]),
    "is_target_met": ({"grow_on_stall": True}, [(100, 0.6), (120, 0.6)]),
    "ess_stall": ({"grow_on_ess_stall": True}, [(100, 0.9), (105, 0.9)]),
    "ess_gain": ({"grow_on_ess_stall": True}, [(100, 0.9), (200, 0.9)]),
    "ess_threshold_met": ({"grow_on_ess_stall": True},
                          [(500, 0.9), (500, 0.9)]),
    "one_round": ({"grow_on_stall": True}, [(100, 0.2)]),
    "at_max": ({"grow_on_stall": True, "max_grown_blocks": 0},
               [(100, 0.3), (100, 0.3)]),
}


@pytest.mark.parametrize("case", sorted(GROWTH_CASES))
@pytest.mark.parametrize("kind", ["rqs", "arqs"])
def test_maybe_grow_flow_decides_as_jax(case, kind):
    changes, pairs = GROWTH_CASES[case]
    jf, tf = flows(kind, 6, 2)
    jcfg = jloop.AdaptiveConfig(flow_kind=kind, n_blocks=2, knots=4,
                                hidden=(8,), **changes)
    tcfg = AdaptiveConfig(flow_kind=kind, n_blocks=2, knots=4, hidden=(8,),
                          **changes)
    jflow, jn, jgrew = jloop.maybe_grow_flow(
        jf, records(jloop.AdaptiveRound, pairs), 0, jcfg, 6,
        jax.random.key(1))
    before = list(tf.transforms)
    tflow, tn, tgrew = loop.maybe_grow_flow(
        tf, records(loop.AdaptiveRound, pairs), 0, tcfg, 6,
        torch.Generator().manual_seed(1))
    assert (tgrew, tn) == (jgrew, jn)
    assert masks(tflow) == [tuple(m) for m in masks(jflow)]
    assert [type(m).__name__ for m in tflow.transforms] == \
        [type(m).__name__ for m in jflow.transforms]
    assert list(tf.transforms) == before  # the old chain as it was
    if tgrew:
        assert tflow is not tf
        assert all(a is b for a, b in zip(tflow.transforms, before))
        new = tflow.transforms[-1]
        assert isinstance(new, RQSCouplingBlock) and new.knots == 4
        assert not torch.any(new.net.weights[-1])
        if kind == "arqs":
            assert isinstance(tflow.transforms[-2], AffineCoupling)
    else:
        assert tflow is tf


def test_chain_append_returns_a_new_chain():
    _, tf = flows("rqs", 4, 2)
    extra = RQSCouplingBlock.init(torch.Generator().manual_seed(2),
                                  (1, 0, 1, 0), knots=4, hidden=(8,))
    grown = tf.append(extra, extra)
    assert isinstance(grown, Chain) and len(grown) == len(tf) + 2
    assert len(tf) == 3 and grown.transforms[-1] is extra
    z = torch.randn(5, 4, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():  # the inverse runs the new modules first
        torch.testing.assert_close(
            grown.inverse(z), tf.inverse(extra.inverse(extra.inverse(z))),
            rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the flow's importance-sampling ESS
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["affine", "arqs"])
def test_flow_is_ess_matches_jax(kind):
    d = 8
    jt = JMixture.bimodal(dim=d, separation=3.0)
    tt = GaussianMixture.bimodal(dim=d, separation=3.0, device="cpu")
    if kind == "affine":
        jf, tf = flows("affine", d, 2)
        bar = 1e-5
    else:
        jf = jax_arqs_flow(21, d=d, n_blocks=1, scale=0.3)
        tf = carry(jf, use_pallas=False)
        bar = 1e-4
    key = jax.random.key(5)
    want = float(jloop._flow_is_ess(key, jf, jt.log_density, d))
    z = np.array(jax.random.normal(key, (2048, d), jnp.float32))
    got = float(loop._is_ess_on(torch.from_numpy(z), tf, tt.log_density))
    assert 0.0 < want < 1.0
    assert abs(got - want) <= bar * abs(want) + bar
    g = torch.Generator().manual_seed(6)
    assert 0.0 < float(loop._flow_is_ess(g, tf, tt.log_density, d)) < 1.0


# ---------------------------------------------------------------------------
# whole runs at tiny size
# ---------------------------------------------------------------------------
def tiny(max_rounds, **changes):
    base = dict(max_rounds=max_rounds, ess_threshold=1e9, n_chains=8,
                num_warmup=50, num_samples=50, flow_kind="rqs", n_blocks=2,
                knots=4, hidden=(8,), train_epochs=3, train_batches=2,
                use_pallas="auto")
    return AdaptiveConfig(**{**base, **changes})


TARGET = DiagNormal(torch.tensor([0.5, -1.0]), torch.tensor([1.0, 2.0]))


def fit(cfg, ckpt=None, seed=0):
    return adaptive_fit(torch.Generator().manual_seed(seed),
                        TARGET.log_density, 2, cfg, checkpoint_dir=ckpt,
                        device="cpu")


def bits_equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(-1).view(torch.uint8)
                           if a.dtype.is_floating_point else a, b.view(-1)
                           .view(torch.uint8)
                           if b.dtype.is_floating_point else b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            bits_equal(x, y)
    else:
        assert a == b


def flows_equal(a, b):
    assert [type(m).__name__ for m in a.transforms] == \
        [type(m).__name__ for m in b.transforms]
    assert masks(a) == masks(b)
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        bits_equal(sa[k], sb[k])


@pytest.mark.parametrize("growth", [False, True])
def test_resume_equals_the_uninterrupted_run(tmp_path, growth):
    """All rounds at once, against one round with a checkpoint and a
    second call that resumes from it: two rounds, or with growth three,
    the third appending a block (the IS-ESS target 2 is never met and
    the gain 10 never reached)."""
    changes = (dict(grow_on_stall=True, grow_is_ess_target=2.0,
                    grow_min_gain=10.0) if growth else {})
    n = 3 if growth else 2
    whole = fit(tiny(n, **changes))
    ckpt = str(tmp_path / "run")
    first = fit(tiny(1, **changes), ckpt)
    assert first.n_rounds == 1 and sorted(os.listdir(ckpt)) == \
        ["adaptive_1.pt"]
    resumed = fit(tiny(n, **changes), ckpt)
    assert resumed.n_rounds == whole.n_rounds == n
    assert not resumed.converged and not whole.converged
    bits_equal([tuple(r) for r in resumed.rounds],
               [tuple(r) for r in whole.rounds])
    bits_equal(resumed.samples, whole.samples)
    flows_equal(resumed.flow, whole.flow)
    flows_equal(resumed.best_flow, whole.best_flow)
    assert resumed.best_min_ess == whole.best_min_ess > 0
    assert len(whole.flow.transforms) == (4 if growth else 3)
    state = load_pytree(str(tmp_path / "run" / f"adaptive_{n}"))
    assert int(state["next_round"]) == n
    assert isinstance(state["key"], torch.Generator)
    flows_equal(state["flow"], whole.flow)


def test_best_flow_is_the_flow_its_round_sampled_through(tmp_path):
    """Round r samples through the flow checkpointed after round r - 1,
    then refits that flow in place. best_flow must be the flow of the
    round with the highest min ESS as it was when that round sampled,
    not the module the refit changed."""
    ckpt = str(tmp_path / "run")
    res = fit(tiny(3), ckpt, seed=1)
    ess = [float(r.min_ess) for r in res.rounds]
    best = 1 + int(np.argmax(ess[1:]))  # round 0 samples without a flow
    assert res.best_min_ess == ess[best]
    sampled = load_pytree(os.path.join(ckpt, f"adaptive_{best}"))["flow"]
    flows_equal(res.best_flow, sampled)
    assert res.best_flow is not res.flow
    refit = load_pytree(os.path.join(ckpt, f"adaptive_{best + 1}"))["flow"]
    differ = [k for k, v in res.best_flow.state_dict().items()
              if not torch.equal(v, refit.state_dict()[k])]
    assert differ  # the refit moved the flow: a shared module would not


@pytest.mark.parametrize("method", ["reverse_kl", "hybrid"])
def test_reverse_kl_fits_record_the_negated_elbo(method):
    res = fit(tiny(1, fit_method=method, vi_steps=5, vi_batch=32))
    loss = float(res.rounds[0].final_loss)
    assert np.isfinite(loss) and res.n_rounds == 1


def test_unknown_fit_method_is_refused():
    with pytest.raises(ValueError, match="unknown fit_method"):
        fit(tiny(1, fit_method="forward"))
