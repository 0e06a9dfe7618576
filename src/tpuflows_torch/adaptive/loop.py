"""Adaptive flow refinement: the train, sample, retrain loop (port of
`tpuflows/adaptive/loop.py`). Each round:

  1. samples the target by NUTS, through the current flow in its latent
     space (round 0, with no flow yet, on the raw target);
  2. refits the flow on the round's pooled draws (forward KL,
     `optimize_flow`), or by reverse KL against the density (`fit_vi`
     with STL), or both ("hybrid");
  3. stops once the draws' min cross-chain ESS reaches the threshold.

Each round also records the flow's importance-sampling ESS against the
target, and the flow whose round sampled best (`best_flow`). A flow whose
proposal quality stalls may grow by one coupling unit a round
(`maybe_grow_flow`).

Randomness: the caller's generator is split once at the start and once a
round into child generators, one per phase (the JAX package's key
splits), so each phase draws the same numbers whatever the others draw;
the checkpoint of a round stores the split generator's state, and a
resumed run continues it.

Training changes a flow in place (`flows/train.py`), where the JAX
package builds a new pytree. So the loop keeps `best_flow` as a deep copy
taken when its round sampled best: without it the best flow would be the
same module as the refit one.
"""
from __future__ import annotations

import copy
import math
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from tpuflows_torch.diagnostics import (effective_sample_size,
                                        importance_weight_ess, split_rhat)
from tpuflows_torch.dist.failures import FailurePolicy
from tpuflows_torch.flows.build import build_flow
from tpuflows_torch.flows.core import Bijector
from tpuflows_torch.flows.train import Adam, optimize_flow
from tpuflows_torch.mcmc.preconditioned import (flow_reparameterized,
                                                to_data_space)
from tpuflows_torch.mcmc.sample import run_nuts
from tpuflows_torch.targets.base import std_normal_logpdf
from tpuflows_torch.util.device import f32_device

FIT_METHODS = ("forward_kl", "reverse_kl", "hybrid")


class AdaptiveConfig(NamedTuple):
    """Knobs for `adaptive_fit`, the JAX package's fields and defaults."""

    max_rounds: int = 5
    ess_threshold: float = 400.0  # min cross-chain ESS over dims to stop
    n_chains: int = 64
    num_warmup: int = 300
    num_samples: int = 300
    max_depth: int = 8
    target_accept: float = 0.8
    # the fit per round: "forward_kl" on the pooled NUTS draws,
    # "reverse_kl" (STL) against the density, or "hybrid" (both, in turn)
    fit_method: str = "forward_kl"
    vi_steps: int = 2000
    vi_batch: int = 1024
    flow_kind: str = "rqs"
    n_blocks: int = 4
    knots: int = 8
    hidden: tuple = (64, 64)
    mask_scheme: str = "alternating"
    clamp: float = 4.0  # affine log-scale soft clamp (arqs growth too)
    train_epochs: int = 60
    train_batches: int = 16
    learning_rate: float = 1e-3
    use_pallas: object = "auto"
    # growth: append a coupling unit when the flow's IS-ESS stalls below
    # `grow_is_ess_target` (`grow_on_stall`), or when the sampling min ESS
    # stalls below `ess_threshold` (`grow_on_ess_stall`); a stall is a
    # value below the previous round's times `grow_min_gain`
    grow_on_stall: bool = False
    grow_is_ess_target: float = 0.5
    grow_min_gain: float = 1.1
    grow_on_ess_stall: bool = False
    max_grown_blocks: int = 4


class AdaptiveRound(NamedTuple):
    """One round's record (0-d tensors)."""

    min_ess: torch.Tensor
    max_rhat: torch.Tensor
    flow_is_ess: torch.Tensor  # relative IS-ESS of the flow as proposal
    accept_rate: torch.Tensor
    divergence_rate: torch.Tensor
    final_loss: torch.Tensor


class AdaptiveResult(NamedTuple):
    flow: Bijector
    samples: torch.Tensor  # (n_draws, n_chains, d), data space, last round
    rounds: Sequence[AdaptiveRound]
    n_rounds: int
    converged: bool
    # the flow whose round sampled with the highest min ESS (the flow
    # itself until a round samples through one)
    best_flow: Optional[Bijector] = None
    best_min_ess: float = 0.0


def split_generator(generator: torch.Generator, n: int) -> list:
    """n generators on `generator`'s device, seeded from n draws of it."""
    seeds = torch.randint(0, 1 << 62, (n,), generator=generator,
                          device=generator.device).tolist()
    return [torch.Generator(device=generator.device).manual_seed(s)
            for s in seeds]


def _growth_mask_menu(dim: int):
    """Both checkerboards and both half-block masks: the menu of
    `build_flow`'s "mixed" scheme."""
    from tpuflows_torch.util.shapes import alternating_mask, block_mask

    return [alternating_mask(dim, 0), alternating_mask(dim, 1),
            block_mask(dim, 0), block_mask(dim, 1)]


def _next_growth_mask(dim: int, flow):
    """The menu's least-used mask, counted over the masks already in the
    flow (so a resumed run grows as an uninterrupted one)."""
    existing = [tuple(t.mask) for t in flow.transforms
                if getattr(t, "mask", None) is not None]
    menu = _growth_mask_menu(dim)
    counts = [existing.count(tuple(m)) for m in menu]
    return menu[counts.index(min(counts))]


def _n_grown_units(flow, cfg) -> int:
    """Spline blocks beyond the initial build: growth always appends one
    (alone, or after an affine coupling for "arqs")."""
    if flow is None:
        return 0
    from tpuflows_torch.flows.coupling import RQSCouplingBlock

    units = sum(isinstance(t, RQSCouplingBlock) for t in flow.transforms)
    initial = cfg.n_blocks if cfg.flow_kind in ("rqs", "arqs") else 0
    return max(0, units - initial)


def maybe_grow_flow(flow, rounds, n_grown, cfg, dim, generator):
    """Append a coupling unit with `_next_growth_mask`'s mask, up to
    `cfg.max_grown_blocks`, when a stall criterion fires (AdaptiveConfig):
    a spline block, after an affine coupling on the same mask for "arqs",
    initialized from two generators split from `generator`. `n_grown` is
    ignored (derived from the flow). Returns (flow, n_grown, grew)."""
    n_grown = _n_grown_units(flow, cfg)
    if not ((cfg.grow_on_stall or cfg.grow_on_ess_stall)
            and flow is not None and len(rounds) >= 2
            and n_grown < cfg.max_grown_blocks):
        return flow, n_grown, False
    is_now = float(rounds[-1].flow_is_ess)
    is_prev = float(rounds[-2].flow_is_ess)
    is_stall = (cfg.grow_on_stall
                and is_now < cfg.grow_is_ess_target
                and is_now < is_prev * cfg.grow_min_gain)
    ess_now = float(rounds[-1].min_ess)
    ess_prev = float(rounds[-2].min_ess)
    ess_stall = (cfg.grow_on_ess_stall
                 and ess_now < cfg.ess_threshold
                 and ess_now < ess_prev * cfg.grow_min_gain)
    if not (is_stall or ess_stall):
        return flow, n_grown, False
    from tpuflows_torch.flows.affine import AffineCoupling
    from tpuflows_torch.flows.coupling import RQSCouplingBlock

    mask = _next_growth_mask(dim, flow)
    g_aff, g_rqs = split_generator(generator, 2)
    device = next(flow.parameters()).device
    if cfg.flow_kind == "arqs":
        flow = flow.append(AffineCoupling.init(
            mask, g_aff, hidden=cfg.hidden, clamp=cfg.clamp, device=device))
    flow = flow.append(RQSCouplingBlock.init(
        g_rqs, mask, knots=cfg.knots, hidden=cfg.hidden,
        use_pallas=cfg.use_pallas, device=device))
    return flow, n_grown + 1, True


@torch.no_grad()
def _is_ess_on(z, flow, log_density):
    """Relative Kish ESS of the flow as an importance proposal for the
    target, on the base draws z (n, d)."""
    x, ladj = flow.inverse_and_ladj(z)
    log_q = std_normal_logpdf(z) - ladj  # q(x) under the flow
    return importance_weight_ess(log_density(x) - log_q) / z.shape[0]


def _flow_is_ess(generator, flow, log_density, dim, n=2048):
    """`_is_ess_on` n base draws from `generator`, on its device."""
    z = torch.randn((n, dim), generator=generator, device=generator.device)
    return _is_ess_on(z, flow, log_density)


def _checkpoint_state(flow, samples, generator, rounds, next_round,
                      best_flow, best_min_ess):
    state = {"flow": flow, "samples": samples, "key": generator,
             "rounds": [tuple(r) for r in rounds],
             "next_round": torch.tensor(next_round)}
    if best_flow is not None:
        state["best_flow"] = best_flow
        state["best_min_ess"] = torch.tensor(best_min_ess,
                                             dtype=torch.float64)
    return state


def adaptive_fit(
    generator: torch.Generator,
    log_density: Callable,
    dim: int,
    config: AdaptiveConfig = AdaptiveConfig(),
    init_positions: Optional[torch.Tensor] = None,
    flow: Optional[Bijector] = None,
    checkpoint_dir: Optional[str] = None,
    verbose: bool = False,
    failure_policy: Optional[FailurePolicy] = None,
    device="cuda",
) -> AdaptiveResult:
    """Run the adaptive loop until the ESS threshold or `max_rounds`, on
    `device` (default "cuda"; `generator` must be on it).

    `log_density` acts on (..., d). With `checkpoint_dir`, every
    completed round is saved as `adaptive_<rounds done>` (the flow, the
    draws, the generator, the round records, the best flow and its min
    ESS), and a call that finds one resumes after it. Each round's
    sampling and fits run under `failure_policy.guard` (default
    `FailurePolicy.from_env()`), so a hang is caught within one phase and
    a restart loses at most the round in flight."""
    cfg = config
    if cfg.fit_method not in FIT_METHODS:
        raise ValueError(f"unknown fit_method: {cfg.fit_method!r}")
    dev = f32_device(device)
    policy = failure_policy if failure_policy is not None \
        else FailurePolicy.from_env()
    (g_init,) = split_generator(generator, 1)
    if init_positions is None:
        init_positions = 0.5 * torch.randn((cfg.n_chains, dim),
                                           generator=g_init, device=dev)

    rounds = []
    samples = None
    converged = False
    n_rounds = 0
    start_round = 0
    best_flow = None
    best_min_ess = 0.0
    opt = Adam(cfg.learning_rate)

    if checkpoint_dir is not None:
        from tpuflows_torch.io import latest_checkpoint, load_pytree

        latest = latest_checkpoint(checkpoint_dir, prefix="adaptive_")
        if latest is not None:
            state = load_pytree(latest, device=dev)
            flow = state["flow"]
            samples = state["samples"]
            generator = state["key"]
            rounds = [AdaptiveRound(*r) for r in state["rounds"]]
            start_round = int(state["next_round"])
            n_rounds = start_round
            best_flow = state.get("best_flow", None)
            best_min_ess = float(state.get("best_min_ess", 0.0))
            if verbose:
                print(f"[adaptive] resumed at round {start_round}")

    n_grown = 0
    for rnd in range(start_round, cfg.max_rounds):
        g_sample, g_build, g_train, g_is, g_grow = split_generator(
            generator, 5)

        # -- 0. growth: append a coupling unit when the flow stalled ------
        flow, n_grown, grew = maybe_grow_flow(flow, rounds, n_grown, cfg,
                                              dim, g_grow)
        if grew and verbose:
            print(f"[adaptive round {rnd}] grew flow to "
                  f"{len(flow.transforms)} modules (is_ess stalled at "
                  f"{float(rounds[-1].flow_is_ess):.3f})")

        # -- 1. sample (in the latent space once a flow exists) -----------
        if flow is None:
            logp = log_density
            q0 = init_positions
        else:
            logp = flow_reparameterized(log_density, flow)
            # restart the chains from the latent image of the last draws
            with torch.no_grad():
                q0 = (flow.forward(samples[-1]) if samples is not None
                      else init_positions)
        res = policy.guard(run_nuts, g_sample, logp, q0,
                           num_warmup=cfg.num_warmup,
                           num_samples=cfg.num_samples,
                           max_depth=cfg.max_depth,
                           target_accept=cfg.target_accept,
                           phase=f"adaptive_sample:{rnd}")
        draws = res.samples  # latent if there is a flow, else data space
        if flow is not None:
            draws = to_data_space(flow, draws)
        samples = draws

        min_ess = torch.min(effective_sample_size(draws))
        max_rhat = torch.max(split_rhat(draws))
        # this round's min ESS measures the flow it SAMPLED through,
        # before the refit below changes that flow in place
        if flow is not None and float(min_ess) > best_min_ess:
            best_min_ess = float(min_ess)
            best_flow = copy.deepcopy(flow)

        # -- 2. refit the flow --------------------------------------------
        flat = draws.reshape(-1, dim)
        if flow is None:
            flow = build_flow(flat, g_build, kind=cfg.flow_kind,
                              n_blocks=cfg.n_blocks, knots=cfg.knots,
                              hidden=cfg.hidden,
                              mask_scheme=cfg.mask_scheme, clamp=cfg.clamp,
                              use_pallas=cfg.use_pallas, device=dev)
        final_loss = torch.tensor(math.nan, device=dev)
        if cfg.fit_method in ("forward_kl", "hybrid"):
            train = policy.guard(optimize_flow, g_train, flat, flow, opt,
                                 nbatches=cfg.train_batches,
                                 nepochs=cfg.train_epochs,
                                 phase=f"adaptive_train:{rnd}")
            flow = train.result
            final_loss = train.loss_hist[-1]
        if cfg.fit_method in ("reverse_kl", "hybrid"):
            from tpuflows_torch.vi import fit_vi

            (g_vi,) = split_generator(g_train, 1)
            vres = policy.guard(fit_vi, g_vi, log_density, flow, dim,
                                optimizer=Adam(cfg.learning_rate),
                                batch_size=cfg.vi_batch,
                                nsteps=cfg.vi_steps, stl=True, device=dev,
                                phase=f"adaptive_vi:{rnd}")
            flow = vres.flow
            final_loss = -vres.final_elbo  # negated: the loss convention

        record = AdaptiveRound(
            min_ess=min_ess,
            max_rhat=max_rhat,
            flow_is_ess=_flow_is_ess(g_is, flow, log_density, dim),
            accept_rate=torch.mean(res.info.accept_prob),
            divergence_rate=torch.mean(res.info.diverging.float()),
            final_loss=final_loss,
        )
        rounds.append(record)
        n_rounds = rnd + 1
        if checkpoint_dir is not None:
            from tpuflows_torch.io import save_pytree

            save_pytree(f"{checkpoint_dir}/adaptive_{rnd + 1}",
                        _checkpoint_state(flow, samples, generator, rounds,
                                          rnd + 1, best_flow, best_min_ess))
        if verbose:
            print(f"[adaptive round {rnd}] min_ess={float(min_ess):.1f} "
                  f"max_rhat={float(max_rhat):.4f} "
                  f"flow_is_ess={float(record.flow_is_ess):.3f} "
                  f"accept={float(record.accept_rate):.3f}")

        # -- 3. stop on the ESS of this round's draws ---------------------
        if float(min_ess) >= cfg.ess_threshold:
            converged = True
            break

    return AdaptiveResult(
        flow=flow,
        samples=samples,
        rounds=rounds,
        n_rounds=n_rounds,
        converged=converged,
        best_flow=best_flow if best_flow is not None else flow,
        best_min_ess=best_min_ess,
    )
