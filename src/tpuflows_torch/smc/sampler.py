"""Annealed SMC with flow bridges (port of `tpuflows/smc/sampler.py`).

The path is the geometric bridge between the flow's density q0 and the
target p,

    log p_beta(x) = (1 - beta) log q0(x) + beta log p(x),

with beta chosen by incremental-ESS bisection (`annealing.py`), systematic
resampling when the relative ESS drops below a threshold (`resample.py`),
HMC mutations whose step size adapts between sweeps from the pooled
acceptance, and an optional refresh of the flow on the current particles,
which then preconditions the mutations in its latent space. A refresh
either keeps the path's q0 endpoint ("freeze", the default) or replaces it
with an exact importance reweight ("reweight"); see `SMCConfig`.

Every stage's work stays on the device. Each stage reads the host twice,
once for the resampling decision and once for beta, where the JAX loop
reads beta once. Randomness: the caller's `torch.Generator` is split
into child generators (`split_generator`) at the start, per stage, for the
cross-fitted switch and for the final resample, at the points where the
JAX package splits its key. The stage's draws (the resampling uniform,
each sweep's momenta and acceptance uniforms) go to `_stage_math` and
`_hmc_sweep_math` as tensors, so tests can hand them the JAX package's.

Three things differ from the JAX code in form:

  * `optimize_flow` trains a flow in place, where the JAX package builds a
    new pytree. `run_smc` retrains a deep copy of the live flow, so the
    path's endpoint `flow_q0` (under "freeze"), and the flow a later
    retrain starts from (under "reweight"), are never moved by it;
  * the JAX mutation differentiates one particle's log density under
    `vmap`; here one `torch.autograd.grad` of the batch's summed log
    density gives every particle's gradient. That is exact because the
    target and every flow module act on each row alone. Each leapfrog
    step's graph is freed at once (`mcmc.hmc.value_and_grad`);
  * no mesh (`mesh=`, `gather_resample` and the sharded stage wait for
    ROADMAP Queue 1 item 11): one process runs the unsharded algorithm.
"""
from __future__ import annotations

import copy
import math
from typing import Callable, NamedTuple, Optional

import torch

from tpuflows_torch.adaptive.loop import split_generator
from tpuflows_torch.diagnostics import importance_weight_ess
from tpuflows_torch.dist.failures import FailurePolicy
from tpuflows_torch.flows.core import Bijector
from tpuflows_torch.flows.train import Adam, optimize_flow
from tpuflows_torch.mcmc.hmc import hmc_transition_math, value_and_grad
from tpuflows_torch.smc.annealing import next_beta
from tpuflows_torch.smc.resample import systematic_indices_math
from tpuflows_torch.targets.base import std_normal_logpdf
from tpuflows_torch.util.device import f32_device
from tpuflows_torch.vi.elbo import vi_log_q as _flow_log_q


class SMCConfig(NamedTuple):
    """`run_smc`'s knobs, the JAX package's fields and defaults."""

    n_particles: int = 4096
    target_rel_ess: float = 0.5  # per-stage incremental ESS target
    resample_threshold: float = 0.5  # resample when rel ESS drops below
    n_mutation_steps: int = 5  # HMC sweeps per stage
    n_leapfrog: int = 5
    initial_step_size: float = 0.2
    target_accept: float = 0.65
    step_adapt_rate: float = 1.0
    max_stages: int = 200
    latent_mutation: bool = True  # mutate in the flow's latent space
    retrain_every: int = 0  # 0 = never retrain the bridge flow
    # what a retrain refreshes:
    #   "freeze"   - the retrained flow preconditions the mutations only;
    #                the path's q0 endpoint stays the initial flow, so
    #                log Z and the weighted moments are unbiased;
    #   "reweight" - the retrained flow replaces q0, with the exact
    #                path-switch reweight log_w += (1 - beta) (log q0_new -
    #                log q0_old) and the matching log Z correction
    retrain_mode: str = "freeze"
    # the cross-fitted switch ("reweight" only): fit q0_new on the even
    # particles and carry the switch on the odd ones, which q0_new never
    # saw, then resample back to n from them; False fits on all and
    # reweights all (biased by the fit's overfit to those points)
    reweight_cross_fit: bool = True
    # stages run at beta = 1 before the final resample: the mutation
    # leaves the posterior invariant there, so they only equilibrate
    final_equilibration_stages: int = 0
    retrain_epochs: int = 20
    retrain_batches: int = 8
    retrain_lr: float = 1e-3
    # the sharded resampler's transport; accepted, no effect without a mesh
    gather_resample: object = None


class SMCResult(NamedTuple):
    particles: torch.Tensor  # (n, d) equally weighted, after the final resample
    log_weights: torch.Tensor  # (n,) residual log weights (0 after resample)
    log_z: torch.Tensor  # log Z_p / Z_q0 estimate (0-d)
    betas: torch.Tensor  # (n_stages,) the realized temperature ladder
    ess_hist: torch.Tensor  # (n_stages,) rel ESS before the resample decision
    accept_hist: torch.Tensor  # (n_stages,) mean mutation acceptance
    n_stages: int
    flow: Bijector
    log_z_sigma: object = float("nan")  # delta-method s.e. of log_z (0-d)
    ancestors: Optional[torch.Tensor] = None  # (n,) int32 initial lineage ids
    final_kish_ess: float = float("nan")  # Kish ESS of the final weights
    unique_ancestors: int = 0  # distinct surviving lineages


def smc_measured_ess(result: SMCResult) -> float:
    """The measured effective sample size of the final population: the
    smaller of the distinct surviving initial lineages and the Kish ESS of
    the final weights before the final resample. Both ignore the
    decorrelation the mutations bring, so the minimum errs low: the safe
    side for the divisor of `moment_gate`."""
    uniq = float(result.unique_ancestors)
    kish = float(result.final_kish_ess)
    return min(uniq, kish) if math.isfinite(kish) else uniq


def _logsumexp(v):
    """The JAX stage's logsumexp (`logsumexp_g` on one device)."""
    m = torch.max(v)
    return m + torch.log(torch.sum(torch.exp(v - m)))


def _hmc_sweep_math(q, logp_and_grad: Callable, eps, inv_mass, n_leapfrog,
                    normals, u):
    """n_steps = len(normals) fixed-length HMC transitions of every
    particle under the diagonal metric `inv_mass` (d,), with the draws
    given: `normals` (n_steps, n, d) standard normals (the momenta are
    normals / sqrt(inv_mass)) and `u` (n_steps, n) acceptance uniforms.
    The JAX rule: dh = h1 - h0 where finite, else inf; accept where
    u < min(1, exp(-dh)). Returns (q_new, mean acceptance probability per
    particle (n,))."""
    accs = []
    for s in range(normals.shape[0]):
        p0 = normals[s] / torch.sqrt(inv_mass)
        q, info = hmc_transition_math(q, p0, u[s], eps, inv_mass,
                                      logp_and_grad, n_leapfrog)
        accs.append(info.accept_prob)
    return q, torch.mean(torch.stack(accs), dim=0)


def _hmc_sweep(generator, q, logp_fn, eps, inv_mass, n_steps, n_leapfrog):
    """`_hmc_sweep_math` with its draws from `generator`, the gradient of
    `logp_fn` by autograd."""
    normals = torch.randn((n_steps, *q.shape), generator=generator,
                          device=q.device)
    u = torch.rand((n_steps, q.shape[0]), generator=generator,
                   device=q.device)
    return _hmc_sweep_math(q, value_and_grad(logp_fn), eps, inv_mass,
                           n_leapfrog, normals, u)


def _pooled_var(a):
    """The per-dimension particle variance in the JAX form (float32
    E[a^2] - E[a]^2, floored at 1e-6), not `torch.var`'s."""
    m1 = torch.mean(a, dim=0)
    m2 = torch.mean(a * a, dim=0)
    return torch.clamp_min(m2 - m1 * m1, 1e-6)


def _stage_math(log_density, cfg: SMCConfig, x, log_w, log_q0_x, anc, beta,
                eps, flow_q0, flow_pre, u0, draw):
    """One temperature stage: reweight, next beta, resample if the relative
    ESS fell below `cfg.resample_threshold`, then `n_mutation_steps`
    pooled-adaptive HMC sweeps at the new beta. `flow_q0` is the path's q0
    endpoint, `flow_pre` the mutation preconditioner (the same module
    unless a "freeze" retrain has run). The draws: `u0` the resampling
    uniform (0-d), `draw(s)` sweep s's (normals (n, d), uniforms (n,)).

    Returns (x, log_w, log_q0_x, anc, beta_new, eps, log_z_inc,
    log_z_var_inc, rel_ess, mean_acc)."""
    n = x.shape[0]
    with torch.no_grad():
        log_ratio = log_density(x) - log_q0_x
        beta_new = next_beta(beta, log_ratio, cfg.target_rel_ess)
        inc = (beta_new - beta) * log_ratio

        # the log Z increment under the current normalized weights
        lse_w = _logsumexp(log_w)
        log_z_inc = _logsumexp(log_w + inc) - lse_w
        # its delta-method variance: with wn the normalized weights and
        # r = exp(inc - max inc), Var(log zhat) ~ sum (wn (r - zhat))^2 /
        # zhat^2, zhat = sum wn r
        wn = torch.exp(log_w - lse_w)
        r = torch.exp(inc - torch.max(inc))
        zhat = torch.sum(wn * r)
        log_z_var_inc = torch.sum((wn * (r - zhat)) ** 2) / (zhat * zhat)

        log_w = log_w + inc
        rel_ess = importance_weight_ess(log_w) / n
        # the JAX stage computes both and selects; one host read here
        if bool(rel_ess < cfg.resample_threshold):
            idx = systematic_indices_math(u0, log_w)
            x, log_q0_x, anc = x[idx], log_q0_x[idx], anc[idx]
            log_w = torch.zeros_like(log_w)

    def tempered(xi):
        return ((1.0 - beta_new) * _flow_log_q(flow_q0, xi)
                + beta_new * log_density(xi))

    def mutate(pos, eps, logp_fn, inv_mass):
        """The sweeps; the step size adapts between them from the pooled
        mean acceptance, on the device."""
        logp_and_grad = value_and_grad(logp_fn)
        accs = []
        for s in range(cfg.n_mutation_steps):
            normals, u = draw(s)
            pos, acc = _hmc_sweep_math(pos, logp_and_grad, eps, inv_mass,
                                       cfg.n_leapfrog, normals[None],
                                       u[None])
            mean_acc = torch.mean(acc)
            eps = eps * torch.exp(cfg.step_adapt_rate
                                  * (mean_acc - cfg.target_accept))
            accs.append(mean_acc)
        return pos, eps, torch.mean(torch.stack(accs))

    if cfg.latent_mutation:
        def latent_logp(zi):
            xi, ladj = flow_pre.inverse_and_ladj(zi)
            return tempered(xi) + ladj

        with torch.no_grad():
            z = flow_pre.forward(x)
        z, eps, mean_acc = mutate(z, eps, latent_logp, _pooled_var(z))
        with torch.no_grad():
            x = flow_pre.inverse(z)
    else:
        x, eps, mean_acc = mutate(x, eps, tempered, _pooled_var(x))
    with torch.no_grad():
        # q0's density follows the moved particles
        log_q0_x = _flow_log_q(flow_q0, x)
    return (x, log_w, log_q0_x, anc, beta_new, eps, log_z_inc,
            log_z_var_inc, rel_ess, mean_acc)


def _make_stage(log_density, cfg: SMCConfig):
    """The stage `run_smc` runs: `stage(generator, x, log_w, log_q0_x, anc,
    beta, eps, flow_q0, flow_pre)`, `_stage_math` with its draws from
    `generator` on x's device (the uniform, then each sweep's normals and
    uniforms in turn)."""

    def stage(generator, x, log_w, log_q0_x, anc, beta, eps, flow_q0,
              flow_pre):
        n, d = x.shape
        dev = x.device
        u0 = torch.rand((), generator=generator, device=dev)

        def draw(_):
            return (torch.randn((n, d), generator=generator, device=dev),
                    torch.rand((n,), generator=generator, device=dev))

        return _stage_math(log_density, cfg, x, log_w, log_q0_x, anc, beta,
                           eps, flow_q0, flow_pre, u0, draw)

    return stage


def _execute_stage(stage, *args):
    """Run one stage to completion (wait for the device), so the failure
    guard of a stage covers its device time; tests substitute a hanging
    stage here."""
    out = stage(*args)
    if out[0].is_cuda:
        torch.cuda.synchronize(out[0].device)
    return out


def _switch_terms(log_w, dlw):
    """The log Z increment of a path switch and its delta-method
    variance."""
    lse_w = torch.logsumexp(log_w, dim=0)
    log_z_inc = torch.logsumexp(log_w + dlw, dim=0) - lse_w
    wn = torch.exp(log_w - lse_w)
    rr = torch.exp(dlw - torch.max(dlw))
    zhat = torch.sum(wn * rr)
    var_inc = torch.sum((wn * (rr - zhat)) ** 2) / (zhat * zhat)
    return log_z_inc, var_inc


@torch.no_grad()
def _path_switch(flow_new, x, log_w, log_q0_x, beta):
    """Replace the path's q0 by `flow_new`: the accrued weights targeted
    q0_old^(1-beta) p^beta, so retargeting them is the exact reweight
    dlw = (1 - beta)(log q0_new - log q0_old), and log Z takes the
    matching Z_beta^new / Z_beta^old. Returns (log_w, log_q0_new,
    log_z_inc, var_inc)."""
    log_q0_new = _flow_log_q(flow_new, x)
    dlw = (1.0 - beta) * (log_q0_new - log_q0_x)
    log_z_inc, var_inc = _switch_terms(log_w, dlw)
    return log_w + dlw, log_q0_new, log_z_inc, var_inc


@torch.no_grad()
def _cross_fit_switch_math(flow_new, u0, x, log_w, log_q0_x, anc, beta):
    """The cross-fitted switch: `flow_new` was fitted on x[0::2], so the
    switch is carried by the held-out x[1::2] alone (reweighted, the log Z
    increment taken from it, and n particles resampled from it with the
    uniform u0). Returns (x, log_w, log_q0_x, anc, log_z_inc, var_inc)."""
    xk, lwk = x[1::2], log_w[1::2]
    lqk, anck = log_q0_x[1::2], anc[1::2]
    log_q0_new = _flow_log_q(flow_new, xk)
    dlw = (1.0 - beta) * (log_q0_new - lqk)
    log_z_inc, var_inc = _switch_terms(lwk, dlw)
    idx = systematic_indices_math(u0, lwk + dlw, n_out=x.shape[0])
    return (xk[idx], torch.zeros_like(log_w), log_q0_new[idx], anck[idx],
            log_z_inc, var_inc)


@torch.no_grad()
def _finalize_math(u0, x, log_w, anc):
    """The final resample to equal weights (the lineage ids follow their
    particles): (x, anc, Kish ESS of log_w, distinct lineages), the
    distinct count taken on the device."""
    kish = importance_weight_ess(log_w)
    idx = systematic_indices_math(u0, log_w)
    x, anc = x[idx], anc[idx]
    present = torch.zeros((x.shape[0],), dtype=torch.int32,
                          device=x.device).index_fill_(0, anc.long(), 1)
    return x, anc, kish, torch.sum(present)


def _uniform(generator):
    (g,) = split_generator(generator, 1)
    return torch.rand((), generator=g, device=g.device)


def run_smc(
    generator: torch.Generator,
    log_density: Callable,
    flow: Bijector,
    dim: int,
    config: SMCConfig = SMCConfig(),
    verbose: bool = False,
    checkpoint_dir: Optional[str] = None,
    failure_policy: Optional[FailurePolicy] = None,
    device="cuda",
) -> SMCResult:
    """Annealed SMC from the flow's density to `log_density`, on `device`
    (default "cuda"; `generator` must be on it). The caller's flow is not
    changed.

    The flow is the exact initial sampler, the path's q0 endpoint and the
    mutation preconditioner (HMC in its latent space when
    `latent_mutation`). With `retrain_every > 0` a copy of the live flow
    is refitted to the particles every that many stages;
    `config.retrain_mode` says what the refit flow replaces.

    With `checkpoint_dir`, every completed stage is saved as
    `smc_<stages done>` (particles, weights, temperatures, both flows,
    the generator), and a call that finds one resumes after it. Each
    stage, retrain and path switch runs under `failure_policy.guard`
    (default `FailurePolicy.from_env()`), so the timeout is a per-stage
    budget and a restart loses at most the stage in flight."""
    cfg = config
    dev = f32_device(device)
    policy = failure_policy if failure_policy is not None \
        else FailurePolicy.from_env()
    if cfg.retrain_mode not in ("freeze", "reweight"):
        raise ValueError(f"unknown retrain_mode: {cfg.retrain_mode!r}")
    n = cfg.n_particles
    (g_init,) = split_generator(generator, 1)

    with torch.no_grad():
        z0 = torch.randn((n, dim), generator=g_init, device=dev)
        x, ladj0 = flow.inverse_and_ladj(z0)
        # log q0 at the start, from the draw itself (no forward pass)
        log_q0_x = std_normal_logpdf(z0) - ladj0
    # lineage ids: each particle's index in the initial population,
    # carried through every resample (`smc_measured_ess`)
    anc = torch.arange(n, dtype=torch.int32, device=dev)
    stage = _make_stage(log_density, cfg)
    flow_q0 = flow  # the path's q0 endpoint (see retrain_mode)

    log_w = torch.zeros((n,), device=dev)
    log_z = torch.zeros((), device=dev)
    log_z_var = torch.zeros((), device=dev)
    beta = torch.zeros((), device=dev)
    eps = torch.tensor(cfg.initial_step_size, dtype=torch.float32,
                       device=dev)
    betas, ess_hist, accept_hist = [], [], []

    start_stage = 0
    if checkpoint_dir is not None:
        from tpuflows_torch.io import latest_checkpoint, load_pytree

        latest = latest_checkpoint(checkpoint_dir, prefix="smc_")
        if latest is not None:
            st = load_pytree(latest, device=dev)
            x, log_w, log_q0_x = st["x"], st["log_w"], st["log_q0_x"]
            beta, eps, log_z = st["beta"], st["eps"], st["log_z"]
            generator = st["key"]
            flow, flow_q0 = st["flow"], st["flow_q0"]
            anc, log_z_var = st["anc"], st["log_z_var"]
            betas = list(st["betas"])
            ess_hist = list(st["ess_hist"])
            accept_hist = list(st["accept_hist"])
            start_stage = int(st["next_stage"])
            if verbose:
                print(f"[smc] resumed at stage {start_stage} "
                      f"beta={float(beta):.4f}")

    for stage_idx in range(start_stage, cfg.max_stages):
        g_stage, g_train = split_generator(generator, 2)
        (x, log_w, log_q0_x, anc, beta, eps, log_z_inc, log_z_var_inc,
         rel_ess, mean_acc) = policy.guard(
            _execute_stage, stage,
            g_stage, x, log_w, log_q0_x, anc, beta, eps, flow_q0, flow,
            phase=f"smc_stage:{stage_idx}")
        log_z = log_z + log_z_inc
        log_z_var = log_z_var + log_z_var_inc
        betas.append(beta)
        ess_hist.append(rel_ess)
        accept_hist.append(mean_acc)
        if verbose:
            print(f"[smc stage {stage_idx}] beta={float(beta):.4f} "
                  f"rel_ess={float(rel_ess):.3f} "
                  f"accept={float(mean_acc):.3f} eps={float(eps):.4f}")
        # the bridge refresh: refit a copy of the live flow (training is
        # in place, and the live flow may be flow_q0 itself)
        if cfg.retrain_every and (stage_idx + 1) % cfg.retrain_every == 0 \
                and float(beta) < 1.0:
            cross = (cfg.retrain_mode == "reweight"
                     and cfg.reweight_cross_fit)
            # cross-fitting fits on the even half only
            x_fit = x[0::2] if cross else x
            res = policy.guard(
                optimize_flow, g_train, x_fit, copy.deepcopy(flow),
                Adam(cfg.retrain_lr), nbatches=cfg.retrain_batches,
                nepochs=cfg.retrain_epochs,
                phase=f"smc_retrain:{stage_idx}")
            flow = res.result
            if cfg.retrain_mode == "reweight":
                if cross:
                    (x, log_w, log_q0_x, anc, sw_inc, sw_var) = policy.guard(
                        _cross_fit_switch_math, flow, _uniform(generator),
                        x, log_w, log_q0_x, anc, beta,
                        phase=f"smc_path_switch:{stage_idx}")
                else:
                    log_w, log_q0_x, sw_inc, sw_var = policy.guard(
                        _path_switch, flow, x, log_w, log_q0_x, beta,
                        phase=f"smc_path_switch:{stage_idx}")
                flow_q0 = flow
                log_z = log_z + sw_inc
                log_z_var = log_z_var + sw_var
                if verbose:
                    print(f"[smc retrain {stage_idx}] path switch "
                          f"log_z_inc={float(sw_inc):+.4f}"
                          f"{' (cross-fit)' if cross else ''}")
        if checkpoint_dir is not None:
            from tpuflows_torch.io import save_pytree

            save_pytree(f"{checkpoint_dir}/smc_{stage_idx + 1}", {
                "x": x, "log_w": log_w, "log_q0_x": log_q0_x, "anc": anc,
                "log_z_var": log_z_var, "beta": beta, "eps": eps,
                "log_z": log_z, "key": generator, "flow": flow,
                "flow_q0": flow_q0, "betas": betas, "ess_hist": ess_hist,
                "accept_hist": accept_hist,
                "next_stage": torch.tensor(stage_idx + 1),
            })
        if float(beta) >= 1.0:
            break

    # equilibration at beta = 1: the same stage, whose log Z increment is
    # 0 there; resampling and the lineages stay live
    for k in range(cfg.final_equilibration_stages):
        (g_stage,) = split_generator(generator, 1)
        (x, log_w, log_q0_x, anc, beta, eps, _, _, _, eq_acc) = \
            policy.guard(
                _execute_stage, stage,
                g_stage, x, log_w, log_q0_x, anc, beta, eps, flow_q0, flow,
                phase=f"smc_equilibrate:{k}")
        if verbose:
            print(f"[smc equilibrate {k}] accept={float(eq_acc):.3f} "
                  f"eps={float(eps):.4f}")

    x, anc, final_kish, uniq = _finalize_math(_uniform(generator), x, log_w,
                                              anc)
    return SMCResult(
        particles=x,
        log_weights=torch.zeros((n,), device=dev),
        log_z=log_z,
        betas=torch.stack(betas),
        ess_hist=torch.stack(ess_hist),
        accept_hist=torch.stack(accept_hist),
        n_stages=len(betas),
        flow=flow,
        log_z_sigma=torch.sqrt(log_z_var),
        ancestors=anc,
        final_kish_ess=float(final_kish),
        unique_ancestors=int(uniq),
    )
