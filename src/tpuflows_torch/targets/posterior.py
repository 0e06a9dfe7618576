"""Posterior = likelihood x prior over unconstrained variates (port of
`tpuflows/targets/posterior.py`).

A prior over d scalar marginals is three per-dimension tensors: an
integer kind and two parameters a, b. Constrain, unconstrain, the
log-Jacobian, the prior's log pdf and its sampling are elementwise
selects over the kind, evaluated for every kind on every dimension with
inputs made safe first, as the JAX package writes them.

Unconstrained parameterization:
  NORMAL      theta = u                  (support R;  theta ~ N(a, b))
  LOGNORMAL   theta = exp(u)             (support R+; log theta ~ N(a, b))
  EXPONENTIAL theta = exp(u)             (support R+; rate a)
  HALFNORMAL  theta = exp(u)             (support R+; scale a)
  UNIFORM     theta = a + (b - a) s(u)   (support (a, b)), s the sigmoid
  BETA        theta = s(u)               (support (0, 1); Beta(a, b))
with log|dtheta/du| added to the unconstrained log density.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from tpuflows_torch.targets.base import Target

_LOG2PI = math.log(2.0 * math.pi)

NORMAL, LOGNORMAL, EXPONENTIAL, HALFNORMAL, UNIFORM, BETA = range(6)
_POSITIVE = (LOGNORMAL, EXPONENTIAL, HALFNORMAL)
_INTERVAL = (UNIFORM, BETA)


class Marginal(NamedTuple):
    """One scalar prior marginal: its kind and two parameters."""
    kind: int
    a: float
    b: float = 0.0


def Normal(mu: float = 0.0, sigma: float = 1.0) -> Marginal:
    return Marginal(NORMAL, float(mu), float(sigma))


def LogNormal(mu: float = 0.0, sigma: float = 1.0) -> Marginal:
    return Marginal(LOGNORMAL, float(mu), float(sigma))


def Exponential(rate: float = 1.0) -> Marginal:
    return Marginal(EXPONENTIAL, float(rate))


def HalfNormal(sigma: float = 1.0) -> Marginal:
    return Marginal(HALFNORMAL, float(sigma))


def Uniform(lo: float = 0.0, hi: float = 1.0) -> Marginal:
    if not hi > lo:
        raise ValueError(f"Uniform needs hi > lo, got ({lo}, {hi})")
    return Marginal(UNIFORM, float(lo), float(hi))


def Beta(alpha: float, beta: float) -> Marginal:
    return Marginal(BETA, float(alpha), float(beta))


def _log_sigmoid(u):
    # log s(u), stable; log(1 - s(u)) = _log_sigmoid(-u)
    return -torch.logaddexp(torch.zeros_like(u), -u)


def _betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


class IndependentPrior:
    """Product prior over d scalar marginals; its tensors on `device`
    (default "cuda")."""

    def __init__(self, marginals: Sequence[Marginal], device="cuda"):
        self.marginals = tuple(marginals)
        self.dim = len(self.marginals)
        self._kind = torch.tensor([m.kind for m in self.marginals],
                                  dtype=torch.int32, device=device)
        self._a = torch.tensor([m.a for m in self.marginals],
                               dtype=torch.float32, device=device)
        self._b = torch.tensor([m.b for m in self.marginals],
                               dtype=torch.float32, device=device)

    def _is(self, kinds):
        return torch.isin(self._kind, torch.tensor(
            kinds, dtype=torch.int32, device=self._kind.device))

    # ---- constrained <-> unconstrained ----------------------------------
    def constrain(self, u):
        """u (..., d) unconstrained -> theta (..., d) in the support."""
        k, a, b = self._kind, self._a, self._b
        s = torch.sigmoid(u)
        theta = torch.where(self._is(_POSITIVE), torch.exp(u), u)
        theta = torch.where(k == UNIFORM, a + (b - a) * s, theta)
        return torch.where(k == BETA, s, theta)

    def unconstrain(self, theta):
        """theta (..., d) -> u (..., d); the inverse of `constrain`."""
        k, a, b = self._kind, self._a, self._b
        positive = self._is(_POSITIVE)
        # safe arguments, so that every branch is finite before the select
        safe_pos = torch.where(positive, torch.clamp_min(theta, 1e-30), 1.0)
        t01_u = torch.clamp((theta - a) / torch.where(k == UNIFORM, b - a,
                                                      1.0), 1e-7, 1 - 1e-7)
        t01_b = torch.clamp(theta, 1e-7, 1 - 1e-7)
        u = torch.where(positive, torch.log(safe_pos), theta)
        u = torch.where(k == UNIFORM,
                        torch.log(t01_u) - torch.log1p(-t01_u), u)
        return torch.where(k == BETA,
                           torch.log(t01_b) - torch.log1p(-t01_b), u)

    def constrain_ladj(self, u):
        """log|dtheta/du| summed over the dimensions, shape (...)."""
        k = self._kind
        ladj = torch.where(self._is(_POSITIVE), u, torch.zeros_like(u))
        sig_ladj = _log_sigmoid(u) + _log_sigmoid(-u)
        ladj = torch.where(
            k == UNIFORM,
            torch.log(torch.clamp_min(self._b - self._a, 1e-30)) + sig_ladj,
            ladj)
        ladj = torch.where(k == BETA, sig_ladj, ladj)
        return torch.sum(ladj, dim=-1)

    # ---- the prior's log pdf (constrained space) -------------------------
    def log_pdf(self, theta):
        """sum_d log p_d(theta_d), shape (...); -inf outside the support."""
        k, a, b = self._kind, self._a, self._b
        positive = self._is(_POSITIVE)
        interval = self._is(_INTERVAL)
        # every branch is evaluated on every dimension before the select,
        # so each branch's inputs are made safe (finite values and
        # gradients where its parameters mean nothing), not its output
        safe_pos = torch.where(positive, torch.clamp_min(theta, 1e-30), 1.0)
        logt = torch.log(safe_pos)
        t01 = torch.where(interval, torch.clamp(theta, 1e-7, 1 - 1e-7), 0.5)
        sb = torch.where((k == NORMAL) | (k == LOGNORMAL),
                         torch.clamp_min(b, 1e-30), 1.0)
        rate = torch.where(k == EXPONENTIAL, torch.clamp_min(a, 1e-30), 1.0)
        hscale = torch.where(k == HALFNORMAL, torch.clamp_min(a, 1e-30), 1.0)
        th_n = torch.where(k == NORMAL, theta, 0.0)
        th_h = torch.where(k == HALFNORMAL, theta, 0.0)

        lp_normal = (-0.5 * ((th_n - a) / sb) ** 2 - torch.log(sb)
                     - 0.5 * _LOG2PI)
        lp_lognorm = (-0.5 * ((logt - a) / sb) ** 2 - torch.log(sb)
                      - 0.5 * _LOG2PI - logt)
        lp_expon = torch.log(rate) - rate * safe_pos
        lp_halfn = (math.log(2.0) - 0.5 * (th_h / hscale) ** 2
                    - torch.log(hscale) - 0.5 * _LOG2PI)
        lp_unif = -torch.log(torch.clamp_min(b - a, 1e-30))
        lp_beta = ((a - 1) * torch.log(t01) + (b - 1) * torch.log1p(-t01)
                   - _betaln(torch.clamp_min(a, 1e-6),
                             torch.clamp_min(b, 1e-6)))

        lp = torch.where(k == NORMAL, lp_normal, 0.0)
        lp = torch.where(k == LOGNORMAL, lp_lognorm, lp)
        lp = torch.where(k == EXPONENTIAL, lp_expon, lp)
        lp = torch.where(k == HALFNORMAL, lp_halfn, lp)
        lp = torch.where(k == UNIFORM, lp_unif, lp)
        lp = torch.where(k == BETA, lp_beta, lp)

        in_support = torch.where(positive, theta > 0, True)
        in_support = torch.where(k == UNIFORM, (theta > a) & (theta < b),
                                 in_support)
        in_support = torch.where(k == BETA, (theta > 0) & (theta < 1),
                                 in_support)
        lp = torch.where(in_support, lp, -math.inf)
        return torch.sum(lp, dim=-1)

    # ---- exact prior sampling (constrained space) ------------------------
    def sample_math(self, z, v, g1=None, g2=None):
        """Prior draws from given noise: z (n, d) standard normals, v (n, d)
        uniforms in (1e-7, 1 - 1e-7), and, where a marginal is a Beta,
        g1 and g2 (n, d) Gamma(max(a, 1e-6)) and Gamma(max(b, 1e-6))
        draws."""
        k, a, b = self._kind, self._a, self._b
        th = a + b * z  # NORMAL
        th = torch.where(k == LOGNORMAL, torch.exp(a + b * z), th)
        th = torch.where(k == EXPONENTIAL,
                         -torch.log1p(-v) / torch.clamp_min(a, 1e-30), th)
        th = torch.where(k == HALFNORMAL, torch.abs(a * z), th)
        th = torch.where(k == UNIFORM, a + (b - a) * v, th)
        if g1 is not None:
            th = torch.where(k == BETA, g1 / (g1 + g2), th)
        return th

    def sample(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """n prior draws on the prior's device (`generator` on it too)."""
        dev = self._a.device
        shape = (n, self.dim)
        z = torch.randn(shape, generator=generator, device=dev)
        v = 1e-7 + (1.0 - 2e-7) * torch.rand(shape, generator=generator,
                                               device=dev)
        g1 = g2 = None
        if any(m.kind == BETA for m in self.marginals):
            g1 = torch._standard_gamma(
                torch.clamp_min(self._a, 1e-6).expand(shape).contiguous(),
                generator=generator)
            g2 = torch._standard_gamma(
                torch.clamp_min(self._b, 1e-6).expand(shape).contiguous(),
                generator=generator)
        return self.sample_math(z, v, g1, g2)


class Posterior(Target):
    """Unnormalized posterior over unconstrained variates:
    `log_density(u) = loglik(constrain(u)) + logprior(constrain(u)) +
    ladj(u)`, so every sampler and flow (which assume support R^d)
    applies; map draws back with `constrain`."""

    def __init__(self, log_likelihood: Callable, prior: IndependentPrior):
        self.prior = prior
        self.log_likelihood = log_likelihood
        self.dim = prior.dim

    def log_density(self, u):
        theta = self.prior.constrain(u)
        return (self.log_likelihood(theta) + self.prior.log_pdf(theta)
                + self.prior.constrain_ladj(u))

    def constrain(self, u):
        return self.prior.constrain(u)

    def unconstrain(self, theta):
        return self.prior.unconstrain(theta)

    def sample_prior(self, generator: torch.Generator, n: int):
        """Exact prior draws in unconstrained space (a sampler's start)."""
        return self.prior.unconstrain(self.prior.sample(generator, n))


class ModeResult(NamedTuple):
    mode: torch.Tensor  # (d,) constrained-space mode (MAP)
    mode_u: torch.Tensor  # (d,) unconstrained-space argmax
    log_density: torch.Tensor  # 0-d log density at mode_u
    trace: torch.Tensor  # (nsteps,) the objective's history


def _ascend(logp, starts, nsteps, learning_rate):
    """`nsteps` Adam steps of every start up `logp` (the JAX package's
    optax.adam on -sum logp): (x (n_starts, d), trace (nsteps,), the mean
    log density after each step)."""
    from tpuflows_torch.flows.train import Adam

    x = starts.detach().clone()
    opt = Adam(learning_rate)
    state = opt.init([x])
    trace = torch.empty(nsteps, device=x.device)
    for i in range(nsteps):
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(-torch.sum(logp(xx)), xx)
        state = opt.update([x], [g], state)
        with torch.no_grad():
            trace[i] = torch.sum(logp(x)) / x.shape[0]
    return x, trace


def find_mode(target, x0, nsteps: int = 500, learning_rate: float = 0.05,
              n_starts: int = 8, generator: Optional[torch.Generator] = None,
              starts: Optional[torch.Tensor] = None) -> ModeResult:
    """MAP by multi-start Adam ascent on `target.log_density` (or on
    `target` itself, a callable), all starts in one (n_starts, d) batch;
    the best start wins. The starts are x0 and x0 + 0.5 N(0, I) draws from
    `generator` (default: seeded 0, on x0's device), or `starts` as
    given. For a `Posterior` the mode is reported in both spaces."""
    logp = target.log_density if hasattr(target, "log_density") else target
    x0 = torch.atleast_1d(torch.as_tensor(x0, dtype=torch.float32))
    if starts is None:
        if generator is None:
            generator = torch.Generator(device=x0.device).manual_seed(0)
        starts = x0[None, :] + 0.5 * torch.randn(
            (n_starts, x0.shape[-1]), generator=generator, device=x0.device)
        starts[0] = x0
    x, trace = _ascend(logp, starts, nsteps, learning_rate)
    with torch.no_grad():
        lps = logp(x)
    best = torch.argmax(lps)
    mode_u = x[best]
    mode = (target.constrain(mode_u) if hasattr(target, "constrain")
            else mode_u)
    return ModeResult(mode=mode, mode_u=mode_u, log_density=lps[best],
                      trace=trace)
