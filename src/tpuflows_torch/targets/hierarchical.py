"""Hierarchical Gaussian posterior (port of `tpuflows/targets/hierarchical.py`;
config c5: the 256-d target).

Model (centered parameterization, funnel-like on purpose):
    mu      ~ N(0, prior_mu_scale^2)
    log_tau ~ N(0, 1)
    theta_i ~ N(mu, tau^2)            i = 1..J,  tau = exp(log_tau)
    y_i     ~ N(theta_i, noise^2)     y fixed synthetic data

Parameter vector x = [mu, log_tau, theta_1..theta_J], dim = J + 2.

Given tau the model is jointly Gaussian, so the posterior moments and the
log evidence follow from 1-D quadrature over log_tau, computed once in
float64 numpy. `_make_data` and `_exact_moments` are copies of the JAX
package's: the data come from the same `np.random.RandomState`, and the
moments and the evidence from the float32 data cast to float64, so they
equal the JAX package's to the bit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from tpuflows_torch.targets.base import Target

_LOG2PI = float(np.log(2.0 * np.pi))


def _make_data(J: int, seed: int, noise: float, true_tau: float,
               true_mu: float):
    rng = np.random.RandomState(seed)
    theta = true_mu + true_tau * rng.randn(J)
    y = theta + noise * rng.randn(J)
    return y.astype(np.float64)


def _exact_moments(y, noise, prior_mu_scale, n_grid=801, lo=-6.0, hi=4.0):
    """Posterior mean/cov of [mu, log_tau, theta] by quadrature over
    log_tau, the log evidence, and the grid's per-point blocks."""
    J = y.shape[0]
    s2 = noise**2
    pm2 = prior_mu_scale**2
    lts = np.linspace(lo, hi, n_grid)
    logw = np.empty(n_grid)
    means = np.empty((n_grid, J + 2))
    # per-grid-point covariance blocks (exchangeable structure)
    v_mu_g = np.empty(n_grid)
    a_g = np.empty(n_grid)
    c_g = np.empty(n_grid)
    for k, lt in enumerate(lts):
        t2 = np.exp(2.0 * lt)
        w2 = t2 + s2  # marginal var of y_i | mu
        # mu | y, tau
        v_mu = 1.0 / (1.0 / pm2 + J / w2)
        m_mu = v_mu * np.sum(y) / w2
        # theta_i | mu, y_i:  c = (1/t2 + 1/s2)^-1, theta = a*mu + b*y_i + eps
        c = 1.0 / (1.0 / t2 + 1.0 / s2)
        a = c / t2
        b = c / s2
        # log p(y | tau): y ~ N(0, w2 I + pm2 11^T) via Sherman-Morrison
        quad = (np.sum(y**2) - pm2 * np.sum(y) ** 2 / (w2 + pm2 * J)) / w2
        logdet = J * np.log(w2) + np.log(1.0 + pm2 * J / w2)
        logw[k] = -0.5 * (quad + logdet + J * _LOG2PI) - 0.5 * lt**2
        means[k, 0] = m_mu
        means[k, 1] = lt
        means[k, 2:] = a * m_mu + b * y
        v_mu_g[k], a_g[k], c_g[k] = v_mu, a, c
    # the log evidence before the max-shift below drops the absolute
    # scale: log p(y) = log of the trapezoid integral of exp(logw) over
    # log_tau, minus the log_tau prior's 0.5 log(2 pi)
    lw_max = logw.max()
    trap = np.exp(logw - lw_max)
    trap[0] *= 0.5
    trap[-1] *= 0.5
    log_evidence = (lw_max + np.log(trap.sum() * (lts[1] - lts[0]))
                    - 0.5 * _LOG2PI)

    logw -= logw.max()
    w = np.exp(logw)
    w /= w.sum()

    mean = w @ means
    d = J + 2
    cov = np.zeros((d, d))
    for k in range(n_grid):
        ck = np.zeros((d, d))
        ck[0, 0] = v_mu_g[k]
        ck[0, 2:] = a_g[k] * v_mu_g[k]
        ck[2:, 0] = a_g[k] * v_mu_g[k]
        ck[2:, 2:] = (a_g[k] ** 2) * v_mu_g[k]
        ck[2:, 2:] += np.eye(J) * c_g[k]
        dm = means[k] - mean
        cov += w[k] * (ck + np.outer(dm, dm))
    return mean, cov, log_evidence, (lts, w, v_mu_g, a_g, c_g, means)


class HierarchicalGaussian(Target):
    """`log_density` takes x on y's device; every normalizing constant is
    in it, so its integral is the evidence."""

    def __init__(self, y, noise: float = 2.0, prior_mu_scale: float = 5.0):
        self.y = torch.as_tensor(y, dtype=torch.float32)  # (J,) data
        self.noise = noise
        self.prior_mu_scale = prior_mu_scale
        self._truth_cache = None

    @property
    def dim(self):
        return self.y.shape[-1] + 2

    def log_density(self, x):
        mu = x[..., 0]
        lt = x[..., 1]
        theta = x[..., 2:]
        J = self.y.shape[-1]
        inv_t2 = torch.exp(-2.0 * lt)  # 1 / tau^2
        lp_mu = (-0.5 * (mu / self.prior_mu_scale) ** 2
                 - math.log(self.prior_mu_scale) - 0.5 * _LOG2PI)
        lp_lt = -0.5 * lt * lt - 0.5 * _LOG2PI
        dtheta = theta - mu[..., None]
        lp_theta = (-0.5 * torch.sum(dtheta * dtheta, dim=-1) * inv_t2
                    - J * lt
                    - 0.5 * J * _LOG2PI)
        dy = self.y - theta
        lp_y = (-0.5 * torch.sum(dy * dy, dim=-1) / (self.noise**2)
                - J * math.log(self.noise)
                - 0.5 * J * _LOG2PI)
        return lp_mu + lp_lt + lp_theta + lp_y

    @staticmethod
    def standard(dim: int = 256, seed: int = 7, noise: float = 2.0,
                 prior_mu_scale: float = 5.0, true_tau: float = 1.5,
                 true_mu: float = 1.0, device="cuda"
                 ) -> "HierarchicalGaussian":
        J = dim - 2
        y = _make_data(J, seed, noise, true_tau, true_mu)
        return HierarchicalGaussian(
            torch.tensor(y, dtype=torch.float32, device=device),
            noise=noise, prior_mu_scale=prior_mu_scale)

    # -- exact ground truth (float64 numpy, computed once) -----------------
    def _truth(self):
        if self._truth_cache is None:
            y = self.y.detach().cpu().numpy().astype(np.float64)
            self._truth_cache = _exact_moments(y, self.noise,
                                               self.prior_mu_scale)
        return self._truth_cache

    def mean(self, device="cuda"):
        return torch.tensor(self._truth()[0], dtype=torch.float32,
                            device=device)

    def cov(self, device="cuda"):
        return torch.tensor(self._truth()[1], dtype=torch.float32,
                            device=device)

    def log_evidence(self) -> float:
        """The quadrature log p(y) (float64, on the moments' log_tau grid):
        the truth for SMC's and the bridge's log Z."""
        return float(self._truth()[2])

    def sample_prior(self, generator: torch.Generator, n: int,
                     device="cuda") -> torch.Tensor:
        """Draws from the model's prior p(mu, log_tau, theta): no data, no
        posterior oracle. c5 pretrains its bridge flow on them."""
        gdev = generator.device
        J = self.y.shape[-1]
        mu = self.prior_mu_scale * torch.randn((n, 1), generator=generator,
                                               device=gdev)
        lt = torch.randn((n, 1), generator=generator, device=gdev)
        theta = mu + torch.exp(lt) * torch.randn((n, J), generator=generator,
                                                 device=gdev)
        return torch.cat([mu, lt, theta], dim=-1).to(device)

    def sample(self, generator: torch.Generator, n: int,
               device="cuda") -> torch.Tensor:
        """Exact posterior draws: a log_tau grid point from its quadrature
        weight, then the conditional Gaussian."""
        _, _, _, (lts, w, v_mu_g, a_g, c_g, means) = self._truth()
        gdev = generator.device

        def f32(a):
            return torch.tensor(a, dtype=torch.float32, device=gdev)

        idx = torch.multinomial(f32(w), n, replacement=True,
                                generator=generator)
        lts_j = f32(lts)[idx]
        v_mu = f32(v_mu_g)[idx]
        a = f32(a_g)[idx]
        c = f32(c_g)[idx]
        m = f32(means)[idx]  # (n, d)
        mu = m[:, 0] + torch.sqrt(v_mu) * torch.randn(
            (n,), generator=generator, device=gdev)
        J = self.y.shape[-1]
        eps = torch.randn((n, J), generator=generator, device=gdev)
        theta = (m[:, 2:] + a[:, None] * (mu - m[:, 0])[:, None]
                 + torch.sqrt(c)[:, None] * eps)
        return torch.cat([mu[:, None], lts_j[:, None], theta],
                         dim=-1).to(device)
