"""Flow training (port of `tpuflows/flows/train.py`): the forward-KL and
reverse-KL losses, the minibatch fit `optimize_flow` with `val_frac` early
stopping, module-by-module training, the reverse-KL fit and its reusable
trainer, and `Adam` / `ClipAdamCosine`, the optax optimizers the package
uses written out.

The JAX loops run inside jitted scans. Here a host loop runs one eager step
at a time, with the loss history kept on the device and read back once per
call. Training updates the flow's parameters in place. Left out: `axis_name`
(waits for `dist/`, ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from tpuflows_torch.flows.core import Bijector, Chain, call_with, detached
from tpuflows_torch.targets.base import std_normal_logpdf
from tpuflows_torch.util.device import f32_device


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------
def negll_flow_loss(flow: Bijector, x: torch.Tensor) -> torch.Tensor:
    """Forward KL: -E_x[log N(f(x); 0, I) + ladj_f(x)], x (batch, d)."""
    z, ladj = flow.forward_and_ladj(x)
    return -torch.mean(std_normal_logpdf(z) + ladj)


# the standard-normal-base specialization is the same computation
mvnormal_negll_flow = negll_flow_loss


def reverse_kl_loss(flow: Bijector, log_density: Callable,
                    z: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """KL(q || p^beta) up to the base entropy: E_z[-ladj_inv(z) - beta log
    p(f^-1(z))], z ~ N(0, I). Also the negative ELBO minus that entropy."""
    x, ladj = flow.inverse_and_ladj(z)
    return -torch.mean(beta * log_density(x) + ladj)


def reverse_kl_stl_loss(flow: Bijector, log_density: Callable,
                        z: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Sticking-the-landing reverse KL: log q(x) is evaluated with the
    flow's parameters detached, so the gradient flows only through the
    sample path x = f^-1(z). At beta = 1 its value is -(ELBO estimate)."""
    x, _ = flow.inverse_and_ladj(z)
    z_sg, ladj_fwd = call_with(flow, "forward_and_ladj", detached(flow), x)
    log_q = std_normal_logpdf(z_sg) + ladj_fwd
    return -torch.mean(beta * log_density(x) - log_q)


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------
class AdamState(NamedTuple):
    count: int  # updates applied so far (host integer: no device read)
    mu: list
    nu: list


class Adam:
    """`optax.adam(lr)`, written out in the same order of operations; the
    moments stay on the device."""

    def __init__(self, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    def learning_rate(self, count: int) -> float:
        return self.lr

    def _transform(self, grads):
        """What the gradients go through before the moments."""
        return grads

    @torch.no_grad()
    def update(self, params, grads, state: AdamState) -> AdamState:
        """Applies one update to `params` in place; returns the new state."""
        grads = self._transform(grads)
        count = state.count + 1
        mu = [(1.0 - self.b1) * g + self.b1 * m
              for g, m in zip(grads, state.mu)]
        nu = [(1.0 - self.b2) * (g * g) + self.b2 * v
              for g, v in zip(grads, state.nu)]
        c1 = 1.0 - self.b1 ** count
        c2 = 1.0 - self.b2 ** count
        step = -self.learning_rate(state.count)
        for p, m, v in zip(params, mu, nu):
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            p.add_(step * u)
        return AdamState(count, mu, nu)


class ClipAdamCosine(Adam):
    """`optax.chain(clip_by_global_norm(max_norm),
    adam(cosine_decay_schedule(lr, decay_steps, alpha)))`, the optimizer of
    `bench.py`, written out in the same order of operations.

    The learning rate of update `count` is computed on the host; the global
    norm, the clip and the moments stay on the device."""

    def __init__(self, lr: float = 1e-2, decay_steps: int = 6000,
                 alpha: float = 0.03, max_norm: float = 10.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        super().__init__(lr, b1, b2, eps)
        self.decay_steps, self.alpha, self.max_norm = (decay_steps, alpha,
                                                       max_norm)

    def learning_rate(self, count: int) -> float:
        c = min(count, self.decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / self.decay_steps))
        return self.lr * ((1.0 - self.alpha) * cosine + self.alpha)

    def _transform(self, grads):
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = g_norm < self.max_norm
        return [torch.where(keep, g, g / g_norm * self.max_norm)
                for g in grads]


# ---------------------------------------------------------------------------
# Steps and results
# ---------------------------------------------------------------------------
class TrainResult(NamedTuple):
    result: Bijector  # the trained flow (the same module, updated in place)
    optimizer_state: object
    loss_hist: torch.Tensor  # (nsteps,)
    # optimize_flow(val_frac > 0): the held-out loss per epoch and the
    # epoch whose parameters `result` carries
    val_hist: Optional[torch.Tensor] = None  # (nepochs,)
    best_epoch: Optional[torch.Tensor] = None  # 0-d int


def _check_finite_loss(loss_hist: torch.Tensor) -> None:
    h = loss_hist.detach().cpu()
    if not torch.isfinite(h[-1]):
        bad = int(torch.nonzero(~torch.isfinite(h))[0, 0])
        raise FloatingPointError(
            f"flow training diverged: loss became non-finite at step {bad} "
            f"of {h.numel()} (loss_hist[-1]={float(h[-1])})")


def make_train_step(optimizer: Adam, loss_fn: Callable):
    """`step(flow, opt_state, batch) -> (flow, opt_state, loss)`: the
    gradient of the scalar `loss_fn(flow, batch)` with respect to every
    parameter of the flow (zero for one the loss does not reach), then one
    optimizer update in place."""

    def step(flow, opt_state, batch):
        params = list(flow.parameters())
        loss = loss_fn(flow, batch)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        opt_state = optimizer.update(params, grads, opt_state)
        return flow, opt_state, loss.detach()

    return step


# ---------------------------------------------------------------------------
# Forward KL on samples
# ---------------------------------------------------------------------------
def _split_validation(samples, val_frac, perm):
    """(train, held-out) rows of `samples` under the permutation `perm` of
    its rows: the first max(int(N val_frac), 1) rows of perm are held
    out."""
    n_all = samples.shape[0]
    n_val = max(int(n_all * val_frac), 1)
    if n_val >= n_all:
        raise ValueError(f"val_frac={val_frac} leaves no training data")
    return samples[perm[n_val:]], samples[perm[:n_val]]


def _fit_epochs(samples, val, flow, optimizer, loss, nbatches, nepochs,
                epoch_perm, opt_state) -> TrainResult:
    """`optimize_flow` on given rows: epoch e trains on the batches of
    `samples[epoch_perm(e)]` (the first nbatches * (N // nbatches) rows;
    the rows in order when `epoch_perm` is None) and, when `val` is given,
    evaluates the loss on it; the parameters of the epoch with the lowest
    held-out loss are kept and put back into the flow at the end, with
    the final optimizer state (the JAX package's behaviour)."""
    n = samples.shape[0]
    bs = n // nbatches
    if bs == 0:
        raise ValueError(f"{n} samples cannot form {nbatches} batches")
    n_used = bs * nbatches
    step = make_train_step(optimizer, loss)
    params = list(flow.parameters())
    if opt_state is None:
        opt_state = optimizer.init(params)
    dev = samples.device
    losses = torch.empty(nepochs * nbatches, device=dev)
    if val is not None:
        val_hist = torch.empty(nepochs, device=dev)
        best = [p.detach().clone() for p in params]
        best_vl = torch.tensor(math.inf, device=dev)
        best_ep = torch.tensor(-1, device=dev)
    for epoch in range(nepochs):
        rows = (samples[:n_used] if epoch_perm is None
                else samples[epoch_perm(epoch)[:n_used]])
        batches = rows.reshape(nbatches, bs, -1)
        for b in range(nbatches):
            flow, opt_state, losses[epoch * nbatches + b] = step(
                flow, opt_state, batches[b])
        if val is not None:
            with torch.no_grad():
                vl = loss(flow, val)
                val_hist[epoch] = vl
                better = vl < best_vl
                for kept, p in zip(best, params):
                    kept.copy_(torch.where(better, p, kept))
                best_vl = torch.where(better, vl, best_vl)
                best_ep = torch.where(better, epoch, best_ep)
    _check_finite_loss(losses)
    if val is None:
        return TrainResult(flow, opt_state, losses)
    with torch.no_grad():
        for p, kept in zip(params, best):
            p.copy_(kept)
    return TrainResult(flow, opt_state, losses, val_hist, best_ep)


def optimize_flow(
    generator: torch.Generator,
    samples: torch.Tensor,
    flow: Bijector,
    optimizer: Optional[Adam] = None,
    loss: Callable = negll_flow_loss,
    nbatches: int = 10,
    nepochs: int = 100,
    shuffle_samples: bool = True,
    opt_state=None,
    val_frac: float = 0.0,
) -> TrainResult:
    """Train `flow` on an (N, d) sample matrix by minibatch steps of
    `optimizer` (default `Adam(1e-3)`) on `loss(flow, batch)`: `nepochs`
    epochs of `nbatches` batches of N // nbatches rows, the rows
    reshuffled every epoch from `generator` when `shuffle_samples`.

    `val_frac > 0` enables early stopping: that fraction of the samples
    (drawn from `generator`) is held out, the held-out loss is evaluated
    once per epoch, and `result` carries the parameters of the best
    epoch, with the final epoch's optimizer state; `val_hist` and
    `best_epoch` record the trajectory."""
    if optimizer is None:
        optimizer = Adam(1e-3)
    if samples.ndim != 2:
        raise ValueError(f"samples must be (N, d), got "
                         f"{tuple(samples.shape)}")
    dev = samples.device

    def perm(n):
        return torch.randperm(n, generator=generator,
                              device=generator.device).to(dev)

    val = None
    if val_frac > 0.0:
        samples, val = _split_validation(samples, val_frac,
                                         perm(samples.shape[0]))
    n = samples.shape[0]
    epoch_perm = (lambda _: perm(n)) if shuffle_samples else None
    return _fit_epochs(samples, val, flow, optimizer, loss, nbatches,
                       nepochs, epoch_perm, opt_state)


class _Frozen(Bijector):
    """A module evaluated through a stop-gradient copy of its parameters."""

    def __init__(self, inner: Bijector):
        super().__init__()
        self.inner = inner

    def forward_and_ladj(self, x):
        return call_with(self.inner, "forward_and_ladj",
                         detached(self.inner), x)

    def inverse_and_ladj(self, z):
        return call_with(self.inner, "inverse_and_ladj",
                         detached(self.inner), z)


def _freeze_all_but(chain: Chain, i: int) -> Chain:
    """The chain with every module but the i-th evaluated through detached
    parameters (sequential training)."""
    return Chain([t if j == i else _Frozen(t)
                  for j, t in enumerate(chain.transforms)])


def optimize_flow_sequentially(
    generator: torch.Generator,
    samples: torch.Tensor,
    flow: Chain,
    optimizer: Optional[Adam] = None,
    loss: Callable = negll_flow_loss,
    nbatches: int = 10,
    nepochs: int = 100,
    shuffle_samples: bool = True,
) -> TrainResult:
    """Train module by module, the others frozen, each module by a fresh
    `optimize_flow`; returns the flow with every module trained, the last
    fit's optimizer state and the concatenated loss history."""
    if optimizer is None:
        optimizer = Adam(1e-3)
    hists = []
    for i in range(len(flow.transforms)):
        res = optimize_flow(
            generator, samples, flow, optimizer,
            loss=lambda f, x, _i=i: loss(_freeze_all_but(f, _i), x),
            nbatches=nbatches, nepochs=nepochs,
            shuffle_samples=shuffle_samples)
        flow = res.result
        hists.append(res.loss_hist)
    return TrainResult(flow, res.optimizer_state, torch.cat(hists))


# ---------------------------------------------------------------------------
# Reverse KL against a density
# ---------------------------------------------------------------------------
def anneal_beta(i: int, anneal_steps: int) -> float:
    """The target temperature of step i: p(x)^beta with beta ramping from
    0.2 to 1 over the first `anneal_steps` steps, in float32 as the JAX
    package computes it; 1 without annealing."""
    if anneal_steps <= 0:
        return 1.0
    f = np.float32
    beta = f(0.2) + f(0.8) * f(i) / f(anneal_steps)
    return float(np.clip(beta, f(0.2), f(1.0)))


def _reverse_kl_steps(flow, log_density, optimizer, opt_state, draw_z,
                      nsteps, anneal_steps, stl, device) -> TrainResult:
    """`nsteps` reverse-KL steps, step i on the base draws `draw_z(i)` at
    temperature `anneal_beta(i, anneal_steps)`."""
    loss_fn = reverse_kl_stl_loss if stl else reverse_kl_loss
    step = make_train_step(
        optimizer, lambda f, zb: loss_fn(f, log_density, zb[0], zb[1]))
    if opt_state is None:
        opt_state = optimizer.init(list(flow.parameters()))
    losses = torch.empty(nsteps, device=device)
    for i in range(nsteps):
        flow, opt_state, losses[i] = step(
            flow, opt_state, (draw_z(i), anneal_beta(i, anneal_steps)))
    return TrainResult(flow, opt_state, losses)


def _base_draws(generator, batch_size, dim, device):
    return lambda _: torch.randn((batch_size, dim), generator=generator,
                                 device=device)


def make_reverse_kl_trainer(
    log_density: Callable,
    dim: int,
    optimizer: Adam,
    batch_size: int = 512,
    anneal_steps: int = 0,
    stl: bool = False,
    device="cuda",
):
    """Returns `train(generator, flow, nsteps, opt_state=None) ->
    TrainResult`. Each step draws z ~ N(0, I) of shape (batch_size, dim)
    from `generator` on `device` and takes one optimizer step on the
    reverse-KL loss (STL when `stl`), annealed over the first
    `anneal_steps` steps of each call (`anneal_beta`); a non-finite final
    loss raises."""
    dev = f32_device(device)

    def train(generator: torch.Generator, flow: Bijector, nsteps: int,
              opt_state: Optional[AdamState] = None) -> TrainResult:
        res = _reverse_kl_steps(
            flow, log_density, optimizer, opt_state,
            _base_draws(generator, batch_size, dim, dev), nsteps,
            anneal_steps, stl, dev)
        _check_finite_loss(res.loss_hist)
        return res

    return train


def optimize_flow_reverse_kl(
    generator: torch.Generator,
    log_density: Callable,
    flow: Bijector,
    dim: int,
    optimizer: Optional[Adam] = None,
    batch_size: int = 512,
    nsteps: int = 1000,
    anneal_steps: int = 0,
    opt_state=None,
    stl: bool = False,
    chunk_size: Optional[int] = None,
    device="cuda",
) -> TrainResult:
    """Reverse-KL (self-sampling) training against `log_density` with
    `optimizer` (default `Adam(1e-3)`): fresh base draws from `generator`
    every step. `anneal_steps` > 0 fits p(x)^beta with beta ramping 0.2 ->
    1 over the first `anneal_steps` steps; `stl` uses the
    sticking-the-landing estimator. `chunk_size` partitions the JAX
    package's scan into device programs and has no meaning here: it is
    accepted and ignored. As in the JAX package, a non-finite loss is not
    checked here."""
    del chunk_size
    if optimizer is None:
        optimizer = Adam(1e-3)
    dev = f32_device(device)
    return _reverse_kl_steps(
        flow, log_density, optimizer, opt_state,
        _base_draws(generator, batch_size, dim, dev), nsteps, anneal_steps,
        stl, dev)
