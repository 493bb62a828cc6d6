"""Mean-field ADVI, PyTorch port of ``pioran_tpu.samplers.advi``.

q(z) = N(mu, diag(exp(log_sigma)^2)) over the unconstrained parameters z
(the PriorSet bijectors supply the transform and its log-Jacobian). Each
optimizer step estimates the reparameterized ELBO from ``num_mc`` draws
in one batched log-posterior call, so on the card one step is one
value+gradient sweep of the likelihood kernels. Adam with a cosine-decay
learning rate (optax's ``cosine_decay_schedule`` with ``alpha=0.05``, as
in the JAX package) via ``torch.optim.Adam`` and ``LambdaLR``.

The entropy of q is analytic, so
  ELBO = E_q[logpost(z)] + sum(log_sigma) + D/2 (1 + log 2 pi),
which also lower-bounds the evidence logZ.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

__all__ = ["ADVIResult", "run_advi", "elbo"]


class ADVIResult(NamedTuple):
    """Fit result: variational parameters, ELBO trace, posterior draws."""

    mu: torch.Tensor          # (D,) variational mean (unconstrained space)
    log_sigma: torch.Tensor   # (D,) variational log-stddev
    elbo_trace: torch.Tensor  # (num_steps,) ELBO estimate per step
    samples: torch.Tensor     # (num_draws, D) draws from q (unconstrained)
    logZ_lower: torch.Tensor  # final ELBO, a lower bound on log-evidence


def elbo(logpost_batch: Callable, mu, log_sigma, generator, num_mc: int = 8):
    """Reparameterized ELBO estimate with analytic Gaussian entropy.

    ``logpost_batch`` maps (num_mc, D) to (num_mc,). A -inf draw (the
    prior's rejection region) would poison the gradient, so such draws
    count as the worst finite draw of the batch.
    """
    D = mu.shape[0]
    eps = torch.randn((num_mc, D), generator=generator, dtype=mu.dtype, device=mu.device)
    lp = logpost_batch(mu + torch.exp(log_sigma) * eps)
    finite = torch.isfinite(lp)
    worst = torch.where(finite, lp, torch.full_like(lp, math.inf)).amin()
    worst = torch.where(finite.any(), worst, torch.full_like(worst, math.nan))
    lp = torch.where(finite, lp, worst)
    entropy = torch.sum(log_sigma) + 0.5 * D * (1.0 + math.log(2.0 * math.pi))
    return torch.mean(lp) + entropy


def _cosine_decay(num_steps: int, alpha: float):
    """optax.cosine_decay_schedule's multiplier of the initial rate."""
    def factor(step: int) -> float:
        frac = min(step, num_steps) / num_steps
        return (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha
    return factor


def run_advi(
    logpost_batch: Callable,
    z0,
    generator: torch.Generator,
    num_steps: int = 2000,
    num_mc: int = 8,
    learning_rate: float = 5e-2,
    num_draws: int = 1000,
    init_log_sigma: float = -2.0,
) -> ADVIResult:
    """Fit mean-field ADVI to the batched unconstrained log-posterior
    ``logpost_batch`` ((M, D) -> (M,)).

    ``z0`` (D,) initializes the variational mean. Random numbers come
    from ``generator``, on ``z0``'s device. A step whose loss or
    gradient is not finite applies a zero gradient, as the JAX package
    does (Adam's moments still decay). Returns draws from the fitted q,
    ready for ``PriorSet.from_unconstrained``.
    """
    z0 = torch.as_tensor(z0)
    D = z0.shape[0]
    mu = z0.detach().clone().requires_grad_(True)
    log_sigma = torch.full((D,), init_log_sigma, dtype=z0.dtype,
                           device=z0.device).requires_grad_(True)
    opt = torch.optim.Adam([mu, log_sigma], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, _cosine_decay(num_steps, 0.05))
    trace = []
    for _ in range(num_steps):
        opt.zero_grad(set_to_none=False)
        value = elbo(logpost_batch, mu, log_sigma, generator, num_mc)
        (-value).backward()
        # no host sync: a non-finite batch zeroes the gradient on device
        ok = torch.isfinite(value) & torch.isfinite(mu.grad).all() \
            & torch.isfinite(log_sigma.grad).all()
        for p in (mu, log_sigma):
            p.grad = torch.where(ok, p.grad, torch.zeros_like(p.grad))
        opt.step()
        sched.step()
        trace.append(value.detach())
    mu, log_sigma = mu.detach(), log_sigma.detach()
    eps = torch.randn((num_draws, D), generator=generator, dtype=mu.dtype, device=mu.device)
    samples = mu + torch.exp(log_sigma) * eps
    with torch.no_grad():
        logZ_lower = elbo(logpost_batch, mu, log_sigma, generator, num_mc=64)
    return ADVIResult(mu=mu, log_sigma=log_sigma,
                      elbo_trace=torch.stack(trace) if trace else mu.new_zeros(0),
                      samples=samples, logZ_lower=logZ_lower)
