"""Sequential Monte Carlo with adaptive likelihood tempering, PyTorch port
of ``pioran_tpu.samplers.smc``.

A cloud of particles moves from the prior to the posterior through a
data-driven temperature ladder, and the evidence log Z is the sum of the
log mean incremental weights:

- each step solves ESS(dlambda) = target * N by a 50-step bisection;
- systematic resampling;
- moves: preconditioned random-walk Metropolis ("rwm") or MALA ("mala")
  in the prior's unconstrained space, the proposal covariance from the
  cloud, the scale adapted toward the move's optimal acceptance.

The likelihood and prior are batched functions, (N, dim) -> (N,), so a
sweep over the cloud is one call: on the card the likelihood without a
gradient is one K1 launch, and MALA's per-particle gradient (the gradient
of the summed objective, since the particles do not interact) runs K3
and K4. The JAX package's ``lax.while_loop`` over temper steps is a host
loop here, with one device->host sync a step to read the temperature.
Random numbers come from a ``torch.Generator``. ``run_smc_resumable``
writes the state and the generator's state every few temper steps and
resumes from them.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["SMCResult", "run_smc", "run_smc_resumable", "smc_init", "systematic_resample"]


class SMCResult(NamedTuple):
    particles: torch.Tensor  # (N, dim) unconstrained-space particles at lambda=1
    logZ: torch.Tensor
    num_steps: int
    log_evidence_path: torch.Tensor  # per-step increments (padded with 0)
    lambdas: torch.Tensor  # temperature after each step (padded with 1)
    acceptance: torch.Tensor  # mean move acceptance per step


def systematic_resample(generator: Optional[torch.Generator], log_weights, u=None):
    """Systematic resampling: indices with E[count_i] = N w_i. ``u`` is
    the one uniform draw in [0, 1); taken from ``generator`` when not
    given."""
    N = log_weights.shape[0]
    w = torch.exp(log_weights - torch.logsumexp(log_weights, 0))
    if u is None:
        u = torch.rand((), generator=generator, dtype=log_weights.dtype,
                       device=log_weights.device)
    arange = torch.arange(N, dtype=log_weights.dtype, device=log_weights.device)
    # a true division (torch divides by a Python scalar through its
    # reciprocal, which can move a position across a cumsum boundary)
    positions = (u + arange) / torch.full_like(arange, N)
    cumsum = torch.cumsum(w, 0)
    # force the final cumsum to 1 so searchsorted stays in range
    cumsum = cumsum / cumsum[-1]
    idx = torch.searchsorted(cumsum, positions, right=False)
    # with no finite weight the cumsum is NaN: torch's searchsorted then
    # gives N, out of range, where the JAX package's gives 0
    return torch.where(torch.isnan(cumsum[-1]), torch.zeros_like(idx), idx)


def _ess_fraction(log_w):
    w = torch.exp(log_w - torch.max(log_w))
    return torch.sum(w) ** 2 / (torch.sum(w * w) * log_w.shape[0])


def _find_dlambda(loglikes, lam, target_ess: float, num_bisect: int = 50):
    """Largest dlambda in (0, 1 - lam] with ESS fraction >= target, on the
    device: no host sync."""
    hi = 1.0 - lam
    ok_full = _ess_fraction(hi * loglikes) >= target_ess
    lo_b, hi_b = torch.zeros_like(hi), hi
    for _ in range(num_bisect):
        mid = 0.5 * (lo_b + hi_b)
        good = _ess_fraction(mid * loglikes) >= target_ess
        lo_b, hi_b = torch.where(good, mid, lo_b), torch.where(good, hi_b, mid)
    dl = torch.where(ok_full, hi, lo_b)
    # never stall: take at least a tiny step
    return torch.maximum(dl, 1e-6 * (1.0 - lam) + 1e-12)


def _default_scale(dim: int, move: str, dtype, device=None):
    if move == "mala":
        return torch.tensor(1.65 / dim ** (1.0 / 6.0), dtype=dtype, device=device)
    return torch.tensor(2.38 / math.sqrt(dim), dtype=dtype, device=device)


def _finite_or_zero(x):
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def smc_init(loglike_batch_fn: Callable, prior_logpdf_fn: Callable, particles0,
             max_steps: int = 200, rw_scale=None, move: str = "rwm") -> dict:
    """The initial SMC state from prior draws (N, dim): particles, their
    log-likelihoods and log-priors, lambda = logZ = 0, the step count,
    the histories and the move scale."""
    dtype, dev = particles0.dtype, particles0.device
    dim = particles0.shape[-1]
    with torch.no_grad():
        loglikes0 = loglike_batch_fn(particles0)
        logpriors0 = prior_logpdf_fn(particles0)
    scale0 = (_default_scale(dim, move, dtype, dev) if rw_scale is None
              else torch.tensor(rw_scale, dtype=dtype, device=dev))
    zero = torch.zeros((), dtype=dtype, device=dev)
    return {
        "particles": particles0, "loglikes": loglikes0, "logpriors": logpriors0,
        "lam": zero, "logZ": zero.clone(), "i": 0,
        "incr": torch.zeros(max_steps, dtype=dtype, device=dev),
        "lams": torch.ones(max_steps, dtype=dtype, device=dev),
        "accs": torch.zeros(max_steps, dtype=dtype, device=dev),
        "scale": scale0,
    }


def _make_step(loglike_batch_fn, prior_logpdf_fn, N: int, dim: int, num_moves: int,
               target_ess: float, move: str):
    target_acc = 0.574 if move == "mala" else 0.234

    def grad_post(Z, lam):
        """Per-particle gradients of the tempered log-posterior: the
        gradient of the summed batched objective (the particles do not
        interact), through the batched likelihood's adjoint."""
        Z = Z.detach().requires_grad_(True)
        with torch.enable_grad():
            obj = torch.sum(lam * loglike_batch_fn(Z)) + torch.sum(prior_logpdf_fn(Z))
            (g,) = torch.autograd.grad(obj, Z)
        return g

    def move_rwm(gen, particles, loglikes, logpriors, grads, lam, chol, scale):
        """One preconditioned random-walk Metropolis sweep at temperature lam."""
        eps = torch.randn(particles.shape, generator=gen, dtype=particles.dtype,
                          device=particles.device)
        prop = particles + scale * (eps @ chol.T)
        with torch.no_grad():
            ll_prop = loglike_batch_fn(prop)
            lp_prop = prior_logpdf_fn(prop)
        log_alpha = lam * (ll_prop - loglikes) + (lp_prop - logpriors)
        u = torch.rand((N,), generator=gen, dtype=particles.dtype, device=particles.device)
        accept = torch.log(u) < log_alpha
        particles = torch.where(accept[:, None], prop, particles)
        loglikes = torch.where(accept, ll_prop, loglikes)
        logpriors = torch.where(accept, lp_prop, logpriors)
        return particles, loglikes, logpriors, grads, torch.mean(accept.to(particles.dtype))

    def move_mala(gen, particles, loglikes, logpriors, grads, lam, chol, scale):
        """Preconditioned MALA sweep: proposal N(z + s^2/2 Sig g, s^2 Sig)."""
        s2 = scale * scale
        Sig_g = (grads @ chol) @ chol.T  # Sig = chol chol^T (cloud covariance)
        mean_fwd = particles + 0.5 * s2 * Sig_g
        eps = torch.randn(particles.shape, generator=gen, dtype=particles.dtype,
                          device=particles.device)
        prop = mean_fwd + scale * (eps @ chol.T)

        with torch.no_grad():
            ll_prop = loglike_batch_fn(prop)
            lp_prop = prior_logpdf_fn(prop)
        g_prop = _finite_or_zero(grad_post(prop, lam))
        mean_bwd = prop + 0.5 * s2 * (g_prop @ chol) @ chol.T

        # log q(z' | z) = -||chol^{-1}(z' - mean_fwd)||^2 / (2 s^2) + const
        def logq(x, mean):
            r = torch.linalg.solve_triangular(chol, (x - mean).T, upper=False).T
            return -0.5 * torch.sum(r * r, dim=-1) / s2

        log_alpha = (lam * (ll_prop - loglikes) + (lp_prop - logpriors)
                     + logq(particles, mean_bwd) - logq(prop, mean_fwd))
        u = torch.rand((N,), generator=gen, dtype=particles.dtype, device=particles.device)
        accept = torch.log(u) < log_alpha
        particles = torch.where(accept[:, None], prop, particles)
        loglikes = torch.where(accept, ll_prop, loglikes)
        logpriors = torch.where(accept, lp_prop, logpriors)
        grads = torch.where(accept[:, None], g_prop, grads)
        return particles, loglikes, logpriors, grads, torch.mean(accept.to(particles.dtype))

    move_once = move_mala if move == "mala" else move_rwm

    def step(state: dict, gen: torch.Generator) -> dict:
        particles, loglikes, logpriors = state["particles"], state["loglikes"], state["logpriors"]
        lam, logZ, i, scale = state["lam"], state["logZ"], state["i"], state["scale"]
        dtype = particles.dtype

        dl = _find_dlambda(loglikes, lam, target_ess)
        log_w = dl * loglikes
        incr = torch.logsumexp(log_w, 0) - math.log(N)
        logZ = logZ + incr
        lam = lam + dl

        idx = systematic_resample(gen, log_w)
        particles, loglikes, logpriors = particles[idx], loglikes[idx], logpriors[idx]

        # adapt the proposal to the current cloud; a failed factorization
        # gives NaN, as jnp.linalg.cholesky does (no jitter is added)
        cov = torch.cov(particles.T) + 1e-10 * torch.eye(dim, dtype=dtype, device=particles.device)
        chol, info = torch.linalg.cholesky_ex(cov)
        chol = torch.where(info == 0, chol, torch.full_like(chol, math.nan))

        if move == "mala":
            grads = _finite_or_zero(grad_post(particles, lam))
        else:
            grads = torch.zeros_like(particles)

        acc = torch.zeros((), dtype=dtype, device=particles.device)
        for _ in range(num_moves):
            particles, loglikes, logpriors, grads, a = move_once(
                gen, particles, loglikes, logpriors, grads, lam, chol, scale)
            acc = acc + a
        acc_mean = acc / num_moves

        # Robbins-Monro scale adaptation toward the move's optimal acceptance
        scale = torch.clamp(scale * torch.exp(acc_mean - target_acc), 1e-3, 1e2).to(dtype)

        incr_hist, lam_hist, acc_hist = (state[k].clone() for k in ("incr", "lams", "accs"))
        incr_hist[i], lam_hist[i], acc_hist[i] = incr, lam, acc_mean
        return {"particles": particles, "loglikes": loglikes, "logpriors": logpriors,
                "lam": lam, "logZ": logZ, "i": i + 1, "incr": incr_hist,
                "lams": lam_hist, "accs": acc_hist, "scale": scale}

    return step


def run_smc(
    loglike_batch_fn: Callable,
    prior_logpdf_fn: Callable,
    particles0,
    generator: torch.Generator,
    num_moves: int = 5,
    target_ess: float = 0.8,
    max_steps: int = 200,
    rw_scale: Optional[float] = None,
    move: str = "rwm",
) -> SMCResult:
    """Adaptive-tempering SMC from prior samples to the posterior.

    ``particles0``: (N, dim) prior draws in unconstrained space;
    ``loglike_batch_fn`` and ``prior_logpdf_fn`` map (N, dim) to (N,).
    With ``move="mala"`` the likelihood must be differentiable: each sweep
    takes every particle's gradient from one backward of the summed
    objective. ``move``: "rwm" (gradient-free) or "mala" (preconditioned
    Langevin moves, far better mixing along posterior ridges). The scale
    adapts between temper steps toward 0.234 (rwm) or 0.574 (mala)
    acceptance. Random numbers come from ``generator`` (on the particles'
    device). Returns :class:`SMCResult` with the log-evidence estimate.
    """
    return _run(loglike_batch_fn, prior_logpdf_fn, particles0, generator, num_moves,
                target_ess, max_steps, rw_scale, move)


def run_smc_resumable(
    loglike_batch_fn: Callable,
    prior_logpdf_fn: Callable,
    particles0,
    generator: torch.Generator,
    checkpoint_dir: str,
    num_moves: int = 5,
    target_ess: float = 0.8,
    max_steps: int = 200,
    rw_scale: Optional[float] = None,
    save_every: int = 1,
    max_to_keep: int = 2,
    move: str = "rwm",
) -> SMCResult:
    """:func:`run_smc` with checkpoint and resume, ultranest-style.

    After every ``save_every`` temper steps the whole state (particles,
    their log-likelihoods and log-priors, temperature, logZ, step count,
    histories, move scale) and ``generator``'s state are written to
    ``checkpoint_dir`` (``checkpoint.CheckpointManager``, keeping
    ``max_to_keep``). Run again with the same directory, it resumes from
    the last finished step. A run that is not interrupted gives exactly
    what :func:`run_smc` gives with the same generator, and so does a
    resumed one.
    """
    from ..checkpoint import CheckpointManager

    mgr = CheckpointManager(checkpoint_dir, max_to_keep=max_to_keep, save_every=save_every)
    return _run(loglike_batch_fn, prior_logpdf_fn, particles0, generator, num_moves,
                target_ess, max_steps, rw_scale, move, mgr)


def _run(loglike_batch_fn, prior_logpdf_fn, particles0, generator, num_moves, target_ess,
         max_steps, rw_scale, move, mgr=None) -> SMCResult:
    """The temper loop of :func:`run_smc`; with a checkpoint manager it
    starts from the latest checkpoint and saves after each step."""
    if move not in ("rwm", "mala"):
        raise ValueError(f"move must be 'rwm' or 'mala', got {move!r}")
    N, dim = particles0.shape
    step = _make_step(loglike_batch_fn, prior_logpdf_fn, N, dim, num_moves, target_ess, move)
    state = smc_init(loglike_batch_fn, prior_logpdf_fn, particles0, max_steps=max_steps,
                     rw_scale=rw_scale, move=move)
    if mgr is not None:
        restored = mgr.restore({"state": state, "generator": generator})
        if restored is not None:
            state = restored[0]["state"]
    # the one host sync of a temper step: is lambda at 1 yet?
    while state["i"] < max_steps and float(state["lam"]) < 1.0:
        state = step(state, generator)
        if mgr is not None:
            mgr.save({"state": state, "generator": generator}, state["i"])
    return SMCResult(
        particles=state["particles"], logZ=state["logZ"], num_steps=state["i"],
        log_evidence_path=state["incr"], lambdas=state["lams"], acceptance=state["accs"])
