"""Vectorised nested sampling, PyTorch port of ``pioran_tpu.samplers.ns``.

K live points stay on the device. Every iteration the worst
``n_delete`` points die together and their replacements run as
``n_delete`` parallel threshold-constrained walks (slice sampling by
default), each of whose likelihood sweeps is one batched call of width
``n_delete``. The iteration loop runs on the host with one device->host
sync per iteration, for the stop test.

- Works in the unit cube; the caller's likelihood applies the prior
  transform.
- Shrinkage uses the exact expectation for batched deletion; evidence
  accumulates trapezoid weights on the dead sequence, and the final
  live set enters with equal weight X_final / K.
- logZ error is sqrt(H / K), with H the information.

The state is a 13-tuple in the JAX package's order, with a
``torch.Generator`` in place of the PRNG key and Python ints for the
iteration and call counts. The step writes the dead buffers in place
instead of copying them.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["NSResult", "run_ns", "equal_weight_indices"]


class NSResult(NamedTuple):
    dead_u: torch.Tensor      # (max_dead, dim) dead points, unit cube, sorted order
    dead_logl: torch.Tensor   # (max_dead,) their log-likelihoods
    dead_logw: torch.Tensor   # (max_dead,) log prior-volume weights (no L factor)
    num_dead: int             # how many entries of the buffers are valid
    logZ: torch.Tensor
    logZ_err: torch.Tensor
    H: torch.Tensor           # information (nats)
    num_iters: int
    ncall: int                # likelihood evaluations
    acceptance: torch.Tensor  # final walker acceptance rate
    logl_max: torch.Tensor
    insert_ranks: torch.Tensor  # (max_iters * n_delete,) insertion ranks
    #   among the K - n_delete survivors; -1 beyond num_iters * n_delete.
    #   Feed to utils.insertion.insertion_order_test.


def run_ns(
    loglike_u_batch: Callable,
    generator: torch.Generator,
    num_live: int = 1024,
    dim: int = 1,
    n_delete: int = 128,
    num_mcmc: int = 32,
    max_iters: int = 2000,
    frac_remain: float = 1e-2,
    move: str = "slice",
    n_expand: int = 4,
    n_shrink: int = 8,
    dtype: torch.dtype = torch.float64,
) -> NSResult:
    """Nested sampling of ``loglike_u_batch`` ((B, dim) unit cube -> (B,)).

    Runs on ``generator``'s device. ``n_delete`` points are replaced per
    iteration, each by a constrained walk started from a random
    survivor. Stops when the live set's remaining evidence is below
    ``frac_remain`` of the accumulated evidence, or at ``max_iters``.

    ``move``: ``"slice"`` (``num_mcmc`` slice updates along random
    live-cloud-preconditioned directions, Neal step-out and shrink;
    2 ``n_expand`` + ``n_shrink`` sweeps each) or ``"rwm"``
    (``num_mcmc`` preconditioned random-walk Metropolis steps, one sweep
    each). Posterior samples: :func:`equal_weight_indices`.
    """
    K, D = num_live, n_delete
    device = generator.device
    live_u = torch.rand((K, dim), generator=generator, dtype=dtype, device=device)
    # in sweeps of width n_delete, like every later sweep
    live_logl = torch.cat([loglike_u_batch(live_u[i:i + D]) for i in range(0, K, D)])

    step = _make_ns_step(loglike_u_batch, K, D, dim, dtype, num_mcmc, move,
                         n_expand, n_shrink)
    state = _ns_init_state(live_u, live_logl, generator, K, D, dim, dtype,
                           max_iters, move)
    log_frac = math.log(frac_remain)
    while state[4] < max_iters:
        live_logl, logX, logZ = state[1], state[2], state[3]
        logZ_live = torch.logsumexp(live_logl, 0) - math.log(K) + logX
        if state[4] > 0 and not bool(logZ_live - logZ > log_frac):
            break
        state = step(state)
    return _ns_finalize(state, K, D)


def _ns_init_state(live_u, live_logl, generator, K, D, dim, dtype, max_iters,
                   move):
    """Initial NS state tuple."""
    device = live_u.device
    max_dead = max_iters * D + K  # dead rows + the final live set
    full = lambda shape, v: torch.full(shape, v, dtype=dtype, device=device)  # noqa: E731
    scale0 = 1.0 if move == "slice" else 2.0 / math.sqrt(dim)
    return (
        live_u, live_logl, full((), 0.0), full((), -math.inf),
        0, generator,
        torch.zeros((max_dead, dim), dtype=dtype, device=device),
        full((max_dead,), -math.inf), full((max_dead,), -math.inf),
        full((), scale0), full((), 0.0), K,
        full((max_iters * D,), -1.0),
    )


def _make_ns_step(loglike_u_batch, K, D, dim, dtype, num_mcmc, move,
                  n_expand, n_shrink):
    """One NS iteration as a state -> state function."""
    # Exact expected shrinkage for batched deletion: the i-th deletion
    # within a batch removes the worst of K-i+1 uniform points, so
    # E[ln t_i] = -1/(K-i+1); after j deletions ln x_j = -(H_K - H_{K-j}).
    Hk = np.concatenate([[0.0], np.cumsum(1.0 / np.arange(1, K + 1))])
    lnx = -(Hk[K] - Hk[K - np.arange(0, D + 1)])  # after 0..D deletions
    logw_step_np = np.log(np.exp(lnx[:-1]) - np.exp(lnx[1:]))
    dlogX = float(lnx[D])
    evals_per = (2 * n_expand + n_shrink) if move == "slice" else 1

    def step(state):
        (live_u, live_logl, logX, logZ, it, gen,
         dead_u, dead_logl, dead_logw, scale, acc_prev, ncall,
         ranks) = state
        dev = live_u.device
        logw_step = torch.as_tensor(logw_step_np, dtype=dtype, device=dev)

        # ---- delete the D worst, record them in ascending-L order ----
        order = torch.argsort(live_logl, stable=True)  # as jnp.argsort
        dead_idx, survivors = order[:D], order[D:]
        dying_u, dying_logl = live_u[dead_idx], live_logl[dead_idx]
        # threshold = highest dead likelihood: replacements are uniform
        # in the volume above it, the X e^{-D/K} the shrinkage assumes
        logl_star = dying_logl[-1]

        logw = logX + logw_step
        row = it * D
        dead_u[row:row + D] = dying_u
        dead_logl[row:row + D] = dying_logl
        dead_logw[row:row + D] = logw

        logZ = torch.logaddexp(logZ, torch.logsumexp(logw + dying_logl, 0))
        logX = logX + dlogX

        # ---- replacements: D constrained walkers from random survivors ----
        start = survivors[torch.randint(0, K - D, (D,), generator=gen, device=dev)]
        walk_u, walk_logl = live_u[start], live_logl[start]

        # precondition with the live-cloud covariance (unit-cube space)
        cov = torch.cov(live_u[survivors].T, correction=1).reshape(dim, dim)
        cov = cov + 1e-12 * torch.eye(dim, dtype=dtype, device=dev)
        chol = torch.linalg.cholesky_ex(cov).L  # no sync for the check

        def eval_constrained(prop):
            """(D, dim) -> (loglike, satisfies L > L* and inside the cube)."""
            inside = torch.all((prop > 0.0) & (prop < 1.0), dim=-1)
            pl = loglike_u_batch(torch.clamp(prop, 1e-9, 1.0 - 1e-9))
            return pl, inside & (pl > logl_star)

        def randn(shape):
            return torch.randn(shape, generator=gen, dtype=dtype, device=dev)

        def rand(shape):
            return torch.rand(shape, generator=gen, dtype=dtype, device=dev)

        def one_rwm_step(wu, wl):
            prop = wu + scale * (randn(wu.shape) @ chol.T)
            pl, ok = eval_constrained(prop)
            wu = torch.where(ok[:, None], prop, wu)
            wl = torch.where(ok, pl, wl)
            return wu, wl, torch.mean(ok.to(dtype))

        def one_slice_step(wu, wl):
            """One Neal slice update per walker along a random
            cloud-preconditioned direction: step-out then shrink. The
            constrained target is flat, so the slice is
            {s : L(u + s v) > L*} within the cube."""
            v = randn(wu.shape) @ chol.T  # (D, dim)
            r = rand((D,))
            lo, hi = -scale * r, scale * (1.0 - r)
            for _ in range(n_expand):
                _, ok_lo = eval_constrained(wu + lo[:, None] * v)
                _, ok_hi = eval_constrained(wu + hi[:, None] * v)
                lo = torch.where(ok_lo, lo - scale, lo)
                hi = torch.where(ok_hi, hi + scale, hi)
            wu_c, wl_c = wu, wl
            done = torch.zeros((D,), dtype=torch.bool, device=dev)
            for _ in range(n_shrink):
                s = lo + (hi - lo) * rand((D,))
                prop = wu + s[:, None] * v
                pl, ok = eval_constrained(prop)
                take = ok & ~done
                wu_c = torch.where(take[:, None], prop, wu_c)
                wl_c = torch.where(take, pl, wl_c)
                done = done | ok
                fail = ~done
                lo = torch.where(fail & (s < 0), s, lo)
                hi = torch.where(fail & (s >= 0), s, hi)
            return wu_c, wl_c, torch.mean(done.to(dtype))

        one_move = one_slice_step if move == "slice" else one_rwm_step
        acc = torch.zeros((), dtype=dtype, device=dev)
        for _ in range(num_mcmc):
            walk_u, walk_logl, a = one_move(walk_u, walk_logl)
            acc = acc + a
        acc_rate = acc / num_mcmc
        ncall = ncall + D * num_mcmc * evals_per

        # insertion-order diagnostic: each replacement's rank among the
        # K - D survivors' likelihoods (uniform on {0..K-D} when the
        # constrained walks have converged)
        surv_logl = live_logl[survivors]
        new_ranks = torch.sum(surv_logl[None, :] < walk_logl[:, None], dim=1)
        ranks[row:row + D] = new_ranks.to(dtype)

        live_u = torch.cat([live_u[survivors], walk_u], dim=0)
        live_logl = torch.cat([surv_logl, walk_logl], dim=0)

        if move != "slice":
            # Robbins-Monro toward ~37% acceptance for the walk
            scale = torch.clamp(scale * torch.exp(acc_rate - 0.37), 1e-4, 1.0)

        return (live_u, live_logl, logX, logZ, it + 1, gen,
                dead_u, dead_logl, dead_logw, scale, acc_rate, ncall, ranks)

    return step


def _ns_finalize(state, K, D) -> NSResult:
    """Fold the final live set into the evidence and build the result."""
    (live_u, live_logl, logX, logZ, it, _gen,
     dead_u, dead_logl, dead_logw, _scale, acc_rate, ncall, ranks) = state
    dev = live_logl.device
    max_dead = dead_logl.shape[0]

    # each of the K survivors carries weight X_final / K
    order = torch.argsort(live_logl, stable=True)
    live_logw = (logX - math.log(K)).expand(K)
    logZ_final = torch.logaddexp(
        logZ, torch.logsumexp(live_logw + live_logl[order], 0))

    # append the final live set to the dead buffers (sized max_iters * D
    # + K, so this never clobbers dead rows)
    n_dead = it * D
    dead_u, dead_logl, dead_logw = dead_u.clone(), dead_logl.clone(), dead_logw.clone()
    dead_u[n_dead:n_dead + K] = live_u[order]
    dead_logl[n_dead:n_dead + K] = live_logl[order]
    dead_logw[n_dead:n_dead + K] = live_logw

    # information H = sum_i P_i ln L_i - ln Z, on the normalised masses
    valid = torch.arange(max_dead, device=dev) < n_dead + K
    ninf = torch.full_like(dead_logl, -math.inf)
    logP = torch.where(valid, dead_logl + dead_logw, ninf) - logZ_final
    P = torch.exp(logP)
    H = torch.sum(torch.where(valid & torch.isfinite(dead_logl), P * dead_logl,
                              torch.zeros_like(P))) - logZ_final
    logZ_err = torch.sqrt(torch.clamp(H, min=0.0) / K)

    return NSResult(
        dead_u=dead_u, dead_logl=dead_logl, dead_logw=dead_logw,
        num_dead=n_dead + K, logZ=logZ_final, logZ_err=logZ_err, H=H,
        num_iters=it, ncall=ncall, acceptance=acc_rate,
        logl_max=torch.max(live_logl), insert_ranks=ranks,
    )


def equal_weight_indices(dead_logl, dead_logw, num_dead: int, num_samples: int,
                         generator: Optional[torch.Generator] = None, u0=None):
    """Systematic-resample indices into the dead buffer by posterior mass.

    Rows past ``num_dead`` carry no weight and are never selected. The
    systematic offset is ``u0`` when given (a float in [0, 1)), else one
    uniform draw from ``generator``.
    """
    dev, dtype = dead_logl.device, dead_logl.dtype
    logp = dead_logl + dead_logw
    valid = torch.arange(logp.shape[0], device=dev) < num_dead
    logp = torch.where(valid & torch.isfinite(logp), logp, torch.full_like(logp, -math.inf))
    w = torch.exp(logp - torch.logsumexp(logp, 0))
    w = w / torch.sum(w)
    if u0 is None:
        u0 = torch.rand((), generator=generator, dtype=dtype, device=dev)
    positions = (u0 + torch.arange(num_samples, dtype=dtype, device=dev)) / num_samples
    cumsum = torch.cumsum(w, 0)
    cumsum = cumsum / cumsum[-1]
    return torch.searchsorted(cumsum, positions, right=False)
