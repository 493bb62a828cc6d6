"""Samplers sharded over a device mesh, PyTorch port of
``pioran_tpu.parallel.sharded``.

The JAX package runs these under ``shard_map`` and GSPMD from one
process. Here every rank of the mesh's process group calls the same
function with the same arguments (the global batch, a generator seeded
alike on every rank), keeps its own slice of the batch on its own device,
and the ranks meet in ``torch.distributed`` collectives: ``all_gather``
of per-particle values, ``all_reduce`` of cross-chain sums. Every rank
returns the same results. On the card each rank's likelihood sweeps are
launches of the hand-written kernels at the width of its slice.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..samplers.chees import ChainAxis, run_chees
from ..samplers.ns import run_ns
from ..samplers.nuts import run_nuts
from ..samplers.smc import SMCResult, _find_dlambda, systematic_resample
from .mesh import axis_group, check_device

__all__ = ["run_nuts_sharded", "run_smc_sharded", "run_ns_sharded",
           "run_chees_sharded", "sharded_batched_fn"]


def _gather(x, group, n: int):
    """Every rank's ``x`` concatenated along dim 0, in rank order."""
    kind = x.dtype
    x = (x.to(torch.uint8) if kind == torch.bool else x).contiguous()
    out = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(out, x, group=group)
    return torch.cat(out, dim=0).to(kind)


def _allreduce(x, group):
    """The sum of ``x`` over the group's ranks, in a new tensor."""
    x = x.detach().clone().contiguous()
    dist.all_reduce(x, group=group)
    return x


def _shard(mesh, axis_name, total: int, device, what: str):
    """(group, rank, ranks, lo, hi): this rank's rows [lo, hi) of a batch
    of ``total`` rows sharded over the axis."""
    check_device(mesh, device, what)
    group, r, n = axis_group(mesh, axis_name)
    if total % n:
        raise ValueError(f"{what}: {total} rows not divisible by {n} devices")
    m = total // n
    return group, r, n, r * m, (r + 1) * m


def _rank_generator(generator: torch.Generator, rank: int) -> torch.Generator:
    """A generator of this rank's own stream: seeded from one draw of the
    replicated ``generator`` and the rank, the analog of JAX's
    ``fold_in(key, axis_index)``."""
    seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=generator.device))
    mixed = np.random.SeedSequence([seed, rank]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=generator.device).manual_seed(int(mixed) >> 1)


def sharded_batched_fn(batch_fn: Callable, mesh, axis_name: str):
    """Shard a (B, ...) -> (B,) batched function's batch axis over the mesh.

    Rank r evaluates rows [r B/n, (r + 1) B/n) of the batch, one call of
    ``batch_fn`` at width B/n (one K1 launch on its card), and an
    ``all_gather`` returns the full (B,) on every rank: the analog of
    ultranest farming likelihood batches over MPI ranks. B must be
    divisible by the axis size. No gradient flows through the gather, so
    the returned function refuses inputs that require one.
    """

    def wrapped(U):
        if U.requires_grad:
            raise ValueError("sharded_batched_fn carries no gradient; "
                             "the gradient samplers shard the chains instead")
        group, _, n, lo, hi = _shard(mesh, axis_name, U.shape[0], U.device, "the batch")
        return _gather(batch_fn(U[lo:hi]), group, n)

    return wrapped


def run_ns_sharded(loglike_u_batch: Callable, generator: torch.Generator, mesh,
                   axis_name: str = "particles", **ns_kwargs):
    """Nested sampling with its likelihood sweeps sharded over the mesh.

    Nested sampling's control flow (sorting K scalars, evidence
    bookkeeping) is cheap; the cost is the batched sweeps of width
    ``n_delete``. So ``run_ns`` runs replicated on every rank, from the
    same ``generator`` seed, and only its sweeps fan out over the axis
    (:func:`sharded_batched_fn`): the replacement for ultranest's MPI
    worker farm. Every rank evaluates the same rows as an unsharded run,
    so the result is the unsharded one. ``n_delete`` and ``num_live``
    must be divisible by the axis size.
    """
    _, _, n = axis_group(mesh, axis_name)
    for name, default in (("n_delete", 128), ("num_live", 1024)):
        if ns_kwargs.get(name, default) % n:
            raise ValueError(f"{name}={ns_kwargs.get(name, default)} not divisible "
                             f"by {n} devices")
    check_device(mesh, generator.device, "the generator")
    return run_ns(sharded_batched_fn(loglike_u_batch, mesh, axis_name), generator,
                  **ns_kwargs)


class _ShardedChains(ChainAxis):
    """A chain axis whose rows are spread over the ranks of ``group``."""

    def __init__(self, total, lo, hi, group):
        super().__init__(total, lo, hi)
        self.group = group

    def allreduce(self, x):
        return _allreduce(x, self.group)


def run_chees_sharded(logp_batch: Callable, z0, generator: torch.Generator, mesh,
                      axis_name="chains", **chees_kwargs):
    """ChEES-HMC with the chain axis sharded over the mesh.

    Each rank runs its C/n chains (``logp_batch`` on its own rows: one
    K3/K4 sweep at width C/n on its card). Every cross-chain statistic of
    the sampler (chain means, the ChEES and accept-rate sums, the
    metric's variance or covariance) is all-reduced over the axis, and
    each random draw is drawn for all C chains from the replicated
    ``generator`` and sliced, so the run is the unsharded one up to the
    order of the reductions, as the JAX package's GSPMD version is.
    ``z0``: the global (C, dim), C divisible by the axis size. Returns
    (samples (S, C, dim), stats) as ``run_chees``, gathered on every rank.
    """
    C = z0.shape[0]
    group, _, n, lo, hi = _shard(mesh, axis_name, C, z0.device, "z0")
    samples, stats = run_chees(logp_batch, z0[lo:hi], generator,
                               chains=_ShardedChains(C, lo, hi, group), **chees_kwargs)
    stats["logp"] = _gather(stats["logp"].transpose(0, 1), group, n).transpose(0, 1)
    return _gather(samples.transpose(0, 1), group, n).transpose(0, 1), stats


def run_nuts_sharded(logp_batch: Callable, z0, generator: torch.Generator, mesh,
                     axis_name="chains", pool_mass: bool = True, **nuts_kwargs):
    """NUTS with the chain axis sharded over the mesh.

    ``z0``: the global (C, dim), C divisible by the axis size. Each rank
    runs its C/n chains batched (``run_nuts``), from its own stream (a
    generator seeded from a draw of the replicated ``generator`` and its
    rank). With ``pool_mass`` the regularized diagonal mass estimate is
    averaged over every chain on every rank at each slow window's end, as
    the JAX package's ``pmean`` over the mesh axis and the local chains
    does: every chain then shares one inverse mass. Returns (samples
    (C, S, dim), stats) as ``run_nuts``, gathered on every rank.
    """
    C = z0.shape[0]
    group, r, n, lo, hi = _shard(mesh, axis_name, C, z0.device, "z0")

    def pool(var):
        return (_allreduce(torch.sum(var, dim=0), group) / C).expand_as(var).clone()

    samples, stats = run_nuts(logp_batch, z0[lo:hi], _rank_generator(generator, r),
                              mass_pool=pool if pool_mass else None, **nuts_kwargs)
    return _gather(samples, group, n), {k: _gather(v, group, n) for k, v in stats.items()}


def run_smc_sharded(loglike_batch_fn: Callable, prior_logpdf_fn: Callable, particles0,
                    generator: torch.Generator, mesh, axis_name="particles",
                    num_moves: int = 5, target_ess: float = 0.8,
                    max_steps: int = 200) -> SMCResult:
    """Adaptive-tempering SMC with the particles sharded over the mesh.

    The device-parallel ``run_smc`` of the JAX package: each rank keeps
    N/n particles and runs their likelihood sweeps (``loglike_batch_fn``,
    (m, dim) -> (m,): one K1 launch at width N/n on its card). An
    ``all_gather`` of the log-likelihoods feeds the global temperature
    search and the systematic resample, both drawn from the replicated
    ``generator``, so every rank takes the same temperatures and its own
    slice of the same indices; the proposal covariance comes from
    all-reduced sums over the cloud; the moves are random-walk Metropolis
    at the fixed scale 2.38 / sqrt(dim), each rank from its own stream.
    ``particles0``: the global (N, dim) prior draws in unconstrained
    space. Returns the gathered (N, dim) particles and logZ on every
    rank; the per-step histories are empty, as in the JAX package.
    """
    N, dim = particles0.shape
    dtype, dev = particles0.dtype, particles0.device
    group, r, n, lo, hi = _shard(mesh, axis_name, N, dev, "particles0")
    m = hi - lo
    scale = 2.38 / math.sqrt(dim)
    move_gen = _rank_generator(generator, r)
    eye = torch.eye(dim, dtype=dtype, device=dev)

    p = particles0[lo:hi]
    with torch.no_grad():
        ll, lp = loglike_batch_fn(p), prior_logpdf_fn(p)
    lam = torch.zeros((), dtype=dtype, device=dev)
    logZ = torch.zeros((), dtype=dtype, device=dev)
    i = 0
    while i < max_steps and float(lam) < 1.0:
        # global temperature search on the gathered log-likelihoods
        ll_all = _gather(ll, group, n)
        dl = _find_dlambda(ll_all, lam, target_ess)
        log_w = dl * ll_all
        logZ = logZ + torch.logsumexp(log_w, 0) - math.log(N)
        lam = lam + dl

        # global systematic resample; this rank takes its slice
        idx = systematic_resample(generator, log_w)[lo:hi]
        p, ll, lp = _gather(p, group, n)[idx], ll_all[idx], _gather(lp, group, n)[idx]

        # cloud covariance from global moments; a failed factorization
        # gives NaN, as jnp.linalg.cholesky does
        mean = _allreduce(torch.sum(p, dim=0), group) / N
        c = p - mean
        cov = _allreduce(c.T @ c, group) / (N - 1) + 1e-10 * eye
        chol, info = torch.linalg.cholesky_ex(cov)
        chol = torch.where(info == 0, chol, torch.full_like(chol, math.nan))

        for _ in range(num_moves):
            eps = torch.randn((m, dim), generator=move_gen, dtype=dtype, device=dev)
            prop = p + scale * (eps @ chol.T)
            with torch.no_grad():
                ll_prop, lp_prop = loglike_batch_fn(prop), prior_logpdf_fn(prop)
            log_alpha = lam * (ll_prop - ll) + (lp_prop - lp)
            u = torch.rand((m,), generator=move_gen, dtype=dtype, device=dev)
            accept = torch.log(u) < log_alpha
            p = torch.where(accept[:, None], prop, p)
            ll = torch.where(accept, ll_prop, ll)
            lp = torch.where(accept, lp_prop, lp)
        i += 1
    empty = torch.zeros((0,), dtype=dtype, device=dev)
    return SMCResult(particles=_gather(p, group, n), logZ=logZ, num_steps=i,
                     log_evidence_path=empty, lambdas=empty, acceptance=empty)
