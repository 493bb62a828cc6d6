"""The No-U-Turn sampler, batched over chains: PyTorch port of
``pioran_tpu.samplers.nuts``.

Multinomial NUTS (Betancourt 2017) with the checkpoint-based iterative
U-turn scheme: within a subtree built leaf by leaf, leaf k is checked
against the start of every balanced block that ends at k; momenta stored
at even leaves in slot popcount(k), odd leaves checked against slots
[popcount(k) - trailing_ones(k), popcount(k) - 1].

Warmup: Stan-style windowed adaptation, per chain: a dual-averaging step
size toward the target accept statistic and a diagonal mass matrix from
Welford accumulators, refreshed at the end of each doubling slow window
(optionally pooled across chains by a ``mass_pool`` hook).

The JAX package runs one chain per ``run_nuts`` and vmaps it. Here the C
chains are one batch, with the semantics of that vmap: every leapfrog
evaluates ``logp_batch`` for all C chains at once (one value+gradient
sweep: K3 and K4 on the card), and a chain whose tree or subtree has
stopped is masked, its state, weights and leaf count frozen. A frozen
chain is evaluated at its transition's start point, so no -inf or NaN of
a stopped trajectory enters the batch. The loops over doublings and
leaves run on the host, with one device->host sync a leaf and one a
doubling ("is any chain still building?").

``make_nuts_transition`` is one iteration of that loop, warmup
adaptation included, with the iteration index given from outside;
``run_nuts`` drives it. ``run_nuts_stepped`` is ``run_nuts`` with the
JAX package's stepped signature: its ``block`` keeps each TPU program
short there, and this loop is on the host already, so it is checked and
changes nothing. Its results are numpy, and its statistics keep the
port's one layout, (C, iterations), where the JAX package's stepped
driver has (iterations, C).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from .chees import batch_value_and_grad

__all__ = ["NutsConfig", "run_nuts", "run_nuts_stepped", "make_nuts_transition",
           "nuts_kernel", "warmup_schedule"]


class NutsConfig(NamedTuple):
    step_size: float = 0.1
    max_depth: int = 8
    target_accept: float = 0.8
    max_delta_energy: float = 1000.0


def _popcount(n):
    """Set bits of each entry of an integer tensor (entries < 2^32)."""
    n = n.to(torch.int64) & 0xFFFFFFFF
    n = n - ((n >> 1) & 0x55555555)
    n = (n & 0x33333333) + ((n >> 2) & 0x33333333)
    n = (n + (n >> 4)) & 0x0F0F0F0F
    return (((n * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int64)


def _trailing_ones(n):
    """Trailing 1-bits of each entry: popcount(n & ~(n + 1))."""
    n = n.to(torch.int64) & 0xFFFFFFFF
    return _popcount(n & ~(n + 1))


def _dot(u, v):
    return torch.sum(u * v, dim=-1)


def _is_turning(inv_mass, r_left, r_right, r_sum):
    """Generalized U-turn criterion on a block with momentum sum r_sum,
    per row."""
    return (_dot(inv_mass * r_left, r_sum) <= 0) | (_dot(inv_mass * r_right, r_sum) <= 0)


def _energy(logp, r, inv_mass):
    return -logp + 0.5 * _dot(r, inv_mass * r)


def _sel(mask, new, old):
    """Row-wise select: ``new`` where ``mask`` (C,), else ``old``."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)), new, old)


def _merge(mask, new: dict, old: dict) -> dict:
    return {k: _sel(mask, new[k], old[k]) for k in old}


def nuts_kernel(logp_batch: Callable, z, logp, grad, generator: torch.Generator,
                step_size, inv_mass, max_depth: int = 8, max_delta_energy: float = 1000.0):
    """One NUTS transition of C chains. ``z``, ``grad``: (C, dim); ``logp``,
    ``step_size``: (C,); ``inv_mass``: (C, dim). Returns (z', logp',
    grad', stats) with per-chain stats ``accept_stat``, ``diverging``,
    ``depth``, ``num_leaves`` (the leapfrogs of this transition) and
    ``energy``."""
    C, dim = z.shape
    dtype, dev = z.dtype, z.device

    def rand(shape=(C,)):
        return torch.rand(shape, generator=generator, dtype=dtype, device=dev)

    r0 = torch.sqrt(1.0 / inv_mass) * torch.randn((C, dim), generator=generator,
                                                   dtype=dtype, device=dev)
    energy0 = _energy(logp, r0, inv_mass)
    false = torch.zeros(C, dtype=torch.bool, device=dev)
    izero = torch.zeros(C, dtype=torch.int64, device=dev)
    fzero = torch.zeros(C, dtype=dtype, device=dev)
    tree = dict(z_left=z, r_left=r0, grad_left=grad, z_right=z, r_right=r0, grad_right=grad,
                z_prop=z, logp_prop=logp, grad_prop=grad, log_weight=fzero, r_sum=r0,
                turning=false, diverging=false, sum_accept=fzero, num_leaves=izero)
    slots = torch.arange(max_depth, device=dev)

    def build_subtree(tree, depth, going_right, building):
        """Extend each building chain's trajectory by a balanced subtree of
        2^depth leaves on one side; returns the subtree's state."""
        target = torch.ones_like(depth) << depth
        eps = torch.where(going_right, step_size, -step_size)[:, None]
        z_c = _sel(going_right, tree["z_right"], tree["z_left"])
        r_c = _sel(going_right, tree["r_right"], tree["r_left"])
        g_c = _sel(going_right, tree["grad_right"], tree["grad_left"])
        sub = dict(z_left=z_c, r_left=r_c, grad_left=g_c, z_right=z_c, r_right=r_c,
                   grad_right=g_c, z_prop=z_c, logp_prop=fzero, grad_prop=g_c,
                   log_weight=torch.full((C,), -math.inf, dtype=dtype, device=dev),
                   r_sum=torch.zeros_like(z), turning=false, diverging=false,
                   sum_accept=fzero, num_leaves=izero)
        # checkpoints for the iterative U-turn scheme: momenta and the
        # cumulative momentum sums including the leaf, at even leaves
        r_ckpts = torch.zeros((C, max_depth, dim), dtype=dtype, device=dev)
        s_ckpts = torch.zeros_like(r_ckpts)
        r_cumsum = torch.zeros_like(z)
        k = izero
        while True:
            act = building & (k < target) & ~sub["turning"] & ~sub["diverging"]
            if not bool(act.any()):  # the host sync of a leaf
                return sub
            # leapfrog; a chain not building is evaluated at its start
            r_half = r_c + 0.5 * eps * g_c
            z_n = _sel(act, z_c + eps * inv_mass * r_half, z)
            logp_n, grad_n = batch_value_and_grad(logp_batch, z_n)
            r_n = r_half + 0.5 * eps * grad_n
            energy_n = _energy(logp_n, r_n, inv_mass)
            delta = energy_n - energy0
            diverging = delta > max_delta_energy
            log_w = -energy_n + energy0  # leaf weight relative to the start
            accept_prob = torch.clamp(torch.exp(-delta), max=1.0)

            # progressive multinomial proposal within the subtree
            new_log_weight = torch.logaddexp(sub["log_weight"], log_w)
            p_take = torch.exp(log_w - new_log_weight)
            first = sub["num_leaves"] == 0
            take = first | (rand() < p_take)
            r_cumsum_n = r_cumsum + r_n

            # checkpoint-based U-turn checks within the subtree
            even = (k % 2) == 0
            slot = torch.clamp(_popcount(k), 0, max_depth - 1)
            store = (even & act)[:, None, None] & (slots[None, :] == slot[:, None])[:, :, None]
            r_ckpts = torch.where(store, r_n[:, None, :], r_ckpts)
            s_ckpts = torch.where(store, r_cumsum_n[:, None, :], s_ckpts)
            idx_max = _popcount(k) - 1
            idx_min = idx_max - _trailing_ones(k) + 1
            check = ((slots[None, :] >= idx_min[:, None]) & (slots[None, :] <= idx_max[:, None])
                     & ~even[:, None])
            rho = r_cumsum_n[:, None, :] - s_ckpts + r_ckpts
            turn = _is_turning(inv_mass[:, None, :], r_ckpts, r_n[:, None, :], rho)
            turning = sub["turning"] | torch.any(check & turn, dim=1)

            new = dict(
                z_left=_sel(first, z_n, sub["z_left"]), r_left=_sel(first, r_n, sub["r_left"]),
                grad_left=_sel(first, grad_n, sub["grad_left"]),
                z_right=z_n, r_right=r_n, grad_right=grad_n,
                z_prop=_sel(take, z_n, sub["z_prop"]),
                logp_prop=torch.where(take, logp_n, sub["logp_prop"]),
                grad_prop=_sel(take, grad_n, sub["grad_prop"]),
                log_weight=torch.where(first, log_w, new_log_weight),
                r_sum=_sel(first, r_n, sub["r_sum"] + r_n),
                turning=turning, diverging=sub["diverging"] | diverging,
                sum_accept=sub["sum_accept"] + accept_prob,
                num_leaves=sub["num_leaves"] + 1)
            sub = _merge(act, new, sub)
            z_c, r_c, g_c = _sel(act, z_n, z_c), _sel(act, r_n, r_c), _sel(act, grad_n, g_c)
            r_cumsum = _sel(act, r_cumsum_n, r_cumsum)
            k = k + act.to(k.dtype)

    depth = izero
    while True:
        building = (depth < max_depth) & ~tree["turning"] & ~tree["diverging"]
        if not bool(building.any()):  # the host sync of a doubling
            break
        going_right = rand() < 0.5
        sub = build_subtree(tree, depth, going_right, building)

        # biased progressive sampling across the doubling
        p_new = torch.clamp(torch.exp(sub["log_weight"] - tree["log_weight"]), max=1.0)
        usable = ~sub["turning"] & ~sub["diverging"]
        take = usable & (rand() < p_new)
        # merge the edges: a subtree grown leftwards has its far end in
        # its "right" slot
        z_left = _sel(going_right, tree["z_left"], sub["z_right"])
        r_left = _sel(going_right, tree["r_left"], sub["r_right"])
        g_left = _sel(going_right, tree["grad_left"], sub["grad_right"])
        z_right = _sel(going_right, sub["z_right"], tree["z_right"])
        r_right = _sel(going_right, sub["r_right"], tree["r_right"])
        g_right = _sel(going_right, sub["grad_right"], tree["grad_right"])
        r_sum = tree["r_sum"] + sub["r_sum"]
        turning_merged = _is_turning(inv_mass, r_left, r_right, r_sum)
        new = dict(
            z_left=z_left, r_left=r_left, grad_left=g_left,
            z_right=z_right, r_right=r_right, grad_right=g_right,
            z_prop=_sel(take, sub["z_prop"], tree["z_prop"]),
            logp_prop=torch.where(take, sub["logp_prop"], tree["logp_prop"]),
            grad_prop=_sel(take, sub["grad_prop"], tree["grad_prop"]),
            log_weight=torch.logaddexp(tree["log_weight"], sub["log_weight"]),
            r_sum=r_sum, turning=sub["turning"] | (usable & turning_merged),
            diverging=sub["diverging"], sum_accept=tree["sum_accept"] + sub["sum_accept"],
            num_leaves=tree["num_leaves"] + sub["num_leaves"])
        tree = _merge(building, new, tree)
        depth = depth + building.to(depth.dtype)

    stats = {
        "accept_stat": tree["sum_accept"] / torch.clamp(tree["num_leaves"], min=1).to(dtype),
        "diverging": tree["diverging"],
        "depth": depth,
        "num_leaves": tree["num_leaves"],
        "energy": energy0,
    }
    return tree["z_prop"], tree["logp_prop"], tree["grad_prop"], stats


# ---------------------------------------------------------------------------
# Warmup adaptation
# ---------------------------------------------------------------------------


def warmup_schedule(num_warmup: int, init_buffer=75, term_buffer=50, base_window=25):
    """Stan-style (fast, slow-doubling, fast) window boundaries: a bool
    array ``update_mass[i]`` marking the end of each slow window (the
    mass-matrix refresh points)."""
    update = np.zeros(num_warmup, dtype=bool)
    if num_warmup < 20:
        return update
    if num_warmup < init_buffer + term_buffer + base_window:
        init_buffer = max(1, int(0.15 * num_warmup))
        term_buffer = max(1, int(0.1 * num_warmup))
    pos = init_buffer
    window = base_window
    while pos + window + term_buffer <= num_warmup:
        nxt = pos + window
        if nxt + 2 * window + term_buffer > num_warmup:
            nxt = num_warmup - term_buffer
        update[nxt - 1] = True
        pos = nxt
        window *= 2
    return update


class _DAState(NamedTuple):
    log_step: torch.Tensor
    log_step_avg: torch.Tensor
    h_sum: torch.Tensor
    mu: torch.Tensor
    count: float  # the same for every chain: all update at every iteration


def _da_init(step_size):
    ls = torch.log(step_size)
    return _DAState(ls, ls, torch.zeros_like(ls), math.log(10.0) + ls, 0.0)


def _da_update(state: _DAState, accept_stat, target, gamma=0.05, t0=10.0, kappa=0.75):
    count = state.count + 1
    h = target - accept_stat
    h_sum = state.h_sum + h
    # the scalar factors in host float64 and a true division by a tensor:
    # torch's sqrt and its division by a Python scalar (through the
    # reciprocal) round otherwise than the JAX package does
    log_step = state.mu - math.sqrt(count) / gamma * h_sum / torch.full_like(h_sum, count + t0)
    eta = count ** (-kappa)
    log_step_avg = eta * log_step + (1 - eta) * state.log_step_avg
    return _DAState(log_step, log_step_avg, h_sum, state.mu, count)


def make_nuts_transition(
    logp_batch: Callable,
    num_warmup: int,
    target_accept: float = 0.8,
    max_depth: int = 8,
    initial_step_size: float = 0.1,
    mass_pool: Callable = None,
):
    """One NUTS iteration of C chains, ``transition(state, it, is_warmup,
    generator) -> (state, out)``, and its initializer ``init(z0) ->
    state``.

    A warmup iteration steps at each chain's dual-averaging iterate
    exp(log_step), then updates the dual averaging and the Welford
    accumulators, and at the end of each slow window of
    :func:`warmup_schedule` (``it`` indexes it) sets the inverse mass to
    the regularized variance estimate (passed through ``mass_pool``, see
    :func:`run_nuts`) and restarts the dual averaging. A sampling
    iteration steps at the frozen exp(log_step_avg) and adapts nothing.
    ``out`` is (z, logp, accept_stat, diverging, depth, num_leaves), each
    with the chains first, as the JAX package's ``out`` tuple.
    """
    update_mass = warmup_schedule(num_warmup)

    def init(z0):
        z0 = torch.as_tensor(z0)
        C, dim = z0.shape
        dtype, dev = z0.dtype, z0.device
        logp, grad = batch_value_and_grad(logp_batch, z0)
        inv_mass = torch.ones((C, dim), dtype=dtype, device=dev)
        return {
            "z": z0, "logp": logp, "grad": grad,
            "da": _da_init(torch.full((C,), initial_step_size, dtype=dtype, device=dev)),
            "inv_mass": inv_mass, "mean": torch.zeros_like(inv_mass),
            "m2": torch.zeros_like(inv_mass), "wcount": torch.zeros((), dtype=dtype, device=dev),
        }

    def transition(state, it: int, is_warmup: bool, generator: torch.Generator):
        st = dict(state)
        da = st["da"]
        step_size = torch.exp(da.log_step if is_warmup else da.log_step_avg)
        z, logp, grad, stats = nuts_kernel(logp_batch, st["z"], st["logp"], st["grad"],
                                           generator, step_size, st["inv_mass"],
                                           max_depth=max_depth)
        st["z"], st["logp"], st["grad"] = z, logp, grad
        if is_warmup:
            st["da"] = _da_update(da, stats["accept_stat"], target_accept)
            # Welford accumulation for the diagonal mass matrix
            wcount = st["wcount"] + 1
            delta = z - st["mean"]
            mean = st["mean"] + delta / wcount
            st["m2"] = st["m2"] + delta * (z - mean)
            st["mean"], st["wcount"] = mean, wcount
            if update_mass[it]:
                var = st["m2"] / torch.clamp(wcount - 1, min=1)
                # regularize like Stan: shrink toward unit scale
                var = (wcount / (wcount + 5.0)) * var + 1e-3 * (5.0 / (wcount + 5.0))
                if mass_pool is not None:
                    var = mass_pool(var)
                # restart step-size adaptation around the current value
                st["da"] = _da_init(torch.exp(st["da"].log_step))
                st["inv_mass"] = var
                st["mean"], st["m2"] = torch.zeros_like(mean), torch.zeros_like(mean)
                st["wcount"] = torch.zeros_like(wcount)
        out = (z, logp, stats["accept_stat"], stats["diverging"], stats["depth"],
               stats["num_leaves"])
        return st, out

    return transition, init


_OUT_KEYS = ("accept_stat", "diverging", "depth", "num_leaves")  # out[2:]


def run_nuts(
    logp_batch: Callable,
    z0,
    generator: torch.Generator,
    num_warmup: int = 500,
    num_samples: int = 1000,
    initial_step_size: float = 0.1,
    max_depth: int = 8,
    target_accept: float = 0.8,
    mass_pool: Callable = None,
):
    """Run C NUTS chains: warmup (per-chain step size and diagonal mass)
    then sampling at each chain's dual-averaged step size.

    ``logp_batch`` maps (C, dim) to (C,) log-densities and must be
    differentiable; ``z0`` is (C, dim); random numbers come from
    ``generator`` (on z0's device). Returns (samples (C, num_samples,
    dim), stats) with stats ``logp``, ``accept_stat``, ``diverging``,
    ``depth`` and ``num_leaves`` of the sampling iterations and
    ``warmup_accept_stat``, ``warmup_diverging``, ``warmup_depth`` and
    ``warmup_num_leaves`` of the warmup ones, each (C, iterations); ``step_size`` (C,) and
    ``inv_mass`` (C, dim). ``num_leaves`` counts each transition's
    leapfrogs (value+gradient evaluations) exactly.

    ``mass_pool``: maps the (C, dim) regularized variance estimates at
    each slow window's end to the chains' new inverse masses, the
    counterpart of the JAX package's ``mass_pool_axis`` (``pmean`` of
    the estimate): ``parallel.run_nuts_sharded`` averages it over every
    chain on every rank. By default each chain keeps its own.
    """
    z0 = torch.as_tensor(z0)
    C, dim = z0.shape
    transition, init = make_nuts_transition(logp_batch, num_warmup, target_accept, max_depth,
                                            initial_step_size, mass_pool)
    state = init(z0)
    warm = {key: [] for key in _OUT_KEYS}
    samples, draws = [], {"logp": [], **{key: [] for key in _OUT_KEYS}}
    for it in range(num_warmup + num_samples):
        state, out = transition(state, it, it < num_warmup, generator)
        if it < num_warmup:
            per_it = warm
        else:
            per_it = draws
            samples.append(out[0])
            draws["logp"].append(out[1])
        for key, x in zip(_OUT_KEYS, out[2:]):
            per_it[key].append(x)

    def stack(xs, like):
        return torch.stack(xs, dim=1) if xs else like.new_zeros((C, 0))

    logp = state["logp"]
    ints = torch.zeros(C, dtype=torch.int64, device=z0.device)
    bools = torch.zeros(C, dtype=torch.bool, device=z0.device)
    like = {"logp": logp, "accept_stat": logp, "diverging": bools, "depth": ints,
            "num_leaves": ints}
    stats = {key: stack(v, like[key]) for key, v in draws.items()}
    stats.update({
        "step_size": torch.exp(state["da"].log_step_avg),
        "inv_mass": state["inv_mass"],
        **{f"warmup_{key}": stack(v, like[key]) for key, v in warm.items()},
    })
    out = torch.stack(samples, dim=1) if samples else z0.new_zeros((C, 0, dim))
    return out, stats


def run_nuts_stepped(
    logp_batch: Callable,
    z0,
    generator: torch.Generator,
    num_warmup: int = 500,
    num_samples: int = 1000,
    initial_step_size: float = 0.1,
    max_depth: int = 8,
    target_accept: float = 0.8,
    thin: int = 1,
    block: int = 10,
):
    """:func:`run_nuts` with the JAX package's stepped signature and
    results: for a given ``generator`` the same draws and statistics.

    ``block`` is checked (at least 1) and has no other effect: the JAX
    driver steps the chains ``block`` transitions a device program to keep
    each TPU program short, and the port's loop runs on the host already.
    ``thin`` keeps every ``thin``-th post-warmup draw. Returns (samples
    (S, C, dim) numpy, stats) with stats ``logp`` (C, S) of the kept
    draws, ``accept_stat``, ``diverging``, ``depth`` and ``num_leaves``
    (C, num_warmup + num_samples), warmup first, ``step_size`` (C,) and
    ``inv_mass`` (C, dim), all numpy. The statistics keep the port's one
    layout, (C, iterations), where the JAX package's stepped driver
    returns (iterations, C). ``num_samples=0`` returns empty draws.
    """
    if block < 1:
        raise ValueError(f"block must be at least 1, got {block}")
    chains, st = run_nuts(logp_batch, z0, generator, num_warmup=num_warmup,
                          num_samples=num_samples, initial_step_size=initial_step_size,
                          max_depth=max_depth, target_accept=target_accept)
    stats = {key: torch.cat([st[f"warmup_{key}"], st[key]], dim=1).cpu().numpy()
             for key in _OUT_KEYS}
    stats.update({
        "logp": st["logp"][:, ::thin].cpu().numpy(),
        "step_size": st["step_size"].cpu().numpy(),
        "inv_mass": st["inv_mass"].cpu().numpy(),
    })
    return chains[:, ::thin].transpose(0, 1).cpu().numpy(), stats
