"""ChEES-HMC: jittered HMC with cross-chain adaptation, PyTorch port of
``pioran_tpu.samplers.chees``.

All chains share one trajectory length, adapted from cross-chain
statistics (Hoffman, Radul & Sountsov, AISTATS 2021), so every leapfrog
is one batched value+gradient of the log-posterior over the (C, dim)
chain state: on the card, one sweep of the likelihood kernels K3 and K4.
The iteration loop runs on the host; the scalar adaptation (step size,
trajectory length) is done there in float64, which costs one
device->host sync per iteration.

Adaptation (warmup only):
  - step size: dual averaging on the cross-chain mean accept
    probability, target 0.651;
  - trajectory length: Adam on log tau with the ChEES criterion gradient;
  - metric: EMA of the cross-chain variance (``mass="diag"``) or of the
    full covariance (``mass="dense"``), refreshed every 25 warmup
    iterations and frozen over the last ones; each refresh restarts dual
    averaging around the current step size.

Every cross-chain statistic goes through a :class:`ChainAxis`: the
chain means, the ChEES and accept-rate sums, the metric's (co)variance,
and the rows of each random draw. The default axis is the identity
over the C chains of one process; ``parallel.run_chees_sharded`` passes
one whose sums are all-reduced over ranks, each rank holding its slice
of the chains.

``run_chees_stepped`` is ``run_chees`` with the JAX package's stepped
signature and numpy results: its ``block`` keeps each TPU program short
there, and this loop is on the host already, so it is checked and
changes nothing.
``chees_warmup_and_sample`` is an alias of ``run_chees``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import torch

__all__ = ["run_chees", "run_chees_stepped", "chees_warmup_and_sample",
           "make_chees_transition", "batch_value_and_grad", "ChainAxis"]


def _halton(i: int, base: int = 2, num_bits: int = 30) -> float:
    """Radical-inverse (Halton) sequence element in (0, 1)."""
    i = (int(i) + 1) & 0xFFFFFFFF
    result, f = 0.0, 1.0 / base
    for _ in range(num_bits):
        result = result + f * (i % base)
        f, i = f / base, i // base
    return result


def _ipow(x: float, n: int) -> float:
    """x ** n for an int n >= 0 by square-and-multiply, the order in which
    XLA evaluates a float raised to an integer power, so the bias
    corrections below round as the JAX package's do."""
    acc = 1.0
    while n:
        if n & 1:
            acc = acc * x
        x, n = x * x, n >> 1
    return acc


class _AdamState(NamedTuple):
    m: float
    v: float
    t: int


def _adam_update(state: _AdamState, grad: float, lr=0.025, b1=0.9, b2=0.999,
                 eps=1e-8) -> Tuple[_AdamState, float]:
    """One scalar Adam step: (new state, the step to subtract)."""
    t = state.t + 1
    m = b1 * state.m + (1 - b1) * grad
    v = b2 * state.v + (1 - b2) * grad**2
    mhat = m / (1 - _ipow(b1, t))
    vhat = v / (1 - _ipow(b2, t))
    return _AdamState(m, v, t), lr * mhat / (math.sqrt(vhat) + eps)


class ChainAxis:
    """The chain axis of :func:`run_chees` over ``total`` chains, of which
    this process holds rows ``[lo, hi)``: cross-chain sums and the
    process's rows of a draw over every chain. This one holds them all
    and reduces nothing; a sharded axis overrides :meth:`allreduce`.
    """

    def __init__(self, total: int, lo: int = 0, hi: int = None):
        self.total, self.lo = total, lo
        self.hi = total if hi is None else hi

    def allreduce(self, x):
        """The sum of ``x`` over the processes that share the axis."""
        return x

    def mean(self, x):
        """Mean over every chain of the axis of per-chain rows ``x``."""
        return self.allreduce(torch.sum(x, dim=0)) / self.total

    def rows(self, x):
        """This process's rows of ``x``, drawn for every chain."""
        return x[self.lo:self.hi]


def batch_value_and_grad(logp_batch: Callable, Z):
    """(logp (C,), d logp / dZ (C, dim)) from one backward of the sum:
    the chains do not interact, so the gradient of the sum holds every
    chain's own gradient."""
    Z = Z.detach().requires_grad_(True)
    with torch.enable_grad():
        lp = logp_batch(Z)
        (grad,) = torch.autograd.grad(lp.sum(), Z)
    return lp.detach(), grad


def make_chees_transition(
    logp_batch: Callable,
    C: int,
    dim: int,
    dtype,
    device,
    num_warmup: int,
    target_accept: float = 0.651,
    max_leapfrogs: int = 1024,
    mass: str = "diag",
    chains: ChainAxis = None,
):
    """The ChEES-HMC transition ``(state, it, is_warmup, generator) ->
    (state, (z, logp, mean_accept, n_steps))`` and its initializer
    ``init(z0, initial_step_size, initial_traj_length) -> state``.

    ``mass="dense"`` adapts a full covariance metric from the
    cross-chain sample covariance (hundreds of chains estimate a
    dim ~ 10 covariance well), which preconditions the flagship model's
    alpha_2/f_1 ridge; "diag" keeps the marginal variances only.
    ``chains``: the chain axis (:class:`ChainAxis`); C is this process's
    share of it.
    """
    if mass not in ("diag", "dense"):
        raise ValueError(f"mass must be 'diag' or 'dense', got {mass!r}")
    dense = mass == "dense"
    eye = torch.eye(dim, dtype=dtype, device=device)
    chains = ChainAxis(C) if chains is None else chains
    C_all = chains.total

    def _draw(gen, shape, fn=torch.randn):
        """This process's rows of a draw for every chain of the axis."""
        return chains.rows(fn(shape, generator=gen, dtype=dtype, device=device))

    # `chol` is the Cholesky factor of the estimated posterior covariance
    # Sigma (momenta r ~ N(0, Sigma^-1), velocity v = Sigma r, kinetic
    # energy |chol^T r|^2 / 2); for diag it is the (dim,) vector of stddevs
    if dense:
        def draw_momentum(gen, chol):
            xi = _draw(gen, (C_all, dim))
            # r = L^{-T} xi, so cov(r) = Sigma^{-1}
            return torch.linalg.solve_triangular(chol.T, xi.T, upper=True).T

        def velocity(r, chol):
            return (r @ chol) @ chol.T

        def kinetic(r, chol):
            return 0.5 * torch.sum((r @ chol) ** 2, dim=1)
    else:
        def draw_momentum(gen, chol):
            xi = _draw(gen, (C_all, dim))
            return xi / chol[None, :]

        def velocity(r, chol):
            return r * (chol**2)[None, :]

        def kinetic(r, chol):
            return 0.5 * torch.sum((r * chol[None, :]) ** 2, dim=1)

    # metric frozen over the last windows, so the final step size is
    # adapted against the final metric
    freeze_tail = min(100, max(num_warmup // 4, 1))

    def leapfrog_traj(z, r, grad, eps, n_steps, chol):
        logp = torch.zeros(C, dtype=dtype, device=device)
        for _ in range(n_steps):
            r_half = r + 0.5 * eps * grad
            z = z + eps * velocity(r_half, chol)
            logp, grad = batch_value_and_grad(logp_batch, z)
            r = r_half + 0.5 * eps * grad
        return z, r, logp, grad

    def transition(state, it: int, is_warmup: bool, gen):
        st = dict(state)
        z, logp, grad, chol = st["z"], st["logp"], st["grad"], st["chol"]
        step_size, log_tau = st["step_size"], st["log_tau"]

        r0 = draw_momentum(gen, chol)
        # jittered trajectory length, shared across chains (Halton)
        h = _halton(it)
        n_steps = max(1, math.ceil(h * math.exp(log_tau) / step_size))
        n_steps = min(n_steps, max_leapfrogs)
        z_new, r_new, logp_new, grad_new = leapfrog_traj(z, r0, grad, step_size, n_steps, chol)

        # MH accept per chain
        log_alpha = (logp_new - kinetic(r_new, chol)) - (logp - kinetic(r0, chol))
        log_alpha = torch.where(torch.isfinite(log_alpha), log_alpha,
                                torch.full_like(log_alpha, -math.inf))
        accept_prob = torch.clamp(torch.exp(log_alpha), max=1.0)
        u = _draw(gen, (C_all,), torch.rand)
        accept = torch.log(u) < log_alpha
        z_next = torch.where(accept[:, None], z_new, z)
        logp_next = torch.where(accept, logp_new, logp)
        grad_next = torch.where(accept[:, None], grad_new, grad)

        # ChEES gradient for the trajectory length (cross-chain means)
        zc_old = z - chains.mean(z)
        zc_new = z_new - chains.mean(z_new)
        proj = torch.sum(zc_new * velocity(r_new, chol), dim=1)
        per_chain = (torch.sum(zc_new**2, 1) - torch.sum(zc_old**2, 1)) * proj
        # divergent trajectories give non-finite terms; they must not
        # poison the adaptation (a NaN log tau would freeze every chain)
        finite = torch.isfinite(per_chain)
        per_chain = torch.where(finite, per_chain, torch.zeros_like(per_chain))
        w = torch.where(finite, accept_prob, torch.zeros_like(accept_prob))
        sums = torch.stack([torch.sum(w * per_chain), torch.sum(w), torch.sum(accept_prob)])

        # metric: EMA of the cross-chain (co)variance, every iteration
        zc = z_next - chains.mean(z_next)[None, :]
        if dense:
            cov_now = chains.allreduce(zc.T @ zc) / max(C_all - 1, 1) + 1e-6 * eye
            st["cov_ema"] = 0.9 * st["cov_ema"] + 0.1 * cov_now
        else:
            var_now = chains.mean(zc * zc) + 1e-6
            st["cov_ema"] = 0.9 * st["cov_ema"] + 0.1 * var_now

        # the one host sync of the iteration
        num, den, acc_sum = chains.allreduce(sums).double().tolist()
        mean_accept = acc_sum / C_all

        chees_grad = h * num / max(den, 1e-10)
        # normalize the scale; gradient ascent on log tau
        chees_grad = chees_grad / (math.exp(2.0 * log_tau) + 1e-10)
        if not math.isfinite(chees_grad):
            chees_grad = 0.0
        adam, delta = _adam_update(st["adam"], -chees_grad)
        log_tau_new = min(log_tau - delta, math.log(0.9 * max_leapfrogs * step_size))

        # dual averaging on the cross-chain mean accept probability
        ls, ls_avg, hsum, mu, cnt = st["da"]
        cnt = cnt + 1
        hsum = hsum + (target_accept - mean_accept)
        ls = mu - math.sqrt(cnt) / 0.05 * hsum / (cnt + 10.0)
        eta = cnt ** (-0.75)
        ls_avg = eta * ls + (1 - eta) * ls_avg

        if is_warmup and it % 25 == 24 and it < num_warmup - freeze_tail:
            cov = st["cov_ema"]
            if dense:
                # the ridge keeps the factorization well-posed early on,
                # when the chains are clustered and the covariance singular
                ridge = 1e-6 * (torch.trace(cov) / dim + 1.0)
                st["chol"], _ = torch.linalg.cholesky_ex(cov + ridge * eye)
            else:
                st["chol"] = torch.sqrt(cov)
            # a new metric invalidates the tuned step size: restart dual
            # averaging centred on the current iterate
            mu, hsum, cnt = math.log(10.0) + ls, 0.0, 0.0
        st["da"] = (ls, ls_avg, hsum, mu, cnt)

        # during warmup follow the DA iterate; on the last warmup step
        # freeze at the DA average for the sampling phase. The trajectory
        # length is frozen at an EMA of its warmup iterates likewise.
        if is_warmup:
            last = it == num_warmup - 1
            st["step_size"] = math.exp(ls_avg if last else ls)
            st["lt_avg"] = 0.98 * st["lt_avg"] + 0.02 * log_tau_new
            st["log_tau"] = st["lt_avg"] if last else log_tau_new
        st["adam"] = adam
        st["z"], st["logp"], st["grad"] = z_next, logp_next, grad_next
        return st, (z_next, logp_next, mean_accept, n_steps)

    def init(z0, initial_step_size=0.1, initial_traj_length=1.0):
        logp0, grad0 = batch_value_and_grad(logp_batch, z0)
        ls0 = math.log(initial_step_size)
        lt0 = math.log(initial_traj_length)
        metric0 = eye.clone() if dense else torch.ones(dim, dtype=dtype, device=device)
        return {
            "z": z0, "logp": logp0, "grad": grad0, "step_size": float(initial_step_size),
            "log_tau": lt0, "adam": _AdamState(0.0, 0.0, 0),
            "da": (ls0, ls0, 0.0, math.log(10.0) + ls0, 0.0),
            "chol": metric0, "cov_ema": metric0.clone(), "lt_avg": lt0,
        }

    return transition, init


def _metric_stats(chol, mass):
    """diag(Sigma) from the metric factor."""
    if mass == "dense":
        return torch.sum(chol * chol, dim=1)
    return chol**2


def run_chees(
    logp_batch: Callable,
    z0,
    generator: torch.Generator,
    num_warmup: int = 500,
    num_samples: int = 1000,
    initial_step_size: float = 0.1,
    initial_traj_length: float = 1.0,
    target_accept: float = 0.651,
    max_leapfrogs: int = 1024,
    mass: str = "diag",
    thin: int = 1,
    chains: ChainAxis = None,
):
    """Run ChEES-HMC on a (C, dim) batch of chains.

    ``logp_batch`` maps (C, dim) to (C,) log-posteriors and must be
    differentiable; each leapfrog takes the values and every chain's
    gradient from one backward. Random numbers come from ``generator``
    (on z0's device). ``thin`` keeps every ``thin``-th post-warmup draw.
    Returns (samples (S, C, dim), stats) with stats ``logp`` (S, C),
    ``accept`` and ``n_leapfrogs`` (per iteration, warmup included),
    ``step_size``, ``traj_length`` and ``inv_mass`` (diag of Sigma).
    ``chains``: the chain axis that takes the cross-chain statistics
    (:class:`ChainAxis`, the identity over z0's chains by default).
    """
    z0 = torch.as_tensor(z0)
    C, dim = z0.shape
    transition, init = make_chees_transition(
        logp_batch, C, dim, z0.dtype, z0.device, num_warmup, target_accept,
        max_leapfrogs, mass, chains)
    state = init(z0, initial_step_size, initial_traj_length)
    samples, logps, accepts, nsteps = [], [], [], []
    for it in range(num_warmup + num_samples):
        state, (z, logp, acc, n) = transition(state, it, it < num_warmup, generator)
        accepts.append(acc)
        nsteps.append(n)
        if it >= num_warmup and (it - num_warmup) % thin == 0:
            samples.append(z)
            logps.append(logp)
    stats = {
        "logp": torch.stack(logps) if logps else z0.new_zeros((0, C)),
        "accept": torch.tensor(accepts, dtype=torch.float64),
        "n_leapfrogs": torch.tensor(nsteps, dtype=torch.int64),
        "step_size": state["step_size"],
        "traj_length": math.exp(state["log_tau"]),
        "inv_mass": _metric_stats(state["chol"], mass),
    }
    return (torch.stack(samples) if samples else z0.new_zeros((0, C, dim))), stats


def run_chees_stepped(
    logp_batch: Callable,
    z0,
    generator: torch.Generator,
    num_warmup: int = 500,
    num_samples: int = 1000,
    initial_step_size: float = 0.1,
    initial_traj_length: float = 1.0,
    target_accept: float = 0.651,
    max_leapfrogs: int = 1024,
    thin: int = 1,
    mass: str = "diag",
    block: int = 1,
):
    """:func:`run_chees` with the JAX package's stepped signature and
    results: for a given ``generator`` the same draws and statistics.

    ``block`` is checked (at least 1) and has no other effect: the JAX
    driver steps the chains ``block`` transitions a device program to keep
    each TPU program short, and the port's loop runs on the host already.
    ``thin`` keeps every ``thin``-th post-warmup draw. Returns (samples
    (S, C, dim) numpy, stats) with stats ``logp`` (S, C), ``accept`` and
    ``n_leapfrogs`` (per iteration, warmup included) as numpy,
    ``step_size`` and ``traj_length`` as floats and ``inv_mass`` (diag of
    Sigma) as numpy.
    """
    if block < 1:
        raise ValueError(f"block must be at least 1, got {block}")
    samples, st = run_chees(logp_batch, z0, generator, num_warmup=num_warmup,
                            num_samples=num_samples, initial_step_size=initial_step_size,
                            initial_traj_length=initial_traj_length,
                            target_accept=target_accept, max_leapfrogs=max_leapfrogs,
                            mass=mass, thin=thin)
    stats = {key: (v.cpu().numpy() if torch.is_tensor(v) else v) for key, v in st.items()}
    return samples.cpu().numpy(), stats


# the JAX package's descriptive name
chees_warmup_and_sample = run_chees
