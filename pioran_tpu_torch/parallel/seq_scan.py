"""Sequence-axis scale-out: the blockwise celerite scan across ranks,
PyTorch port of ``pioran_tpu.parallel.seq_scan``.

The time axis is split into contiguous blocks, one a rank of the mesh's
``axis_name`` group, in rank order. Block 0 starts from the neutral state
(S, W, D, f, zp) = 0; every later block starts from the state the block
before it ended with, which the ranks hand on with point-to-point calls
(``torch.distributed.batch_isend_irecv``). The spacing of a block's first
step is the one to the previous block's last point (0 for block 0), so the
hand-off is exact: the blocks compute what one pass over the series does,
up to the order in which their partial sums are added.

One block of one micro-batch is one call of :func:`run_block`: on CUDA
tensors the carry entry of K1 (no gradient wanted) or of K3 (gradient
wanted), warp-per-chain or wide by J (``ops/cuda_celerite.py``,
``ops/cuda_celerite_vjp.py``); on CPU tensors their plain versions. The
gradient is one ``torch.autograd.Function`` over the whole pipelined
call: its backward runs the rounds in reverse with K4's carry entry, the
cotangents of T and pre moving from rank k to rank k - 1.

Every rank holds the whole batch (the samplers run replicated, one seed on
every rank) and returns the same bits: the per-block partials are
gathered and summed in block order, not all-reduced in the backend's
order, and the backward returns every block's cotangents gathered the
same way. Each rank keeps only its block's residual tables, so the memory
of the gradient sweep scales as 1/n_dev of the series.

Every call is a collective over the group: every rank of it calls it with
the same arguments. A group of one rank sends nothing.
"""

from __future__ import annotations

import math
import weakref
from typing import List, Optional

import torch
import torch.distributed as dist

from ..ops.cuda_celerite import loglike_carry
from ..ops.cuda_celerite_vjp import (
    adjoint_width, bwd_carry, carry_width, fwd_aug_carry, neutral_carry, spacings)
from .mesh import axis_group

__all__ = ["logl_seq_sharded", "factor_solve_seq_sharded", "logl_seq_pipelined", "run_block"]

_LOG2PI = math.log(2.0 * math.pi)

# the groups whose communicator a collective of every rank has set up
_READY = weakref.WeakSet()


def run_block(a, b, c, d, t, y, sigma2, dt, carry, grad: bool):
    """One block of one micro-batch: ``(partials (B, 3), carry out,
    residuals or None)``. ``t`` (K,) the block's times, ``dt`` (K,) its
    spacings with the boundary's first, ``carry`` the state the block
    before ended with (``cuda_celerite_vjp.neutral_carry`` for block 0).
    ``grad`` runs K3's carry entry and keeps its residual tables for
    K4's; otherwise K1's, which writes none."""
    if grad:
        return fwd_aug_carry(a, b, c, d, t, y, sigma2, dt, carry)
    parts, cout = loglike_carry(a, b, c, d, t, y, sigma2, dt, carry)
    return parts, cout, None


class _Ring:
    """The point-to-point hand-off between neighbours of the group."""

    def __init__(self, mesh, axis_name: str, device):
        self.group, self.me, self.n = axis_group(mesh, axis_name)
        if self.n > 1 and self.group not in _READY:
            # a collective of every rank first, once a group: NCCL sets up
            # a group's communicator at its first call, which must not be
            # a point-to-point call between two of its ranks
            dist.all_reduce(torch.zeros(1, device=device), group=self.group)
            _READY.add(self.group)

    def _peer(self, k: int) -> int:
        return dist.get_global_rank(self.group, k)

    def exchange(self, send: Optional[torch.Tensor], to: int, shape, like, frm: int,
                 want: bool) -> Optional[torch.Tensor]:
        """Send ``send`` (if any) to rank ``to`` of the group and, if
        ``want``, receive a tensor of ``shape`` from rank ``frm``."""
        ops, recv = [], None
        if send is not None:
            ops.append(dist.P2POp(dist.isend, send.contiguous(), self._peer(to), self.group))
        if want:
            recv = like.new_empty(shape)
            ops.append(dist.P2POp(dist.irecv, recv, self._peer(frm), self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return recv

    def gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x``, in rank (block) order."""
        x = x.contiguous()
        if self.n == 1:
            return [x]
        out = [torch.empty_like(x) for _ in range(self.n)]
        dist.all_gather(out, x, group=self.group)
        return out


class _Plan:
    """One pipelined call's layout on this rank: the ring, the micro-batch
    count M and width, and this rank's block of the series."""

    def __init__(self, mesh, axis_name, N, B, J, n_micro, t, dt, dtype):
        self.ring = _Ring(mesh, axis_name, t.device)
        n = self.ring.n
        if N % n != 0:
            raise ValueError(f"N={N} not divisible by mesh axis size {n}")
        self.M = n_micro or n
        if B % self.M != 0:
            raise ValueError(f"B={B} chains not divisible by n_micro={self.M}")
        self.mb, self.K, self.N, self.J = B // self.M, N // n, N, J
        lo = self.ring.me * self.K
        self.block = slice(lo, lo + self.K)
        # global spacings with a leading 0 (host float64 ones when given),
        # so each block's first step decays against the previous block's
        # last point
        t = t.detach().to(dtype)
        self.t = t[self.block].contiguous()
        self.dt = spacings(t, dt)[self.block].contiguous()

    def rows(self, m: int) -> slice:
        return slice(m * self.mb, (m + 1) * self.mb)


def _forward(plan: _Plan, a, b, c, d, Y, S2, grad: bool):
    """The rounds of the pipeline: rank k runs micro-batch m = r - k at
    round r from the carry rank k - 1 handed it. Returns this block's
    partials (B, 3) and, with ``grad``, each micro-batch's residuals."""
    ring, me, n = plan.ring, plan.ring.me, plan.ring.n
    B, J = a.shape
    Y_l, S2_l = Y[:, plan.block], S2[:, plan.block]
    parts = a.new_empty(B, 3)
    saved = [None] * plan.M
    recv = None
    for r in range(plan.M + n - 1):
        m, send = r - me, None
        if 0 <= m < plan.M:
            rows = plan.rows(m)
            carry = neutral_carry(plan.mb, J, a) if me == 0 else recv
            p, cout, res = run_block(a[rows], b[rows], c[rows], d[rows], plan.t, Y_l[rows],
                                     S2_l[rows], plan.dt, carry, grad)
            parts[rows] = p
            saved[m] = res
            send = cout if me < n - 1 else None
        mr = r + 1 - me  # the micro-batch rank k - 1 hands on this round
        recv = ring.exchange(send, me + 1, (plan.mb, carry_width(J)), a, me - 1,
                             me > 0 and 0 <= mr < plan.M)
    return parts, saved


def _reduce(plan: _Plan, parts):
    """(B,) log-likelihoods from every block's partials, summed in block
    order; -inf unless every D > 0 and the value is finite."""
    blocks = plan.ring.gather(parts)
    logdet, quad, minD = blocks[0][:, 0], blocks[0][:, 1], blocks[0][:, 2]
    for p in blocks[1:]:
        logdet, quad, minD = logdet + p[:, 0], quad + p[:, 1], torch.minimum(minD, p[:, 2])
    ll = -0.5 * (logdet + quad + plan.N * _LOG2PI)
    ok = (minD > 0) & torch.isfinite(ll)
    return torch.where(ok, ll, torch.full_like(ll, -math.inf))


def _backward(plan: _Plan, a, b, c, d, Y, S2, saved, g):
    """The rounds in reverse: rank k runs K4's carry entry on micro-batch
    m = r - (n - 1 - k) from the adjoint carry rank k + 1 handed it. The
    cotangents of every block, gathered and summed in block order:
    (ā, b̄, c̄, d̄ (B, J), t̄ (N,), ȳ, σ̄² (B, N))."""
    ring, me, n = plan.ring, plan.ring.me, plan.ring.n
    B, J = a.shape
    K = plan.K
    Y_l, S2_l = Y[:, plan.block], S2[:, plan.block]
    coefs = a.new_zeros(B, 4 * J)
    ybar, s2bar = a.new_zeros(B, K), a.new_zeros(B, K)
    tb, dtb = a.new_zeros(K), a.new_zeros(K)
    recv = None
    for r in range(plan.M + n - 1):
        m, send = r - (n - 1 - me), None
        if 0 <= m < plan.M:
            rows = plan.rows(m)
            carry = a.new_zeros(plan.mb, adjoint_width(J)) if me == n - 1 else recv
            ab, bb, cb, db, tpart, dtpart, yb, sb, aout = bwd_carry(
                a[rows], b[rows], c[rows], d[rows], plan.t, Y_l[rows], S2_l[rows], saved[m],
                g[rows], plan.dt, carry)
            coefs[rows] = torch.cat([ab, bb, cb, db], dim=1)
            ybar[rows], s2bar[rows] = yb, sb
            tb, dtb = tb + tpart, dtb + dtpart
            send = aout if me > 0 else None
        mr = r + 2 - n + me  # the micro-batch rank k + 1 hands on this round
        recv = ring.exchange(send, me - 1, (plan.mb, adjoint_width(J)), a, me + 1,
                             me < n - 1 and 0 <= mr < plan.M)
    flat = torch.cat([coefs.reshape(-1), ybar.reshape(-1), s2bar.reshape(-1), tb, dtb])
    blocks = ring.gather(flat)
    split = [B * 4 * J, B * K, B * K, K, K]
    parts = [x.split(split) for x in blocks]
    coefs = parts[0][0]
    for p in parts[1:]:
        coefs = coefs + p[0]
    coefs = coefs.reshape(B, 4 * J)
    ybar = torch.cat([p[1].reshape(B, K) for p in parts], dim=1)
    s2bar = torch.cat([p[2].reshape(B, K) for p in parts], dim=1)
    tb = torch.cat([p[3] for p in parts])
    dtb = torch.cat([p[4] for p in parts])
    # t̄ from the cos/sin partials and the spacing chain rule across the
    # blocks: t̄_m += dt̄_m - dt̄_{m+1}
    tbar = tb + dtb - torch.cat([dtb[1:], dtb.new_zeros(1)])
    return (*coefs.split(J, dim=1), tbar, ybar, s2bar)


class _SeqLoglike(torch.autograd.Function):
    """The pipelined likelihood with its gradient: forward K3's carry
    entry (each micro-batch's residuals kept for this rank's block),
    backward K4's. Chains with ll = -inf get a zero cotangent."""

    @staticmethod
    def forward(ctx, a, b, c, d, t, Y, S2, plan):
        parts, saved = _forward(plan, a, b, c, d, Y, S2, grad=True)
        ll = _reduce(plan, parts)
        ctx.save_for_backward(a, b, c, d, Y, S2, ll)
        ctx.plan, ctx.saved_blocks = plan, saved
        return ll

    @staticmethod
    def backward(ctx, g):
        a, b, c, d, Y, S2, ll = ctx.saved_tensors
        g = torch.where(torch.isfinite(ll), g, torch.zeros_like(g)).contiguous()
        grads = _backward(ctx.plan, a, b, c, d, Y, S2, ctx.saved_blocks, g)
        ab, bb, cb, db, tbar, ybar, s2bar = grads
        ctx.saved_blocks = None
        out = (ab, bb, cb, db, tbar, ybar, s2bar)
        return (*(x if need else None for x, need in zip(out, ctx.needs_input_grad)), None)


def logl_seq_pipelined(a, b, c, d, t, Y, S2, mesh, axis_name: str = "seq",
                       n_micro: Optional[int] = None, dt=None):
    """Batched celerite log-likelihood, (B,): the time axis split into
    blocks over the ranks of the mesh's ``axis_name``, chain micro-batches
    pipelined round the ring.

    ``a..d``: (B, J) coefficients; ``t``: (N,) sorted times shared by the
    chains; ``Y``, ``S2``: (B, N) residuals and noise variances. Every
    rank passes the whole batch; N must be divisible by the axis size, B
    by ``n_micro`` (default: the axis size), else ``ValueError``. ``dt``
    (optional, (N-1,)): the spacings computed in float64 on the host.

    Rank k runs micro-batch m = r - k at round r, so the M micro-batches
    take M + n_dev - 1 rounds. Differentiable (K3/K4's carry entries on
    the card); -inf where the factorisation is not positive definite,
    with a zero gradient there. Every rank returns the same values and
    gradients.
    """
    B, J = a.shape
    plan = _Plan(mesh, axis_name, t.shape[0], B, J, n_micro, t, dt, a.dtype)
    args = (a, b, c, d, t, Y, S2)
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        return _SeqLoglike.apply(*args, plan)
    return _reduce(plan, _forward(plan, a, b, c, d, Y, S2, grad=False)[0])


def logl_seq_sharded(a, b, c, d, t, y, sigma2, mesh, axis_name: str = "seq", dt=None):
    """Celerite log-likelihood of one chain with its time axis split over
    the ranks of the mesh's ``axis_name``: the latency mode, one
    micro-batch. ``a..d`` (J,), ``y`` and ``sigma2`` (N,); a leading batch
    axis ((B, J), (B, N)) runs as one micro-batch too. The value of
    ``ops.celerite.logl``, -inf where the factorisation is not positive
    definite; differentiable."""
    one = a.dim() == 1
    if one:
        a, b, c, d, y, sigma2 = (x[None] for x in (a, b, c, d, y, sigma2))
    ll = logl_seq_pipelined(a, b, c, d, t, y, sigma2, mesh, axis_name, n_micro=1, dt=dt)
    return ll[0] if one else ll


def factor_solve_seq_sharded(a, b, c, d, t, y, sigma2, mesh, axis_name: str = "seq", dt=None):
    """(D, zp) of the whole series, computed blockwise over the ranks: the
    LDL^T diagonal and the forward-substituted residuals, (N,) each for
    one chain (``a..d`` (J,), ``y``, ``sigma2`` (N,)), (B, N) with a
    leading batch axis, on every rank. Enough for the likelihood:
    y^T K^-1 y = sum zp^2 / D, log det K = sum log D. Runs K3's carry
    entry on the card (its D and zp tables), no gradient."""
    one = a.dim() == 1
    if one:
        a, b, c, d, y, sigma2 = (x[None] for x in (a, b, c, d, y, sigma2))
    B, J = a.shape
    plan = _Plan(mesh, axis_name, t.shape[0], B, J, 1, t, dt, a.dtype)
    with torch.no_grad():
        _, saved = _forward(plan, a, b, c, d, y, sigma2, grad=True)
        res = saved[0]
        D = torch.cat(plan.ring.gather(res[4]), dim=1)
        zp = torch.cat(plan.ring.gather(res[5]), dim=1)
    return (D[0], zp[0]) if one else (D, zp)
