"""Batched celerite log-likelihood: the hand-written CUDA kernels, their
plain PyTorch versions, and the dispatchers between them.

Port of the forward path of ``pioran_tpu.ops.pallas_celerite``: the TPU
kernel ``_fused_kernel`` becomes ``csrc/celerite_fwd.cu``, a
warp-per-chain CUDA kernel built by nvcc at first use (see ``_build.py``),
in two instantiations: K1 for a time grid shared by the chains (launched
by ``batched_loglike_pallas_fused`` on the TPU) and K2 for per-chain
ragged grids (``batched_loglike_pallas_multi``). The table-streaming TPU
kernel ``_kernel`` (K0, launched by ``batched_loglike_pallas``) becomes
``csrc/celerite_tables.cu``: it reads the U, V and phi tables that
:func:`build_tables` writes instead of building them.

- :func:`batched_loglike_plain` and :func:`batched_loglike_multi_plain`
  are Python loops over N on (B, J, J) tensors with the kernels' math:
  the S00/S01/S11 blocks, Kahan sums and the -inf rule. The CPU tests use
  them, and ``chip_smoke.py`` compares the kernels with them on the card.
- :func:`batched_loglike` and :func:`batched_loglike_multi` send CUDA
  tensors to the kernels (or raise) and CPU tensors to the plain
  versions. When an input requires a gradient they are a
  ``torch.autograd.Function`` whose forward is the augmented forward K3
  and whose backward is the reverse sweep K4
  (``ops/cuda_celerite_vjp.py``), or their plain versions on the CPU.

- :func:`build_tables`, :func:`loglike_from_tables` and
  :func:`batched_loglike_tables` are K0's entry points, with
  :func:`loglike_from_tables_plain` its plain version. K0 has no adjoint
  (nor has the TPU kernel): its wrappers raise on an input that requires
  a gradient.

- :func:`loglike_carry` is K1's carry entry: one block of a series split
  along time, started from the state the previous block ended with
  (``cuda_celerite_vjp``'s carry layout), returning the block's partials
  (Kahan sums of log|D| and zp^2 / D, min D) and its final state; the
  time-sharded scan (``parallel/seq_scan.py``) runs it for its sweeps
  without a gradient. ``CARRY_LAUNCHES`` and ``WIDE_CARRY_LAUNCHES``
  count its launches.

Past ``NARROW_TERMS`` = 32 terms the kernels' wide forms run instead,
from ``csrc/celerite_wide.cu``: one thread block a chain, up to
``MAX_TERMS`` terms, in the design ``cuda_celerite_vjp.wide_shape`` picks
(two threads a row of the 2J x 2J state in registers; past 64 terms
the part of a thread's row that the registers do not hold in shared
memory or a device scratch).

``LAUNCHES`` (K1), ``MULTI_LAUNCHES`` (K2) and ``TABLES_LAUNCHES`` (K0)
count kernel launches, so a run can show that its main path went through
the kernels; ``WIDE_LAUNCHES``, ``WIDE_MULTI_LAUNCHES`` and
``WIDE_TABLES_LAUNCHES`` count those of the wide forms.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import _build
from .celerite import exp_neg
from .cuda_celerite_vjp import (
    MAX_TERMS, NARROW_TERMS, _call, _lanes, _masked, _scratch, _wide_lib, block_lanes, bwd,
    carry_width, check_carry, check_inputs, fwd_aug, initial_state, live_steps, log2pi_terms,
    pack_carry, wide_shape)

__all__ = ["batched_loglike", "batched_loglike_plain", "batched_loglike_multi",
           "batched_loglike_multi_plain", "build_tables", "loglike_from_tables",
           "loglike_from_tables_plain", "batched_loglike_tables", "tables_launch_shape",
           "loglike_carry",
           "MAX_TERMS", "NARROW_TERMS"]

LAUNCHES = 0
MULTI_LAUNCHES = 0
TABLES_LAUNCHES = 0
WIDE_LAUNCHES = 0
WIDE_MULTI_LAUNCHES = 0
WIDE_TABLES_LAUNCHES = 0
CARRY_LAUNCHES = 0
WIDE_CARRY_LAUNCHES = 0
_LOG2PI = math.log(2.0 * math.pi)
_LIB: Optional[ctypes.CDLL] = None
_TABLES_LIB: Optional[ctypes.CDLL] = None


def _plain(a, b, c, d, t, y, sigma2, dt, n_valid, carry=None):
    """The kernels' forward loop over N, for a shared t (N,) or per-lane
    t (B, N) with ``n_valid`` (B,) (None: every step counts).

    With a forward ``carry`` (B, 3 J^2 + 4 J + 2) this is K1's carry
    entry: the loop starts from the carried state, ``dt`` (N,) is every
    step's spacing with the boundary's first, and the result is
    ``(partials (B, 3), carry out)``: the Kahan sums of log|D| and
    zp^2 / D, min D, and the state after the last step."""
    B, J = a.shape
    N = t.shape[-1]
    lanes_t, lanes_dt, live = (_lanes(t, dt, B, n_valid) if carry is None
                               else block_lanes(t, dt, B))
    zero, inf = a.new_zeros(()), a.new_full((), math.inf)
    suma = torch.sum(a, dim=1)
    S00, S01, S11, W0, W1, f0, f1, Dp, zpp = initial_state(a, carry)
    logdet, clog, quad, cquad = (a.new_zeros(B) for _ in range(4))
    minD = torch.full((B,), math.inf, dtype=a.dtype, device=a.device)

    for n in range(N):
        co = torch.cos(d * lanes_t[:, n, None])
        si = torch.sin(d * lanes_t[:, n, None])
        U0 = a * co + b * si
        U1 = a * si - b * co
        ec = exp_neg(c * lanes_dt[:, n, None])

        # S is symmetric: only S00, S01, S11 are kept (S10 = S01^T)
        ee = ec[:, :, None] * ec[:, None, :]
        Wd0 = W0 * Dp[:, None]
        Wd1 = W1 * Dp[:, None]
        S00 = ee * (S00 + Wd0[:, :, None] * W0[:, None, :])
        S01 = ee * (S01 + Wd0[:, :, None] * W1[:, None, :])
        S11 = ee * (S11 + Wd1[:, :, None] * W1[:, None, :])
        SU0 = (S00 @ U0[:, :, None] + S01 @ U1[:, :, None])[..., 0]
        SU1 = (S01.transpose(1, 2) @ U0[:, :, None] + S11 @ U1[:, :, None])[..., 0]
        Dn = suma + sigma2[:, n] - torch.sum(U0 * SU0, 1) - torch.sum(U1 * SU1, 1)

        f0 = ec * (f0 + W0 * zpp[:, None])
        f1 = ec * (f1 + W1 * zpp[:, None])
        zpn = y[:, n] - torch.sum(U0 * f0, 1) - torch.sum(U1 * f1, 1)
        W0 = (co - SU0) / Dn[:, None]
        W1 = (si - SU1) / Dn[:, None]
        Dp, zpp = Dn, zpn

        # Kahan-compensated sums over the live steps: O(sqrt N) float32
        # error instead of O(N)
        x2 = _masked(live, n, torch.log(torch.abs(Dn)), zero) - clog
        t2 = logdet + x2
        clog = (t2 - logdet) - x2
        logdet = t2
        x3 = _masked(live, n, zpn * zpn / Dn, zero) - cquad
        t3 = quad + x3
        cquad = (t3 - quad) - x3
        quad = t3
        minD = torch.minimum(minD, _masked(live, n, Dn, inf))

    if carry is not None:
        return (torch.stack([logdet, quad, minD], dim=1),
                pack_carry(S00, S01, S11, W0, W1, f0, f1, Dp, zpp))
    ll = -0.5 * (logdet + quad + log2pi_terms(N, n_valid, a.dtype))
    ok = (minD > 0) & torch.isfinite(ll)
    return torch.where(ok, ll, torch.full_like(ll, -math.inf))


def batched_loglike_plain(a, b, c, d, t, y, sigma2, dt=None):
    """Plain PyTorch version of K1: (B,) log-likelihoods.

    a, b, c, d: (B, J) coefficients; t: (N,) sorted times shared by the
    chains; y, sigma2: (B, N); dt: optional (N-1,) spacings computed in
    float64 on the host, cast to the working dtype. -inf where the
    factorisation is not positive definite or ll is not finite.
    """
    return _plain(a, b, c, d, t, y, sigma2, dt, None)


def batched_loglike_multi_plain(a, b, c, d, t, y, sigma2, n_valid, dt=None):
    """Plain PyTorch version of K2: (B,) log-likelihoods of ragged series.

    t: (B, N) per-chain sorted times, padded past each chain's
    ``n_valid`` (B,) points (edge padding: dt = 0); y, sigma2: (B, N);
    dt: optional (B, N-1) host-f64 spacings. Only steps below ``n_valid``
    count toward the sums and the -inf check; the constant term is
    ``n_valid`` log 2 pi. sigma2 is used as given (the dispatcher sets it
    to 1 on the padding first).
    """
    return _plain(a, b, c, d, t, y, sigma2, dt, torch.as_tensor(n_valid, device=a.device))


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("celerite_fwd")
        for fn in (lib.celerite_fwd_f32, lib.celerite_fwd_f64):
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for fn in (lib.celerite_fwd_multi_f32, lib.celerite_fwd_multi_f64):
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for fn in (lib.celerite_fwd_carry_f32, lib.celerite_fwd_carry_f64):
            fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.celerite_fwd_error_string.argtypes = [ctypes.c_int]
        lib.celerite_fwd_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(a, b, c, d, t, y, sigma2, dt, n_valid=None):
    """Run K1 (shared t) or K2 (per-lane t) on CUDA tensors, their wide
    forms past ``NARROW_TERMS`` terms; raise on what they do not take."""
    global LAUNCHES, MULTI_LAUNCHES, WIDE_LAUNCHES, WIDE_MULTI_LAUNCHES
    dt, n_valid = check_inputs(a, b, c, d, t, y, sigma2, dt, n_valid)
    per_lane = n_valid is not None
    B, J = a.shape
    N = t.shape[-1]
    dtype, dev = a.dtype, a.device
    out = torch.empty(B, dtype=dtype, device=dev)
    if B == 0 or N == 0:
        return out
    args = [x.contiguous() for x in (a, b, c, d, t)]
    args.append(None if dt is None else dt.contiguous())
    args += [y.contiguous(), sigma2.contiguous()]
    args += [n_valid] if per_lane else []
    args.append(out)
    wide = J > NARROW_TERMS
    if wide:
        lib = _wide_lib()
        errors = lib.celerite_wide_error_string
        name = "celerite_wide_fwd_multi" if per_lane else "celerite_wide_fwd"
        shape = wide_shape(J, dtype, B)
        args.append(_scratch(B, shape.fwd_scratch, a))
    else:
        lib = _lib()
        errors = lib.celerite_fwd_error_string
        name = "celerite_fwd_multi" if per_lane else "celerite_fwd"
    fn = getattr(lib, name + ("_f32" if dtype == torch.float32 else "_f64"))
    _call(fn, errors, name, dev, args, (B, J, N, shape.cpt) if wide else (B, J, N))
    if wide and per_lane:
        WIDE_MULTI_LAUNCHES += 1
    elif wide:
        WIDE_LAUNCHES += 1
    elif per_lane:
        MULTI_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out


def _launch_carry(a, b, c, d, t, y, sigma2, dt, carry):
    """Run K1's carry entry on CUDA tensors, its wide form past
    ``NARROW_TERMS`` terms; raise on what it does not take."""
    global CARRY_LAUNCHES, WIDE_CARRY_LAUNCHES
    B, J = a.shape
    dt = check_carry(a, b, c, d, t, y, sigma2, dt, carry, carry_width(J))
    N = t.shape[0]
    parts = torch.empty(B, 3, dtype=a.dtype, device=a.device)
    cout = torch.empty(B, carry_width(J), dtype=a.dtype, device=a.device)
    if B == 0 or N == 0:
        return parts, carry.clone()
    args = [x.contiguous() for x in (a, b, c, d, t, dt, y, sigma2, carry)] + [cout, parts]
    wide = J > NARROW_TERMS
    if wide:
        lib, name = _wide_lib(), "celerite_wide_fwd_carry"
        errors = lib.celerite_wide_error_string
        shape = wide_shape(J, a.dtype, B)
        args.append(_scratch(B, shape.fwd_scratch, a))
    else:
        lib, name = _lib(), "celerite_fwd_carry"
        errors = lib.celerite_fwd_error_string
    fn = getattr(lib, name + ("_f32" if a.dtype == torch.float32 else "_f64"))
    _call(fn, errors, name, a.device, args, (B, J, N, shape.cpt) if wide else (B, J, N))
    if wide:
        WIDE_CARRY_LAUNCHES += 1
    else:
        CARRY_LAUNCHES += 1
    return parts, cout


def loglike_carry(a, b, c, d, t, y, sigma2, dt, carry):
    """K1's carry entry, one block of a series split along time:
    ``(partials (B, 3), carry out)``, no gradient. ``t`` (N,) the block's
    times, ``dt`` (N,) every step's spacing with the boundary's first (0
    for the first block), ``carry`` the state (B, 3 J^2 + 4 J + 2) the
    previous block ended with (``cuda_celerite_vjp.neutral_carry`` for the
    first). The partials are the Kahan sums of log|D| and zp^2 / D and
    min D; -1/2 (their sums over the blocks + N log 2 pi) is the
    log-likelihood. CUDA tensors launch the kernel (or raise), CPU tensors
    run the plain loop."""
    if a.is_cuda:
        return _launch_carry(a, b, c, d, t, y, sigma2, dt, carry)
    dt = check_carry(a, b, c, d, t, y, sigma2, dt, carry, carry_width(a.shape[1]))
    return _plain(a, b, c, d, t, y, sigma2, dt, None, carry=carry)


def _forward(a, b, c, d, t, y, sigma2, dt, n_valid):
    if a.is_cuda:
        return _launch(a, b, c, d, t, y, sigma2, dt, n_valid)
    return _plain(a, b, c, d, t, y, sigma2, dt, n_valid)


class _BatchedLoglike(torch.autograd.Function):
    """Forward K3 (saving its residual tables), backward K4. Chains with
    ll = -inf get a zero cotangent and so a zero gradient; ``dt`` and
    ``n_valid`` get none (the t cotangent assumes dt = diff(t)). With
    ``n_valid``, the t, y and sigma2 cotangents are zero past it."""

    @staticmethod
    def forward(ctx, a, b, c, d, t, y, sigma2, dt, n_valid):
        ll, residuals = fwd_aug(a, b, c, d, t, y, sigma2, dt, n_valid=n_valid)
        ctx.save_for_backward(a, b, c, d, t, y, sigma2, ll, *residuals)
        ctx.dt, ctx.n_valid = dt, n_valid
        return ll

    @staticmethod
    def backward(ctx, g):
        a, b, c, d, t, y, sigma2, ll, *residuals = ctx.saved_tensors
        g = torch.where(torch.isfinite(ll), g, torch.zeros_like(g))
        grads = bwd(a, b, c, d, t, y, sigma2, residuals, g, ctx.dt, n_valid=ctx.n_valid)
        if ctx.n_valid is not None:
            live = live_steps(ctx.n_valid, t.shape[-1])
            grads = grads[:4] + tuple(torch.where(live, x, torch.zeros_like(x))
                                      for x in grads[4:])
        return (*(gr if need else None
                  for gr, need in zip(grads, ctx.needs_input_grad)), None, None)


def _dispatch(a, b, c, d, t, y, sigma2, dt, n_valid):
    args = (a, b, c, d, t, y, sigma2)
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        return _BatchedLoglike.apply(*args, dt, n_valid)
    return _forward(*args, dt, n_valid)


def batched_loglike(a, b, c, d, t, y, sigma2, dt=None):
    """Batched celerite log-likelihood, (B,), differentiable.

    a, b, c, d: (B, J); t: (N,) sorted times shared by the chains;
    y, sigma2: (B, N); dt: optional (N-1,) host-f64 spacings (cast to
    the working dtype, no gradient). CUDA tensors run the hand-written
    kernels (or raise); CPU tensors their plain versions. With no input
    requiring a gradient this is one forward kernel (K1) that saves
    nothing; otherwise K3 saves the residual tables and the backward
    runs K4. -inf where the factorisation is not positive definite,
    with a zero gradient there.
    """
    return _dispatch(a, b, c, d, t, y, sigma2, dt, None)


def batched_loglike_multi(a, b, c, d, t, y, sigma2, n_valid, dt=None):
    """Batched log-likelihood of ragged series with per-chain time grids,
    (B,), differentiable: the multi-dataset axis (D datasets x C chains
    stacked into B rows).

    t: (B, N) per-chain sorted times, each padded with its last value
    past its ``n_valid`` (B,) points; y, sigma2: (B, N); dt: optional
    (B, N-1) host-f64 spacings (trailing zeros on the padding). sigma2 is
    set to 1 past ``n_valid`` first, so the padded steps stay benign.
    With no input requiring a gradient this is K2; otherwise the
    per-lane K3 forward and K4 backward. The t, y and sigma2 cotangents
    are zero past ``n_valid``; ``n_valid`` and ``dt`` get none. CUDA
    tensors run the kernels (or raise), CPU tensors the plain versions.
    """
    n_valid = torch.as_tensor(n_valid, device=a.device).to(torch.int32)
    sigma2 = torch.where(live_steps(n_valid, t.shape[-1]), sigma2, torch.ones_like(sigma2))
    return _dispatch(a, b, c, d, t, y, sigma2, dt, n_valid)


# ---------------------------------------------------------------------------
# K0: the likelihood from streamed U, V, phi tables
# ---------------------------------------------------------------------------


def build_tables(a, b, c, d, t):
    """U, V, phi tables of shape (N, R, B), R = 2J, the batch last: the
    layout of the JAX package's ``build_tables`` and the input of K0.

    a, b, c, d: (B, J) coefficients; t: (N,) sorted times shared by the
    chains. Rows are in the block layout [J cos-type; J sin-type] (a row
    permutation of :func:`~pioran_tpu_torch.ops.celerite.build_uv`'s
    interleaved one): U = [a cos + b sin; a sin - b cos], V = [cos; sin],
    phi = [ec; ec] with ec = exp_neg(c dt), dt = diff(t) in the working
    dtype, and an all-zero first row of phi.
    """
    aT, bT, cT, dT = a.T, b.T, c.T, d.T  # (J, B)
    td = t[:, None, None] * dT[None]  # (N, J, B)
    co, si = torch.cos(td), torch.sin(td)
    U = torch.cat([aT * co + bT * si, aT * si - bT * co], dim=1)
    V = torch.cat([co, si], dim=1)
    ec = exp_neg(torch.diff(t)[:, None, None] * cT[None])  # (N-1, J, B)
    phi = torch.cat([ec, ec], dim=1)
    phi = torch.cat([torch.zeros_like(phi[:1]), phi], dim=0)
    return U, V, phi


def loglike_from_tables_plain(U, V, phi, y, sigma2, suma):
    """Plain PyTorch version of K0: (B,) log-likelihoods.

    U, V, phi: (N, R, B) tables; y, sigma2: (B, N); suma: (B,) the sum of
    each chain's a. A Python loop over N on (B, R, R) states with the TPU
    kernel's statements: T = S + D W W^T, S = (phi phi^T) o T, q = S U,
    D = suma + sigma2 - U.q, W = (V - q) / D, f = phi o (f + W zp),
    zp = y - U.f, Kahan sums of log|D| and zp^2 / D, and -inf unless
    every D > 0 and the result is finite.
    """
    N, R, B = U.shape
    S = U.new_zeros(B, R, R)
    f, W = U.new_zeros(B, R), U.new_zeros(B, R)
    Dp, zpp = U.new_zeros(B), U.new_zeros(B)
    logdet, clog, quad, cquad = (U.new_zeros(B) for _ in range(4))
    minD = torch.full((B,), math.inf, dtype=U.dtype, device=U.device)
    for n in range(N):
        Un, Vn, pn = U[n].T, V[n].T, phi[n].T  # (B, R)
        S = (pn[:, :, None] * pn[:, None, :]) * (
            S + Dp[:, None, None] * (W[:, :, None] * W[:, None, :]))
        q = torch.sum(S * Un[:, None, :], dim=2)
        Dn = suma + sigma2[:, n] - torch.sum(Un * q, dim=1)
        Wn = (Vn - q) / Dn[:, None]
        f = pn * (f + W * zpp[:, None])
        zpn = y[:, n] - torch.sum(Un * f, dim=1)
        W, Dp, zpp = Wn, Dn, zpn
        x2 = torch.log(torch.abs(Dn)) - clog
        t2 = logdet + x2
        clog = (t2 - logdet) - x2
        logdet = t2
        x3 = zpn * zpn / Dn - cquad
        t3 = quad + x3
        cquad = (t3 - quad) - x3
        quad = t3
        minD = torch.minimum(minD, Dn)
    ll = -0.5 * (logdet + quad + N * _LOG2PI)
    ok = (minD > 0) & torch.isfinite(ll)
    return torch.where(ok, ll, torch.full_like(ll, -math.inf))


def _tables_lib() -> ctypes.CDLL:
    global _TABLES_LIB
    if _TABLES_LIB is None:
        lib = _build.load("celerite_tables")
        for fn in (lib.celerite_tables_f32, lib.celerite_tables_f64):
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for fn in (lib.celerite_tables_at_f32, lib.celerite_tables_at_f64):
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.celerite_tables_shape.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.celerite_tables_shape.restype = ctypes.c_int
        lib.celerite_tables_error_string.argtypes = [ctypes.c_int]
        lib.celerite_tables_error_string.restype = ctypes.c_char_p
        _TABLES_LIB = lib
    return _TABLES_LIB


def tables_launch_shape(B: int, J: int, dtype=torch.float32) -> dict:
    """The launch shape K0 picks on the current card for B chains of J
    terms: ``chains`` a block (one warp each), ``steps`` a staged chunk,
    ``smem`` bytes of shared memory a block, ``blocks_per_sm`` resident
    on one SM (the occupancy calculator) and the card's ``sms``."""
    lib = _tables_lib()
    res = (ctypes.c_int * 5)()
    err = lib.celerite_tables_shape(B, J, torch.empty((), dtype=dtype).element_size(), res)
    if err != 0:
        raise RuntimeError("celerite_tables_shape failed: "
                           + lib.celerite_tables_error_string(err).decode())
    return dict(zip(("chains", "steps", "smem", "blocks_per_sm", "sms"), res))


def _check_tables(U, V, phi, y, sigma2, suma):
    """Raise ``ValueError`` on what K0 does not take: an odd R, J = R / 2
    > ``MAX_TERMS``, a dtype other than float32/float64, mixed dtypes or
    devices, or wrong shapes."""
    if U.dim() != 3:
        raise ValueError(f"U must be (N, R, B), got {tuple(U.shape)}")
    N, R, B = U.shape
    if R % 2 or R == 0:
        raise ValueError(f"the tables need an even R = 2J > 0 rows, got R={R}")
    if R // 2 > MAX_TERMS:
        raise ValueError(
            f"the CUDA celerite kernels take at most {MAX_TERMS} terms "
            f"(two threads a row of the 2J x 2J state), got J={R // 2}")
    if U.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"float32 or float64 expected, got {U.dtype}")
    for name, x, shape in (("V", V, (N, R, B)), ("phi", phi, (N, R, B)), ("y", y, (B, N)),
                           ("sigma2", sigma2, (B, N)), ("suma", suma, (B,))):
        if x.device != U.device or x.dtype != U.dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"{name}: expected {U.dtype} {shape} on {U.device}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")


def _launch_tables(U, V, phi, y, sigma2, suma, shape=None):
    """Run K0 on CUDA tensors, its wide form past ``NARROW_TERMS`` terms;
    raise on what it does not take. ``shape`` = (chains a block, steps a
    chunk) overrides the shape K0 picks from B (chains 1, 2 or 4; steps
    4, 8, 16 or 32; the warp-per-chain form only)."""
    global TABLES_LAUNCHES, WIDE_TABLES_LAUNCHES
    _check_tables(U, V, phi, y, sigma2, suma)
    N, R, B = U.shape
    out = torch.empty(B, dtype=U.dtype, device=U.device)
    if B == 0 or N == 0:
        return out
    args = [x.contiguous() for x in (U, V, phi, y, sigma2, suma)]
    f32 = U.dtype == torch.float32
    if R // 2 > NARROW_TERMS:
        if shape is not None:
            raise ValueError("a launch shape is the warp-per-chain K0's (J <= 32)")
        lib = _wide_lib()
        fn = lib.celerite_wide_tables_f32 if f32 else lib.celerite_wide_tables_f64
        shape = wide_shape(R // 2, U.dtype, B)
        state = _scratch(B, shape.fwd_scratch, U)
        _call(fn, lib.celerite_wide_error_string, "celerite_wide_tables", U.device,
              [*args, out, state], (B, R // 2, N, shape.cpt))
        WIDE_TABLES_LAUNCHES += 1
        return out
    lib = _tables_lib()
    if shape is None:
        fn, extra = (lib.celerite_tables_f32 if f32 else lib.celerite_tables_f64), ()
    else:
        fn, extra = (lib.celerite_tables_at_f32 if f32 else lib.celerite_tables_at_f64), shape
    with torch.cuda.device(U.device):
        stream = torch.cuda.current_stream(U.device).cuda_stream
        err = fn(*[x.data_ptr() for x in args], out.data_ptr(), B, R // 2, N, *extra, stream)
    if err != 0:
        raise RuntimeError(
            "celerite_tables launch failed: "
            + lib.celerite_tables_error_string(err).decode())
    TABLES_LAUNCHES += 1
    return out


def loglike_from_tables(U, V, phi, y, sigma2, suma):
    """(B,) log-likelihoods from the (N, R, B) tables of
    :func:`build_tables`, y and sigma2 (B, N) and suma (B,), the sum of
    each chain's a: K0 for CUDA tensors (or it raises), its plain version
    for CPU tensors. K0 has no adjoint, so an input that requires a
    gradient raises ``ValueError`` instead of yielding a wrong one."""
    args = (U, V, phi, y, sigma2, suma)
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        raise ValueError(
            "the table-streaming likelihood (K0) has no gradient; use batched_loglike "
            "(K3/K4) for one, or call this under torch.no_grad()")
    if U.is_cuda:
        return _launch_tables(*args)
    return loglike_from_tables_plain(*args)


def batched_loglike_tables(a, b, c, d, t, y, sigma2):
    """The batched celerite log-likelihood through the table-streaming
    kernel, (B,): :func:`build_tables`, then :func:`loglike_from_tables`
    with suma = sum(a). The counterpart of the JAX package's
    ``batched_loglike_pallas``; a, b, c, d (B, J), t (N,) shared, y and
    sigma2 (B, N). The spacings are diff(t) in the working dtype. No
    gradient: an input that requires one raises ``ValueError``."""
    U, V, phi = build_tables(a, b, c, d, t)
    return loglike_from_tables(U, V, phi, y, sigma2, torch.sum(a, dim=1))
