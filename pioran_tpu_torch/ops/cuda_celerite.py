"""Batched celerite log-likelihood: the hand-written CUDA kernels, their
plain PyTorch versions, and the dispatchers between them.

Port of the forward path of ``pioran_tpu.ops.pallas_celerite``: the TPU
kernel ``_fused_kernel`` becomes ``csrc/celerite_fwd.cu``, a
warp-per-chain CUDA kernel built by nvcc at first use (see ``_build.py``),
in two instantiations: K1 for a time grid shared by the chains (launched
by ``batched_loglike_pallas_fused`` on the TPU) and K2 for per-chain
ragged grids (``batched_loglike_pallas_multi``).

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

``LAUNCHES`` (K1) and ``MULTI_LAUNCHES`` (K2) count kernel launches, so
a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import _build
from .celerite import exp_neg
from .cuda_celerite_vjp import (
    MAX_TERMS, _lanes, _masked, bwd, check_inputs, fwd_aug, live_steps, log2pi_terms)

__all__ = ["batched_loglike", "batched_loglike_plain", "batched_loglike_multi",
           "batched_loglike_multi_plain", "MAX_TERMS"]

LAUNCHES = 0
MULTI_LAUNCHES = 0
_LIB: Optional[ctypes.CDLL] = None


def _plain(a, b, c, d, t, y, sigma2, dt, n_valid):
    """The kernels' forward loop over N, for a shared t (N,) or per-lane
    t (B, N) with ``n_valid`` (B,) (None: every step counts)."""
    B, J = a.shape
    N = t.shape[-1]
    lanes_t, lanes_dt, live = _lanes(t, dt, B, n_valid)
    zero, inf = a.new_zeros(()), a.new_full((), math.inf)
    suma = torch.sum(a, dim=1)
    S00 = a.new_zeros(B, J, J)
    S01 = a.new_zeros(B, J, J)
    S11 = a.new_zeros(B, J, J)
    f0, f1, W0, W1 = (a.new_zeros(B, J) for _ in range(4))
    Dp, zpp = a.new_zeros(B), a.new_zeros(B)
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
        lib.celerite_fwd_error_string.argtypes = [ctypes.c_int]
        lib.celerite_fwd_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(a, b, c, d, t, y, sigma2, dt, n_valid=None):
    """Run K1 (shared t) or K2 (per-lane t) on CUDA tensors; raise on what
    they do not take."""
    global LAUNCHES, MULTI_LAUNCHES
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
    lib = _lib()
    name = "celerite_fwd_multi" if per_lane else "celerite_fwd"
    fn = getattr(lib, name + ("_f32" if dtype == torch.float32 else "_f64"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[None if x is None else x.data_ptr() for x in args],
                 out.data_ptr(), B, J, N, stream)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: " + lib.celerite_fwd_error_string(err).decode())
    if per_lane:
        MULTI_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out


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
