"""Batched celerite log-likelihood: the hand-written CUDA kernel, its plain
PyTorch version, and the dispatcher between them.

Port of the forward path of ``pioran_tpu.ops.pallas_celerite``: the TPU
kernel ``_fused_kernel`` (launched by ``batched_loglike_pallas_fused``)
becomes ``csrc/celerite_fwd.cu``, a warp-per-chain CUDA kernel built by
nvcc at first use (see ``_build.py``).

- :func:`batched_loglike_plain` is a Python loop over N on (B, J, J)
  tensors with the kernel's math: the S00/S01/S11 blocks, Kahan sums
  and the -inf rule. The CPU tests use it, and ``chip_smoke.py``
  compares the kernel with it on the card.
- :func:`batched_loglike` sends CUDA tensors to the kernel (or raises)
  and CPU tensors to the plain version. When an input requires a
  gradient it is a ``torch.autograd.Function`` whose forward is the
  augmented forward K3 and whose backward is the reverse sweep K4
  (``ops/cuda_celerite_vjp.py``), or their plain versions on the CPU.

``LAUNCHES`` counts kernel launches, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import _build
from .celerite import exp_neg
from .cuda_celerite_vjp import MAX_TERMS, bwd, check_inputs, fwd_aug, spacings

__all__ = ["batched_loglike", "batched_loglike_plain", "MAX_TERMS"]

_LOG2PI = math.log(2.0 * math.pi)

LAUNCHES = 0
_LIB: Optional[ctypes.CDLL] = None


def batched_loglike_plain(a, b, c, d, t, y, sigma2, dt=None):
    """Plain PyTorch version of the kernel: (B,) log-likelihoods.

    a, b, c, d: (B, J) coefficients; t: (N,) sorted times shared by the
    chains; y, sigma2: (B, N); dt: optional (N-1,) spacings computed in
    float64 on the host, cast to the working dtype. -inf where the
    factorisation is not positive definite or ll is not finite.
    """
    B, J = a.shape
    N = t.shape[0]
    dtv = spacings(t, dt)
    suma = torch.sum(a, dim=1)
    S00 = a.new_zeros(B, J, J)
    S01 = a.new_zeros(B, J, J)
    S11 = a.new_zeros(B, J, J)
    f0, f1, W0, W1 = (a.new_zeros(B, J) for _ in range(4))
    Dp, zpp = a.new_zeros(B), a.new_zeros(B)
    logdet, clog, quad, cquad = (a.new_zeros(B) for _ in range(4))
    minD = torch.full((B,), math.inf, dtype=a.dtype, device=a.device)

    for n in range(N):
        co = torch.cos(d * t[n])
        si = torch.sin(d * t[n])
        U0 = a * co + b * si
        U1 = a * si - b * co
        ec = exp_neg(c * dtv[n])

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

        # Kahan-compensated sums: O(sqrt N) float32 error instead of O(N)
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


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("celerite_fwd")
        for fn in (lib.celerite_fwd_f32, lib.celerite_fwd_f64):
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.celerite_fwd_error_string.argtypes = [ctypes.c_int]
        lib.celerite_fwd_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(a, b, c, d, t, y, sigma2, dt):
    """Run the CUDA kernel on CUDA tensors; raise on what it does not take."""
    global LAUNCHES
    dt = check_inputs(a, b, c, d, t, y, sigma2, dt)
    B, J = a.shape
    N = t.shape[0]
    dtype, dev = a.dtype, a.device
    out = torch.empty(B, dtype=dtype, device=dev)
    if B == 0 or N == 0:
        return out
    args = [x.contiguous() for x in (a, b, c, d, t)]
    args.append(None if dt is None else dt.contiguous())
    args += [y.contiguous(), sigma2.contiguous()]
    lib = _lib()
    fn = lib.celerite_fwd_f32 if dtype == torch.float32 else lib.celerite_fwd_f64
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[None if x is None else x.data_ptr() for x in args],
                 out.data_ptr(), B, J, N, stream)
    if err != 0:
        raise RuntimeError(
            "celerite_fwd launch failed: "
            + lib.celerite_fwd_error_string(err).decode())
    LAUNCHES += 1
    return out


def _forward(a, b, c, d, t, y, sigma2, dt):
    if a.is_cuda:
        return _launch(a, b, c, d, t, y, sigma2, dt)
    return batched_loglike_plain(a, b, c, d, t, y, sigma2, dt)


class _BatchedLoglike(torch.autograd.Function):
    """Forward K3 (saving its residual tables), backward K4. Chains with
    ll = -inf get a zero cotangent and so a zero gradient; ``dt`` gets
    none (the t cotangent assumes dt = diff(t))."""

    @staticmethod
    def forward(ctx, a, b, c, d, t, y, sigma2, dt):
        ll, residuals = fwd_aug(a, b, c, d, t, y, sigma2, dt)
        ctx.save_for_backward(a, b, c, d, t, y, sigma2, ll, *residuals)
        ctx.dt = dt
        return ll

    @staticmethod
    def backward(ctx, g):
        a, b, c, d, t, y, sigma2, ll, *residuals = ctx.saved_tensors
        g = torch.where(torch.isfinite(ll), g, torch.zeros_like(g))
        grads = bwd(a, b, c, d, t, y, sigma2, residuals, g, ctx.dt)
        return (*(gr if need else None
                  for gr, need in zip(grads, ctx.needs_input_grad)), None)


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
    args = (a, b, c, d, t, y, sigma2)
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        return _BatchedLoglike.apply(*args, dt)
    return _forward(*args, dt)
