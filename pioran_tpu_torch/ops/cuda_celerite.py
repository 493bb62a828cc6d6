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
  and CPU tensors to the plain version. It is a
  ``torch.autograd.Function`` whose backward raises until the adjoint
  kernels are ported.

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

__all__ = ["batched_loglike", "batched_loglike_plain", "MAX_TERMS"]

_LOG2PI = math.log(2.0 * math.pi)

MAX_TERMS = 32  # one warp lane per celerite term
LAUNCHES = 0
_LIB: Optional[ctypes.CDLL] = None


def _spacings(t, dt):
    """Per-step spacing with a leading 0: the first step is inert."""
    zero = torch.zeros(1, dtype=t.dtype, device=t.device)
    if dt is None:
        return torch.cat([zero, torch.diff(t)])
    return torch.cat([zero, torch.as_tensor(dt, device=t.device).to(t.dtype)])


def batched_loglike_plain(a, b, c, d, t, y, sigma2, dt=None):
    """Plain PyTorch version of the kernel: (B,) log-likelihoods.

    a, b, c, d: (B, J) coefficients; t: (N,) sorted times shared by the
    chains; y, sigma2: (B, N); dt: optional (N-1,) spacings computed in
    float64 on the host, cast to the working dtype. -inf where the
    factorisation is not positive definite or ll is not finite.
    """
    B, J = a.shape
    N = t.shape[0]
    dtv = _spacings(t, dt)
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
    if a.dim() != 2:
        raise ValueError(f"a must be (B, J), got {tuple(a.shape)}")
    B, J = a.shape
    N = t.shape[0]
    if J > MAX_TERMS:
        raise ValueError(
            f"the CUDA celerite kernel takes at most {MAX_TERMS} terms "
            f"(one warp lane each), got J={J}")
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"float32 or float64 expected, got {a.dtype}")
    dev, dtype = a.device, a.dtype
    for name, x, shape in (("b", b, (B, J)), ("c", c, (B, J)), ("d", d, (B, J)),
                           ("t", t, (N,)), ("y", y, (B, N)),
                           ("sigma2", sigma2, (B, N))):
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {dev}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if dt is not None:
        dt = torch.as_tensor(dt, device=dev).to(dtype)
        if tuple(dt.shape) != (max(N - 1, 0),):
            raise ValueError(f"dt must be ({N - 1},), got {tuple(dt.shape)}")
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


class _BatchedLoglike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, c, d, t, y, sigma2, dt):
        if a.is_cuda:
            return _launch(a, b, c, d, t, y, sigma2, dt)
        return batched_loglike_plain(a, b, c, d, t, y, sigma2, dt)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "batched_loglike has no gradient yet: it needs the adjoint "
            "kernels K3 (_fwd_aug_kernel) and K4 (_bwd_kernel) of "
            "pioran_tpu/ops/pallas_celerite_vjp.py, queued in ROADMAP.md")


def batched_loglike(a, b, c, d, t, y, sigma2, dt=None):
    """Batched celerite log-likelihood, (B,).

    a, b, c, d: (B, J); t: (N,) sorted times shared by the chains;
    y, sigma2: (B, N); dt: optional (N-1,) host-f64 spacings (cast to
    the working dtype). CUDA tensors run the hand-written kernel (or
    raise); CPU tensors run :func:`batched_loglike_plain`. -inf where
    the factorisation is not positive definite.
    """
    return _BatchedLoglike.apply(a, b, c, d, t, y, sigma2, dt)
