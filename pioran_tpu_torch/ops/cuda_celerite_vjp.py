"""The celerite likelihood's adjoint: the hand-written CUDA kernels K3 and
K4, their plain PyTorch versions, and the wrappers between them.

Port of ``pioran_tpu.ops.pallas_celerite_vjp`` for a time grid shared by
the chains. The TPU kernels ``_fwd_aug_kernel`` (K3) and ``_bwd_kernel``
(K4) become ``csrc/celerite_adjoint.cu``, built by nvcc at first use
(see ``_build.py``).

- :func:`fwd_aug` runs the forward sweep and also returns the residual
  tables the reverse sweep reads: per step W0, W1, pre0, pre1 (B, N, J),
  D and zp (B, N), and a checkpoint of the T blocks every ``kc`` steps
  (B, ceil(N / kc), 3, J, J).
- :func:`bwd` takes those tables and a cotangent ``g`` (B,) of the
  log-likelihoods and returns the cotangents of (a, b, c, d, t, y,
  sigma2); ``t``'s is summed over the chains and includes the chain rule
  through the spacings, t̄_m += dt̄_m - dt̄_{m+1}.

CUDA tensors go to the kernels, or raise; CPU tensors go to
:func:`fwd_aug_plain` and :func:`bwd_plain`, Python loops over N on
(B, J, J) tensors that follow the TPU kernels statement by statement.
``chip_smoke.py`` holds the kernels against them on the card.

There is no counterpart of the TPU code's VMEM tiling (``auto_tiles``,
``fits_vmem``), its scan fallback, or its ``SEG_STEPS`` launch
segmentation: the tables live in device memory and one launch runs all N
steps. ``FWD_AUG_LAUNCHES`` and ``BWD_LAUNCHES`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from .. import _build
from .celerite import exp_neg

__all__ = ["fwd_aug", "fwd_aug_plain", "bwd", "bwd_plain", "residual_bytes",
           "check_inputs", "spacings", "KC", "MAX_TERMS"]

_LOG2PI = math.log(2.0 * math.pi)

MAX_TERMS = 32  # one warp lane per celerite term
KC = 8          # steps between T checkpoints
FWD_AUG_LAUNCHES = 0
BWD_LAUNCHES = 0
_LIB: Optional[ctypes.CDLL] = None

Residuals = Tuple[torch.Tensor, ...]


def spacings(t, dt=None):
    """(N,) per-step spacing with a leading 0 (the first step is inert):
    ``diff(t)``, or the host-f64 ``dt`` (N-1,) cast to t's dtype."""
    zero = torch.zeros(1, dtype=t.dtype, device=t.device)
    if dt is None:
        return torch.cat([zero, torch.diff(t)])
    return torch.cat([zero, torch.as_tensor(dt, device=t.device).to(t.dtype)])


def check_inputs(a, b, c, d, t, y, sigma2, dt):
    """Raise ``ValueError`` on what the CUDA kernels do not take: J > 32,
    a dtype other than float32/float64, mixed dtypes or devices, or wrong
    shapes. Returns dt cast to the working dtype (or None)."""
    if a.dim() != 2:
        raise ValueError(f"a must be (B, J), got {tuple(a.shape)}")
    B, J = a.shape
    N = t.shape[0]
    if J > MAX_TERMS:
        raise ValueError(
            f"the CUDA celerite kernels take at most {MAX_TERMS} terms "
            f"(one warp lane each), got J={J}")
    if a.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"float32 or float64 expected, got {a.dtype}")
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
    return dt


def residual_bytes(B: int, J: int, N: int, kc: int = KC,
                   dtype: torch.dtype = torch.float32) -> Tuple[int, int, int]:
    """Bytes of (the per-step tables, the T checkpoints, K4's scratch)."""
    item = torch.empty((), dtype=dtype).element_size()
    nck = -(-N // kc)
    return (item * B * N * (4 * J + 2), item * B * nck * 3 * J * J,
            item * B * kc * 4 * J * J)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _mv(M, v):
    """Batched matrix-vector product (B, J, J) x (B, J) -> (B, J)."""
    return (M @ v[:, :, None])[:, :, 0]


def fwd_aug_plain(a, b, c, d, t, y, sigma2, dt=None, kc: int = KC):
    """Plain PyTorch version of K3: ``(ll (B,), residuals)``.

    ll is :func:`cuda_celerite.batched_loglike_plain`'s value; residuals
    are (W0, W1, pre0, pre1) (B, N, J), (D, zp) (B, N) and the T
    checkpoints (B, ceil(N / kc), 3, J, J) of steps 0, kc, 2 kc, ...
    """
    B, J = a.shape
    N = t.shape[0]
    dtv = spacings(t, dt)
    suma = torch.sum(a, dim=1)
    S00, S01, S11 = (a.new_zeros(B, J, J) for _ in range(3))
    f0, f1, W0, W1 = (a.new_zeros(B, J) for _ in range(4))
    Dp, zpp = a.new_zeros(B), a.new_zeros(B)
    logdet, clog, quad, cquad = (a.new_zeros(B) for _ in range(4))
    minD = torch.full((B,), math.inf, dtype=a.dtype, device=a.device)
    tabs = ([], [], [], [], [], [])
    ckpts = []

    for n in range(N):
        co = torch.cos(d * t[n])
        si = torch.sin(d * t[n])
        U0 = a * co + b * si
        U1 = a * si - b * co
        ec = exp_neg(c * dtv[n])
        ee = ec[:, :, None] * ec[:, None, :]
        Wd0 = W0 * Dp[:, None]
        Wd1 = W1 * Dp[:, None]
        T00 = S00 + Wd0[:, :, None] * W0[:, None, :]
        T01 = S01 + Wd0[:, :, None] * W1[:, None, :]
        T11 = S11 + Wd1[:, :, None] * W1[:, None, :]
        if n % kc == 0:
            ckpts.append(torch.stack([T00, T01, T11], dim=1))
        S00, S01, S11 = ee * T00, ee * T01, ee * T11
        SU0 = _mv(S00, U0) + _mv(S01, U1)
        SU1 = _mv(S01.transpose(1, 2), U0) + _mv(S11, U1)
        Dn = suma + sigma2[:, n] - torch.sum(U0 * SU0, 1) - torch.sum(U1 * SU1, 1)

        pre0 = f0 + W0 * zpp[:, None]
        pre1 = f1 + W1 * zpp[:, None]
        f0, f1 = ec * pre0, ec * pre1
        zpn = y[:, n] - torch.sum(U0 * f0, 1) - torch.sum(U1 * f1, 1)
        W0 = (co - SU0) / Dn[:, None]
        W1 = (si - SU1) / Dn[:, None]
        for lst, x in zip(tabs, (W0, W1, pre0, pre1, Dn, zpn)):
            lst.append(x)
        Dp, zpp = Dn, zpn

        # Kahan-compensated sums, as in the kernel
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
    ll = torch.where(ok, ll, torch.full_like(ll, -math.inf))
    residuals = tuple(torch.stack(lst, dim=1) for lst in tabs) + (torch.stack(ckpts, dim=1),)
    return ll, residuals


def _fold_time(tb, dtb):
    """t̄ (N,) from per-chain step partials (B, N): the cos/sin partial plus
    the spacing chain rule, dt_m = t_m - t_{m-1}, summed over chains."""
    tb, dtb = tb.sum(0), dtb.sum(0)
    return tb + dtb - torch.cat([dtb[1:], dtb.new_zeros(1)])


def bwd_plain(a, b, c, d, t, y, sigma2, residuals: Residuals, g, dt=None,
              kc: int = KC):
    """Plain PyTorch version of K4: cotangents (ā, b̄, c̄, d̄ (B, J), t̄ (N,),
    ȳ, σ̄² (B, N)) of the log-likelihoods under the cotangent ``g`` (B,).

    Within each kc-step chunk, T is recomputed from its checkpoint; the
    sweep then reverses every forward statement, carrying Mbar (the
    cotangent of T_{m+1}) and cpre (that of pre_{m+1}). Chains with
    ``g == 0`` get exact zeros.
    """
    W0t, W1t, P0t, P1t, Dt, ZPt, Tcp = residuals
    B, J = a.shape
    N = t.shape[0]
    dtv = spacings(t, dt)
    live = g != 0
    g = torch.where(live, g, torch.zeros_like(g))
    M00, M01, M11 = (a.new_zeros(B, J, J) for _ in range(3))
    cp0, cp1 = a.new_zeros(B, J), a.new_zeros(B, J)
    abar, bbar, cbar, dbar = (a.new_zeros(B, J) for _ in range(4))
    sumabar = a.new_zeros(B)
    ybar, s2bar, tb, dtb = (a.new_zeros(B, N) for _ in range(4))
    tr = lambda M: M.transpose(1, 2)  # noqa: E731

    for chunk in reversed(range(-(-N // kc))):
        base = chunk * kc
        steps = range(base, min(base + kc, N))
        # phase 1: T_m for the chunk's steps, from the checkpoint
        Ts = [Tcp[:, chunk].unbind(1)]
        for m in steps[1:]:
            ec = exp_neg(c * dtv[m - 1])
            ee = ec[:, :, None] * ec[:, None, :]
            W0, W1, Dm = W0t[:, m - 1], W1t[:, m - 1], Dt[:, m - 1]
            Wd0, Wd1 = W0 * Dm[:, None], W1 * Dm[:, None]
            T00, T01, T11 = Ts[-1]
            Ts.append((ee * T00 + Wd0[:, :, None] * W0[:, None, :],
                       ee * T01 + Wd0[:, :, None] * W1[:, None, :],
                       ee * T11 + Wd1[:, :, None] * W1[:, None, :]))

        # phase 2: reverse sweep
        for m in reversed(steps):
            T00, T01, T11 = Ts[m - base]
            tn, dtn = t[m], dtv[m]
            co = torch.cos(d * tn)
            si = torch.sin(d * tn)
            U0 = a * co + b * si
            U1 = a * si - b * co
            ec = exp_neg(c * dtn)
            ee = ec[:, :, None] * ec[:, None, :]
            W0, W1, pre0, pre1 = W0t[:, m], W1t[:, m], P0t[:, m], P1t[:, m]
            Dm, zpm = Dt[:, m, None], ZPt[:, m, None]
            q0 = co - W0 * Dm
            q1 = si - W1 * Dm
            f0m, f1m = ec * pre0, ec * pre1

            # T_{m+1} = S_m + D_m W_m W_m^T
            M00W0, M00tW0 = _mv(M00, W0), _mv(tr(M00), W0)
            M01W1, M01tW0 = _mv(M01, W1), _mv(tr(M01), W0)
            M11W1, M11tW1 = _mv(M11, W1), _mv(tr(M11), W1)
            Dbar = torch.sum(W0 * (M00W0 + M01W1), 1) + torch.sum(W1 * M11W1, 1)
            W0bar = (M00W0 + M00tW0 + M01W1) * Dm
            W1bar = (M11W1 + M11tW1 + M01tW0) * Dm

            # pre_{m+1} = f_m + W_m zp_m
            f0bar, f1bar = cp0, cp1
            W0bar = W0bar + cp0 * zpm
            W1bar = W1bar + cp1 * zpm
            zpbar = torch.sum(cp0 * W0, 1) + torch.sum(cp1 * W1, 1)

            # loss seeds
            Dbar = Dbar - 0.5 * g * (1.0 / Dm[:, 0] - zpm[:, 0] ** 2 / Dm[:, 0] ** 2)
            zpbar = zpbar - g * zpm[:, 0] / Dm[:, 0]

            # zp = y - U0.f0 - U1.f1 ; f = ec o pre
            ybar[:, m] = zpbar
            U0bar = -zpbar[:, None] * f0m
            U1bar = -zpbar[:, None] * f1m
            f0bar = f0bar - zpbar[:, None] * U0
            f1bar = f1bar - zpbar[:, None] * U1
            ecbar = f0bar * pre0 + f1bar * pre1
            cp0, cp1 = ec * f0bar, ec * f1bar

            # W = (V - q) / D
            cobar, sibar = W0bar / Dm, W1bar / Dm
            q0bar, q1bar = -W0bar / Dm, -W1bar / Dm
            Dbar = Dbar - (torch.sum(W0bar * W0, 1) + torch.sum(W1bar * W1, 1)) / Dm[:, 0]

            # D = suma + s2 - U0.q0 - U1.q1
            s2bar[:, m] = Dbar
            sumabar = sumabar + Dbar
            U0bar = U0bar - Dbar[:, None] * q0
            U1bar = U1bar - Dbar[:, None] * q1
            q0bar = q0bar - Dbar[:, None] * U0
            q1bar = q1bar - Dbar[:, None] * U1

            # q0 = S00 U0 + S01 U1 ; q1 = S01^T U0 + S11 U1 ; S = ee o T
            S00, S01, S11 = ee * T00, ee * T01, ee * T11
            Sb00 = M00 + q0bar[:, :, None] * U0[:, None, :]
            Sb01 = M01 + q0bar[:, :, None] * U1[:, None, :] + U0[:, :, None] * q1bar[:, None, :]
            Sb11 = M11 + q1bar[:, :, None] * U1[:, None, :]
            U0bar = U0bar + _mv(tr(S00), q0bar) + _mv(S01, q1bar)
            U1bar = U1bar + _mv(tr(S01), q0bar) + _mv(tr(S11), q1bar)
            A00, A01, A11 = Sb00 * T00, Sb01 * T01, Sb11 * T11
            ecbar = ecbar + sum(_mv(A, ec) + _mv(tr(A), ec) for A in (A00, A01, A11))
            M00, M01, M11 = ee * Sb00, ee * Sb01, ee * Sb11

            # U0 = a co + b si ; U1 = a si - b co ; V = (co, si)
            abar = abar + U0bar * co + U1bar * si
            bbar = bbar + U0bar * si - U1bar * co
            cobar = cobar + U0bar * a - U1bar * b
            sibar = sibar + U0bar * b + U1bar * a
            dchain = -cobar * si + sibar * co
            dbar = dbar + tn * dchain
            cbar = cbar - dtn * ecbar * ec
            tb[:, m] = torch.sum(d * dchain, 1)
            dtb[:, m] = -torch.sum(c * ecbar * ec, 1)

    abar = abar + sumabar[:, None]
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    outs = [torch.where(live[:, None], x, zero)
            for x in (abar, bbar, cbar, dbar, ybar, s2bar, tb, dtb)]
    abar, bbar, cbar, dbar, ybar, s2bar, tb, dtb = outs
    return abar, bbar, cbar, dbar, _fold_time(tb, dtb), ybar, s2bar


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("celerite_adjoint")
        for fn in (lib.celerite_fwd_aug_f32, lib.celerite_fwd_aug_f64):
            fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for fn in (lib.celerite_bwd_f32, lib.celerite_bwd_f64):
            fn.argtypes = [ctypes.c_void_p] * 23 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.celerite_adjoint_error_string.argtypes = [ctypes.c_int]
        lib.celerite_adjoint_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _call(fn, lib, name, dev, args, ints):
    ptrs = [None if x is None else x.data_ptr() for x in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*ptrs, *ints, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.celerite_adjoint_error_string(err).decode())


def _check_kc(kc):
    if int(kc) < 1:
        raise ValueError(f"kc must be >= 1, got {kc}")
    return int(kc)


def _launch_fwd_aug(a, b, c, d, t, y, sigma2, dt, kc):
    global FWD_AUG_LAUNCHES
    dt = check_inputs(a, b, c, d, t, y, sigma2, dt)
    kc = _check_kc(kc)
    B, J = a.shape
    N = t.shape[0]
    nck = -(-N // kc)
    new = lambda *s: torch.empty(*s, dtype=a.dtype, device=a.device)  # noqa: E731
    ll = new(B)
    res = (new(B, N, J), new(B, N, J), new(B, N, J), new(B, N, J),
           new(B, N), new(B, N), new(B, nck, 3, J, J))
    if B == 0 or N == 0:
        return ll, res
    args = [x.contiguous() for x in (a, b, c, d, t)]
    args.append(None if dt is None else dt.contiguous())
    args += [y.contiguous(), sigma2.contiguous(), ll, *res]
    lib = _lib()
    fn = lib.celerite_fwd_aug_f32 if a.dtype == torch.float32 else lib.celerite_fwd_aug_f64
    _call(fn, lib, "celerite_fwd_aug", a.device, args, (B, J, N, kc))
    FWD_AUG_LAUNCHES += 1
    return ll, res


def _launch_bwd(a, b, c, d, t, y, sigma2, residuals, g, dt, kc):
    global BWD_LAUNCHES
    dt = check_inputs(a, b, c, d, t, y, sigma2, dt)
    kc = _check_kc(kc)
    B, J = a.shape
    N = t.shape[0]
    nck = -(-N // kc)
    shapes = [(B, N, J)] * 4 + [(B, N)] * 2 + [(B, nck, 3, J, J)]
    if len(residuals) != 7:
        raise ValueError(f"residuals: expected 7 tables, got {len(residuals)}")
    for i, (x, shape) in enumerate(zip(residuals, shapes)):
        if x.device != a.device or x.dtype != a.dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"residual table {i}: expected {a.dtype} {shape} on {a.device}, "
                f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    g = torch.as_tensor(g, device=a.device).to(a.dtype)
    if tuple(g.shape) != (B,):
        raise ValueError(f"g must be ({B},), got {tuple(g.shape)}")
    new = lambda *s: torch.empty(*s, dtype=a.dtype, device=a.device)  # noqa: E731
    coefs = [new(B, J) for _ in range(4)]
    rows = [new(B, N) for _ in range(4)]  # ybar, s2bar, t partial, dt partial
    if B == 0 or N == 0:
        coefs = [x.zero_() for x in coefs]
        return (*coefs, a.new_zeros(N), rows[0].zero_(), rows[1].zero_())
    scratch = new(B, kc, 4, J, J)
    args = [x.contiguous() for x in (a, b, c, d, t)]
    args.append(None if dt is None else dt.contiguous())
    args += [g.contiguous(), *(x.contiguous() for x in residuals), scratch, *coefs, *rows]
    lib = _lib()
    fn = lib.celerite_bwd_f32 if a.dtype == torch.float32 else lib.celerite_bwd_f64
    _call(fn, lib, "celerite_bwd", a.device, args, (B, J, N, kc))
    BWD_LAUNCHES += 1
    ybar, s2bar, tb, dtb = rows
    return (*coefs, _fold_time(tb, dtb), ybar, s2bar)


def fwd_aug(a, b, c, d, t, y, sigma2, dt=None, kc: int = KC):
    """K3: ``(ll (B,), residuals)``. CUDA tensors launch the kernel (or
    raise ``ValueError`` on J > 32, a wrong dtype or shape); CPU tensors
    run :func:`fwd_aug_plain`."""
    if a.is_cuda:
        return _launch_fwd_aug(a, b, c, d, t, y, sigma2, dt, kc)
    return fwd_aug_plain(a, b, c, d, t, y, sigma2, dt, kc)


def bwd(a, b, c, d, t, y, sigma2, residuals: Residuals, g, dt=None, kc: int = KC):
    """K4: cotangents (ā, b̄, c̄, d̄, t̄, ȳ, σ̄²) under the cotangent ``g``.
    CUDA tensors launch the kernel (or raise); CPU tensors run
    :func:`bwd_plain`. ``kc`` must be the one :func:`fwd_aug` used."""
    if a.is_cuda:
        return _launch_bwd(a, b, c, d, t, y, sigma2, residuals, g, dt, kc)
    return bwd_plain(a, b, c, d, t, y, sigma2, residuals, g, dt, kc)
