"""The celerite likelihood's adjoint: the hand-written CUDA kernels K3 and
K4, their plain PyTorch versions, and the wrappers between them.

Port of ``pioran_tpu.ops.pallas_celerite_vjp``, for a time grid shared by
the chains and for per-chain (ragged) grids. The TPU kernels
``_fwd_aug_kernel`` (K3) and ``_bwd_kernel`` (K4) become
``csrc/celerite_adjoint.cu``, built by nvcc at first use (see
``_build.py``); each has a shared-grid and a per-lane instantiation.

- :func:`fwd_aug` runs the forward sweep and also returns the residual
  tables the reverse sweep reads: per step W0, W1, pre0, pre1 (B, N, J),
  D and zp (B, N), and a checkpoint of the T blocks every ``kc`` steps
  (B, ceil(N / kc), 3, J, J).
- :func:`bwd` takes those tables and a cotangent ``g`` (B,) of the
  log-likelihoods and returns the cotangents of (a, b, c, d, t, y,
  sigma2); ``t``'s includes the chain rule through the spacings,
  t̄_m += dt̄_m - dt̄_{m+1}, and is summed over the chains for a shared
  grid, one row per chain for per-lane grids.
- Per-lane grids: ``t`` (B, N), ``dt`` (B, N-1) and ``n_valid`` (B,)
  valid lengths; only steps below a chain's ``n_valid`` count toward its
  sums, its -inf check and its loss seeds, and the constant term is
  ``n_valid`` log 2 pi.

CUDA tensors go to the kernels, or raise; CPU tensors go to
:func:`fwd_aug_plain` and :func:`bwd_plain`, Python loops over N on
(B, J, J) tensors that follow the TPU kernels statement by statement.
``chip_smoke.py`` holds the kernels against them on the card.

Past ``NARROW_TERMS`` = 32 terms (one warp lane a term) the wrappers
launch the wide forms of K3 and K4 in ``csrc/celerite_wide.cu`` instead,
one thread block a chain and a thread a row of the 2J x 2J state, up to
``MAX_TERMS``; that library also holds the wide K1, K2 and K0, which
``ops/cuda_celerite.py`` launches. The residual tables are the same for
both forms.

There is no counterpart of the TPU code's VMEM tiling (``auto_tiles``,
``fits_vmem``), its scan fallback, or its ``SEG_STEPS`` launch
segmentation: the tables live in device memory and one launch runs all N
steps. K4 keeps the T blocks it recomputes for a chunk in shared memory,
as the TPU kernel keeps them in VMEM; :func:`bwd_launch_shape` chooses
the chains per block and the sub-chunk length that fit, and
:func:`wide_bwd_shape` what the wide K4 keeps in shared memory and what
in a device scratch. ``FWD_AUG_LAUNCHES`` and ``BWD_LAUNCHES`` count
launches of the shared-grid kernels, ``FWD_AUG_MULTI_LAUNCHES`` and
``BWD_MULTI_LAUNCHES`` those of the per-lane ones, and the ``WIDE_``
counters those of the wide forms.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from .. import _build
from .celerite import exp_neg

__all__ = ["fwd_aug", "fwd_aug_plain", "bwd", "bwd_plain", "residual_bytes",
           "bwd_launch_shape", "wide_fwd_scratch", "wide_bwd_shape", "check_inputs", "spacings",
           "live_steps", "log2pi_terms", "KC", "MAX_TERMS", "NARROW_TERMS"]

_LOG2PI = math.log(2.0 * math.pi)

NARROW_TERMS = 32  # the warp-per-chain kernels: one warp lane per celerite term
MAX_TERMS = 128    # the wide kernels: one thread per row of the 2J x 2J state
KC = 8             # steps between T checkpoints
WIDE_SUB = 8       # the wide K4: steps of a chunk's T held at once, at most
SMEM_BYTES = 232_448  # shared memory one block may use on the H100 (sm_90)
H100_SMS = 132
_WIDE_WARPS = 2 * MAX_TERMS // 32
FWD_AUG_LAUNCHES = 0
BWD_LAUNCHES = 0
FWD_AUG_MULTI_LAUNCHES = 0
BWD_MULTI_LAUNCHES = 0
WIDE_FWD_AUG_LAUNCHES = 0
WIDE_BWD_LAUNCHES = 0
WIDE_FWD_AUG_MULTI_LAUNCHES = 0
WIDE_BWD_MULTI_LAUNCHES = 0
_LIB: Optional[ctypes.CDLL] = None
_WIDE_LIB: Optional[ctypes.CDLL] = None

Residuals = Tuple[torch.Tensor, ...]


def spacings(t, dt=None):
    """Per-step spacing with a leading 0 (the first step is inert), along
    the last axis of t, (N,) or (B, N): ``diff(t)``, or the host-f64
    ``dt`` (N-1,) or (B, N-1) cast to t's dtype."""
    zero = t.new_zeros(t.shape[:-1] + (1,))
    if dt is None:
        return torch.cat([zero, torch.diff(t)], dim=-1)
    return torch.cat([zero, torch.as_tensor(dt, device=t.device).to(t.dtype)], dim=-1)


def live_steps(n_valid, N: int):
    """(B, N) mask of the steps below each chain's ``n_valid`` (B,)."""
    return torch.arange(N, device=n_valid.device) < n_valid[:, None]


def _lanes(t, dt, B, n_valid):
    """(times (B, N), spacings (B, N), live (B, N) or None): every chain's
    own rows, from a shared grid or per-lane grids; ``live`` marks the
    steps below ``n_valid`` (None when every step counts)."""
    N = t.shape[-1]
    lanes_t, lanes_dt = t.expand(B, N), spacings(t, dt).expand(B, N)
    if n_valid is None:
        return lanes_t, lanes_dt, None
    return lanes_t, lanes_dt, live_steps(torch.as_tensor(n_valid, device=t.device), N)


def check_inputs(a, b, c, d, t, y, sigma2, dt, n_valid=None):
    """Raise ``ValueError`` on what the CUDA kernels do not take: J >
    ``MAX_TERMS``, a dtype other than float32/float64, mixed dtypes or
    devices, or wrong shapes. ``t`` is (N,) shared by the chains or (B, N) per lane, with
    ``dt`` (N-1,) or (B, N-1); ``n_valid`` (B,) goes with per-lane t only.
    Returns (dt cast to the working dtype or None, n_valid as int32 or
    None; per-lane t without n_valid gets N everywhere)."""
    if a.dim() != 2:
        raise ValueError(f"a must be (B, J), got {tuple(a.shape)}")
    B, J = a.shape
    per_lane = t.dim() == 2
    N = t.shape[-1]
    if J > MAX_TERMS:
        raise ValueError(
            f"the CUDA celerite kernels take at most {MAX_TERMS} terms "
            f"(one thread a row of the 2J x 2J state), got J={J}")
    if a.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"float32 or float64 expected, got {a.dtype}")
    dev, dtype = a.device, a.dtype
    lead = (B,) if per_lane else ()
    for name, x, shape in (("b", b, (B, J)), ("c", c, (B, J)), ("d", d, (B, J)),
                           ("t", t, lead + (N,)), ("y", y, (B, N)),
                           ("sigma2", sigma2, (B, N))):
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {dev}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if dt is not None:
        dt = torch.as_tensor(dt, device=dev).to(dtype)
        if tuple(dt.shape) != lead + (max(N - 1, 0),):
            raise ValueError(f"dt must be {lead + (N - 1,)}, got {tuple(dt.shape)}")
    if n_valid is None:
        return dt, (torch.full((B,), N, dtype=torch.int32, device=dev) if per_lane else None)
    if not per_lane:
        raise ValueError("n_valid needs per-lane times t (B, N)")
    n_valid = torch.as_tensor(n_valid, device=dev).to(torch.int32).contiguous()
    if tuple(n_valid.shape) != (B,):
        raise ValueError(f"n_valid must be ({B},), got {tuple(n_valid.shape)}")
    return dt, n_valid


def residual_bytes(B: int, J: int, N: int, kc: int = KC,
                   dtype: torch.dtype = torch.float32) -> Tuple[int, int]:
    """Bytes of (the per-step tables, the T checkpoints) that K3 writes
    and K4 reads."""
    item = torch.empty((), dtype=dtype).element_size()
    nck = -(-N // kc)
    return item * B * N * (4 * J + 2), item * B * nck * 3 * J * J


def bwd_launch_shape(dtype: torch.dtype, J: int, kc: int, B: int = 1,
                     sms: int = H100_SMS) -> Tuple[int, int, int]:
    """K4's launch: (chains per block, sub-chunk length ks, shared-memory
    bytes per block).

    A warp (one chain) holds ks steps of its chunk's recomputed T blocks
    (three JP x JP blocks a step, JP = J rounded up to a multiple of 4,
    rows padded to an odd number of 16-byte vectors), two checkpoints, two
    residual buffers of ks steps, ks rows of ec and two column rows: the
    layout ``bwd_warp_len`` in ``csrc/celerite_adjoint.cu`` computes. ks
    is the whole chunk (at most 32 steps) where one chain fits the
    block's 232,448 bytes, else the longest that does; up to four chains
    share a block, but no more than B spread over the card's SMs needs.
    """
    item = torch.empty((), dtype=dtype).element_size()
    vec = 16 // item
    jp = -(-J // 4) * 4
    rs = jp if (jp // vec) % 2 else jp + vec

    def warp_bytes(ks):
        return item * (ks * 3 * jp * rs + 6 * J * rs + 2 * (4 * ks * jp + 4 * ks + 4)
                       + 32 * ks + 256)

    ks = min(kc, 32)
    while ks > 1 and warp_bytes(ks) > SMEM_BYTES:
        ks -= 1
    cpb = max(1, min(4, -(-B // sms), SMEM_BYTES // warp_bytes(ks)))
    return cpb, ks, cpb * warp_bytes(ks)


def wide_fwd_scratch(J: int, dtype: torch.dtype) -> int:
    """Device scratch values a chain the wide forward kernels (K1, K2, K0
    and K3 past 32 terms) need: 0 where the R x R state S (R = 2J) fits
    the block's 232,448 bytes of shared memory beside the rows U, ec and W
    and the reduction buffer, else R x R. The launch
    (``fwd_smem_len`` in ``csrc/celerite_wide.cu``) lays shared memory out
    by whether the scratch pointer is null, and refuses a layout that does
    not fit.
    """
    item = torch.empty((), dtype=dtype).element_size()
    R = 2 * J
    return 0 if item * (3 * R + 2 * _WIDE_WARPS + R * R) <= SMEM_BYTES else R * R


def wide_bwd_shape(J: int, kc: int, dtype: torch.dtype, B: int = 1,
                   sms: int = H100_SMS) -> Tuple[int, int, int, int]:
    """The wide K4's launch: (sub-chunk length ks, shared-memory bytes a
    block, carry scratch values a chain, chunk scratch values a chain).

    One block a chain, a thread a row of the R x R carry G (R = 2J). A
    chunk of kc steps is swept in sub-chunks of ks = min(kc, 8) steps,
    whose T blocks (three J x (J | 1) blocks a step) are recomputed from
    the checkpoint. Shared memory holds the rows and the reduction buffer;
    G goes there too where it fits. The T chunk joins it where it fits
    beside G and the B chains do not outnumber the ``sms`` SMs; what
    shared memory does not hold lives in the scratch. At J = 40 with more
    chains than SMs, blocks that keep the chunk in the scratch, several to
    an SM, ran faster on the H100 (PERF.md); at other J the placement is
    not tuned. The launch (``bwd_smem_len`` in ``csrc/celerite_wide.cu``)
    lays shared memory out by which scratch pointers are null, and refuses
    a layout that does not fit.
    """
    item = torch.empty((), dtype=dtype).element_size()
    R = 2 * J
    ks = min(kc, WIDE_SUB)
    rows = 7 * R + 3 * _WIDE_WARPS
    carry, chunk = R * R, 3 * ks * J * (J | 1)
    carry_smem = item * (rows + carry) <= SMEM_BYTES
    chunk_smem = B <= sms and item * (rows + carry * carry_smem + chunk) <= SMEM_BYTES
    smem = item * (rows + carry * carry_smem + chunk * chunk_smem)
    return ks, smem, 0 if carry_smem else carry, 0 if chunk_smem else chunk


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _mv(M, v):
    """Batched matrix-vector product (B, J, J) x (B, J) -> (B, J)."""
    return (M @ v[:, :, None])[:, :, 0]


def _masked(live, n, x, fill):
    """x where step n is live (everywhere when live is None), else fill."""
    return x if live is None else torch.where(live[:, n], x, fill)


def fwd_aug_plain(a, b, c, d, t, y, sigma2, dt=None, kc: int = KC, n_valid=None):
    """Plain PyTorch version of K3: ``(ll (B,), residuals)``.

    ll is :func:`cuda_celerite.batched_loglike_plain`'s value (with
    per-lane t, ``batched_loglike_multi_plain``'s); residuals are (W0,
    W1, pre0, pre1) (B, N, J), (D, zp) (B, N) and the T checkpoints
    (B, ceil(N / kc), 3, J, J) of steps 0, kc, 2 kc, ...
    """
    B, J = a.shape
    N = t.shape[-1]
    lanes_t, lanes_dt, live = _lanes(t, dt, B, n_valid)
    zero, inf = a.new_zeros(()), a.new_full((), math.inf)
    suma = torch.sum(a, dim=1)
    S00, S01, S11 = (a.new_zeros(B, J, J) for _ in range(3))
    f0, f1, W0, W1 = (a.new_zeros(B, J) for _ in range(4))
    Dp, zpp = a.new_zeros(B), a.new_zeros(B)
    logdet, clog, quad, cquad = (a.new_zeros(B) for _ in range(4))
    minD = torch.full((B,), math.inf, dtype=a.dtype, device=a.device)
    tabs = ([], [], [], [], [], [])
    ckpts = []

    for n in range(N):
        co = torch.cos(d * lanes_t[:, n, None])
        si = torch.sin(d * lanes_t[:, n, None])
        U0 = a * co + b * si
        U1 = a * si - b * co
        ec = exp_neg(c * lanes_dt[:, n, None])
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

        # Kahan-compensated sums over the live steps, as in the kernel
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
    ll = torch.where(ok, ll, torch.full_like(ll, -math.inf))
    residuals = tuple(torch.stack(lst, dim=1) for lst in tabs) + (torch.stack(ckpts, dim=1),)
    return ll, residuals


def log2pi_terms(N, n_valid, dtype):
    """The constant term of -2 ll: N log 2 pi, or n_valid log 2 pi per chain."""
    if n_valid is None:
        return N * _LOG2PI
    return torch.as_tensor(n_valid).to(dtype) * _LOG2PI


def _fold_time(tb, dtb, per_lane):
    """t̄ from per-chain step partials (B, N): the cos/sin partial plus the
    spacing chain rule, dt_m = t_m - t_{m-1}, so t̄_m += dt̄_m - dt̄_{m+1}
    (with dt̄_N = 0). One row per chain for per-lane grids, (N,) summed over
    the chains for a shared grid."""
    if not per_lane:
        tb, dtb = tb.sum(0), dtb.sum(0)
    return tb + dtb - torch.cat([dtb[..., 1:], torch.zeros_like(dtb[..., :1])], dim=-1)


def bwd_plain(a, b, c, d, t, y, sigma2, residuals: Residuals, g, dt=None,
              kc: int = KC, n_valid=None):
    """Plain PyTorch version of K4: cotangents (ā, b̄, c̄, d̄ (B, J), t̄ (N,)
    or (B, N) for per-lane t, ȳ, σ̄² (B, N)) of the log-likelihoods under
    the cotangent ``g`` (B,).

    Within each kc-step chunk, T is recomputed from its checkpoint; the
    sweep then reverses every forward statement, carrying Mbar (the
    cotangent of T_{m+1}) and cpre (that of pre_{m+1}). Only steps below
    ``n_valid`` seed the loss. Chains with ``g == 0`` get exact zeros.
    """
    W0t, W1t, P0t, P1t, Dt, ZPt, Tcp = residuals
    B, J = a.shape
    N = t.shape[-1]
    lanes_t, lanes_dt, step_live = _lanes(t, dt, B, n_valid)
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
            ec = exp_neg(c * lanes_dt[:, m - 1, None])
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
            tn, dtn = lanes_t[:, m, None], lanes_dt[:, m, None]
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

            # loss seeds, on the live steps
            gm = _masked(step_live, m, g, torch.zeros_like(g))
            Dbar = Dbar - 0.5 * gm * (1.0 / Dm[:, 0] - zpm[:, 0] ** 2 / Dm[:, 0] ** 2)
            zpbar = zpbar - gm * zpm[:, 0] / Dm[:, 0]

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
    return abar, bbar, cbar, dbar, _fold_time(tb, dtb, t.dim() == 2), ybar, s2bar


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("celerite_adjoint")
        # the per-lane entries take one more pointer, the int32 n_valid;
        # K4's take ks and the chains per block after (B, J, N, kc)
        for fn, nptr, nint in ((lib.celerite_fwd_aug_f32, 16, 4),
                               (lib.celerite_fwd_aug_f64, 16, 4),
                               (lib.celerite_fwd_aug_multi_f32, 17, 4),
                               (lib.celerite_fwd_aug_multi_f64, 17, 4),
                               (lib.celerite_bwd_f32, 22, 6), (lib.celerite_bwd_f64, 22, 6),
                               (lib.celerite_bwd_multi_f32, 23, 6),
                               (lib.celerite_bwd_multi_f64, 23, 6)):
            fn.argtypes = [ctypes.c_void_p] * nptr + [ctypes.c_int] * nint + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.celerite_adjoint_error_string.argtypes = [ctypes.c_int]
        lib.celerite_adjoint_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _wide_lib() -> ctypes.CDLL:
    """The wide kernels' library (``csrc/celerite_wide.cu``): K1, K2, K0,
    K3 and K4 past ``NARROW_TERMS`` terms."""
    global _WIDE_LIB
    if _WIDE_LIB is None:
        lib = _build.load("celerite_wide")
        # pointers, then (B, J, N[, kc[, ks]]); the per-lane entries take
        # one more pointer, the int32 n_valid
        for name, nptr, nint in (("fwd", 10, 3), ("fwd_multi", 11, 3), ("tables", 8, 3),
                                 ("fwd_aug", 17, 4), ("fwd_aug_multi", 18, 4),
                                 ("bwd", 24, 5), ("bwd_multi", 25, 5)):
            for dt in ("f32", "f64"):
                fn = getattr(lib, f"celerite_wide_{name}_{dt}")
                fn.argtypes = [ctypes.c_void_p] * nptr + [ctypes.c_int] * nint + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
        lib.celerite_wide_error_string.argtypes = [ctypes.c_int]
        lib.celerite_wide_error_string.restype = ctypes.c_char_p
        _WIDE_LIB = lib
    return _WIDE_LIB


def _call(fn, errors, name, dev, args, ints):
    """Launch the C entry ``fn`` on ``dev``'s current stream with the
    tensors ``args`` (None: a null pointer) and the ints ``ints``; raise
    with ``errors(code)`` (the library's error string) if it fails."""
    ptrs = [None if x is None else x.data_ptr() for x in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*ptrs, *ints, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: " + errors(err).decode())


def _check_kc(kc):
    if int(kc) < 1:
        raise ValueError(f"kc must be >= 1, got {kc}")
    return int(kc)


def _entry(lib, name, dtype, per_lane):
    """The C entry ``name[_multi]_{f32,f64}``."""
    return getattr(lib, name + ("_multi" if per_lane else "")
                   + ("_f32" if dtype == torch.float32 else "_f64"))


def _scratch(B, values, x):
    """A device scratch of ``values`` a chain for B chains, or None when
    the kernel keeps that part in shared memory."""
    return torch.empty(B * values, dtype=x.dtype, device=x.device) if values else None


def _launch_fwd_aug(a, b, c, d, t, y, sigma2, dt, kc, n_valid):
    global FWD_AUG_LAUNCHES, FWD_AUG_MULTI_LAUNCHES
    global WIDE_FWD_AUG_LAUNCHES, WIDE_FWD_AUG_MULTI_LAUNCHES
    dt, n_valid = check_inputs(a, b, c, d, t, y, sigma2, dt, n_valid)
    kc = _check_kc(kc)
    per_lane = n_valid is not None
    B, J = a.shape
    N = t.shape[-1]
    nck = -(-N // kc)
    new = lambda *s: torch.empty(*s, dtype=a.dtype, device=a.device)  # noqa: E731
    ll = new(B)
    res = (new(B, N, J), new(B, N, J), new(B, N, J), new(B, N, J),
           new(B, N), new(B, N), new(B, nck, 3, J, J))
    if B == 0 or N == 0:
        return ll, res
    args = [x.contiguous() for x in (a, b, c, d, t)]
    args.append(None if dt is None else dt.contiguous())
    args += [y.contiguous(), sigma2.contiguous()]
    args += [n_valid] if per_lane else []
    args += [ll, *res]
    wide = J > NARROW_TERMS
    if wide:
        lib, name = _wide_lib(), "celerite_wide_fwd_aug"
        errors = lib.celerite_wide_error_string
        args.append(_scratch(B, wide_fwd_scratch(J, a.dtype), a))
    else:
        lib, name = _lib(), "celerite_fwd_aug"
        errors = lib.celerite_adjoint_error_string
    _call(_entry(lib, name, a.dtype, per_lane), errors, name, a.device, args, (B, J, N, kc))
    if wide and per_lane:
        WIDE_FWD_AUG_MULTI_LAUNCHES += 1
    elif wide:
        WIDE_FWD_AUG_LAUNCHES += 1
    elif per_lane:
        FWD_AUG_MULTI_LAUNCHES += 1
    else:
        FWD_AUG_LAUNCHES += 1
    return ll, res


def _launch_bwd(a, b, c, d, t, y, sigma2, residuals, g, dt, kc, n_valid):
    """Run K4 (its wide form past ``NARROW_TERMS`` terms)."""
    global BWD_LAUNCHES, BWD_MULTI_LAUNCHES, WIDE_BWD_LAUNCHES, WIDE_BWD_MULTI_LAUNCHES
    dt, n_valid = check_inputs(a, b, c, d, t, y, sigma2, dt, n_valid)
    kc = _check_kc(kc)
    per_lane = n_valid is not None
    B, J = a.shape
    N = t.shape[-1]
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
        return (*coefs, rows[2].zero_() if per_lane else a.new_zeros(N),
                rows[0].zero_(), rows[1].zero_())
    args = [x.contiguous() for x in (a, b, c, d, t)]
    args.append(None if dt is None else dt.contiguous())
    args += [g.contiguous()]
    args += [n_valid] if per_lane else []
    args += [*(x.contiguous() for x in residuals), *coefs, *rows]
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    if J > NARROW_TERMS:
        ks, _, carry, chunk = wide_bwd_shape(J, kc, a.dtype, B, sms)
        args += [_scratch(B, carry, a), _scratch(B, chunk, a)]
        lib, name, ints = _wide_lib(), "celerite_wide_bwd", (B, J, N, kc, ks)
        errors = lib.celerite_wide_error_string
    else:
        cpb, ks, _ = bwd_launch_shape(a.dtype, J, kc, B, sms)
        lib, name, ints = _lib(), "celerite_bwd", (B, J, N, kc, ks, cpb)
        errors = lib.celerite_adjoint_error_string
    _call(_entry(lib, name, a.dtype, per_lane), errors, name, a.device, args, ints)
    if J > NARROW_TERMS and per_lane:
        WIDE_BWD_MULTI_LAUNCHES += 1
    elif J > NARROW_TERMS:
        WIDE_BWD_LAUNCHES += 1
    elif per_lane:
        BWD_MULTI_LAUNCHES += 1
    else:
        BWD_LAUNCHES += 1
    ybar, s2bar, tb, dtb = rows
    return (*coefs, _fold_time(tb, dtb, per_lane), ybar, s2bar)


def fwd_aug(a, b, c, d, t, y, sigma2, dt=None, kc: int = KC, n_valid=None):
    """K3: ``(ll (B,), residuals)``. ``t`` (N,) shared, or (B, N) per lane
    with ``dt`` (B, N-1) and ``n_valid`` (B,). CUDA tensors launch the
    kernel, its wide form past ``NARROW_TERMS`` terms (or raise
    ``ValueError`` on J > ``MAX_TERMS``, a wrong dtype or shape); CPU
    tensors run :func:`fwd_aug_plain`."""
    if a.is_cuda:
        return _launch_fwd_aug(a, b, c, d, t, y, sigma2, dt, kc, n_valid)
    return fwd_aug_plain(a, b, c, d, t, y, sigma2, dt, kc, n_valid)


def bwd(a, b, c, d, t, y, sigma2, residuals: Residuals, g, dt=None, kc: int = KC,
        n_valid=None):
    """K4: cotangents (ā, b̄, c̄, d̄, t̄, ȳ, σ̄²) under the cotangent ``g``.
    CUDA tensors launch the kernel (or raise); CPU tensors run
    :func:`bwd_plain`. ``kc``, ``dt`` and ``n_valid`` must be those
    :func:`fwd_aug` used."""
    if a.is_cuda:
        return _launch_bwd(a, b, c, d, t, y, sigma2, residuals, g, dt, kc, n_valid)
    return bwd_plain(a, b, c, d, t, y, sigma2, residuals, g, dt, kc, n_valid)
