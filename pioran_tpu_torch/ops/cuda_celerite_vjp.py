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
- :func:`value_and_grad_tables` runs both, with ``g`` 1 on the finite
  chains and 0 on the -inf ones.
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
one thread block a chain, up to ``MAX_TERMS``: two threads a row of the
2J x 2J state, held in registers up to J = 64, past that the first
``TAIL_RC`` columns of a thread's row half in registers and the rest in
shared memory or a device scratch (:func:`wide_shape`); that library
also holds the wide K1, K2 and K0, which ``ops/cuda_celerite.py``
launches. The residual tables are the same for both forms.

Carry entries: one block of a series split along time, started from the
state the previous block ended with, as the TPU kernels' segmented
launches do with their carry refs and as ``parallel/seq_scan.py`` hands a
block's state from rank to rank. :func:`fwd_aug_carry` takes the forward
carry (B, 3 J^2 + 4 J + 2) per chain: S00, S01 and S11 row-major, then W
and f in the block layout [cos-type; sin-type], then D and zp (all zeros
is the neutral start of a series; :func:`neutral_carry`), and ``dt`` (N,),
every step's spacing with the one to the previous block's last point
first. It returns the block's partials (B, 3), the Kahan sums of log|D|
and zp^2 / D and min D, the carry after its last step, and the residual
tables. :func:`bwd_carry` takes the adjoint carry (B, 3 J^2 + 2 J), the
cotangents of T and pre at the next block's first step (P00 = M00 +
M00^T, M01, P11 = M11 + M11^T row-major, then cpre; zeros for the last
block), and returns the block's partial cotangents and the adjoint carry
at its own first step. ``FWD_AUG_CARRY_LAUNCHES``, ``BWD_CARRY_LAUNCHES``
and their ``WIDE_`` forms count those launches.

There is no counterpart of the TPU code's VMEM tiling (``auto_tiles``,
``fits_vmem``), its scan fallback, or its ``SEG_STEPS`` launch
segmentation: the tables live in device memory and one launch runs all N
steps. K4 keeps the T blocks it recomputes for a chunk in shared memory,
as the TPU kernel keeps them in VMEM; :func:`bwd_launch_shape` chooses
the chains per block and the sub-chunk length that fit, and
:func:`wide_shape` the wide kernels' design, K4's sub-chunk, and what
they keep in shared memory and what in a device scratch.
``FWD_AUG_LAUNCHES`` and ``BWD_LAUNCHES`` count launches of the
shared-grid kernels, ``FWD_AUG_MULTI_LAUNCHES`` and
``BWD_MULTI_LAUNCHES`` those of the per-lane ones, and the ``WIDE_``
counters those of the wide forms.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from .. import _build
from .celerite import exp_neg

__all__ = ["fwd_aug", "fwd_aug_plain", "bwd", "bwd_plain", "value_and_grad_tables",
           "fwd_aug_carry", "bwd_carry",
           "carry_width", "adjoint_width", "neutral_carry", "residual_bytes",
           "bwd_launch_shape", "WideShape", "wide_cpt", "wide_shape", "check_inputs", "spacings",
           "live_steps", "log2pi_terms", "KC", "MAX_TERMS", "NARROW_TERMS"]

_LOG2PI = math.log(2.0 * math.pi)

NARROW_TERMS = 32  # the warp-per-chain kernels: one warp lane per celerite term
MAX_TERMS = 128    # the wide kernels: two threads per row of the 2J x 2J state
KC = 8             # steps between T checkpoints
WIDE_TAB = 8       # the wide kernels: steps a table of residual rows holds; K4's ks at most
WIDE_CPT = (40, 64)  # the wide kernels' register design: columns a thread
SMEM_BYTES = 232_448  # shared memory one block may use on the H100 (sm_90)
SM_SMEM_BYTES = 233_472  # shared memory of an SM, 1 KB of it reserved a block
H100_SMS = 132
_SPLIT_WARPS = (4 * WIDE_CPT[-1] + 31) // 32  # the register design's largest block, in warps
_TAIL_WARPS = 4 * MAX_TERMS // 32  # past the registers: the largest block, in warps
# past the registers: columns of a thread's row segment held in registers,
# by (bytes a value, K4); the rest, the tail, in shared memory or a scratch
TAIL_RC = {(4, False): 64, (4, True): 32, (8, False): 32, (8, True): 16}
FWD_AUG_LAUNCHES = 0
BWD_LAUNCHES = 0
FWD_AUG_MULTI_LAUNCHES = 0
BWD_MULTI_LAUNCHES = 0
WIDE_FWD_AUG_LAUNCHES = 0
WIDE_BWD_LAUNCHES = 0
WIDE_FWD_AUG_MULTI_LAUNCHES = 0
WIDE_BWD_MULTI_LAUNCHES = 0
FWD_AUG_CARRY_LAUNCHES = 0
BWD_CARRY_LAUNCHES = 0
WIDE_FWD_AUG_CARRY_LAUNCHES = 0
WIDE_BWD_CARRY_LAUNCHES = 0
_LIB: Optional[ctypes.CDLL] = None
_CARRY_LIB: Optional[ctypes.CDLL] = None
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
            f"(two threads a row of the 2J x 2J state), got J={J}")
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


def carry_width(J: int) -> int:
    """Values of the forward carry a chain: S00, S01, S11 (J x J each),
    W and f (2 J each), D and zp."""
    return 3 * J * J + 4 * J + 2


def adjoint_width(J: int) -> int:
    """Values of the adjoint carry a chain: P00, M01, P11 (J x J each)
    and cpre (2 J)."""
    return 3 * J * J + 2 * J


def neutral_carry(B: int, J: int, like: torch.Tensor) -> torch.Tensor:
    """The forward carry that starts a series, (B, 3 J^2 + 4 J + 2) zeros
    in ``like``'s dtype on its device; zeros of :func:`adjoint_width` are
    the adjoint carry that ends one."""
    return like.new_zeros(B, carry_width(J))


def carry_state(carry, J):
    """(S00, S01, S11 (B, J, J), W0, W1, f0, f1 (B, J), D, zp (B,)):
    copies of a forward carry's parts."""
    B, JJ = carry.shape[0], J * J
    S00, S01, S11 = (carry[:, k * JJ:(k + 1) * JJ].reshape(B, J, J).clone() for k in range(3))
    W0, W1, f0, f1 = (carry[:, 3 * JJ + k * J:3 * JJ + (k + 1) * J].clone() for k in range(4))
    return S00, S01, S11, W0, W1, f0, f1, carry[:, -2].clone(), carry[:, -1].clone()


def pack_carry(S00, S01, S11, W0, W1, f0, f1, D, zp):
    """The forward carry (B, 3 J^2 + 4 J + 2) of a chain state."""
    B = S00.shape[0]
    return torch.cat([S00.reshape(B, -1), S01.reshape(B, -1), S11.reshape(B, -1),
                      W0, W1, f0, f1, D[:, None], zp[:, None]], dim=1)


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


class WideShape(NamedTuple):
    """The wide kernels' launch (J > ``NARROW_TERMS``), from
    :func:`wide_shape`."""

    cpt: int            # columns a thread holds in registers (40, 64), or past 64 terms cw
    threads: int        # threads a block: two a row, 4 J rounded up to a warp
    ks: int             # K4's sub-chunk: steps of a chunk's T held at once
    chains: int         # K4's blocks (chains) an SM: shared memory, threads, registers
    fwd_chains: int     # forward blocks an SM: shared memory, threads, registers
    fwd_smem: int       # bytes of shared memory a forward block (K3's, the largest)
    bwd_smem: int       # bytes of shared memory a K4 block
    fwd_scratch: int    # device scratch values a chain: the forward tail
    carry_scratch: int  # K4's tail of G
    chunk_scratch: int  # K4's slots


def wide_cpt(J: int) -> int:
    """The wide kernels' ``cpt`` for J terms, in both dtypes: the smallest of
    ``WIDE_CPT`` at least J (the register design: columns a thread holds
    in registers), else cw = J rounded up to 4 (past the registers: the
    width of a row half, a thread's first ``TAIL_RC`` columns in
    registers). At 100 columns a thread in registers float32 spilled 2 KB
    a thread."""
    for cpt in WIDE_CPT:
        if J <= cpt:
            return cpt
    return -(-J // 4) * 4


def wide_shape(J: int, dtype: torch.dtype, B: int = 1, kc: int = KC,
               sms: int = H100_SMS) -> WideShape:
    """The wide kernels' launch shape for J terms in ``dtype``: one block a
    chain, B chains, checkpoints every ``kc`` steps; two threads a row of
    the 2J x 2J state (S forward, K4's carry G), each holding a row half.

    Register design (J <= 64, ``cpt`` 40 or 64 from :func:`wide_cpt`):
    each thread holds its ``cpt`` >= J columns in registers, so nothing of
    the state is in shared or device memory. The forward kernels'
    registers are sized for four chains an SM in float32 at cpt = 40, two
    at 64 (float64: two, one); K3 stages each checkpoint in shared memory
    (three J x (J + 1) blocks, where kc >= 2) and stores it coalesced. K4's
    registers are sized for one chain an SM (its column loads at once take
    about 250 registers; bounded for two chains it spilled and ran slower),
    and it keeps a thread's own T row segments for ks steps (ks x threads
    x cpt values) in shared memory, the largest ks that fits (ks = 1 fits
    every J up to 64), so that fewer steps are replayed; ks <= min(kc, 8),
    and ks divides 8 where kc > 8 (a sub-chunk lies in one 8-step window
    of residual rows).

    Past the registers (64 < J <= 128, cpt = cw, J rounded up to 4): the
    same kernels with rows of 2 cw, a thread's first ``TAIL_RC`` columns in
    registers and the rest (the tail, threads x (cw - rc) values a chain) in
    shared memory where it fits, else in the device scratch; one chain an
    SM (512 threads at J = 128). The forward tail fits in float32 at every
    J; K3 stages its checkpoints where the staging fits beside it. K4
    takes ks = the largest allowed (min(kc, 8), dividing 8 where kc > 8),
    its slots in shared memory where all ks fit beside the rest, else in
    the scratch; then G's tail in shared memory where it fits, else the
    scratch. ``csrc/celerite_wide.cu`` lays shared memory out the same way
    and refuses a layout that does not fit. Every design takes one chain
    a block, so the shape no longer depends on B and ``sms``, which the
    signature keeps for its callers.
    """
    item = torch.empty((), dtype=dtype).element_size()
    cpt = wide_cpt(J)
    nts = -(-4 * J // 32) * 32
    ks_max = next(k for k in range(min(kc, WIDE_TAB), 0, -1)
                  if kc <= WIDE_TAB or WIDE_TAB % k == 0)

    def chains(nbytes):
        return min(SM_SMEM_BYTES // (nbytes + 1024), 2048 // nts)
    if cpt in WIDE_CPT:
        slot = nts * cpt
        fixed = WIDE_TAB * (9 * cpt + 4) + 4 * cpt + 8 * _SPLIT_WARPS
        fwd_smem = item * (2 * WIDE_TAB * 6 * cpt + 4 * cpt + 6 * WIDE_TAB + 4 * _SPLIT_WARPS
                           + (3 * J * (J + 1) if kc >= 2 else 0))

        def bwd_bytes(ks):
            return item * (fixed + 8 * ks * cpt + ks * slot)
        regs_chains = {(4, 40): 4, (4, 64): 2, (8, 40): 2}.get((item, cpt), 1)
        fwd_chains = min(regs_chains, chains(fwd_smem))
        ks = next(k for k in range(ks_max, 0, -1)
                  if (kc <= WIDE_TAB or WIDE_TAB % k == 0) and bwd_bytes(k) <= SMEM_BYTES)
        return WideShape(cpt, nts, ks, 1, fwd_chains, fwd_smem, bwd_bytes(ks), 0, 0, 0)

    cw = cpt

    def fwd_off(stj):
        return -(-(2 * WIDE_TAB * 6 * cw + 4 * cw + 6 * WIDE_TAB + 4 * _TAIL_WARPS
                   + 3 * stj * (stj + 1)) // 4) * 4
    tail = nts * (cw - TAIL_RC[item, False])
    tail_smem = item * (fwd_off(0) + tail) <= SMEM_BYTES
    tail_in = tail if tail_smem else 0
    stage = kc >= 2 and item * (fwd_off(J) + tail_in) <= SMEM_BYTES
    fwd_smem = item * (fwd_off(J if stage else 0) + tail_in)
    fixed = WIDE_TAB * (9 * cw + 4) + 4 * cw + 8 * ks_max * cw + 8 * _TAIL_WARPS
    slots, gtail = ks_max * nts * cw, nts * (cw - TAIL_RC[item, True])
    slots_in = slots if item * (fixed + slots) <= SMEM_BYTES else 0
    gtail_in = gtail if item * (fixed + slots_in + gtail) <= SMEM_BYTES else 0
    bwd_smem = item * (fixed + slots_in + gtail_in)
    return WideShape(cw, nts, ks_max, chains(bwd_smem), 1, fwd_smem, bwd_smem,
                     0 if tail_smem else tail, gtail - gtail_in, slots - slots_in)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _mv(M, v):
    """Batched matrix-vector product (B, J, J) x (B, J) -> (B, J)."""
    return (M @ v[:, :, None])[:, :, 0]


def _masked(live, n, x, fill):
    """x where step n is live (everywhere when live is None), else fill."""
    return x if live is None else torch.where(live[:, n], x, fill)


def block_lanes(t, dt, B):
    """(times (B, N), spacings (B, N), live None) of a block of a split
    series: ``dt`` (N,) holds every step's spacing, the boundary's first."""
    N = t.shape[-1]
    return t.expand(B, N), torch.as_tensor(dt, device=t.device).to(t.dtype).expand(B, N), None


def initial_state(a, carry):
    """The recursion's starting (S00, S01, S11, W0, W1, f0, f1, D, zp):
    zeros, or a forward carry's parts."""
    B, J = a.shape
    if carry is not None:
        return carry_state(carry, J)
    return (*(a.new_zeros(B, J, J) for _ in range(3)), *(a.new_zeros(B, J) for _ in range(4)),
            a.new_zeros(B), a.new_zeros(B))


def fwd_aug_plain(a, b, c, d, t, y, sigma2, dt=None, kc: int = KC, n_valid=None, carry=None):
    """Plain PyTorch version of K3: ``(ll (B,), residuals)``.

    ll is :func:`cuda_celerite.batched_loglike_plain`'s value (with
    per-lane t, ``batched_loglike_multi_plain``'s); residuals are (W0,
    W1, pre0, pre1) (B, N, J), (D, zp) (B, N) and the T checkpoints
    (B, ceil(N / kc), 3, J, J) of steps 0, kc, 2 kc, ...

    With a forward ``carry`` (B, 3 J^2 + 4 J + 2) this is K3's carry
    entry: ``dt`` (N,) is every step's spacing, the boundary's first, and
    the result is ``(partials (B, 3), carry out, residuals)``; the
    partials are the Kahan sums of log|D| and zp^2 / D and min D.
    """
    B, J = a.shape
    N = t.shape[-1]
    lanes_t, lanes_dt, live = (_lanes(t, dt, B, n_valid) if carry is None
                               else block_lanes(t, dt, B))
    zero, inf = a.new_zeros(()), a.new_full((), math.inf)
    suma = torch.sum(a, dim=1)
    S00, S01, S11, W0, W1, f0, f1, Dp, zpp = initial_state(a, carry)
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

    residuals = tuple(torch.stack(lst, dim=1) for lst in tabs) + (torch.stack(ckpts, dim=1),)
    if carry is not None:
        return (torch.stack([logdet, quad, minD], dim=1),
                pack_carry(S00, S01, S11, W0, W1, f0, f1, Dp, zpp), residuals)
    ll = -0.5 * (logdet + quad + log2pi_terms(N, n_valid, a.dtype))
    ok = (minD > 0) & torch.isfinite(ll)
    ll = torch.where(ok, ll, torch.full_like(ll, -math.inf))
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
              kc: int = KC, n_valid=None, carry=None):
    """Plain PyTorch version of K4: cotangents (ā, b̄, c̄, d̄ (B, J), t̄ (N,)
    or (B, N) for per-lane t, ȳ, σ̄² (B, N)) of the log-likelihoods under
    the cotangent ``g`` (B,).

    Within each kc-step chunk, T is recomputed from its checkpoint; the
    sweep then reverses every forward statement, carrying Mbar (the
    cotangent of T_{m+1}) and cpre (that of pre_{m+1}). Only steps below
    ``n_valid`` seed the loss. Chains with ``g == 0`` get exact zeros.

    With an adjoint ``carry`` (B, 3 J^2 + 2 J), the cotangents of T and
    pre at the next block's first step, this is K4's carry entry (``dt``
    (N,) as for :func:`fwd_aug_plain`'s): Mbar and cpre start from it,
    and the result is ``(ā, b̄, c̄, d̄, t partials (N,), dt partials (N,),
    ȳ, σ̄², adjoint carry out)``, the per-step time partials summed over
    the chains and not folded (the spacing of a block's first step
    reaches back into the block before).
    """
    W0t, W1t, P0t, P1t, Dt, ZPt, Tcp = residuals
    B, J = a.shape
    N = t.shape[-1]
    lanes_t, lanes_dt, step_live = (_lanes(t, dt, B, n_valid) if carry is None
                                    else block_lanes(t, dt, B))
    live = g != 0
    g = torch.where(live, g, torch.zeros_like(g))
    if carry is None:
        M00, M01, M11 = (a.new_zeros(B, J, J) for _ in range(3))
        cp0, cp1 = a.new_zeros(B, J), a.new_zeros(B, J)
    else:  # M00 and M11 enter only through their symmetric parts
        JJ = J * J
        M00, M01, M11 = (carry[:, k * JJ:(k + 1) * JJ].reshape(B, J, J).clone()
                         for k in range(3))
        M00, M11 = 0.5 * M00, 0.5 * M11
        cp0, cp1 = carry[:, 3 * JJ:3 * JJ + J].clone(), carry[:, 3 * JJ + J:].clone()
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
    if carry is not None:
        aout = torch.cat([(M00 + tr(M00)).reshape(B, -1), M01.reshape(B, -1),
                          (M11 + tr(M11)).reshape(B, -1), cp0, cp1], dim=1)
        aout = torch.where(live[:, None], aout, zero)
        return abar, bbar, cbar, dbar, tb.sum(0), dtb.sum(0), ybar, s2bar, aout
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


def _carry_lib() -> ctypes.CDLL:
    """The warp-per-chain K3 and K4 carry entries' library
    (``csrc/celerite_adjoint_carry.cu``: ``celerite_adjoint.cu``'s
    kernels, built apart so that nvcc compiles both at once)."""
    global _CARRY_LIB
    if _CARRY_LIB is None:
        lib = _build.load("celerite_adjoint_carry")
        for fn, nptr, nint in ((lib.celerite_fwd_aug_carry_f32, 18, 4),
                               (lib.celerite_fwd_aug_carry_f64, 18, 4),
                               (lib.celerite_bwd_carry_f32, 24, 6),
                               (lib.celerite_bwd_carry_f64, 24, 6)):
            fn.argtypes = [ctypes.c_void_p] * nptr + [ctypes.c_int] * nint + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.celerite_adjoint_error_string.argtypes = [ctypes.c_int]
        lib.celerite_adjoint_error_string.restype = ctypes.c_char_p
        _CARRY_LIB = lib
    return _CARRY_LIB


def _wide_lib() -> ctypes.CDLL:
    """The wide kernels' library (``csrc/celerite_wide.cu``): K1, K2, K0,
    K3 and K4 past ``NARROW_TERMS`` terms."""
    global _WIDE_LIB
    if _WIDE_LIB is None:
        lib = _build.load("celerite_wide")
        # pointers, then (B, J, N[, kc[, ks]], cpt); the per-lane entries
        # take one more pointer, the int32 n_valid
        for name, nptr, nint in (("fwd", 10, 4), ("fwd_multi", 11, 4), ("tables", 8, 4),
                                 ("fwd_aug", 17, 5), ("fwd_aug_multi", 18, 5),
                                 ("bwd", 24, 6), ("bwd_multi", 25, 6),
                                 ("fwd_carry", 12, 4), ("fwd_aug_carry", 19, 5),
                                 ("bwd_carry", 26, 6)):
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
    ints = (B, J, N, kc)
    if wide:
        lib, name = _wide_lib(), "celerite_wide_fwd_aug"
        errors = lib.celerite_wide_error_string
        shape = wide_shape(J, a.dtype, B, kc)
        args.append(_scratch(B, shape.fwd_scratch, a))
        ints += (shape.cpt,)
    else:
        lib, name = _lib(), "celerite_fwd_aug"
        errors = lib.celerite_adjoint_error_string
    _call(_entry(lib, name, a.dtype, per_lane), errors, name, a.device, args, ints)
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
        shape = wide_shape(J, a.dtype, B, kc, sms)
        args += [_scratch(B, shape.carry_scratch, a), _scratch(B, shape.chunk_scratch, a)]
        lib, name = _wide_lib(), "celerite_wide_bwd"
        ints = (B, J, N, kc, shape.ks, shape.cpt)
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


def value_and_grad_tables(a, b, c, d, t, y, sigma2, dt=None, n_valid=None, kc: int = KC):
    """``(ll (B,), (ā, b̄, c̄, d̄, t̄, ȳ, σ̄²))``: :func:`fwd_aug` then
    :func:`bwd` under the cotangent 1 on every finite chain and 0 on a
    −inf one, as the JAX package's ``value_and_grad_tables``. CUDA
    tensors launch K3 and K4 (or raise); CPU tensors run their plain
    versions."""
    ll, res = fwd_aug(a, b, c, d, t, y, sigma2, dt, kc, n_valid)
    g = torch.isfinite(ll).to(ll.dtype)
    return ll, bwd(a, b, c, d, t, y, sigma2, res, g, dt, kc, n_valid)


# ---------------------------------------------------------------------------
# the carry entries: one block of a series split along time
# ---------------------------------------------------------------------------

def check_carry(a, b, c, d, t, y, sigma2, dt, carry, width):
    """Raise ``ValueError`` on what a carry entry does not take (as
    :func:`check_inputs`, with a shared t (N,), the spacings ``dt`` (N,)
    of every step and a ``carry`` (B, width)); return dt in the working
    dtype."""
    if t.dim() != 1:
        raise ValueError(f"a carry entry takes a shared grid t (N,), got {tuple(t.shape)}")
    check_inputs(a, b, c, d, t, y, sigma2, None)
    B, N = a.shape[0], t.shape[0]
    if dt is None:
        raise ValueError("a carry entry needs dt (N,): every step's spacing, the boundary's first")
    dt = torch.as_tensor(dt, device=a.device).to(a.dtype)
    if tuple(dt.shape) != (N,):
        raise ValueError(f"dt must be ({N},) with the boundary spacing first, got "
                         f"{tuple(dt.shape)}")
    if carry.device != a.device or carry.dtype != a.dtype or tuple(carry.shape) != (B, width):
        raise ValueError(f"carry: expected {a.dtype} {(B, width)} on {a.device}, got "
                         f"{carry.dtype} {tuple(carry.shape)} on {carry.device}")
    return dt


def _launch_fwd_aug_carry(a, b, c, d, t, y, sigma2, dt, carry, kc):
    global FWD_AUG_CARRY_LAUNCHES, WIDE_FWD_AUG_CARRY_LAUNCHES
    B, J = a.shape
    dt = check_carry(a, b, c, d, t, y, sigma2, dt, carry, carry_width(J))
    kc = _check_kc(kc)
    N = t.shape[0]
    new = lambda *s: torch.empty(*s, dtype=a.dtype, device=a.device)  # noqa: E731
    parts, cout = new(B, 3), new(B, carry_width(J))
    res = (new(B, N, J), new(B, N, J), new(B, N, J), new(B, N, J),
           new(B, N), new(B, N), new(B, -(-N // kc), 3, J, J))
    if B == 0 or N == 0:
        return parts, carry.clone(), res
    args = [x.contiguous() for x in (a, b, c, d, t, dt, y, sigma2)]
    args += [*res, carry.contiguous(), cout, parts]
    wide = J > NARROW_TERMS
    ints = (B, J, N, kc)
    if wide:
        lib, name = _wide_lib(), "celerite_wide_fwd_aug_carry"
        errors = lib.celerite_wide_error_string
        shape = wide_shape(J, a.dtype, B, kc)
        args.append(_scratch(B, shape.fwd_scratch, a))
        ints += (shape.cpt,)
    else:
        lib, name = _carry_lib(), "celerite_fwd_aug_carry"
        errors = lib.celerite_adjoint_error_string
    _call(_entry(lib, name, a.dtype, False), errors, name, a.device, args, ints)
    if wide:
        WIDE_FWD_AUG_CARRY_LAUNCHES += 1
    else:
        FWD_AUG_CARRY_LAUNCHES += 1
    return parts, cout, res


def _launch_bwd_carry(a, b, c, d, t, y, sigma2, residuals, g, dt, carry, kc):
    global BWD_CARRY_LAUNCHES, WIDE_BWD_CARRY_LAUNCHES
    B, J = a.shape
    dt = check_carry(a, b, c, d, t, y, sigma2, dt, carry, adjoint_width(J))
    kc = _check_kc(kc)
    N = t.shape[0]
    shapes = [(B, N, J)] * 4 + [(B, N)] * 2 + [(B, -(-N // kc), 3, J, J)]
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
    aout = new(B, adjoint_width(J))
    if B == 0 or N == 0:
        return (*(x.zero_() for x in coefs), a.new_zeros(N), a.new_zeros(N),
                rows[0].zero_(), rows[1].zero_(), carry.clone())
    args = [x.contiguous() for x in (a, b, c, d, t, dt, g)]
    args += [*(x.contiguous() for x in residuals), *coefs, *rows, carry.contiguous(), aout]
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    if J > NARROW_TERMS:
        shape = wide_shape(J, a.dtype, B, kc, sms)
        args += [_scratch(B, shape.carry_scratch, a), _scratch(B, shape.chunk_scratch, a)]
        lib, name = _wide_lib(), "celerite_wide_bwd_carry"
        ints = (B, J, N, kc, shape.ks, shape.cpt)
        errors = lib.celerite_wide_error_string
    else:
        cpb, ks, _ = bwd_launch_shape(a.dtype, J, kc, B, sms)
        lib, name, ints = _carry_lib(), "celerite_bwd_carry", (B, J, N, kc, ks, cpb)
        errors = lib.celerite_adjoint_error_string
    _call(_entry(lib, name, a.dtype, False), errors, name, a.device, args, ints)
    if J > NARROW_TERMS:
        WIDE_BWD_CARRY_LAUNCHES += 1
    else:
        BWD_CARRY_LAUNCHES += 1
    ybar, s2bar, tb, dtb = rows
    return (*coefs, tb.sum(0), dtb.sum(0), ybar, s2bar, aout)


def fwd_aug_carry(a, b, c, d, t, y, sigma2, dt, carry, kc: int = KC):
    """K3's carry entry, one block of a split series: ``(partials (B, 3),
    carry out, residuals)``. ``t`` (N,) the block's times, ``dt`` (N,)
    every step's spacing with the boundary's first, ``carry`` (B,
    3 J^2 + 4 J + 2) the state the previous block ended with
    (:func:`neutral_carry` for the first). CUDA tensors launch the kernel,
    its wide form past ``NARROW_TERMS`` terms (or raise); CPU tensors run
    :func:`fwd_aug_plain` with the carry."""
    if a.is_cuda:
        return _launch_fwd_aug_carry(a, b, c, d, t, y, sigma2, dt, carry, kc)
    dt = check_carry(a, b, c, d, t, y, sigma2, dt, carry, carry_width(a.shape[1]))
    return fwd_aug_plain(a, b, c, d, t, y, sigma2, dt, kc, carry=carry)


def bwd_carry(a, b, c, d, t, y, sigma2, residuals: Residuals, g, dt, carry, kc: int = KC):
    """K4's carry entry, one block of a split series: ``(ā, b̄, c̄, d̄, t
    partials (N,), dt partials (N,), ȳ, σ̄², adjoint carry out)`` under
    the cotangent ``g`` (B,) of the whole series' log-likelihoods.
    ``carry`` (B, 3 J^2 + 2 J) holds the cotangents of T and pre at the
    next block's first step (zeros for the last block); ``residuals``,
    ``dt`` and ``kc`` are those :func:`fwd_aug_carry` used. CUDA tensors
    launch the kernel (or raise); CPU tensors run :func:`bwd_plain`."""
    if a.is_cuda:
        return _launch_bwd_carry(a, b, c, d, t, y, sigma2, residuals, g, dt, carry, kc)
    dt = check_carry(a, b, c, d, t, y, sigma2, dt, carry, adjoint_width(a.shape[1]))
    return bwd_plain(a, b, c, d, t, y, sigma2, residuals, g, dt, kc, carry=carry)
