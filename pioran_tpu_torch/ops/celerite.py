"""Celerite table helpers, PyTorch port of part of ``pioran_tpu.ops.celerite``.

Only what the likelihood path needs is here: the accurate float32
``exp_neg``, the U/V/phi table build and the blocked ``stable_sum``.
The three-scan factor/solve and simulate/predict come with the GP
object API.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["CeleriteUV", "exp_neg", "build_uv", "stable_sum"]


class CeleriteUV(NamedTuple):
    """Per-point tables, interleaved row layout (R = 2J):

    U[n] : odd rows a cos(d t_n) + b sin(d t_n), even rows
           a sin(d t_n) - b cos(d t_n)
    V[n] : odd rows cos(d t_n), even rows sin(d t_n)
    phi[n] : exp(-c (t_n - t_{n-1})) per row pair; phi[0] = 0
    """

    U: torch.Tensor
    V: torch.Tensor
    phi: torch.Tensor


def _interleave(odd, even):
    """Stack (..., J) pairs into (..., 2J) interleaved [o1, e1, o2, e2, ...]."""
    return torch.stack([odd, even], dim=-1).reshape(*odd.shape[:-1], -1)


# two-part split of ln 2 (hi has 16 trailing zero bits, so k * LN2_HI
# is exact in f32 for |k| < 2^15)
_LN2_HI = 0.693145751953125
_LN2_LO = 1.4286068203094633e-06
_INV_LN2 = 1.4426950408889634


def exp_neg(u):
    """``exp(-u)`` for u >= 0: ln 2 range reduction plus a degree-7
    polynomial in float32, ``torch.exp`` in float64.

    This is the plain counterpart of the JAX package's ``exp_neg``,
    which exists because a TPU's float32 ``exp`` is about 30 ulps off
    near 1. The CUDA kernel calls libdevice ``expf`` instead (about 2
    ulps; see ``csrc/celerite_fwd.cu``); this function stays so the
    port's tables match the reference's bit for bit where the tests
    compare them.
    """
    if u.dtype != torch.float32:
        return torch.exp(-u)
    # clamp: exp(-104) already underflows f32 to 0, and for huge u the
    # range reduction would cancel into inf * 0 = NaN
    u = torch.clamp(u, max=104.0)
    k = torch.round(u * _INV_LN2)
    r = (u - k * _LN2_HI) - k * _LN2_LO  # in [-ln2/2, ln2/2]
    x = -r
    p = torch.full_like(x, 1.0 / 5040.0)
    for coef in (1.0 / 720.0, 1.0 / 120.0, 1.0 / 24.0, 1.0 / 6.0, 0.5,
                 1.0, 1.0):
        p = p * x + coef
    return torch.exp2(-k) * p


def build_uv(a, b, c, d, t, dt=None) -> CeleriteUV:
    """U, V, phi tables of shape (..., N, 2J) for coefficients (..., J)
    and times t (N,).

    ``dt`` (optional, (N-1,)): consecutive spacings computed in float64
    on the host for long dense series; ``diff`` of a float32 grid loses
    about log2(N) bits when the span is about N times the spacing.
    """
    td = t[:, None] * d[..., None, :]  # (..., N, J)
    co = torch.cos(td)
    si = torch.sin(td)
    a_, b_ = a[..., None, :], b[..., None, :]
    U = _interleave(a_ * co + b_ * si, a_ * si - b_ * co)
    V = _interleave(co, si)
    if dt is None:
        dt = torch.diff(t)
    dt = torch.as_tensor(dt, dtype=t.dtype, device=t.device)
    ec = exp_neg(dt[:, None] * c[..., None, :])  # (..., N-1, J)
    phi = _interleave(ec, ec)
    phi = torch.cat([torch.zeros_like(phi[..., :1, :]), phi], dim=-2)
    return CeleriteUV(U=U, V=V, phi=phi)


def stable_sum(x, dim: int = -1):
    """Blocked (two-level) summation along ``dim``: about sqrt(N) float32
    error growth instead of N, by summing ~sqrt(N) blocks separately."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= 256:
        return torch.sum(x, dim=-1)
    k = 1 << max((n - 1).bit_length() // 2, 1)  # ~sqrt(n), power of 2
    m = -(-n // k) * k
    if m > n:
        x = torch.nn.functional.pad(x, (0, m - n))
    return torch.sum(torch.sum(x.reshape(*x.shape[:-1], -1, k), dim=-1), dim=-1)
