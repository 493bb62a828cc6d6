"""The celerite scan, PyTorch port of part of ``pioran_tpu.ops.celerite``.

The accurate float32 ``exp_neg``, the U/V/phi table build, the blocked
``stable_sum``, and the three-scan LDL^T factor/solve with the
log-likelihood ``logl``: Python loops over N on (..., R, R) tensors,
batched over leading chain axes. Slow but exact, and differentiable by
autograd, which makes them the oracle the adjoint kernels are tested
against; ``logl_masked`` is the ragged multi-dataset oracle.
simulate/predict come with the GP object API.
"""

from __future__ import annotations

from typing import NamedTuple
import math
from typing import Tuple

import torch

__all__ = ["CeleriteUV", "exp_neg", "build_uv", "stable_sum",
           "celerite_factor_solve", "logl", "logl_masked"]


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
    and times t (N,) or per-row times t (..., N).

    ``dt`` (optional, (N-1,) or (..., N-1)): consecutive spacings computed
    in float64 on the host for long dense series; ``diff`` of a float32
    grid loses about log2(N) bits when the span is about N times the
    spacing.
    """
    td = t[..., :, None] * d[..., None, :]  # (..., N, J)
    co = torch.cos(td)
    si = torch.sin(td)
    a_, b_ = a[..., None, :], b[..., None, :]
    U = _interleave(a_ * co + b_ * si, a_ * si - b_ * co)
    V = _interleave(co, si)
    if dt is None:
        dt = torch.diff(t)
    dt = torch.as_tensor(dt, dtype=t.dtype, device=t.device)
    ec = exp_neg(dt[..., :, None] * c[..., None, :])  # (..., N-1, J)
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


def _factor(U, V, phi, sigma2, suma) -> Tuple[torch.Tensor, torch.Tensor]:
    """The LDL^T factor scan over N: returns ``(D, W)``, shapes (..., N)
    and (..., N, R).

    S_n = (phi phi^T) o (S_{n-1} + D_{n-1} W_{n-1} W_{n-1}^T);
    D_n = suma + sigma2_n - U_n . S_n U_n;  W_n = (V_n - S_n U_n) / D_n.
    The first step has S = 0, so D_0 = suma + sigma2_0 and W_0 = V_0 / D_0.
    """
    N, R = U.shape[-2:]
    D = [suma + sigma2[..., 0]]
    W = [V[..., 0, :] / D[0][..., None]]
    S = U.new_zeros(U.shape[:-2] + (R, R))
    for n in range(1, N):
        ph = phi[..., n, :]
        S = (ph[..., :, None] * ph[..., None, :]) * (
            S + D[-1][..., None, None] * (W[-1][..., :, None] * W[-1][..., None, :]))
        SU = (S @ U[..., n, :, None])[..., 0]
        Dn = suma + sigma2[..., n] - torch.sum(U[..., n, :] * SU, dim=-1)
        D.append(Dn)
        W.append((V[..., n, :] - SU) / Dn[..., None])
    return torch.stack(D, dim=-1), torch.stack(W, dim=-2)


def _forward_sub(U, W, phi, y):
    """zp = (I + tril(U W^T))^{-1} y, (..., N): the forward substitution."""
    zp = [y[..., 0]]
    f = torch.zeros_like(U[..., 0, :])
    for n in range(1, U.shape[-2]):
        f = phi[..., n, :] * (f + W[..., n - 1, :] * zp[-1][..., None])
        zp.append(y[..., n] - torch.sum(U[..., n, :] * f, dim=-1))
    return torch.stack(zp, dim=-1)


def celerite_factor_solve(a, b, c, d, t, y, sigma2, dt=None):
    """LDL^T factorisation and the K^{-1} y solve in three scans.

    a, b, c, d: (..., J); t: (N,); y, sigma2: (..., N). Returns
    ``(z, D, W, logdetD, uv)`` with ``z = K^{-1} y`` and
    ``logdetD = sum log |D_n|``.
    """
    uv = build_uv(a, b, c, d, t, dt=dt)
    U, V, phi = uv
    N = U.shape[-2]
    D, W = _factor(U, V, phi, sigma2, torch.sum(a, dim=-1))
    logdetD = stable_sum(torch.log(torch.abs(D)))

    zp = _forward_sub(U, W, phi, y)

    # backward substitution: z = D^{-1} z' then (I + triu(W U^T))^{-1}
    z = [zp[..., -1] / D[..., -1]]
    g = torch.zeros_like(U[..., 0, :])
    for n in range(N - 2, -1, -1):
        g = phi[..., n + 1, :] * (g + U[..., n + 1, :] * z[-1][..., None])
        z.append(zp[..., n] / D[..., n] - torch.sum(W[..., n, :] * g, dim=-1))
    z = torch.stack(z[::-1], dim=-1)
    return z, D, W, logdetD, uv


def logl(a, b, c, d, t, y, sigma2, dt=None):
    """Celerite GP log-likelihood, (...,):
    -logdetD/2 - N log(2 pi)/2 - y^T K^{-1} y / 2, and -inf unless every
    D_n > 0 and the value is finite."""
    z, D, _, logdetD, _ = celerite_factor_solve(a, b, c, d, t, y, sigma2, dt=dt)
    N = y.shape[-1]
    ll = -0.5 * logdetD - 0.5 * N * math.log(2.0 * math.pi) - 0.5 * stable_sum(y * z)
    ok = torch.all(D > 0, dim=-1) & torch.isfinite(ll)
    return torch.where(ok, ll, torch.full_like(ll, -math.inf))


def logl_masked(a, b, c, d, t, y, sigma2, n_valid, dt=None):
    """Log-likelihood of the first ``n_valid`` points of padded series, (...,).

    The recursion runs over the full padded grid (pad ``t`` with its last
    value so dt = 0, ``sigma2`` with 1 so D stays positive); only steps
    below ``n_valid`` (...,) count toward log det, the quadratic form
    sum zp^2 / D and the positive-definiteness check, and the constant is
    ``n_valid`` log 2 pi. t: (N,) or (..., N); dt: optional (N-1,) or
    (..., N-1). The oracle of the multi-dataset kernels.
    """
    U, V, phi = build_uv(a, b, c, d, t, dt=dt)
    D, W = _factor(U, V, phi, sigma2, torch.sum(a, dim=-1))
    zp = _forward_sub(U, W, phi, y)
    nv = torch.as_tensor(n_valid, device=y.device).to(y.dtype)
    live = torch.arange(y.shape[-1], device=y.device) < nv[..., None]
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    logdet = stable_sum(torch.where(live, torch.log(torch.abs(D)), zero))
    quad = stable_sum(torch.where(live, zp * zp / D, zero))
    ll = -0.5 * (logdet + quad + nv * math.log(2.0 * math.pi))
    ok = torch.all(torch.where(live, D, torch.ones_like(D)) > 0, dim=-1) & torch.isfinite(ll)
    return torch.where(ok, ll, torch.full_like(ll, -math.inf))
