"""The celerite scan, PyTorch port of part of ``pioran_tpu.ops.celerite``.

The accurate float32 ``exp_neg``, the U/V/phi table build, the blocked
``stable_sum``, and the three-scan LDL^T factor/solve with the
log-likelihood ``logl``: Python loops over N on (..., R, R) tensors,
batched over leading chain axes. Slow but exact, and differentiable by
autograd, which makes them the oracle the adjoint kernels are tested
against; ``logl_masked`` is the ragged multi-dataset oracle.

The functions on a :class:`~pioran_tpu_torch.models.kernels.CeleriteKernel`
with ``(..., J)`` coefficients serve the GP object API: ``log_likelihood``
(the kernels K1, or K3/K4 under a gradient, on CUDA tensors; their plain
versions on CPU tensors), ``simulate`` (prior draws), and the posterior
mean ``predict_matmul`` and ``predict``, whose solve z = K^{-1} r runs
the adjoint pair K3/K4 on CUDA tensors and the three-scan solve on CPU
tensors. simulate's and predict's own sweeps are loops over N in plain
PyTorch on either device: none of them is a TPU kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from . import direct as _direct

__all__ = ["CeleriteUV", "exp_neg", "build_uv", "stable_sum",
           "celerite_factor_solve", "logl", "logl_masked", "log_likelihood",
           "simulate", "predict_matmul", "predict", "SEQ_SHARD_MIN_N"]


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


# series at or above this length run through the sequence-sharded
# blockwise scan when a mesh is given (below it, splitting a short series
# is only hand-off overhead)
SEQ_SHARD_MIN_N = 8192


def _seq_sharded(t, mesh, seq_axis, seq_min_n) -> bool:
    """Whether a series on the grid ``t`` runs through the blockwise scan
    over ``mesh``: N >= ``seq_min_n`` (default ``SEQ_SHARD_MIN_N``) and N
    divisible by the axis size (the JAX package's rule)."""
    if mesh is None:
        return False
    from ..parallel.mesh import axis_size

    cap = SEQ_SHARD_MIN_N if seq_min_n is None else seq_min_n
    return t.shape[0] >= cap and t.shape[0] % axis_size(mesh, seq_axis) == 0


def _logl_seq(a, b, c, d, t, y, sigma2, mesh, seq_axis, dt):
    """``parallel.seq_scan.logl_seq_sharded`` on (..., J) coefficients and
    (..., N) rows, the leading axes flattened into one micro-batch."""
    from ..parallel.seq_scan import logl_seq_sharded

    batch = torch.broadcast_shapes(a.shape[:-1], y.shape[:-1], sigma2.shape[:-1])
    J, N = a.shape[-1], t.shape[0]
    flat = lambda x, n: x.expand(batch + (n,)).reshape(-1, n)  # noqa: E731
    ll = logl_seq_sharded(*(flat(x, J) for x in (a, b, c, d)), t, flat(y, N),
                          flat(sigma2, N), mesh, seq_axis, dt=dt)
    return ll.reshape(batch)


def logl(a, b, c, d, t, y, sigma2, dt=None, mesh=None, seq_axis: str = "seq",
         seq_min_n=None):
    """Celerite GP log-likelihood, (...,):
    -logdetD/2 - N log(2 pi)/2 - y^T K^{-1} y / 2, and -inf unless every
    D_n > 0 and the value is finite.

    ``mesh`` (optional): a ``DeviceMesh`` whose ``seq_axis`` carries the
    time dimension. Series of N >= ``seq_min_n`` (default
    ``SEQ_SHARD_MIN_N``) whose N the axis size divides then run through
    the blockwise scan over its ranks
    (``parallel.seq_scan.logl_seq_sharded``: the carry entries of the
    kernels on the card, each rank one block of the series); shorter
    series ignore the mesh. Every rank of the axis calls this with the
    same arguments. The same values and gradients either way, up to the
    order of the sums.
    """
    if _seq_sharded(t, mesh, seq_axis, seq_min_n):
        return _logl_seq(a, b, c, d, t, y, sigma2, mesh, seq_axis, dt)
    z, D, _, logdetD, _ = celerite_factor_solve(a, b, c, d, t, y, sigma2, dt=dt)
    return _logl_from_solve(y, z, D, logdetD)


def _logl_from_solve(y, z, D, logdetD):
    """The log-likelihood from the three-scan solve's outputs, -inf
    unless every D_n > 0 and the value is finite."""
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


# ---------------------------------------------------------------------------
# The GP object API's operations on a CeleriteKernel with (..., J) coefficients
# ---------------------------------------------------------------------------


def _batched(kernel, *rows):
    """(batch shape, coefficients (B, J), rows (B, N)): the kernel's
    leading axes and those of each (..., N) row tensor broadcast together
    and flattened to B rows (B = 1 for an unbatched problem)."""
    coefs = kernel.coefficients()
    J = coefs[0].shape[-1]
    batch = torch.broadcast_shapes(coefs[0].shape[:-1], *(x.shape[:-1] for x in rows))
    flat = lambda x, n: x.expand(batch + (n,)).reshape(-1, n)  # noqa: E731
    return (batch, [flat(x, J) for x in coefs], [flat(x, x.shape[-1]) for x in rows])


def log_likelihood(kernel, t, y, sigma2, dt=None, mesh=None, seq_axis: str = "seq",
                   seq_min_n=None):
    """Log-likelihood (...,) of ``y`` (..., N) under the kernel's
    (..., J) coefficients, on the grid ``t`` (N,) with noise variances
    ``sigma2`` (..., N) (reference celerite_solver.jl:262-294).

    Runs ``cuda_celerite.batched_loglike``: on CUDA tensors the
    hand-written kernel K1, or K3 and K4 when an input requires a
    gradient; on CPU tensors their plain versions. ``dt`` (N-1,) are
    host-f64 spacings. -inf where the factorisation is not positive
    definite, with a zero gradient there. ``mesh``, ``seq_axis`` and
    ``seq_min_n`` shard long series over a mesh's time axis, as for
    :func:`logl`.
    """
    from .cuda_celerite import batched_loglike  # it imports this module

    if _seq_sharded(t, mesh, seq_axis, seq_min_n):
        a, b, c, d = kernel.coefficients()
        return _logl_seq(a, b, c, d, t, y, sigma2, mesh, seq_axis, dt)
    batch, (a, b, c, d), (y, sigma2) = _batched(kernel, y, sigma2)
    return batched_loglike(a, b, c, d, t, y, sigma2, dt).reshape(batch)


def _solve_adjoint(a, b, c, d, t, r, sigma2, dt=None):
    """(z, ok): z = K^{-1} r (B, N) from the likelihood's adjoint pair.
    The cotangent of y under a unit cotangent of the log-likelihood is
    -K^{-1} y exactly, so z = -ȳ of K4 after K3 (their plain versions on
    CPU tensors). ``ok`` (B,) marks the rows whose log-likelihood is
    finite; z means nothing on the others."""
    from .cuda_celerite_vjp import bwd, fwd_aug  # it imports this module

    ll, residuals = fwd_aug(a, b, c, d, t, r, sigma2, dt)
    ybar = bwd(a, b, c, d, t, r, sigma2, residuals, torch.ones_like(ll), dt)[5]
    return -ybar, torch.isfinite(ll)


def _solve(kernel, t, r, sigma2, dt=None):
    """z = K^{-1} r, (..., N): on CUDA tensors by the adjoint kernels
    K3/K4 (:func:`_solve_adjoint`, no gradient), on CPU tensors by
    :func:`celerite_factor_solve`. NaN on the rows whose log-likelihood
    is -inf (the factorisation is not positive definite there)."""
    batch, (a, b, c, d), (r, sigma2) = _batched(kernel, r, sigma2)
    if a.is_cuda:
        z, ok = _solve_adjoint(a, b, c, d, t, r, sigma2, dt)
    else:
        z, D, _, logdetD, _ = celerite_factor_solve(a, b, c, d, t, r, sigma2, dt=dt)
        ok = torch.isfinite(_logl_from_solve(r, z, D, logdetD))
    z = torch.where(ok[:, None], z, torch.full_like(z, math.nan))
    return z.reshape(batch + z.shape[-1:])


def _simulate_from_normals(q, kernel, t, sigma2, dt=None):
    """:func:`simulate` with its standard normals ``q`` (..., N) given."""
    a, b, c, d = kernel.coefficients()
    U, V, phi = build_uv(a, b, c, d, t, dt=dt)
    D, W = _factor(U, V, phi, sigma2, torch.sum(a, dim=-1))
    sdq = torch.sqrt(torch.clamp(D, min=0.0)) * q
    f = sdq.new_zeros(torch.broadcast_shapes(sdq.shape[:-1], U.shape[:-2]) + U.shape[-1:])
    out = [sdq[..., 0].expand(f.shape[:-1])]
    for n in range(1, t.shape[0]):
        f = phi[..., n, :] * (f + W[..., n - 1, :] * sdq[..., n - 1, None])
        out.append(torch.sum(U[..., n, :] * f, dim=-1) + sdq[..., n])
    return torch.stack(out, dim=-1)


def simulate(generator, kernel, t, sigma2, dt=None):
    """Prior draws (..., N) in O(N R) from the LDL^T factors, one per
    leading index of the kernel and ``sigma2``:

    y_1 = sqrt(D_1) q_1;  y_n = U_n . f_n + sqrt(D_n) q_n with
    f_n = phi_{n-1} o (f_{n-1} + W_{n-1} sqrt(D_{n-1}) q_{n-1})

    (reference celerite_solver.jl:515-549), q standard normals from the
    ``torch.Generator`` ``generator`` (on t's device). ``dt`` (N-1,) are
    host-f64 spacings. A loop over N in plain PyTorch on either device.
    """
    batch = torch.broadcast_shapes(kernel.a.shape[:-1], sigma2.shape[:-1])
    q = torch.randn(batch + t.shape[-1:], generator=generator, dtype=t.dtype,
                    device=t.device)
    return _simulate_from_normals(q, kernel, t, sigma2, dt)


def predict_matmul(kernel, tau, t, y, sigma2, dt=None):
    """Posterior mean (..., M) at ``tau`` (M,): the solve z = K^{-1} y
    (K3/K4 on CUDA tensors), then the (..., M, N) x (..., N) product
    with the cross-covariance K(tau, t). NaN on rows whose
    log-likelihood is -inf. For very long series :func:`predict` gives
    the same in O((N + M) R)."""
    z = _solve(kernel, t, y, sigma2, dt)
    Kcross = _direct.covariance_matrix(kernel, tau, t)
    return (Kcross @ z[..., None])[..., 0]


def predict(kernel, tau, t, y, sigma2, dt=None):
    """Posterior mean (..., M) at ``tau`` (M,) in O((N + M) R) by gated
    forward and backward sweeps (reference celerite_solver.jl:363-483).

    After the solve z = K^{-1} y (as in :func:`predict_matmul`), a
    forward sweep accumulates the decayed statistic of the data points
    with t_n <= tau_m and a backward sweep that of those with
    t_n > tau_m; each target point reads both at its ``searchsorted``
    neighbours. ``dt`` (N-1,) host-f64 spacings feed the solve and the
    sweeps' decays.
    """
    a, b, c, d = kernel.coefficients()
    z = _solve(kernel, t, y, sigma2, dt)
    N = t.shape[0]
    dt_arr = torch.diff(t) if dt is None else torch.as_tensor(dt, device=t.device).to(t.dtype)
    zero = dt_arr.new_zeros(1)

    # rows of the sweeps: Q_n = Q_{n -/+ 1} e_n + z_n x_n, (..., N, 2J)
    co, si = torch.cos(t[:, None] * d[..., None, :]), torch.sin(t[:, None] * d[..., None, :])
    a_, b_ = a[..., None, :], b[..., None, :]
    zc = z[..., :, None]
    xf = torch.cat([zc * co, zc * si], dim=-1)
    xb = torch.cat([zc * (a_ * co + b_ * si), zc * (a_ * si - b_ * co)], dim=-1)
    c2 = torch.cat([c, c], dim=-1)[..., None, :]
    ef = exp_neg(c2 * torch.cat([zero, dt_arr])[:, None])
    eb = exp_neg(c2 * torch.cat([dt_arr, zero])[:, None])
    xf, xb, ef, eb = torch.broadcast_tensors(xf, xb, ef, eb)
    Qf, Qb = [xf[..., 0, :]], [xb[..., N - 1, :]]
    for n in range(1, N):
        Qf.append(torch.addcmul(xf[..., n, :], Qf[-1], ef[..., n, :]))
        Qb.append(torch.addcmul(xb[..., N - 1 - n, :], Qb[-1], eb[..., N - 1 - n, :]))
    Qf, Qb = torch.stack(Qf, dim=-2), torch.stack(Qb[::-1], dim=-2)

    # combine per target point: the last data point at or before tau_m
    # and the first after it
    n0 = torch.searchsorted(t.contiguous(), tau, right=True)
    il, ir = torch.clamp(n0 - 1, 0, N - 1), torch.clamp(n0, 0, N - 1)
    J = a.shape[-1]
    cm, sm = torch.cos(tau[:, None] * d[..., None, :]), torch.sin(tau[:, None] * d[..., None, :])
    c_ = c[..., None, :]
    # clamp: with no left point tau_m - t_0 < 0 and the decay would overflow
    dl = exp_neg(c_ * torch.clamp(tau - t[il], min=0.0)[:, None])
    dr = exp_neg(c_ * torch.clamp(t[ir] - tau, min=0.0)[:, None])
    Ql, Qr = Qf[..., il, :], Qb[..., ir, :]
    mu_left = torch.sum(dl * (Ql[..., :J] * (a_ * cm + b_ * sm)
                              + Ql[..., J:] * (a_ * sm - b_ * cm)), dim=-1)
    mu_right = torch.sum(dr * (Qr[..., :J] * cm + Qr[..., J:] * sm), dim=-1)
    zero_m = torch.zeros_like(mu_left)
    return (torch.where(n0 > 0, mu_left, zero_m)
            + torch.where(n0 < N, mu_right, zero_m))
