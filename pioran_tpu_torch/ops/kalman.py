"""Log-depth celerite likelihood via parallel Kalman filtering, the
PyTorch port of ``pioran_tpu.ops.kalman``.

**STATUS: EXPERIMENTAL.** This backend is a correctness-complete
log-depth formulation, but it is NOT on the production path: the
samplers run the batched celerite recursion (``ops.cuda_celerite``,
the hand-written kernels K1, K3 and K4 on the card), and the
covariance-form filter requires f64 for wide-dynamic-range kernels (see
Precision below). Use it in float64 for single evaluations, or as a
second oracle for ``ops.celerite``.

Why a square-root (Cholesky-factor) associative filter — the standard
f32-stabilization (Yaghoobi et al. 2021) — does NOT apply here: sqrt
filters require a real factor ``Q_k^{1/2}`` of the per-interval process
noise, but the celerite 2-d embedding's ``Q_k = Pinf - Phi Pinf Phi^T``
is INDEFINITE (for an SHO term ``Pinf = a [[1,1],[1,1]]`` is rank-1, so
``Q_k`` is a difference of two equal-norm rank-1 matrices in rotated
directions — one positive and one negative eigenvalue whenever
``d dt != 0 mod pi``). Only the FULL data covariance is PD; per-term /
per-interval pieces are not, which is exactly why this filter works
with Schur complements of the full covariance and why the reference's
LDL^T recursion (and the port's celerite kernels) is the right f32
algorithm. Hence: experimental, f64-only, by construction rather than by
neglect.

The celerite LDL^T recursion (``ops.celerite``; reference
src/celerite_solver.jl:12-106) is a Riccati-type recursion: each step's
state depends nonlinearly on the previous step, so it cannot be fed to an
associative scan directly. The standard way to parallelize exactly this
class of recursions is the associative formulation of the Kalman filter
(Sarkka & Garcia-Fernandez 2021, IEEE TAC 66:299): represent the celerite
GP as a linear-Gaussian state-space model, express per-step Gaussian
conditioning as an associative operator on 5-tuples ``(A, b, C, eta,
J)``, and run an inclusive associative scan — O(log N) depth at O(N R^3)
work (vs O(N) depth, O(N R^2) work for the celerite recursion). The scan
here is written in plain torch over the time axis: log2 N rounds of a
batched :func:`_combine`, in the odd/even order of JAX's
``lax.associative_scan``, so the combine order, and with it the
rounding, follows the JAX package's.

State-space form (exact, not a discretisation): each celerite term
``k_j(tau) = e^{-c tau}(a cos d tau + b sin d tau)`` is the output of a
2-d stationary process with

  transition   Phi_j(dt) = e^{-c dt} [[cos d dt,  sin d dt],
                                      [-sin d dt, cos d dt]]
  stationary   Pinf_j    = [[a, b], [b, a]]
  observation  h_j       = [1, 0]

so that h Phi(tau) Pinf h^T = k_j(tau) exactly. Process noise is the
exact stationary increment ``Q_k = Pinf - Phi_k Pinf Phi_k^T``. Per-term
``Pinf_j`` may be indefinite (DRWCelerite basis has b = sqrt(3) a); the
filter only ever works with Schur complements of the full (PD) data
covariance, so innovation variances stay positive exactly when the
celerite diagonal D does.

Precision: the covariance-form filter (both variants here) needs f64 for
wide-dynamic-range kernels (the J=20 basis spans ~4 frequency decades);
in f32 the innovation variance can round non-positive, in which case the
guard returns -inf rather than a wrong number. A square-root
(Cholesky-factor) filter — the classical f32-stable fix — does NOT
exist for these state spaces: both the stationary covariance ``Pinf_j``
(DRWCelerite basis has b = sqrt(3) a > a) and the per-interval process
noise ``Q_k = Pinf - Phi_k Pinf Phi_k^T`` are indefinite for celerite
embeddings (verified numerically on the J=20 basis), so there is no
real Cholesky factor to propagate. The f32-stable path is
``ops.celerite``, whose LDL^T recursion only ever forms Schur
complements of the full PD data covariance.

Every function takes one light curve: coefficients (J,), t, y and sigma2
(N,). It runs on the tensors' device, and its gradient comes from
autograd.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import torch

__all__ = [
    "build_ssm",
    "build_process_noise",
    "log_likelihood_kalman",
    "logl_kalman",
    "logl_kalman_sequential",
]


def build_ssm(a, b, c, d, t) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(H, Pinf, Phi) for the stacked 2J-dim celerite state space.

    H: (R,) observation row; Pinf: (R, R) stationary covariance;
    Phi: (N-1, R, R) block-diagonal transitions over dt_k = t_k - t_{k-1}.
    """
    J = a.shape[0]
    R = 2 * J
    dtype, device = t.dtype, t.device

    H = torch.tensor([1.0, 0.0], dtype=dtype, device=device).repeat(J)

    # Pinf = blockdiag([[a, b], [b, a]])
    eye2 = torch.eye(2, dtype=dtype, device=device)
    off2 = torch.tensor([[0.0, 1.0], [1.0, 0.0]], dtype=dtype, device=device)
    blocks = a[:, None, None] * eye2 + b[:, None, None] * off2  # (J,2,2)
    Pinf = torch.block_diag(*blocks).reshape(R, R)

    dt = torch.diff(t)  # (N-1,)
    decay = torch.exp(-dt[:, None] * c[None, :])  # (N-1, J)
    co = torch.cos(dt[:, None] * d[None, :])
    si = torch.sin(dt[:, None] * d[None, :])
    rot = torch.stack(
        [torch.stack([co, si], -1), torch.stack([-si, co], -1)], -2
    )  # (N-1, J, 2, 2)
    blocks_phi = decay[..., None, None] * rot
    # scatter the (J, 2, 2) blocks onto the (R, R) diagonal
    idx = 2 * torch.arange(J, device=device)[:, None, None]
    two = torch.arange(2, device=device)
    Phi = torch.zeros((dt.shape[0], R, R), dtype=dtype, device=device)
    Phi[:, idx + two[None, :, None], idx + two[None, None, :]] = blocks_phi
    return H, Pinf, Phi


def build_process_noise(a, b, c, d, t) -> torch.Tensor:
    """Exact stationary increments ``Q_k = Pinf - Phi_k Pinf Phi_k^T``,
    computed blockwise in closed form.

    The naive subtraction cancels catastrophically in f32 for small
    ``c dt`` (Q ~ 2 c dt); the closed form uses ``-expm1(-2 c dt)`` for
    the dominant diagonal so every entry is accurate to machine eps.
    Block algebra: with gamma = e^{-c dt}, theta = d dt,
      Q_j = a(1-gamma^2) I + b [[-g2 sin2t, 1-g2 cos2t],
                                [1-g2 cos2t, g2 sin2t]],  g2 = gamma^2.
    """
    J = a.shape[0]
    R = 2 * J
    dt = torch.diff(t)
    g2 = torch.exp(-2.0 * dt[:, None] * c[None, :])  # (N-1, J)
    one_m_g2 = -torch.expm1(-2.0 * dt[:, None] * c[None, :])
    s2t = torch.sin(2.0 * dt[:, None] * d[None, :])
    c2t = torch.cos(2.0 * dt[:, None] * d[None, :])
    q11 = a * one_m_g2 - b * g2 * s2t
    q22 = a * one_m_g2 + b * g2 * s2t
    q12 = b * (1.0 - g2 * c2t)
    Q = torch.zeros((dt.shape[0], R, R), dtype=t.dtype, device=t.device)
    idx = 2 * torch.arange(J, device=t.device)
    Q[:, idx, idx] = q11
    Q[:, idx + 1, idx + 1] = q22
    Q[:, idx, idx + 1] = q12
    Q[:, idx + 1, idx] = q12
    return Q


def _guarded(total, S1, S):
    """``total``, or -inf unless every innovation variance is positive
    and the total finite."""
    ok = (S1 > 0) & torch.all(S > 0) & torch.isfinite(total)
    return torch.where(ok, total, torch.full_like(total, -math.inf))


def logl_kalman_sequential(a, b, c, d, t, y, sigma2):
    """Sequential Kalman-filter log-likelihood (cross-check backend).

    Same value as ops.celerite.logl: both are the prediction-error
    decomposition of log N(y; 0, K + diag(sigma2)). A host loop over the
    N - 1 steps.
    """
    H, Pinf, Phi = build_ssm(a, b, c, d, t)
    Q = build_process_noise(a, b, c, d, t)

    # first point: x_1 ~ N(0, Pinf)
    v1 = y[0]
    S1 = H @ Pinf @ H + sigma2[0]
    K1 = (Pinf @ H) / S1
    m = K1 * v1
    P = Pinf - torch.outer(K1, H @ Pinf)
    ll1 = -0.5 * (torch.log(2.0 * math.pi * S1) + v1 * v1 / S1)

    lls, Ss = [], []
    for k in range(Phi.shape[0]):
        Phik = Phi[k]
        m_pred = Phik @ m
        P_pred = Phik @ P @ Phik.T + Q[k]
        v = y[k + 1] - H @ m_pred
        S = H @ P_pred @ H + sigma2[k + 1]
        K = (P_pred @ H) / S
        m = m_pred + K * v
        P = P_pred - torch.outer(K, H @ P_pred)
        lls.append(-0.5 * (torch.log(2.0 * math.pi * S) + v * v / S))
        Ss.append(S)

    if not lls:
        return _guarded(ll1, S1, S1)
    total = ll1 + torch.sum(torch.stack(lls))
    return _guarded(total, S1, torch.stack(Ss))


class _FilterElement(NamedTuple):
    A: torch.Tensor
    b: torch.Tensor
    C: torch.Tensor
    eta: torch.Tensor
    J: torch.Tensor


def _combine(ei: _FilterElement, ej: _FilterElement) -> _FilterElement:
    """Associative combine of filtering elements (Sarkka & G-F 2021, eq. 10).

    Batched over the leading axis by :func:`_associative_scan`; one LU
    of (I + Ci Jj) a pair serves both solves.
    """
    Ai, bi, Ci, etai, Ji = ei
    Aj, bj, Cj, etaj, Jj = ej
    R = Ai.shape[-1]
    I = torch.eye(R, dtype=Ai.dtype, device=Ai.device)
    # M = (I + Ci Jj)^{-1}; solve once, reuse transpose-solve for the dual
    LU = I + Ci @ Jj
    AjM = torch.linalg.solve(LU.mT, Aj.mT).mT  # Aj (I + Ci Jj)^{-1}
    A = AjM @ Ai
    b = (AjM @ (bi[..., None] + Ci @ etaj[..., None]))[..., 0] + bj
    C = AjM @ Ci @ Aj.mT + Cj
    # dual: Ai^T (I + Jj Ci)^{-1} = [ (I + Ci Jj)^{-1} Ai ]^T  (C, J symmetric)
    AitM = torch.linalg.solve(LU, Ai).mT
    eta = (AitM @ (etaj[..., None] - Jj @ bi[..., None]))[..., 0] + etai
    Jout = AitM @ Jj @ Ai + Ji
    return _FilterElement(A, b, C, eta, Jout)


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Rows even[0], odd[0], even[1], odd[1], ... (``even`` holds as many
    rows as ``odd`` or one more)."""
    n = odd.shape[0]
    pairs = torch.stack([even[:n], odd], dim=1).reshape((2 * n,) + odd.shape[1:])
    return torch.cat([pairs, even[n:]]) if even.shape[0] > n else pairs


def _associative_scan(fn: Callable, elems: _FilterElement) -> _FilterElement:
    """Inclusive scan of ``fn`` over the leading axis of every field, in
    the odd/even recursion of JAX's ``lax.associative_scan``: combine
    adjacent pairs, scan the pairs, then fill in the even positions."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = fn(_FilterElement(*(e[0:-1:2] for e in elems)),
                 _FilterElement(*(e[1::2] for e in elems)))
    odd = _associative_scan(fn, reduced)
    later = _FilterElement(*(e[2::2] for e in elems))
    if n % 2 == 0:
        even = fn(_FilterElement(*(e[:-1] for e in odd)), later)
    else:
        even = fn(odd, later)
    # the first element of a scan is the first element of the input
    even = [torch.cat([e[:1], r]) for e, r in zip(elems, even)]
    return _FilterElement(*(_interleave(e, o) for e, o in zip(even, odd)))


def logl_kalman(a, b, c, d, t, y, sigma2):
    """Log-depth celerite log-likelihood via parallel Kalman filtering."""
    H, Pinf, Phi = build_ssm(a, b, c, d, t)
    Q = build_process_noise(a, b, c, d, t)
    R = H.shape[0]
    dtype, device = t.dtype, t.device
    I = torch.eye(R, dtype=dtype, device=device)

    # --- per-step elements, k >= 2 (vectorised) ---
    QH = Q @ H  # (N-1, R)
    S = QH @ H + sigma2[1:]  # innovation given exact previous state
    K = QH / S[:, None]  # (N-1, R)
    A = (I[None] - K[:, :, None] * H[None, None, :]) @ Phi
    bvec = K * y[1:, None]
    C = Q - K[:, :, None] * QH[:, None, :]
    PhiT_H = Phi.mT @ H  # (N-1, R)
    eta = PhiT_H * (y[1:] / S)[:, None]
    Jmat = (PhiT_H / S[:, None])[:, :, None] * PhiT_H[:, None, :]

    # --- first element: x_1 ~ N(0, Pinf), observe y_1 ---
    S1 = H @ Pinf @ H + sigma2[0]
    K1 = (Pinf @ H) / S1
    zeros_rr = torch.zeros((1, R, R), dtype=dtype, device=device)
    b1 = K1 * y[0]
    C1 = Pinf - torch.outer(K1, H @ Pinf)

    elems = _FilterElement(
        A=torch.cat([zeros_rr, A]),
        b=torch.cat([b1[None], bvec]),
        C=torch.cat([C1[None], C]),
        eta=torch.cat([torch.zeros((1, R), dtype=dtype, device=device), eta]),
        J=torch.cat([zeros_rr, Jmat]),
    )

    filt = _associative_scan(_combine, elems)
    m_filt = filt.b  # (N, R): filtered means (A-prefix hits the zero prior)
    P_filt = filt.C  # (N, R, R)

    # prediction-error decomposition from the filtered marginals
    m_pred = (Phi @ m_filt[:-1, :, None])[..., 0]  # (N-1, R)
    P_pred = Phi @ P_filt[:-1] @ Phi.mT + Q
    v = y[1:] - m_pred @ H
    Spred = (P_pred @ H) @ H + sigma2[1:]
    ll1 = -0.5 * (torch.log(2.0 * math.pi * S1) + y[0] * y[0] / S1)
    lls = -0.5 * (torch.log(2.0 * math.pi * Spred) + v * v / Spred)
    total = ll1 + torch.sum(lls)
    return _guarded(total, S1, Spred)


def log_likelihood_kalman(kernel, t, y, sigma2, sequential: bool = False):
    """Kernel-level API mirroring ops.celerite.log_likelihood, for one
    light curve: the kernel's coefficients are (J,)."""
    a, b, c, d = kernel.coefficients()
    if a.dim() != 1:
        raise ValueError(f"log_likelihood_kalman takes one kernel, (J,) coefficients; "
                         f"got {tuple(a.shape)}")
    fn = logl_kalman_sequential if sequential else logl_kalman
    return fn(a, b, c, d, t, y, sigma2)
