"""Dense O(N^3) GP solver, PyTorch port of ``pioran_tpu.ops.direct``.

Not used on the hot path: a dense Cholesky computation against which the
O(N) celerite recursion, its adjoint and the posterior mean are checked,
and the posterior covariance of the GP object API. Every function takes
a kernel with ``(..., J)`` coefficients and returns one result per
leading index. As in the reference, :func:`log_likelihood_direct`
returns the NEGATIVE log-likelihood.
"""

from __future__ import annotations

import math

import torch

__all__ = ["covariance_matrix", "log_likelihood_direct", "predict_direct",
           "predict_cov_direct"]


def covariance_matrix(kernel, x1, x2):
    """Dense K[..., i, j] = k(|x1_i - x2_j|), (..., M, N) for x1 (M,),
    x2 (N,): summed term by term, so no (..., M, N, J) tensor is held."""
    tau = torch.abs(x1[:, None] - x2[None, :])
    K = None
    for a, b, c, d in zip(*(x.unbind(-1) for x in kernel.coefficients())):
        a, b, c, d = (v[..., None, None] for v in (a, b, c, d))
        term = torch.exp(-c * tau) * (a * torch.cos(d * tau) + b * torch.sin(d * tau))
        K = term if K is None else K + term
    return K


def _factor(kernel, t, sigma2):
    """The Cholesky factor of K(t, t) + diag(sigma2), (..., N, N)."""
    return torch.linalg.cholesky(covariance_matrix(kernel, t, t) + torch.diag_embed(sigma2))


def log_likelihood_direct(kernel, t, y, sigma2):
    """Negative log-likelihood via a dense Cholesky factorisation, (...,)."""
    N = t.shape[0]
    L = _factor(kernel, t, sigma2)
    y = y.expand(L.shape[:-1])
    z = torch.linalg.solve_triangular(L, y[..., :, None], upper=False)[..., 0]
    logdet_L = torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    return logdet_L + 0.5 * torch.sum(z * z, dim=-1) + 0.5 * N * math.log(2.0 * math.pi)


def _cross(kernel, tau, t, sigma2):
    """(L, w): the factor of the data covariance and w = L^{-1} K(t, tau)."""
    L = _factor(kernel, t, sigma2)
    Kt0 = covariance_matrix(kernel, tau, t)
    w = torch.linalg.solve_triangular(L, Kt0.expand(L.shape[:-2] + Kt0.shape[-2:]).mT,
                                      upper=False)
    return L, w


def predict_direct(kernel, tau, t, y, sigma2, with_covariance: bool = False):
    """Posterior mean (..., M) at ``tau`` (M,), and with
    ``with_covariance`` the posterior covariance (..., M, M), via dense
    Cholesky (reference direct_solver.jl:75-119)."""
    L, w = _cross(kernel, tau, t, sigma2)
    y = y.expand(L.shape[:-1])
    alpha = torch.linalg.solve_triangular(L, y[..., :, None], upper=False)
    mean = (w.mT @ alpha)[..., 0]
    if with_covariance:
        return mean, covariance_matrix(kernel, tau, tau) - w.mT @ w
    return mean


def predict_cov_direct(kernel, tau, t, sigma2):
    """Posterior covariance (..., M, M) at ``tau`` via dense Cholesky
    (reference direct_solver.jl:28-68)."""
    _, w = _cross(kernel, tau, t, sigma2)
    return covariance_matrix(kernel, tau, tau) - w.mT @ w
