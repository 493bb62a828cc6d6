"""Dense O(N^3) GP log-likelihood, PyTorch port of ``pioran_tpu.ops.direct``.

Not used on the hot path: a dense Cholesky computation against which the
O(N) celerite recursion and its adjoint are checked on small N. As in the
reference, :func:`log_likelihood_direct` returns the NEGATIVE
log-likelihood.
"""

from __future__ import annotations

import math

import torch

__all__ = ["covariance_matrix", "log_likelihood_direct"]


def covariance_matrix(kernel, x1, x2):
    """Dense K[..., i, j] = k(|x1_i - x2_j|)."""
    return kernel(torch.abs(x1[:, None] - x2[None, :]))


def log_likelihood_direct(kernel, t, y, sigma2):
    """Negative log-likelihood via a dense Cholesky factorisation."""
    N = t.shape[0]
    K = covariance_matrix(kernel, t, t) + torch.diag_embed(sigma2)
    L = torch.linalg.cholesky(K)
    z = torch.linalg.solve_triangular(L, y[..., :, None], upper=False)[..., 0]
    logdet_L = torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    return logdet_L + 0.5 * torch.sum(z * z, dim=-1) + 0.5 * N * math.log(2.0 * math.pi)
