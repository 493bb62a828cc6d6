"""Semi-separable (celerite) covariance functions, PyTorch port of
``pioran_tpu.models.kernels``.

:class:`CeleriteKernel` stores the stacked celerite coefficients
``(a, b, c, d)`` as tensors of shape ``(..., J)``, a leading batch axis
holding one kernel per chain:

    k(tau) = sum_j exp(-c_j tau) (a_j cos(d_j tau) + b_j sin(d_j tau))

``+`` concatenates terms; scalar ``*`` scales (a, b).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..config import DEFAULT_DTYPE

__all__ = [
    "CeleriteKernel",
    "celerite_term",
    "sho_term",
    "exp_term",
    "celerite_psd",
    "celerite_covariance",
    "SHO",
    "Exp",
]


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        x, dtype=DEFAULT_DTYPE)


def celerite_covariance(tau, a, b, c, d):
    """k(tau) for one term."""
    tau = torch.abs(_t(tau))
    return torch.exp(-c * tau) * (a * torch.cos(d * tau) + b * torch.sin(d * tau))


def celerite_psd(f, a, b, c, d):
    """One-sided absolute-frequency celerite PSD of one term (with the
    factor 4 of the one-sided, absolute-frequency convention)."""
    w = 2.0 * math.pi * _t(f)
    num = (a * c + b * d) * (c**2 + d**2) + (a * c - b * d) * w**2
    den = w**4 + 2.0 * (c**2 - d**2) * w**2 + (c**2 + d**2) ** 2
    return num / den * 4.0


@dataclass(frozen=True)
class CeleriteKernel:
    """Sum of J celerite terms stored as ``(..., J)`` coefficient tensors."""

    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    d: torch.Tensor

    @property
    def num_terms(self) -> int:
        return self.a.shape[-1]

    def __add__(self, other: "CeleriteKernel") -> "CeleriteKernel":
        return CeleriteKernel(
            a=torch.cat([self.a, other.a], dim=-1),
            b=torch.cat([self.b, other.b], dim=-1),
            c=torch.cat([self.c, other.c], dim=-1),
            d=torch.cat([self.d, other.d], dim=-1),
        )

    def __mul__(self, scale) -> "CeleriteKernel":
        return CeleriteKernel(a=self.a * scale, b=self.b * scale, c=self.c, d=self.d)

    __rmul__ = __mul__

    def __call__(self, tau):
        """k(|tau|) summed over terms. ``tau`` has shape ``(..., M)`` whose
        leading axes match the coefficients' batch axes."""
        tau = torch.abs(_t(tau))[..., None]
        a, b, c, d = (x.unsqueeze(-2) for x in self.coefficients())
        return torch.sum(
            torch.exp(-c * tau) * (a * torch.cos(d * tau) + b * torch.sin(d * tau)),
            dim=-1,
        )

    def psd(self, f):
        """One-sided PSD of the kernel summed over terms; ``f`` as in
        :meth:`__call__`."""
        f = _t(f)[..., None]
        a, b, c, d = (x.unsqueeze(-2) for x in self.coefficients())
        return torch.sum(celerite_psd(f, a, b, c, d), dim=-1)

    def coefficients(self):
        return self.a, self.b, self.c, self.d


def celerite_term(a, b, c, d) -> CeleriteKernel:
    """A single celerite term as a 1-term kernel."""
    as_vec = lambda x: torch.atleast_1d(_t(x))  # noqa: E731
    return CeleriteKernel(a=as_vec(a), b=as_vec(b), c=as_vec(c), d=as_vec(d))


def exp_term(A, alpha) -> CeleriteKernel:
    """Exponential (damped random walk) kernel k(tau) = A/2 exp(-alpha tau):
    coefficients (A/2, 0, alpha, 0)."""
    A = _t(A)
    return celerite_term(A / 2.0, torch.zeros_like(A), _t(alpha), torch.zeros_like(A))


def sho_term(A, w0, Q=None) -> CeleriteKernel:
    """SHO kernel at the critically damped point Q = 1/sqrt(2):
    coefficients (A, A, w0/sqrt(2), w0/sqrt(2)). Only that Q has a
    celerite representation."""
    if Q is not None and not math.isclose(float(Q), 1.0 / math.sqrt(2.0),
                                          rel_tol=1e-5, abs_tol=1e-8):
        raise NotImplementedError("SHO with Q != 1/sqrt(2) not implemented yet")
    A = _t(A)
    c = _t(w0) * math.sqrt(2.0) / 2.0
    return celerite_term(A, A, c, c)


@dataclass(frozen=True)
class SHO:
    """Full SHO covariance with its three Q regimes:

    k(tau) = A exp(-w0 tau / 2Q) * { 2(1 + w0 tau)                      Q = 1/2
                                   { cos(e w0 t) + sin(e w0 t)/(2 e Q)   Q > 1/2
                                   { cosh(e w0 t) + sinh(e w0 t)/(2eQ)   Q < 1/2
    with e = sqrt(|1 - 1/(4 Q^2)|). The Q comparison is on a Python float.
    """

    A: torch.Tensor
    w_0: torch.Tensor
    Q: torch.Tensor

    def __call__(self, tau):
        tau = torch.abs(_t(tau))
        A, w0, Q = (torch.as_tensor(x, dtype=tau.dtype, device=tau.device)
                    for x in (self.A, self.w_0, self.Q))
        term1 = A * torch.exp(-w0 * tau / Q / 2.0)
        eta = torch.sqrt(torch.abs(1.0 - 1.0 / (4.0 * Q**2)))
        qval = float(Q)
        if qval == 0.5:
            return term1 * 2.0 * (1.0 + w0 * tau)
        if qval >= 0.5:
            return term1 * (
                torch.cos(eta * w0 * tau) + torch.sin(eta * w0 * tau) / (2.0 * eta * Q)
            )
        return term1 * (
            torch.cosh(eta * w0 * tau) + torch.sinh(eta * w0 * tau) / (2.0 * eta * Q)
        )

    def celerite(self) -> CeleriteKernel:
        return sho_term(self.A, self.w_0, float(self.Q))


@dataclass(frozen=True)
class Exp:
    """Exponential covariance k(tau) = A/2 exp(-alpha tau)."""

    A: torch.Tensor
    alpha: torch.Tensor

    def __call__(self, tau):
        return self.A / 2.0 * torch.exp(-self.alpha * torch.abs(_t(tau)))

    def psd(self, f):
        """P(f) = 2 A alpha / (alpha^2 + 4 pi^2 f^2)."""
        return 2.0 * self.A * self.alpha / (self.alpha**2 + 4.0 * math.pi**2 * _t(f) ** 2)

    def celerite(self) -> CeleriteKernel:
        return exp_term(self.A, self.alpha)
