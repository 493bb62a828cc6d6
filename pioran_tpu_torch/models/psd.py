"""Power-spectral-density models (PyTorch port of ``pioran_tpu.models.psd``).

Each model is a frozen dataclass whose fields are scalars or tensors of
shape ``(B,)``: one parameter value per chain. Calling a model on
frequencies ``f`` broadcasts each parameter against the leading axes of
``f`` and treats its last axis as frequency, so a ``(B,)``-parameter
model evaluated on a shared ``(J,)`` grid returns ``(B, J)``.
``+`` combines models; :func:`separate_psd` splits a sum into its
broadband continuum and its narrow features.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple, Union

import torch

from ..config import DEFAULT_DTYPE

__all__ = [
    "PowerSpectralDensity",
    "ContinuumPSD",
    "FeaturePSD",
    "PowerLaw",
    "SingleBendingPowerLaw",
    "DoubleBendingPowerLaw",
    "Lorentzian",
    "QPO",
    "SumPSD",
    "separate_psd",
]


def _p(x, like: torch.Tensor) -> torch.Tensor:
    """Parameter ``x`` as a tensor shaped to broadcast over the last
    (frequency) axis of ``like``."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)[..., None]


def _f(f) -> torch.Tensor:
    if isinstance(f, torch.Tensor):
        return f
    return torch.as_tensor(f, dtype=DEFAULT_DTYPE)


class PowerSpectralDensity:
    """Base class: callable PSD model. Subclasses implement ``__call__``."""

    def __add__(self, other: "PowerSpectralDensity") -> "SumPSD":
        parts: Tuple[PowerSpectralDensity, ...] = ()
        parts += self.components if isinstance(self, SumPSD) else (self,)
        parts += other.components if isinstance(other, SumPSD) else (other,)
        return SumPSD(parts)

    def __call__(self, f):  # pragma: no cover - abstract
        raise NotImplementedError


class ContinuumPSD(PowerSpectralDensity):
    """Broadband continuum shape, approximated with SHO/DRWCelerite bases."""


class FeaturePSD(PowerSpectralDensity):
    """Narrow feature, converted to an exact celerite term (no basis fit)."""


@dataclass(frozen=True)
class PowerLaw(ContinuumPSD):
    """P(f) = f^-alpha."""

    alpha: torch.Tensor

    def __call__(self, f):
        f = _f(f)
        return f ** (-_p(self.alpha, f))


@dataclass(frozen=True)
class SingleBendingPowerLaw(ContinuumPSD):
    """P(f) = (f/f_1)^-a1 / (1 + (f/f_1)^(a2-a1))."""

    alpha_1: torch.Tensor
    f_1: torch.Tensor
    alpha_2: torch.Tensor

    def __call__(self, f):
        f = _f(f)
        a1, a2 = _p(self.alpha_1, f), _p(self.alpha_2, f)
        x = f / _p(self.f_1, f)
        return x ** (-a1) / (1.0 + x ** (a2 - a1))


@dataclass(frozen=True)
class DoubleBendingPowerLaw(ContinuumPSD):
    """P(f) = (f/f_1)^-a1 / (1+(f/f_1)^(a2-a1)) / (1+(f/f_2)^(a3-a2))."""

    alpha_1: torch.Tensor
    f_1: torch.Tensor
    alpha_2: torch.Tensor
    f_2: torch.Tensor
    alpha_3: torch.Tensor

    def __call__(self, f):
        f = _f(f)
        a1, a2, a3 = (_p(x, f) for x in (self.alpha_1, self.alpha_2,
                                         self.alpha_3))
        x1 = f / _p(self.f_1, f)
        x2 = f / _p(self.f_2, f)
        return x1 ** (-a1) / (1.0 + x1 ** (a2 - a1)) / (1.0 + x2 ** (a3 - a2))


@dataclass(frozen=True)
class QPO(FeaturePSD):
    """Quasi-periodic oscillation QPO(S0, f0, Q): the celerite PSD of its
    exact celerite term,

        P(f) = S0 w0^4 / ((w^2 - w0^2)^2 + (w0 w / Q)^2),  w = 2 pi f.
    """

    S_0: torch.Tensor
    f_0: torch.Tensor
    Q: torch.Tensor

    def __call__(self, f):
        f = _f(f)
        w = 2.0 * math.pi * f
        w0 = 2.0 * math.pi * _p(self.f_0, f)
        S0, Q = _p(self.S_0, f), _p(self.Q, f)
        return S0 * w0**4 / ((w**2 - w0**2) ** 2 + (w0 * w / Q) ** 2)

    def celerite_coefficients(self, like: torch.Tensor):
        """Exact celerite (a, b, c, d), each shaped like the parameters:
        Delta = sqrt(4 Q^2 - 1), w0 = 2 pi f0, a = S0 w0 Q / 4,
        b = a / Delta, c = w0 / (2 Q), d = c Delta. ``like`` gives the
        dtype and device."""
        S0, f0, Q = (torch.as_tensor(x, dtype=like.dtype, device=like.device)
                     for x in (self.S_0, self.f_0, self.Q))
        delta = torch.sqrt(4.0 * Q**2 - 1.0)
        w0 = 2.0 * math.pi * f0
        a = S0 * w0 * Q / 4.0
        b = a / delta
        c = w0 / Q / 2.0
        d = c * delta
        return a, b, c, d


@dataclass(frozen=True)
class Lorentzian(FeaturePSD):
    """P(f) = A (gamma/2)^2 / ((f - f0)^2 + (gamma/2)^2).

    Like the reference, only QPO features take part in the celerite
    conversion; a Lorentzian is evaluated but not approximated."""

    A: torch.Tensor
    f_0: torch.Tensor
    gamma: torch.Tensor

    def __call__(self, f):
        f = _f(f)
        hg = _p(self.gamma, f) / 2.0
        return _p(self.A, f) * hg**2 / ((f - _p(self.f_0, f)) ** 2 + hg**2)


@dataclass(frozen=True)
class SumPSD(PowerSpectralDensity):
    """Sum of PSD components (continuum + features)."""

    components: Tuple[PowerSpectralDensity, ...]

    def __call__(self, f):
        total = self.components[0](f)
        for comp in self.components[1:]:
            total = total + comp(f)
        return total


def separate_psd(
    psd: PowerSpectralDensity,
) -> Tuple[Union[PowerSpectralDensity, None], Tuple[FeaturePSD, ...]]:
    """Split a PSD model into (continuum, features): the continuum is one
    ContinuumPSD, a SumPSD of them, or None; features a tuple."""
    parts = psd.components if isinstance(psd, SumPSD) else (psd,)
    continuum = tuple(p for p in parts if isinstance(p, ContinuumPSD))
    features = tuple(p for p in parts if isinstance(p, FeaturePSD))
    if len(continuum) == 0:
        cont: Union[PowerSpectralDensity, None] = None
    elif len(continuum) == 1:
        cont = continuum[0]
    else:
        cont = SumPSD(continuum)
    return cont, features
