"""PSD -> celerite-kernel approximation, PyTorch port of
``pioran_tpu.ops.approx``, batched over a leading chain axis:

  1. log grid  f_j = f0 (fM/f0)^(j/(J-1))
  2. B[j,k] = 1 / (1 + (f_j/f_k)^p), p = 4 (SHO) or 6 (DRWCelerite)
  3. solve B A = P(f_j)/P(f_0)
  4. normalise by the analytic band integral (or the variance)
  5. emit celerite coefficients

The grid and the J x J matrix depend only on f_min and f_max, so one
matrix serves every chain: its LU factorisation is done once and the
B right-hand sides are solved together.
"""

from __future__ import annotations

import math
from dataclasses import fields, is_dataclass
from typing import Optional, Tuple

import torch

from ..models.kernels import CeleriteKernel
from ..models.psd import PowerSpectralDensity, QPO, separate_psd

__all__ = [
    "spectral_grid",
    "spectral_matrix",
    "psd_decomposition",
    "get_approx_coefficients",
    "approx",
    "integral_sho",
    "integral_drwcelerite",
    "integral_celerite",
    "integrate_basis_function",
    "integrate_psd_feature",
    "get_norm_psd",
]

_SQRT2 = 1.4142135623730951
_SQRT3 = 1.7320508075688772


def spectral_grid(J: int, f0, fM, dtype=torch.float64, device=None):
    """Log-spaced grid f_j = f0 (fM/f0)^(j/(J-1)), shape (J,)."""
    f0 = torch.as_tensor(f0, dtype=dtype, device=device)
    fM = torch.as_tensor(fM, dtype=dtype, device=device)
    j = torch.arange(J, dtype=dtype, device=device)
    return f0 * (fM / f0) ** (j / (J - 1))


def _basis_power(basis_function: str) -> int:
    if basis_function == "SHO":
        return 4
    if basis_function == "DRWCelerite":
        return 6
    raise ValueError(
        f"Basis function {basis_function!r} not implemented; use 'SHO' or 'DRWCelerite'"
    )


def spectral_matrix(points, basis_function: str = "SHO"):
    """B[j,k] = 1/(1 + (f_j/f_k)^p) with p = 4 (SHO) or 6 (DRWCelerite)."""
    p = _basis_power(basis_function)
    ratio = points[:, None] / points[None, :]
    return 1.0 / (1.0 + ratio**p)


def psd_decomposition(psd_normalised, matrix):
    """Amplitudes A solving B A = P_normalised for each row of the
    ``(..., J)`` right-hand side against one shared ``(J, J)`` matrix."""
    rhs = psd_normalised.reshape(-1, matrix.shape[0]).T  # (J, rows)
    # solve_ex: no device->host sync for the error check on the card
    sol, _ = torch.linalg.solve_ex(matrix, rhs)
    return sol.T.reshape(psd_normalised.shape)


def get_approx_coefficients(
    psd_model: PowerSpectralDensity,
    f0,
    fM,
    n_components: int = 20,
    basis_function: str = "SHO",
    dtype=torch.float64,
    device=None,
):
    """Basis amplitudes of the approximation, shape (..., n_components)."""
    points = spectral_grid(n_components, f0, fM, dtype, device)
    matrix = spectral_matrix(points, basis_function)
    p = psd_model(points)
    return psd_decomposition(p / p[..., :1], matrix)


# --------------------------------------------------------------------------
# Analytic band integrals; coefficient tensors are (..., J), x a scalar
# --------------------------------------------------------------------------


def integral_sho(a, c, x):
    """Antiderivative of sum_j a_j / ((x/c_j)^4 + 1)."""
    norm = c * a / (4.0 * _SQRT2)
    poly = (x**2 + _SQRT2 * c * x + c**2) / (x**2 - _SQRT2 * c * x + c**2)
    return torch.sum(
        norm * (torch.log(poly) + 2.0 * torch.atan2(c * _SQRT2 * x, c**2 - x**2)),
        dim=-1,
    )


def integral_drwcelerite(a, c, x):
    """Antiderivative of sum_j a_j / ((x/c_j)^6 + 1)."""
    norm = a * c / 3.0
    drw = torch.atan(x / c)
    poly = (x**2 + _SQRT3 * c * x + c**2) / (x**2 - _SQRT3 * c * x + c**2)
    cel = 0.5 * torch.atan2(x**2 - c**2, c * x) + _SQRT3 / 4.0 * torch.log(poly)
    return torch.sum(norm * (drw + cel), dim=-1)


def integral_celerite(a, b, c, d, x):
    """Antiderivative of the celerite PSD (elementwise in the terms)."""
    num = c**2 + (d + 2.0 * math.pi * x) ** 2
    den = c**2 + (d - 2.0 * math.pi * x) ** 2
    return (
        2.0 * a * (torch.atan2(c, d - 2.0 * math.pi * x)
                   - torch.atan2(c, d + 2.0 * math.pi * x))
        + b * torch.log(num / den)
    ) / (2.0 * math.pi)


def integrate_basis_function(a, c, x1, x2, basis_function: str = "SHO"):
    """Band integral of the basis sum between x1 and x2."""
    if basis_function == "SHO":
        return integral_sho(a, c, x2) - integral_sho(a, c, x1)
    if basis_function == "DRWCelerite":
        return integral_drwcelerite(a, c, x2) - integral_drwcelerite(a, c, x1)
    raise ValueError(f"Unknown basis function: {basis_function}")


def integrate_psd_feature(a, b, c, d, x1, x2):
    """Band integral of a celerite feature PSD."""
    return integral_celerite(a, b, c, d, x2) - integral_celerite(a, b, c, d, x1)


def get_norm_psd(
    amplitudes, points, f_min, f_max, basis_function: str,
    is_integrated_power: bool = True, feat_coefs=None,
):
    """Normalisation of a basis-function sum: the band power on
    [f_min, f_max], or the total 0..inf variance. Shape (...,)."""
    if is_integrated_power:
        integ = integrate_basis_function(amplitudes, points, f_min, f_max, basis_function)
        if feat_coefs is not None:
            fa, fb, fc, fd = feat_coefs
            integ = integ + torch.sum(integrate_psd_feature(fa, fb, fc, fd, f_min, f_max),
                                      dim=-1)
        return integ
    if basis_function == "SHO":
        return torch.sum(amplitudes * points, dim=-1) * math.pi / _SQRT2
    return torch.sum(amplitudes * points, dim=-1) * 2.0 * math.pi / 3.0


def _param_like(psd_model: PowerSpectralDensity, norm) -> torch.Tensor:
    """The first tensor among the model's parameters and ``norm``: it sets
    the approximation's dtype and device."""
    stack = [psd_model, norm]
    while stack:
        x = stack.pop(0)
        if isinstance(x, torch.Tensor):
            return x
        if is_dataclass(x):
            stack += [getattr(x, f.name) for f in fields(x)]
        elif isinstance(x, tuple):
            stack += list(x)
    return torch.zeros((), dtype=torch.float64)


def approx(
    psd_model: PowerSpectralDensity,
    f_min,
    f_max,
    n_components: int = 20,
    norm=1.0,
    S_low=20.0,
    S_high=20.0,
    is_integrated_power: bool = True,
    basis_function: str = "SHO",
) -> CeleriteKernel:
    """Approximate a PSD with basis functions, returning a celerite kernel.

    The model's parameters and ``norm`` are scalars or ``(B,)`` tensors;
    the kernel's coefficients are ``(J,)`` or ``(B, J)`` in the dtype and
    on the device of the first parameter tensor. The PSD is approximated
    on [f_min/S_low, f_max*S_high], and the kernel is normalised so the
    band power on [f_min, f_max] equals ``norm`` (with
    ``is_integrated_power=False``: so the process variance equals
    ``norm``). ``f_min`` and ``f_max`` are Python floats.
    """
    like = _param_like(psd_model, norm)
    dtype, device = like.dtype, like.device
    f0 = f_min / S_low
    fM = f_max * S_high
    points = spectral_grid(n_components, f0, fM, dtype, device)  # (J,)
    matrix = spectral_matrix(points, basis_function)

    continuum, features = separate_psd(psd_model)
    if continuum is None:
        raise ValueError(
            "The PSD model must contain at least one continuum component to approximate"
        )
    for feat in features:
        if not isinstance(feat, QPO):
            raise NotImplementedError(f"Feature {type(feat).__name__} not implemented")

    p_points = continuum(points)  # (..., J)
    psd_norm = p_points[..., :1]
    amplitudes = psd_decomposition(p_points / psd_norm, matrix)

    # feature terms: exact celerite coefficients, amplitudes normalised
    # the same way as the continuum
    feat_coefs: Optional[Tuple[torch.Tensor, ...]] = None
    if features:
        fa, fb, fc, fd = zip(*(q.celerite_coefficients(like) for q in features))
        batch = amplitudes.shape[:-1]
        fa, fb, fc, fd = (torch.stack([x.expand(batch) for x in v], dim=-1)
                          for v in (fa, fb, fc, fd))
        feat_coefs = (fa / psd_norm, fb / psd_norm, fc, fd)

    points_b = points.expand_as(amplitudes)
    f_lo = torch.as_tensor(f_min, dtype=dtype, device=device)
    f_hi = torch.as_tensor(f_max, dtype=dtype, device=device)
    # variance normalisation uses the continuum only, like the reference
    integ = get_norm_psd(amplitudes, points_b, f_lo, f_hi, basis_function,
                         is_integrated_power, feat_coefs)
    scale = (torch.as_tensor(norm, dtype=dtype, device=device) / integ)[..., None]
    amplitudes = amplitudes * scale
    if feat_coefs is not None:
        fa, fb, fc, fd = feat_coefs
        feat_coefs = (fa * scale, fb * scale, fc, fd)

    if basis_function == "SHO":
        a = amplitudes * points_b * math.pi / _SQRT2
        c = _SQRT2 * math.pi * points_b
        ka, kb, kc, kd = a, a, c, c
    else:  # DRWCelerite = celerite part + DRW part
        a = amplitudes * points_b * math.pi / 3.0
        b = _SQRT3 * a
        c = math.pi * points_b
        d = _SQRT3 * c
        zeros = torch.zeros_like(a)
        ka = torch.cat([a, a], dim=-1)
        kb = torch.cat([b, zeros], dim=-1)
        kc = torch.cat([c, 2.0 * c], dim=-1)
        kd = torch.cat([d, zeros], dim=-1)

    if feat_coefs is not None:
        fa, fb, fc, fd = feat_coefs
        ka = torch.cat([ka, 2.0 * fa], dim=-1)
        kb = torch.cat([kb, 2.0 * fb], dim=-1)
        kc = torch.cat([kc, fc], dim=-1)
        kd = torch.cat([kd, fd], dim=-1)

    return CeleriteKernel(a=ka, b=kb, c=kc, d=kd)
