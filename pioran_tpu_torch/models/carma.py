"""CARMA(p, q) power-spectrum models (reference src/CARMA.jl), PyTorch port
of ``pioran_tpu.models.carma``.

A CARMA model is stored by the roots of its autoregressive polynomial
(complex-conjugate pairs, the last root real when p is odd), its
moving-average coefficients beta and a normalisation. The
partial-fraction expansion turns it into J = ceil(p/2) celerite terms.

Two paths compute the same numbers:

- the real path (:func:`carma_celerite_coefs_real`,
  :func:`carma_psd_real`, :func:`poly_from_conjugate_pairs`) carries
  every complex number as an (re, im) pair of real tensors. It is
  batched: each root is a ``(B,)`` tensor (or a scalar), beta is
  ``(..., q + 1)`` with the order on its last axis, and the
  coefficients come out ``(B, J)``. The likelihood of
  ``inference.carma_model`` runs it, on the card in float32 or float64.
- the complex path (:class:`CARMA`, :func:`carma_celerite_coefs`,
  :func:`carma_covariance`, :func:`carma_psd`, :func:`roots2coeffs`) is
  one model in complex128: the oracle of the tests. No sampler uses it.

The loops over the roots are Python loops over the static orders p and q.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..config import DEFAULT_DTYPE
from .kernels import CeleriteKernel, _t

__all__ = [
    "CARMA",
    "carma_celerite_coefs",
    "carma_celerite_coefs_real",
    "carma_covariance",
    "carma_psd",
    "carma_psd_real",
    "carma_normalisation",
    "poly_from_conjugate_pairs",
    "quad2roots",
    "roots2coeffs",
    "sample_quad",
]


# ---------------------------------------------------------------------------
# Real-arithmetic path: the likelihood's
# ---------------------------------------------------------------------------


def _c_mul(a, b):
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def _c_div(a, b):
    d = b[0] * b[0] + b[1] * b[1]
    return (a[0] * b[0] + a[1] * b[1]) / d, (a[1] * b[0] - a[0] * b[1]) / d


def _c_polyval(coeffs, z):
    """Horner evaluation of a real-coefficient polynomial (ascending
    order on the last axis of ``coeffs``) at the complex point
    z = (re, im); the coefficients broadcast against z."""
    n = coeffs.shape[-1]
    re = torch.zeros_like(z[0]) + coeffs[..., n - 1]
    im = torch.zeros_like(re)
    for i in range(n - 2, -1, -1):
        re, im = _c_mul((re, im), z)
        re = re + coeffs[..., i]
    return re, im


def _poly_mul(p, q):
    """Product of two polynomials given as lists of coefficient tensors
    (ascending order): the full convolution, written out."""
    out = []
    for k in range(len(p) + len(q) - 1):
        lo, hi = max(0, k - len(q) + 1), min(k, len(p) - 1)
        s = p[lo] * q[k - lo]
        for i in range(lo + 1, hi + 1):
            s = s + p[i] * q[k - i]
        out.append(s)
    return out


def poly_from_conjugate_pairs(pair_re, pair_im, real_roots=()):
    """Real coefficients (ascending, monic) of the polynomial whose roots
    are the conjugate pairs (re_k +- i im_k) and the optional real roots:
    the real-arithmetic analog of :func:`roots2coeffs` for the MA
    polynomial (reference src/CARMA.jl:185-188). Each pair contributes
    the real quadratic z^2 - 2 re z + (re^2 + im^2). The roots are
    tensors of one shape (...); the result is (..., order + 1)."""
    pair_re, pair_im = [_t(x) for x in pair_re], [_t(x) for x in pair_im]
    real_roots = [_t(x) for x in real_roots]
    like = pair_re + real_roots
    if not like:
        return torch.ones(1, dtype=DEFAULT_DTYPE)
    one = torch.ones_like(like[0])
    c = [one]
    for x, y in zip(pair_re, pair_im):
        c = _poly_mul(c, [x * x + y * y, -2.0 * x, one])
    for rho in real_roots:
        c = _poly_mul(c, [-rho, one])
    return torch.stack(c, dim=-1)


def carma_celerite_coefs_real(
    p: int, root_re, root_im, beta, norm=1.0, is_integrated_power: bool = True
):
    """CARMA -> celerite (a, b, c, d) partial fractions in real arithmetic.

    The math of :func:`carma_celerite_coefs` (reference
    src/CARMA.jl:98-143) with every complex number carried as an (re, im)
    pair. ``root_re``/``root_im``: the p roots' real and imaginary parts,
    each a (B,) tensor or a scalar, with root[2k+1] = conj(root[2k]) and a
    real last root when p is odd; ``beta`` (..., q + 1); ``norm`` a scalar
    or (B,). Returns four (B, J) tensors ((J,) for scalar roots).
    """
    root_re, root_im = [_t(x) for x in root_re], [_t(x) for x in root_im]
    beta = _t(beta)
    J = p // 2 + (p % 2)

    a_list, b_list, c_list, d_list = [], [], [], []
    for k in range(J):
        x, y = root_re[2 * k], root_im[2 * k]
        num1 = _c_polyval(beta, (x, y))
        num2 = _c_polyval(beta, (-x, -y))
        fr = _c_mul(num1, num2)
        frac = (-fr[0] / x, -fr[1] / x)
        for j in range(p):
            if j == 2 * k:
                continue
            xj, yj = root_re[j], root_im[j]
            t1 = (xj - x, yj - y)           # r_j - r_k
            t2 = (xj + x, y - yj)           # conj(r_j) + r_k
            frac = _c_div(frac, _c_mul(t1, t2))
        last_is_real = (p % 2 == 1) and (k == J - 1)
        if not last_is_real:
            a_list.append(2.0 * frac[0])
            b_list.append(2.0 * frac[1])
            c_list.append(-x)
            d_list.append(-y)
        else:
            a_list.append(frac[0])
            b_list.append(torch.zeros_like(frac[0]))
            c_list.append(-x)
            d_list.append(torch.zeros_like(x))

    a, b, c, d = (torch.stack(v, dim=-1) for v in (a_list, b_list, c_list, d_list))
    variance = torch.sum(a, dim=-1)
    va = torch.as_tensor(norm, dtype=a.dtype, device=a.device)
    if is_integrated_power:
        va = va / variance
    va = va[..., None]
    return a * va, b * va, c, d


def carma_psd_real(f, p: int, q: int, root_re, root_im, beta, norm=1.0,
                   is_integrated_power: bool = True):
    """CARMA PSD in real arithmetic (the real analog of :func:`carma_psd`).

    |B(2 pi i f)|^2 / |A(2 pi i f)|^2 with A rebuilt from the conjugate
    pairs by :func:`poly_from_conjugate_pairs`, evaluated at purely
    imaginary points. The roots and ``norm`` (scalars or (B,)) and beta
    ((..., q + 1)) broadcast against the last axis of ``f``: (B,) roots
    on an (F,) grid give (B, F).
    """
    f = _t(f)
    w = 2.0 * math.pi * f
    ex = lambda v: _t(v)[..., None]  # noqa: E731
    rre, rim = [ex(r) for r in root_re], [ex(r) for r in root_im]
    pairs_re = [rre[2 * k] for k in range(p // 2)]
    pairs_im = [rim[2 * k] for k in range(p // 2)]
    reals = [rre[p - 1]] if p % 2 == 1 else []
    alpha = poly_from_conjugate_pairs(pairs_re, pairs_im, reals)
    zero = torch.zeros_like(w)
    nre, nim = _c_polyval(_t(beta)[..., None, :], (zero, w))
    dre, dim_ = _c_polyval(alpha, (zero, w))
    ratio2 = (nre * nre + nim * nim) / (dre * dre + dim_ * dim_)
    if is_integrated_power:
        a, _, _, _ = carma_celerite_coefs_real(p, root_re, root_im, beta, 1.0, False)
        # sum(a) = 2 x the process normalisation integral, so the
        # complex path's 2 ratio2 norm / normalisation becomes 4 / sum(a)
        return 4.0 * ratio2 * ex(norm) / torch.sum(a, dim=-1)[..., None]
    return 4.0 * ratio2 * ex(norm)


# ---------------------------------------------------------------------------
# Complex path: the oracle
# ---------------------------------------------------------------------------


def roots2coeffs(r):
    """Coefficients (ascending powers, monic) of prod_k (x - r_k)
    (Polynomials.fromroots, reference src/CARMA.jl:185-188); complex128
    for complex128 or float64 roots, complex64 otherwise."""
    r = torch.as_tensor(r)
    cdt = torch.complex128 if r.dtype in (torch.complex128, torch.float64) else torch.complex64
    r = r.to(cdt)
    n = r.shape[0]
    c = torch.zeros(n + 1, dtype=cdt, device=r.device)
    c[0] = 1.0
    for k in range(n):
        # multiply c by (x - r_k): shift(c) - r_k c
        shifted = torch.cat([c.new_zeros(1), c[:-1]])
        c = shifted - r[k] * c
    return c


def quad2roots(quad):
    """Roots (complex128 on the CPU) from stacked quadratic coefficients
    (reference src/CARMA.jl:201-223).

    quad = [c1, b1, c2, b2, ..., (r_last)]: pairs (c, b) of monic
    quadratics x^2 + b x + c, plus a trailing real root -r when the
    length is odd. Host-side numpy, like the reference's prior sampling.
    """
    quad = np.asarray(quad)
    n = quad.shape[0]
    r = np.zeros(n, dtype=np.complex128)
    n_ = n - 1 if n % 2 == 1 else n
    if n % 2 == 1:
        r[-1] = -quad[-1]
    for k in range(0, n_, 2):
        c, b = quad[k], quad[k + 1]
        delta = b**2 - 4 * c
        if delta < 0:
            r[k] = (-b + 1j * np.sqrt(-delta)) / 2
            r[k + 1] = np.conj(r[k])
        else:
            r[k] = (-b + np.sqrt(delta)) / 2
            r[k + 1] = (-b - np.sqrt(delta)) / 2
    return torch.as_tensor(r)


def _beta_at(beta, r):
    """sum_i beta_i r^i and the same at -r, for one complex root r."""
    powers = torch.arange(beta.shape[0], device=beta.device)
    return torch.sum(beta * r**powers), torch.sum(beta * (-r) ** powers)


def carma_celerite_coefs(p: int, roots, beta, norm=1.0, is_integrated_power: bool = True):
    """CARMA -> celerite (a, b, c, d) by partial fractions, in complex
    arithmetic (reference src/CARMA.jl:98-143). ``roots`` (p,): conjugate
    pairs ordered pairwise, a real last root when p is odd."""
    roots, beta = torch.as_tensor(roots), _t(beta)
    J = p // 2 + (p % 2)

    a_list, b_list, c_list, d_list = [], [], [], []
    for k in range(J):
        rk = roots[2 * k]
        num1, num2 = _beta_at(beta, rk)
        frac = -num1 * num2 / torch.real(rk)
        for j in range(p):
            if j == 2 * k:
                continue
            rj = roots[j]
            frac = frac / ((rj - rk) * (torch.conj(rj) + rk))
        last_is_real = (p % 2 == 1) and (k == J - 1)
        if not last_is_real:
            a_list.append(2.0 * torch.real(frac))
            b_list.append(2.0 * torch.imag(frac))
            c_list.append(-torch.real(rk))
            d_list.append(-torch.imag(rk))
        else:
            a_list.append(torch.real(frac))
            b_list.append(torch.zeros_like(torch.real(frac)))
            c_list.append(-torch.real(rk))
            d_list.append(torch.zeros_like(torch.real(rk)))

    a, b, c, d = (torch.stack(v) for v in (a_list, b_list, c_list, d_list))
    variance = torch.sum(a)
    va = torch.as_tensor(norm, dtype=a.dtype, device=a.device)
    if is_integrated_power:
        va = va / variance
    return a * va, b * va, c, d


@dataclass(frozen=True)
class CARMA:
    """CARMA(p, q) kernel (reference src/CARMA.jl:19-42).

    ``roots``: the p AR roots (conjugate pairs; a real last root when p
    is odd), complex; ``beta``: the q + 1 MA coefficients; ``norm``: the
    normalisation (band power, or the variance with
    ``is_integrated_power=False``).
    """

    roots: torch.Tensor
    beta: torch.Tensor
    norm: torch.Tensor = 1.0
    p: int = 0
    q: int = 0
    is_integrated_power: bool = True

    def __post_init__(self):
        if self.p < 1 or self.q < 0:
            raise ValueError("p must be >= 1 and q >= 0")
        if self.q > self.p:
            raise ValueError("q must be <= p")

    @staticmethod
    def create(p, q, roots, beta, norm=1.0, is_integrated_power=True) -> "CARMA":
        roots = torch.as_tensor(roots)
        beta = torch.as_tensor(beta, dtype=DEFAULT_DTYPE, device=roots.device)
        if roots.shape[0] != p:
            raise ValueError("length of AR roots must equal p")
        if beta.shape[0] != q + 1:
            raise ValueError("length of beta must equal q + 1")
        return CARMA(roots=roots, beta=beta,
                     norm=torch.as_tensor(norm, dtype=DEFAULT_DTYPE, device=roots.device),
                     p=p, q=q, is_integrated_power=is_integrated_power)

    def celerite_coefficients(self):
        return carma_celerite_coefs(
            self.p, self.roots, self.beta, self.norm, self.is_integrated_power)

    def celerite(self) -> CeleriteKernel:
        """Celerite representation (reference src/CARMA.jl:56-71)."""
        return CeleriteKernel(*self.celerite_coefficients())

    def __call__(self, tau):
        return carma_covariance(tau, self)

    def psd(self, f):
        return carma_psd(f, self)


def _root_terms(model: CARMA):
    """Per root k: (r_k, num_k, den_k) of the partial-fraction sum."""
    roots = model.roots
    for k in range(model.p):
        rk = roots[k]
        num1, num2 = _beta_at(model.beta, rk)
        den = -2.0 * torch.real(rk)
        for j in range(model.p):
            if j == k:
                continue
            den = den * ((roots[j] - rk) * (torch.conj(roots[j]) + rk))
        yield rk, num1 * num2, den


def carma_covariance(tau, model: CARMA):
    """Analytic CARMA autocovariance (reference src/CARMA.jl:230-271)."""
    tau = torch.abs(_t(tau))
    R = torch.zeros(tau.shape, dtype=model.roots.dtype, device=tau.device)
    variance = torch.zeros((), dtype=model.roots.dtype, device=tau.device)
    for rk, num, den in _root_terms(model):
        R = R + num * torch.exp(rk * tau) / den
        variance = variance + num / den
    cov = torch.real(R) * model.norm
    if model.is_integrated_power:
        cov = cov / (2.0 * torch.real(variance))
    return 2.0 * cov


def carma_normalisation(model: CARMA):
    """Process variance of the unnormalised CARMA (reference src/CARMA.jl:279-304)."""
    variance = torch.zeros((), dtype=model.roots.dtype, device=model.roots.device)
    for _, num, den in _root_terms(model):
        variance = variance + num / den
    return torch.real(variance)


def carma_psd(f, model: CARMA):
    """CARMA PSD |B(2 pi i f)|^2 / |A(2 pi i f)|^2 (reference src/CARMA.jl:150-172)."""
    f = _t(f)
    wi = 2.0 * math.pi * f * 1j
    alpha = roots2coeffs(model.roots)
    num = torch.zeros(f.shape, dtype=alpha.dtype, device=f.device)
    den = torch.zeros(f.shape, dtype=alpha.dtype, device=f.device)
    for i in range(model.q + 1):
        num = num + model.beta[i] * wi**i
    for j in range(model.p + 1):
        den = den + alpha[j] * wi**j
    ratio2 = torch.abs(num / den) ** 2
    if model.is_integrated_power:
        return 2.0 * ratio2 * model.norm / carma_normalisation(model)
    return 4.0 * ratio2 * model.norm


def sample_quad(p: int, q: int, generator, f_min: float, f_max: float):
    """Valid quadratic coefficients for the CARMA priors: (qa (p,), qb (q,))
    numpy arrays of monic-quadratic coefficients whose roots are
    conjugate pairs within [f_min, f_max], ordered by imaginary part.

    Host-side numpy (reference src/CARMA.jl:328-407). ``generator`` is a
    ``torch.Generator``, from which one integer seeds numpy's generator,
    or that integer itself.
    """
    if isinstance(generator, torch.Generator):
        generator = int(torch.randint(0, 2**31 - 1, (), generator=generator,
                                      device=generator.device))
    rng = np.random.default_rng(int(generator))

    def log_uniform(lo, hi):
        return float(np.exp(rng.uniform(np.log(lo), np.log(hi))))

    def fill(n):
        qv = np.zeros(n)
        n_ = n - 1 if n % 2 == 1 else n
        if n % 2 == 1:
            qv[-1] = log_uniform(f_min, f_max)
        for i in range(1, n_, 2):
            qv[i] = log_uniform(2 * f_min, 2 * f_max)
        buff = 0.0
        for j, i in enumerate(range(0, n_ - 1, 2)):
            if j == 0:
                buff = qv[i + 1] ** 2 / 4
                qv[i] = log_uniform(f_min, f_max) + buff
            else:
                start_log = qv[i - 2] - buff
                buff = qv[i + 1] ** 2 / 4
                qv[i] = log_uniform(start_log, f_max) + buff
        return qv

    return fill(p), fill(q)
