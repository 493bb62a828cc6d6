"""Plain reference of the celerite GP models that the benchmark holds the
program's answers against: the PSD -> celerite approximation (the J x J
basis solve) and the O(N J^2) celerite likelihood, written as straight
PyTorch loops and differentiated by autograd. It imports nothing of the
program and takes nothing the program made: it builds its own data, grid
and matrix from the raw light curve and the configuration.

A configuration names the module of its model, ``reference/<name>.py``,
which defines ``Model`` (a subclass of :class:`ApproxCelerite` with the
model's PSD, prior and parameter columns) and ``rows`` (the parameter
rows the traffic draws). Each function is a frozen copy of the formula
it names, with the source ``file:line`` in its comment. ``dtype`` is the
precision it computes in: float64 for the reference. The control
computes in float32 with every matrix and vector product in TF32
(``tf32=True``): both factors of each product rounded to TF32's 10-bit
mantissa, the sums in float32, as the card's tensor cores do when TF32
is allowed. The configurations state float32 with TF32 off, and the
program forbids TF32, so TF32 is the step below it that a later change
could take.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

_SQRT2 = 1.4142135623730951
_SQRT3 = 1.7320508075688772
LOG2PI = math.log(2.0 * math.pi)


def round_tf32(x):
    """``x`` (float32) rounded to TF32: 10 mantissa bits, to nearest (ties
    away from zero), as a float32 tensor."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _identity(x):
    return x


def log_sig_pair(z):
    # pioran_tpu_torch/priors.py:50 (log_sig_pair)
    return F.logsigmoid(z) + F.logsigmoid(-z)


def gamma_logpdf(x, k, th):
    # pioran_tpu_torch/priors.py:212 (Gamma.logpdf)
    lp = (k - 1.0) * torch.log(x) - x / th - math.lgamma(k) - k * math.log(th)
    return torch.where(x > 0, lp, torch.full_like(lp, -math.inf))


def lognormal_logpdf(x, mu, sigma):
    # pioran_tpu_torch/priors.py:164 (LogNormal.logpdf)
    lx = torch.log(x)
    zz = (lx - mu) / sigma
    lp = -0.5 * zz**2 - lx - math.log(sigma) - 0.5 * LOG2PI
    return torch.where(x > 0, lp, torch.full_like(lp, -math.inf))


def _integral_sho(a, c, x):
    # pioran_tpu_torch/ops/approx.py:130 (integral_sho)
    norm = c * a / (4.0 * _SQRT2)
    poly = (x**2 + _SQRT2 * c * x + c**2) / (x**2 - _SQRT2 * c * x + c**2)
    return torch.sum(norm * (torch.log(poly) + 2.0 * torch.atan2(c * _SQRT2 * x, c**2 - x**2)),
                     dim=-1)


def _integral_drwcelerite(a, c, x):
    # pioran_tpu_torch/ops/approx.py:140 (integral_drwcelerite)
    norm = a * c / 3.0
    drw = torch.atan(x / c)
    poly = (x**2 + _SQRT3 * c * x + c**2) / (x**2 - _SQRT3 * c * x + c**2)
    cel = 0.5 * torch.atan2(x**2 - c**2, c * x) + _SQRT3 / 4.0 * torch.log(poly)
    return torch.sum(norm * (drw + cel), dim=-1)


class ApproxCelerite:
    """A GP whose PSD is approximated by ``n_components`` celerite basis
    functions, on one light curve, in ``dtype`` on ``device``. A model
    subclass gives ``psd(points, TH)`` (B, J) and the columns of theta
    that hold the variance, the noise scale nu and the mean mu; the data
    are log-transformed with sigma^2 = nu yerr^2 / y^2
    (pioran_tpu_torch/inference.py:257, single_bending_model, and the
    builders after it)."""

    VAR, NU, MU = 3, 4, 5

    def __init__(self, t, y, yerr, xbar, va, n_components=20, basis_function="SHO",
                 S_low=20.0, S_high=20.0, dtype=torch.float64, device="cpu", tf32=False):
        t, y, yerr = (np.asarray(v, np.float64) for v in (t, y, yerr))
        if tf32 and dtype != torch.float32:
            raise ValueError("TF32 products need dtype=float32")
        self.dtype, self.device = dtype, torch.device(device)
        self.rnd = round_tf32 if tf32 else _identity
        self.basis = basis_function
        self.n_components = n_components
        # inference.py:184 (_freq_range), on the float64 times
        self.f_min = 1.0 / (t[-1] - t[0])
        self.f_max = 1.0 / float(np.min(np.diff(t))) / 2.0
        self.f_lo_b, self.f_hi_b = self.f_min / 20.0 * 4.0, self.f_max * 20.0 / 4.0
        self.mu0, self.mu_sd = float(xbar), 5.0 * math.sqrt(va)
        as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=self.device)  # noqa: E731
        self.t = as_t(t)
        self.dt = as_t(np.diff(t))
        self.logy = as_t(np.log(y))
        self.e2y2 = as_t(yerr**2 / y**2)
        # approx.py:45 (spectral_grid), :63 (spectral_matrix), in float64
        f0, fM = self.f_min / S_low, self.f_max * S_high
        J = n_components
        pts = f0 * (fM / f0) ** (np.arange(J, dtype=np.float64) / (J - 1))
        p = 4 if basis_function == "SHO" else 6
        self.points = as_t(pts)
        self.matrix = torch.as_tensor(1.0 / (1.0 + (pts[:, None] / pts[None, :]) ** p),
                                      dtype=torch.float64, device=self.device)

    @property
    def terms(self) -> int:
        return self.n_components * (2 if self.basis == "DRWCelerite" else 1)

    def psd(self, points, TH):
        """(B, J) the model's PSD at ``points`` for the rows of theta."""
        raise NotImplementedError

    # -- approximation (approx.py:207, approx; is_integrated_power=True)
    def coefficients(self, TH) -> Tuple[torch.Tensor, ...]:
        var = TH[:, self.VAR]
        pts = self.points
        pp = self.psd(pts, TH)                            # (B, J)
        rhs = (pp / pp[:, :1]).T
        solve_dtype = torch.float64 if self.dtype == torch.float64 else torch.float32
        amp = torch.linalg.solve(self.rnd(self.matrix.to(solve_dtype)),
                                 self.rnd(rhs.to(solve_dtype)))
        amp = amp.T.to(self.dtype)
        ptsb = pts.expand_as(amp)
        lo, hi = self.f_min, self.f_max
        if self.basis == "SHO":
            integ = _integral_sho(amp, ptsb, hi) - _integral_sho(amp, ptsb, lo)
        else:
            integ = _integral_drwcelerite(amp, ptsb, hi) - _integral_drwcelerite(amp, ptsb, lo)
        amp = amp * (var / integ)[:, None]
        if self.basis == "SHO":
            a = amp * ptsb * math.pi / _SQRT2
            c = _SQRT2 * math.pi * ptsb
            return a, a, c, c
        a = amp * ptsb * math.pi / 3.0
        b = _SQRT3 * a
        c = math.pi * ptsb
        d = _SQRT3 * c
        z = torch.zeros_like(a)
        return (torch.cat([a, a], 1), torch.cat([b, z], 1), torch.cat([c, 2.0 * c], 1),
                torch.cat([d, z], 1))

    def loglike(self, TH):
        a, b, c, d = self.coefficients(TH)
        y = self.logy[None, :] - TH[:, self.MU:self.MU + 1]
        s2 = TH[:, self.NU:self.NU + 1] * self.e2y2[None, :]
        return celerite_loglike(a, b, c, d, self.t, self.dt, y, s2, self.rnd)


def celerite_loglike(a, b, c, d, t, dt, y, s2, rnd=_identity):
    """(B,) celerite log-likelihoods: the LDL^T factor scan and the forward
    substitution over N, as ops/celerite.py:124 (_factor) and :147
    (_forward_sub) with the log-likelihood of :235 (_logl_from_solve):
    -1/2 (sum log D_n + sum zp_n^2 / D_n + N log 2 pi); -inf unless every
    D_n > 0. a..d (B, J); t (N,); dt (N-1,); y, s2 (B, N). ``rnd`` rounds
    the factors of each matrix and vector product (the control's TF32)."""
    B, J = a.shape
    N = t.shape[0]
    suma = torch.sum(a, dim=1)
    S = a.new_zeros(B, 2 * J, 2 * J)
    W = a.new_zeros(B, 2 * J)
    f = a.new_zeros(B, 2 * J)
    Dp = a.new_ones(B)
    zpp = a.new_zeros(B)
    logdet = a.new_zeros(B)
    quad = a.new_zeros(B)
    ok = torch.ones(B, dtype=torch.bool, device=a.device)
    for n in range(N):
        co, si = torch.cos(d * t[n]), torch.sin(d * t[n])
        U = torch.cat([a * co + b * si, a * si - b * co], 1)
        V = torch.cat([co, si], 1)
        if n == 0:
            Dn = suma + s2[:, 0]
            zpn = y[:, 0]
        else:
            ec = torch.exp(-c * dt[n - 1])
            ph = torch.cat([ec, ec], 1)
            S = (ph[:, :, None] * ph[:, None, :]) * (S + Dp[:, None, None] * W[:, :, None] * W[:, None, :])
            f = ph * (f + W * zpp[:, None])
        Ur = rnd(U)
        SU = torch.bmm(rnd(S), Ur[:, :, None])[..., 0]
        if n > 0:
            Dn = suma + s2[:, n] - torch.sum(Ur * rnd(SU), 1)
            zpn = y[:, n] - torch.sum(Ur * rnd(f), 1)
        W = (V - SU) / Dn[:, None]
        ok = ok & (Dn > 0)
        logdet = logdet + torch.log(torch.abs(Dn))
        quad = quad + zpn * zpn / Dn
        Dp, zpp = Dn, zpn
    ll = -0.5 * (logdet + quad + N * LOG2PI)
    ok = ok & torch.isfinite(ll)
    return torch.where(ok, ll, torch.full_like(ll, -math.inf))


def values(fn, X, block: int):
    """``fn`` over the rows of X in blocks, without a gradient: (B,)."""
    with torch.no_grad():
        return torch.cat([fn(X[i:i + block]) for i in range(0, X.shape[0], block)])


def values_and_grads(fn, X, block: int):
    """(fn(X) (B,), d fn / d X (B, dim)) over the rows of X in blocks, by
    autograd of each block's sum (the rows do not interact)."""
    vals, grads = [], []
    for i in range(0, X.shape[0], block):
        x = X[i:i + block].detach().requires_grad_(True)
        with torch.enable_grad():
            v = fn(x)
            (g,) = torch.autograd.grad(torch.where(torch.isfinite(v), v, torch.zeros_like(v)).sum(), x)
        vals.append(v.detach())
        grads.append(g)
    return torch.cat(vals), torch.cat(grads)
