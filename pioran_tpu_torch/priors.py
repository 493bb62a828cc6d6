"""Prior distributions, PyTorch port of ``pioran_tpu.priors``.

Each distribution provides, batched over leading (row) axes:

- ``logpdf(x)``
- ``sample(shape, generator)``
- ``quantile(u)``: the nested-sampling unit-cube transform
- ``to_unconstrained(x)`` / ``from_unconstrained(z)`` /
  ``unconstrained_logpdf(z)``: the bijector view for gradient samplers

Fields are Python floats or scalar tensors; every method takes its
dtype and device from its input tensor. Includes the reference's
dependent priors for ordered parameters and :class:`PriorSet`, which
flattens a named collection into one parameter vector.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "Uniform",
    "LogUniform",
    "Normal",
    "LogNormal",
    "Gamma",
    "TwoUniformDependent",
    "ThreeUniformDependent",
    "TwoLogUniformDependent",
    "PriorSet",
]

_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


def _p(v, like: torch.Tensor) -> torch.Tensor:
    """A distribution field as a tensor in ``like``'s dtype and device."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _logit(p):
    return torch.log(p) - torch.log1p(-p)


def _log_sig_pair(z):
    """log sigmoid(z) + log sigmoid(-z): the log-Jacobian of a logit
    bijection with the interval's width cancelled analytically."""
    return F.logsigmoid(z) + F.logsigmoid(-z)


def _neg_inf(x):
    return torch.full_like(x, -math.inf)


def _uniform(shape, generator, dtype, device):
    return torch.rand(shape, generator=generator, dtype=dtype, device=device)


class Distribution:
    dim: int = 1

    def logpdf(self, x):  # pragma: no cover - abstract
        raise NotImplementedError

    def quantile(self, u):  # pragma: no cover - abstract
        raise NotImplementedError

    def sample(self, shape, generator=None, dtype=torch.float64, device=None):
        """Draws of shape ``shape`` (+ ``(dim,)`` when dim > 1) by
        inverse-transform sampling."""
        ushape = tuple(shape) + ((self.dim,) if self.dim > 1 else ())
        return self.quantile(_uniform(ushape, generator, dtype, device))

    # bijector view (default: identity for R-supported)
    def to_unconstrained(self, x):
        return x

    def from_unconstrained(self, z):
        return z

    def unconstrained_logpdf(self, z):
        """log density of the pushforward in unconstrained space."""
        return self.logpdf(self.from_unconstrained(z))


@dataclass(frozen=True)
class Uniform(Distribution):
    low: float
    high: float

    def logpdf(self, x):
        lo, hi = _p(self.low, x), _p(self.high, x)
        inside = (x >= lo) & (x <= hi)
        return torch.where(inside, -torch.log(hi - lo), _neg_inf(x))

    def quantile(self, u):
        lo, hi = _p(self.low, u), _p(self.high, u)
        return lo + (hi - lo) * u

    def to_unconstrained(self, x):
        lo, hi = _p(self.low, x), _p(self.high, x)
        return _logit((x - lo) / (hi - lo))

    def from_unconstrained(self, z):
        lo, hi = _p(self.low, z), _p(self.high, z)
        return lo + (hi - lo) * torch.sigmoid(z)

    def unconstrained_logpdf(self, z):
        return _log_sig_pair(z)


@dataclass(frozen=True)
class LogUniform(Distribution):
    """Reciprocal distribution on [low, high] (log-uniform)."""

    low: float
    high: float

    def logpdf(self, x):
        lo, hi = _p(self.low, x), _p(self.high, x)
        inside = (x >= lo) & (x <= hi)
        lognorm = torch.log(torch.log(hi) - torch.log(lo))
        return torch.where(inside, -torch.log(x) - lognorm, _neg_inf(x))

    def quantile(self, u):
        la, lb = torch.log(_p(self.low, u)), torch.log(_p(self.high, u))
        return torch.exp(la + u * (lb - la))

    def to_unconstrained(self, x):
        la, lb = torch.log(_p(self.low, x)), torch.log(_p(self.high, x))
        return _logit((torch.log(x) - la) / (lb - la))

    def from_unconstrained(self, z):
        return self.quantile(torch.sigmoid(z))

    def unconstrained_logpdf(self, z):
        return _log_sig_pair(z)


@dataclass(frozen=True)
class Normal(Distribution):
    loc: float
    scale: float

    def logpdf(self, x):
        loc, scale = _p(self.loc, x), _p(self.scale, x)
        zz = (x - loc) / scale
        return -0.5 * zz**2 - torch.log(scale) - _HALF_LOG_2PI

    def quantile(self, u):
        return _p(self.loc, u) + _p(self.scale, u) * torch.special.ndtri(u)


@dataclass(frozen=True)
class LogNormal(Distribution):
    mu: float
    sigma: float

    def logpdf(self, x):
        mu, sigma = _p(self.mu, x), _p(self.sigma, x)
        lx = torch.log(x)
        zz = (lx - mu) / sigma
        lp = -0.5 * zz**2 - lx - torch.log(sigma) - _HALF_LOG_2PI
        return torch.where(x > 0, lp, _neg_inf(x))

    def quantile(self, u):
        return torch.exp(_p(self.mu, u) + _p(self.sigma, u) * torch.special.ndtri(u))

    def to_unconstrained(self, x):
        return torch.log(x)

    def from_unconstrained(self, z):
        return torch.exp(z)

    def unconstrained_logpdf(self, z):
        return self.logpdf(torch.exp(z)) + z


def _gammaincinv(a, p, num_bisect: int = 80):
    """Inverse regularised lower incomplete gamma, batched over ``p``.

    Bisection of gammainc(a, x) = p on [0, hi]: each row's ``hi`` doubles
    until it brackets that row's root (the loop runs until every row is
    bracketed), then 80 halvings localise the root to ~1e-16 relative.
    """
    a = _p(a, p).expand_as(p)
    hi = a + 40.0 * torch.sqrt(a) + 40.0
    below = torch.special.gammainc(a, hi) < p
    while bool(torch.any(below)):  # rarely entered: hi0 ~ mean + 40 sd
        hi = torch.where(below, hi * 2.0, hi)
        below = torch.special.gammainc(a, hi) < p
    lo = torch.zeros_like(hi)
    for _ in range(num_bisect):
        mid = 0.5 * (lo + hi)
        below = torch.special.gammainc(a, mid) < p
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


@dataclass(frozen=True)
class Gamma(Distribution):
    """Gamma(shape k, scale theta)."""

    shape: float
    scale: float

    def logpdf(self, x):
        k, th = _p(self.shape, x), _p(self.scale, x)
        lp = (k - 1.0) * torch.log(x) - x / th - torch.lgamma(k) - k * torch.log(th)
        return torch.where(x > 0, lp, _neg_inf(x))

    def quantile(self, u):
        return _gammaincinv(self.shape, u) * _p(self.scale, u)

    def to_unconstrained(self, x):
        return torch.log(x)

    def from_unconstrained(self, z):
        return torch.exp(z)

    def unconstrained_logpdf(self, z):
        return self.logpdf(torch.exp(z)) + z


# ---------------------------------------------------------------------------
# Dependent (ordered) priors
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TwoUniformDependent(Distribution):
    """x1 ~ U[a, b]; x2 ~ U[x1, c]."""

    a: float
    b: float
    c: float

    dim = 2

    def logpdf(self, x):
        x1, x2 = x[..., 0], x[..., 1]
        c = _p(self.c, x)
        lp1 = Uniform(self.a, self.b).logpdf(x1)
        lp2 = torch.where((x2 >= x1) & (x2 <= c), -torch.log(c - x1), _neg_inf(x1))
        return lp1 + lp2

    def quantile(self, u):
        a, b, c = (_p(v, u) for v in (self.a, self.b, self.c))
        x1 = a + (b - a) * u[..., 0]
        x2 = x1 + (c - x1) * u[..., 1]
        return torch.stack([x1, x2], dim=-1)

    def to_unconstrained(self, x):
        a, b, c = (_p(v, x) for v in (self.a, self.b, self.c))
        x1, x2 = x[..., 0], x[..., 1]
        return torch.stack([_logit((x1 - a) / (b - a)),
                            _logit((x2 - x1) / (c - x1))], dim=-1)

    def from_unconstrained(self, z):
        a, b, c = (_p(v, z) for v in (self.a, self.b, self.c))
        x1 = a + (b - a) * torch.sigmoid(z[..., 0])
        x2 = x1 + (c - x1) * torch.sigmoid(z[..., 1])
        return torch.stack([x1, x2], dim=-1)

    def unconstrained_logpdf(self, z):
        return torch.sum(_log_sig_pair(z), dim=-1)


@dataclass(frozen=True)
class ThreeUniformDependent(Distribution):
    """x1 ~ U[a,b]; x2 ~ U[x1, c]; x3 ~ U[x2, c]."""

    a: float
    b: float
    c: float

    dim = 3

    def logpdf(self, x):
        x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2]
        c = _p(self.c, x)
        lp1 = Uniform(self.a, self.b).logpdf(x1)
        lp2 = torch.where((x2 >= x1) & (x2 <= c), -torch.log(c - x1), _neg_inf(x1))
        lp3 = torch.where((x3 >= x2) & (x3 <= c), -torch.log(c - x2), _neg_inf(x1))
        return lp1 + lp2 + lp3

    def quantile(self, u):
        a, b, c = (_p(v, u) for v in (self.a, self.b, self.c))
        x1 = a + (b - a) * u[..., 0]
        x2 = x1 + (c - x1) * u[..., 1]
        x3 = x2 + (c - x2) * u[..., 2]
        return torch.stack([x1, x2, x3], dim=-1)

    def to_unconstrained(self, x):
        a, b, c = (_p(v, x) for v in (self.a, self.b, self.c))
        x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2]
        return torch.stack([_logit((x1 - a) / (b - a)),
                            _logit((x2 - x1) / (c - x1)),
                            _logit((x3 - x2) / (c - x2))], dim=-1)

    def from_unconstrained(self, z):
        a, b, c = (_p(v, z) for v in (self.a, self.b, self.c))
        x1 = a + (b - a) * torch.sigmoid(z[..., 0])
        x2 = x1 + (c - x1) * torch.sigmoid(z[..., 1])
        x3 = x2 + (c - x2) * torch.sigmoid(z[..., 2])
        return torch.stack([x1, x2, x3], dim=-1)

    def unconstrained_logpdf(self, z):
        return torch.sum(_log_sig_pair(z), dim=-1)


@dataclass(frozen=True)
class TwoLogUniformDependent(Distribution):
    """x1 ~ logU[a,b]; x2 ~ logU[x1, b]."""

    a: float
    b: float

    dim = 2

    def logpdf(self, x):
        x1, x2 = x[..., 0], x[..., 1]
        b = _p(self.b, x)
        lp1 = LogUniform(self.a, self.b).logpdf(x1)
        inside = (x2 >= x1) & (x2 <= b)
        lp2 = torch.where(
            inside, -torch.log(x2) - torch.log(torch.log(b) - torch.log(x1)),
            _neg_inf(x1))
        return lp1 + lp2

    def quantile(self, u):
        la, lb = torch.log(_p(self.a, u)), torch.log(_p(self.b, u))
        lx1 = la + u[..., 0] * (lb - la)
        lx2 = lx1 + u[..., 1] * (lb - lx1)
        return torch.exp(torch.stack([lx1, lx2], dim=-1))

    def to_unconstrained(self, x):
        la, lb = torch.log(_p(self.a, x)), torch.log(_p(self.b, x))
        lx1, lx2 = torch.log(x[..., 0]), torch.log(x[..., 1])
        return torch.stack([_logit((lx1 - la) / (lb - la)),
                            _logit((lx2 - lx1) / (lb - lx1))], dim=-1)

    def from_unconstrained(self, z):
        la, lb = torch.log(_p(self.a, z)), torch.log(_p(self.b, z))
        lx1 = la + (lb - la) * torch.sigmoid(z[..., 0])
        lx2 = lx1 + (lb - lx1) * torch.sigmoid(z[..., 1])
        return torch.exp(torch.stack([lx1, lx2], dim=-1))

    def unconstrained_logpdf(self, z):
        return torch.sum(_log_sig_pair(z), dim=-1)


class PriorSet:
    """An ordered, named collection of priors flattened to one vector.

    Every method works on rows: ``transform(U)`` maps ``(..., dim)``
    unit-cube points to ``(..., dim)`` parameters (the nested-sampling
    prior transform), ``logpdf`` returns ``(...,)``.
    """

    def __init__(self, items: Sequence[Tuple[str, Distribution]]):
        self.names: Tuple[str, ...] = tuple(n for n, _ in items)
        self.dists: Tuple[Distribution, ...] = tuple(d for _, d in items)

    @property
    def dim(self) -> int:
        return sum(d.dim for d in self.dists)

    def _split(self, x):
        out, i = [], 0
        for d in self.dists:
            k = d.dim
            out.append(x[..., i] if k == 1 else x[..., i:i + k])
            i += k
        return out

    def _join(self, vals):
        return torch.cat([v[..., None] if d.dim == 1 else v
                          for d, v in zip(self.dists, vals)], dim=-1)

    def logpdf(self, theta):
        return sum(d.logpdf(p) for d, p in zip(self.dists, self._split(theta)))

    def sample(self, shape=(), generator=None, dtype=torch.float64, device=None):
        """Draws of shape ``shape + (dim,)`` by inverse transform of one
        uniform block."""
        u = _uniform(tuple(shape) + (self.dim,), generator, dtype, device)
        return self.transform(u)

    def transform(self, u):
        """Unit-cube -> parameter vector (nested-sampling prior transform)."""
        return self._join([d.quantile(p) for d, p in zip(self.dists, self._split(u))])

    def to_unconstrained(self, theta):
        return self._join([d.to_unconstrained(p)
                           for d, p in zip(self.dists, self._split(theta))])

    def from_unconstrained(self, z):
        return self._join([d.from_unconstrained(p)
                           for d, p in zip(self.dists, self._split(z))])

    def unconstrained_logpdf(self, z):
        return sum(d.unconstrained_logpdf(p)
                   for d, p in zip(self.dists, self._split(z)))
