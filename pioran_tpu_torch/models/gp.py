"""The scalable Gaussian-process API, PyTorch port of ``pioran_tpu.models.gp``
(reference src/scalable_GP.jl).

A :class:`GaussianProcess` is a celerite kernel and a mean; conditioning
it on inputs gives a :class:`ConditionedGP`; :func:`posterior` gives a
:class:`PosteriorGP`. They are frozen dataclasses over tensors, and a
kernel with ``(B, J)`` coefficients makes B GPs at once: every method
then returns one result per row, where the JAX package maps a one-GP
function over the rows. Times are ``(N,)``; ``y`` and noise variances
``(..., N)``.

A mean is a scalar or tensor (a constant mean: one per GP is ``(B, 1)``)
or any callable ``t -> mean``, the reference's ``CustomMean`` (reference
test/test_mean.jl:21-28). A callable may return a batch of means, one
row per GP: ``(B, N)`` on an ``(N,)`` grid.

On CUDA tensors ``logpdf`` runs the hand-written kernel K1 (K3/K4 when
an input requires a gradient) and the posterior mean's solve runs
K3/K4; on CPU tensors their plain versions run
(``ops.celerite.log_likelihood``, ``ops.celerite._solve``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Union

import torch

from ..ops import celerite as _cel
from ..ops import direct as _direct
from .kernels import CeleriteKernel

__all__ = [
    "CustomMean",
    "GaussianProcess",
    "ScalableGP",
    "ConditionedGP",
    "PosteriorGP",
    "posterior",
]


@dataclass(frozen=True)
class CustomMean:
    """Wrap an arbitrary mean function m(t) (reference CustomMean,
    re-exported at src/Pioran.jl and used in test/test_mean.jl:21)."""

    fn: Callable[[torch.Tensor], torch.Tensor]

    def __call__(self, t):
        return self.fn(t)


def _mean_vector(mean, t):
    """The mean on the grid ``t`` (N,): ``mean(t)`` for a callable, the
    constant otherwise, broadcast to (..., N)."""
    m = mean(t) if callable(mean) else torch.as_tensor(mean, dtype=t.dtype, device=t.device)
    return m.expand(torch.broadcast_shapes(m.shape, t.shape))


@dataclass(frozen=True)
class GaussianProcess:
    """GP with a semiseparable (celerite) kernel and a constant or
    callable mean (reference src/scalable_GP.jl:24-40)."""

    kernel: CeleriteKernel
    mean: Any = 0.0

    def __call__(self, t, sigma2=None) -> "ConditionedGP":
        """Condition on times ``t`` (N,) and per-point noise variances
        ``sigma2`` (..., N) (zero when omitted), like the reference's
        ``f(t, sigma^2)`` FiniteGP (scalable_GP.jl:42)."""
        if sigma2 is None:
            sigma2 = torch.zeros_like(t)
        else:
            sigma2 = torch.as_tensor(sigma2, dtype=t.dtype, device=t.device)
            sigma2 = sigma2.expand(torch.broadcast_shapes(sigma2.shape, t.shape))
        return ConditionedGP(gp=self, t=t, sigma2=sigma2)


def ScalableGP(mean_or_kernel, kernel: Union[CeleriteKernel, None] = None) -> GaussianProcess:
    """Constructor-name parity helper: ScalableGP(kernel) / ScalableGP(mean, kernel)."""
    if kernel is None:
        return GaussianProcess(kernel=mean_or_kernel, mean=0.0)
    return GaussianProcess(kernel=kernel, mean=mean_or_kernel)


@dataclass(frozen=True)
class ConditionedGP:
    """GP fixed at inputs ``t`` (N,) with noise variances ``sigma2``
    (..., N) (a FiniteGP)."""

    gp: GaussianProcess
    t: torch.Tensor
    sigma2: torch.Tensor

    def _resid(self, y):
        return y - _mean_vector(self.gp.mean, self.t)

    def logpdf(self, y):
        """log p(y), (...,), by the O(N) celerite likelihood
        (reference scalable_GP.jl:162-166); -inf where the factorisation
        is not positive definite."""
        return _cel.log_likelihood(self.gp.kernel, self.t, self._resid(y), self.sigma2)

    def logpdf_direct(self, y):
        """log p(y) by the dense oracle (the reference's direct solver
        returns the negative log-likelihood; this returns the positive)."""
        return -_direct.log_likelihood_direct(self.gp.kernel, self.t, self._resid(y),
                                              self.sigma2)

    def sample(self, generator, t=None):
        """Prior draws (..., N) in O(N R) (reference scalable_GP.jl:134-155),
        from the ``torch.Generator`` ``generator``.

        With ``t`` given, draws at those points with zero noise (like the
        reference's rand(f, t)); otherwise at the conditioning points with
        the conditioning noise.
        """
        if t is None:
            t, s2 = self.t, self.sigma2
        else:
            s2 = torch.zeros_like(t)
        draw = _cel.simulate(generator, self.gp.kernel, t, s2)
        return draw + _mean_vector(self.gp.mean, t)


def posterior(fx: ConditionedGP, y) -> "PosteriorGP":
    """Lazy posterior object (reference scalable_GP.jl:44-54)."""
    return PosteriorGP(fx=fx, y=torch.as_tensor(y, dtype=fx.t.dtype, device=fx.t.device))


@dataclass(frozen=True)
class PosteriorGP:
    """Posterior GP given (fx, y); its mean is O(N + M), its covariance
    dense O(N^3) (only for plot-sized target grids, as in the reference:
    docs/src/simulations.md:76-91). Target points ``tau`` are (M,),
    sorted for ``mean(method="scan")``; the conditioning times when
    omitted."""

    fx: ConditionedGP
    y: torch.Tensor

    def mean(self, tau=None, method: str = "matmul"):
        """Posterior mean (..., M): ``"matmul"`` (the solve, then the
        cross-covariance product) or ``"scan"`` (the O((N + M) R)
        sweeps). NaN on GPs whose log-likelihood is -inf."""
        fns = {"matmul": _cel.predict_matmul, "scan": _cel.predict}
        if method not in fns:
            raise ValueError(f"method must be 'matmul' or 'scan', got {method!r}")
        tau = self.fx.t if tau is None else tau
        fx = self.fx
        mu = fns[method](fx.gp.kernel, tau, fx.t, fx._resid(self.y), fx.sigma2)
        return mu + _mean_vector(fx.gp.mean, tau)

    def cov(self, tau=None):
        """Posterior covariance (..., M, M) by dense Cholesky."""
        tau = self.fx.t if tau is None else tau
        return _direct.predict_cov_direct(self.fx.gp.kernel, tau, self.fx.t, self.fx.sigma2)

    def std(self, tau=None):
        return torch.sqrt(torch.diagonal(self.cov(tau), dim1=-2, dim2=-1))

    def _sample_from_normals(self, eps, tau=None):
        """:meth:`sample` with its standard normals ``eps``
        (..., num_samples, M) given."""
        tau = self.fx.t if tau is None else tau
        mu = self.mean(tau)
        cov = self.cov(tau)
        M = tau.shape[0]
        jitter = 1e-12 * torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1) / M
        eye = torch.eye(M, dtype=cov.dtype, device=cov.device)
        L = torch.linalg.cholesky(cov + jitter[..., None, None] * eye)
        return mu[..., None, :] + eps @ L.mT

    def sample(self, generator, tau=None, num_samples: int = 1):
        """Dense multivariate-normal posterior draws (..., num_samples, M)
        (reference scalable_GP.jl:106-131), from the ``torch.Generator``
        ``generator``; the covariance gets a jitter of 1e-12 trace / M."""
        tau = self.fx.t if tau is None else tau
        fx = self.fx
        shape = torch.broadcast_shapes(fx.gp.kernel.a.shape[:-1], self.y.shape[:-1],
                                       fx.sigma2.shape[:-1],
                                       _mean_vector(fx.gp.mean, tau).shape[:-1])
        eps = torch.randn(shape + (num_samples, tau.shape[0]), generator=generator,
                          dtype=tau.dtype, device=tau.device)
        return self._sample_from_normals(eps, tau)
