"""Means of the scalable Gaussian process, PyTorch port of the mean part of
``pioran_tpu.models.gp``.

A mean is a scalar or tensor (a constant mean) or any callable
``t -> mean``, the reference's ``CustomMean`` (reference
test/test_mean.jl:21-28). A callable may return a batch of means, one
row per chain: ``(B, N)`` on an ``(N,)`` grid. The GP objects of the JAX
module (conditioning, posterior, sampling) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

__all__ = ["CustomMean"]


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
