"""CARMA root-validity predicates, PyTorch port of ``pioran_tpu.utils.roots``
(reference src/utils.jl:154-211).

Two flavours: host-side numpy checks of one root vector (exact, for
prior construction and tests) and :func:`roots_valid_batch`, a batched
predicate on complex tensors ``(..., p)`` returning ``(...)`` booleans,
for rejecting rows with ``torch.where(ok, logp, -inf)``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "check_conjugate_pair",
    "check_roots_bounds",
    "check_order_imag_roots",
    "roots_valid_batch",
]


def check_conjugate_pair(r) -> bool:
    """All real parts non-positive and the roots form conjugate pairs
    (reference utils.jl:160-180)."""
    r = np.asarray(r)
    if np.any(np.real(r) > 0):
        return False
    n = len(r)
    n_ = n if n % 2 == 0 else n - 1
    for i in range(0, n_, 2):
        if r[i] != np.conj(r[i + 1]):
            return False
    return True


def check_roots_bounds(r, f_min: float, f_max: float) -> bool:
    """Roots within the frequency bounds (reference utils.jl:187-192)."""
    r = np.asarray(r)
    return bool(
        np.all((-f_max < np.real(r)) & (np.real(r) < -f_min))
        and np.all((-f_max < np.imag(r)) & (np.imag(r) < f_max))
    )


def check_order_imag_roots(r) -> bool:
    """Imaginary parts of the pair leaders ascending (reference utils.jl:199-210)."""
    r = np.asarray(r)
    n = len(r)
    n_ = n if n % 2 == 0 else n - 1
    lead = np.imag(r[0:n_:2])
    return bool(np.all(np.argsort(lead, kind="stable") == np.arange(len(lead))))


def roots_valid_batch(r, f_min: float, f_max: float) -> torch.Tensor:
    """The four checks above on every row of ``r`` (..., p), complex (a
    real tensor counts as roots with zero imaginary parts): real parts
    negative, pairs conjugate, roots in the band, pair leaders ordered by
    imaginary part. Returns a boolean tensor of shape ``r.shape[:-1]``."""
    r = torch.as_tensor(r)
    if not r.is_complex():
        r = torch.complex(r, torch.zeros_like(r))
    re, im = r.real, r.imag
    n = r.shape[-1]
    n_ = n - (n % 2)
    neg_real = torch.all(re < 0, dim=-1)
    pairs_ok = torch.all(r[..., 0:n_:2] == torch.conj(r[..., 1:n_:2]), dim=-1)
    in_bounds = torch.all((-f_max < re) & (re < -f_min) & (-f_max < im) & (im < f_max), dim=-1)
    ok = neg_real & pairs_ok & in_bounds
    if n_ >= 4:
        ok = ok & torch.all(torch.diff(im[..., 0:n_:2], dim=-1) >= 0, dim=-1)
    return ok
