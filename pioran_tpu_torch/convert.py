"""Carry parameters and sampler state across from numpy.

The port's tests feed the JAX package and this one the same inputs:
the JAX side's prior sets, sampler states and kernel coefficients are
converted to numpy there and rebuilt here with these helpers.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence, Tuple

import numpy as np
import torch

from . import priors
from .config import DEFAULT_DTYPE, resolve_device
from .models.kernels import CeleriteKernel

__all__ = ["prior_set_from_numpy", "ns_state_from_numpy", "coefficients_from_numpy"]


def prior_set_from_numpy(
        items: Iterable[Tuple[str, str, Mapping[str, np.ndarray]]]) -> priors.PriorSet:
    """A PriorSet from ``(name, distribution class name, {field: value})``
    items; each value is a scalar array and becomes a Python float."""
    out = []
    for name, cls_name, fields in items:
        cls = getattr(priors, cls_name)
        if not (isinstance(cls, type) and issubclass(cls, priors.Distribution)):
            raise ValueError(f"{cls_name!r} is not a distribution of pioran_tpu_torch.priors")
        out.append((name, cls(**{k: float(np.asarray(v)) for k, v in fields.items()})))
    return priors.PriorSet(out)


def ns_state_from_numpy(state: Sequence, generator: torch.Generator = None,
                        device=None, dtype: torch.dtype = DEFAULT_DTYPE) -> tuple:
    """The NS state 13-tuple (``samplers.ns`` order) from numpy values.

    ``device`` defaults to the card (``device="cpu"`` for the CPU). The
    key slot (index 5) is replaced by ``generator`` (a new one on
    ``device`` seeded with 0 when omitted); the iteration and call
    counts (indices 4 and 11) become Python ints; every other entry
    becomes a new tensor of ``dtype`` on ``device`` (a copy: the NS step
    writes its dead buffers in place).
    """
    if len(state) != 13:
        raise ValueError(f"an NS state has 13 entries, got {len(state)}")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    out = []
    for i, x in enumerate(state):
        if i == 5:
            out.append(generator)
        elif i in (4, 11):
            out.append(int(np.asarray(x)))
        else:
            out.append(torch.tensor(np.asarray(x), dtype=dtype, device=dev))
    return tuple(out)


def coefficients_from_numpy(a, b, c, d, device=None,
                            dtype: torch.dtype = DEFAULT_DTYPE) -> CeleriteKernel:
    """A CeleriteKernel from (..., J) numpy coefficient arrays, on the
    card unless ``device="cpu"``."""
    dev = resolve_device(device)
    return CeleriteKernel(*(torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
                            for x in (a, b, c, d)))
