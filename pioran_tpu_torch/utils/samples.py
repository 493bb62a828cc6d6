"""Posterior-sample column routing (reference src/utils.jl:89-151): the
port's own numpy copy of ``pioran_tpu.utils.samples``."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

__all__ = ["separate_samples", "makelist_namessplit"]


def makelist_namessplit(paramnames_split: Dict) -> Dict[str, List[str]]:
    """Normalize dict values to lists (reference utils.jl:89-100)."""
    return {
        k: v if isinstance(v, (list, tuple)) else [v]
        for k, v in paramnames_split.items()
    }


def separate_samples(samples, paramnames: Sequence[str], paramnames_split: Dict):
    """Split a (P, k) sample matrix into PSD / norm / nu / mu / c columns.

    Returns (samples_psd, samples_norm, samples_nu, samples_mu, samples_c)
    with ones/zeros defaults when a role is absent
    (reference utils.jl:108-151).
    """
    samples = np.asarray(samples)
    names = list(paramnames)
    split = makelist_namessplit(paramnames_split)
    P = samples.shape[0]

    def cols(role):
        if role not in split:
            return None
        idx = [names.index(n) for n in split[role] if n in names]
        if len(idx) != len(split[role]):
            return None
        return samples[:, idx]

    s_psd = cols("psd")
    s_norm = cols("norm")
    if s_norm is not None:
        s_norm = s_norm[:, 0]
    nu = cols("scale_err")
    s_nu = np.ones(P) if nu is None else nu[:, 0]
    c = cols("log_transform")
    s_c = np.zeros(P) if c is None else c[:, 0]
    mu = cols("mean")
    s_mu = np.zeros(P) if mu is None else mu[:, 0]
    return s_psd, s_norm, s_nu, s_mu, s_c
