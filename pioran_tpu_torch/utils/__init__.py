"""Helpers around the samplers: MCMC diagnostics, the CARMA root checks,
the posterior's per-component split and the light-curve subsets.

The names and their order are the JAX package's ``utils``, with
``roots_valid_batch`` (batched over rows, no jit) in place of its
``roots_valid_jit``.
"""

from .mcmc_stats import ess_bulk, ess_tail, split_rhat, summarize_chains
from .roots import (
    check_conjugate_pair,
    check_order_imag_roots,
    check_roots_bounds,
    roots_valid_batch,
)
from .samples import makelist_namessplit, separate_samples
from .subset import extract_subset

__all__ = [
    "check_conjugate_pair",
    "check_order_imag_roots",
    "check_roots_bounds",
    "roots_valid_batch",
    "extract_subset",
    "separate_samples",
    "makelist_namessplit",
    "split_rhat",
    "ess_bulk",
    "ess_tail",
    "summarize_chains",
]
