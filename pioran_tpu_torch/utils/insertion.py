"""Insertion-order uniformity test for nested sampling.

The analog of ultranest's ``insertion_order_MWW_test`` (reference
examples/ultranest/inference/simu_single/info/results.json): under
correct constrained-prior sampling, each replacement point's insertion
rank among the surviving live points is uniform on {0..n_slots}
(Buchner 2021, "Nested sampling methods", §insertion order
cross-checks). A Mann-Whitney-Wilcoxon-style rank-sum z-test against
the discrete uniform detects replacement chains that have not mixed
(ranks pile up near their start points) or threshold bookkeeping bugs
(ranks skew low/high).

Host-side numpy: runs once per inference on the (num_iters * n_delete,)
rank buffer ``NSResult.insert_ranks``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

__all__ = ["insertion_order_test"]


def _z_crit_bisect(alpha: float) -> float:
    """Two-sided critical z with ``erfc(z/sqrt2) = alpha``, dependency-free.

    Bisection on the monotone erfc: 60 halvings of [0, 40] pin z to
    ~7e-18 — used when scipy is absent. (A fixed constant here — the old
    5.8, i.e. alpha ~ 1e-8 — made the no-scipy rolling test almost never
    reject: lenient exactly where a convergence gate must be strict.)
    """
    lo, hi = 0.0, 40.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if math.erfc(mid / math.sqrt(2.0)) > alpha:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _rank_sum_z(r: np.ndarray, n_slots: int) -> float:
    """z-score of the rank sum vs iid discrete-uniform{0..n_slots}."""
    m = r.size
    if m == 0:
        return 0.0
    mean = n_slots / 2.0
    var = n_slots * (n_slots + 2) / 12.0  # ((n+1)^2 - 1) / 12
    if var <= 0:
        return 0.0
    return float((r.sum() - m * mean) / math.sqrt(m * var))


def insertion_order_test(
    ranks,
    n_slots: int,
    batch: Optional[int] = None,
    significance: float = 0.01,
) -> Dict:
    """MWW-style insertion-order uniformity test.

    Parameters
    ----------
    ranks : array
        Insertion ranks; entries < 0 (the unused tail of the fixed-size
        buffer) are dropped. Each valid entry must lie in [0, n_slots].
    n_slots : int
        Maximum possible rank (= number of surviving live points the
        replacement was ranked against, K - n_delete).
    batch : int, optional
        Window length for the rolling test (default ``n_slots``,
        matching ultranest's nlive-sized batches).
    significance : float
        Per-experiment two-sided significance level; Bonferroni-split
        across the rolling windows.

    Returns
    -------
    dict with keys
      ``zscore``/``pvalue``: full-sequence rank-sum z and two-sided p;
      ``converged``: no rolling window rejects at the corrected level;
      ``independent_iterations``: longest rejection-free run of rank
      entries (``inf`` when nothing rejects — ultranest's convention).
    """
    r = np.asarray(ranks, dtype=np.float64).ravel()
    r = r[r >= 0]
    m = r.size
    out = {
        "zscore": 0.0,
        "pvalue": 1.0,
        "converged": True,
        "independent_iterations": float("inf"),
        "n_ranks": int(m),
    }
    if m == 0 or n_slots <= 0:
        return out

    z_all = _rank_sum_z(r, n_slots)
    p_all = math.erfc(abs(z_all) / math.sqrt(2.0))
    out["zscore"] = z_all
    out["pvalue"] = p_all

    batch = int(batch or max(n_slots, 1))
    n_win = max(m // batch, 1)
    alpha = significance / n_win  # Bonferroni over windows
    # two-sided critical z for the corrected level
    try:
        from scipy.special import erfcinv

        z_crit = math.sqrt(2.0) * float(erfcinv(alpha))
    except ImportError:
        z_crit = _z_crit_bisect(alpha)
    rejects = []
    for w in range(n_win):
        seg = r[w * batch: (w + 1) * batch if w < n_win - 1 else m]
        if abs(_rank_sum_z(seg, n_slots)) > z_crit:
            rejects.append(w)
    if rejects:
        out["converged"] = False
        # longest stretch of windows between rejections, in rank entries
        edges = [-1] + rejects + [n_win]
        longest = max(b - a - 1 for a, b in zip(edges[:-1], edges[1:]))
        out["independent_iterations"] = float(max(longest, 0) * batch)
    # full-sequence rejection at the uncorrected level also fails the gate
    if p_all < significance:
        out["converged"] = False
        if out["independent_iterations"] == float("inf"):
            out["independent_iterations"] = float(m)
    return out
