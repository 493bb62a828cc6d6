"""Data subset extraction for data-driven priors (reference src/utils.jl:27-84).

Withholds ~n_perc of the time series; the withheld points' (log-)mean and
variance seed the prior on the GP mean. Results are cached to a txt file
with the same header format as the reference so runs resume identically.
The port's own numpy copy of ``pioran_tpu.utils.subset``: a cache file
either package writes, the other reads.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

__all__ = ["extract_subset"]


def extract_subset(
    seed_or_rng,
    prefix: str,
    t,
    y,
    yerr,
    n_perc: float = 0.03,
    take_log: bool = True,
    suffix: str = "",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float, float]:
    """Return (t_subset, y_subset, yerr_subset, xbar, va).

    The kept arrays are the (1 - n_perc) fraction used for inference; the
    withheld points give initial guesses xbar (mean) and va (variance) of
    the (log-)flux. Caches/reads ``{prefix}_subset_time_series{suffix}.txt``.
    """
    rng = (
        seed_or_rng
        if isinstance(seed_or_rng, np.random.Generator)
        else np.random.default_rng(seed_or_rng)
    )
    t = np.asarray(t)
    y = np.asarray(y)
    yerr = np.asarray(yerr)

    filename = f"{prefix}_subset_time_series{suffix}.txt"
    if os.path.isfile(filename):
        with open(filename) as fh:
            xbar = va = None
            for line in fh:
                if line.startswith("#mean: "):
                    left, right = line[len("#mean: "):].split(" va: ")
                    xbar, va = float(left), float(right)
                    break
        A = np.loadtxt(filename, comments="#")
        return A[:, 0], A[:, 1], A[:, 2], xbar, va

    n_points = len(t)
    n_samples = int(round(n_points * n_perc))
    if n_samples <= 1:
        n_samples = 3
    withheld = rng.choice(n_points, size=n_samples, replace=False)
    keep = np.setdiff1d(np.arange(n_points), withheld)

    x = np.log(y[withheld]) if take_log else y[withheld]
    info = "#Estimates computed on the log of the subset time series\n" if take_log else ""
    va = float(np.var(x, ddof=1))
    xbar = float(np.mean(x))

    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    with open(filename, "w") as fh:
        fh.write(
            "#Extracted time series for the analysis (97% of the OG time series)\n"
            "# t y yerr\n"
            "#Initial guess for the mean and variance from the discarded subset\n"
            f"#mean: {xbar} va: {va}\n{info}"
        )
        np.savetxt(fh, np.column_stack([t[keep], y[keep], yerr[keep]]))
    return t[keep], y[keep], yerr[keep], xbar, va
