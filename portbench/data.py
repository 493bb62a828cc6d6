"""The benchmark's inputs: the light curve a configuration names, the
referee files, and the seeds of a run's streams.

``load_curve`` is a copy of ``chip_smoke.py``'s ``load_curve``
(chip_smoke.py:293), kept here so that the yardstick does not move with
the program's scripts; the parameter rows are drawn by the configuration's
reference module (``reference/<name>.py``, ``rows``).
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from portbench import parts


def load_curve(fname: str):
    """(t, y, yerr) columns of ``data/<fname>`` and its ``#mean:`` header
    (xbar, va)."""
    path = os.path.join(parts.BENCH_DIR, "data", fname)
    xbar = va = None
    with open(path) as fh:
        for line in fh:
            if line.startswith("#mean: "):
                left, right = line[len("#mean: "):].split(" va: ")
                xbar, va = float(left), float(right)
                break
    A = np.loadtxt(path)
    return A[:, 0], A[:, 1], A[:, 2], xbar, va


def curve(config: dict):
    """The configuration's curve, cut to its first ``points`` points where
    it names that many: (t, y, yerr, xbar, va)."""
    t, y, yerr, xbar, va = load_curve(config["curve"])
    n = config.get("points")
    if n:
        t, y, yerr = t[:n], y[:n], yerr[:n]
    return t, y, yerr, xbar, va


def load_json(fname: str) -> dict:
    with open(os.path.join(parts.BENCH_DIR, "data", fname)) as fh:
        return json.load(fh)


def derived_seed(seed: int, *parts) -> int:
    """A 62-bit seed derived from ``seed`` and ``parts``: distinct streams
    of one run, and the same streams in every run of that seed."""
    key = ":".join(str(p) for p in (seed,) + parts).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 2
