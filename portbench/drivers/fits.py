"""The ``fits`` kind: whole fits through ``run_inference`` back to back,
each with its own seed derived from ``--seed``, writing its files to a
fresh directory under ``TMPDIR``.

Mix keys: ``run``, the keywords of ``run_inference`` (``sampler`` and its
settings). Set-up runs the sampler's warm-up, ``warmups/<sampler>.py``
(``warm(spec, run, seed)``), found by the sampler's name.

The check compares every fit's last likelihood sweep, the values the fit
returned at its particles, row by row with the reference (``value_gap``,
``value_mismatch``; a fit whose sweep is not over the particles it
returned counts all of them as mismatched), and where the configuration
names referee files, each fit's evidence (``logz_gap``, nats from the
referee's) and posterior means (``pull_max``, referee standard
deviations).
"""

from __future__ import annotations

import math
import shutil
import tempfile
import time
from typing import Callable, List

import torch

from portbench import check, data, drive, parts
from portbench.reference.celerite import values


class Driver:
    def __init__(self, spec, model, config, mix, seed, annotate):
        self.spec, self.run, self.seed, self.annotate = spec, dict(mix["run"]), seed, annotate
        parts.load_module("warmups", self.run["sampler"]).warm(
            spec, self.run, data.derived_seed(seed, "warm"))
        drive.sync(spec.device)
        self.dirs: List[str] = []

    def window(self, win: drive.Window, seconds: float, on_unit: Callable):
        from pioran_tpu_torch import run_inference

        win.start = time.perf_counter()
        end_at = win.start + seconds
        k = 0
        while True:
            seed = data.derived_seed(self.seed, "fit", k)
            log_dir = tempfile.mkdtemp(prefix="portbench-fit-")
            self.dirs.append(log_dir)
            win.last_sweep = None
            t0 = time.perf_counter()
            try:
                with self.annotate("pb.fit"):
                    res = run_inference(self.spec, seed=seed, log_dir=log_dir, **self.run)
                t1 = time.perf_counter()
                rows, vals = win.last_sweep or (None, None)
                win.fits.append(drive.Fit(
                    t0, t1, seed, res.get("num_temper_steps"), res.get("logz"),
                    [float(v) for v in res["posterior"]["mean"]], res["samples"], rows, vals))
            except RuntimeError:
                win.failed += 1
                t1 = time.perf_counter()
            win.attempted += 1
            k += 1
            on_unit(t1)
            if t1 >= end_at:
                break
        win.end = t1

    def close(self):
        for d in self.dirs:
            shutil.rmtree(d, ignore_errors=True)


def collect(win: drive.Window, seed: int, limits: dict):
    return list(win.fits)


def _swept(fit: drive.Fit) -> bool:
    """Whether the fit's last sweep is over the particles it returned."""
    if fit.rows is None or fit.values is None:
        return False
    samples = torch.as_tensor(fit.samples, dtype=fit.rows.dtype, device=fit.rows.device)
    return fit.rows.shape == samples.shape and bool(torch.equal(fit.rows, samples))


def _rows_numbers(fits, model, answer, block: int):
    """value_gap and value_mismatch of ``answer(fit)`` (a fit's values at its
    particles) against the reference, over every fit."""
    swept = [f for f in fits if _swept(f)]
    unswept = sum(len(f.samples) for f in fits if not _swept(f))
    if not swept:
        return {"value_gap": math.inf, "value_mismatch": float(unswept)}
    X = torch.cat([f.rows for f in swept]).to(model.dtype)
    ref = values(model.loglike, X, block)
    got = torch.cat([answer(f) for f in swept]).to(ref.device)
    return {"value_gap": check.value_gap(got, ref),
            "value_mismatch": check.value_mismatch(got, ref) + unswept}


def numbers(fits, model, config, mix, limits):
    """The compared numbers of the window's fits."""
    if not fits:
        return {"value_gap": math.nan}
    nums = _rows_numbers(fits, model, lambda f: f.values, limits["check"]["value_block"])
    if config.get("evidence_referee"):
        logz_ref = data.load_json(config["evidence_referee"])["logz"]
        nums["logz_gap"] = max(abs(f.logz - logz_ref) if f.logz is not None else math.inf
                               for f in fits)
    if config.get("referee"):
        referee = data.load_json(config["referee"])
        mean = torch.tensor(referee["is_mean"], dtype=torch.float64)
        sd = torch.tensor(referee["is_std"], dtype=torch.float64)
        nums["pull_max"] = max(
            float(((torch.tensor(f.mean, dtype=torch.float64) - mean).abs() / sd).max())
            for f in fits)
    return nums


def control_numbers(fits, model, low, config, mix, limits):
    """value_gap and value_mismatch with the reference ``low`` in the
    program's place, at the same fits' particles."""
    block = limits["check"]["value_block"]
    return _rows_numbers(fits, model,
                         lambda f: values(low.loglike, f.rows.to(low.dtype), block), block)
