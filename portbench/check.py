"""What decides ``correct``: the program's answers from the window against
the plain reference, computed again from the same inputs after the window
has closed.

The reference model is the configuration's ``reference/<name>.py``
(``config["reference"]``), built from the raw curve with the builder's
keywords (``config["builder_kwargs"]``). Each traffic kind's driver
(``drivers/<kind>.py``) keeps its sample of answers and computes the
compared numbers with the functions here; each number is held against its
limit in ``limits/<workload>.json``:

- ``value_gap``: the widest gap, in nats, between a value the program
  returned and the reference's, over the compared rows where both are
  finite;
- ``value_mismatch``: the compared rows where one side is finite and the
  other not (a factorisation that fails on one side only, or a NaN);
  -inf on both sides agrees;
- ``grad_gap``: the widest relative gap |g - g_ref| / |g_ref| of a row's
  gradient.

The control is the same reference computed in float32 with its products
in TF32, put in the program's place.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from portbench import data, parts


def reference_module(config: dict):
    return parts.load_module("reference", config["reference"])


def reference_model(config: dict, device, dtype=torch.float64, tf32: bool = False):
    """The configuration's plain reference model, in ``dtype`` on ``device``."""
    return reference_module(config).Model(*data.curve(config), dtype=dtype, device=device,
                                          tf32=tf32, **config["builder_kwargs"])


def value_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest gap over the rows where both values are finite; infinite
    where there is no such row."""
    prog, ref = prog.double(), ref.double()
    both = torch.isfinite(prog) & torch.isfinite(ref)
    return float((prog[both] - ref[both]).abs().max()) if bool(both.any()) else math.inf


def value_mismatch(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Rows where one value is finite and the other not, or the program's
    is NaN or +inf: -inf on both sides agrees."""
    agree = (torch.isfinite(prog) & torch.isfinite(ref)) | (
        torch.isneginf(prog) & torch.isneginf(ref))
    return float((~agree).sum())


def grad_gap(prog: torch.Tensor, ref: torch.Tensor, ref_values: torch.Tensor) -> float:
    live = torch.isfinite(ref_values)
    if not bool(live.any()):
        return math.nan
    prog, ref = prog[live].double(), ref[live].double()
    rel = (prog - ref).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-300)
    rel = torch.where(torch.isnan(rel), torch.full_like(rel, math.inf), rel)
    return float(rel.max())


def judge(numbers: Dict[str, float], limits: Dict[str, float],
          failed: int) -> (bool, Dict[str, dict]):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, and no unit of work failed. A number without a limit fails."""
    out, ok = {}, failed == 0
    for name, v in numbers.items():
        lim: Optional[float] = limits.get(name)
        out[name] = {"value": v, "limit": lim}
        ok = ok and lim is not None and not math.isnan(v) and v <= lim
    return ok, out
