"""What every traffic kind shares: the window's records, the program's
model spec built from a configuration, the named spans of a traced run,
and the watch on the spec's likelihood.

A mix (``mixes/<name>.json``) names its ``kind``; the kind's driver is
``drivers/<kind>.py``, found by that name. A driver module defines

- ``Driver(spec, model, config, mix, seed, annotate)``: set-up, which
  draws the inputs from ``--seed`` and warms every shape the traffic
  uses, with ``window(win, seconds, on_unit)``, which starts units of work
  while the window is open (the last runs to its end and is counted, and
  the window closes with it), and ``close()``;
- ``collect(win, seed, limits)``: the answers that are compared, kept
  before the program's state is freed;
- ``numbers(kept, model, config, mix, limits)`` and
  ``control_numbers(kept, model, low, config, mix, limits)``: the compared
  numbers (``check.py``) of the program's answers, and of the control's
  (the reference ``low`` in the program's place), against ``model``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from portbench import data


@dataclass
class Call:
    t0: float
    t_issue: float
    t_done: float
    rows: int
    kind: str  # "grad" or "sweep"


@dataclass
class Fit:
    t0: float
    t_done: float
    seed: int
    temper_steps: Optional[int]
    logz: Optional[float]
    mean: List[float]
    samples: np.ndarray
    # the fit's last likelihood sweep: its rows and the values it returned
    rows: Optional[torch.Tensor]
    values: Optional[torch.Tensor]


@dataclass
class Window:
    start: float = 0.0
    end: float = 0.0
    attempted: int = 0
    failed: int = 0
    calls: List[Call] = field(default_factory=list)
    fits: List[Fit] = field(default_factory=list)
    # a calls driver's last answers per pool slot: (rows, value, grad)
    outputs: dict = field(default_factory=dict)
    # the spec's last likelihood call without a gradient: (rows, values)
    last_sweep: Optional[tuple] = None

    @property
    def seconds(self) -> float:
        return self.end - self.start


def build_spec(config: dict, device):
    """The configuration's model spec, built through the program's builder
    with the configuration's keywords."""
    import pioran_tpu_torch

    builder = getattr(pioran_tpu_torch, config["builder"])
    return builder(*data.curve(config), device=device, dtype=getattr(torch, config["dtype"]),
                   **config["builder_kwargs"])


class Annotator:
    """Named host spans in the profiler's trace (``record_function``) when
    tracing, nothing otherwise."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        if self.on:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()


def watch_loglike(spec, win: Window, annotate: Annotator):
    """Wrap the spec's ``loglike_batch``, the entry from the samplers and
    the log-posterior into the likelihood: mark its calls in the trace, and
    keep the last call without a gradient (a fit's final sweep over its
    particles) for the check."""
    inner = spec.loglike_batch

    def loglike_batch(TH):
        grad = torch.is_grad_enabled() and TH.requires_grad
        with annotate("pb.loglike." + ("grad" if grad else "sweep")):
            out = inner(TH)
        if not grad:
            win.last_sweep = (TH, out)
        return out

    spec.loglike_batch = loglike_batch


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
