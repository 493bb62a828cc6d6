"""One run of one cell: set-up, the measured window, the checks and the
result line.

Everything that belongs to one configuration, one traffic mix or one
metric is found by its name (``parts.py``):

- ``configs/<config>.json``: the program's builder and its keywords, the
  light curve, the precision, and ``reference``, the name of the model's
  plain reference ``reference/<name>.py``;
- ``mixes/<traffic>.json``: the traffic; its ``kind`` names the driver
  ``drivers/<kind>.py`` that runs it and keeps what the check compares;
- ``limits/<workload>.json``: each compared number's limit and the
  sample sizes of the check;
- ``e2e_metrics/<name>.py`` and ``layer_metrics/<name>.py``: a
  ``read(ctx)`` that returns the metric's value from the window, or
  ``None`` where it finds nothing to read.
"""

from __future__ import annotations

import gc
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from typing import List, Optional

import torch

from portbench import check, drive, parts
from portbench.trace import TraceSummary, Tracer

ROOT = parts.ROOT
FORBIDDEN = ("jax", "jaxlib", "flax", "pioran_tpu")
TRACE_SECONDS = 4.0


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def load_reader(folder: str, name: str):
    """The ``read`` function of ``<folder>/<name>.py``."""
    return parts.load_module(folder, name).read


def cell_metrics(bench: dict, workload: str, section: str) -> List[dict]:
    """The metrics of ``section`` that the cell reports: those that list it,
    and those without a list."""
    return [m for m in bench[section] if workload in m.get("workloads", [workload])]


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that this benchmark may not load,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def process_start() -> float:
    """Wall-clock time the process started (``time.time`` scale)."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as fh:
            btime = next(int(ln.split()[1]) for ln in fh if ln.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


@dataclass
class Ctx:
    """What a metric reader reads."""

    workload: dict
    config: dict
    mix: dict
    setup_s: float
    window: drive.Window
    trace: Optional[TraceSummary]
    terms: int
    points: int
    batch: Optional[int]


def run_once(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_process: float, config: Optional[dict] = None,
             mix: Optional[dict] = None, limits: Optional[dict] = None,
             fault=None, keep: Optional[dict] = None) -> dict:
    """Run the cell once and return its result line as a dict (with
    ``checks`` last). ``config``, ``mix`` and ``limits`` override the files
    the cell names, ``fault(spec)`` breaks the program's path underneath
    before set-up, and ``keep`` receives the compared answers and the parts
    that judged them; they serve the tests and ``readings.py``."""
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    config = config or parts.load_json("configs", cell["config"])
    mix = mix or parts.load_json("mixes", cell["traffic"])
    limits = limits or parts.load_json("limits", workload)
    kind = parts.load_module("drivers", mix["kind"])
    annotate = drive.Annotator(trace)
    win = drive.Window()

    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.empty(0, device=device)  # the context, before its statistics are reset
        torch.cuda.reset_peak_memory_stats(device)
    model = check.reference_model(config, device)  # its data only, until the check
    spec = drive.build_spec(config, device)
    if fault is not None:
        fault(spec)
    drive.watch_loglike(spec, win, annotate)
    driver = kind.Driver(spec, model, config, mix, seed, annotate)
    tracer = Tracer(device, TRACE_SECONDS) if trace else None
    t_setup_end = time.time()
    if tracer is not None:
        tracer.start()
    driver.window(win, seconds, tracer.on_unit if tracer else (lambda t: None))
    summary = tracer.summary() if tracer else None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    driver.close()

    ctx = Ctx(cell, config, mix, t_setup_end - t_process, win, summary, model.terms,
              int(model.t.shape[0]), mix.get("batch"))
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, workload, section):
        v = load_reader("layer_metrics" if trace else "e2e_metrics", m["name"])(ctx)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the check runs once the program's state is freed
    kept = kind.collect(win, seed, limits)
    if keep is not None:
        keep.update(kept=kept, kind=kind, config=config, mix=mix, limits=limits)
    del spec, driver
    win.outputs.clear()
    win.last_sweep = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = kind.numbers(kept, model, config, mix, limits)
    correct, checks = check.judge(numbers, limits["limits"], win.failed)

    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": win.attempted, "failed": win.failed,
            "metrics": metrics, "device": dev_info}
    if summary is not None:
        dev_info["busy_s"] = summary.busy_s
        dev_info["window_s"] = summary.window_s
        line["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    line["checks"] = {k: {"value": _finite_or_str(c["value"]), "limit": c["limit"]}
                      for k, c in checks.items()}
    return line


def main(argv=None) -> int:
    import argparse

    t_process = process_start()
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_benchmark()
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    line = run_once(bench, args.workload, args.seed, args.seconds, bool(args.trace), device,
                    t_process)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line, allow_nan=False))
    sys.stdout.flush()
    return 0


def _finite_or_str(x: float):
    """A compared number for the result line: non-finite ones as text."""
    return x if math.isfinite(x) else str(x)
