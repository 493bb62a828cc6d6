"""The traced run: ``torch.profiler`` over the first part of the window,
and its reduction to device-busy time, idle gaps and time per kernel.

The profiler records the host's operations, the benchmark's own spans
(``pb.*``, ``drive.Annotator``) and every operation on the card on one
clock. The traced window runs from the start of the first ``pb.call.*``
or ``pb.fit`` span to the end of the last one the profiler saw whole.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
UNIT_PREFIXES = ("pb.call.", "pb.fit")


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    units: Dict[str, int]                       # traced pb.call.<kind> / pb.fit spans
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


class Tracer:
    """Profiles from :meth:`start` until the first unit of work that ends
    ``seconds`` or more after it."""

    def __init__(self, device: torch.device, seconds: float):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.seconds = seconds
        self.t_start: Optional[float] = None
        self.running = False

    def start(self):
        self.prof.start()
        # after the profiler's own start, which can take seconds
        self.t_start, self.running = time.perf_counter(), True

    def on_unit(self, t: float):
        if self.running and t - self.t_start >= self.seconds:
            self.stop()

    def stop(self):
        if self.running:
            self.prof.stop()
            self.running = False

    def summary(self) -> Optional[TraceSummary]:
        self.stop()
        fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        finally:
            os.remove(path)
        return summarize(events)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(events: List[dict]) -> Optional[TraceSummary]:
    """Busy and idle time of the card, and per-kernel time, within the
    traced window of a chrome trace's events (times in microseconds)."""
    dev, units, spans, ops = [], [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        s = float(e["ts"])
        iv = (s, s + float(e["dur"]), name)
        if cat in DEVICE_CATS:
            dev.append(iv)
        elif cat == "user_annotation" and name.startswith("pb."):
            spans.append(iv + (e.get("tid"),))
            if name.startswith(UNIT_PREFIXES):
                units.append(iv + (e.get("tid"),))
        elif cat == "cpu_op":
            ops.append(iv + (e.get("tid"),))
    if not units:
        return None
    w0 = min(u[0] for u in units)
    w1 = max(u[1] for u in units)
    counted = defaultdict(int)
    for _, _, name, _ in units:
        counted[name[len("pb.call."):] if name.startswith("pb.call.") else "fit"] += 1

    clipped = [(max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1]
    busy_iv = _merge([(s, e) for s, e, _ in clipped])
    busy = sum(e - s for s, e in busy_iv)
    per_op = defaultdict(float)
    for s, e, n in clipped:
        per_op[n] += e - s

    # idle gaps, named by the host's benchmark span and the outermost host
    # operation running when the gap began: on the calling thread, else on
    # another (the autograd engine runs a backward on a thread of its own)
    main_tid = units[0][3]
    host_spans = sorted((s, e, n) for s, e, n, tid in spans if tid == main_tid)
    span_starts = [s for s, _, _ in host_spans]
    by_tid = defaultdict(list)
    for s, e, n, tid in sorted(ops):
        top = by_tid[tid]
        if not top or s >= top[-1][1]:
            top.append((s, e, n))
    tops = {tid: ([s for s, _, _ in top], top) for tid, top in by_tid.items()}

    def host_op(g0):
        order = [main_tid] + [t for t in tops if t != main_tid]
        for tid in order:
            if tid not in tops:
                continue
            starts, top = tops[tid]
            j = bisect.bisect_right(starts, g0) - 1
            if j >= 0 and top[j][1] > g0:
                return top[j][2] if tid == main_tid else f"{top[j][2]} (other thread)"
        return "no host op"

    gaps, prev = [], w0
    for s, e in busy_iv + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    idle = defaultdict(float)
    for g0, g1 in gaps:
        i = bisect.bisect_right(span_starts, g0)
        # the innermost span over g0 starts last; spans nest a few deep
        span = next((n for s, e, n in reversed(host_spans[max(i - 8, 0):i]) if g0 < e),
                    "outside pb spans")
        idle[f"{span} / {host_op(g0)}"] += (g1 - g0) * 1e-6

    def top(d, scale):
        return [[k, v * scale] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return TraceSummary(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6, units=dict(counted),
                        device_ops=top(per_op, 1e-6), idle_gaps=top(idle, 1.0))
