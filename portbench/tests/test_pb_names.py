"""Configurations, mixes, traffic kinds, reference models, limits and metric
readers are found by their names in BENCHMARK.json; a new one is a new
file and an entry, with no edit to a file that is there."""

import json
import os
import shutil

import pytest
import torch

from portbench import harness, parts

BENCH = harness.load_benchmark()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    config = parts.load_json("configs", w["config"])
    assert config["dtype"] == "float32" and config["tf32"] is False
    assert hasattr(parts.load_module("reference", config["reference"]), "Model")
    mix = parts.load_json("mixes", w["traffic"])
    kind = parts.load_module("drivers", mix["kind"])
    assert all(hasattr(kind, f) for f in ("Driver", "collect", "numbers", "control_numbers"))
    assert parts.load_json("limits", cell)["limits"]
    e2e = [m["name"] for m in harness.cell_metrics(BENCH, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in harness.cell_metrics(BENCH, cell, "end_to_end"):
        assert callable(harness.load_reader("e2e_metrics", m["name"]))
    layer = harness.cell_metrics(BENCH, cell, "per_layer")
    assert layer
    for m in layer:
        assert callable(harness.load_reader("layer_metrics", m["name"]))
        # the metric it moves is one the cell reports
        assert m["moves"] in e2e


def test_config_entries_point_at_their_files():
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"]))
        assert c["reduced"] == []


# a second builder's plain reference, as a later PR would add it: the
# double-bending power law (pioran_tpu_torch/models/psd.py:105)
DOUBLE_BENDING = '''
import torch
from portbench.reference.celerite import ApproxCelerite


class Model(ApproxCelerite):
    VAR, NU, MU = 5, 6, 7

    def psd(self, points, TH):
        a1, a2, a3, f1, f2 = (TH[:, i:i + 1] for i in range(5))
        x1, x2 = points / f1, points / f2
        return x1 ** (-a1) / (1.0 + x1 ** (a2 - a1)) / (1.0 + x2 ** (a3 - a2))


def rows(model, referee, n, sd, gen, dtype, device):
    mean = torch.tensor(referee["is_mean"], dtype=dtype, device=device)
    std = torch.tensor(referee["is_std"], dtype=dtype, device=device)
    return mean + sd * std * torch.rand((n, mean.numel()), generator=gen, dtype=dtype,
                                        device=device)
'''

# a new traffic kind: bursts of ``burst`` calls back to back, then one
# synchronize, reusing the calls kind's set-up and check
BURSTS = '''
import time

from portbench import drive
from portbench.drivers.calls import CallSample, collect, control_numbers, numbers  # noqa: F401
from portbench.drivers.calls import Driver as _Calls


class Driver(_Calls):
    def window(self, win, seconds, on_unit):
        win.start = time.perf_counter()
        i = 0
        while True:
            t0 = time.perf_counter()
            for _ in range(self.mix["burst"]):
                X = self.pool[i % len(self.pool)]
                value, grad = self.fn(X)
                win.outputs[i % len(self.pool)] = (X, value, grad)
                i += 1
            t1 = time.perf_counter()
            drive.sync(self.spec.device)
            t2 = time.perf_counter()
            win.calls.append(drive.Call(t0, t1, t2, X.shape[0] * self.mix["burst"], self.kind))
            win.attempted += 1
            on_unit(t2)
            if t2 >= win.start + seconds:
                break
        win.end = t2
'''


def test_a_new_builder_kind_metric_and_mix_are_new_files(tmp_path, monkeypatch):
    """Copy the benchmark's folder; add a configuration of a second builder
    with its reference model, a mix of a new traffic kind with its driver,
    its limits and a per-layer reader, all as new files; then run the new
    cell on the CPU, found by name, and see it correct."""
    bench_dir = tmp_path / "portbench"
    shutil.copytree(parts.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    referee = json.loads((bench_dir / "data" / "is_referee.json").read_text())
    m, s = referee["is_mean"], referee["is_std"]
    new = {
        "reference/double_bending.py": DOUBLE_BENDING,
        "drivers/bursts.py": BURSTS,
        "data/dbpl_referee.json": json.dumps({
            "is_mean": [m[0], m[1], min(m[1] + 0.5, 3.9), m[2], 3.0 * m[2]] + m[3:],
            "is_std": [0.1 * v for v in s[:2] + s[1:3] + s[2:]]}),
        "configs/dbpl-sho20.json": json.dumps({
            "builder": "double_bending_model", "reference": "double_bending",
            "builder_kwargs": {"n_components": 20, "basis_function": "SHO"},
            "dtype": "float32", "tf32": False, "curve": "simu_single_subset_time_series.txt",
            "referee": "dbpl_referee.json", "points": 48}),
        "mixes/sweep-bursts4.json": json.dumps({
            "kind": "bursts", "program": "loglike_batch", "reference": "loglike",
            "grad": False, "space": "theta", "batch": 8, "pool": 2, "row_sd": 0.5,
            "burst": 4}),
        "limits/dbpl20-bursts.json": json.dumps({
            "limits": {"value_gap": 0.1, "value_mismatch": 0},
            "check": {"value_rows": 16, "grad_rows": 0, "value_block": 16}}),
        "layer_metrics/calls_done.py": "def read(ctx):\n    return float(len(ctx.window.calls))\n",
    }
    for rel, text in new.items():
        assert not (bench_dir / rel).exists()
        (bench_dir / rel).write_text(text)

    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "dbpl-sho20", "file": "portbench/configs/dbpl-sho20.json"})
    bench["workloads"].append({"name": "dbpl20-bursts", "config": "dbpl-sho20",
                               "traffic": "sweep-bursts4", "chips": 1, "why": "x"})
    bench["end_to_end"][[e["name"] for e in bench["end_to_end"]].index(
        "loglike_evals_per_s")]["workloads"].append("dbpl20-bursts")
    bench["per_layer"].append({"name": "calls_done", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "whole step",
                               "moves": "loglike_evals_per_s", "workloads": ["dbpl20-bursts"]})
    monkeypatch.setattr(parts, "BENCH_DIR", str(bench_dir))
    for trace in (False, True):
        line = harness.run_once(bench, "dbpl20-bursts", 2**33 + 1, 0.2, trace,
                                torch.device("cpu"), harness.process_start())
        assert line["correct"] is True, line["checks"]
        assert line["checks"]["value_gap"]["value"] < 0.1
        names = set(line["metrics"])
        assert names == ({"calls_done"} if trace else {"loglike_evals_per_s", "setup_s"})
    # and a wrong answer from the new builder's path is caught
    line = harness.run_once(bench, "dbpl20-bursts", 2**33 + 2, 0.2, False, torch.device("cpu"),
                            harness.process_start(),
                            fault=lambda spec: setattr(spec, "loglike_batch",
                                                       (lambda f: lambda TH: f(TH) + 0.5)(
                                                           spec.loglike_batch)))
    assert line["correct"] is False
    assert all(p.read_bytes() == b for p, b in before.items())
