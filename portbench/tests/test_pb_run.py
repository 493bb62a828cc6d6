"""A run of each cell, shrunk to the CPU: the result line's keys, the
checks, the chip look, the modules the benchmark may not load, and the
faults that the check must catch."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import check, drive, harness, parts
from conftest import ROOT, run_small

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload,trace", [("sho20-grad", False), ("sho20-grad", True),
                                            ("sho20-sweep", False), ("drw40-grad", True)])
def test_result_line_keys(workload, trace):
    line = run_small(workload, trace=trace)
    keys = list(line)
    assert keys[:5] == KEYS
    assert keys[-1] == "checks"
    assert ("breakdown" in keys) == trace
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    section = "per_layer" if trace else "end_to_end"
    bench = harness.load_benchmark()
    names = {m["name"]: m["unit"] for m in harness.cell_metrics(bench, workload, section)}
    for name, m in line["metrics"].items():
        assert m["unit"] == names[name]
    json.dumps(line, allow_nan=False)


def _stale(spec):
    """A call that returns the previous call's answers: state unchanged."""
    inner, last = spec.logpost_batch, {}

    def logpost_batch(Z):
        out = inner(Z)
        prev = last.get("v")
        last["v"] = out.detach()
        return out if prev is None else out - out.detach() + prev
    spec.logpost_batch = logpost_batch


def _half(spec):
    """Half of the batch left out, the mean of the rest in its place."""
    inner = spec.loglike_batch

    def loglike_batch(TH):
        h = TH.shape[0] // 2
        v = inner(TH[:h])
        return torch.cat([v, v.mean().expand(TH.shape[0] - h)])
    spec.loglike_batch = loglike_batch


def _altered(spec):
    """One answer altered where it is produced."""
    inner = spec.loglike_batch

    def loglike_batch(TH):
        v = inner(TH)
        return v + torch.nn.functional.one_hot(torch.tensor(1), TH.shape[0]).to(v) * 5.0
    spec.loglike_batch = loglike_batch


def _grad_altered(spec):
    """One row's gradient altered where it is produced (values intact)."""
    inner = spec.logpost_batch

    def logpost_batch(Z):
        v = inner(Z)
        w = torch.nn.functional.one_hot(torch.tensor(1), Z.shape[0]).to(v) * 0.5
        return v + w * (v - v.detach())
    spec.logpost_batch = logpost_batch


@pytest.mark.parametrize("workload,fault", [
    ("sho20-grad", _stale), ("sho20-grad", _half), ("sho20-grad", _altered),
    ("sho20-grad", _grad_altered), ("sho20-sweep", _half), ("sho20-sweep", _altered),
    ("drw40-grad", _half)])
def test_a_broken_path_is_not_correct(workload, fault):
    # a window long enough for calls on every pool slot, which a stale
    # answer needs to show
    line = run_small(workload, fault=fault, seconds=3.0)
    if fault is _stale:
        assert line["attempted"] >= 2
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("workload", ["sho20-grad", "sho20-sweep", "drw40-grad", "drw40-smc"])
def test_control_is_not_correct_at_the_cells_size(workload):
    """The control, the reference with TF32 products in the program's
    place, on the cell's own curve and configuration, fails its limits: on
    a window's rows for the calls cells, at a fit's particles for the fits
    (rows near the posterior, as a fit returns them)."""
    keep = {}
    calls = workload != "drw40-smc"
    run_small(workload if calls else "drw40-grad", keep=keep, points=485, batch=4, pool=2)
    config, sample = keep["config"], keep["kept"]
    model = check.reference_model(config, "cpu")
    low = check.reference_model(config, "cpu", dtype=torch.float32, tf32=True)
    limits = parts.load_json("limits", workload)
    if calls:
        kind, kept = keep["kind"], sample
        limits["check"].update(value_block=64, grad_block=8)
    else:
        kind = parts.load_module("drivers", "fits")
        th = model.theta(sample.X.double()).float()
        kept = [drive.Fit(0.0, 1.0, 1, 10, None, [0.0] * 6, th.numpy(), th, None)]
    nums = kind.control_numbers(kept, model, low, config, keep["mix"], limits)
    ok, _ = check.judge(nums, limits["limits"], 0)
    assert not ok, nums


def test_no_card_no_result(tmp_path):
    """Without a card, and in a folder that holds only BENCHMARK.json and
    the benchmark's own files, the command fails and prints no result."""
    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:
            shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
            shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                            ignore=shutil.ignore_patterns("__pycache__"))
        proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "sho20-grad",
                               "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                              cwd=cwd, capture_output=True, text=True, timeout=300,
                              env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert proc.returncode != 0
        assert "correct" not in proc.stdout


def test_nothing_loads_jax_and_the_reference_stands_alone():
    """A subprocess runs a small cell on the CPU and finds no module whose
    top-level name is jax, jaxlib, flax or pioran_tpu; the reference's
    sources import nothing of pioran_tpu_torch."""
    code = (
        "import sys, os; sys.path[:0] = [%r, %r]\n"
        "from conftest import run_small\n"
        "from portbench import harness, parts, readings\n"
        "run_small('sho20-sweep')\n"
        "for folder in ('reference', 'drivers', 'warmups', 'e2e_metrics', 'layer_metrics'):\n"
        "    for f in os.listdir(os.path.join(parts.BENCH_DIR, folder)):\n"
        "        if f.endswith('.py') and not f.startswith('_'):\n"
        "            parts.load_module(folder, f[:-3])\n"
        "print(','.join(harness.forbidden_modules()) or 'none')\n"
    ) % (ROOT, os.path.join(ROOT, "portbench", "tests"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "none"
    ref_dir = os.path.join(ROOT, "portbench", "reference")
    for f in os.listdir(ref_dir):
        if f.endswith(".py"):
            src = open(os.path.join(ref_dir, f)).read()
            assert "pioran_tpu" not in src.replace("pioran_tpu_torch/", "")


def test_the_card_runs_a_cell(cuda_device):
    """On the card: one short run of each cell through the command."""
    bench = harness.load_benchmark()
    for w in bench["workloads"]:
        proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", w["name"],
                               "--seed", "3000000001", "--seconds", "2", "--trace", "0"],
                              cwd=ROOT, capture_output=True, text=True, timeout=1200)
        assert proc.returncode == 0, proc.stderr[-2000:]
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        assert line["correct"] is True, line["checks"]


def test_a_fit_whose_moves_leave_the_particles_is_not_correct(monkeypatch):
    """The fits cell with every temper step's moves leaving the particles
    as they were (the move's state unchanged): the posterior check fails."""
    from pioran_tpu_torch.samplers import smc

    make_step = smc._make_step

    def no_moves(loglike, prior, N, dim, num_moves, *rest):
        return make_step(loglike, prior, N, dim, 0, *rest)
    monkeypatch.setattr(smc, "_make_step", no_moves)
    line = _run_small_fit(2**31 + 5)
    assert line["correct"] is False
    assert line["checks"]["pull_max"]["value"] > line["checks"]["pull_max"]["limit"]


@pytest.mark.parametrize("fault", [_half, _altered])
def test_a_fit_with_a_broken_likelihood_is_not_correct(fault):
    """The fits cell with half of each batch of particles left out (the mean
    of the rest in its place), or one particle's value altered, where the
    likelihood is produced: the row-by-row check of every fit's particles
    fails."""
    line = _run_small_fit(2**31 + 6, fault=fault)
    assert line["correct"] is False
    assert line["checks"]["value_gap"]["value"] > line["checks"]["value_gap"]["limit"]


def test_a_sound_fit_is_correct_at_every_particle():
    keep = {}
    line = _run_small_fit(2**31 + 7, keep=keep)
    assert line["correct"] is True, line["checks"]
    fits = keep["kept"]
    assert fits and all(f.rows.shape == (128, 6) for f in fits)


def _run_small_fit(seed, fault=None, keep=None):
    from conftest import small_cell

    bench, config, mix, limits = small_cell("drw40-smc", points=485)
    config["builder_kwargs"] = {"n_components": 8, "basis_function": "SHO"}
    mix["run"].update(num_particles=128, num_moves=1)
    return harness.run_once(bench, "drw40-smc", seed, 0.1, False, torch.device("cpu"),
                            harness.process_start(), config, mix, limits, fault=fault,
                            keep=keep)
