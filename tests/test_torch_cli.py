"""PyTorch port: the example scripts (``pioran_tpu_torch.examples``).

- ``--help``: each CLI's option strings (with their choices) equal
  those that ``python examples/<x>.py --help`` prints, except ``--x64``,
  which becomes ``--dtype``; the defaults and choices equal those of the
  JAX script's own parser.
- Short runs on the CPU (``--cpu --dtype float64``, SMC with 64 particles
  and 2 MALA moves on a 32-point cut of each light curve, and
  ``single_pl --sampler nuts --hmc-stepped`` with 2 chains): the output
  layout, the result keys of the JAX package's SMC and NUTS runs, and a cached
  subset file byte-equal to what ``pioran_tpu.utils.extract_subset``
  writes for the same seed and input. Without ``--cpu`` on a machine
  with no card a CLI raises ``RuntimeError`` and writes nothing.
- The parity CLI on 32-point cuts (its loaders patched): each entry
  carries the keys of the same entry in the committed
  ``artifacts/tpu_parity/summary.json``.
"""

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from pioran_tpu.utils import extract_subset as jax_extract_subset
from pioran_tpu_torch.examples import carma, double_pl, parity, single_pl, single_pl_periodicity

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_EXAMPLES = os.path.join(ROOT, "examples")
DATA = os.path.join(ROOT, "tests", "data")
PAIRS = {  # JAX script -> port module
    "single_pl.py": single_pl,
    "double_pl.py": double_pl,
    "single_pl_periodicity.py": single_pl_periodicity,
    "carma.py": carma,
    "tpu_parity.py": parity,
}
DROPPED = {"--x64"}                     # JAX options with no counterpart
ADDED = {"--dtype"}                     # the port's stand-in for --x64
# defaults the port changes on purpose: its parity artifacts' directory
DEFAULTS = {"tpu_parity.py": {"out": "artifacts/torch_parity"}}
SMC_KEYS = {"paramnames", "sampler", "elapsed_s", "posterior", "maximum_likelihood",
            "logz", "num_temper_steps", "ncall"}
NUTS_KEYS = {"paramnames", "sampler", "elapsed_s", "posterior", "maximum_likelihood",
             "ncall", "rhat", "ess_bulk", "ess_tail", "ess", "ess_per_s"}
TINY = ["--cpu", "--dtype", "float64", "--sampler", "smc", "--particles", "64",
        "--moves", "2"]
# CLI, light curve, its own options, (t shift, take_log) as the JAX
# script prepares the curve for extract_subset
RUNS = {
    "single_pl": (single_pl, os.path.join(ROOT, "examples", "data", "simu.txt"), [],
                  (False, True)),
    "double_pl": (double_pl, os.path.join(
        DATA, "simu_double", "simu_double_subset_time_series.txt"), [], (False, True)),
    "single_pl_periodicity": (single_pl_periodicity, os.path.join(
        DATA, "simu_periodic", "simu_periodic_rednoise_subset_time_series.txt"), [],
        (True, False)),
    "carma": (carma, os.path.join(ROOT, "examples", "data", "simu.txt"), ["--p", "2", "--q", "1"],
              (False, True)),
}
# the layout test's runs: each CLI's SMC run, and single_pl's host-stepped
# NUTS (2 chains, 2 + 2 iterations)
STEPPED_NUTS = ["--cpu", "--dtype", "float64", "--sampler", "nuts", "--hmc-stepped",
                "--chains", "2", "--warmup", "2", "--samples", "2", "--components", "4"]
LAYOUT_RUNS = {**{name: (name, TINY) for name in RUNS},
               "single_pl-hmc-stepped": ("single_pl", STEPPED_NUTS)}


def _option_lines(help_text):
    """{option string: its metavar or choices} of an argparse help text:
    the lines that start with two spaces and a dash."""
    out = {}
    for line in help_text.splitlines():
        m = re.match(r"^  (-\S.*?)(?:\s{2,}|$)", line)
        if m:
            for part in m.group(1).split(", "):
                name, _, meta = part.partition(" ")
                out[name] = meta
    return out


class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def _jax_parser(script, monkeypatch):
    """The argparse parser the JAX script builds: its ``main`` runs until
    ``parse_args``, which hands the parser over (no JAX import is reached)."""
    def capture(self, *a, **k):
        raise _Parsed(self)

    spec = importlib.util.spec_from_file_location(f"_jax_cli_{script[:-3]}",
                                                  os.path.join(JAX_EXAMPLES, script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with monkeypatch.context() as m, pytest.raises(_Parsed) as caught:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        mod.main()
    return caught.value.parser


def _settings(parser, skip):
    return {a.dest: (a.option_strings, a.default, a.choices, a.type, a.nargs)
            for a in parser._actions if not set(a.option_strings) & skip}


@pytest.mark.parametrize("script", sorted(PAIRS))
def test_help_matches_the_jax_script(script, monkeypatch):
    out = subprocess.run([sys.executable, os.path.join(JAX_EXAMPLES, script), "--help"],
                         capture_output=True, text=True, timeout=60, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    jax_opts = {k: v for k, v in _option_lines(out.stdout).items() if k not in DROPPED}
    port = PAIRS[script].parser()
    port_opts = {k: v for k, v in _option_lines(port.format_help()).items()
                 if k not in ADDED}
    assert port_opts == jax_opts
    want = _settings(_jax_parser(script, monkeypatch), DROPPED | {"-h"})
    for dest, default in DEFAULTS.get(script, {}).items():
        want[dest] = want[dest][:1] + (default,) + want[dest][2:]
    assert _settings(port, ADDED | {"-h"}) == want
    if "--dtype" in _option_lines(port.format_help()):
        dtype = next(a for a in port._actions if a.dest == "dtype")
        assert dtype.default == "float32" and dtype.choices == ["float32", "float64"]


def _cut(src, dst, n=32):
    with open(src) as fh:
        rows = [ln for ln in fh if not ln.startswith("#")][:n]
    with open(dst, "w") as fh:
        fh.writelines(rows)
    return dst


def _run_dir(root):
    runs = os.listdir(os.path.join(root, "inference"))
    assert len(runs) == 1, runs
    return os.path.join(root, "inference", runs[0])


@pytest.mark.parametrize("name", sorted(LAYOUT_RUNS))
def test_tiny_run_writes_the_layout(name, tmp_path, monkeypatch):
    cli, opts = LAYOUT_RUNS[name]
    mod, src, extra, (shift, take_log) = RUNS[cli]
    data = _cut(src, str(tmp_path / f"{name}.txt"))
    monkeypatch.chdir(tmp_path)
    assert mod.main([data, *extra, *opts]) == 0
    out = _run_dir(str(tmp_path))
    with open(os.path.join(out, "info", "results.json")) as fh:
        res = json.load(fh)
    if opts is TINY:
        assert set(res) == SMC_KEYS and res["sampler"] == "smc"
        assert np.isfinite(res["logz"])
        rows = 64
    else:
        assert set(res) == NUTS_KEYS and res["sampler"] == "nuts"
        assert res["ncall"] > 0
        rows = 2 * 2
    with open(os.path.join(out, "chains", "equal_weighted_post.txt")) as fh:
        assert fh.readline().split() == res["paramnames"]
    post = np.loadtxt(os.path.join(out, "chains", "equal_weighted_post.txt"), skiprows=1)
    assert post.shape == (rows, len(res["paramnames"])) and np.all(np.isfinite(post))

    # the cached subset, against the JAX package's extract_subset on the
    # same seed (the CLIs' default 123) and curve
    subset = [f for f in os.listdir(out) if f.endswith("_subset_time_series.txt")]
    assert len(subset) == 1
    A = np.loadtxt(data)
    t = A[:, 0] - A[0, 0] if shift else A[:, 0]
    ref_dir = tmp_path / "jax"
    ref_dir.mkdir()
    prefix = subset[0][:-len("_subset_time_series.txt")]
    jax_extract_subset(123, str(ref_dir / prefix), t, A[:, 1], A[:, 2], take_log=take_log)
    with open(os.path.join(out, subset[0]), "rb") as fh, \
            open(ref_dir / subset[0], "rb") as ref:
        assert fh.read() == ref.read()


def test_single_pl_checks_write_their_files(tmp_path, monkeypatch):
    """--prior-checks and --posterior-checks: the diagnostics' text files
    under plots/ (figures too, where matplotlib imports)."""
    data = _cut(RUNS["single_pl"][1], str(tmp_path / "simu.txt"))
    monkeypatch.chdir(tmp_path)
    assert single_pl.main([data, *TINY, "--prior-checks", "--posterior-checks"]) == 0
    plots = os.path.join(_run_dir(str(tmp_path)), "plots")
    for name in ("mean_psd_approx.txt", "quantiles_psd_approx.txt", "psd_ppc_data.txt",
                 "lsp_ppc_data.txt", "ppc_timeseries_quantiles.txt"):
        assert os.path.isfile(os.path.join(plots, name)), name


def test_carma_posterior_check_writes_its_psd(tmp_path, monkeypatch):
    data = _cut(RUNS["carma"][1], str(tmp_path / "simu.txt"))
    monkeypatch.chdir(tmp_path)
    assert carma.main([data, "--p", "3", "--q", "2", *TINY, "--posterior-checks"]) == 0
    psd = np.loadtxt(os.path.join(_run_dir(str(tmp_path)), "plots", "psd_ppc_data.txt"))
    assert psd.shape == (6, 1000) and np.all(np.isfinite(psd))


@pytest.mark.parametrize("p,q", [(2, 0), (2, 1), (3, 2), (4, 3)])
def test_carma_ppc_roots_match_the_jax_script(p, q):
    """The CLI's conjugate-pair roots and MA coefficients, against the
    JAX script's row-by-row construction through the JAX package's
    ``poly_from_conjugate_pairs``."""
    import jax.numpy as jnp

    from pioran_tpu.models.carma import poly_from_conjugate_pairs

    n_ar = 2 * (p // 2) + p % 2
    n_ma = 2 * (q // 2) + q % 2
    sub = np.random.default_rng(p + q).uniform(0.1, 2.0, (5, n_ar + n_ma + 3))
    ras, betas = carma.ppc_roots(sub, p, q)
    for th, r_row, b_row in zip(sub, ras, betas):
        r = []
        for k in range(p // 2):
            u, b = th[2 * k], th[2 * k + 1]
            r += [-b / 2 + 1j * np.sqrt(u), -b / 2 - 1j * np.sqrt(u)]
        if p % 2:
            r.append(-th[2 * (p // 2)] + 0j)
        np.testing.assert_array_equal(r_row, np.asarray(r))
        if q > 0:
            pre = [jnp.asarray(-th[n_ar + 2 * k + 1] / 2) for k in range(q // 2)]
            pim = [jnp.asarray(np.sqrt(th[n_ar + 2 * k])) for k in range(q // 2)]
            rr = [jnp.asarray(-th[n_ar + 2 * (q // 2)])] if q % 2 else []
            ref = np.asarray(poly_from_conjugate_pairs(pre, pim, rr))
        else:
            ref = np.ones(1)
        np.testing.assert_allclose(b_row, ref, rtol=1e-14)


@pytest.mark.parametrize("name", sorted(RUNS) + ["parity"])
def test_no_card_raises_and_writes_nothing(name, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if name == "parity":
            parity.main(["--out", str(tmp_path / "out")])
        else:
            mod, src, extra, _ = RUNS[name]
            mod.main([_cut(src, str(tmp_path / "curve.txt")), *extra, "--sampler", "smc"])
    assert sorted(os.listdir(tmp_path)) == ([] if name == "parity" else ["curve.txt"])


def _cut_loaders(monkeypatch, n=32):
    load, load_longn = parity.load_dataset, parity.load_longn
    monkeypatch.setattr(parity, "load_dataset", lambda name: (
        lambda r: (r[0], *(x[:n] for x in r[1:4]), *r[4:]))(load(name)))
    monkeypatch.setattr(parity, "load_longn", lambda: (
        lambda r: (*(x[:n] for x in r[:3]), *r[3:]))(load_longn()))


def test_parity_entries_carry_the_jax_keys(tmp_path, monkeypatch):
    _cut_loaders(monkeypatch)
    out = str(tmp_path / "parity")
    small = ["--samplers", "smc", "--particles", "64", "--moves", "2", "--out", out]
    rc = parity.main(["--datasets", "single,longn", *small], device="cpu")
    with open(os.path.join(out, "summary.json")) as fh:
        summary = json.load(fh)
    assert rc == (0 if all(e["pass"] for e in summary["runs"].values()) else 1)
    assert set(summary) == {"platform", "device_kind", "power_limit", "torch_version",
                            "dtype", "seed", "particles", "runs"}
    assert summary["platform"] == "cpu" and summary["dtype"] == "float32"
    with open(os.path.join(ROOT, "artifacts", "tpu_parity", "summary.json")) as fh:
        committed = json.load(fh)["runs"]
    assert sorted(summary["runs"]) == ["longn_smc", "single_smc"]
    for tag, entry in summary["runs"].items():
        assert set(entry) == set(committed[tag]), tag
        for rel in (("chains", "equal_weighted_post.txt"), ("info", "results.json")):
            assert os.path.isfile(os.path.join(out, tag, *rel))
    # a later call on the same platform merges its runs into the summary
    parity.main(["--datasets", "docs", *small], device="cpu")
    with open(os.path.join(out, "summary.json")) as fh:
        merged = json.load(fh)["runs"]
    assert sorted(merged) == ["docs_smc", "longn_smc", "single_smc"]
    # the committed docs entry predates the JAX script's pull_tol_effective
    # and width_gate_referee; with its referee docs gets single's keys
    assert set(merged["docs_smc"]) == set(committed["single_smc"])


def test_parity_without_tests_data_says_so(tmp_path, monkeypatch):
    monkeypatch.setattr(parity, "TESTDATA", str(tmp_path / "missing"))
    with pytest.raises(FileNotFoundError, match="tests/data"):
        parity.load_dataset("single")
