"""Validate the COMMITTED H100 parity artifacts of the PyTorch port
against the reference's stored ultranest baselines and the
importance-sampling referees.

``artifacts/torch_parity/`` holds ``summary.json`` and each run's
``chains/equal_weighted_post.txt`` and ``info/results.json``, produced on
one NVIDIA H100 in float32 by

    python -m pioran_tpu_torch.examples.parity \\
        --datasets single,double,periodic,docs,carma,longn --samplers ns,smc
    python -m pioran_tpu_torch.examples.parity --datasets single --samplers chees

This mirrors ``tests/test_tpu_artifacts.py``. Every gate is recomputed
from the run's own files, the stored baselines (``tests/data/*``) and the
JAX script's tolerances (``examples/tpu_parity.py``), not read from the
summary alone; the maximum-likelihood points recompute on the CPU in
float64 through the port's plain loop and through the JAX package.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pioran_tpu import inference as jinf
from pioran_tpu_torch import inference as tinf

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(ROOT, "artifacts", "torch_parity")
DATA = os.path.join(ROOT, "tests", "data")


def _jax_script():
    """``examples/tpu_parity.py`` as a module (its DATASETS and loaders;
    nothing of JAX is imported at its top level)."""
    spec = importlib.util.spec_from_file_location(
        "_jax_tpu_parity", os.path.join(ROOT, "examples", "tpu_parity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_PARITY = _jax_script()
DATASETS = JAX_PARITY.DATASETS
RUNS = [(name, sampler) for name in ("single", "double", "periodic", "docs")
        for sampler in ("ns", "smc")]


@pytest.fixture(scope="module")
def summary():
    with open(os.path.join(ART, "summary.json")) as fh:
        return json.load(fh)


def _run(tag):
    """(results.json, the equal-weighted posterior) of a committed run."""
    with open(os.path.join(ART, tag, "info", "results.json")) as fh:
        res = json.load(fh)
    theta = np.loadtxt(os.path.join(ART, tag, "chains", "equal_weighted_post.txt"),
                       skiprows=1)
    return res, theta


def _check_files(res, theta, entry):
    """The summary entry, results.json and the posterior file agree (no
    hand-edited summaries)."""
    if entry["logz"] is None:
        assert res.get("logz") is None
    else:
        assert res["logz"] == pytest.approx(entry["logz"], abs=1e-6)
    assert res["maximum_likelihood"]["logl"] == pytest.approx(entry["ml_logl"], abs=1e-9)
    assert theta.shape[1] == len(res["paramnames"])
    mean, want = theta.mean(axis=0), np.asarray(res["posterior"]["mean"])
    if theta.shape[0] < 20000:  # every draw is in the file; a float32 mean
        np.testing.assert_allclose(mean, want, rtol=1e-5, atol=1e-9)
    else:  # a subsample of 20,000 draws
        std = np.asarray(res["posterior"]["stdev"])
        assert np.all(np.abs(mean - want) <= 5.0 * std / np.sqrt(theta.shape[0]))


def test_artifacts_are_from_an_h100_in_float32(summary):
    assert summary["platform"] == "gpu", summary["platform"]
    assert "H100" in summary["device_kind"], summary["device_kind"]
    assert summary["dtype"] == "float32"
    assert summary["power_limit"].endswith(" W"), summary["power_limit"]
    assert summary["torch_version"]
    expected = {f"{n}_{s}" for n, s in RUNS} | {"carma_ns", "carma_smc", "longn_smc",
                                                 "single_chees"}
    assert set(summary["runs"]) == expected


def _referee(name):
    path = os.path.join(DATA, DATASETS[name]["dir"], "is_referee.json")
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        ref = json.load(fh)
    return ref if ref.get("ess", 0.0) > 500.0 else None


def _gates(name, res, entry):
    """The parity gates of examples/tpu_parity.py, recomputed from the
    run's results.json, the stored baseline and the referee."""
    cfg = DATASETS[name]
    with open(os.path.join(DATA, cfg["dir"], "results.json")) as fh:
        stored = json.load(fh)
    mean = np.asarray(res["posterior"]["mean"])
    std = np.asarray(res["posterior"]["stdev"])
    inv = np.argsort(cfg["perm"])
    ref_mean = np.asarray(stored["posterior"]["mean"])
    ref_std = np.asarray(stored["posterior"]["stdev"])
    pulls = np.abs(mean[inv] - ref_mean) / ref_std
    np.testing.assert_allclose(pulls, entry["pulls"], atol=1e-4)
    if res.get("logz") is not None:
        logz_diff = res["logz"] - stored["logz"]
        assert abs(logz_diff) < cfg["logz_tol"], logz_diff
    referee = _referee(name)
    tol = cfg["pull_tol"] + (float(referee["max_stored_pull"]) if referee else 0.0)
    assert entry["pull_tol_effective"] == pytest.approx(tol)
    assert pulls.max() < tol, (pulls, tol)
    # the stored runs are underdispersed (the referee showed simu_single's
    # f1 width at 0.61x the true one), so the stored width ratio is a
    # loose sanity bound only
    wr = std[inv] / ref_std
    assert np.all((wr > 0.5) & (wr < 2.0)), wr
    if referee is not None:
        is_mean, is_std = np.asarray(referee["is_mean"]), np.asarray(referee["is_std"])
        pull_ref = np.abs(mean - is_mean) / is_std
        np.testing.assert_allclose(pull_ref, entry["pull_vs_referee"], atol=1e-4)
        assert pull_ref.max() < 0.5, pull_ref
        # [0.8, 1.25] widened by 3 IS standard errors of the referee's
        # own width estimate
        rse = 3.0 / np.sqrt(2.0 * float(referee["ess"]))
        w_lo, w_hi = 0.8 * (1.0 - rse), 1.25 * (1.0 + rse)
        wrr = std / is_std
        assert np.all((wrr > w_lo) & (wrr < w_hi)), (wrr, w_lo, w_hi)


@pytest.mark.parametrize("name,sampler", RUNS)
def test_parity_gates(summary, name, sampler):
    tag = f"{name}_{sampler}"
    entry = summary["runs"][tag]
    res, theta = _run(tag)
    _check_files(res, theta, entry)
    assert entry["dataset"] == name and entry["sampler"] == sampler
    _gates(name, res, entry)
    if sampler == "ns":
        # the insertion-rank uniformity diagnostic (ultranest's field)
        assert entry["insertion_order_MWW_test"]["converged"], entry[
            "insertion_order_MWW_test"]
    assert entry["pass"], entry


def test_chees_gradient_path_referee_gates(summary):
    """ChEES from dispersed ADVI inits with the dense metric on
    simu_single (512 chains, 500 + 300): the referee gates of the NS/SMC
    runs, recomputed."""
    entry = summary["runs"]["single_chees"]
    res, theta = _run("single_chees")
    _check_files(res, theta, entry)
    assert entry["init"] == "advi-dispersed" and entry["mass"] == "dense"
    assert entry["num_chains"] == 512
    rhat = np.asarray(res["rhat"], np.float64)
    assert float(np.nanmax(rhat)) == pytest.approx(entry["rhat_max"])
    _gates("single", res, entry)


@pytest.mark.xfail(strict=True, reason=(
    "ROADMAP §3, reference behaviour the port matches, which its gates cannot "
    "hold: ChEES (512 chains, 500 + 300, dense metric, ADVI inits) reads "
    "split-r̂_max 1.0536 (α₂) on the H100, over examples/tpu_parity.py's 1.02 "
    "gate; its transition is in lock-step with the JAX package's "
    "(tests/test_torch_chees_lockstep.py) and seeds 0-7 read 1.022-1.116"))
def test_chees_gradient_path_converges(summary):
    """The ChEES leg's split-r̂ <= 1.02 over every parameter, the JAX
    script's convergence gate, and with it the run's pass."""
    entry = summary["runs"]["single_chees"]
    assert entry["rhat_max"] <= 1.02, entry["rhat_max"]
    assert entry["pass"], entry


def test_carma_cross_sampler_gates(summary):
    """CARMA(2,1): NS and SMC agree on logZ and on every posterior moment
    (no stored reference posterior exists for CARMA)."""
    runs = {s: _run(f"carma_{s}") for s in ("ns", "smc")}
    for s, (res, theta) in runs.items():
        _check_files(res, theta, summary["runs"][f"carma_{s}"])
    (rn, _), (rs, _) = runs["ns"], runs["smc"]
    m_ns, m_smc = np.asarray(rn["posterior"]["mean"]), np.asarray(rs["posterior"]["mean"])
    s_ns, s_smc = np.asarray(rn["posterior"]["stdev"]), np.asarray(rs["posterior"]["stdev"])
    pull = np.abs(m_ns - m_smc) / np.sqrt(s_ns**2 + s_smc**2)
    ratio = s_ns / s_smc
    assert abs(rn["logz"] - rs["logz"]) < 1.5
    assert pull.max() < 0.5, pull
    assert np.all((ratio > 0.75) & (ratio < 1.33)), ratio
    for s in ("ns", "smc"):
        entry = summary["runs"][f"carma_{s}"]
        np.testing.assert_allclose(entry["cross_sampler_pulls"], pull, atol=1e-4)
        assert entry["pq"] == [2, 1] and entry["pass"], entry


def test_longn_covers_the_truth(summary):
    entry = summary["runs"]["longn_smc"]
    res, theta = _run("longn_smc")
    _check_files(res, theta, entry)
    *_, truth = _longn()
    tv = np.asarray([truth["alpha1"], truth["alpha2"], truth["f1"], truth["variance"],
                     truth["nu"], truth["mu"]])
    pull = np.abs(np.asarray(res["posterior"]["mean"]) - tv) / np.asarray(
        res["posterior"]["stdev"])
    np.testing.assert_allclose(pull, entry["pull_vs_truth"], atol=1e-3)
    assert pull.max() < 4.0, pull
    assert entry["pass"], entry


def _longn():
    """The long-N curve as tests/data holds it: (A, xbar, va, truth)."""
    path = os.path.join(DATA, "simu_longn", "longn_time_series.txt")
    truth, xbar, va = {}, None, None
    with open(path) as fh:
        for line in fh:
            if line.startswith("#truth: "):
                for kv in line[len("#truth: "):].split():
                    k, v = kv.split("=")
                    truth[k] = float(v)
            elif line.startswith("#mean: "):
                left, right = line[len("#mean: "):].split(" va: ")
                xbar, va = float(left), float(right)
    return np.loadtxt(path), xbar, va, truth


def _subset():
    path = os.path.join(DATA, "simu_single", "simu_single_subset_time_series.txt")
    with open(path) as fh:
        for line in fh:
            if line.startswith("#mean: "):
                left, right = line[len("#mean: "):].split(" va: ")
                xbar, va = float(left), float(right)
                break
    A = np.loadtxt(path)
    return A[:, 0], A[:, 1], A[:, 2], xbar, va


# (run, builder name, builder kwargs, tolerance in nats): the artifact's
# logl is a float32 evaluation on the card; float64 on the CPU differs by
# about 0.05-0.1 nats at logL ~ 1e3 over 485 steps, and more over 2^14
ML_CASES = {
    "single_ns": ("single_bending_model", {}, 0.3),
    "carma_ns": ("carma_model", {"p": 2, "q": 1}, 0.3),
    "longn_smc": ("single_bending_model", {}, 1.0),
}


@pytest.mark.parametrize("package", ["port", "jax"])
@pytest.mark.parametrize("run", sorted(ML_CASES))
def test_ml_point_recomputes_in_float64(summary, run, package):
    """The committed maximum-likelihood point's log-likelihood, on the CPU
    in float64: through the port's plain loop and through the JAX
    package, each within the tolerance of the artifact's float32 value."""
    builder, kw, tol = ML_CASES[run]
    if run == "longn_smc":
        A, xbar, va, _ = _longn()
        data = (A[:, 0], A[:, 1], A[:, 2], xbar, va)
    else:
        data = _subset()
    res, _ = _run(run)
    point = res["maximum_likelihood"]["point"]
    if package == "port":
        spec = getattr(tinf, builder)(*data, device="cpu", dtype=torch.float64, **kw)
        ll = float(spec.loglike(torch.as_tensor(point, dtype=torch.float64)))
    else:
        spec = getattr(jinf, builder)(*data, **kw)
        ll = float(jax.jit(spec.loglike)(jnp.asarray(point)))
    assert abs(ll - res["maximum_likelihood"]["logl"]) < tol, (
        ll, res["maximum_likelihood"]["logl"])
    assert summary["runs"][run]["ml_logl"] == pytest.approx(res["maximum_likelihood"]["logl"])
