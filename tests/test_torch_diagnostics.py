"""PyTorch port parity: the post-fit diagnostics (``diagnostics/``),
``ops.approx.approximated_psd`` and the sample utilities against the JAX
package's (CPU, float64).

The deterministic artifacts of the approximation checks and the
posterior predictive checks are held against the JAX package's files on
the same samples; the stochastic ones (simulated periodograms and
posterior time series, whose draws come from other generators) are
checked for shape and finite values, as the JAX package's own test
checks them (tests/test_diagnostics.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pioran_tpu import SingleBendingPowerLaw as JSBPL, approximated_psd as japprox_psd
from pioran_tpu.diagnostics import lsp as jlsp, approx_checks as jchecks, ppc as jppc
from pioran_tpu.utils import samples as jsamples, subset as jsubset
from pioran_tpu_torch import SingleBendingPowerLaw, ScalableGP, approx, approximated_psd
from pioran_tpu_torch.diagnostics import (
    binned_lsp,
    lombscargle,
    plot_psd_ppc_carma,
    run_diagnostics,
    run_posterior_predict_checks,
)
from pioran_tpu_torch.utils import samples as tsamples, subset as tsubset

torch.set_num_threads(1)

PPC_FILES = ("psd_ppc_data.txt", "psd_noise_levels.txt", "lsp_ppc_data.txt",
             "binned_lsp_data.txt", "ppc_timeseries_quantiles.txt",
             "ppc_residuals_quantiles.txt", "ppc_residuals_mean.txt", "ppc_t_pred.txt",
             "ppc_residuals_acvf.txt", "psd_ppc.png", "LSP_ppc.png", "TS_ppc.png",
             "residuals_diagnostics.png")


def _rel(x, ref):
    x, ref = np.asarray(x), np.asarray(ref)
    return float(np.max(np.abs(x - ref)) / np.max(np.abs(ref)))


def test_lombscargle_matches_jax():
    """Three realisations at once, with per-row and shared errors,
    against the JAX periodogram of each, 1e-10; binned_lsp of one."""
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0.0, 100.0, 80))
    y = np.sin(2 * np.pi * 0.3 * t) + 0.5 * rng.normal(size=(3, 80))
    yerr = rng.uniform(0.3, 0.6, (3, 80))
    freqs = np.exp(np.linspace(np.log(0.005), np.log(2.0), 200))
    jfn = jax.jit(jlsp.lombscargle)
    for err in (yerr, yerr[0]):
        ours = lombscargle(*(torch.as_tensor(x) for x in (t, y, err, freqs))).numpy()
        assert ours.shape == (3, 200)
        for i in range(3):
            ref = np.asarray(jfn(*(jnp.asarray(x) for x in (t, y[i], np.broadcast_to(
                err, y.shape)[i], freqs))))
            assert _rel(ours[i], ref) <= 1e-10
    for x, r in zip(binned_lsp(freqs, ours[0]), jlsp.binned_lsp(freqs, ours[0])):
        np.testing.assert_array_equal(x, r)


@pytest.mark.parametrize("basis", ["SHO", "DRWCelerite"])
def test_approximated_psd_matches_jax(basis):
    """Batched over three PSD parameter rows and their norms, summed and
    term by term, against the JAX package row by row, 1e-10."""
    rows = np.array([[0.5, 0.01, 2.8], [1.1, 0.05, 3.4], [0.2, 0.002, 2.1]])
    norms = np.array([0.02, 1.0, 0.3])
    f = np.exp(np.linspace(np.log(1e-4), np.log(20.0), 300))
    model = SingleBendingPowerLaw(*(torch.as_tensor(c) for c in rows.T))
    ours = approximated_psd(torch.as_tensor(f), model, 1e-4, 20.0, n_components=20,
                            norm=torch.as_tensor(norms), basis_function=basis)
    terms = approximated_psd(torch.as_tensor(f), model, 1e-4, 20.0, n_components=20,
                             norm=torch.as_tensor(norms), basis_function=basis,
                             individual=True)
    assert ours.shape == (3, 300) and terms.shape == (3, 300, 20)
    jfn = jax.jit(lambda r, n: japprox_psd(jnp.asarray(f), JSBPL(*r), 1e-4, 20.0,
                                           n_components=20, norm=n, basis_function=basis,
                                           individual=True))
    for i in range(3):
        ref = np.asarray(jfn(jnp.asarray(rows[i]), norms[i]))
        assert _rel(terms[i].numpy(), ref) <= 1e-10
        assert _rel(ours[i].numpy(), ref.sum(-1)) <= 1e-10


def test_run_diagnostics_matches_jax(tmp_path):
    """run_diagnostics on the JAX test's prior samples: the three text
    artifacts within 1e-8 of the JAX package's files, and the figures."""
    rng = np.random.default_rng(2)
    P = 20
    prior = np.vstack([rng.uniform(0.1, 1.0, P), 10 ** rng.uniform(-2, -1, P),
                       rng.uniform(2.0, 3.5, P)])
    norms = 10 ** rng.uniform(-2, 0, P)
    ours, ref = str(tmp_path / "port") + "/", str(tmp_path / "jax") + "/"
    _, psd, psd_approx, f = run_diagnostics(prior, norms, 1e-3, 1e1, SingleBendingPowerLaw,
                                            path=ours, make_figures=True, device="cpu")
    assert psd.shape == psd_approx.shape == (1000, P) and f.shape == (1000,)
    jchecks.run_diagnostics(prior, norms, 1e-3, 1e1, JSBPL, path=ref, make_figures=False)
    for name in ("mean_psd_approx.txt", "quantiles_psd_approx.txt",
                 "boxplot_psd_approx.txt"):
        x, r = np.loadtxt(ours + name), np.loadtxt(ref + name)
        assert x.shape == r.shape and np.all(np.isfinite(x))
        assert _rel(x, r) <= 1e-8, name
    for name in ("diagnostics_psd_approx.png", "quantiles_psd_approx.png",
                 "boxplot_psd_approx.png"):
        assert os.path.exists(ours + name), name


def _ppc_inputs(simu_log_data):
    """The JAX test's inputs: the first 80 points, 12 posterior rows."""
    t, y, yerr = simu_log_data
    t, y, yerr = t[:80], np.exp(y[:80]), yerr[:80]
    rng = np.random.default_rng(3)
    P = 12
    samples = np.column_stack([
        rng.uniform(0.3, 1.0, P), 10 ** rng.uniform(-2.3, -1.7, P),
        rng.uniform(2.5, 3.2, P), 10 ** rng.uniform(-1.8, -1.2, P),
        rng.uniform(0.8, 1.3, P), rng.normal(1.55, 0.05, P),
    ])
    names = ["a1", "f1", "a2", "variance", "nu", "mu"]
    split = {"psd": ["a1", "f1", "a2"], "norm": "variance",
             "scale_err": "nu", "mean": "mu", "log_transform": "c"}
    return t, y, yerr, samples, names, split


def test_run_posterior_predict_checks(tmp_path, simu_log_data):
    """The three checks with figures on the JAX test's inputs: all 13
    artifacts; the PSD check's files within 1e-8 of the JAX package's;
    the stochastic files of the right shapes, finite, with standardized
    residuals of order 1."""
    t, y, yerr, samples, names, split = _ppc_inputs(simu_log_data)
    f_min, f_max = 1.0 / (t[-1] - t[0]), 1.0 / np.min(np.diff(t)) / 2.0

    def gp_model(tt, yy, ee, params):  # (P, 6) rows -> one batched GP
        kern = approx(SingleBendingPowerLaw(params[:, 0], params[:, 1], params[:, 2]),
                      f_min, f_max, 20, params[:, 3])
        return ScalableGP(params[:, 5:6], kern)(tt, params[:, 4:5] * ee**2 / yy**2)

    ours, ref = str(tmp_path / "port") + "/", str(tmp_path / "jax") + "/"
    run_posterior_predict_checks(samples, names, split, t, y, yerr, SingleBendingPowerLaw,
                                 gp_model, True, n_samples=12, path=ours,
                                 generator=torch.Generator().manual_seed(0), device="cpu")
    for name in PPC_FILES:
        assert os.path.exists(ours + name), name
    jppc.run_posterior_predict_checks(samples, names, split, t, y, yerr, JSBPL, None, True,
                                      plots=["psd"], path=ref, make_figures=False)
    for name in ("psd_ppc_data.txt", "psd_noise_levels.txt"):
        assert _rel(np.loadtxt(ours + name), np.loadtxt(ref + name)) <= 1e-8, name
    # the data grid and 160 even points, the shared end points once
    t_pred = np.sort(np.unique(np.concatenate([t, np.linspace(t[0], t[-1], 160)])))
    np.testing.assert_array_equal(np.loadtxt(ours + "ppc_t_pred.txt"), t_pred)
    shapes = {"psd_ppc_data.txt": (11, 1000), "lsp_ppc_data.txt": (6, 999),
              "binned_lsp_data.txt": (99, 2), "ppc_timeseries_quantiles.txt": (5, 238),
              "ppc_residuals_quantiles.txt": (5, 80), "ppc_residuals_mean.txt": (80,),
              "ppc_t_pred.txt": (238,), "ppc_residuals_acvf.txt": (3, 9)}
    for name, shape in shapes.items():
        x = np.loadtxt(ours + name)
        assert x.shape == shape and np.all(np.isfinite(x)), name
    assert np.abs(np.loadtxt(ours + "ppc_residuals_mean.txt")).mean() < 5.0


def test_psd_ppc_carma_matches_jax(tmp_path, simu_log_data):
    """The CARMA(3, 1) posterior predictive PSD on batched roots (the
    real path) against the JAX package's complex path, 1e-8."""
    t, y, yerr = simu_log_data
    t, y, yerr = t[:80], np.exp(y[:80]), yerr[:80]
    rng = np.random.default_rng(4)
    P = 6
    re = -rng.uniform(0.02, 0.5, (P, 2))
    im = rng.uniform(0.01, 0.8, P)
    roots = np.column_stack([re[:, 0] + 1j * im, re[:, 0] - 1j * im, re[:, 1]])
    beta = np.column_stack([np.ones(P), rng.uniform(0.1, 5.0, P)])
    norm = 10 ** rng.uniform(-2, 0, P)
    nu = rng.uniform(0.8, 1.2, P)
    ours, ref = str(tmp_path / "port") + "/", str(tmp_path / "jax") + "/"
    plot_psd_ppc_carma(roots, beta, norm, nu, t, y, yerr, 3, 1, path=ours,
                       with_log_transform=True, make_figures=False, device="cpu")
    jppc.plot_psd_ppc_carma(roots, beta, norm, nu, t, y, yerr, 3, 1, path=ref,
                            with_log_transform=True, make_figures=False)
    for name in ("psd_ppc_data.txt", "psd_noise_levels.txt"):
        assert _rel(np.loadtxt(ours + name), np.loadtxt(ref + name)) <= 1e-8, name


def test_extract_subset_and_separate_samples_match_jax(tmp_path):
    """extract_subset: the same kept points, estimates and cache file as
    the JAX package's, and each reads the other's cache;
    separate_samples and makelist_namessplit: the same columns."""
    rng = np.random.default_rng(5)
    t = np.sort(rng.uniform(0.0, 100.0, 200))
    y, yerr = rng.uniform(1.0, 3.0, 200), rng.uniform(0.05, 0.1, 200)
    ours = tsubset.extract_subset(7, str(tmp_path / "port" / "lc"), t, y, yerr)
    ref = jsubset.extract_subset(7, str(tmp_path / "jax" / "lc"), t, y, yerr)
    for x, r in zip(ours, ref):
        np.testing.assert_array_equal(x, r)
    with open(tmp_path / "port" / "lc_subset_time_series.txt") as a, \
            open(tmp_path / "jax" / "lc_subset_time_series.txt") as b:
        assert a.read() == b.read()
    cached = tsubset.extract_subset(99, str(tmp_path / "jax" / "lc"), t, y, yerr)
    for x, r in zip(cached, ref):
        np.testing.assert_array_equal(x, r)

    samples = rng.normal(size=(10, 5))
    names = ["a1", "f1", "variance", "nu", "mu"]
    for split in ({"psd": ["a1", "f1"], "norm": "variance", "scale_err": "nu", "mean": "mu"},
                  {"psd": ["a1", "f1"], "norm": "variance", "log_transform": "c"}):
        assert tsamples.makelist_namessplit(split) == jsamples.makelist_namessplit(split)
        for x, r in zip(tsamples.separate_samples(samples, names, split),
                        jsamples.separate_samples(samples, names, split)):
            np.testing.assert_array_equal(x, r)
