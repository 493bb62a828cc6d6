"""Prior predictive checks of the PSD approximation quality, PyTorch port
of ``pioran_tpu.diagnostics.approx_checks`` (reference
src/plots_diagnostics.jl:1-240).

The per-sample loops become one batched computation over prior draws on
the device; matplotlib renders host-side and is imported only when
figures are asked for; the txt artifacts keep the reference's filenames
and column layouts (they double as regression baselines, reference
test/plots/*.txt).
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from ..config import DEFAULT_DTYPE, resolve_device
from ..ops.approx import approximated_psd

__all__ = ["sample_approx_model", "run_diagnostics"]

QUANTS = np.array([0.025, 0.16, 0.5, 0.84, 0.975])


def sample_approx_model(
    samples,
    norm_samples,
    f0,
    fM,
    model: Callable,
    n_frequencies: int = 1000,
    basis_function: str = "SHO",
    n_components: int = 20,
    device=None,
    dtype: torch.dtype = DEFAULT_DTYPE,
):
    """psd / approx / residual / ratio tensors over prior samples.

    ``samples``: (P, k) PSD parameters; ``model(*columns)`` builds one
    batched PSD from its k (P,) columns. Returns (psd, psd_approx,
    residuals, ratios, f) with shape (n_frequencies, P) like the
    reference (plots_diagnostics.jl:195-229), as tensors on ``device``
    (the card unless ``device="cpu"``) in ``dtype``.
    """
    dev = resolve_device(device)
    cols = torch.atleast_2d(torch.as_tensor(samples, dtype=dtype, device=dev)).unbind(-1)
    norm = torch.as_tensor(norm_samples, dtype=dtype, device=dev).reshape(-1)
    f = 10.0 ** torch.linspace(np.log10(f0), np.log10(fM), n_frequencies, dtype=dtype,
                               device=dev)
    psd_model = model(*cols)
    p = psd_model(f)
    p = p / p[..., :1] * norm[:, None]
    pa = approximated_psd(f, psd_model, f0, fM, n_components=n_components, norm=norm,
                          basis_function=basis_function)
    psd, psd_approx = p.T, pa.T
    return psd, psd_approx, psd - psd_approx, psd_approx / psd, f


def run_diagnostics(
    prior_samples,
    norm_samples,
    f_min,
    f_max,
    model: Callable,
    S_low: float = 20.0,
    S_high: float = 20.0,
    path: str = "",
    basis_function: str = "SHO",
    n_components: int = 20,
    make_figures: bool = True,
    device=None,
    dtype: torch.dtype = DEFAULT_DTYPE,
):
    """Prior predictive approximation diagnostics
    (reference plots_diagnostics.jl:232-240).

    Writes mean_psd_approx.txt, quantiles_psd_approx.txt,
    boxplot_psd_approx.txt (+ .png figures with ``make_figures``, which
    needs matplotlib). ``prior_samples``: (k, P) like the reference
    (rows = parameters). Computes on ``device`` (the card unless
    ``device="cpu"``) in ``dtype``; returns (figures, psd, psd_approx,
    f) as numpy arrays.
    """
    if path:
        os.makedirs(path, exist_ok=True)
    f0, fM = f_min / S_low, f_max * S_high
    prior_samples = np.atleast_2d(np.asarray(prior_samples))
    psd, psd_approx, residuals, ratios, f = sample_approx_model(
        prior_samples.T, norm_samples, f0, fM, model,
        basis_function=basis_function, n_components=n_components, device=device,
        dtype=dtype,
    )
    psd, psd_approx, residuals, ratios, f = (
        x.cpu().numpy() for x in (psd, psd_approx, residuals, ratios, f))

    # ---- mean over samples (plot_mean_approx, :144-170) ----
    mean_res = residuals.mean(axis=1)
    mean_rat = ratios.mean(axis=1)
    _write(path, "mean_psd_approx.txt",
           "# Mean residuals and ratios for the PSD approximation\n# f, mean_res, mean_rat\n",
           np.column_stack([f, mean_res, mean_rat]))

    # ---- quantiles over samples (plot_quantiles_approx, :83-141) ----
    res_q = np.quantile(residuals, QUANTS, axis=1)
    rat_q = np.quantile(ratios, QUANTS, axis=1)
    header = (
        "# Quantiles of the residuals and ratios for the PSD approximation\n"
        f"#f_min: {f_min}, f_max: {f_max}\n# f, res_quantiles, rat_quantiles\n"
    )
    _write(path, "quantiles_psd_approx.txt", header,
           np.column_stack([f, *res_q, *rat_q]))

    # ---- per-sample meta stats (plot_boxplot_psd_approx, :37-76) ----
    meta = np.column_stack([
        residuals.mean(axis=0), np.median(residuals, axis=0),
        np.abs(residuals).min(axis=0), np.abs(residuals).max(axis=0),
        ratios.mean(axis=0), np.median(ratios, axis=0),
        np.abs(ratios).min(axis=0), np.abs(ratios).max(axis=0),
    ])
    _write(path, "boxplot_psd_approx.txt",
           "# Boxplot of the residuals and ratios for the PSD approximation\n"
           "# meta_mean, meta_median, meta_min, meta_max, meta_mean_rat, meta_median_rat, meta_min_rat, meta_max_rat\n",
           meta)

    figs = []
    if make_figures:
        figs = _figures(f, f_min, f_max, mean_res, mean_rat, res_q, rat_q, meta, path)
    return figs, psd, psd_approx, f


def _write(path, name, header, data):
    with open(os.path.join(path, name) if path else name, "w") as fh:
        fh.write(header)
        np.savetxt(fh, data)


def _figures(f, f_min, f_max, mean_res, mean_rat, res_q, rat_q, meta, path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    figs = []
    # mean
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
    ax1.semilogx(f, mean_res); ax1.axhline(0, color="r", ls="--")
    ax1.set_ylabel("Residuals")
    ax2.semilogx(f, mean_rat); ax2.axhline(1, color="r", ls="--")
    ax2.set_ylabel("Ratios"); ax2.set_xlabel("Frequency")
    fig.savefig(os.path.join(path, "diagnostics_psd_approx.png"), dpi=100)
    figs.append(fig)

    # quantiles
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
    for ax, q, ref in ((ax1, res_q, 0.0), (ax2, rat_q, 1.0)):
        ax.semilogx(f, q[2], label="Median")
        ax.fill_between(f, q[0], q[4], alpha=0.2, label="95%")
        ax.fill_between(f, q[1], q[3], alpha=0.4, label="68%")
        ax.axhline(ref, color="r", ls="--")
        for x in (f_min, f_max):
            ax.axvline(x, color="k", ls="--")
    ax1.set_ylabel("Residuals"); ax2.set_ylabel("Ratios")
    ax2.set_xlabel("Frequency"); ax1.legend(ncol=3, fontsize=8)
    fig.savefig(os.path.join(path, "quantiles_psd_approx.png"), dpi=100)
    figs.append(fig)

    # boxplots
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 6))
    labels = ["mean", "median", "min", "max"]
    ax1.boxplot([meta[:, i] for i in range(4)], tick_labels=labels)
    ax1.set_ylabel("Residuals")
    ax2.boxplot([meta[:, 4 + i] for i in range(4)], tick_labels=labels)
    ax2.set_ylabel("Ratios")
    fig.savefig(os.path.join(path, "boxplot_psd_approx.png"), dpi=100)
    figs.append(fig)
    plt.close("all")
    return figs
