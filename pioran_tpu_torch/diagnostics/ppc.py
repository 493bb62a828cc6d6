"""Posterior predictive checks (PSD bands, Lomb-Scargle PPC, time series),
PyTorch port of ``pioran_tpu.diagnostics.ppc`` (reference
src/plots_diagnostics.jl:243-937).

The reference loops over 100-1000 posterior samples re-running the model
per sample; the JAX package maps a one-draw function over them; here each
check is one batched computation over the draws on the device: the
``gp_model`` callable takes all the draws' parameters at once and returns
one batched :class:`~pioran_tpu_torch.models.gp.ConditionedGP`. On the
card its prior draws and posterior solves run through the hand-written
kernels K3/K4 (``ops.celerite``). Figures render host-side with
matplotlib, imported only when ``make_figures`` asks for them; the txt
artifacts keep the reference's filenames and column layouts.

The entry points take ``device`` (the card unless ``device="cpu"``),
``dtype`` (float64 by default) and a ``torch.Generator`` ``generator``
on that device for the stochastic checks (a new one seeded with 0 for
the Lomb-Scargle check and 1 for the time series when omitted, the seeds
of the JAX package's default keys).
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from ..config import DEFAULT_DTYPE, resolve_device
from ..models.carma import carma_psd_real
from ..models.gp import posterior as gp_posterior
from ..ops.approx import get_approx_coefficients, get_norm_psd, spectral_grid
from ..utils.samples import separate_samples
from .approx_checks import sample_approx_model
from .lsp import binned_lsp, lombscargle

__all__ = [
    "run_posterior_predict_checks",
    "plot_psd_ppc",
    "plot_lsp_ppc",
    "plot_ppc_timeseries",
    "plot_psd_ppc_carma",
]

QUANTS = np.array([0.025, 0.16, 0.5, 0.84, 0.975])


def _write(path, name, header, data):
    with open(os.path.join(path, name) if path else name, "w") as fh:
        fh.write(header)
        np.savetxt(fh, np.asarray(data))


def _noise_levels(t, y, yerr, samples_nu, with_log_transform):
    """Periodogram noise levels 2 nu <sigma^2> <dt>
    (reference plots_diagnostics.jl:396-397)."""
    t, y, yerr, nu = (_numpy(x) for x in (t, y, yerr, samples_nu))
    dt = np.diff(t)
    sq = (yerr / y) ** 2 if with_log_transform else yerr ** 2
    mean_nl = 2.0 * nu.mean() * sq.mean() * dt.mean()
    med_nl = 2.0 * np.median(nu) * np.median(sq) * np.median(dt)
    return mean_nl, med_nl


def _numpy(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _band(t):
    """(f_min, f_max) of the light curve's grid."""
    tn = _numpy(t)
    return 1.0 / (tn[-1] - tn[0]), 1.0 / np.min(np.diff(tn)) / 2.0


def _tensors(dev, dtype, *xs):
    return [torch.as_tensor(x, dtype=dtype, device=dev) for x in xs]


def plot_psd_ppc(
    samples_psd,
    samples_norm,
    samples_nu,
    t,
    y,
    yerr,
    model: Callable,
    S_low: float = 20.0,
    S_high: float = 20.0,
    path: str = "",
    n_components: int = 20,
    basis_function: str = "SHO",
    is_integrated_power: bool = True,
    n_frequencies: int = 1000,
    with_log_transform: bool = False,
    plot_f_P: bool = False,
    save_samples: bool = False,
    make_figures: bool = True,
    device=None,
    dtype: torch.dtype = DEFAULT_DTYPE,
):
    """Posterior predictive PSD with noise levels
    (reference plots_diagnostics.jl:371-489).

    ``samples_psd``: (P, k) posterior PSD parameters (rows = draws);
    ``model(*columns)`` builds one batched PSD from its k (P,) columns.
    """
    if path:
        os.makedirs(path, exist_ok=True)
    dev = resolve_device(device)
    f_min, f_max = _band(t)
    f0, fM = f_min / S_low, f_max * S_high

    mean_nl, med_nl = _noise_levels(t, y, yerr, samples_nu, with_log_transform)

    (samples_psd,) = _tensors(dev, dtype, samples_psd)
    samples_psd = torch.atleast_2d(samples_psd)
    psd, psd_approx, _, _, f = sample_approx_model(
        samples_psd, samples_norm, f0, fM, model,
        n_frequencies=n_frequencies, basis_function=basis_function,
        n_components=n_components, device=dev, dtype=dtype,
    )

    # normalise each draw by its band power so the plotted PSD integrates
    # to 1 on [f_min, f_max] (reference :399-409)
    points = spectral_grid(n_components, f0, fM, dtype, dev)
    amps = get_approx_coefficients(model(*samples_psd.unbind(-1)), f0, fM,
                                   n_components=n_components, basis_function=basis_function,
                                   dtype=dtype, device=dev)
    f_lo, f_hi = _tensors(dev, dtype, f_min, f_max)
    integ = get_norm_psd(amps, points, f_lo, f_hi, basis_function, is_integrated_power)
    psd_m = (psd / integ[None, :]).cpu().numpy()
    psd_approx_m = (psd_approx / integ[None, :]).cpu().numpy()
    f = f.cpu().numpy()

    if save_samples:
        _write(path, "psd_ppc_samples.txt",
               "# Posterior predictive power spectral density samples\n# f, psd, psd_approx\n",
               psd_m)

    scale = f[:, None] if plot_f_P else 1.0
    psd_q = np.quantile(scale * psd_m, QUANTS, axis=1)
    psd_approx_q = np.quantile(scale * psd_approx_m, QUANTS, axis=1)

    _write(path, "psd_noise_levels.txt",
           "# Noise levels\n# mean_noise_level, median_noise_level\n",
           np.array([mean_nl, med_nl]))
    hdr = ("# Posterior predictive power spectral density\n"
           "# quantiles=[0.025, 0.16, 0.5, 0.84, 0.975] \n# f, psd_quantiles, psd_approx_quantiles\n")
    if plot_f_P:
        hdr += "# f * PSD\n"
    _write(path, "psd_ppc_data.txt", hdr, np.vstack([f[None, :], psd_q, psd_approx_q]))

    if not make_figures:
        return None
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    ax.loglog(f, psd_q[2], color="b", label="Model Median")
    ax.fill_between(f, psd_q[0], psd_q[4], color="b", alpha=0.2, label="95%")
    ax.fill_between(f, psd_q[1], psd_q[3], color="b", alpha=0.4, label="68%")
    ax.loglog(f, psd_approx_q[2], color="r", label="Approx Median")
    ax.fill_between(f, psd_approx_q[0], psd_approx_q[4], color="r", alpha=0.2)
    ax.fill_between(f, psd_approx_q[1], psd_approx_q[3], color="r", alpha=0.4)
    nl_scale = f if plot_f_P else np.ones_like(f)
    ax.loglog(f, nl_scale * mean_nl, "k--", label="Mean noise level")
    ax.loglog(f, nl_scale * med_nl, "k-", label="Median noise level")
    for x in (f_min, f_max):
        ax.axvline(x, color="k", ls=":")
    ax.set_xlabel("Frequency"); ax.set_ylabel("f PSD" if plot_f_P else "PSD")
    ax.set_title("Posterior predictive power spectral density")
    ax.legend(ncol=3, fontsize=8)
    fig.savefig(os.path.join(path, "psd_ppc.png"), dpi=100)
    plt.close(fig)
    return fig


def plot_lsp_ppc(
    samples,
    t,
    y,
    yerr,
    gp_model: Callable,
    generator=None,
    S_low: float = 20.0,
    S_high: float = 20.0,
    n_frequencies: int = 1000,
    n_samples: int = 1000,
    bin_fact: int = 10,
    path: str = "",
    with_log_transform: bool = True,
    plot_f_P: bool = False,
    make_figures: bool = True,
    device=None,
    dtype: torch.dtype = DEFAULT_DTYPE,
):
    """Lomb-Scargle posterior predictive check
    (reference plots_diagnostics.jl:514-633).

    ``gp_model(t, y, yerr, params) -> ConditionedGP`` with ``params``
    (P, k): one batched GP over the first P = min(n_samples, rows)
    posterior draws; one realisation of each is simulated and its GLS
    periodogram computed, all batched on the device.
    """
    if path:
        os.makedirs(path, exist_ok=True)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    t, y, yerr = _tensors(dev, dtype, t, y, yerr)
    f_min, f_max = _band(t)
    f0, fM = f_min / S_low, f_max * S_high
    freq = torch.exp(torch.linspace(np.log(f0), np.log(fM), n_frequencies, dtype=dtype,
                                    device=dev))

    (samples,) = _tensors(dev, dtype, samples)
    P = min(n_samples, samples.shape[0])

    fx = gp_model(t, y, yerr, samples[:P])
    powers = lombscargle(t, fx.sample(generator), yerr, freq)  # (P, F)
    ls_array = powers.cpu().numpy().T[: n_frequencies - 1]
    freq_np = freq.cpu().numpy()[: n_frequencies - 1]

    scale = freq_np[:, None] if plot_f_P else 1.0
    ls_q = np.quantile(scale * ls_array, QUANTS, axis=1)

    # observed LSP (log-transform like the reference :566-572)
    if with_log_transform:
        obs_power = lombscargle(t, torch.log(y), yerr / y, freq)
    else:
        obs_power = lombscargle(t, y, yerr, freq)
    obs_power = obs_power.cpu().numpy()[: n_frequencies - 1]
    bf, bp = binned_lsp(freq_np, obs_power, bin_fact=bin_fact)
    if plot_f_P:
        bp = bp * bf

    _write(path, "lsp_ppc_data.txt",
           "# Posterior predictive Lomb-Scargle\n# quantiles=[0.025, 0.16, 0.5, 0.84, 0.975] \n# freq, ls_quantiles\n",
           np.vstack([freq_np[None, :], ls_q]))
    hdr = "# Binned Lomb-Scargle of the data\n# freq, lsp\n"
    if plot_f_P:
        hdr += "# f * Periodogram\n"
    _write(path, "binned_lsp_data.txt", hdr, np.column_stack([bf, bp]))

    if not make_figures:
        return None
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    ax.loglog(freq_np, ls_q[2], color="b", label="LSP realisations")
    ax.fill_between(freq_np, ls_q[0], ls_q[4], color="b", alpha=0.1, label="95%")
    ax.fill_between(freq_np, ls_q[1], ls_q[3], color="b", alpha=0.2, label="68%")
    ax.loglog(bf, bp, color="r", lw=2, label="Binned LSP")
    for x in (f_min, f_max):
        ax.axvline(x, color="k", ls="--")
    ax.set_xlabel("Frequency")
    ax.set_ylabel("f * Periodogram" if plot_f_P else "Periodogram")
    ax.set_title("Posterior predictive Lomb-Scargle periodogram")
    ax.legend(ncol=2, fontsize=8)
    fig.savefig(os.path.join(path, "LSP_ppc.png"), dpi=100)
    plt.close(fig)
    return fig


def plot_ppc_timeseries(
    samples,
    samples_c,
    t,
    y,
    yerr,
    gp_model: Callable,
    with_log_transform: bool,
    generator=None,
    t_pred=None,
    n_samples: int = 100,
    path: str = "",
    make_figures: bool = True,
    device=None,
    dtype: torch.dtype = DEFAULT_DTYPE,
):
    """Time-series PPC + standardized residual diagnostics
    (reference plots_diagnostics.jl:640-830): one posterior realisation
    of each of the first P = min(n_samples, rows) draws on the union of
    the data grid and ``t_pred``, from the batched GP of ``gp_model``
    (see :func:`plot_lsp_ppc`). The posterior mean's solve runs K3/K4 on
    the card."""
    if path:
        os.makedirs(path, exist_ok=True)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(1)
    tn, yn, en = (_numpy(x) for x in (t, y, yerr))
    if t_pred is None:
        t_pred = np.linspace(tn[0], tn[-1], 2 * len(tn))
    t_pred = np.sort(np.unique(np.concatenate([tn, _numpy(t_pred)])))
    indexes = np.searchsorted(t_pred, tn)
    t, y, yerr, t_pred_t, samples, samples_c = _tensors(dev, dtype, tn, yn, en, t_pred,
                                                          samples, samples_c)
    P = min(n_samples, samples.shape[0])
    c = samples_c.reshape(-1)[:P, None]

    fx = gp_model(t, y, yerr, samples[:P])
    y_obs = torch.log(y - c) if with_log_transform else y
    draw = gp_posterior(fx, y_obs).sample(generator, t_pred_t, num_samples=1)[..., 0, :]
    ts = torch.exp(draw + c) if with_log_transform else draw
    ts_array = ts.cpu().numpy().T  # (T, P)

    ts_q = np.quantile(ts_array, QUANTS, axis=1)
    res = (yn[:, None] - ts_array[indexes, :]) / en[:, None]
    res_q = np.quantile(res, QUANTS, axis=1)
    mean_res = res.mean(axis=1)

    np.savetxt(os.path.join(path, "ppc_timeseries_quantiles.txt"), ts_q)
    np.savetxt(os.path.join(path, "ppc_residuals_quantiles.txt"), res_q)
    np.savetxt(os.path.join(path, "ppc_residuals_mean.txt"), mean_res)
    np.savetxt(os.path.join(path, "ppc_t_pred.txt"), t_pred)

    # residual ACF (reference :723-731)
    lags = np.arange(len(mean_res) // 10 + 1)
    acvf = _autocor(mean_res, lags)
    acvf_med = _autocor(res_q[2], lags)
    _write(path, "ppc_residuals_acvf.txt",
           "# Autocorrelation of the residuals \n# lags, acvf, acvf_median\n",
           np.vstack([lags, acvf, acvf_med]))

    if not make_figures:
        return None, None
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig1, ax = plt.subplots(figsize=(8, 4))
    ax.errorbar(tn, yn, yerr=en, fmt="o", ms=3, label="Data")
    ax.plot(t_pred, ts_q[2], color="k", alpha=0.5, lw=1, label="median realisation")
    ax.fill_between(t_pred, ts_q[0], ts_q[4], color="k", alpha=0.1, label="95%")
    ax.fill_between(t_pred, ts_q[1], ts_q[3], color="k", alpha=0.2, label="68%")
    ax.set_xlabel("Time"); ax.set_ylabel("Time series")
    ax.set_title("Posterior predictive simulated time series")
    ax.legend(ncol=4, fontsize=8)
    fig1.savefig(os.path.join(path, "TS_ppc.png"), dpi=100)

    fig2, (ax1, ax3) = plt.subplots(2, 1, figsize=(7, 6))
    ax1.plot(tn, mean_res, color="b", label="mean")
    ax1.plot(tn, res_q[2], color="k", label="median realisation")
    ax1.fill_between(tn, res_q[0], res_q[4], color="k", alpha=0.1)
    ax1.fill_between(tn, res_q[1], res_q[3], color="k", alpha=0.2)
    ax1.set_xlabel("Time"); ax1.set_ylabel("Residuals"); ax1.legend(fontsize=8)
    ax3.stem(lags, acvf, basefmt="k-", label="ACVF")
    for ci, alpha in ((1.96, 0.2), (2.58, 0.1)):
        ax3.fill_between(lags, -ci / np.sqrt(len(tn)), ci / np.sqrt(len(tn)),
                         color="k", alpha=alpha)
    ax3.set_xlabel("Lag (indices)"); ax3.set_ylabel("ACVF")
    fig2.savefig(os.path.join(path, "residuals_diagnostics.png"), dpi=100)
    plt.close("all")
    return fig1, fig2


def _autocor(x, lags):
    x = np.asarray(x) - np.mean(x)
    denom = np.sum(x**2)
    return np.array([np.sum(x[: len(x) - k] * x[k:]) / denom for k in lags])


def plot_psd_ppc_carma(
    samples_ra,
    samples_beta,
    samples_norm,
    samples_nu,
    t,
    y,
    yerr,
    p: int,
    q: int,
    n_frequencies: int = 1000,
    path: str = "",
    with_log_transform: bool = False,
    plot_f_P: bool = False,
    make_figures: bool = True,
    device=None,
):
    """CARMA posterior predictive PSD (reference plots_diagnostics.jl:832-935).

    ``samples_ra`` (P, p) complex AR roots, stored as CARMA stores them:
    conjugate pairs, the last root real when p is odd; ``samples_beta``
    (P, q + 1); ``samples_norm`` (P,). The PSDs come from the batched
    real path ``carma_psd_real`` in float64.
    """
    if path:
        os.makedirs(path, exist_ok=True)
    dev = resolve_device(device)
    tn = _numpy(t)
    f_min = 1.0 / (tn[-1] - tn[0]) / 10.0
    f_max = 1.0 / np.min(np.diff(tn)) / 2.0 * 10.0
    f = torch.exp(torch.linspace(np.log(f_min), np.log(f_max), n_frequencies,
                                 dtype=torch.float64, device=dev))

    mean_nl, med_nl = _noise_levels(t, y, yerr, samples_nu, with_log_transform)

    ra = torch.as_tensor(np.asarray(_numpy(samples_ra), dtype=np.complex128), device=dev)
    beta, norm = _tensors(dev, torch.float64, samples_beta, samples_norm)
    psd = carma_psd_real(f, p, q, list(ra.real.unbind(-1)), list(ra.imag.unbind(-1)),
                         beta, norm.reshape(-1))
    psd_samples = psd.cpu().numpy().T
    f_np = f.cpu().numpy()
    scale = f_np[:, None] if plot_f_P else 1.0
    psd_q = np.quantile(scale * psd_samples, QUANTS, axis=1)

    _write(path, "psd_noise_levels.txt",
           "# Noise levels\n# mean_noise_level, median_noise_level\n",
           np.array([mean_nl, med_nl]))
    hdr = ("# Posterior predictive CARMA power spectral density\n"
           "# quantiles=[0.025, 0.16, 0.5, 0.84, 0.975] \n# f, psd_quantiles\n")
    if plot_f_P:
        hdr += "# f * PSD\n"
    _write(path, "psd_ppc_data.txt", hdr, np.vstack([f_np[None, :], psd_q]))

    if not make_figures:
        return None
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    ax.loglog(f_np, psd_q[2], color="b", label="Model Median")
    ax.fill_between(f_np, psd_q[0], psd_q[4], color="b", alpha=0.2, label="95%")
    ax.fill_between(f_np, psd_q[1], psd_q[3], color="b", alpha=0.4, label="68%")
    nl_scale = f_np if plot_f_P else np.ones_like(f_np)
    ax.loglog(f_np, nl_scale * mean_nl, "k--", label="Mean noise level")
    ax.loglog(f_np, nl_scale * med_nl, "k-", label="Median noise level")
    for x in (f_min, f_max):
        ax.axvline(x, color="k", ls=":")
    ax.set_xlabel("Frequency"); ax.set_ylabel("f PSD" if plot_f_P else "PSD")
    ax.legend(ncol=3, fontsize=8)
    fig.savefig(os.path.join(path, "psd_ppc.png"), dpi=100)
    plt.close(fig)
    return fig


def run_posterior_predict_checks(
    samples,
    paramnames,
    paramnames_split,
    t,
    y,
    yerr,
    model: Callable,
    gp_model: Callable,
    with_log_transform: bool,
    S_low: float = 20.0,
    S_high: float = 20.0,
    is_integrated_power: bool = True,
    plots="all",
    n_samples: int = 100,
    path: str = "",
    basis_function: str = "SHO",
    n_frequencies: int = 1000,
    plot_f_P: bool = False,
    n_components: int = 20,
    save_samples: bool = False,
    generator=None,
    make_figures: bool = True,
    device=None,
    dtype: torch.dtype = DEFAULT_DTYPE,
):
    """Orchestrate the three PPC diagnostics
    (reference plots_diagnostics.jl:276-344).

    ``samples`` (P, k) in ``paramnames`` order; ``model`` the PSD class
    (``spec.psd_model``); ``gp_model(t, y, yerr, params)`` takes the
    (P, k) rows at once and returns one batched ConditionedGP
    (``spec.gp_model``), where the JAX package's callable takes one row.
    ``generator`` feeds both stochastic checks.
    """
    s_psd, s_norm, s_nu, s_mu, s_c = separate_samples(
        _numpy(samples), list(paramnames), paramnames_split
    )
    figs = []
    wanted = ["psd", "lsp", "timeseries"] if plots == "all" else list(plots)
    common = dict(path=path, make_figures=make_figures, device=device, dtype=dtype)
    if "psd" in wanted:
        figs.append(plot_psd_ppc(
            s_psd, s_norm, s_nu, t, y, yerr, model,
            S_low=S_low, S_high=S_high,
            n_components=n_components, basis_function=basis_function,
            is_integrated_power=is_integrated_power,
            n_frequencies=n_frequencies,
            with_log_transform=with_log_transform, plot_f_P=plot_f_P,
            save_samples=save_samples, **common,
        ))
    if "lsp" in wanted:
        figs.append(plot_lsp_ppc(
            samples, t, y, yerr, gp_model, generator=generator,
            S_low=S_low, S_high=S_high, n_frequencies=n_frequencies,
            with_log_transform=with_log_transform, plot_f_P=plot_f_P, **common,
        ))
    if "timeseries" in wanted:
        figs.extend(plot_ppc_timeseries(
            samples, s_c, t, y, yerr, gp_model, with_log_transform,
            generator=generator, n_samples=n_samples, **common,
        ))
    return figs
