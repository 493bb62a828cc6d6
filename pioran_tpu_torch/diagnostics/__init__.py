"""Post-fit diagnostics: the PSD approximation checks, the Lomb-Scargle
periodogram and the posterior predictive checks (PyTorch port of
``pioran_tpu.diagnostics``)."""

from .approx_checks import run_diagnostics, sample_approx_model
from .lsp import binned_lsp, lombscargle
from .ppc import (
    plot_lsp_ppc,
    plot_ppc_timeseries,
    plot_psd_ppc,
    plot_psd_ppc_carma,
    run_posterior_predict_checks,
)

__all__ = [
    "run_diagnostics",
    "sample_approx_model",
    "lombscargle",
    "binned_lsp",
    "run_posterior_predict_checks",
    "plot_psd_ppc",
    "plot_lsp_ppc",
    "plot_ppc_timeseries",
    "plot_psd_ppc_carma",
]
