"""Generalized (floating-mean) Lomb-Scargle periodogram, PyTorch port of
``pioran_tpu.diagnostics.lsp``.

Replaces the reference's LombScargle.jl dependency (used by
reference src/plots_diagnostics.jl:514-633 for the LSP posterior
predictive check). The GLS is a weighted least-squares fit per
frequency: elementwise math and reductions, batched over the frequency
grid and over realisations (the JAX package maps over both).

Formulation: Zechmeister & Kuerster (2009), weighted, floating mean,
"standard" normalization p in [0, 1] — matching LombScargle.jl defaults
(fit_mean=true, errors as weights, normalization=:standard).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["lombscargle", "binned_lsp"]

# elements of one (rows, F, N) temporary, about 256 MiB in float64
_CHUNK_ELEMENTS = 1 << 25


def lombscargle(t, y, yerr, frequencies):
    """GLS power (..., F) of the series ``y`` (..., N) with errors
    ``yerr`` (..., N) on the grid ``t`` (N,) at ``frequencies`` (F,).

    Realisations are processed in chunks so that no (rows, F, N)
    temporary exceeds about 2^25 elements.
    """
    F, N = frequencies.shape[-1], t.shape[-1]
    batch = torch.broadcast_shapes(y.shape[:-1], yerr.shape[:-1])
    y, yerr = y.expand(batch + (N,)).reshape(-1, N), yerr.expand(batch + (N,)).reshape(-1, N)
    rows = max(1, _CHUNK_ELEMENTS // (F * N))
    out = [_gls(t, y[i:i + rows], yerr[i:i + rows], frequencies)
           for i in range(0, y.shape[0], rows)]
    return torch.cat(out).reshape(batch + (F,))


def _gls(t, y, yerr, frequencies):
    """GLS power (B, F) of y, yerr (B, N)."""
    w = 1.0 / yerr**2
    w = (w / torch.sum(w, dim=-1, keepdim=True))[:, None, :]  # (B, 1, N)
    ybar = torch.sum(w * y[:, None, :], dim=-1, keepdim=True)
    yc = y[:, None, :] - ybar
    YY = torch.sum(w * yc**2, dim=-1)

    omega = (2.0 * math.pi * frequencies)[:, None]  # (F, 1)
    # tau makes the cos/sin basis orthogonal (ZK09 eq. 19 uses full
    # matrices; the tau trick gives the same power)
    two_wt = 2.0 * omega * t
    tau = 0.5 * torch.atan2(torch.sum(w * torch.sin(two_wt), dim=-1, keepdim=True),
                            torch.sum(w * torch.cos(two_wt), dim=-1, keepdim=True)) / omega
    x = omega * (t - tau)
    cosx, sinx = torch.cos(x), torch.sin(x)
    C = torch.sum(w * cosx, dim=-1)
    S = torch.sum(w * sinx, dim=-1)
    YC = torch.sum(w * yc * cosx, dim=-1)
    YS = torch.sum(w * yc * sinx, dim=-1)
    CC = torch.sum(w * cosx**2, dim=-1) - C * C
    SS = torch.sum(w * sinx**2, dim=-1) - S * S
    CS = torch.sum(w * cosx * sinx, dim=-1) - C * S
    D = CC * SS - CS**2
    num = SS * YC**2 + CC * YS**2 - 2.0 * CS * YC * YS
    return num / (YY * D)


def binned_lsp(freqs, power, bin_fact: int = 10):
    """Log-space binning of a periodogram (host-side numpy), as in
    reference plots_diagnostics.jl:575-589."""
    freqs = np.asarray(freqs)
    power = np.asarray(power)
    n = int(round(len(power) / bin_fact))
    bf, bp = [], []
    for i in range(n - 1):
        sl = slice(i * bin_fact, (i + 1) * bin_fact)
        bp.append(np.mean(np.log(power[sl])))
        bf.append(np.mean(np.log(freqs[sl])))
    return np.exp(np.array(bf)), np.exp(np.array(bp))
