"""MCMC convergence diagnostics: rank-normalized split-R̂ and bulk/tail ESS.

The port's own copy of ``pioran_tpu.utils.mcmc_stats`` (numpy and scipy
only), kept here so the port never imports the JAX package. The
statistics are those of Vehtari, Gelman, Simpson, Carpenter & Bürkner
(2021), "Rank-normalization, folding, and localization: an improved R̂
for assessing convergence of MCMC".

All functions are host-side numpy on draws already copied to the host:
chains of shape ``(n_chains, n_samples)`` per scalar parameter, or
``(n_chains, n_samples, dim)`` for a full posterior.
"""

from __future__ import annotations

import numpy as np

__all__ = ["split_rhat", "ess_bulk", "ess_tail", "summarize_chains"]


def _ndtri(p):
    from scipy.special import ndtri

    return ndtri(p)


def _split_chains(x):
    """(C, S) -> (2C, S//2): split each chain in half (drop odd sample)."""
    C, S = x.shape
    half = S // 2
    return np.concatenate([x[:, :half], x[:, S - half:]], axis=0)


def _rank_normalize(x):
    """Fractional-offset average ranks -> standard normal scores, pooled
    over all chains (Vehtari+ 2021 eq. 14: z = Phi^-1((r - 3/8)/(N + 1/4)));
    ties get average ranks so discrete values map to one common score."""
    from scipy.stats import rankdata

    shape = x.shape
    ranks = rankdata(x.reshape(-1), method="average")
    z = _ndtri((ranks - 0.375) / (ranks.size + 0.25))
    return z.reshape(shape)


def _rhat_of(z):
    """Classic split-R̂ on already-split, already-transformed chains (C, S)."""
    C, S = z.shape
    if S < 2:
        return np.nan
    chain_means = z.mean(axis=1)
    chain_vars = z.var(axis=1, ddof=1)
    W = chain_vars.mean()
    B = S * chain_means.var(ddof=1) if C > 1 else 0.0
    var_plus = (S - 1) / S * W + B / S
    if W <= 0:
        return np.nan
    return float(np.sqrt(var_plus / W))


def split_rhat(chains):
    """Rank-normalized split-R̂; max over (bulk, folded) statistics.

    ``chains``: (n_chains, n_samples) or (n_chains, n_samples, dim).
    Values near 1.0 indicate convergence (Vehtari+ 2021 threshold 1.01).
    """
    chains = np.asarray(chains, dtype=np.float64)
    if chains.ndim == 3:
        return np.asarray([split_rhat(chains[..., i])
                           for i in range(chains.shape[-1])])
    x = _split_chains(chains)
    rhat_bulk = _rhat_of(_rank_normalize(x))
    folded = np.abs(x - np.median(x))
    rhat_tail = _rhat_of(_rank_normalize(folded))
    both = [v for v in (rhat_bulk, rhat_tail) if np.isfinite(v)]
    # all-NaN (e.g. S < 2 smoke runs): undefined, without the numpy
    # "All-NaN axis" RuntimeWarning polluting the run's output
    return float(max(both)) if both else float("nan")


def _ess_of(z):
    """ESS of split chains (C, S) via FFT autocorrelation + Geyer's
    initial monotone positive sequence (Vehtari+ 2021 §3.2)."""
    C, S = z.shape
    if S < 4:
        return np.nan
    chain_means = z.mean(axis=1, keepdims=True)
    chain_vars = z.var(axis=1, ddof=1)
    W = chain_vars.mean()
    B_over_S = z.mean(axis=1).var(ddof=1) if C > 1 else 0.0
    var_plus = (S - 1) / S * W + B_over_S
    if var_plus <= 0:
        return np.nan

    # per-chain autocovariance via FFT
    d = z - chain_means
    nfft = 1 << int(np.ceil(np.log2(2 * S)))
    f = np.fft.rfft(d, nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=1)[:, :S].real / S
    rho = 1.0 - (W - acov.mean(axis=0)) / var_plus  # combined rho_t
    # the Stan/ArviZ estimator fixes rho_0 = 1 exactly (the estimated
    # value 1 - W/(S var_plus) slightly understates tau for short chains)
    rho[0] = 1.0

    # Geyer: tau = -rho_0 + 2 * sum of consecutive-pair sums, stopping at
    # the first negative pair and enforcing a monotone non-increasing
    # sequence of pair sums (initial monotone positive sequence).
    pair_total = 0.0
    prev_pair = np.inf
    for k in range((S - 1) // 2):
        pair = rho[2 * k] + rho[2 * k + 1]
        if pair < 0:
            break
        pair = min(pair, prev_pair)
        prev_pair = pair
        pair_total += pair
    tau = max(2.0 * pair_total - rho[0], 1.0 / np.log10(C * S + 10.0))
    ess = C * S / tau
    return float(ess) if np.isfinite(ess) else np.nan


def ess_bulk(chains):
    """Bulk ESS: ESS of the rank-normalized split chains."""
    chains = np.asarray(chains, dtype=np.float64)
    if chains.ndim == 3:
        return np.asarray([ess_bulk(chains[..., i])
                           for i in range(chains.shape[-1])])
    z = _rank_normalize(_split_chains(chains))
    return _ess_of(z)


def ess_tail(chains):
    """Tail ESS: min ESS of the raw 0/1 5% / 95% quantile-exceedance
    indicator chains (no rank normalization — matching ArviZ and
    Vehtari+ 2021 §4.3)."""
    chains = np.asarray(chains, dtype=np.float64)
    if chains.ndim == 3:
        return np.asarray([ess_tail(chains[..., i])
                           for i in range(chains.shape[-1])])
    x = _split_chains(chains)
    out = []
    for q in (0.05, 0.95):
        ind = (x <= np.quantile(x, q)).astype(np.float64)
        out.append(_ess_of(ind))
    finite = [v for v in out if np.isfinite(v)]
    return float(min(finite)) if finite else float("nan")


def summarize_chains(chains):
    """Per-parameter {rhat, ess_bulk, ess_tail} for (C, S, dim) draws."""
    chains = np.asarray(chains, dtype=np.float64)
    if chains.ndim == 2:
        chains = chains[..., None]
    return {
        "rhat": np.atleast_1d(split_rhat(chains)).tolist(),
        "ess_bulk": np.atleast_1d(ess_bulk(chains)).tolist(),
        "ess_tail": np.atleast_1d(ess_tail(chains)).tolist(),
    }
