"""High-level inference entry points, PyTorch port of ``pioran_tpu.inference``.

What is ported: the flagship single-bending power-law model
(:func:`single_bending_model`) and :func:`run_inference` with
``sampler="ns"``, ``"chees"`` (ChEES-HMC, optionally seeded by
:func:`advi_seeded_inits`) and ``"advi"``, which write their results in
the ultranest layout (``chains/equal_weighted_post.txt``,
``info/results.json``); and :func:`run_inference_many`, which fits the
single-bending model to many ragged light curves as one ChEES ensemble.
The likelihood of a batch of parameter vectors is one batched PSD ->
celerite approximation (plain PyTorch) feeding the CUDA celerite kernels
on the card (K1 or, for ragged per-chain grids, K2 without a gradient;
K3 and K4 with one), or their plain versions on the CPU.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import DEFAULT_DTYPE, resolve_device
from .convert import multi_inputs_from_numpy
from .models.psd import SingleBendingPowerLaw
from .ops.approx import approx
from .ops.cuda_celerite import batched_loglike, batched_loglike_multi
from .priors import (
    Gamma,
    LogNormal,
    LogUniform,
    Normal,
    PriorSet,
    TwoUniformDependent,
)
from .samplers.advi import run_advi
from .samplers.chees import run_chees
from .samplers.ns import equal_weight_indices, run_ns
from .utils.insertion import insertion_order_test
from .utils.mcmc_stats import summarize_chains

__all__ = ["GPModelSpec", "single_bending_model", "advi_seeded_inits",
           "run_inference", "run_inference_many"]

# samplers of the JAX package that are not ported yet, with the ROADMAP
# item that ports them
_NOT_PORTED = {
    "smc": "SMC and NUTS (ROADMAP queue 1, step 9)",
    "nuts": "SMC and NUTS (ROADMAP queue 1, step 9)",
}


@dataclass
class GPModelSpec:
    """Everything needed to run inference on one light curve.

    ``loglike_batch(TH)`` maps ``(B, dim)`` parameter rows to ``(B,)``
    GP log-likelihoods of the transformed data; ``loglike(th)`` is its
    one-row case. ``prior`` is a PriorSet over theta and ``names``
    label theta's entries. ``gp_model`` and ``psd_model`` stay ``None``
    until the GP object API is ported. Tensors live on ``device`` in
    ``dtype``.
    """

    prior: PriorSet
    loglike: Callable
    names: List[str]
    gp_model: Optional[Callable]
    psd_model: Optional[Callable]
    paramnames_split: Dict
    t: np.ndarray
    y: np.ndarray
    yerr: np.ndarray
    f_min: float
    f_max: float
    loglike_batch: Optional[Callable] = None
    device: torch.device = torch.device("cpu")
    dtype: torch.dtype = DEFAULT_DTYPE

    def logpost_batch(self, Z):
        """(B, dim) unconstrained rows -> (B,) log-posteriors: the prior's
        unconstrained log-density plus the likelihood of the mapped
        parameters. Differentiable; on the card its gradient runs K3/K4."""
        return self.prior.unconstrained_logpdf(Z) + self.loglike_batch(
            self.prior.from_unconstrained(Z))

    def logpost_unconstrained(self, z):
        """The one-row case of :meth:`logpost_batch`."""
        return self.logpost_batch(z[None])[0]


def _batched_loglike_from_coeffs(coeff_fn, t, dt=None):
    """(B, dim) -> (B,) likelihood: the batched parameter -> coefficient
    map feeding the batched celerite likelihood."""

    def loglike_batch(TH):
        a, b, c, d, yv, s2 = coeff_fn(TH)
        return batched_loglike(a, b, c, d, t, yv, s2, dt)

    return loglike_batch


def _write_ultranest(log_dir, names, theta, results):
    """``chains/equal_weighted_post.txt`` (a header of the names, then the
    draws) and ``info/results.json`` under ``log_dir``."""
    os.makedirs(os.path.join(log_dir, "chains"), exist_ok=True)
    os.makedirs(os.path.join(log_dir, "info"), exist_ok=True)
    with open(os.path.join(log_dir, "chains", "equal_weighted_post.txt"), "w") as fh:
        fh.write(" ".join(names) + "\n")
        np.savetxt(fh, theta)
    with open(os.path.join(log_dir, "info", "results.json"), "w") as fh:
        json.dump(results, fh, indent=2, ensure_ascii=False)


def _posterior_summary(theta):
    return {
        "mean": theta.mean(axis=0).tolist(),
        "stdev": theta.std(axis=0).tolist(),
        "median": np.median(theta, axis=0).tolist(),
        "errlo": np.quantile(theta, 0.158655, axis=0).tolist(),
        "errup": np.quantile(theta, 0.841345, axis=0).tolist(),
    }


def _freq_range(t):
    f_min = 1.0 / (t[-1] - t[0])
    f_max = 1.0 / float(np.min(np.diff(np.asarray(t)))) / 2.0
    return float(f_min), float(f_max)


def single_bending_model(
    t, y, yerr, xbar, va,
    n_components: int = 20,
    basis_function: str = "SHO",
    S_low: float = 20.0,
    S_high: float = 20.0,
    use_c: bool = False,
    alpha1_max: float = 1.5,
    is_integrated_power: bool = True,
    device=None,
    dtype: torch.dtype = DEFAULT_DTYPE,
) -> GPModelSpec:
    """The reference's single-bending power-law model with its priors:

    theta = (alpha_1, alpha_2, f_1, variance, nu, mu[, c]);
    alpha_1 ~ U(0, alpha1_max); alpha_2 ~ U(alpha_1, 4);
    f_1 ~ logU(f0*4, fM/4); variance ~ LogNormal(-3, sqrt(2));
    nu ~ Gamma(2, 0.5); mu ~ N(xbar, 5 sqrt(va)); the data are
    log-transformed with sigma^2 = nu yerr^2 / y^2.

    ``use_c`` adds a flux offset c ~ logU(1e-6, 0.99 min y) to theta;
    the transform becomes log(y - c) with sigma^2 = nu yerr^2/(y - c)^2.
    ``is_integrated_power=False`` makes ``variance`` the total process
    variance instead of the band-integrated power.

    ``device`` (default: the card; ``device="cpu"`` for the CPU) and
    ``dtype`` place the data and every likelihood evaluation. On the card
    the likelihood and its gradient run the hand-written CUDA kernels;
    with no card and no ``device`` this raises ``RuntimeError``.
    """
    dev = resolve_device(device)
    # consecutive spacings computed in host f64 before any f32 cast:
    # diff of an f32 grid loses ~log2(N) bits for long dense series
    dt64 = torch.as_tensor(np.diff(np.asarray(t, np.float64)), device=dev)
    tt = torch.as_tensor(np.asarray(t), dtype=dtype, device=dev)
    yy = torch.as_tensor(np.asarray(y), dtype=dtype, device=dev)
    ee = torch.as_tensor(np.asarray(yerr), dtype=dtype, device=dev)
    t_np, y_np = tt.cpu().numpy(), yy.cpu().numpy()
    f_min, f_max = _freq_range(t_np)
    min_f_b, max_f_b = f_min / 20.0 * 4.0, f_max * 20.0 / 4.0

    items = [
        ("alphas", TwoUniformDependent(0.0, alpha1_max, 4.0)),
        ("f_1", LogUniform(min_f_b, max_f_b)),
        ("variance", LogNormal(2 * -1.5, np.sqrt(2.0) * 1.0)),
        ("nu", Gamma(2.0, 0.5)),
        ("mu", Normal(xbar, 5.0 * np.sqrt(va))),
    ]
    names = ["α₁", "α₂", "f₁", "variance", "ν", "μ"]
    if use_c:
        items.append(("c", LogUniform(1e-6, float(np.min(y_np)) * 0.99)))
        names.append("c")
    prior = PriorSet(items)
    yn = torch.log(yy)

    def coeff_fn(TH):
        a1, a2, f1, var, nu, mu = (TH[:, i] for i in range(6))
        kern = approx(
            SingleBendingPowerLaw(a1, f1, a2), f_min, f_max,
            n_components, var, S_low, S_high, basis_function=basis_function,
            is_integrated_power=is_integrated_power,
        )
        a, b, c, d = kern.coefficients()
        if use_c:
            c_off = TH[:, 6:7]
            yv = torch.log(yy - c_off)
            s2 = nu[:, None] * ee**2 / (yy - c_off) ** 2
        else:
            yv = yn.expand(TH.shape[0], -1)
            s2 = nu[:, None] * ee**2 / yy**2
        return a, b, c, d, yv - mu[:, None], s2

    loglike_batch = _batched_loglike_from_coeffs(coeff_fn, tt, dt=dt64)

    def loglike(th):
        return loglike_batch(th[None])[0]

    return GPModelSpec(
        prior=prior, loglike=loglike, names=names,
        gp_model=None, psd_model=None,
        paramnames_split={"psd": ["α₁", "f₁", "α₂"], "norm": "variance",
                          "scale_err": "ν", "mean": "μ",
                          **({"log_transform": "c"} if use_c else {})},
        t=t_np, y=y_np, yerr=ee.cpu().numpy(),
        f_min=f_min, f_max=f_max, loglike_batch=loglike_batch,
        device=dev, dtype=dtype,
    )


# final per-sample likelihood sweeps process at most this many samples
# per loglike_batch call
_FINAL_LOGLIKE_CHUNK = 65536


def _kish_ess(logp: np.ndarray) -> float:
    """Kish effective sample size of normalised log weights."""
    m = np.max(logp)
    logp = logp - (m + np.log(np.sum(np.exp(logp - m))))
    w = np.exp(logp)
    return float(1.0 / np.sum(w * w))


def advi_seeded_inits(
    spec: GPModelSpec,
    generator: torch.Generator,
    num_chains: int,
    num_steps: int = 1500,
    overdispersion: float = 2.0,
    num_mc: int = 8,
):
    """Dispersed chain inits for the gradient samplers: (num_chains, dim).

    Raw prior draws leave a share of HMC chains on the flagship model's
    f_1 plateaus, where the likelihood is flat and gradients vanish. So:
    take the best of 256 prior draws (one batched sweep, no gradient),
    start a mean-field ADVI fit there, and draw the chains from the fitted
    Gaussian widened by ``overdispersion`` in unconstrained space, the
    classical Gelman-Rubin prescription.
    """
    prior = spec.prior
    with torch.no_grad():
        zc = prior.to_unconstrained(prior.sample(
            (256,), generator=generator, dtype=spec.dtype, device=spec.device))
        lp = spec.logpost_batch(zc)
        lp = torch.where(torch.isfinite(lp), lp, torch.full_like(lp, -math.inf))
        z_init = zc[torch.argmax(lp)]
    res = run_advi(spec.logpost_batch, z_init, generator, num_steps=num_steps,
                   num_mc=num_mc, num_draws=1)
    eps = torch.randn((num_chains, prior.dim), generator=generator,
                      dtype=spec.dtype, device=spec.device)
    return res.mu[None, :] + overdispersion * torch.exp(res.log_sigma)[None, :] * eps


def _run_ns(spec, gen, num_particles, num_samples, num_ns_mcmc, ns_move, frac_remain):
    """Nested sampling: (theta draws, the NS entries of the results)."""
    prior = spec.prior

    def loglike_u_batch(U):
        return spec.loglike_batch(prior.transform(U))

    n_delete = max(num_particles // 8, 1)
    res = run_ns(
        loglike_u_batch, gen, num_live=num_particles, dim=prior.dim,
        n_delete=n_delete, num_mcmc=num_ns_mcmc, move=ns_move,
        max_iters=max(8 * num_particles // n_delete, 400),
        frac_remain=frac_remain, dtype=spec.dtype,
    )
    n_eq = max(num_samples * 4, 4000)
    idx = equal_weight_indices(res.dead_logl, res.dead_logw, res.num_dead,
                               n_eq, generator=gen)
    theta = prior.transform(res.dead_u[idx]).cpu().numpy()
    logp = (res.dead_logl + res.dead_logw).cpu().numpy().astype(np.float64)
    valid = np.arange(logp.shape[0]) < res.num_dead
    logp = np.where(valid & np.isfinite(logp), logp, -np.inf)
    mww = insertion_order_test(res.insert_ranks.cpu().numpy(),
                               n_slots=num_particles - n_delete)
    return theta, {
        "logz": float(res.logZ),
        "logzerr": float(res.logZ_err),
        "H": float(res.H),
        "ess": _kish_ess(logp),
        "ncall": int(res.ncall),
        # the run stopped on frac_remain, not the max_iters backstop
        "iteration_budget_ok": bool(res.num_iters < 8 * num_particles // n_delete),
        "insertion_order_MWW_test": {
            "independent_iterations": mww["independent_iterations"],
            "converged": bool(mww["converged"]),
            "zscore": mww["zscore"],
            "pvalue": mww["pvalue"],
        },
    }


def _run_chees(spec, gen, num_chains, num_warmup, num_samples, init, mass,
               hmc_max_leapfrogs):
    """ChEES-HMC: (theta draws, the MCMC entries of the results)."""
    prior = spec.prior
    if init == "advi":
        z0 = advi_seeded_inits(spec, gen, num_chains)
    elif init == "prior":
        z0 = prior.to_unconstrained(prior.sample(
            (num_chains,), generator=gen, dtype=spec.dtype, device=spec.device))
    else:
        raise ValueError(f"init must be 'prior' or 'advi', got {init!r}")
    samples_z, stats = run_chees(
        spec.logpost_batch, z0, gen, num_warmup=num_warmup,
        num_samples=num_samples, mass=mass, max_leapfrogs=hmc_max_leapfrogs)
    with torch.no_grad():
        # (S, C, dim) -> (C, S, dim): per-chain draws, in theta space
        chains_th = prior.from_unconstrained(samples_z.transpose(0, 1)).cpu().numpy()
    theta = chains_th.transpose(1, 0, 2).reshape(-1, prior.dim)
    conv = summarize_chains(chains_th)
    ess_b = np.asarray(conv["ess_bulk"], np.float64)
    return theta, {
        # every leapfrog evaluates value+gradient for all chains
        "ncall": int(stats["n_leapfrogs"].sum()) * num_chains,
        "rhat": conv["rhat"],
        "ess_bulk": conv["ess_bulk"],
        "ess_tail": conv["ess_tail"],
        # all-NaN for tiny runs (ESS undefined below 4 draws)
        "ess": (float(np.nanmin(ess_b)) if np.any(np.isfinite(ess_b)) else float("nan")),
    }


def _run_advi(spec, gen, num_warmup, num_samples):
    """Mean-field ADVI: (theta draws, the ADVI entries of the results)."""
    prior = spec.prior
    num_steps, num_mc = num_warmup + num_samples, 8
    z0 = prior.to_unconstrained(prior.sample(
        (), generator=gen, dtype=spec.dtype, device=spec.device))
    res = run_advi(spec.logpost_batch, z0, gen, num_steps=num_steps, num_mc=num_mc,
                   num_draws=num_samples)
    with torch.no_grad():
        theta = prior.from_unconstrained(res.samples).cpu().numpy()
    return theta, {
        "logz_lower": float(res.logZ_lower),
        # ELBO-gradient likelihood evaluations: num_mc draws per step,
        # plus the final 64-draw ELBO estimate
        "ncall": int(num_steps * num_mc + 64),
    }


def run_inference(
    spec: GPModelSpec,
    sampler: str = "ns",
    seed: int = 0,
    num_particles: int = 2048,
    num_chains: int = 16,
    num_warmup: int = 500,
    num_samples: int = 1000,
    log_dir: Optional[str] = None,
    num_ns_mcmc: int = 8,
    ns_move: str = "slice",
    frac_remain: float = 1e-2,
    init: str = "prior",
    mass: str = "diag",
    hmc_max_leapfrogs: int = 128,
) -> Dict:
    """Run NS, ChEES-HMC or ADVI on a model spec and write its artifacts.

    ``sampler="ns"`` is the direct ultranest analog: ``num_particles``
    live points, evidence logZ with an ultranest-style logzerr, an
    equal-weighted posterior and the insertion-order MWW test.
    ``sampler="chees"`` runs ``num_chains`` ChEES-HMC chains for
    ``num_warmup`` + ``num_samples`` iterations (at most
    ``hmc_max_leapfrogs`` leapfrogs each) with a ``mass`` "diag" or
    "dense" metric, started from prior draws (``init="prior"``) or from
    an overdispersed ADVI fit (``init="advi"``, :func:`advi_seeded_inits`),
    and reports split-r̂ and bulk/tail ESS per parameter.
    ``sampler="advi"`` fits mean-field ADVI for ``num_warmup`` +
    ``num_samples`` steps and reports ``num_samples`` draws and the ELBO
    ``logz_lower``.

    Random numbers come from one ``torch.Generator`` on the spec's device
    seeded with ``seed``. Returns a results dict with posterior samples
    (theta space), summary moments and the sampler's own entries, with
    the JAX package's keys; with ``log_dir``, writes
    ``chains/equal_weighted_post.txt`` and ``info/results.json``. SMC and
    NUTS raise ``NotImplementedError``.
    """
    if sampler in _NOT_PORTED:
        raise NotImplementedError(
            f"sampler={sampler!r} is not ported to pioran_tpu_torch yet: "
            f"{_NOT_PORTED[sampler]}")
    t0 = time.time()
    gen = torch.Generator(device=spec.device).manual_seed(seed)
    if sampler == "ns":
        theta, extra = _run_ns(spec, gen, num_particles, num_samples, num_ns_mcmc,
                               ns_move, frac_remain)
    elif sampler == "chees":
        theta, extra = _run_chees(spec, gen, num_chains, num_warmup, num_samples,
                                  init, mass, hmc_max_leapfrogs)
    elif sampler == "advi":
        theta, extra = _run_advi(spec, gen, num_warmup, num_samples)
    else:
        raise ValueError(
            f"unknown sampler {sampler!r}; use ns, smc, nuts, chees or advi")
    elapsed = time.time() - t0

    # final per-sample likelihoods, chunked
    TH_all = torch.as_tensor(theta, dtype=spec.dtype, device=spec.device)
    loglikes = np.concatenate([
        spec.loglike_batch(TH_all[i:i + _FINAL_LOGLIKE_CHUNK]).cpu().numpy()
        for i in range(0, TH_all.shape[0], _FINAL_LOGLIKE_CHUNK)])
    results = {
        "paramnames": spec.names,
        "sampler": sampler,
        "elapsed_s": elapsed,
        "posterior": _posterior_summary(theta),
        "maximum_likelihood": {
            "logl": float(np.max(loglikes)),
            "point": theta[int(np.argmax(loglikes))].tolist(),
        },
        **extra,
    }
    if "ess" in results and elapsed > 0:
        results["ess_per_s"] = float(results["ess"]) / elapsed

    if log_dir:
        # cap the written posterior at 20k equal-weighted rows
        theta_out = theta
        if theta.shape[0] > 20000:
            sel = np.random.default_rng(0).choice(
                theta.shape[0], 20000, replace=False)
            theta_out = theta[np.sort(sel)]
        _write_ultranest(log_dir, spec.names, theta_out, results)
    results["samples"] = theta
    return results


class _ManyModel(NamedTuple):
    """The single-bending model over D ragged light curves: ``loglike_batch``
    maps (D C, 6) theta rows, for any C, dataset-major (rows d C .. d C +
    C - 1 belong to dataset d), to (D C,) likelihoods, and
    ``logpost_batch`` (D C, 6) unconstrained rows to log-posteriors.
    theta = (alpha_1, alpha_2, f_1, variance, nu, mu_std), with each
    dataset's mu = xbar[d] + sd5[d] mu_std. ``data`` holds the padded
    (T, DT, Y, E, n_valid) per dataset, as ``convert.multi_inputs_from_numpy``
    returns them."""

    prior: PriorSet
    loglike_batch: Callable
    logpost_batch: Callable
    xbar: np.ndarray
    sd5: np.ndarray
    f_min: float
    f_max: float
    data: Tuple[torch.Tensor, ...]


def _many_model(datasets: Sequence[Tuple], n_components: int = 20,
                basis_function: str = "SHO", S_low: float = 20.0, S_high: float = 20.0,
                device=None, dtype: torch.dtype = DEFAULT_DTYPE) -> _ManyModel:
    """The model :func:`run_inference_many` samples (see there)."""
    dev = resolve_device(device)
    Ns = [len(ds[0]) for ds in datasets]
    Nmax = max(Ns)

    def pad(x, fill):
        x = np.asarray(x, np.float64)
        return np.concatenate([x, np.full(Nmax - len(x), x[-1] if fill == "edge" else fill)])

    # times edge-padded; spacings in host f64 (trailing zeros on the
    # padding), cast after the diff; fluxes and errors padded with 1
    T = np.stack([pad(ds[0], "edge") for ds in datasets])
    T, DT, Y, E, NV = multi_inputs_from_numpy(
        T, np.diff(T, axis=1), np.stack([pad(ds[1], 1.0) for ds in datasets]),
        np.stack([pad(ds[2], 1.0) for ds in datasets]), Ns, device=dev, dtype=dtype)
    logy = [np.log(np.asarray(ds[1])) for ds in datasets]
    xbar = np.asarray([float(np.mean(x)) for x in logy])
    sd5 = np.asarray([5.0 * float(np.std(x)) for x in logy])

    f_min = min(1.0 / float(ds[0][-1] - ds[0][0]) for ds in datasets)
    f_max = max(1.0 / float(np.min(np.diff(np.asarray(ds[0])))) / 2.0 for ds in datasets)
    min_f_b, max_f_b = f_min / 20.0 * 4.0, f_max * 20.0 / 4.0
    # one prior for every dataset: the global f band and a standardized mu
    prior = PriorSet([
        ("alphas", TwoUniformDependent(0.0, 1.5, 4.0)),
        ("f_1", LogUniform(min_f_b, max_f_b)),
        ("variance", LogNormal(2 * -1.5, np.sqrt(2.0) * 1.0)),
        ("nu", Gamma(2.0, 0.5)),
        ("mu_std", Normal(0.0, 1.0)),
    ])
    YN = torch.log(Y)
    xbar_t = torch.as_tensor(xbar, device=dev).to(dtype)
    sd5_t = torch.as_tensor(sd5, device=dev).to(dtype)
    D = len(datasets)

    def loglike_batch(TH):
        # every row's own copy of its dataset's arrays
        rows = torch.repeat_interleave(torch.arange(D, device=dev), TH.shape[0] // D)
        a1, a2, f1, var, nu, mu_std = (TH[:, i] for i in range(6))
        kern = approx(SingleBendingPowerLaw(a1, f1, a2), f_min, f_max, n_components,
                      var, S_low, S_high, basis_function=basis_function)
        a, b, c, d = kern.coefficients()
        mu = xbar_t[rows] + sd5_t[rows] * mu_std
        s2 = nu[:, None] * E[rows] ** 2 / Y[rows] ** 2
        return batched_loglike_multi(a, b, c, d, T[rows], YN[rows] - mu[:, None], s2,
                                     NV[rows], DT[rows])

    def logpost_batch(Z):
        return prior.unconstrained_logpdf(Z) + loglike_batch(prior.from_unconstrained(Z))

    return _ManyModel(prior, loglike_batch, logpost_batch, xbar, sd5, f_min, f_max,
                      (T, DT, Y, E, NV))


def run_inference_many(
    datasets: Sequence[Tuple],
    sampler: str = "chees",
    seed: int = 0,
    num_chains: int = 64,
    num_warmup: int = 500,
    num_samples: int = 500,
    n_components: int = 20,
    basis_function: str = "SHO",
    S_low: float = 20.0,
    S_high: float = 20.0,
    max_leapfrogs: int = 128,
    log_dir: Optional[str] = None,
    mesh=None,
    mesh_axis="chains",
    device=None,
    dtype: torch.dtype = DEFAULT_DTYPE,
) -> List[Dict]:
    """Fit the single-bending model to many light curves in one ensemble.

    ``datasets``: (t, y, yerr) arrays whose lengths may differ. The D
    datasets x ``num_chains`` chains run as one ChEES-HMC ensemble of
    B = D C chains, whose likelihood
    is one ragged batched call with per-chain time grids
    (:func:`~pioran_tpu_torch.ops.cuda_celerite.batched_loglike_multi`:
    per-lane K3 and K4 on the card). One prior serves every dataset: the
    bend-frequency bounds use the global [min f_min, max f_max] band, and
    theta carries a standardized mu_std ~ N(0, 1) with each dataset's
    mu = xbar_d + 5 sd_d mu_std (the mean and standard deviation of its
    log flux), an exact reparametrization of mu ~ N(xbar_d, 5 sd_d).

    The chains start from prior draws and ChEES adapts one diagonal
    metric, one step size and one trajectory length over all B chains.
    Prior draws can leave chains on the flat f_1 plateaus of the
    single-bending likelihood, as they do for :func:`run_inference`; the
    per-dataset r̂ and ``converged`` show which fits that left unmixed.

    Returns one results dict per dataset, with mu in the dataset's own
    units, split-r̂ and bulk/tail ESS, ``ncall`` (every leapfrog of the
    run times the dataset's C chains) and ``converged`` (r̂_max < 1.05);
    with ``log_dir``, writes each dataset's ultranest layout under
    ``log_dir/ds{i}/``. Random numbers come from one ``torch.Generator``
    on ``device`` (default: the card) seeded with ``seed``. Only
    ``sampler="chees"`` exists; ``mesh`` raises ``NotImplementedError``
    until ``parallel/`` is ported.
    """
    if mesh is not None:
        raise NotImplementedError(
            "run_inference_many(mesh=...) is not ported to pioran_tpu_torch yet: "
            "the multi-device paths come with parallel/ (ROADMAP queue 1, step 13)")
    if sampler != "chees":
        raise ValueError(f"run_inference_many runs ChEES-HMC only, got sampler={sampler!r}")
    model = _many_model(datasets, n_components, basis_function, S_low, S_high,
                        device=device, dtype=dtype)
    prior = model.prior
    D, C = len(datasets), num_chains
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    z0 = prior.to_unconstrained(prior.sample((D * C,), generator=gen, dtype=dtype, device=dev))
    t0 = time.time()
    samples_z, stats = run_chees(model.logpost_batch, z0, gen, num_warmup=num_warmup,
                                 num_samples=num_samples, max_leapfrogs=max_leapfrogs)
    elapsed = time.time() - t0

    with torch.no_grad():
        TH = prior.from_unconstrained(samples_z).cpu().numpy()
    S = TH.shape[0]
    TH = TH.reshape(S, D, C, 6).transpose(1, 2, 0, 3)  # (D, C, S, 6)
    names = ["α₁", "α₂", "f₁", "variance", "ν", "μ"]
    # every leapfrog evaluates value+gradient for each dataset's C chains
    ncall = int(stats["n_leapfrogs"].sum()) * C
    results = []
    for i in range(D):
        chains = TH[i].copy()  # (C, S, 6)
        chains[..., 5] = model.xbar[i] + model.sd5[i] * chains[..., 5]
        th = chains.reshape(C * S, 6)
        conv = summarize_chains(chains)
        ess_b = np.asarray(conv["ess_bulk"], np.float64)
        ess_min = float(np.nanmin(ess_b)) if np.any(np.isfinite(ess_b)) else float("nan")
        rhat = np.asarray(conv["rhat"], np.float64)
        res = {
            "paramnames": names,
            "sampler": sampler,
            "elapsed_s": elapsed,
            "posterior": _posterior_summary(th),
            "rhat": conv["rhat"],
            "ess_bulk": conv["ess_bulk"],
            "ess_tail": conv["ess_tail"],
            "ess": ess_min,
            "ess_per_s": ess_min / elapsed if elapsed > 0 else float("nan"),
            "ncall": ncall,
            "converged": (bool(np.nanmax(rhat) < 1.05)
                          if np.any(np.isfinite(rhat)) else False),
        }
        if log_dir:
            _write_ultranest(os.path.join(log_dir, f"ds{i}"), names, th, res)
        res["samples"] = th
        results.append(res)
    return results
