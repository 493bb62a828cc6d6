"""High-level inference entry points, PyTorch port of ``pioran_tpu.inference``.

What is ported: the flagship single-bending power-law model
(:func:`single_bending_model`) and :func:`run_inference` with
``sampler="ns"``, which writes its results in the ultranest layout
(``chains/equal_weighted_post.txt``, ``info/results.json``). The
likelihood of a batch of parameter vectors is one batched PSD ->
celerite approximation (plain PyTorch) feeding the CUDA celerite kernel
on the card, or its plain version on the CPU.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .config import DEFAULT_DTYPE, resolve_device
from .models.psd import SingleBendingPowerLaw
from .ops.approx import approx
from .ops.cuda_celerite import batched_loglike
from .priors import (
    Gamma,
    LogNormal,
    LogUniform,
    Normal,
    PriorSet,
    TwoUniformDependent,
)
from .samplers.ns import equal_weight_indices, run_ns
from .utils.insertion import insertion_order_test

__all__ = ["GPModelSpec", "single_bending_model", "run_inference"]

# samplers of the JAX package that are not ported yet, with the ROADMAP
# item that ports them
_NOT_PORTED = {
    "chees": "ChEES-HMC and ADVI (ROADMAP queue 1, step 7)",
    "advi": "ChEES-HMC and ADVI (ROADMAP queue 1, step 7)",
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


def _batched_loglike_from_coeffs(coeff_fn, t, dt=None):
    """(B, dim) -> (B,) likelihood: the batched parameter -> coefficient
    map feeding the batched celerite likelihood."""

    def loglike_batch(TH):
        a, b, c, d, yv, s2 = coeff_fn(TH)
        return batched_loglike(a, b, c, d, t, yv, s2, dt)

    return loglike_batch


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

    ``device`` (default CPU) and ``dtype`` place the data and every
    likelihood evaluation; on a CUDA device the likelihood runs the
    hand-written kernel.
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


def run_inference(
    spec: GPModelSpec,
    sampler: str = "ns",
    seed: int = 0,
    num_particles: int = 2048,
    num_samples: int = 1000,
    log_dir: Optional[str] = None,
    num_ns_mcmc: int = 8,
    ns_move: str = "slice",
    frac_remain: float = 1e-2,
) -> Dict:
    """Run nested sampling on a model spec and write its artifacts.

    ``sampler="ns"`` is the direct ultranest analog: ``num_particles``
    live points, evidence logZ with an ultranest-style logzerr, an
    equal-weighted posterior and the insertion-order MWW test. Random
    numbers come from one ``torch.Generator`` on the spec's device
    seeded with ``seed``. Returns a results dict with posterior samples
    (theta space), summary moments and the evidence; with ``log_dir``,
    writes ``chains/equal_weighted_post.txt`` and ``info/results.json``.
    Other samplers raise ``NotImplementedError``.
    """
    if sampler in _NOT_PORTED:
        raise NotImplementedError(
            f"sampler={sampler!r} is not ported to pioran_tpu_torch yet: "
            f"{_NOT_PORTED[sampler]}")
    if sampler != "ns":
        raise ValueError(
            f"unknown sampler {sampler!r}; use ns, smc, nuts, chees or advi")
    prior = spec.prior
    t0 = time.time()
    gen = torch.Generator(device=spec.device).manual_seed(seed)

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
    extra = {
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
        "posterior": {
            "mean": theta.mean(axis=0).tolist(),
            "stdev": theta.std(axis=0).tolist(),
            "median": np.median(theta, axis=0).tolist(),
            "errlo": np.quantile(theta, 0.158655, axis=0).tolist(),
            "errup": np.quantile(theta, 0.841345, axis=0).tolist(),
        },
        "maximum_likelihood": {
            "logl": float(np.max(loglikes)),
            "point": theta[int(np.argmax(loglikes))].tolist(),
        },
        **extra,
    }
    if elapsed > 0:
        results["ess_per_s"] = float(results["ess"]) / elapsed

    if log_dir:
        os.makedirs(os.path.join(log_dir, "chains"), exist_ok=True)
        os.makedirs(os.path.join(log_dir, "info"), exist_ok=True)
        # cap the written posterior at 20k equal-weighted rows
        theta_out = theta
        if theta.shape[0] > 20000:
            sel = np.random.default_rng(0).choice(
                theta.shape[0], 20000, replace=False)
            theta_out = theta[np.sort(sel)]
        with open(os.path.join(log_dir, "chains", "equal_weighted_post.txt"), "w") as fh:
            fh.write(" ".join(spec.names) + "\n")
            np.savetxt(fh, theta_out)
        with open(os.path.join(log_dir, "info", "results.json"), "w") as fh:
            json.dump(results, fh, indent=2, ensure_ascii=False)
    results["samples"] = theta
    return results
