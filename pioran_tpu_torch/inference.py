"""High-level inference entry points, PyTorch port of ``pioran_tpu.inference``.

What is ported: the model builders of the JAX package, the flagship
single-bending power-law model (:func:`single_bending_model`), the
double-bending model (:func:`double_bending_model`), a periodic signal
in red noise (:func:`periodic_rednoise_model`) and CARMA(p, q)
(:func:`carma_model`); and :func:`run_inference` with every sampler of
the JAX package: ``sampler="smc"`` (the default), ``"ns"``, ``"nuts"``,
``"chees"`` (NUTS and ChEES-HMC optionally seeded by
:func:`advi_seeded_inits`) and ``"advi"``, which write their results in
the ultranest layout (``chains/equal_weighted_post.txt``,
``info/results.json``); and :func:`run_inference_many`, which fits the
single-bending model to many ragged light curves as one ChEES ensemble.
NS and SMC runs resume from checkpoints (``resume=True``), and every
sampler but ADVI shards over the ranks of a ``DeviceMesh`` (``mesh=``,
``parallel/``). A builder's ``seq_mesh=`` splits the light curve's time
axis over a mesh's ranks instead (``parallel/seq_scan.py``); the samplers
then run replicated on every rank. The likelihood of a batch of parameter vectors is one
batched parameter -> celerite coefficient map (plain PyTorch: the PSD approximation or
CARMA's partial fractions) feeding the CUDA celerite kernels on the card
(K1 or, for ragged per-chain grids, K2 without a gradient; K3 and K4
with one), or their plain versions on the CPU.
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
import torch.distributed as dist

from .config import DEFAULT_DTYPE, resolve_device
from .convert import multi_inputs_from_numpy
from .models.carma import carma_celerite_coefs_real, poly_from_conjugate_pairs
from .models.gp import ConditionedGP, CustomMean, ScalableGP, _mean_vector
from .models.kernels import CeleriteKernel
from .models.psd import DoubleBendingPowerLaw, SingleBendingPowerLaw
from .ops.approx import approx
from .ops.celerite import logl
from .ops.cuda_celerite import batched_loglike, batched_loglike_multi
from .priors import (
    Gamma,
    LogNormal,
    LogUniform,
    Normal,
    PriorSet,
    ThreeUniformDependent,
    TwoLogUniformDependent,
    TwoUniformDependent,
    Uniform,
)
from .parallel.mesh import axis_group, axis_size, check_device
from .parallel.sharded import (
    run_chees_sharded,
    run_nuts_sharded,
    run_smc_sharded,
    sharded_batched_fn,
)
from .samplers.advi import run_advi
from .samplers.chees import run_chees
from .samplers.ns import equal_weight_indices, run_ns, run_ns_resumable
from .samplers.nuts import run_nuts
from .samplers.smc import run_smc, run_smc_resumable
from .utils.insertion import insertion_order_test
from .utils.mcmc_stats import summarize_chains

__all__ = ["GPModelSpec", "single_bending_model", "double_bending_model",
           "periodic_rednoise_model", "carma_model", "advi_seeded_inits",
           "run_inference", "run_inference_many"]

@dataclass
class GPModelSpec:
    """Everything needed to run inference on one light curve.

    ``loglike_batch(TH)`` maps ``(B, dim)`` parameter rows to ``(B,)``
    GP log-likelihoods of the transformed data; ``loglike(th)`` is its
    one-row case. ``prior`` is a PriorSet over theta and ``names``
    label theta's entries. ``gp_model(t, y, yerr, TH)`` takes (P, dim)
    rows of theta in spec order (and t, y, yerr as arrays or tensors) and
    returns one batched ConditionedGP of the P GPs, the input of
    ``diagnostics.run_posterior_predict_checks``; ``psd_model`` is the
    PSD class whose columns ``paramnames_split["psd"]`` name (``None``
    for CARMA, as in the JAX package). Tensors live on ``device`` in
    ``dtype``. ``carma_pq`` is (p, q) for a CARMA model, else ``None``.
    ``seq_mesh`` is the mesh whose ``seq_axis`` splits the time axis
    (the builders' ``seq_mesh=``), else ``None``.
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
    carma_pq: Optional[Tuple[int, int]] = None
    seq_mesh: object = None
    seq_axis: str = "seq"

    def logpost_batch(self, Z):
        """(B, dim) unconstrained rows -> (B,) log-posteriors: the prior's
        unconstrained log-density plus the likelihood of the mapped
        parameters. Differentiable; on the card its gradient runs K3/K4."""
        return self.prior.unconstrained_logpdf(Z) + self.loglike_batch(
            self.prior.from_unconstrained(Z))

    def logpost_unconstrained(self, z):
        """The one-row case of :meth:`logpost_batch`."""
        return self.logpost_batch(z[None])[0]


def _batched_loglike_from_coeffs(coeff_fn, t, dt=None, seq_mesh=None, seq_axis="seq"):
    """(B, dim) -> (B,) likelihood: the batched parameter -> coefficient
    map feeding the batched celerite likelihood.

    With ``seq_mesh`` the time axis is split over the ranks of its
    ``seq_axis`` instead: the batch runs through the pipelined blockwise
    scan (``parallel.seq_scan.logl_seq_pipelined``), in as many
    micro-batches as the axis has ranks."""
    if seq_mesh is not None:
        from .parallel.seq_scan import logl_seq_pipelined

        n_dev = axis_size(seq_mesh, seq_axis)

        def loglike_batch_seq(TH):
            # the pipeline needs B divisible by its micro-batch count (the
            # axis size), and callers such as the final per-sample sweep
            # come with any B: pad with copies of row 0, slice the result
            B = TH.shape[0]
            pad = (-B) % n_dev
            if pad:
                TH = torch.cat([TH, TH[:1].expand(pad, -1)])
            a, b, c, d, yv, s2 = coeff_fn(TH)
            ll = logl_seq_pipelined(a, b, c, d, t, yv, s2, seq_mesh, seq_axis, dt=dt)
            return ll[:B] if pad else ll

        return loglike_batch_seq

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
    if theta.shape[0] == 0:  # a run asked for no draws
        nan = [float("nan")] * theta.shape[1]
        return {k: nan for k in ("mean", "stdev", "median", "errlo", "errup")}
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


class _LightCurve(NamedTuple):
    """One light curve on the device: t, y, yerr in the working dtype,
    dt64 the spacings in float64, and the frequency band."""

    device: torch.device
    dt64: torch.Tensor
    t: torch.Tensor
    y: torch.Tensor
    yerr: torch.Tensor
    f_min: float
    f_max: float


def _light_curve(t, y, yerr, device, dtype) -> _LightCurve:
    dev = resolve_device(device)
    # consecutive spacings computed in host f64 before any f32 cast:
    # diff of an f32 grid loses ~log2(N) bits for long dense series
    dt64 = torch.as_tensor(np.diff(np.asarray(t, np.float64)), device=dev)
    tt, yy, ee = (torch.as_tensor(np.asarray(x), dtype=dtype, device=dev) for x in (t, y, yerr))
    return _LightCurve(dev, dt64, tt, yy, ee, *_freq_range(tt.cpu().numpy()))


def _gp_model(lc: _LightCurve, kernel_fn, mean_fn, noise_fn):
    """A spec's ``gp_model``: (t, y, yerr, (P, dim) theta) -> the batched
    ConditionedGP with kernel ``kernel_fn(TH)``, mean ``mean_fn(TH)``
    and noise variances ``noise_fn(TH, y, yerr)``, in the spec's dtype
    on its device."""

    def gp_model(tt, yy, ee, TH) -> ConditionedGP:
        tt, yy, ee, TH = (torch.as_tensor(x, dtype=lc.t.dtype, device=lc.device)
                          for x in (tt, yy, ee, TH))
        TH = torch.atleast_2d(TH)
        return ScalableGP(mean_fn(TH), kernel_fn(TH))(tt, noise_fn(TH, yy, ee))

    return gp_model


def _spec(lc: _LightCurve, prior, names, paramnames_split, coeff_fn, gp_model, psd_model,
          seq_mesh=None, seq_axis="seq", **extra) -> GPModelSpec:
    """The GPModelSpec of a model whose batched coefficient map is
    ``coeff_fn``: (B, dim) theta -> (a, b, c, d, y - mean, sigma^2).
    With ``seq_mesh`` its time axis is split over the mesh's
    ``seq_axis``: the spec's device must be this rank's on the mesh and
    the axis size must divide N."""
    if seq_mesh is not None:
        check_device(seq_mesh, lc.device)
        n_dev = axis_size(seq_mesh, seq_axis)
        if lc.t.shape[0] % n_dev:
            raise ValueError(f"N={lc.t.shape[0]} not divisible by mesh axis size {n_dev}")
    loglike_batch = _batched_loglike_from_coeffs(coeff_fn, lc.t, dt=lc.dt64,
                                                 seq_mesh=seq_mesh, seq_axis=seq_axis)

    def loglike(th):
        if seq_mesh is None:
            return loglike_batch(th[None])[0]
        a, b, c, d, yv, s2 = coeff_fn(th[None])
        return logl(a[0], b[0], c[0], d[0], lc.t, yv[0], s2[0], dt=lc.dt64, mesh=seq_mesh,
                    seq_axis=seq_axis, seq_min_n=0)

    return GPModelSpec(
        prior=prior, loglike=loglike, names=names,
        gp_model=gp_model, psd_model=psd_model, paramnames_split=paramnames_split,
        t=lc.t.cpu().numpy(), y=lc.y.cpu().numpy(), yerr=lc.yerr.cpu().numpy(),
        f_min=lc.f_min, f_max=lc.f_max, loglike_batch=loglike_batch,
        device=lc.device, dtype=lc.t.dtype, seq_mesh=seq_mesh, seq_axis=seq_axis, **extra)


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
    seq_mesh=None,
    seq_axis: str = "seq",
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

    ``seq_mesh`` (optional): a ``DeviceMesh`` whose ``seq_axis`` splits
    the time axis over its ranks, for series too long for one device
    (``parallel.seq_scan``): ``loglike_batch`` runs the pipelined
    blockwise scan (B padded with copies of row 0 to a multiple of the
    axis size), ``loglike`` the one-chain form. Every rank builds the same
    spec on its own device; N must be divisible by the axis size. The
    other builders take the same four keywords.
    """
    lc = _light_curve(t, y, yerr, device, dtype)
    f_min, f_max = lc.f_min, lc.f_max
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
        items.append(("c", LogUniform(1e-6, float(lc.y.min()) * 0.99)))
        names.append("c")
    yy, ee = lc.y, lc.yerr
    yn = torch.log(yy)

    def kernel_fn(TH):
        a1, a2, f1, var = (TH[:, i] for i in range(4))
        return approx(
            SingleBendingPowerLaw(a1, f1, a2), f_min, f_max,
            n_components, var, S_low, S_high, basis_function=basis_function,
            is_integrated_power=is_integrated_power,
        )

    def noise_fn(TH, y, e):
        scale = (y - TH[:, 6:7]) if use_c else y
        return TH[:, 4:5] * e**2 / scale**2

    def coeff_fn(TH):
        a, b, c, d = kernel_fn(TH).coefficients()
        yv = torch.log(yy - TH[:, 6:7]) if use_c else yn.expand(TH.shape[0], -1)
        return a, b, c, d, yv - TH[:, 5:6], noise_fn(TH, yy, ee)

    return _spec(lc, PriorSet(items), names,
                 {"psd": ["α₁", "f₁", "α₂"], "norm": "variance", "scale_err": "ν", "mean": "μ",
                  **({"log_transform": "c"} if use_c else {})},
                 coeff_fn, _gp_model(lc, kernel_fn, lambda TH: TH[:, 5:6], noise_fn),
                 SingleBendingPowerLaw, seq_mesh=seq_mesh, seq_axis=seq_axis)


def double_bending_model(
    t, y, yerr, xbar, va,
    n_components: int = 20,
    basis_function: str = "SHO",
    device=None,
    dtype: torch.dtype = DEFAULT_DTYPE,
    seq_mesh=None,
    seq_axis: str = "seq",
) -> GPModelSpec:
    """The reference's double-bending power-law model
    (examples/ultranest/double_pl.jl):

    theta = (alpha_1, alpha_2, alpha_3, f_1, f_2, variance, nu, mu);
    alpha_1 ~ U(0, 1.5), alpha_2 ~ U(alpha_1, 4), alpha_3 ~ U(alpha_2, 4);
    f_1 ~ logU(f0*4, fM/4), f_2 ~ logU(f_1, fM/4); the rest, and the
    log-transform with sigma^2 = nu yerr^2 / y^2, as in
    :func:`single_bending_model`.
    """
    lc = _light_curve(t, y, yerr, device, dtype)
    f_min, f_max = lc.f_min, lc.f_max
    min_f_b, max_f_b = f_min / 20.0 * 4.0, f_max * 20.0 / 4.0
    prior = PriorSet([
        ("alphas", ThreeUniformDependent(0.0, 1.5, 4.0)),
        ("f_bends", TwoLogUniformDependent(min_f_b, max_f_b)),
        ("variance", LogNormal(2 * -1.5, np.sqrt(2.0) * 1.0)),
        ("nu", Gamma(2.0, 0.5)),
        ("mu", Normal(xbar, 5.0 * np.sqrt(va))),
    ])
    yn = torch.log(lc.y)

    def kernel_fn(TH):
        a1, a2, a3, f1, f2, var = (TH[:, i] for i in range(6))
        return approx(
            DoubleBendingPowerLaw(a1, f1, a2, f2, a3), f_min, f_max,
            n_components, var, basis_function=basis_function,
        )

    def noise_fn(TH, y, e):
        return TH[:, 6:7] * e**2 / y**2

    def coeff_fn(TH):
        a, b, c, d = kernel_fn(TH).coefficients()
        return a, b, c, d, yn - TH[:, 7:8], noise_fn(TH, lc.y, lc.yerr)

    return _spec(lc, prior, ["α₁", "α₂", "α₃", "f₁", "f₂", "variance", "ν", "μ"],
                 {"psd": ["α₁", "f₁", "α₂", "f₂", "α₃"], "norm": "variance",
                  "scale_err": "ν", "mean": "μ"},
                 coeff_fn, _gp_model(lc, kernel_fn, lambda TH: TH[:, 7:8], noise_fn),
                 DoubleBendingPowerLaw, seq_mesh=seq_mesh, seq_axis=seq_axis)


def periodic_rednoise_model(
    t, y, yerr, xbar, va,
    n_components: int = 20,
    basis_function: str = "SHO",
    device=None,
    dtype: torch.dtype = DEFAULT_DTYPE,
    seq_mesh=None,
    seq_axis: str = "seq",
) -> GPModelSpec:
    """A periodic signal in red noise: the single-bending GP with a
    sinusoidal :class:`~pioran_tpu_torch.models.gp.CustomMean` (reference
    examples/ultranest/single_pl_periodicity.jl:103-148):

    theta = (alpha_1, alpha_2, f_1, variance, nu, mu, A, phi, T0);
    mean(t) = A sin(2 pi t / T0 + phi) + mu, computed in ``dtype`` on the
    working grid; no log-transform: sigma^2 = nu yerr^2. Priors:
    A ~ LogNormal(0, 1), phi ~ U(0, 2 pi), T0 ~ U(0, T_span); the rest as
    in :func:`single_bending_model`.
    """
    lc = _light_curve(t, y, yerr, device, dtype)
    f_min, f_max = lc.f_min, lc.f_max
    min_f_b, max_f_b = f_min / 20.0 * 4.0, f_max * 20.0 / 4.0
    T_span = float(lc.t[-1] - lc.t[0])
    prior = PriorSet([
        ("alphas", TwoUniformDependent(0.0, 1.5, 4.0)),
        ("f_1", LogUniform(min_f_b, max_f_b)),
        ("variance", LogNormal(2 * -1.5, np.sqrt(2.0) * 1.0)),
        ("nu", Gamma(2.0, 0.5)),
        ("mu", Normal(xbar, 5.0 * np.sqrt(va))),
        ("A", LogNormal(0.0, 1.0)),
        ("phi", Uniform(0.0, 2.0 * np.pi)),
        ("T0", Uniform(0.0, T_span)),
    ])

    def kernel_fn(TH):
        a1, a2, f1, var = (TH[:, i] for i in range(4))
        return approx(
            SingleBendingPowerLaw(a1, f1, a2), f_min, f_max,
            n_components, var, basis_function=basis_function,
        )

    def mean(TH):
        """The sinusoidal CustomMean of each row: (B, N) on an (N,) grid."""
        mu, A, phi, T0 = (TH[:, i:i + 1] for i in range(5, 9))
        return CustomMean(lambda x: A * torch.sin(2.0 * math.pi * x / T0 + phi) + mu)

    def noise_fn(TH, y, e):
        return TH[:, 4:5] * e**2

    def coeff_fn(TH):
        a, b, c, d = kernel_fn(TH).coefficients()
        return a, b, c, d, lc.y - _mean_vector(mean(TH), lc.t), noise_fn(TH, lc.y, lc.yerr)

    return _spec(lc, prior, ["α₁", "α₂", "f₁", "variance", "ν", "μ", "A", "ϕ", "T₀"],
                 {"psd": ["α₁", "f₁", "α₂"], "norm": "variance", "scale_err": "ν",
                  "mean": ["A", "ϕ", "T₀", "μ"]},
                 coeff_fn, _gp_model(lc, kernel_fn, mean, noise_fn), SingleBendingPowerLaw,
                 seq_mesh=seq_mesh, seq_axis=seq_axis)


def carma_model(
    t, y, yerr, xbar, va,
    p: int = 2,
    q: int = 0,
    use_c: bool = False,
    mu_n: float = -3.0,
    sigma_n: float = float(np.sqrt(2.0)),
    device=None,
    dtype: torch.dtype = DEFAULT_DTYPE,
    seq_mesh=None,
    seq_axis: str = "seq",
) -> GPModelSpec:
    """The CARMA(p, q) model (reference docs/src/carma.md:63-200).

    The reference parameterizes the AR and MA polynomials by quadratic
    factors x^2 + b x + c with the dependent prior
    ``c ~ U(0, f_max^2) + b^2/4``, ``b ~ logU(2 f_min, 2 f_max)`` (an
    odd order's trailing factor ``~ logU(f_min, f_max)``), and rejects
    parameters whose roots leave the band ``-f_max < Re r < -f_min``,
    ``|Im r| < f_max``. Here, as in the JAX package, theta carries
    ``u = c - b^2/4 ~ U(0, f_max^2)`` itself, so every draw is a
    conjugate pair with ``Re r = -b/2`` in (-f_max, -f_min) and
    ``|Im r| = sqrt(u) < f_max``: the constraint holds with prior
    probability 1. The reference's root-ordering rejection is commented
    out there and left out here.

    theta = [ (u_k, b_k) x p//2, (r_p if p odd),
              (u_k, b_k) x q//2, (r_q if q odd),
              variance, nu, mu, (c if use_c) ],
    variance ~ LogNormal(mu_n, sigma_n). The likelihood runs the real
    partial-fraction path (J = ceil(p/2) celerite terms). With ``use_c``
    the data transform is log(y - c) with sigma^2 = nu yerr^2/(y - c)^2;
    otherwise the log-transform of :func:`single_bending_model`.
    """
    lc = _light_curve(t, y, yerr, device, dtype)
    f_min, f_max = lc.f_min, lc.f_max

    items: List[Tuple[str, object]] = []
    names: List[str] = []
    for tag, order in (("a", p), ("b", q)):
        for k in range(order // 2):
            items.append((f"q{tag}_u{k}", Uniform(0.0, f_max**2)))
            items.append((f"q{tag}_b{k}", LogUniform(2 * f_min, 2 * f_max)))
            names += [f"q{tag}_u{k}", f"q{tag}_b{k}"]
        if order % 2 == 1:
            items.append((f"q{tag}_r", LogUniform(f_min, f_max)))
            names.append(f"q{tag}_r")
    items += [
        ("variance", LogNormal(mu_n, sigma_n)),
        ("nu", Gamma(2.0, 0.5)),
        ("mu", Normal(xbar, 5.0 * np.sqrt(va))),
    ]
    names += ["variance", "ν", "μ"]
    if use_c:
        items.append(("c", LogUniform(1e-6, float(lc.y.min()) * 0.99)))
        names.append("c")
    n_ar = 2 * (p // 2) + (p % 2)
    n_ma = 2 * (q // 2) + (q % 2)
    yy, ee = lc.y, lc.yerr
    yn = torch.log(yy)

    def _roots(TH, i, order):
        """(re, im) lists of the order roots from the (u, b) and r columns
        starting at i, each (B,), and the next column."""
        re_l, im_l = [], []
        for _ in range(order // 2):
            x, yv = -0.5 * TH[:, i + 1], torch.sqrt(TH[:, i])
            re_l += [x, x]
            im_l += [yv, -yv]
            i += 2
        if order % 2 == 1:
            re_l.append(-TH[:, i])
            im_l.append(torch.zeros_like(TH[:, i]))
            i += 1
        return re_l, im_l, i

    i_var = n_ar + n_ma  # the columns of variance, nu, mu and c

    def kernel_fn(TH):
        ar_re, ar_im, i = _roots(TH, 0, p)
        ma_re, ma_im, _ = _roots(TH, i, q)
        if q > 0:
            beta = poly_from_conjugate_pairs(
                ma_re[0:2 * (q // 2):2], ma_im[0:2 * (q // 2):2],
                [ma_re[q - 1]] if q % 2 == 1 else [])
        else:
            beta = TH.new_ones(1)
        return CeleriteKernel(*carma_celerite_coefs_real(p, ar_re, ar_im, beta,
                                                         norm=TH[:, i_var]))

    def noise_fn(TH, y, e):
        scale = (y - TH[:, i_var + 3:i_var + 4]) if use_c else y
        return TH[:, i_var + 1:i_var + 2] * e**2 / scale**2

    def coeff_fn(TH):
        a, b, cc, d = kernel_fn(TH).coefficients()
        yv = torch.log(yy - TH[:, i_var + 3:i_var + 4]) if use_c else yn
        return a, b, cc, d, yv - TH[:, i_var + 2:i_var + 3], noise_fn(TH, yy, ee)

    return _spec(lc, PriorSet(items), names,
                 {"psd": names[: n_ar + n_ma], "norm": "variance", "scale_err": "ν",
                  "mean": "μ", **({"log_transform": "c"} if use_c else {})},
                 coeff_fn, _gp_model(lc, kernel_fn, lambda TH: TH[:, i_var + 2:i_var + 3],
                                     noise_fn),
                 None, seq_mesh=seq_mesh, seq_axis=seq_axis, carma_pq=(p, q))


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


def _run_ns(spec, gen, num_particles, num_samples, num_ns_mcmc, ns_move, frac_remain,
            shard, checkpoint_dir, group=None):
    """Nested sampling: (theta draws, the NS entries of the results). Under
    a mesh its sweeps fan out over the ranks, ``n_delete`` rounded up to a
    multiple of their number; with ``checkpoint_dir`` it resumes, rank 0
    of ``group`` (the ranks a replicated run spans) writing."""
    prior = spec.prior

    def loglike_u_batch(U):
        return spec.loglike_batch(prior.transform(U))

    n_delete = max(num_particles // 8, 1)
    if shard is not None:
        # each rank evaluates its slice of every sweep (the analog of
        # ultranest's MPI likelihood farm)
        n_delete = -(-n_delete // shard.n) * shard.n
        loglike_u_batch = sharded_batched_fn(loglike_u_batch, shard.mesh, shard.axis)
    kw = dict(num_live=num_particles, dim=prior.dim, n_delete=n_delete, num_mcmc=num_ns_mcmc,
              move=ns_move, max_iters=max(8 * num_particles // n_delete, 400),
              frac_remain=frac_remain, dtype=spec.dtype)
    if checkpoint_dir is not None:
        res = run_ns_resumable(loglike_u_batch, gen, checkpoint_dir, group=group, **kw)
    else:
        res = run_ns(loglike_u_batch, gen, **kw)
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


def _chain_inits(spec, gen, num_chains, init):
    """(num_chains, dim) unconstrained starts for the gradient samplers:
    prior draws (``init="prior"``) or an overdispersed ADVI fit
    (``init="advi"``)."""
    prior = spec.prior
    if init == "advi":
        return advi_seeded_inits(spec, gen, num_chains)
    if init == "prior":
        return prior.to_unconstrained(prior.sample(
            (num_chains,), generator=gen, dtype=spec.dtype, device=spec.device))
    raise ValueError(f"init must be 'prior' or 'advi', got {init!r}")


def _mcmc_entries(chains_th, ncall):
    """The MCMC entries of the results from per-chain draws (C, S, dim)
    in theta space."""
    if chains_th.shape[1] == 0:  # a run asked for no draws: no diagnostics
        nan = [float("nan")] * chains_th.shape[2]
        conv = {"rhat": nan, "ess_bulk": nan, "ess_tail": nan}
    else:
        conv = summarize_chains(chains_th)
    ess_b = np.asarray(conv["ess_bulk"], np.float64)
    return {
        "ncall": ncall,
        "rhat": conv["rhat"],
        "ess_bulk": conv["ess_bulk"],
        "ess_tail": conv["ess_tail"],
        # all-NaN for tiny runs (ESS undefined below 4 draws)
        "ess": (float(np.nanmin(ess_b)) if np.any(np.isfinite(ess_b)) else float("nan")),
    }


def _run_chees(spec, gen, num_chains, num_warmup, num_samples, init, mass,
               hmc_max_leapfrogs, shard):
    """ChEES-HMC: (theta draws, the MCMC entries of the results). Under a
    mesh each rank runs its slice of the chains, the adaptation
    statistics all-reduced."""
    prior = spec.prior
    z0 = _chain_inits(spec, gen, num_chains, init)
    kw = dict(num_warmup=num_warmup, num_samples=num_samples, mass=mass,
              max_leapfrogs=hmc_max_leapfrogs)
    if shard is not None:
        samples_z, stats = run_chees_sharded(spec.logpost_batch, z0, gen, shard.mesh,
                                             shard.axis, **kw)
    else:
        samples_z, stats = run_chees(spec.logpost_batch, z0, gen, **kw)
    with torch.no_grad():
        # (S, C, dim) -> (C, S, dim): per-chain draws, in theta space
        chains_th = prior.from_unconstrained(samples_z.transpose(0, 1)).cpu().numpy()
    theta = chains_th.transpose(1, 0, 2).reshape(-1, prior.dim)
    # every leapfrog evaluates value+gradient for all chains
    return theta, _mcmc_entries(chains_th, int(stats["n_leapfrogs"].sum()) * num_chains)


def _run_nuts(spec, gen, num_chains, num_warmup, num_samples, init, shard):
    """NUTS, C chains with per-chain adaptation: (theta draws, chain by
    chain, and the MCMC entries of the results). ``ncall`` is the exact
    count of leapfrogs (value+gradient evaluations), warmup included.
    Under a mesh each rank runs its slice of the chains and the mass
    estimate is pooled over all of them."""
    prior = spec.prior
    z0 = _chain_inits(spec, gen, num_chains, init)
    kw = dict(num_warmup=num_warmup, num_samples=num_samples)
    if shard is not None:
        chains_z, stats = run_nuts_sharded(spec.logpost_batch, z0, gen, shard.mesh,
                                           shard.axis, **kw)
    else:
        chains_z, stats = run_nuts(spec.logpost_batch, z0, gen, **kw)
    with torch.no_grad():
        chains_th = prior.from_unconstrained(chains_z).cpu().numpy()
    ncall = int(stats["num_leaves"].sum()) + int(stats["warmup_num_leaves"].sum())
    return chains_th.reshape(-1, prior.dim), _mcmc_entries(chains_th, ncall)


def _run_smc(spec, gen, num_particles, num_moves, smc_move, shard, checkpoint_dir):
    """Adaptive-tempering SMC: (theta draws, the SMC entries of the
    results). Under a mesh the particles are sharded over the ranks (the
    JAX package's sharded SMC: random-walk moves whatever ``smc_move``
    says); with ``checkpoint_dir`` it resumes."""
    prior = spec.prior
    z0 = prior.to_unconstrained(prior.sample(
        (num_particles,), generator=gen, dtype=spec.dtype, device=spec.device))

    def loglike_z_batch(Z):
        return spec.loglike_batch(prior.from_unconstrained(Z))

    if shard is not None:
        res = run_smc_sharded(loglike_z_batch, prior.unconstrained_logpdf, z0, gen,
                              shard.mesh, shard.axis, num_moves=num_moves)
    elif checkpoint_dir is not None:
        res = run_smc_resumable(loglike_z_batch, prior.unconstrained_logpdf, z0, gen,
                                checkpoint_dir, num_moves=num_moves, move=smc_move)
    else:
        res = run_smc(loglike_z_batch, prior.unconstrained_logpdf, z0, gen,
                      num_moves=num_moves, move=smc_move)
    with torch.no_grad():
        theta = prior.from_unconstrained(res.particles).cpu().numpy()
    return theta, {
        "logz": float(res.logZ),
        "num_temper_steps": int(res.num_steps),
        "ncall": int(res.num_steps) * num_moves * num_particles,
    }


class _Shard(NamedTuple):
    """A run's layout on a mesh: the mesh, the axis (a name or a tuple of
    names) its batch is sharded over, and the number of ranks along it.
    Every rank of the process group runs the same call; rank 0 writes
    files and checkpoints."""

    mesh: object
    axis: object
    n: int


def _shard_layout(mesh, mesh_axis, device) -> Optional[_Shard]:
    """The layout of a run on ``mesh`` (None without one). The default
    axis is every axis of the mesh. Raises unless ``device`` is this
    rank's device on the mesh."""
    if mesh is None:
        return None
    names = tuple(mesh.mesh_dim_names)
    axis = mesh_axis if mesh_axis is not None else (names if len(names) > 1 else names[0])
    check_device(mesh, device)
    return _Shard(mesh, axis, axis_size(mesh, axis))


def _replica_group(spec: GPModelSpec, shard: Optional[_Shard]):
    """The process group a run spans: the whole group under a chain mesh,
    the seq axis's group for a spec whose time axis is split (every rank
    of it runs the sampler replicated), else None (one process)."""
    if shard is not None:
        return dist.group.WORLD
    if spec.seq_mesh is not None:
        return axis_group(spec.seq_mesh, spec.seq_axis)[0]
    return None


def _is_writer(group) -> bool:
    """Whether this process writes a run's files: rank 0 of ``group``."""
    return group is None or dist.get_rank(group) == 0


def _written(group) -> None:
    """Every rank of ``group`` waits until its rank 0 has written the
    run's files."""
    if group is not None:
        dist.barrier(group=group)


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
    sampler: str = "smc",
    seed: int = 0,
    num_particles: int = 2048,
    num_chains: int = 16,
    num_warmup: int = 500,
    num_samples: int = 1000,
    num_moves: int = 8,
    log_dir: Optional[str] = None,
    smc_move: str = "mala",
    resume: bool = False,
    num_ns_mcmc: int = 8,
    ns_move: str = "slice",
    frac_remain: float = 1e-2,
    init: str = "prior",
    mass: str = "diag",
    hmc_max_leapfrogs: int = 128,
    mesh=None,
    mesh_axis=None,
    hmc_stepped: bool = False,
) -> Dict:
    """Run SMC, NS, NUTS, ChEES-HMC or ADVI on a model spec and write its
    artifacts.

    ``sampler="smc"`` (the default) runs adaptive-tempering SMC with
    ``num_particles`` particles from prior draws and ``num_moves`` moves
    (``smc_move`` "mala" or "rwm") a temper step, and reports the evidence
    logZ and the number of temper steps. ``sampler="ns"`` is the direct
    ultranest analog: ``num_particles`` live points, evidence logZ with an
    ultranest-style logzerr, an equal-weighted posterior and the
    insertion-order MWW test. ``sampler="nuts"`` runs ``num_chains`` NUTS
    chains, each with its own dual-averaged step size and diagonal mass
    matrix, for ``num_warmup`` + ``num_samples`` iterations.
    ``sampler="chees"`` runs ``num_chains`` ChEES-HMC chains for
    ``num_warmup`` + ``num_samples`` iterations (at most
    ``hmc_max_leapfrogs`` leapfrogs each) with a ``mass`` "diag" or
    "dense" metric. NUTS and ChEES start from prior draws
    (``init="prior"``) or from an overdispersed ADVI fit (``init="advi"``,
    :func:`advi_seeded_inits`), and report split-r̂ and bulk/tail ESS per
    parameter. ``sampler="advi"`` fits mean-field ADVI for ``num_warmup``
    + ``num_samples`` steps and reports ``num_samples`` draws and the ELBO
    ``logz_lower``. ``ncall`` counts likelihood evaluations: temper steps
    x moves x particles for SMC, the exact leapfrogs for NUTS.
    ``hmc_stepped=True`` is the JAX package's switch to its host-stepped
    ChEES and NUTS drivers, which keep each TPU program short; the port's
    sampler loops run on the host already, so it runs the same path and
    gives the same samples, ``ncall`` and written files. With ``mesh=`` it
    raises ``NotImplementedError``, as the JAX package does.

    Random numbers come from one ``torch.Generator`` on the spec's device
    seeded with ``seed``. Returns a results dict with posterior samples
    (theta space), summary moments and the sampler's own entries, with
    the JAX package's keys; with ``log_dir``, writes
    ``chains/equal_weighted_post.txt`` and ``info/results.json``.

    ``resume=True`` (NS and SMC) checkpoints the run under
    ``log_dir/checkpoints`` and, called again with the same ``log_dir``,
    resumes from the last checkpoint; it raises ``ValueError`` without a
    ``log_dir`` or for another sampler, where the JAX package silently
    starts a fresh run.

    ``mesh``: a ``torch.distributed`` ``DeviceMesh`` (``parallel``) whose
    every rank calls this function with the same arguments, the spec on
    its own device. NS shards its likelihood sweeps (``n_delete``
    rounded up to a multiple of the ranks), SMC its particles (random-walk
    moves, no ``resume``), ChEES and NUTS their chains; ADVI ignores the
    mesh. ``mesh_axis`` names the axes that carry the batch (default:
    all of them); ``num_particles`` or ``num_chains`` must be divisible
    by their size. Every rank returns the same results, with a ``mesh``
    entry; rank 0 writes the files and checkpoints.

    A spec built with ``seq_mesh=`` (its time axis split over the ranks of
    that mesh's axis) runs every sampler replicated on every rank of the
    axis, from the same seed: each likelihood sweep is one collective
    pipelined scan, every rank gets the same values, and the results are
    the same on every rank. Rank 0 of the axis writes the files and NS's
    checkpoints; SMC's ``resume`` is not supported there, and ``mesh=``
    over the same ranks raises ``ValueError``.
    """
    if sampler not in ("smc", "ns", "nuts", "chees", "advi"):
        raise ValueError(
            f"unknown sampler {sampler!r}; use ns, smc, nuts, chees or advi")
    if resume and not log_dir:
        raise ValueError("resume=True needs a log_dir: the checkpoints are written "
                         "under log_dir/checkpoints")
    if resume and sampler not in ("ns", "smc"):
        raise ValueError(f"resume=True resumes NS and SMC runs only, not sampler={sampler!r}")
    if resume and mesh is not None and sampler == "smc":
        raise NotImplementedError(
            "resume is not supported for the mesh-sharded SMC; drop mesh= or resume=")
    if hmc_stepped and mesh is not None and sampler in ("nuts", "chees"):
        raise NotImplementedError(
            f"hmc_stepped is not supported together with mesh= (the sharded "
            f"{'NUTS' if sampler == 'nuts' else 'ChEES'} path has no stepped driver); "
            f"drop one of the two")
    if spec.seq_mesh is not None and mesh is not None:
        raise ValueError("the spec's time axis is split over its seq_mesh's ranks, which run "
                         "the sampler replicated; mesh= cannot shard its batch over them too")
    if resume and spec.seq_mesh is not None and sampler == "smc":
        raise NotImplementedError(
            "resume is not supported for SMC on a seq_mesh spec; drop seq_mesh= or resume=")
    shard = _shard_layout(mesh, mesh_axis, spec.device)
    group = _replica_group(spec, shard)
    if shard is not None and sampler != "advi":
        batch = num_particles if sampler in ("ns", "smc") else num_chains
        what = "num_particles" if sampler in ("ns", "smc") else "num_chains"
        if batch % shard.n:
            raise ValueError(f"{what}={batch} not divisible by the mesh axis size {shard.n}")
    ckpt = os.path.join(log_dir, "checkpoints") if resume else None
    t0 = time.time()
    gen = torch.Generator(device=spec.device).manual_seed(seed)
    if sampler == "smc":
        theta, extra = _run_smc(spec, gen, num_particles, num_moves, smc_move, shard, ckpt)
    elif sampler == "ns":
        theta, extra = _run_ns(spec, gen, num_particles, num_samples, num_ns_mcmc,
                               ns_move, frac_remain, shard, ckpt, group)
    elif sampler == "nuts":
        theta, extra = _run_nuts(spec, gen, num_chains, num_warmup, num_samples, init, shard)
    elif sampler == "chees":
        theta, extra = _run_chees(spec, gen, num_chains, num_warmup, num_samples,
                                  init, mass, hmc_max_leapfrogs, shard)
    else:
        theta, extra = _run_advi(spec, gen, num_warmup, num_samples)
    elapsed = time.time() - t0

    # final per-sample likelihoods, chunked
    TH_all = torch.as_tensor(theta, dtype=spec.dtype, device=spec.device)
    loglikes = np.concatenate([np.zeros(0)] + [
        spec.loglike_batch(TH_all[i:i + _FINAL_LOGLIKE_CHUNK]).cpu().numpy()
        for i in range(0, TH_all.shape[0], _FINAL_LOGLIKE_CHUNK)])
    ml = ({"logl": float(np.max(loglikes)), "point": theta[int(np.argmax(loglikes))].tolist()}
          if loglikes.size else {"logl": float("nan"), "point": [float("nan")] * theta.shape[1]})
    results = {
        "paramnames": spec.names,
        "sampler": sampler,
        "elapsed_s": elapsed,
        "posterior": _posterior_summary(theta),
        "maximum_likelihood": ml,
        **extra,
    }
    if "ess" in results and elapsed > 0:
        results["ess_per_s"] = float(results["ess"]) / elapsed
    if shard is not None:
        results["mesh"] = {
            "axes": {name: int(mesh.size(i)) for i, name in enumerate(mesh.mesh_dim_names)},
            "shard_axes": list(shard.axis) if isinstance(shard.axis, tuple) else str(shard.axis),
            "n_devices_sharded": shard.n,
        }

    if log_dir and _is_writer(group):
        # cap the written posterior at 20k equal-weighted rows
        theta_out = theta
        if theta.shape[0] > 20000:
            sel = np.random.default_rng(0).choice(
                theta.shape[0], 20000, replace=False)
            theta_out = theta[np.sort(sel)]
        _write_ultranest(log_dir, spec.names, theta_out, results)
    if log_dir:
        _written(group)
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
    returns them. Built with ``lanes``, the dataset of each row this
    process holds, ``loglike_batch`` takes just those rows."""

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
                device=None, dtype: torch.dtype = DEFAULT_DTYPE,
                lanes: Optional[torch.Tensor] = None) -> _ManyModel:
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
        if lanes is None:
            rows = torch.repeat_interleave(torch.arange(D, device=dev), TH.shape[0] // D)
        elif TH.shape[0] != lanes.shape[0]:
            raise ValueError(f"{TH.shape[0]} rows for a model of {lanes.shape[0]} lanes")
        else:
            rows = lanes
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
    ``sampler="chees"`` exists.

    ``mesh``: a ``DeviceMesh`` whose every rank calls this function with
    the same arguments, ``device`` its own. The B chains are sharded
    over ``mesh_axis``: each rank runs the per-lane kernels on its own
    slice of the padded lanes, and ChEES's statistics are all-reduced
    (``parallel.run_chees_sharded``), so the run is the unsharded one up
    to the order of the reductions. B must be divisible by the axis size.
    Rank 0 writes the files.
    """
    if sampler != "chees":
        raise ValueError(f"run_inference_many runs ChEES-HMC only, got sampler={sampler!r}")
    D, C = len(datasets), num_chains
    dev = resolve_device(device)
    shard = _shard_layout(mesh, mesh_axis, dev)
    lanes = None
    if shard is not None:
        if (D * C) % shard.n:
            raise ValueError(f"B={D * C} chains not divisible by mesh axis {mesh_axis} "
                             f"of size {shard.n}")
        _, r, n = axis_group(mesh, shard.axis)
        m = D * C // n
        lanes = torch.arange(r * m, (r + 1) * m, device=dev) // C
    model = _many_model(datasets, n_components, basis_function, S_low, S_high,
                        device=dev, dtype=dtype, lanes=lanes)
    prior = model.prior
    gen = torch.Generator(device=dev).manual_seed(seed)
    z0 = prior.to_unconstrained(prior.sample((D * C,), generator=gen, dtype=dtype, device=dev))
    t0 = time.time()
    kw = dict(num_warmup=num_warmup, num_samples=num_samples, max_leapfrogs=max_leapfrogs)
    if shard is not None:
        samples_z, stats = run_chees_sharded(model.logpost_batch, z0, gen, mesh, shard.axis,
                                             **kw)
    else:
        samples_z, stats = run_chees(model.logpost_batch, z0, gen, **kw)
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
        if log_dir and _is_writer(None if shard is None else dist.group.WORLD):
            _write_ultranest(os.path.join(log_dir, f"ds{i}"), names, th, res)
        res["samples"] = th
        results.append(res)
    if log_dir:
        _written(None if shard is None else dist.group.WORLD)
    return results
