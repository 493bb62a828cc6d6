#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--out DIR]

It builds the CUDA kernels from ``pioran_tpu_torch/csrc`` with nvcc
(K1, the forward ``celerite_fwd``; K3 and K4, the adjoint pair
``celerite_fwd_aug`` and ``celerite_bwd``; their per-lane forms for
ragged per-chain time grids: K2 ``celerite_fwd_multi``,
``celerite_fwd_aug_multi`` and ``celerite_bwd_multi``; K0, the
table-streaming forward ``celerite_tables``; the carry entries of K1,
K3 and K4 for one block of a series split along time, ``*_carry``; and
the wide forms of all ten past 32 terms, ``celerite_wide_*``), checks
each against its
plain PyTorch version, and drives the port's main paths with
the flagship single-bending model (J = 20): on the reference's 485-point
light curve, nested sampling (``run_inference(sampler="ns")``, 1024 live
points, gated against the reference's ultranest evidence) and ChEES-HMC
seeded by ADVI with a dense metric (``run_inference(sampler="chees")``,
512 chains, 500 + 1800 iterations, gated against the importance-sampling
referee and on split-r̂); then the multi-dataset path on 16 ragged light
curves: a no-gradient sweep of ``batched_loglike_multi`` (K2) and
``run_inference_many`` (64 chains each from prior draws, 150 + 150
iterations, per-lane K3/K4; every dataset's mu gated, dataset 0, the
reference's subset, reported against the referee); then K0 through its
entry point ``batched_loglike_tables`` (ten flagship sweeps at B = 4096),
tempered SMC (``run_inference(sampler="smc")``, 1024 particles, 12 MALA
moves, gated on the reference's evidence and the referee) and NUTS (on a
correlated Gaussian on the card, with the analytic gates; and
``run_inference(sampler="nuts", init="advi")`` on the flagship, 16
chains, checked for finite draws and its exact leapfrog count), and the
host-stepped drivers (phase 16b): ``run_nuts_stepped`` on that Gaussian
and ``run_inference(hmc_stepped=True)`` on the flagship, NUTS and ChEES,
bit-equal to the unstepped runs, and ``value_and_grad_tables`` bit-equal
to K3 then K4. Then the
other model builders: the double-bending and periodic-in-red-noise
models (J = 20, on their committed 485-point light curves) and CARMA(2,1)
and CARMA(3,2) (J = 1 and 2, on the flagship subset), each at its stored
maximum-likelihood point, with K1 and K3/K4 against their plain versions
on the model's own coefficients and its float64 gradient; and
``run_inference(sampler="smc")`` on the double-bending, periodic and
CARMA(2,1) models, gated as the JAX package's parity runs are (logZ,
posterior pulls and widths). Last, the post-fit path in float64: the GP
objects' logpdf at the flagship point (K1), its gradient and the
posterior solve (K3/K4), the posterior mean and covariance against the
dense predictors, prior draws, and ``run_posterior_predict_checks`` on
the SMC posterior (without figures: the card's machine has no
matplotlib). Then checkpoint and resume: flagship SMC and NS through
``run_inference(resume=True)``, resumed from a mid-run checkpoint and
gated bit-equal to the uninterrupted run; and the multi-device code at
world size 1 on an in-process NCCL group: sharded NS and ChEES against
their unsharded runs, sharded SMC against the evidence gate, sharded
NUTS with its pooled mass.
Between them it checks the flagship gradients and the N = 2^16 gradient.
Last, past 32 terms (phase 22): the DRWCelerite basis (two terms a
component; J = 40 at the default 20 components): the wide kernels' times
at J = 40 and 64 and the float64 value at the referee mean against the
JAX package's (22a), ``run_inference(sampler="smc")`` on the DRWCelerite
flagship through the wide K1 and K3/K4 alone (22b; gated on the
evidence ± 1.5 and the referee), then every wide kernel against its
plain version at J = 40, 70, 100 and 128 (J = 40 also at the fit's 1024
particles; the per-lane forms at J = 40, 100 and 128; K0 at 40, 100 and
128) and the entry points that no sampler
runs here: the DRWCelerite many-model's sweeps and gradient (the wide K2
and per-lane K3/K4) and ``batched_loglike_tables`` (the wide K0) (22),
past the registers too (22c, 22d).
Then the time-sharded scan (phase 23, ``parallel/seq_scan.py``): the
carry entries of K1, K3 and K4 (``celerite_fwd_carry``,
``celerite_fwd_aug_carry``, ``celerite_bwd_carry`` and their wide forms,
at J = 100 past the registers), each chained over 4 blocks of a series of
2^14 points through the ring's one-block helper and held against one
launch of the entry without a carry (float64 1e-9) and, at 4 x 133
points, against the chained plain loops (23a), their times on a block of
4096 steps beside the entries without a carry and their plain versions'
on its first 512 steps (23c), and ``single_bending_model(seq_mesh=)`` on
a one-rank NCCL group, SHO (J = 20) and DRWCelerite (J = 40) on a
simulated light curve of 2^15 points and DRWCelerite at 50 components
(J = 100) on its first 2^14, against the spec without ``seq_mesh``
(float64 1e-12), with the plain loops made to raise (23b). ``--seed``
seeds its series (numpy).
Last, the example scripts and the Kalman filters (phase 24): the four
model CLIs' ``main`` (``pioran_tpu_torch.examples.single_pl``,
``double_pl``, ``single_pl_periodicity``, ``carma``; SMC with 1024
particles and 12 MALA moves on the repository's light curves, each in a
temporary directory), gated on their output layout, the JAX package's
result keys, a finite evidence and posterior and K1/K3/K4 launches (24a);
the parity CLI's SMC legs on the single and docs datasets, gated on
every run's pass (24b); and ``ops.kalman``'s sequential and associative
filters in float64 on the flagship light curve with the SHO (J = 20) and
DRWCelerite (J = 40) bases against K1's value (1e-8 and 1e-6 relative)
(24c).

The phases run in this order: the build, the kernel checks and timings
(2-4, 6-8, 10, 11, 13), SMC, the post-fit path, resume, the multi-device
code, the wide kernels' times and fit and the seq scan (14, 19-21, 22a,
22b, 23); then
phase 9, the ChEES fit, starts in a child process of this script
(``--only-chees``) and runs on the same card while this process runs NS,
the multi-dataset run, NUTS, the host-stepped drivers, the other
builders, the wide kernels' checks and the CLIs (5, 12, 15-18, 16b, 22,
24). The host-bound samplers
then share the card and the host, so those phases' walls are not those
of a run alone; with
``--serial`` (or on a card whose compute mode is not Default) phase 9 runs
in this process at that point and every phase runs alone.
Each phase prints its lines; any failure exits non-zero before the result
lines. The last two lines are the kernel table (JSON) and
``{"ok": true, "device": {...}}``. Without a card it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "tests", "data")
FLAGSHIP_THETA = [0.761, 2.777, 0.00414, 0.0223, 1.113, 0.247]  # spec order
FLAGSHIP_LL64 = 1533.8193151727223  # JAX package, CPU, float64
REF_LOGZ, LOGZ_TOL = 1014.013, 0.90  # reference ultranest; 3x its logzerr
ADJOINT_SRC = "pioran_tpu_torch/csrc/celerite_adjoint.cu"
FWD_SRC = "pioran_tpu_torch/csrc/celerite_fwd.cu"
TABLES_SRC = "pioran_tpu_torch/csrc/celerite_tables.cu"
WIDE_SRC = "pioran_tpu_torch/csrc/celerite_wide.cu"
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "celerite_fwd": (FWD_SRC, "pioran_tpu/ops/pallas_celerite.py:252"),  # _fused_kernel
    "celerite_fwd_aug": (ADJOINT_SRC, "pioran_tpu/ops/pallas_celerite_vjp.py:127"),
    "celerite_bwd": (ADJOINT_SRC, "pioran_tpu/ops/pallas_celerite_vjp.py:540"),
    # the same TPU kernels with per_lane_t=True (K2 is launched at :521)
    "celerite_fwd_multi": (FWD_SRC, "pioran_tpu/ops/pallas_celerite.py:252"),
    "celerite_fwd_aug_multi": (ADJOINT_SRC, "pioran_tpu/ops/pallas_celerite_vjp.py:127"),
    "celerite_bwd_multi": (ADJOINT_SRC, "pioran_tpu/ops/pallas_celerite_vjp.py:540"),
    # _kernel, launched at :232 by batched_loglike_pallas
    "celerite_tables": (TABLES_SRC, "pioran_tpu/ops/pallas_celerite.py:96"),
    # the wide forms past 32 terms, of the same TPU kernels
    "celerite_wide_fwd": (WIDE_SRC, "pioran_tpu/ops/pallas_celerite.py:252"),
    "celerite_wide_fwd_aug": (WIDE_SRC, "pioran_tpu/ops/pallas_celerite_vjp.py:127"),
    "celerite_wide_bwd": (WIDE_SRC, "pioran_tpu/ops/pallas_celerite_vjp.py:540"),
    "celerite_wide_fwd_multi": (WIDE_SRC, "pioran_tpu/ops/pallas_celerite.py:252"),
    "celerite_wide_fwd_aug_multi": (WIDE_SRC, "pioran_tpu/ops/pallas_celerite_vjp.py:127"),
    "celerite_wide_bwd_multi": (WIDE_SRC, "pioran_tpu/ops/pallas_celerite_vjp.py:540"),
    "celerite_wide_tables": (WIDE_SRC, "pioran_tpu/ops/pallas_celerite.py:96"),
    # the wide forms past the registers (J > 64), at J = 100 and 128:
    # shared grid, per lane, and K0 at J = 100
    **{f"celerite_wide_{k}{lane}_j{2 * nc}": (WIDE_SRC, f"pioran_tpu/ops/{line}")
       for lane in ("", "_multi") for nc in (50, 64)
       for k, line in (("fwd", "pallas_celerite.py:252"),
                       ("fwd_aug", "pallas_celerite_vjp.py:127"),
                       ("bwd", "pallas_celerite_vjp.py:540"))},
    "celerite_wide_tables_j100": (WIDE_SRC, "pioran_tpu/ops/pallas_celerite.py:96"),
    # the carry entries (a block of a split series), narrow and wide, of
    # the TPU kernels whose carry refs they port
    "celerite_fwd_carry": (FWD_SRC, "pioran_tpu/ops/pallas_celerite.py:252"),
    "celerite_fwd_aug_carry": (ADJOINT_SRC, "pioran_tpu/ops/pallas_celerite_vjp.py:127"),
    "celerite_bwd_carry": (ADJOINT_SRC, "pioran_tpu/ops/pallas_celerite_vjp.py:540"),
    "celerite_wide_fwd_carry": (WIDE_SRC, "pioran_tpu/ops/pallas_celerite.py:252"),
    "celerite_wide_fwd_aug_carry": (WIDE_SRC, "pioran_tpu/ops/pallas_celerite_vjp.py:127"),
    "celerite_wide_bwd_carry": (WIDE_SRC, "pioran_tpu/ops/pallas_celerite_vjp.py:540"),
    # the wide carry entries past the registers, at J = 100
    "celerite_wide_fwd_carry_j100": (WIDE_SRC, "pioran_tpu/ops/pallas_celerite.py:252"),
    "celerite_wide_fwd_aug_carry_j100": (WIDE_SRC, "pioran_tpu/ops/pallas_celerite_vjp.py:127"),
    "celerite_wide_bwd_carry_j100": (WIDE_SRC, "pioran_tpu/ops/pallas_celerite_vjp.py:540"),
}
PHASE2_BATCHES = (128, 4096, 1000, 1024)  # NS sweep, final sweep, ragged edge, SMC sweep
PHASE2_TIMED = (128, 1024, 4096)
ADJ_BATCHES = (512, 8, 1000)        # ChEES batch, small, ragged edge
NS_LIVE = 1024
# 2400 samples until the builders' phases 17-18 joined the script; cut by
# a quarter, with phase 15's depth halved, to keep the script inside its
# time limit on the slowest card host
CHEES = dict(num_chains=512, num_warmup=500, num_samples=1800, hmc_max_leapfrogs=128)
MULTI_BATCHES = (1024, 4096, 1000)  # the run_inference_many batch, large, ragged edge
ADJ_MULTI_BATCHES = (1024, 7)      # the run_inference_many batch, ragged edge
MANY_D = 16                         # datasets of the multi-dataset run
# 64 chains (the JAX default) at 150 + 150 of the JAX default's 500 + 500
# iterations, for the script's time limit: its gates (finite draws, every
# mu within 2.0 of its log-mean) do not depend on the depth
MANY = dict(num_chains=64, num_warmup=150, num_samples=150, max_leapfrogs=128)
PATH_A_SWEEPS = 10                  # no-gradient K2 sweeps over the run's batch
TABLES_BATCHES = (128, 4096, 1000, 1024)  # K0: NS sweep, final sweep, ragged edge, SMC sweep
TABLES_TIMED = (128, 1024, 4096)
TABLES_SWEEPS = 10                  # flagship sweeps through batched_loglike_tables
SMC_LOGZ_TOL = 1.0                  # examples/tpu_parity.py's logz_tol for "single"
SMC = dict(num_particles=1024, num_moves=12)  # the committed parity run's settings
# 16 chains, the JAX default. Its leaves are host-bound: at 80 iterations
# (67,837 leaves) the whole script took 1129 s of its 1200 s limit on the
# slowest card host seen; 50 iterations took 45,760 leaves and 85 s on a
# fast host; cut again to 16 (its gates, finite draws and the exact
# leapfrog count, do not depend on the depth; 8 draws a chain are the
# fewest whose split halves the ESS estimator accepts)
NUTS_FLAGSHIP = dict(num_chains=16, num_warmup=8, num_samples=8)
NUTS_GAUSSIAN = dict(num_warmup=150, num_samples=250)  # halved from 300 + 500 with CHEES
# phase 16b: stepped NUTS on phase 15's Gaussian (34 warmup iterations, the
# fewest with a mass refresh), and the flagship's host-stepped runs, each
# against the same call without hmc_stepped (f32, prior inits). From prior
# draws NUTS's trees sit near the depth cap, about 200 leaf steps an
# iteration of 16-19 ms each on one H100: 10 + 10 iterations took 80 s a
# run, so 2 + 3. The stepped drivers call run_nuts and run_chees, and no
# code reads their block past its check, so no iteration count is special
STEPPED_GAUSSIAN = dict(num_warmup=34, num_samples=16)
STEPPED_NUTS = dict(num_chains=8, num_warmup=2, num_samples=3, seed=3)
STEPPED_CHEES = dict(num_chains=64, num_warmup=30, num_samples=20, mass="dense", seed=4)
# the other model builders: dataset, light curve, builder, its keywords,
# stored order -> spec order of the stored ML point (None: no reference
# run), J
BUILDERS = {
    "double": ("simu_double", "simu_double_subset_time_series.txt", "double_bending_model",
               {}, [0, 2, 4, 1, 3, 5, 6, 7], 20),
    "periodic": ("simu_periodic", "simu_periodic_rednoise_subset_time_series.txt",
                 "periodic_rednoise_model", {}, [0, 2, 1, 3, 4, 5, 6, 7, 8], 20),
    "carma21": ("simu_single", "simu_single_subset_time_series.txt", "carma_model",
                {"p": 2, "q": 1}, None, 1),
    "carma32": ("simu_single", "simu_single_subset_time_series.txt", "carma_model",
                {"p": 3, "q": 2}, None, 2),
}
BUILDER_BATCHES = (1024, 1000)      # the SMC sweep, ragged edge
SMC_BUILDERS = ("double", "periodic", "carma21")  # the JAX package's parity runs
PARITY = os.path.join(HERE, "artifacts", "tpu_parity")
# phases 20-21: NS at 256 live points with two random-walk steps an
# iteration (the gates are equalities, not the evidence: phase 5 holds
# that), ChEES at 64 chains with at most 8 leapfrogs a trajectory, NUTS
# at 16 chains to the end of its first slow window (34 warmup iterations)
# with trees of depth <= 4
RESUME_NS = dict(num_particles=256, num_ns_mcmc=2, ns_move="rwm", num_samples=500)
MD_CHEES = dict(num_chains=64, num_warmup=100, num_samples=100, hmc_max_leapfrogs=8)
MD_NUTS = dict(num_warmup=34, num_samples=6, max_depth=4)
MD_NUTS_CHAINS = 16
# phase 22: the DRWCelerite basis (two terms a component) at 20, 35, 50
# and 64 components, J = 40, 70, 100, 128; timed at 20 and 32 components
# (J = 40, 64) and, past the registers, at 50 and 64 (J = 100, 128), whose
# entry-point paths (22c) give those rows' launches
WIDE_NC = (20, 35, 50, 64)
WIDE_TIMED_NC = (20, 32)
WIDE_PAST_NC = (50, 64)
WIDE_BATCHES = (64, 65)             # a batch, and a ragged one
PAST_SWEEPS = 3                     # no-gradient and table sweeps past the registers
DRW_LL64 = 1021.110678373424        # JAX package, CPU, float64, at the referee mean
# phase 14's 1.0 widened by the basis's +0.37 nats at the referee mean
# (tests/test_torch_inference.py) and the fit's own noise
DRW_LOGZ_TOL = 1.5
# the H100 SXM's published peaks: HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_S, F32_OPS_S = 3.35e12, 67e12


class PhaseError(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise PhaseError(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def once_ms(fn) -> float:
    """Milliseconds of one run of ``fn()``, by CUDA events, with no warm-up
    (for a plain loop that has already run at the same width)."""
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def load_curve(dirname, fname):
    """A committed light curve (t, y, yerr columns) and its #mean: header."""
    path = os.path.join(DATA, dirname, fname)
    xbar = va = None
    with open(path) as fh:
        for line in fh:
            if line.startswith("#mean: "):
                left, right = line[len("#mean: "):].split(" va: ")
                xbar, va = float(left), float(right)
                break
    return np.loadtxt(path), xbar, va


def load_subset():
    """The reference's 485-point light curve and its #mean: header."""
    return load_curve("simu_single", "simu_single_subset_time_series.txt")


def k1_cost(B: int, J: int = 20, N: int = 485, item: int = 4):
    """(bytes, operations) of one K1 launch: inputs read once, the output
    written once; about 20 J^2 operations a chain-step."""
    return item * (4 * B * J + 2 * N - 1 + 2 * B * N + B), 20.0 * J * J * B * N


def bound(nbytes: float, ops: float):
    """(ms, "bytes" or "operations"): the least time the card could take
    for the bytes moved at the HBM rate and the float32 operations at the
    peak rate outside the tensor cores."""
    tb, to = nbytes / HBM_BYTES_S, ops / F32_OPS_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def referee():
    with open(os.path.join(DATA, "simu_single", "is_referee.json")) as fh:
        return json.load(fh)


def referee_thetas(spec, B, gen):
    """B parameter rows scattered around the reference posterior (0.3 sd),
    clamped inside the prior's support."""
    ref = referee()
    dev, dt = spec.device, spec.dtype
    mean = torch.tensor(ref["is_mean"], dtype=dt, device=dev)
    sd = torch.tensor(ref["is_std"], dtype=dt, device=dev)
    th = mean + 0.3 * sd * torch.randn((B, 6), generator=gen, dtype=dt, device=dev)
    f_lo, f_hi = spec.f_min / 20.0 * 4.0, spec.f_max * 20.0 / 4.0
    th[:, 0] = th[:, 0].clamp(0.01, 1.49)
    th[:, 1] = torch.maximum(th[:, 1], th[:, 0] + 0.01).clamp(max=3.99)
    th[:, 2] = th[:, 2].clamp(f_lo * 1.01, f_hi * 0.99)
    th[:, 3] = th[:, 3].clamp(min=1e-4)
    th[:, 4] = th[:, 4].clamp(min=0.2)
    return th


def flagship_coefficients(spec, B, gen, n_components=20, basis_function="SHO"):
    """(theta, a, b, c, d) at B rows from :func:`referee_thetas`, through
    the port's own basis approximation (J = n_components, twice that for
    DRWCelerite); lane 0 is forced non-positive-definite."""
    from pioran_tpu_torch import SingleBendingPowerLaw, approx

    th = referee_thetas(spec, B, gen)
    kern = approx(SingleBendingPowerLaw(th[:, 0], th[:, 2], th[:, 1]),
                  spec.f_min, spec.f_max, n_components, th[:, 3],
                  basis_function=basis_function)
    a, b, c, d = (x.contiguous() for x in kern.coefficients())
    a[0] = -50.0 * a[0]
    return th, a, b, c, d


def flagship_inputs(spec, B, gen, **basis):
    """(a, b, c, d, y, sigma2) at B rows from :func:`flagship_coefficients`
    (``basis``: its n_components and basis_function) on the spec's own
    light curve; lane 0 is not positive definite."""
    dev, dt = spec.device, spec.dtype
    th, a, b, c, d = flagship_coefficients(spec, B, gen, **basis)
    y = torch.as_tensor(spec.y, dtype=dt, device=dev)
    e = torch.as_tensor(spec.yerr, dtype=dt, device=dev)
    yv = (torch.log(y)[None, :] - th[:, 5:6]).contiguous()
    s2 = (th[:, 4:5] * e**2 / y**2).contiguous()
    return a, b, c, d, yv, s2


def many_datasets():
    """The multi-dataset run's 16 ragged light curves: dataset 0 is the
    reference's 485-point subset; datasets 1-15 are windows of the long
    simulated series, one starting every 1000 points, 256-489 consecutive
    points long (lengths from a seeded generator), each thinned by
    dropping 3 % of its points at random, as the committed subsets were
    made. Every window spans less than dataset 0's 729.5 and keeps
    spacings >= 0.3 > dataset 0's 0.25, so the global frequency band is
    dataset 0's own (checked by the caller)."""
    sub, _, _ = load_subset()
    out = [(sub[:, 0], sub[:, 1], sub[:, 2])]
    A = np.loadtxt(os.path.join(DATA, "simu_longn", "longn_time_series.txt"))
    rng = np.random.default_rng(2024)
    for k in range(MANY_D - 1):
        width = int(rng.integers(256, 490))
        win = A[1000 * k:1000 * k + width]
        keep = np.sort(rng.choice(width, width - round(0.03 * width), replace=False))
        out.append(tuple(win[keep].T))
    return out


def multi_inputs(spec, model, B, gen, **basis):
    """(a, b, c, d, T, y, sigma2, n_valid, DT) at B ragged rows: the
    flagship coefficients of :func:`flagship_coefficients` (``basis`` as
    there) on dataset i mod D's light curve, padded as the multi-dataset
    model pads it; lane 0 is not positive definite. sigma2 is left as the
    model gives it on the padding."""
    th, a, b, c, d = flagship_coefficients(spec, B, gen, **basis)
    rows = torch.arange(B, device=spec.device) % model.data[0].shape[0]
    T, DT, Y, E, NV = (x[rows].contiguous() for x in model.data)
    yv = (torch.log(Y) - th[:, 5:6]).contiguous()
    s2 = (th[:, 4:5] * E**2 / Y**2).contiguous()
    return a, b, c, d, T, yv, s2, NV, DT


def phase_build():
    from pioran_tpu_torch import _build
    from pioran_tpu_torch.config import require_cuda

    dev = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    libs = ("celerite_fwd", "celerite_adjoint", "celerite_adjoint_carry", "celerite_tables",
            "celerite_wide")
    t0 = time.perf_counter()
    _build.load_all(libs)  # one nvcc per source, started together
    wall = time.perf_counter() - t0
    for name in libs:
        seconds, log = _build.build_info(name)
        print(f"phase 1 build: {name} nvcc_s={seconds:.2f} ptxas: {ptxas_summary(log)}")
    print(f"phase 1 build: ok device={torch.cuda.get_device_name(0)!r} wall_s={wall:.2f}")
    return dev, smi


def ptxas_summary(log: str) -> str:
    """'kernel<type,JP,grid[,carry]> regs spill stores/loads' for each
    entry function in nvcc's -Xptxas -v output (grid: shared or per-lane
    t; tables for K0; carry: the carry entry); the wide kernels as
    split_fwd<type,cpt,grid[,aug][,carry][,tail]> and
    split_bwd<type,cpt,grid[,carry][,tail]> (tail: past the registers)."""
    out, cur, spill = [], None, None
    for ln in log.splitlines():
        m = re.search(r"(?<![a-z_])(celerite_fwd_kernel|fwd_aug_kernel|bwd_kernel|"
                      r"celerite_tables_kernel)"
                      r"I([fd])Li(\d+)E((?:Lb[01]E)*)", ln)
        w = re.search(r"(wide|split)_(fwd|bwd)_kernelI([fd])((?:Li\d+E)*)((?:Lb[01]E)*)", ln)
        if "Compiling entry function" in ln and m:
            flags = re.findall(r"Lb([01])E", m.group(4))
            grid = "tables" if not flags else ("per-lane" if flags[0] == "1" else "shared")
            grid += ",carry" if flags[1:] == ["1"] else ""
            cur, spill = f"{m.group(1)}<{m.group(2)},{m.group(3)},{grid}>", None
            continue
        if "Compiling entry function" in ln and w:
            ints = re.findall(r"Li(\d+)E", w.group(4))
            first, carry, tail = (re.findall(r"Lb([01])E", w.group(5)) + ["0"] * 3)[:3]
            cpt = f"{ints.pop(0)}," if w.group(1) == "split" else ""
            if w.group(2) == "fwd":
                grid = ("shared", "per-lane", "tables")[int(ints[0])]
                tag = grid + (",aug" if first == "1" else "")
            else:
                tag = "per-lane" if first == "1" else "shared"
            tag += (",carry" if carry == "1" else "") + (",tail" if tail == "1" else "")
            cur, spill = f"{w.group(1)}_{w.group(2)}<{w.group(3)},{cpt}{tag}>", None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if cur and m and spill is None:
            spill = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", ln)
        if cur and m:
            out.append(f"{cur} {m.group(1)}r spill {spill or '0/0'}")
            cur = None
    return "; ".join(out)


def phase_kernel_vs_plain(spec64, spec32):
    from pioran_tpu_torch.ops.cuda_celerite import (
        batched_loglike, batched_loglike_plain)

    gen = torch.Generator(device=spec64.device).manual_seed(1)
    worst = {torch.float64: 0.0, torch.float32: 0.0}
    times = {}
    t64 = torch.as_tensor(spec64.t, dtype=torch.float64, device=spec64.device)
    dt64 = torch.as_tensor(np.diff(spec64.t.astype(np.float64)), device=spec64.device)
    for spec in (spec64, spec32):
        dtype = spec.dtype
        t = t64.to(dtype)
        for B in PHASE2_BATCHES:
            a, b, c, d, y, s2 = flagship_inputs(spec, B, gen)
            for dt in (dt64, None):
                k = batched_loglike(a, b, c, d, t, y, s2, dt)
                p = batched_loglike_plain(a, b, c, d, t, y, s2, dt)
                torch.cuda.synchronize()
                kinf, pinf = torch.isneginf(k), torch.isneginf(p)
                check(bool(torch.equal(kinf, pinf)),
                      f"-inf lanes differ ({dtype}, B={B}, dt={dt is not None}): "
                      f"kernel {int(kinf.sum())}, plain {int(pinf.sum())}")
                check(bool(kinf[0]), "the forced non-PD lane is not -inf")
                fin = ~kinf
                check(bool(torch.isfinite(k[fin]).all()), "non-finite kernel value")
                err = (k[fin] - p[fin]).abs()
                if dtype == torch.float64:
                    rel = float((err / p[fin].abs()).max())
                    check(rel <= 1e-9, f"f64 B={B}: rel err {rel:.3e} > 1e-9")
                    worst[dtype] = max(worst[dtype], rel)
                else:
                    mx = float(err.max())
                    check(mx <= 0.05, f"f32 B={B}: abs err {mx:.3e} > 0.05 nats")
                    worst[dtype] = max(worst[dtype], mx)
            if B in PHASE2_TIMED:
                run_k = lambda: batched_loglike(a, b, c, d, t, y, s2, dt64)  # noqa: E731
                run_p = lambda: batched_loglike_plain(a, b, c, d, t, y, s2, dt64)  # noqa: E731
                times[(str(dtype)[6:], B)] = (cuda_ms(run_k, 20), cuda_ms(run_p, 2))
    b_ns = PHASE2_BATCHES[0]
    N = len(spec64.t)
    tstr = " ".join(f"{k[0]}/B={k[1]}: kernel_ms={v[0]:.4f} us_per_step={v[0] * 1e3 / N:.3f} "
                    f"plain_ms={v[1]:.2f}"
                    + (f" bound_ms={bound(*k1_cost(k[1]))[0]:.5f}" if k[0] == "float32" else "")
                    for k, v in times.items())
    print(f"phase 2 kernel vs plain: ok N={N} J=20 B={','.join(map(str, PHASE2_BATCHES))} "
          f"with/without dt "
          f"f64_max_rel_err={worst[torch.float64]:.3e} "
          f"f32_max_abs_err={worst[torch.float32]:.3e} | {tstr}")
    return worst[torch.float32], times[("float32", b_ns)]


def phase_long_n(dev):
    from pioran_tpu_torch.ops.cuda_celerite import batched_loglike

    rng = np.random.default_rng(0)
    N, J = 16384, 8
    t = np.sort(rng.uniform(0, N / 4, N))
    a = np.abs(rng.normal(0.5, 0.2, J))
    b = np.zeros(J)
    c = np.abs(rng.normal(0.5, 0.2, J))
    d = np.abs(rng.normal(0.3, 0.1, J))
    y = np.sin(t / 10) + rng.normal(0, 0.3, N)
    s2 = 0.05 + 0.01 * np.abs(rng.normal(size=N))

    def ll(dtype):
        T = lambda x, two_d: torch.as_tensor(x[None] if two_d else x,  # noqa: E731
                                             dtype=dtype, device=dev)
        out = batched_loglike(T(a, 1), T(b, 1), T(c, 1), T(d, 1), T(t, 0),
                              T(y, 1), T(s2, 1))
        return float(out[0])

    ll64, ll32 = ll(torch.float64), ll(torch.float32)
    diff = abs(ll32 - ll64)
    check(math.isfinite(ll64) and diff < 1.0,
          f"long-N f32 error {diff:.4f} nats >= 1.0 (ll64={ll64})")
    # exp(-c dt) in f32 vs f64 on the card over the same grid
    u = torch.as_tensor(c[:, None] * np.diff(t)[None, :], device=dev)
    e64 = torch.exp(-u)
    e32 = torch.exp(-u.float()).double()
    exp_err = float((e32 - e64).abs().max())
    print(f"phase 3 long-N f32: ok N={N} J={J} ll64={ll64:.6f} ll32={ll32:.6f} "
          f"abs_diff={diff:.6f} exp_f32_max_abs_err={exp_err:.3e}")


def phase_likelihood(dev):
    from pioran_tpu_torch import single_bending_model

    A = np.loadtxt(os.path.join(DATA, "simu.txt"))
    xbar, va = float(np.mean(np.log(A[:, 1]))), float(np.var(np.log(A[:, 1])))
    vals = {}
    for dtype in (torch.float64, torch.float32):
        spec = single_bending_model(A[:, 0], A[:, 1], A[:, 2], xbar, va,
                                    device=dev, dtype=dtype)
        vals[dtype] = float(spec.loglike(torch.tensor(FLAGSHIP_THETA, dtype=dtype,
                                                      device=dev)))
    rel64 = abs(vals[torch.float64] / FLAGSHIP_LL64 - 1.0)
    d32 = abs(vals[torch.float32] - FLAGSHIP_LL64)
    check(rel64 <= 1e-8, f"f64 flagship ll {vals[torch.float64]!r}: rel {rel64:.3e}")
    check(d32 <= 0.5, f"f32 flagship ll {vals[torch.float32]!r}: off by {d32:.4f}")
    print(f"phase 4 flagship likelihood: ok N={A.shape[0]} f64={vals[torch.float64]!r} "
          f"(rel {rel64:.2e}) f32={vals[torch.float32]!r} (abs {d32:.4f})")


def phase_ns(dev, out_dir):
    from pioran_tpu_torch import run_inference, single_bending_model
    from pioran_tpu_torch.ops import cuda_celerite

    sub, xbar, va = load_subset()
    spec = single_bending_model(sub[:, 0], sub[:, 1], sub[:, 2], xbar, va,
                                device=dev, dtype=torch.float32)
    from pioran_tpu_torch.ops import cuda_celerite_vjp as vjp

    log_dir = os.path.join(out_dir, "ns")
    cuda_celerite.LAUNCHES = vjp.FWD_AUG_LAUNCHES = vjp.BWD_LAUNCHES = 0
    res = run_inference(spec, sampler="ns", num_particles=NS_LIVE, log_dir=log_dir)
    torch.cuda.synchronize()
    launches = cuda_celerite.LAUNCHES
    mww = res["insertion_order_MWW_test"]
    print(f"phase 5 NS: logz={res['logz']:.4f} logzerr={res['logzerr']:.4f} "
          f"ess={res['ess']:.1f} ncall={res['ncall']} elapsed_s={res['elapsed_s']:.2f} "
          f"insertion_converged={mww['converged']} mww_z={mww['zscore']:.3f} "
          f"launches={launches} N={sub.shape[0]}")
    ref = referee()
    pulls = (np.asarray(res["posterior"]["mean"]) - np.asarray(ref["is_mean"])) \
        / np.asarray(ref["is_std"])
    print(f"phase 5 NS posterior pulls vs referee: {np.round(pulls, 4).tolist()}")
    check(abs(res["logz"] - REF_LOGZ) <= LOGZ_TOL,
          f"logZ {res['logz']:.4f} outside {REF_LOGZ} +- {LOGZ_TOL}")
    check(bool(np.all(np.abs(pulls) <= 0.25)), f"posterior pull > 0.25 sd: {pulls}")
    width = NS_LIVE // 8  # n_delete: the width of every NS sweep
    check(launches >= res["ncall"] / width,
          f"launches {launches} < ncall/{width} = {res['ncall'] / width}")
    for rel in (("chains", "equal_weighted_post.txt"), ("info", "results.json")):
        check(os.path.isfile(os.path.join(log_dir, *rel)), f"{rel} not written")
    print("phase 5 NS: ok")
    return launches


def rel_rows(x, ref) -> float:
    """Largest 2-norm relative error over the leading axis."""
    x, ref = x.double().reshape(x.shape[0], -1), ref.double().reshape(ref.shape[0], -1)
    return float(((x - ref).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-300)).max())


def adjoint_rows(fin, ll, res, grads):
    """ll, the 7 residual tables and the 7 cotangents as (rows, ...) over
    the finite chains; t's cotangent (summed over chains) is one row."""
    out = [ll[fin][:, None]] + [x[fin] for x in res]
    return out + [x[None] if x.dim() == 1 else x[fin] for x in grads]


ADJ_NAMES = ("ll", "W0", "W1", "pre0", "pre1", "D", "zp", "Tckpt",
             "a_bar", "b_bar", "c_bar", "d_bar", "t_bar", "y_bar", "s2_bar")


def adjoint_cost(B, J, N, kc, item, B_live):
    """(bytes, operations) of K3 and of K4 at these shapes: each input
    read once, each output written once; operations counted from the
    kernels' inner loops (about 20 J^2 a chain-step for K3, as K1, and 56
    J^2 for K4, which only works on the chains with a nonzero cotangent)."""
    nck = -(-N // kc)
    coef, rows = 4 * B * J, 2 * N - 1
    tables = B * N * (4 * J + 2) + B * nck * 3 * J * J
    k3 = (item * (coef + rows + 2 * B * N + B + tables), 20.0 * J * J * B * N)
    k4 = (item * (coef + rows + B + tables + 4 * B * J + 4 * B * N), 56.0 * J * J * B_live * N)
    return k3, k4


def phase_adjoint_vs_plain(spec64, spec32):
    from pioran_tpu_torch.ops.cuda_celerite_vjp import (
        KC, bwd, bwd_launch_shape, bwd_plain, fwd_aug, fwd_aug_plain, residual_bytes)
    from pioran_tpu_torch.samplers.chees import batch_value_and_grad

    dev = spec64.device
    gen = torch.Generator(device=dev).manual_seed(2)
    t64 = torch.as_tensor(spec64.t, dtype=torch.float64, device=dev)
    dt64 = torch.as_tensor(np.diff(spec64.t.astype(np.float64)), device=dev)
    worst64, worst_ratio, worst32 = 0.0, 0.0, np.zeros(len(ADJ_NAMES))
    max_abs = {"celerite_fwd_aug": 0.0, "celerite_bwd": 0.0}
    for B in ADJ_BATCHES:
        a, b, c, d, y, s2 = flagship_inputs(spec64, B, gen)
        for dt in (dt64, None):
            args64 = (a, b, c, d, t64, y, s2)
            args32 = tuple(x.float() for x in args64)
            ll_p, res_p = fwd_aug_plain(*args64, dt=dt)
            fin = torch.isfinite(ll_p)
            g = torch.where(fin, torch.linspace(0.5, 1.5, B, dtype=torch.float64, device=dev), 0.0)
            refs = adjoint_rows(fin, ll_p, res_p, bwd_plain(*args64, res_p, g, dt=dt))
            out = {}
            for dtype, args in ((torch.float64, args64), (torch.float32, args32)):
                gg = g.to(dtype)
                ll, res = fwd_aug(*args, dt=dt)
                grads = bwd(*args, res, gg, dt=dt)
                torch.cuda.synchronize()
                check(torch.equal(torch.isneginf(ll), ~fin) and bool(ll[0] == -math.inf),
                      f"K3 -inf lanes differ from plain ({dtype}, B={B})")
                check(all(x.dim() == 1 or bool((x[0] == 0).all()) for x in grads),
                      f"K4: the non-PD lane's gradient is not zero ({dtype}, B={B})")
                check(all(bool(torch.isfinite(x).all()) for x in adjoint_rows(fin, ll, res, grads)[8:]),
                      f"K4: non-finite cotangent ({dtype}, B={B})")
                out[dtype] = (ll, res, grads)
            errs = [rel_rows(x, r) for x, r in zip(adjoint_rows(fin, *out[torch.float64]), refs)]
            worst64 = max(worst64, max(errs))
            check(max(errs) <= 1e-9, f"f64 B={B} dt={dt is not None}: rel err "
                  f"{max(errs):.3e} in {ADJ_NAMES[int(np.argmax(errs))]} > 1e-9")
            # f32: the plain loop's own float32 error against f64 sets the gate
            ll_q, res_q = fwd_aug_plain(*args32, dt=dt)
            own = adjoint_rows(fin, ll_q, res_q, bwd_plain(*args32, res_q, g.float(), dt=dt))
            k32 = adjoint_rows(fin, *out[torch.float32])
            for i, (x, q, r) in enumerate(zip(k32, own, refs)):
                e_k, e_q = rel_rows(x, r), rel_rows(q, r)
                worst32[i] = max(worst32[i], e_k)
                worst_ratio = max(worst_ratio, e_k / max(e_q, 1e-7))
                check(e_k <= max(3.0 * e_q, 1e-5),
                      f"f32 B={B} dt={dt is not None} {ADJ_NAMES[i]}: kernel rel err "
                      f"{e_k:.3e} > 3 x the f32 plain loop's {e_q:.3e}")
                key = "celerite_fwd_aug" if i < 8 else "celerite_bwd"
                max_abs[key] = max(max_abs[key], float((x.double() - q.double()).abs().max()))
    print(f"phase 6 K3/K4 vs plain: ok N=485 J=20 B={ADJ_BATCHES} with/without dt, "
          f"lane 0 non-PD (-inf, zero gradient) f64_max_rel_err={worst64:.3e} (gate 1e-9)")
    print("phase 6 f32 gate: each output's 2-norm relative error against the f64 plain "
          "loop within 3x the f32 plain loop's own (rounding, not the kernel, sets it); "
          f"worst kernel/plain ratio {worst_ratio:.3f}; f32 rel errs: "
          + " ".join(f"{n}={e:.2e}" for n, e in zip(ADJ_NAMES, worst32)))

    timing = {}
    for B in (16, 512, 4096):  # the NUTS leaf batch, the ChEES batch, large
        a, b, c, d, y, s2 = (x.float() for x in flagship_inputs(spec32, B, gen))
        args = (a, b, c, d, t64.float(), y, s2)
        ll, res = fwd_aug(*args, dt=dt64)
        g = torch.isfinite(ll).float()
        k3 = cuda_ms(lambda: fwd_aug(*args, dt=dt64), 20)  # noqa: B023
        k4 = cuda_ms(lambda: bwd(*args, res, g, dt=dt64), 20)  # noqa: B023
        Z = spec32.prior.to_unconstrained(referee_thetas(spec32, B, gen))
        vg = cuda_ms(lambda: batch_value_and_grad(spec32.logpost_batch, Z), 10)  # noqa: B023
        p3 = p4 = None
        if B == 512:
            p3 = cuda_ms(lambda: fwd_aug_plain(*args, dt=dt64), 1)  # noqa: B023
            p4 = cuda_ms(lambda: bwd_plain(*args, res, g, dt=dt64), 1)  # noqa: B023
        cost = adjoint_cost(B, 20, 485, KC, 4, int(g.sum()))
        timing[B] = dict(k3=k3, k4=k4, vg=vg, p3=p3, p4=p4, cost=cost)
        tb, ck = residual_bytes(B, 20, 485, KC, torch.float32)
        cpb, ks, smem = bwd_launch_shape(torch.float32, 20, KC, B,
                                         torch.cuda.get_device_properties(dev).multi_processor_count)
        print(f"phase 6 times f32 B={B}: K3_ms={k3:.4f} K4_ms={k4:.4f} "
              f"K3_us_per_step={k3 * 1e3 / 485:.3f} K4_us_per_step={k4 * 1e3 / 485:.3f} "
              f"logpost_value_and_grad_ms={vg:.3f} value_grad_evals_per_s={B / vg * 1e3:.1f}"
              + (f" K3_plain_ms={p3:.1f} K4_plain_ms={p4:.1f}" if p3 else "")
              + f" K3_bound_ms={bound(*cost[0])[0]:.4f} K4_bound_ms={bound(*cost[1])[0]:.4f}"
              f" residual_bytes tables={tb} ckpts={ck} K4 chains_per_block={cpb} "
              f"sub_chunk={ks} smem_bytes_per_block={smem}")
    return max_abs, timing


def phase_flagship_grad(spec64):
    """Gradient of the f64 flagship log-posterior through K3/K4 against
    autograd through the plain forward loop, at 64 rows."""
    import pioran_tpu_torch.inference as tinf
    from pioran_tpu_torch.ops import cuda_celerite_vjp as vjp
    from pioran_tpu_torch.ops.cuda_celerite import batched_loglike_plain
    from pioran_tpu_torch.samplers.chees import batch_value_and_grad

    gen = torch.Generator(device=spec64.device).manual_seed(3)
    Z = spec64.prior.to_unconstrained(referee_thetas(spec64, 64, gen))
    n3, n4 = vjp.FWD_AUG_LAUNCHES, vjp.BWD_LAUNCHES
    lp, g = batch_value_and_grad(spec64.logpost_batch, Z)
    torch.cuda.synchronize()
    check((vjp.FWD_AUG_LAUNCHES, vjp.BWD_LAUNCHES) == (n3 + 1, n4 + 1),
          "the flagship gradient did not run K3 and K4 once each")
    kernel_loglike = tinf.batched_loglike
    tinf.batched_loglike = batched_loglike_plain  # the model's closure looks it up per call
    try:
        lp_p, g_p = batch_value_and_grad(spec64.logpost_batch, Z)
    finally:
        tinf.batched_loglike = kernel_loglike
    fin = torch.isfinite(lp_p)
    check(int(fin.sum()) >= 60 and torch.equal(torch.isfinite(lp), fin),
          f"finite rows differ or too few: {int(fin.sum())}")
    rel = ((g - g_p).norm(dim=1) / g_p.norm(dim=1))[fin]
    check(float(rel.max()) <= 1e-8, f"f64 flagship gradient rel err {float(rel.max()):.3e} > 1e-8")
    print(f"phase 7 flagship gradient: ok 64 rows f64 max_rel_err={float(rel.max()):.3e} "
          f"(gate 1e-8) value_rel_err={float(((lp - lp_p).abs() / lp_p.abs())[fin].max()):.3e}")


def phase_long_n_grad(dev):
    """K3 + K4 at N = 2^16, J = 20, B = 16, shared t, in f32 and f64."""
    from pioran_tpu_torch.ops.cuda_celerite_vjp import KC, bwd, fwd_aug, residual_bytes

    rng = np.random.default_rng(1)
    N, J, B = 65536, 20, 16
    t = np.sort(rng.uniform(0, N / 4, N))
    a = np.abs(rng.normal(0.5, 0.2, (B, J)))
    b = np.zeros((B, J))
    c = np.abs(rng.normal(0.5, 0.2, (B, J)))
    d = np.abs(rng.normal(0.3, 0.1, (B, J)))
    y = np.sin(t / 10)[None, :] + rng.normal(0, 0.3, (B, N))
    s2 = 0.05 + 0.01 * np.abs(rng.normal(size=(B, N)))
    dt = torch.as_tensor(np.diff(t), device=dev)
    out, secs = {}, {}
    for dtype in (torch.float64, torch.float32):
        args = [torch.as_tensor(x, dtype=dtype, device=dev) for x in (a, b, c, d, t, y, s2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ll, res = fwd_aug(*args, dt=dt)
        grads = bwd(*args, res, torch.isfinite(ll).to(dtype), dt=dt)
        torch.cuda.synchronize()
        secs[dtype] = time.perf_counter() - t0
        check(bool(torch.isfinite(ll).all()), f"long-N {dtype}: non-finite ll")
        check(all(bool(torch.isfinite(x).all()) for x in grads), f"long-N {dtype}: non-finite gradient")
        out[dtype] = (ll, grads)
        del res
    ll64, g64 = out[torch.float64]
    ll32, g32 = out[torch.float32]
    errs = [rel_rows(x[None] if x.dim() == 1 else x, r[None] if r.dim() == 1 else r)
            for x, r in zip(g32, g64)]
    by = {str(dt_)[6:]: sum(residual_bytes(B, J, N, KC, dt_)) for dt_ in (torch.float64, torch.float32)}
    print(f"phase 8 long-N gradient: ok N={N} J={J} B={B} kc={KC} finite in f32 and f64; "
          f"max |ll32-ll64|={float((ll32.double() - ll64).abs().max()):.4f} nats; f32-vs-f64 "
          "grad rel errs " + " ".join(f"{n}={e:.2e}" for n, e in zip(ADJ_NAMES[8:], errs))
          + f"; K3+K4 s f64={secs[torch.float64]:.3f} f32={secs[torch.float32]:.3f}; "
          f"residual bytes f64={by['float64']} f32={by['float32']}")


def phase_chees(dev, out_dir):
    import pioran_tpu_torch.inference as tinf
    from pioran_tpu_torch.ops import cuda_celerite, cuda_celerite_vjp as vjp

    sub, xbar, va = load_subset()
    spec = tinf.single_bending_model(sub[:, 0], sub[:, 1], sub[:, 2], xbar, va,
                                     device=dev, dtype=torch.float32)
    log_dir = os.path.join(out_dir, "chees")
    seeded = tinf.advi_seeded_inits
    advi_s = []

    def timed_seed(*args, **kw):
        t0 = time.perf_counter()
        z = seeded(*args, **kw)
        torch.cuda.synchronize()
        advi_s.append(time.perf_counter() - t0)
        return z

    tinf.advi_seeded_inits = timed_seed
    cuda_celerite.LAUNCHES = vjp.FWD_AUG_LAUNCHES = vjp.BWD_LAUNCHES = 0
    try:
        res = tinf.run_inference(spec, sampler="chees", init="advi", mass="dense",
                                 log_dir=log_dir, **CHEES)
        torch.cuda.synchronize()
    finally:
        tinf.advi_seeded_inits = seeded
    launches = {"celerite_fwd": cuda_celerite.LAUNCHES,
                "celerite_fwd_aug": vjp.FWD_AUG_LAUNCHES, "celerite_bwd": vjp.BWD_LAUNCHES}
    leapfrogs = res["ncall"] // CHEES["num_chains"]
    ref = referee()
    mean, sd = np.asarray(res["posterior"]["mean"]), np.asarray(res["posterior"]["stdev"])
    pulls = (mean - np.asarray(ref["is_mean"])) / np.asarray(ref["is_std"])
    width = sd / np.asarray(ref["is_std"])
    rhat = np.asarray(res["rhat"], np.float64)
    print(f"phase 9 ChEES: chains={CHEES['num_chains']} warmup={CHEES['num_warmup']} "
          f"samples={CHEES['num_samples']} leapfrogs={leapfrogs} ncall={res['ncall']} "
          f"elapsed_s={res['elapsed_s']:.2f} advi_s={advi_s[0]:.2f} ess={res['ess']:.1f} "
          f"ess_per_s={res['ess_per_s']:.2f} rhat_max={rhat.max():.4f} "
          f"(repo target 1.02: {'met' if rhat.max() <= 1.02 else 'not met'}) launches={launches}")
    print(f"phase 9 ChEES pulls vs referee: {np.round(pulls, 4).tolist()} "
          f"width ratios: {np.round(width, 4).tolist()} rhat: {np.round(rhat, 4).tolist()} ess_bulk: "
          f"{np.round(res['ess_bulk'], 1).tolist()}")
    check(bool(np.all(np.abs(pulls) <= 0.25)), f"ChEES posterior pull > 0.25 sd: {pulls}")
    check(bool(np.all((width >= 0.75) & (width <= 1.33))), f"ChEES width ratio outside [0.75, 1.33]: {width}")
    check(float(rhat.max()) <= 1.05, f"ChEES rhat_max {rhat.max():.4f} > 1.05")
    check(min(launches["celerite_fwd_aug"], launches["celerite_bwd"]) >= leapfrogs,
          f"K3/K4 launches {launches} < leapfrogs {leapfrogs}")
    check(launches["celerite_fwd"] > 0, "the ChEES run launched no K1")
    for rel in (("chains", "equal_weighted_post.txt"), ("info", "results.json")):
        check(os.path.isfile(os.path.join(log_dir, *rel)), f"{rel} not written")
    print("phase 9 ChEES: ok")
    return launches


def multi_costs(B, J, N, kc, item, n_valid, live_chains):
    """(bytes, operations) of K2, K3 and K4 on per-lane grids: each input
    read once (t, dt, y, sigma2 rows and the int32 n_valid), each output
    written once; operations only on the live steps, n < n_valid (20 J^2
    a chain-step for K2/K3, 56 J^2 for K4 on chains with a cotangent)."""
    nck = -(-N // kc)
    coef, grid = 4 * B * J, B * N + B * (N - 1)
    tables = B * N * (4 * J + 2) + B * nck * 3 * J * J
    steps, live_steps = float(np.sum(n_valid)), float(np.sum(n_valid[live_chains]))
    k2 = (item * (coef + grid + 2 * B * N + B) + 4 * B, 20.0 * J * J * steps)
    k3 = (item * (coef + grid + 2 * B * N + B + tables) + 4 * B, 20.0 * J * J * steps)
    k4 = (item * (coef + grid + B + tables + 4 * B * J + 4 * B * N) + 4 * B,
          56.0 * J * J * live_steps)
    return k2, k3, k4


def phase_multi_vs_plain(spec64, spec32, datasets):
    """K2 against its plain version on ragged rows, K2 on one shared grid
    against K1, and the kernel's times."""
    import pioran_tpu_torch.inference as tinf
    from pioran_tpu_torch.ops import cuda_celerite
    from pioran_tpu_torch.ops.cuda_celerite import (
        batched_loglike, batched_loglike_multi, batched_loglike_multi_plain)
    from pioran_tpu_torch.ops.cuda_celerite_vjp import live_steps

    dev = spec64.device
    gen = torch.Generator(device=dev).manual_seed(4)
    worst = {torch.float64: 0.0, torch.float32: 0.0}
    vs_k1 = {}
    times = {}
    t64 = torch.as_tensor(spec64.t, dtype=torch.float64, device=dev)
    dt64 = torch.as_tensor(np.diff(spec64.t.astype(np.float64)), device=dev)
    for spec in (spec64, spec32):
        dtype = spec.dtype
        model = tinf._many_model(datasets, device=dev, dtype=dtype)
        for B in MULTI_BATCHES:
            a, b, c, d, T, y, s2, nv, DT = multi_inputs(spec, model, B, gen)
            s2m = torch.where(live_steps(nv, T.shape[1]), s2, torch.ones_like(s2))
            for dt in (DT, None):
                k = batched_loglike_multi(a, b, c, d, T, y, s2, nv, dt)
                p = batched_loglike_multi_plain(a, b, c, d, T, y, s2m, nv, dt)
                torch.cuda.synchronize()
                kinf, pinf = torch.isneginf(k), torch.isneginf(p)
                check(bool(torch.equal(kinf, pinf)),
                      f"K2 -inf lanes differ ({dtype}, B={B}, dt={dt is not None}): "
                      f"kernel {int(kinf.sum())}, plain {int(pinf.sum())}")
                check(bool(kinf[0]), "the forced non-PD lane is not -inf")
                fin = ~kinf
                check(bool(torch.isfinite(k[fin]).all()), "non-finite K2 value")
                err = (k[fin] - p[fin]).abs()
                if dtype == torch.float64:
                    rel = float((err / p[fin].abs()).max())
                    check(rel <= 1e-9, f"K2 f64 B={B}: rel err {rel:.3e} > 1e-9")
                    worst[dtype] = max(worst[dtype], rel)
                else:
                    mx = float(err.max())
                    check(mx <= 0.05, f"K2 f32 B={B}: abs err {mx:.3e} > 0.05 nats")
                    worst[dtype] = max(worst[dtype], mx)
            if B in MULTI_BATCHES[:2]:
                run_k = lambda: cuda_celerite._launch(a, b, c, d, T, y, s2m, DT, nv)  # noqa: E731,B023
                run_p = lambda: batched_loglike_multi_plain(a, b, c, d, T, y, s2m, nv, DT)  # noqa: E731,B023
                times[(str(dtype)[6:], B)] = (cuda_ms(run_k, 20),
                                              cuda_ms(run_p, 1) if B == MULTI_BATCHES[0] else None,
                                              nv.cpu().numpy())
        # one shared grid, every step live: K2 is K1
        B = MULTI_BATCHES[0]
        a, b, c, d, y, s2 = flagship_inputs(spec, B, gen)
        t = t64.to(dtype)
        k1 = batched_loglike(a, b, c, d, t, y, s2, dt64)
        k2 = batched_loglike_multi(a, b, c, d, t.expand(B, -1), y, s2,
                                   torch.full((B,), t.shape[0], device=dev),
                                   dt64.expand(B, -1))
        torch.cuda.synchronize()
        fin = torch.isfinite(k1)
        check(torch.equal(fin, torch.isfinite(k2)), f"K2 vs K1: -inf lanes differ ({dtype})")
        rel = float(((k2[fin] - k1[fin]).abs() / k1[fin].abs()).max())
        vs_k1[dtype] = rel
        check(rel <= (1e-12 if dtype == torch.float64 else 1e-6),
              f"K2 on one grid vs K1 ({dtype}): rel {rel:.3e}")
    tstr = " ".join(
        f"{k[0]}/B={k[1]}: K2_ms={v[0]:.4f} us_per_step={v[0] * 1e3 / T.shape[1]:.3f}"
        + (f" plain_ms={v[1]:.2f}" if v[1] else "")
        + (f" bound_ms={bound(*multi_costs(k[1], 20, 485, 8, 4, v[2], v[2] > 0)[0])[0]:.5f}"
           if k[0] == "float32" else "")
        for k, v in times.items())
    print(f"phase 10 K2 vs plain: ok Nmax=485 J=20 B={MULTI_BATCHES} ragged over "
          f"{len(datasets)} datasets, with/without dt, lane 0 non-PD "
          f"f64_max_rel_err={worst[torch.float64]:.3e} (gate 1e-9) "
          f"f32_max_abs_err={worst[torch.float32]:.3e} (gate 0.05); one shared grid vs K1: "
          f"f64 rel {vs_k1[torch.float64]:.3e} f32 rel {vs_k1[torch.float32]:.3e} | {tstr}")
    return worst[torch.float32], times[("float32", MULTI_BATCHES[0])]


def phase_path_a(datasets, dev):
    """Path (a), no gradient: sweeps of the multi-dataset model's
    likelihood over the run's batch (D x C rows, float32) through
    ``batched_loglike_multi``, which launches K2."""
    import pioran_tpu_torch.inference as tinf
    from pioran_tpu_torch.ops import cuda_celerite, cuda_celerite_vjp as vjp

    model = tinf._many_model(datasets, device=dev, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(5)
    B = MANY_D * MANY["num_chains"]
    TH = model.prior.sample((PATH_A_SWEEPS, B), generator=gen, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    cuda_celerite.LAUNCHES = cuda_celerite.MULTI_LAUNCHES = 0
    vjp.FWD_AUG_LAUNCHES = vjp.BWD_LAUNCHES = 0
    vjp.FWD_AUG_MULTI_LAUNCHES = vjp.BWD_MULTI_LAUNCHES = 0
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        start.record()
        lls = [model.loglike_batch(TH[i]) for i in range(PATH_A_SWEEPS)]
        stop.record()
    torch.cuda.synchronize()
    launches = cuda_celerite.MULTI_LAUNCHES
    others = (cuda_celerite.LAUNCHES, vjp.FWD_AUG_LAUNCHES, vjp.BWD_LAUNCHES,
              vjp.FWD_AUG_MULTI_LAUNCHES, vjp.BWD_MULTI_LAUNCHES)
    ms = start.elapsed_time(stop) / PATH_A_SWEEPS
    fin = float(torch.stack([torch.isfinite(x).float().mean() for x in lls]).mean())
    print(f"phase 10 path (a) no-gradient sweeps: B={B} ({MANY_D} datasets x "
          f"{MANY['num_chains']} chains) f32 prior draws, {PATH_A_SWEEPS} sweeps, "
          f"sweep_ms={ms:.3f} (approximation + K2) K2_launches={launches} "
          f"finite_share={fin:.3f}")
    check(launches == PATH_A_SWEEPS, f"K2 launches {launches} != {PATH_A_SWEEPS} sweeps")
    check(others == (0,) * 5, f"a no-gradient sweep launched other kernels: {others}")
    return launches, ms


def phase_multi_adjoint_vs_plain(spec64, spec32, datasets):
    """Per-lane K3/K4 against their plain versions, the many-model's f64
    gradient against autograd through the plain loop, and times."""
    import pioran_tpu_torch.inference as tinf
    from pioran_tpu_torch.ops.cuda_celerite import batched_loglike_multi_plain
    from pioran_tpu_torch.ops.cuda_celerite_vjp import (
        KC, bwd, bwd_plain, fwd_aug, fwd_aug_plain, live_steps)
    from pioran_tpu_torch.samplers.chees import batch_value_and_grad

    dev = spec64.device
    gen = torch.Generator(device=dev).manual_seed(6)
    worst64, worst_ratio, worst32 = 0.0, 0.0, np.zeros(len(ADJ_NAMES))
    max_abs = {"celerite_fwd_aug_multi": 0.0, "celerite_bwd_multi": 0.0}
    timing = {}
    model64 = tinf._many_model(datasets, device=dev, dtype=torch.float64)
    for B in ADJ_MULTI_BATCHES:
        a, b, c, d, T, y, s2, nv, DT = multi_inputs(spec64, model64, B, gen)
        live = live_steps(nv, T.shape[1])
        s2 = torch.where(live, s2, torch.ones_like(s2))
        for dt in (DT, None):
            args64 = (a, b, c, d, T, y, s2)
            args32 = tuple(x.float() for x in args64)
            kw = dict(dt=dt, n_valid=nv)
            ll_p, res_p = fwd_aug_plain(*args64, **kw)
            fin = torch.isfinite(ll_p)
            g = torch.where(fin, torch.linspace(0.5, 1.5, B, dtype=torch.float64, device=dev), 0.0)
            refs = adjoint_rows(fin, ll_p, res_p, bwd_plain(*args64, res_p, g, **kw))
            out = {}
            for dtype, args in ((torch.float64, args64), (torch.float32, args32)):
                ll, res = fwd_aug(*args, **kw)
                grads = bwd(*args, res, g.to(dtype), **kw)
                torch.cuda.synchronize()
                check(torch.equal(torch.isneginf(ll), ~fin) and bool(ll[0] == -math.inf),
                      f"per-lane K3 -inf lanes differ from plain ({dtype}, B={B})")
                check(all(bool((x[0] == 0).all()) for x in grads),
                      f"per-lane K4: the non-PD lane's gradient is not zero ({dtype}, B={B})")
                check(all(bool((x[~live] == 0).all()) for x in grads[4:]),
                      f"per-lane K4: t/y/sigma2 cotangents not zero past n_valid ({dtype}, B={B})")
                check(all(bool(torch.isfinite(x).all()) for x in adjoint_rows(fin, ll, res, grads)[8:]),
                      f"per-lane K4: non-finite cotangent ({dtype}, B={B})")
                out[dtype] = (ll, res, grads)
            errs = [rel_rows(x, r) for x, r in zip(adjoint_rows(fin, *out[torch.float64]), refs)]
            worst64 = max(worst64, max(errs))
            check(max(errs) <= 1e-9, f"per-lane f64 B={B} dt={dt is not None}: rel err "
                  f"{max(errs):.3e} in {ADJ_NAMES[int(np.argmax(errs))]} > 1e-9")
            ll_q, res_q = fwd_aug_plain(*args32, **kw)
            own = adjoint_rows(fin, ll_q, res_q, bwd_plain(*args32, res_q, g.float(), **kw))
            for i, (x, q, r) in enumerate(zip(adjoint_rows(fin, *out[torch.float32]), own, refs)):
                e_k, e_q = rel_rows(x, r), rel_rows(q, r)
                worst32[i] = max(worst32[i], e_k)
                worst_ratio = max(worst_ratio, e_k / max(e_q, 1e-7))
                check(e_k <= max(3.0 * e_q, 1e-5),
                      f"per-lane f32 B={B} dt={dt is not None} {ADJ_NAMES[i]}: kernel rel err "
                      f"{e_k:.3e} > 3 x the f32 plain loop's {e_q:.3e}")
                key = "celerite_fwd_aug_multi" if i < 8 else "celerite_bwd_multi"
                max_abs[key] = max(max_abs[key], float((x.double() - q.double()).abs().max()))
        if B == ADJ_MULTI_BATCHES[0]:
            args = tuple(x.float() for x in (a, b, c, d, T, y, s2))
            ll, res = fwd_aug(*args, dt=DT, n_valid=nv)
            gg = torch.isfinite(ll).float()
            k3 = cuda_ms(lambda: fwd_aug(*args, dt=DT, n_valid=nv), 20)  # noqa: B023
            k4 = cuda_ms(lambda: bwd(*args, res, gg, dt=DT, n_valid=nv), 20)  # noqa: B023
            p3 = cuda_ms(lambda: fwd_aug_plain(*args, dt=DT, n_valid=nv), 1)  # noqa: B023
            p4 = cuda_ms(lambda: bwd_plain(*args, res, gg, dt=DT, n_valid=nv), 1)  # noqa: B023
            model32 = tinf._many_model(datasets, device=dev, dtype=torch.float32)
            Z = many_rows(model32, spec32, B, gen)
            vg = cuda_ms(lambda: batch_value_and_grad(model32.logpost_batch, Z), 10)
            nvn = nv.cpu().numpy()
            costs = multi_costs(B, 20, T.shape[1], KC, 4, nvn, gg.bool().cpu().numpy())
            timing = dict(k3=k3, k4=k4, p3=p3, p4=p4, vg=vg, cost3=costs[1], cost4=costs[2])
            print(f"phase 11 times f32 B={B}: K3_multi_ms={k3:.4f} K4_multi_ms={k4:.4f} "
                  f"K3_multi_plain_ms={p3:.1f} K4_multi_plain_ms={p4:.1f} "
                  f"K3_multi_bound_ms={bound(*costs[1])[0]:.4f} "
                  f"K4_multi_bound_ms={bound(*costs[2])[0]:.4f} "
                  f"many_logpost_value_and_grad_ms={vg:.3f} live_steps={int(nvn.sum())} "
                  f"of {B * T.shape[1]}")
    print(f"phase 11 per-lane K3/K4 vs plain: ok Nmax=485 J=20 B={ADJ_MULTI_BATCHES} ragged, "
          f"with/without dt, lane 0 non-PD, t/y/sigma2 cotangents exactly zero past n_valid; "
          f"f64_max_rel_err={worst64:.3e} (gate 1e-9); f32 worst kernel/plain ratio "
          f"{worst_ratio:.3f} (gate 3); f32 rel errs: "
          + " ".join(f"{n}={e:.2e}" for n, e in zip(ADJ_NAMES, worst32)))

    # the many-model's f64 gradient through the per-lane K3/K4 against
    # autograd through the plain loop, 64 rows (16 datasets x 4 chains)
    from pioran_tpu_torch.ops import cuda_celerite_vjp as vjp

    Z = many_rows(model64, spec64, 64, gen)
    n3, n4 = vjp.FWD_AUG_MULTI_LAUNCHES, vjp.BWD_MULTI_LAUNCHES
    lp, grad = batch_value_and_grad(model64.logpost_batch, Z)
    torch.cuda.synchronize()
    check((vjp.FWD_AUG_MULTI_LAUNCHES, vjp.BWD_MULTI_LAUNCHES) == (n3 + 1, n4 + 1),
          "the many-model gradient did not run the per-lane K3 and K4 once each")

    def plain(a, b, c, d, t, y, s2, nv, dt):
        s2 = torch.where(live_steps(nv, t.shape[1]), s2, torch.ones_like(s2))
        return batched_loglike_multi_plain(a, b, c, d, t, y, s2, nv, dt)

    kernel_loglike = tinf.batched_loglike_multi
    tinf.batched_loglike_multi = plain  # the model's closure looks it up per call
    try:
        lp_p, g_p = batch_value_and_grad(model64.logpost_batch, Z)
    finally:
        tinf.batched_loglike_multi = kernel_loglike
    fin = torch.isfinite(lp_p)
    check(int(fin.sum()) >= 60 and torch.equal(torch.isfinite(lp), fin),
          f"finite rows differ or too few: {int(fin.sum())}")
    rel = ((grad - g_p).norm(dim=1) / g_p.norm(dim=1))[fin]
    check(float(rel.max()) <= 1e-8, f"f64 many-model gradient rel err {float(rel.max()):.3e} > 1e-8")
    print(f"phase 11 many-model gradient: ok 64 rows ({MANY_D} datasets x 4) f64 "
          f"max_rel_err={float(rel.max()):.3e} (gate 1e-8) "
          f"value_rel_err={float(((lp - lp_p).abs() / lp_p.abs())[fin].max()):.3e}")
    return max_abs, timing


def many_rows(model, spec, B, gen):
    """B unconstrained rows of the many-model from :func:`referee_thetas`,
    with mu carried as each row's dataset's standardized mu_std."""
    th = referee_thetas(spec, B, gen)
    rows = torch.arange(B, device=th.device) // (B // MANY_D)
    xbar = torch.as_tensor(model.xbar, dtype=th.dtype, device=th.device)[rows]
    sd5 = torch.as_tensor(model.sd5, dtype=th.dtype, device=th.device)[rows]
    th[:, 5] = (th[:, 5] - xbar) / sd5
    return model.prior.to_unconstrained(th)


def phase_many(dev, out_dir, datasets):
    """Path (b): run_inference_many on the 16 ragged light curves."""
    import pioran_tpu_torch.inference as tinf
    from pioran_tpu_torch.ops import cuda_celerite, cuda_celerite_vjp as vjp

    model = tinf._many_model(datasets, device=dev, dtype=torch.float32)
    t0, _, _ = datasets[0]
    check(model.f_min == 1.0 / float(t0[-1] - t0[0])
          and model.f_max == 1.0 / float(np.min(np.diff(t0))) / 2.0,
          f"the global f band ({model.f_min}, {model.f_max}) is not dataset 0's own")
    log_dir = os.path.join(out_dir, "many")
    C = MANY["num_chains"]
    cuda_celerite.LAUNCHES = cuda_celerite.MULTI_LAUNCHES = 0
    vjp.FWD_AUG_LAUNCHES = vjp.BWD_LAUNCHES = 0
    vjp.FWD_AUG_MULTI_LAUNCHES = vjp.BWD_MULTI_LAUNCHES = 0
    t_wall = time.perf_counter()
    res = tinf.run_inference_many(datasets, device=dev, dtype=torch.float32, log_dir=log_dir,
                                  **MANY)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_wall
    launches = {"celerite_fwd_aug_multi": vjp.FWD_AUG_MULTI_LAUNCHES,
                "celerite_bwd_multi": vjp.BWD_MULTI_LAUNCHES,
                "celerite_fwd_multi": cuda_celerite.MULTI_LAUNCHES,
                "celerite_fwd": cuda_celerite.LAUNCHES,
                "celerite_fwd_aug": vjp.FWD_AUG_LAUNCHES, "celerite_bwd": vjp.BWD_LAUNCHES}
    leapfrogs = res[0]["ncall"] // C
    elapsed = res[0]["elapsed_s"]
    ess = [r["ess"] for r in res]
    print(f"phase 12 run_inference_many: datasets={len(res)} chains={C} (B={len(res) * C}) "
          f"warmup={MANY['num_warmup']} samples={MANY['num_samples']} leapfrogs={leapfrogs} "
          f"elapsed_s={elapsed:.2f} wall_s={wall:.2f} aggregate_ess={sum(ess):.1f} "
          f"aggregate_ess_per_s={sum(ess) / elapsed:.2f} launches={launches}")
    for i, (r, d) in enumerate(zip(res, datasets)):
        print(f"phase 12 ds{i}: N={len(d[0])} rhat_max={max(r['rhat']):.4f} ess={r['ess']:.1f} "
              f"converged={r['converged']} mu={r['posterior']['mean'][5]:.4f} "
              f"log_mean={float(np.mean(np.log(d[1]))):.4f}")
    # not gated: from prior starts some of dataset 0's chains stay on an
    # f_1 plateau, in the JAX package too (PERF.md; tools/many_reference.py)
    ref = referee()
    mean, sd = np.asarray(res[0]["posterior"]["mean"]), np.asarray(res[0]["posterior"]["stdev"])
    pulls = (mean - np.asarray(ref["is_mean"])) / np.asarray(ref["is_std"])
    width = sd / np.asarray(ref["is_std"])
    print(f"phase 12 ds0 vs referee (reported, not gated): pulls {np.round(pulls, 4).tolist()} "
          f"width ratios: {np.round(width, 4).tolist()}")
    for i, (r, d) in enumerate(zip(res, datasets)):
        check(r["samples"].shape == (C * MANY["num_samples"], 6)
              and bool(np.isfinite(r["samples"]).all()),
              f"ds{i}: samples {r['samples'].shape} not finite of shape ({C * MANY['num_samples']}, 6)")
        mu = r["posterior"]["mean"][5]
        check(math.isfinite(mu) and abs(mu - float(np.mean(np.log(d[1])))) < 2.0,
              f"ds{i}: mu {mu} not within 2.0 of its log-mean")
        check(os.path.isfile(os.path.join(log_dir, f"ds{i}", "info", "results.json")),
              f"ds{i}/info/results.json not written")
    check(min(launches["celerite_fwd_aug_multi"], launches["celerite_bwd_multi"]) >= leapfrogs,
          f"per-lane K3/K4 launches {launches} < leapfrogs {leapfrogs}")
    print("phase 12 run_inference_many: ok")
    return launches


def tables_cost(B: int, J: int = 20, N: int = 485, item: int = 4):
    """(bytes, operations) of one K0 launch: the three (N, 2J, B) tables,
    y and sigma2 (B, N) and suma (B,) read once, the output written once;
    about 24 J^2 operations a chain-step (K1's 20 J^2 plus the four
    products of the row and column phi, which K0 reads for both halves)."""
    return item * (3 * N * 2 * J * B + 2 * B * N + 2 * B), 24.0 * J * J * B * N


def phase_tables(spec64, spec32):
    """K0 against its plain version and against K1, its times beside its
    bound with its launch shape, and the entry point
    batched_loglike_tables driven alone."""
    from pioran_tpu_torch import _build
    from pioran_tpu_torch.ops import cuda_celerite
    from pioran_tpu_torch.ops import cuda_celerite_vjp as vjp
    from pioran_tpu_torch.ops.cuda_celerite import (
        batched_loglike, batched_loglike_tables, build_tables, loglike_from_tables,
        loglike_from_tables_plain, tables_launch_shape)

    dev = spec64.device
    gen = torch.Generator(device=dev).manual_seed(7)
    worst = {torch.float64: 0.0, torch.float32: 0.0}
    vs_k1, times = 0.0, {}
    for spec in (spec64, spec32):
        dtype = spec.dtype
        t = torch.as_tensor(spec.t, dtype=torch.float64, device=dev).to(dtype)
        for B in TABLES_BATCHES:
            a, b, c, d, y, s2 = flagship_inputs(spec, B, gen)
            U, V, phi = build_tables(a, b, c, d, t)
            suma = a.sum(1)
            k = loglike_from_tables(U, V, phi, y, s2, suma)
            p = loglike_from_tables_plain(U, V, phi, y, s2, suma)
            torch.cuda.synchronize()
            kinf, pinf = torch.isneginf(k), torch.isneginf(p)
            check(bool(torch.equal(kinf, pinf)),
                  f"K0 -inf lanes differ ({dtype}, B={B}): kernel {int(kinf.sum())}, "
                  f"plain {int(pinf.sum())}")
            check(bool(kinf[0]), "K0: the forced non-PD lane is not -inf")
            fin = ~kinf
            check(bool(torch.isfinite(k[fin]).all()), "non-finite K0 value")
            err = (k[fin] - p[fin]).abs()
            if dtype == torch.float64:
                rel = float((err / p[fin].abs()).max())
                check(rel <= 1e-9, f"K0 f64 B={B}: rel err {rel:.3e} > 1e-9")
                worst[dtype] = max(worst[dtype], rel)
                k1 = batched_loglike(a, b, c, d, t, y, s2)
                torch.cuda.synchronize()
                check(torch.equal(torch.isfinite(k1), fin), f"K0 vs K1: -inf lanes differ (B={B})")
                r1 = float(((k[fin] - k1[fin]).abs() / k1[fin].abs()).max())
                check(r1 <= 1e-9, f"K0 vs K1 f64 B={B}: rel {r1:.3e} > 1e-9")
                vs_k1 = max(vs_k1, r1)
            else:
                mx = float(err.max())
                check(mx <= 0.05, f"K0 f32 B={B}: abs err {mx:.3e} > 0.05 nats")
                worst[dtype] = max(worst[dtype], mx)
            if B in TABLES_TIMED:
                times[(str(dtype)[6:], B)] = (
                    cuda_ms(lambda: loglike_from_tables(U, V, phi, y, s2, suma), 20),  # noqa: B023
                    cuda_ms(lambda: batched_loglike_tables(a, b, c, d, t, y, s2), 20),  # noqa: B023
                    cuda_ms(lambda: build_tables(a, b, c, d, t), 20),  # noqa: B023
                    cuda_ms(lambda: batched_loglike(a, b, c, d, t, y, s2), 20),  # noqa: B023
                    cuda_ms(lambda: loglike_from_tables_plain(U, V, phi, y, s2, suma), 1))  # noqa: B023
            del U, V, phi

    def time_line(name, B, v):
        item = 4 if name == "float32" else 8
        nbytes = tables_cost(B, item=item)[0]
        sh = tables_launch_shape(B, 20, getattr(torch, name))
        return (f"{name}/B={B}: K0_ms={v[0]:.4f} entry_ms={v[1]:.4f} "
                f"build_tables_ms={v[2]:.4f} K1_ms={v[3]:.4f} plain_ms={v[4]:.2f} "
                f"achieved={nbytes / v[0] * 1e-9:.4f} TB/s "
                f"({nbytes / v[0] * 1e3 / HBM_BYTES_S:.2%} of 3.35) "
                f"shape chains={sh['chains']} steps={sh['steps']} smem={sh['smem']} "
                f"blocks_per_sm={sh['blocks_per_sm']}"
                + (f" bound_ms={bound(*tables_cost(B))[0]:.5f} ({bound(*tables_cost(B))[1]})"
                   if name == "float32" else ""))
    tstr = " ".join(time_line(k[0], k[1], v) for k, v in times.items())
    ptx = [x for x in ptxas_summary(_build.build_info("celerite_tables")[1]).split("; ")
           if ",20," in x]
    print(f"phase 13 K0 vs plain: ok N={len(spec64.t)} J=20 B={TABLES_BATCHES} lane 0 non-PD "
          f"f64_max_rel_err={worst[torch.float64]:.3e} (gate 1e-9) "
          f"f32_max_abs_err={worst[torch.float32]:.3e} (gate 0.05); K0 vs K1 f64 rel "
          f"{vs_k1:.3e} (gate 1e-9) | ptxas {ptx} | {tstr}")

    # the main path: flagship sweeps through the entry point, nothing else
    B = TABLES_BATCHES[1]
    t = torch.as_tensor(spec32.t, dtype=torch.float32, device=dev)
    inputs = [flagship_inputs(spec32, B, gen) for _ in range(TABLES_SWEEPS)]
    torch.cuda.synchronize()
    cuda_celerite.LAUNCHES = cuda_celerite.MULTI_LAUNCHES = cuda_celerite.TABLES_LAUNCHES = 0
    vjp.FWD_AUG_LAUNCHES = vjp.BWD_LAUNCHES = 0
    vjp.FWD_AUG_MULTI_LAUNCHES = vjp.BWD_MULTI_LAUNCHES = 0
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    lls = [batched_loglike_tables(a, b, c, d, t, y, s2) for a, b, c, d, y, s2 in inputs]
    stop.record()
    torch.cuda.synchronize()
    launches = cuda_celerite.TABLES_LAUNCHES
    others = (cuda_celerite.LAUNCHES, cuda_celerite.MULTI_LAUNCHES, vjp.FWD_AUG_LAUNCHES,
              vjp.BWD_LAUNCHES, vjp.FWD_AUG_MULTI_LAUNCHES, vjp.BWD_MULTI_LAUNCHES)
    sweep_ms = start.elapsed_time(stop) / TABLES_SWEEPS
    # each sweep against K1 in float64 on the same inputs: the entry
    # point's float32 error within 3x K1's own float32 error (both round
    # the flagship's ill-conditioned sums; 0.05 nats at least)
    k1_64, k1_32 = [], []
    for a, b, c, d, y, s2 in inputs:
        k1_64.append(batched_loglike(*(x.double() for x in (a, b, c, d, t, y, s2))))
        k1_32.append(batched_loglike(a, b, c, d, t, y, s2))
    torch.cuda.synchronize()
    fin = [torch.isfinite(x) for x in k1_64]
    check(all(torch.equal(f, torch.isfinite(x)) for f, x in zip(fin, lls)),
          "entry-point sweeps: -inf lanes differ from K1 in float64")
    err = max(float((x[f] - r[f]).abs().max()) for x, r, f in zip(lls, k1_64, fin))
    err_k1 = max(float((x[f] - r[f]).abs().max()) for x, r, f in zip(k1_32, k1_64, fin))
    share = float(torch.stack([f.float().mean() for f in fin]).mean())
    print(f"phase 13 entry point batched_loglike_tables: {TABLES_SWEEPS} flagship sweeps at "
          f"B={B} float32 sweep_ms={sweep_ms:.4f} (build_tables + K0) K0_launches={launches} "
          f"finite_share={share:.4f} max_abs_err_vs_f64={err:.3e} nats "
          f"(K1 float32: {err_k1:.3e}; gate max(3x K1's, 0.05))")
    check(launches == TABLES_SWEEPS, f"K0 launches {launches} != {TABLES_SWEEPS} sweeps")
    check(others == (0,) * 6, f"the entry point launched other kernels: {others}")
    check(err <= max(3.0 * err_k1, 0.05) and share > 0.9,
          f"entry-point sweeps: {err:.3e} nats off float64 (K1 float32 {err_k1:.3e}), "
          f"finite share {share:.3f}")
    b32 = ("float32", TABLES_BATCHES[1])
    return launches, worst[torch.float32], times[b32][0], times[b32][4], times


def phase_smc(dev, out_dir):
    """Tempered SMC on the flagship: run_inference(sampler="smc") with
    the committed parity run's settings."""
    import pioran_tpu_torch.inference as tinf
    from pioran_tpu_torch.ops import cuda_celerite, cuda_celerite_vjp as vjp

    sub, xbar, va = load_subset()
    spec = tinf.single_bending_model(sub[:, 0], sub[:, 1], sub[:, 2], xbar, va,
                                     device=dev, dtype=torch.float32)
    log_dir = os.path.join(out_dir, "smc")
    cuda_celerite.LAUNCHES = cuda_celerite.TABLES_LAUNCHES = 0
    vjp.FWD_AUG_LAUNCHES = vjp.BWD_LAUNCHES = 0
    t_wall = time.perf_counter()
    res = tinf.run_inference(spec, sampler="smc", log_dir=log_dir, **SMC)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_wall
    launches = {"celerite_fwd": cuda_celerite.LAUNCHES, "celerite_fwd_aug": vjp.FWD_AUG_LAUNCHES,
                "celerite_bwd": vjp.BWD_LAUNCHES, "celerite_tables": cuda_celerite.TABLES_LAUNCHES}
    steps = res["num_temper_steps"]
    ref = referee()
    mean, sd = np.asarray(res["posterior"]["mean"]), np.asarray(res["posterior"]["stdev"])
    pulls = (mean - np.asarray(ref["is_mean"])) / np.asarray(ref["is_std"])
    width = sd / np.asarray(ref["is_std"])
    print(f"phase 14 SMC: particles={SMC['num_particles']} moves={SMC['num_moves']} (mala) "
          f"logz={res['logz']:.4f} temper_steps={steps} ncall={res['ncall']} "
          f"elapsed_s={res['elapsed_s']:.2f} wall_s={wall:.2f} "
          f"ms_per_temper_step={res['elapsed_s'] / max(steps, 1) * 1e3:.1f} launches={launches}")
    print(f"phase 14 SMC pulls vs referee: {np.round(pulls, 4).tolist()} "
          f"width ratios: {np.round(width, 4).tolist()}")
    check(abs(res["logz"] - REF_LOGZ) <= SMC_LOGZ_TOL,
          f"SMC logZ {res['logz']:.4f} outside {REF_LOGZ} +- {SMC_LOGZ_TOL}")
    check(bool(np.all(np.abs(pulls) <= 0.5)), f"SMC posterior pull > 0.5 sd: {pulls}")
    check(bool(np.all((width >= 0.75) & (width <= 1.33))),
          f"SMC width ratio outside [0.75, 1.33]: {width}")
    check(res["ncall"] == steps * SMC["num_moves"] * SMC["num_particles"], "SMC ncall formula")
    # one gradient a temper step plus one a move; one K1 sweep a move
    check(launches["celerite_fwd"] >= steps * SMC["num_moves"],
          f"K1 launches {launches['celerite_fwd']} < {steps * SMC['num_moves']} moves")
    check(min(launches["celerite_fwd_aug"], launches["celerite_bwd"])
          >= steps * (SMC["num_moves"] + 1), f"K3/K4 launches {launches} < gradients")
    for rel in (("chains", "equal_weighted_post.txt"), ("info", "results.json")):
        check(os.path.isfile(os.path.join(log_dir, *rel)), f"{rel} not written")
    print("phase 14 SMC: ok")
    return launches


def gaussian_target(dev):
    """Phase 15's correlated Gaussian (tests/test_samplers.py's) on the
    card: (covariance, log-density of (C, 3) rows, the chains' start)."""
    cov = np.array([[2.0, 1.2, 0.3], [1.2, 1.5, 0.5], [0.3, 0.5, 1.0]])
    prec = torch.linalg.inv(torch.as_tensor(cov, device=dev))
    z0 = torch.as_tensor(np.random.default_rng(1).normal(size=(8, 3)), device=dev)
    return cov, lambda Z: -0.5 * torch.sum((Z @ prec) * Z, dim=1), z0


def phase_nuts_gaussian(dev):
    """NUTS on the correlated Gaussian of tests/test_samplers.py, on the
    card, with its gates."""
    from pioran_tpu_torch.samplers.nuts import run_nuts

    cov, logp, z0 = gaussian_target(dev)
    t0 = time.perf_counter()
    samples, stats = run_nuts(logp, z0, torch.Generator(device=dev).manual_seed(0),
                              **NUTS_GAUSSIAN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(samples.is_cuda, "NUTS draws are not on the card")
    s = samples.reshape(-1, 3).cpu().numpy()
    div = float(stats["diverging"].double().mean())
    mean_err = float(np.abs(s.mean(0)).max())
    cov_err = float(np.abs(np.cov(s.T) - cov).max())
    leaves = int(stats["num_leaves"].sum() + stats["warmup_num_leaves"].sum())
    print(f"phase 15 NUTS correlated Gaussian (card): chains=8 "
          f"warmup={NUTS_GAUSSIAN['num_warmup']} samples={NUTS_GAUSSIAN['num_samples']} "
          f"wall_s={wall:.2f} leaves={leaves} mean_depth={float(stats['depth'].double().mean()):.3f} "
          f"divergent={div:.4f} max_mean_err={mean_err:.4f} (gate 0.12) "
          f"max_cov_err={cov_err:.4f} (gate 0.25) step_sizes="
          f"{np.round(stats['step_size'].cpu().numpy(), 4).tolist()}")
    check(div < 0.01, f"NUTS divergences {div:.4f} >= 1%")
    check(mean_err <= 0.12, f"NUTS mean error {mean_err:.4f} > 0.12")
    check(cov_err <= 0.25, f"NUTS covariance error {cov_err:.4f} > 0.25")
    print("phase 15 NUTS Gaussian: ok")


def phase_nuts_flagship(dev, out_dir):
    """run_inference(sampler="nuts", init="advi") on the flagship: finite
    draws, ncall the exact leapfrog count, K3/K4 on every leaf; r-hat,
    pulls and depth reported, not gated (the diagonal metric's failure on
    the alpha_2/f_1 ridge is the reference's own behaviour)."""
    import pioran_tpu_torch.inference as tinf
    from pioran_tpu_torch.ops import cuda_celerite, cuda_celerite_vjp as vjp

    sub, xbar, va = load_subset()
    spec = tinf.single_bending_model(sub[:, 0], sub[:, 1], sub[:, 2], xbar, va,
                                     device=dev, dtype=torch.float32)
    log_dir = os.path.join(out_dir, "nuts")
    stats = []
    run_nuts = tinf.run_nuts

    def spy(*a, **k):
        out = run_nuts(*a, **k)
        stats.append(out[1])
        return out

    tinf.run_nuts = spy
    cuda_celerite.LAUNCHES = cuda_celerite.TABLES_LAUNCHES = 0
    vjp.FWD_AUG_LAUNCHES = vjp.BWD_LAUNCHES = 0
    try:
        res = tinf.run_inference(spec, sampler="nuts", init="advi", log_dir=log_dir,
                                 **NUTS_FLAGSHIP)
        torch.cuda.synchronize()
    finally:
        tinf.run_nuts = run_nuts
    launches = {"celerite_fwd": cuda_celerite.LAUNCHES, "celerite_fwd_aug": vjp.FWD_AUG_LAUNCHES,
                "celerite_bwd": vjp.BWD_LAUNCHES, "celerite_tables": cuda_celerite.TABLES_LAUNCHES}
    st = stats[0]
    leaves = int(st["num_leaves"].sum() + st["warmup_num_leaves"].sum())
    depth = torch.cat([st["warmup_depth"], st["depth"]], dim=1).double()
    ref = referee()
    mean = np.asarray(res["posterior"]["mean"])
    pulls = (mean - np.asarray(ref["is_mean"])) / np.asarray(ref["is_std"])
    rhat = np.asarray(res["rhat"], np.float64)
    iters = NUTS_FLAGSHIP["num_warmup"] + NUTS_FLAGSHIP["num_samples"]
    print(f"phase 16 NUTS flagship: chains={NUTS_FLAGSHIP['num_chains']} "
          f"warmup={NUTS_FLAGSHIP['num_warmup']} samples={NUTS_FLAGSHIP['num_samples']} "
          f"ncall={res['ncall']} leaves={leaves} elapsed_s={res['elapsed_s']:.2f} "
          f"s_per_iteration={res['elapsed_s'] / iters:.3f} "
          f"mean_depth={float(depth.mean()):.3f} sampling_mean_depth="
          f"{float(st['depth'].double().mean()):.3f} "
          f"divergent={float(st['diverging'].double().mean()):.4f} "
          f"ess={res['ess']:.1f} launches={launches}")
    print(f"phase 16 NUTS flagship (reported, not gated): rhat {np.round(rhat, 4).tolist()} "
          f"pulls vs referee {np.round(pulls, 4).tolist()} step_sizes "
          f"{np.round(st['step_size'].cpu().numpy(), 5).tolist()}")
    shape = (NUTS_FLAGSHIP["num_chains"] * NUTS_FLAGSHIP["num_samples"], 6)
    check(res["samples"].shape == shape and bool(np.isfinite(res["samples"]).all()),
          f"NUTS samples {res['samples'].shape} not finite of shape {shape}")
    check(res["ncall"] == leaves, f"NUTS ncall {res['ncall']} != sum of leaves {leaves}")
    check(min(launches["celerite_fwd_aug"], launches["celerite_bwd"]) > 0,
          f"the NUTS run launched no K3/K4: {launches}")
    for rel in (("chains", "equal_weighted_post.txt"), ("info", "results.json")):
        check(os.path.isfile(os.path.join(log_dir, *rel)), f"{rel} not written")
    print("phase 16 NUTS flagship: ok")
    return launches


def same_run(tag, stepped, plain, counts):
    """Gates a run_inference call with hmc_stepped=True against the same
    call without it: samples and ncall bit-equal, the K3/K4 launches
    equal. ``counts``: each run's launches."""
    check(np.array_equal(stepped["samples"], plain["samples"]),
          f"{tag}: stepped samples differ from the unstepped run's")
    check(stepped["ncall"] == plain["ncall"],
          f"{tag}: stepped ncall {stepped['ncall']} != {plain['ncall']}")
    check(counts[0] == counts[1] and min(counts[0]["celerite_fwd_aug"],
                                         counts[0]["celerite_bwd"]) > 0,
          f"{tag}: launches stepped {counts[0]} unstepped {counts[1]}")


def phase_stepped(dev):
    """Phase 16b, beside the ChEES child: the host-stepped drivers against
    the unstepped ones on the card, bit for bit. run_nuts_stepped (block
    7) against run_nuts on phase 15's Gaussian with one generator seed
    (STEPPED_GAUSSIAN: 34 warmup iterations, the fewest with a mass
    refresh); run_inference(hmc_stepped=True) on the flagship, NUTS
    (STEPPED_NUTS) and ChEES (STEPPED_CHEES), prior inits, f32, against
    the same calls without it; value_and_grad_tables at B = 512 against
    fwd_aug then bwd. Returns the run_inference calls' launches."""
    import pioran_tpu_torch.inference as tinf
    from pioran_tpu_torch.ops.cuda_celerite_vjp import bwd, fwd_aug, value_and_grad_tables
    from pioran_tpu_torch.samplers.nuts import run_nuts, run_nuts_stepped

    t0 = time.perf_counter()
    _, logp, z0 = gaussian_target(dev)
    ref_s, ref_st = run_nuts(logp, z0, torch.Generator(device=dev).manual_seed(0),
                             **STEPPED_GAUSSIAN)
    s, st = run_nuts_stepped(logp, z0, torch.Generator(device=dev).manual_seed(0), block=7,
                             **STEPPED_GAUSSIAN)
    check(np.array_equal(s, ref_s.cpu().numpy().transpose(1, 0, 2)),
          "stepped NUTS draws differ from run_nuts's on the card")
    check(all(np.array_equal(st[k], ref_st[k].cpu().numpy())
              for k in ("logp", "step_size", "inv_mass"))
          and all(np.array_equal(st[k], torch.cat([ref_st[f"warmup_{k}"], ref_st[k]], 1)
                                 .cpu().numpy())
                  for k in ("accept_stat", "diverging", "depth", "num_leaves")),
          "stepped NUTS statistics differ from run_nuts's on the card")
    gauss_s = time.perf_counter() - t0

    spec = flagship_f32(dev)
    total, walls = {}, {}
    for sampler, kw in (("nuts", STEPPED_NUTS), ("chees", STEPPED_CHEES)):
        runs, counts = [], []
        for stepped in (True, False):
            zero_launch_counts()
            t1 = time.perf_counter()
            runs.append(tinf.run_inference(spec, sampler=sampler, hmc_stepped=stepped, **kw))
            torch.cuda.synchronize()
            walls[f"{sampler}{'_stepped' if stepped else ''}"] = round(time.perf_counter() - t1, 2)
            counts.append(launch_counts())
            total = add_counts(total, counts[-1])
        same_run(f"run_inference({sampler})", *runs, counts)
        print(f"phase 16b {sampler} flagship {kw}: hmc_stepped samples and ncall "
              f"({runs[0]['ncall']}) bit-equal to the unstepped run's; launches each {counts[0]}")

    gen = torch.Generator(device=dev).manual_seed(16)
    for dtype in (torch.float64, torch.float32):
        a, b, c, d, y, s2 = flagship_inputs(spec, ADJ_BATCHES[0], gen)
        t = torch.as_tensor(spec.t, dtype=torch.float64, device=dev)
        args = tuple(x.to(dtype) for x in (a, b, c, d, t, y, s2))
        ll, grads = value_and_grad_tables(*args)
        ll_k, res = fwd_aug(*args)
        grads_k = bwd(*args, res, torch.isfinite(ll_k).to(dtype))
        torch.cuda.synchronize()
        check(torch.equal(ll, ll_k) and all(torch.equal(x, y) for x, y in zip(grads, grads_k)),
              f"value_and_grad_tables ({dtype}) differs from fwd_aug then bwd")
    print(f"phase 16b stepped NUTS on the Gaussian ({STEPPED_GAUSSIAN}, block 7) bit-equal to "
          f"run_nuts (wall_s of both {gauss_s:.2f}); run_inference walls {walls}; "
          f"value_and_grad_tables at "
          f"B={ADJ_BATCHES[0]} bit-equal to fwd_aug then bwd (f64, f32)")
    print("phase 16b stepped drivers: ok")
    return total


def builder_spec(name, dev, dtype):
    """The port's spec of one of BUILDERS on its light curve."""
    import pioran_tpu_torch.inference as tinf

    dirname, fname, builder, kw = BUILDERS[name][:4]
    A, xbar, va = load_curve(dirname, fname)
    return getattr(tinf, builder)(A[:, 0], A[:, 1], A[:, 2], xbar, va, device=dev,
                                  dtype=dtype, **kw)


def stored_point(name):
    """(theta in spec order, logl, tolerance) of the model's stored
    maximum-likelihood point, or None: the reference's ultranest run for
    the power-law models (float64, 1e-6), the committed CARMA(2,1) NS run
    for CARMA (a float32 run: 0.3, the bound of
    tests/test_tpu_artifacts.py)."""
    perm = BUILDERS[name][4]
    if perm is not None:
        with open(os.path.join(DATA, BUILDERS[name][0], "results.json")) as fh:
            ml = json.load(fh)["maximum_likelihood"]
        return [ml["point"][i] for i in perm], ml["logl"], 1e-6
    if name == "carma21":
        with open(os.path.join(PARITY, "summary.json")) as fh:
            entry = json.load(fh)["runs"]["carma_ns"]
        return entry["ml_point"], entry["ml_logl"], 0.3
    return None


def model_inputs(spec, TH):
    """The (a, b, c, d, y, sigma2) that ``spec.loglike_batch(TH)`` hands
    the kernels, as the model makes them (the model's closure looks
    ``batched_loglike`` up at each call)."""
    import pioran_tpu_torch.inference as tinf

    seen = []

    def grab(a, b, c, d, t, y, sigma2, dt=None):
        seen.append((a, b, c, d, y, sigma2))
        return a.new_zeros(a.shape[0])

    kernel_loglike = tinf.batched_loglike
    tinf.batched_loglike = grab
    try:
        with torch.no_grad():
            spec.loglike_batch(TH)
    finally:
        tinf.batched_loglike = kernel_loglike
    return seen[0]


def f32_spread(tag, name, e_k, e_q):
    """The float32 gate on prior draws: at the median and the 90th
    percentile of the rows, the kernel's error within 3x the plain
    loop's own (or 1e-7). Prior draws include covariances so ill
    conditioned that float32 keeps no digit in either order, so the
    largest errors are reported, not gated. Returns the three ratios
    (median, 90th percentile, largest)."""
    qs = torch.tensor([0.5, 0.9], dtype=torch.float64, device=e_k.device)
    k50, k90 = torch.quantile(e_k.double(), qs).tolist()
    q50, q90 = torch.quantile(e_q.double(), qs).tolist()
    check(k50 <= max(3.0 * q50, 1e-7) and k90 <= max(3.0 * q90, 1e-7),
          f"{tag} {name} f32: kernel rel err median/90% {k50:.3e}/{k90:.3e} > 3 x the f32 "
          f"plain loop's {q50:.3e}/{q90:.3e}")
    return k50 / max(q50, 1e-12), k90 / max(q90, 1e-12), float(e_k.max() / e_q.max().clamp_min(1e-12))


def ll_err(x, ref):
    """Per-chain error of log-likelihoods, relative to max(|ll|, 1 nat):
    prior draws reach log-likelihoods near 0."""
    ref = ref.double()
    return (x.double() - ref).abs() / ref.abs().clamp_min(1.0)


def chain_err(x, ref):
    """Per-chain 2-norm relative error of (B, ...) tables."""
    x, ref = x.double().reshape(x.shape[0], -1), ref.double().reshape(ref.shape[0], -1)
    return (x - ref).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-300)


def f64_bound(e_q32) -> float:
    """The float64 gate on prior draws: 1e-9, or where the plain loop's
    own float32 error shows an ill-conditioned draw, 3x the float64
    rounding that conditioning predicts: e_q32 x 2^-53 / 2^-24."""
    return max(1e-9, 3.0 * 2.0**-29 * e_q32)


def same_neginf(tag, k, p, blind=None):
    """The kernel's -inf lanes (not positive definite) are the plain
    version's, and lane 0 (forced) is one of them; in float32 a lane may
    differ only where ``blind`` marks the draw ill-conditioned. Returns
    the number of lanes that differ."""
    differ = torch.isneginf(k) != torch.isneginf(p)
    allowed = torch.zeros_like(differ) if blind is None else blind
    check(not bool((differ & ~allowed).any()) and bool(torch.isneginf(k[0])),
          f"{tag}: -inf lanes differ: kernel {int(torch.isneginf(k).sum())}, plain "
          f"{int(torch.isneginf(p).sum())}, {int((differ & ~allowed).sum())} of them on "
          f"well-conditioned draws")
    return int(differ.sum())


def f32_blind(p32, p64):
    """Lanes where float32 keeps no digit of the answer: finite in
    float64, and the f32 plain loop -inf or more than 1e-3 off (relative
    to max(|ll|, 1 nat))."""
    off = ll_err(torch.where(torch.isfinite(p32), p32, 0.0), torch.where(torch.isfinite(p64), p64, 0.0))
    return torch.isfinite(p64) & (torch.isneginf(p32) | (off > 1e-3))


def hold_k1(args64, dt, tag):
    """K1 against its plain version on one batch of prior draws: the
    largest f64 error, per row relative to max(|ll|, 1 nat), within
    :func:`f64_bound` of the plain loop's largest f32 error; f32 by
    :func:`f32_spread`; -inf on the plain version's lanes (float32: see
    :func:`same_neginf`). Returns (f64 err, its bound, f32 ratios, f32 max
    abs err against the f32 plain loop, f32 lanes whose -inf differs)."""
    from pioran_tpu_torch.ops.cuda_celerite import batched_loglike, batched_loglike_plain

    args32 = tuple(x.float() for x in args64)
    k64, p64 = batched_loglike(*args64, dt), batched_loglike_plain(*args64, dt)
    k32, p32 = batched_loglike(*args32, dt), batched_loglike_plain(*args32, dt)
    torch.cuda.synchronize()
    same_neginf(f"{tag} K1 f64", k64, p64)
    n_differ = same_neginf(f"{tag} K1 f32", k32, p32, f32_blind(p32, p64))
    fin = torch.isfinite(p64) & torch.isfinite(p32) & torch.isfinite(k32)
    check(int(fin.sum()) > 0.5 * fin.numel(), f"{tag}: only {int(fin.sum())} finite lanes")
    e_q = ll_err(p32[fin], p64[fin])
    e64, b64 = float(ll_err(k64[fin], p64[fin]).max()), f64_bound(float(e_q.max()))
    check(e64 <= b64, f"{tag} K1 f64: rel err {e64:.3e} > {b64:.3e}")
    ratios = f32_spread(tag, "K1", ll_err(k32[fin], p64[fin]), e_q)
    return e64, b64, ratios, float((k32[fin] - p32[fin]).abs().max()), n_differ


def hold_k3k4(args64, dt, tag):
    """K3/K4 against their plain versions on one batch of prior draws,
    per chain (ll as in :func:`hold_k1`, tables and cotangents 2-norm
    relative), on the chains finite in every version: each output's
    largest f64 error within :func:`f64_bound` of the plain loop's
    largest f32 error on it; f32 by :func:`f32_spread`; -inf lanes as in
    :func:`hold_k1`; the non-PD lane's gradient zero. t's cotangent sums
    every chain, so it carries the worst-conditioned draws' float32
    error: its f32 error is reported, not gated (no model takes a time
    gradient; phase 6 gates it near the posterior). Returns (the f64
    error nearest its bound, that bound, the worst f32 ratios, {K3, K4:
    max abs err against the f32 plain loop}, t's f32 kernel/plain error
    ratio, f32 lanes whose -inf differs, the output nearest its bound)."""
    from pioran_tpu_torch.ops.cuda_celerite_vjp import bwd, bwd_plain, fwd_aug, fwd_aug_plain

    B = args64[0].shape[0]
    args32 = tuple(x.float() for x in args64)
    ll_p, res_p = fwd_aug_plain(*args64, dt=dt)
    ll_q, res_q = fwd_aug_plain(*args32, dt=dt)
    out64, out32 = fwd_aug(*args64, dt=dt), fwd_aug(*args32, dt=dt)
    torch.cuda.synchronize()
    same_neginf(f"{tag} K3 f64", out64[0], ll_p)
    n_differ = same_neginf(f"{tag} K3 f32", out32[0], ll_q, f32_blind(ll_q, ll_p))
    fin = torch.isfinite(ll_p) & torch.isfinite(ll_q) & torch.isfinite(out32[0])
    g = torch.where(fin, torch.linspace(0.5, 1.5, B, dtype=torch.float64, device=fin.device), 0.0)
    refs = adjoint_rows(fin, ll_p, res_p, bwd_plain(*args64, res_p, g, dt=dt))
    own = adjoint_rows(fin, ll_q, res_q, bwd_plain(*args32, res_q, g.float(), dt=dt))
    err = lambda i, x, r: ll_err(x[:, 0], r[:, 0]) if i == 0 else chain_err(x, r)  # noqa: E731
    bounds = [f64_bound(float(err(i, q, r).max())) for i, (q, r) in enumerate(zip(own, refs))]
    rows = {}
    for dtype, args, (ll, res) in ((torch.float64, args64, out64), (torch.float32, args32, out32)):
        grads = bwd(*args, res, g.to(dtype), dt=dt)
        torch.cuda.synchronize()
        check(all(x.dim() == 1 or bool((x[0] == 0).all()) for x in grads),
              f"{tag} K4 {dtype}: the non-PD lane's gradient is not zero")
        rows[dtype] = adjoint_rows(fin, ll, res, grads)
        check(all(bool(torch.isfinite(x).all()) for x in rows[dtype][8:]),
              f"{tag} K4 {dtype}: non-finite cotangent")
    errs = [float(err(i, x, r).max()) for i, (x, r) in enumerate(zip(rows[torch.float64], refs))]
    for name, e, b in zip(ADJ_NAMES, errs, bounds):
        check(e <= b, f"{tag} f64 {name}: rel err {e:.3e} > {b:.3e}")
    worst = int(np.argmax(np.asarray(errs) / np.asarray(bounds)))
    ratios, max_abs = [0.0, 0.0, 0.0], {"celerite_fwd_aug": 0.0, "celerite_bwd": 0.0}
    t_bar = ADJ_NAMES.index("t_bar")
    for i, (x, q, r) in enumerate(zip(rows[torch.float32], own, refs)):
        key = "celerite_fwd_aug" if i < 8 else "celerite_bwd"
        max_abs[key] = max(max_abs[key], float((x.double() - q.double()).abs().max()))
        if i != t_bar:
            ratios = [max(u, v) for u, v in
                      zip(ratios, f32_spread(tag, ADJ_NAMES[i], err(i, x, r), err(i, q, r)))]
    t_ratio = float(err(t_bar, rows[torch.float32][t_bar], refs[t_bar])
                    / err(t_bar, own[t_bar], refs[t_bar]))
    return errs[worst], bounds[worst], ratios, max_abs, t_ratio, n_differ, ADJ_NAMES[worst]


def builder_grad(spec64, name):
    """The f64 log-posterior gradient through K3/K4 against autograd
    through the plain loop at 64 rows from the middle half of the prior
    (phase 7's gate, 1e-8 relative per row). Returns (max rel err, the
    periodic model's A, phi, T0 entries' own max rel err or None)."""
    import pioran_tpu_torch.inference as tinf
    from pioran_tpu_torch.ops import cuda_celerite_vjp as vjp
    from pioran_tpu_torch.ops.cuda_celerite import batched_loglike_plain
    from pioran_tpu_torch.samplers.chees import batch_value_and_grad

    dev, prior = spec64.device, spec64.prior
    gen = torch.Generator(device=dev).manual_seed(18)
    U = 0.25 + 0.5 * torch.rand((64, prior.dim), generator=gen, dtype=torch.float64, device=dev)
    Z = prior.to_unconstrained(prior.transform(U))
    n3, n4 = vjp.FWD_AUG_LAUNCHES, vjp.BWD_LAUNCHES
    lp, g = batch_value_and_grad(spec64.logpost_batch, Z)
    torch.cuda.synchronize()
    check((vjp.FWD_AUG_LAUNCHES, vjp.BWD_LAUNCHES) == (n3 + 1, n4 + 1),
          f"{name}: the gradient did not run K3 and K4 once each")
    kernel_loglike = tinf.batched_loglike
    tinf.batched_loglike = batched_loglike_plain
    try:
        lp_p, g_p = batch_value_and_grad(spec64.logpost_batch, Z)
    finally:
        tinf.batched_loglike = kernel_loglike
    fin = torch.isfinite(lp_p)
    check(int(fin.sum()) >= 60 and torch.equal(torch.isfinite(lp), fin),
          f"{name}: finite rows differ or too few: {int(fin.sum())}")
    rel = float(((g - g_p).norm(dim=1) / g_p.norm(dim=1))[fin].max())
    check(rel <= 1e-8, f"{name} f64 gradient rel err {rel:.3e} > 1e-8")
    if name != "periodic":
        return rel, None
    sub, sub_p = g[fin][:, 6:], g_p[fin][:, 6:]
    check(bool((sub_p.abs() > 0).all()), "periodic: a zero A, phi or T0 gradient entry")
    return rel, float(((sub - sub_p).norm(dim=1) / sub_p.norm(dim=1)).max())


def phase_builders(dev):
    """Phase 17: each other builder on the card at full width, f64 value
    at its stored point, K1 and K3/K4 against their plain versions on its
    own coefficients (prior draws), and its f64 gradient."""
    for name in BUILDERS:
        t0 = time.perf_counter()
        spec64 = builder_spec(name, dev, torch.float64)
        J = BUILDERS[name][5]
        stored = stored_point(name)
        value = "no stored point"
        if stored is not None:
            th, logl, tol = stored
            ll = float(spec64.loglike(torch.tensor(th, dtype=torch.float64, device=dev)))
            check(abs(ll - logl) <= tol, f"{name}: f64 logl {ll!r} at the stored point, "
                  f"stored {logl!r} (gate {tol})")
            value = f"f64 logl at the stored point {ll!r} (stored {logl!r}, gate {tol})"
        t = torch.as_tensor(spec64.t, dtype=torch.float64, device=dev)
        dt = torch.as_tensor(np.diff(spec64.t.astype(np.float64)), device=dev)
        gen = torch.Generator(device=dev).manual_seed(17)
        k1, k34 = [], []
        for B in BUILDER_BATCHES:
            TH = spec64.prior.sample((B,), generator=gen, dtype=torch.float64, device=dev)
            a, b, c, d, y, s2 = model_inputs(spec64, TH)
            check(tuple(a.shape) == (B, J) and tuple(y.shape) == (B, len(spec64.t)),
                  f"{name}: coefficients {tuple(a.shape)}, y {tuple(y.shape)}")
            a = a.clone()
            a[0] = -50.0 * a[0]  # lane 0 not positive definite
            args64 = (a, b, c, d, t, y, s2)
            k1.append(hold_k1(args64, dt, f"{name} B={B}"))
            k34.append(hold_k3k4(args64, dt, f"{name} B={B}"))
        grad_rel, sub_rel = builder_grad(spec64, name)
        r1 = [max(x[2][i] for x in k1) for i in range(3)]
        r34 = [max(x[2][i] for x in k34) for i in range(3)]
        w1, w34 = max(k1, key=lambda x: x[0] / x[1]), max(k34, key=lambda x: x[0] / x[1])
        print(f"phase 17 {name}: ok J={J} N={len(spec64.t)} {value}; B={BUILDER_BATCHES} prior "
              f"draws, lane 0 non-PD: f64 rel err (gate) K1 {w1[0]:.3e} ({w1[1]:.1e}), K3/K4 "
              f"{w34[0]:.3e} ({w34[1]:.1e}) in {w34[6]}; f32 kernel/plain error ratios "
              f"median/90%/max K1 {r1[0]:.2f}/{r1[1]:.2f}/{r1[2]:.2f}, K3/K4 worst output "
              f"{r34[0]:.2f}/{r34[1]:.2f}/{r34[2]:.2f} (gate 3 at the median and 90%), t_bar "
              f"{max(x[4] for x in k34):.2f} (reported); f32 -inf lanes that differ (ill-conditioned "
              f"draws) K1 {sum(x[4] for x in k1)} K3 {sum(x[5] for x in k34)}; f32 max abs err "
              f"against the f32 plain "
              f"loop K1 {max(x[3] for x in k1):.3e} K3 "
              f"{max(x[3]['celerite_fwd_aug'] for x in k34):.3e} K4 "
              f"{max(x[3]['celerite_bwd'] for x in k34):.3e}; f64 gradient 64 rows max rel "
              f"{grad_rel:.3e} (gate 1e-8)"
              + (f", A/phi/T0 entries {sub_rel:.3e}" if sub_rel is not None else "")
              + f"; wall_s={time.perf_counter() - t0:.1f}")


def phase_builders_smc(dev, out_dir):
    """Phase 18: run_inference(sampler="smc") on the double-bending,
    periodic and CARMA(2,1) models with phase 14's settings, gated as the
    JAX package's parity runs are."""
    import pioran_tpu_torch.inference as tinf
    from pioran_tpu_torch.ops import cuda_celerite, cuda_celerite_vjp as vjp

    total = {"celerite_fwd": 0, "celerite_fwd_aug": 0, "celerite_bwd": 0, "celerite_tables": 0}
    walls = {}
    for name in SMC_BUILDERS:
        gate = smc_gate(name)
        spec = builder_spec(name, dev, torch.float32)
        log_dir = os.path.join(out_dir, f"smc_{name}")
        cuda_celerite.LAUNCHES = cuda_celerite.TABLES_LAUNCHES = 0
        vjp.FWD_AUG_LAUNCHES = vjp.BWD_LAUNCHES = 0
        t_wall = time.perf_counter()
        res = tinf.run_inference(spec, sampler="smc", log_dir=log_dir, **SMC)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_wall
        launches = {"celerite_fwd": cuda_celerite.LAUNCHES,
                    "celerite_fwd_aug": vjp.FWD_AUG_LAUNCHES,
                    "celerite_bwd": vjp.BWD_LAUNCHES,
                    "celerite_tables": cuda_celerite.TABLES_LAUNCHES}
        steps = res["num_temper_steps"]
        mean, sd = np.asarray(res["posterior"]["mean"]), np.asarray(res["posterior"]["stdev"])
        ref_mean, ref_sd = gate["mean"], gate["sd"]
        pulls = (mean - ref_mean) / (np.sqrt(ref_sd**2 + sd**2) if gate["combined"] else ref_sd)
        width = sd / ref_sd
        lo, hi = gate["widths"]
        walls[name] = round(wall, 2)
        print(f"phase 18 SMC {name}: particles={SMC['num_particles']} moves={SMC['num_moves']} "
              f"(mala) logz={res['logz']:.4f} (gate {gate['logz']} +- {gate['logz_tol']}) "
              f"temper_steps={steps} ncall={res['ncall']} elapsed_s={res['elapsed_s']:.2f} "
              f"wall_s={wall:.2f} ms_per_temper_step={res['elapsed_s'] / max(steps, 1) * 1e3:.1f} "
              f"launches={launches}")
        print(f"phase 18 SMC {name} pulls vs {gate['against']}: {np.round(pulls, 4).tolist()} "
              f"width ratios: {np.round(width, 4).tolist()} (gate [{lo}, {hi}])")
        check(abs(res["logz"] - gate["logz"]) <= gate["logz_tol"],
              f"{name} SMC logZ {res['logz']:.4f} outside {gate['logz']} +- {gate['logz_tol']}")
        check(bool(np.all(np.abs(pulls) <= 0.5)), f"{name} SMC posterior pull > 0.5 sd: {pulls}")
        check(bool(np.all((width >= lo) & (width <= hi))),
              f"{name} SMC width ratio outside [{lo}, {hi}]: {width}")
        check(res["ncall"] == steps * SMC["num_moves"] * SMC["num_particles"],
              f"{name} SMC ncall formula")
        check(launches["celerite_fwd"] >= steps * SMC["num_moves"],
              f"{name}: K1 launches {launches['celerite_fwd']} < {steps * SMC['num_moves']} moves")
        check(min(launches["celerite_fwd_aug"], launches["celerite_bwd"])
              >= steps * (SMC["num_moves"] + 1), f"{name}: K3/K4 launches {launches} < gradients")
        check(launches["celerite_tables"] == 0, f"{name}: the SMC run launched K0")
        for rel in (("chains", "equal_weighted_post.txt"), ("info", "results.json")):
            check(os.path.isfile(os.path.join(log_dir, *rel)), f"{name}: {rel} not written")
        for key in total:
            total[key] += launches[key]
    print(f"phase 18 SMC on the builders: ok walls_s={walls}")
    return total


def smc_gate(name):
    """Phase 18's gates for one model, from the committed records: the
    JAX package's parity gates (examples/tpu_parity.py,
    tests/test_tpu_artifacts.py). Power-law models: the reference's
    ultranest logZ with the parity run's tolerance, pulls in the
    importance-sampling referee's standard deviations, widths against its
    in the JAX SMC run's recorded gate ([0.75, 1.33] where it recorded
    none). CARMA(2,1): the committed NS run's logZ within 1.5, pulls in
    the combined standard deviation of both runs (the cross-sampler gate)
    and widths against that run's equal-weighted posterior."""
    with open(os.path.join(PARITY, "summary.json")) as fh:
        runs = json.load(fh)["runs"]
    if name == "carma21":
        theta = np.loadtxt(os.path.join(PARITY, "carma_ns", "chains",
                                        "equal_weighted_post.txt"), skiprows=1)
        return dict(logz=runs["carma_ns"]["logz"], logz_tol=1.5, mean=theta.mean(axis=0),
                    sd=theta.std(axis=0), combined=True, widths=(0.75, 1.33),
                    against="the committed CARMA(2,1) NS run")
    entry = runs[f"{name}_smc"]
    with open(os.path.join(DATA, BUILDERS[name][0], "is_referee.json")) as fh:
        ref = json.load(fh)
    return dict(logz=entry["logz_ref"], logz_tol=entry["logz_tol"],
                mean=np.asarray(ref["is_mean"]), sd=np.asarray(ref["is_std"]), combined=False,
                widths=tuple(entry.get("width_gate_referee", (0.75, 1.33))),
                against="the referee")


def rel_norm(x, ref) -> float:
    """Largest row-wise 2-norm relative error of x against ref, (B, N)."""
    return float((torch.linalg.vector_norm(x - ref, dim=-1)
                  / torch.linalg.vector_norm(ref, dim=-1)).max())


def phase_post_fit(dev, out_dir):
    """Phase 19: the GP object API and the post-fit diagnostics on the card.

    logpdf at the flagship point through K1 (float64, and float32 on the
    same inputs rounded), its gradient through K3/K4 against autograd
    through the plain loop, the posterior solve z = -ȳ of K3/K4 against
    the plain three-scan solve, PosteriorGP's mean (both methods), cov
    and std against the dense predictors at M = 2N, simulate's whitened
    draws at B = 2048, and run_posterior_predict_checks on phase 14's
    SMC posterior (float64, 100 draws for the time series, the JAX
    default of up to 1000 for the periodogram, no figures: the card's
    machine has no matplotlib). Returns the phase's K1/K3/K4 launches;
    the comparisons with plain versions launch nothing and the timings
    after the main path are not counted."""
    from pioran_tpu_torch import single_bending_model
    from pioran_tpu_torch.diagnostics import run_posterior_predict_checks
    from pioran_tpu_torch.models.gp import ScalableGP, posterior
    from pioran_tpu_torch.models.kernels import CeleriteKernel
    from pioran_tpu_torch.ops import celerite as cel, cuda_celerite, direct
    from pioran_tpu_torch.ops import cuda_celerite_vjp as vjp

    f64 = torch.float64
    A = np.loadtxt(os.path.join(DATA, "simu.txt"))
    xbar, va = float(np.mean(np.log(A[:, 1]))), float(np.var(np.log(A[:, 1])))
    full = single_bending_model(A[:, 0], A[:, 1], A[:, 2], xbar, va, device=dev, dtype=f64)
    sub, sxbar, sva = load_subset()
    spec = single_bending_model(sub[:, 0], sub[:, 1], sub[:, 2], sxbar, sva, device=dev,
                                dtype=f64)
    t = torch.as_tensor(spec.t, device=dev)
    obs = torch.log(torch.as_tensor(spec.y, device=dev))
    th = torch.tensor(FLAGSHIP_THETA, dtype=f64, device=dev)
    rows4 = torch.cat([th[None], referee_thetas(spec, 3, torch.Generator(device=dev)
                                                .manual_seed(19))])

    cuda_celerite.LAUNCHES = 0
    vjp.FWD_AUG_LAUNCHES = vjp.BWD_LAUNCHES = 0
    counts = lambda: (cuda_celerite.LAUNCHES, vjp.FWD_AUG_LAUNCHES,  # noqa: E731
                      vjp.BWD_LAUNCHES)
    t_wall = time.perf_counter()

    # logpdf through K1: float64 at the flagship point, then the same
    # inputs rounded to float32, held to phase 2's gate against the plain
    # loop in float32 and to phase 4's against the float64 value (float32
    # input rounding alone moves this value 0.02-0.06 nats; float32's own
    # basis solve adds about 0.16, phase 4)
    fx = full.gp_model(full.t, full.y, full.yerr, th[None])
    fobs = torch.log(torch.as_tensor(full.y, device=dev))
    before = counts()
    ll64 = float(fx.logpdf(fobs)[0])
    check(counts() == (before[0] + 1,) + before[1:], f"logpdf launches {before} -> {counts()}")
    rel64 = abs(ll64 / FLAGSHIP_LL64 - 1.0)
    check(rel64 <= 1e-9, f"f64 logpdf {ll64!r}: rel {rel64:.3e} from {FLAGSHIP_LL64!r}")
    k = fx.gp.kernel
    fx32 = ScalableGP(fx.gp.mean.float(), CeleriteKernel(*(x.float() for x in
                                                            k.coefficients())))(
        fx.t.float(), fx.sigma2.float())
    ll32 = float(fx32.logpdf(fobs.float())[0])
    k32 = fx32.gp.kernel.coefficients()
    ll32_plain = float(cuda_celerite.batched_loglike_plain(
        *k32, fx32.t, fx32._resid(fobs.float()).contiguous(), fx32.sigma2)[0])
    check(abs(ll32 - ll32_plain) <= 0.05 and abs(ll32 - FLAGSHIP_LL64) <= 0.5,
          f"f32 logpdf {ll32!r}: plain loop {ll32_plain!r}, f64 reference {FLAGSHIP_LL64!r}")

    # the gradient of logpdf in the coefficients, K3/K4 against autograd
    # through the plain loop, four rows of the subset
    gp4 = spec.gp_model(t, spec.y, spec.yerr, rows4)
    leaves = [x.detach().clone().requires_grad_(True) for x in gp4.gp.kernel.coefficients()]
    fx4 = ScalableGP(gp4.gp.mean, CeleriteKernel(*leaves))(t, gp4.sigma2)
    before = counts()
    fx4.logpdf(obs).sum().backward()
    check(counts() == (before[0], before[1] + 1, before[2] + 1),
          f"gradient launches {before} -> {counts()}")
    grads = [x.grad for x in leaves]
    plain = [x.detach().clone().requires_grad_(True) for x in leaves]
    resid = (obs - gp4.gp.mean).expand(4, -1).contiguous()
    cuda_celerite.batched_loglike_plain(*plain, t, resid, gp4.sigma2.contiguous()).sum().backward()
    grad_rel = max(rel_norm(g, p.grad) for g, p in zip(grads, plain))
    check(grad_rel <= 1e-8, f"logpdf gradient rel {grad_rel:.3e} > 1e-8")

    # the posterior solve: z = -ȳ of K3/K4 against the plain three-scan solve
    before = counts()
    z = cel._solve(gp4.gp.kernel, t, resid, gp4.sigma2)
    check(counts() == (before[0], before[1] + 1, before[2] + 1),
          f"solve launches {before} -> {counts()}")
    z_ref = cel.celerite_factor_solve(*gp4.gp.kernel.coefficients(), t, resid, gp4.sigma2)[0]
    solve_rel = rel_norm(z, z_ref)
    check(solve_rel <= 1e-9, f"posterior solve rel {solve_rel:.3e} > 1e-9")

    # PosteriorGP at M = 2N against the dense predictors
    tau = torch.linspace(float(t[0]), float(t[-1]), 2 * len(t), dtype=f64, device=dev)
    post = posterior(gp4, obs)
    mean_ref, cov_ref = direct.predict_direct(gp4.gp.kernel, tau, t, resid, gp4.sigma2,
                                              with_covariance=True)
    mean_ref = mean_ref + gp4.gp.mean
    mean_rel = max(rel_norm(post.mean(tau, method=m), mean_ref) for m in ("matmul", "scan"))
    check(mean_rel <= 1e-8, f"posterior mean rel {mean_rel:.3e} > 1e-8")
    cov_rel = float((post.cov(tau) - cov_ref).abs().max() / cov_ref.abs().max())
    std_rel = rel_norm(post.std(tau), torch.sqrt(torch.diagonal(cov_ref, dim1=-2, dim2=-1)))
    check(max(cov_rel, std_rel) <= 1e-8, f"posterior cov/std rel {cov_rel:.3e}/{std_rel:.3e}")

    # simulate at B = 2048 draws, whitened by the dense factor
    sim_B = 2048
    k0 = CeleriteKernel(*(x[:1].expand(sim_B, -1) for x in gp4.gp.kernel.coefficients()))
    gen = torch.Generator(device=dev).manual_seed(190)
    draws = cel.simulate(gen, k0, t, gp4.sigma2[0])
    L = torch.linalg.cholesky(direct.covariance_matrix(
        CeleriteKernel(*(x[0] for x in gp4.gp.kernel.coefficients())), t, t)
        + torch.diag(gp4.sigma2[0]))
    white = torch.linalg.solve_triangular(L, draws.T, upper=False)
    w_mean, w_var = float(white.mean()), float(white.var(unbiased=False))
    check(abs(w_mean) < 0.02 and abs(w_var - 1.0) <= 0.03,
          f"simulate whitened mean {w_mean:.4f} var {w_var:.4f}")

    # the posterior predictive checks on phase 14's SMC posterior
    samples = np.loadtxt(os.path.join(out_dir, "smc", "chains", "equal_weighted_post.txt"),
                         skiprows=1)
    ppc_dir = os.path.join(out_dir, "ppc") + os.sep
    check_s, ppc_gen = {}, torch.Generator(device=dev).manual_seed(0)
    for plot in ("psd", "lsp", "timeseries"):
        t0 = time.perf_counter()
        run_posterior_predict_checks(samples, spec.names, spec.paramnames_split, spec.t,
                                     spec.y, spec.yerr, spec.psd_model, spec.gp_model, True,
                                     plots=[plot], n_samples=100, path=ppc_dir,
                                     generator=ppc_gen, make_figures=False, device=dev,
                                     dtype=f64)
        torch.cuda.synchronize()
        check_s[plot] = round(time.perf_counter() - t0, 3)
    for name in ("psd_ppc_data.txt", "psd_noise_levels.txt", "lsp_ppc_data.txt",
                 "binned_lsp_data.txt", "ppc_timeseries_quantiles.txt",
                 "ppc_residuals_quantiles.txt", "ppc_residuals_mean.txt", "ppc_t_pred.txt",
                 "ppc_residuals_acvf.txt"):
        x = np.loadtxt(ppc_dir + name)
        check(bool(np.all(np.isfinite(x))), f"{name} not finite")
    psd_shape = np.loadtxt(ppc_dir + "psd_ppc_data.txt").shape
    check(psd_shape == (11, 1000), f"psd_ppc_data.txt is {psd_shape}")
    res_abs = float(np.abs(np.loadtxt(ppc_dir + "ppc_residuals_mean.txt")).mean())
    check(res_abs < 5.0, f"mean absolute standardized residual {res_abs:.3f} >= 5")
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t_wall
    k1, k3, k4 = counts()
    launches = {"celerite_fwd": k1, "celerite_fwd_aug": k3, "celerite_bwd": k4}
    check(min(launches.values()) > 0, f"a kernel of the post-fit path never ran: {launches}")

    # card times (CUDA events), not counted as the path's launches
    gp100 = spec.gp_model(t, spec.y, spec.yerr, samples[:100])
    r100 = gp100._resid(obs)
    one = spec.gp_model(t, spec.y, spec.yerr, th[None])
    ms = {
        "logpdf_B1": cuda_ms(lambda: one.logpdf(obs), 20),
        "logpdf_B100": cuda_ms(lambda: gp100.logpdf(obs), 20),
        "solve_B100": cuda_ms(lambda: cel._solve(gp100.gp.kernel, t, r100, gp100.sigma2), 10),
        "predict_matmul_B100": cuda_ms(lambda: cel.predict_matmul(
            gp100.gp.kernel, tau, t, r100, gp100.sigma2), 5),
        "predict_B100": cuda_ms(lambda: cel.predict(gp100.gp.kernel, tau, t, r100,
                                                     gp100.sigma2), 3),
        f"simulate_B{sim_B}": cuda_ms(lambda: cel.simulate(gen, k0, t, gp4.sigma2[0]), 3),
    }
    print(f"phase 19 post-fit: logpdf f64 {ll64!r} (rel {rel64:.2e}, one K1 launch), f32 on "
          f"the rounded inputs {ll32!r} (plain f32 loop {ll32_plain!r}: abs "
          f"{abs(ll32 - ll32_plain):.4f}; from the f64 reference {abs(ll32 - FLAGSHIP_LL64):.4f}"
          f"); gradient 4 rows "
          f"rel {grad_rel:.3e} (K3, K4 once); solve -ybar rel {solve_rel:.3e}; posterior "
          f"M={len(tau)} mean rel {mean_rel:.3e} cov {cov_rel:.3e} std {std_rel:.3e}; "
          f"simulate B={sim_B} whitened mean {w_mean:.4f} var {w_var:.4f}")
    print(f"phase 19 PPC: {samples.shape[0]} posterior rows, psd_ppc_data {psd_shape}, mean "
          f"|standardized residual| {res_abs:.3f}; check wall_s {check_s}; path wall_s "
          f"{path_s:.2f} launches {launches}")
    print(f"phase 19 times (CUDA events, ms, float64, N={len(t)}, M={len(tau)}): "
          + " ".join(f"{k}={v:.4f}" for k, v in ms.items()))
    print("phase 19 post-fit: ok")
    return launches


def launch_counts():
    """K1, K3/K4 and K0 launch counters (the NS, SMC, ChEES and NUTS paths)."""
    from pioran_tpu_torch.ops import cuda_celerite, cuda_celerite_vjp as vjp

    return {"celerite_fwd": cuda_celerite.LAUNCHES, "celerite_fwd_aug": vjp.FWD_AUG_LAUNCHES,
            "celerite_bwd": vjp.BWD_LAUNCHES, "celerite_tables": cuda_celerite.TABLES_LAUNCHES}


def zero_launch_counts():
    from pioran_tpu_torch.ops import cuda_celerite, cuda_celerite_vjp as vjp

    cuda_celerite.LAUNCHES = cuda_celerite.TABLES_LAUNCHES = 0
    vjp.FWD_AUG_LAUNCHES = vjp.BWD_LAUNCHES = 0


def add_counts(total, more):
    return {k: total.get(k, 0) + v for k, v in more.items()}


def flagship_f32(dev):
    from pioran_tpu_torch import single_bending_model

    sub, xbar, va = load_subset()
    return single_bending_model(sub[:, 0], sub[:, 1], sub[:, 2], xbar, va, device=dev,
                                dtype=torch.float32)


def phase_resume(dev, out_dir):
    """Phase 20: resume on the card. Flagship SMC (float32, phase 14's 1024
    particles and 12 MALA moves) and NS (256 live points) through
    run_inference(log_dir=..., resume=True): the uninterrupted run keeps
    every checkpoint; a second run starts from a copy of its mid-run
    checkpoint alone. Gate: the resumed logZ, particles (SMC) and dead
    buffers (NS) bit-equal to the uninterrupted run's. Also times a
    checkpoint write of the 1024-particle SMC state. Returns the K1/K3/K4
    launches of the four runs."""
    import shutil

    import pioran_tpu_torch.inference as tinf
    from pioran_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint

    spec = flagship_f32(dev)
    total = {}
    for sampler, runner, kw in (("smc", "run_smc_resumable", SMC),
                                ("ns", "run_ns_resumable", RESUME_NS)):
        orig, raw, runs = getattr(tinf, runner), [], {}

        def keep_all(*a, _orig=orig, _raw=raw, **k):
            res = _orig(*a, max_to_keep=10_000, **k)
            _raw.append(res)
            return res

        root = os.path.join(out_dir, "resume", sampler)
        shutil.rmtree(root, ignore_errors=True)
        setattr(tinf, runner, keep_all)
        try:
            walls = []
            for name in ("full", "mid"):
                if name == "mid":
                    ckpts = os.path.join(root, "full", "checkpoints")
                    steps = sorted(int(n[5:]) for n in os.listdir(ckpts) if n.startswith("step_"))
                    mid = steps[len(steps) // 2]
                    os.makedirs(os.path.join(root, "mid", "checkpoints"))
                    shutil.copy(os.path.join(ckpts, f"step_{mid:08d}"),
                                os.path.join(root, "mid", "checkpoints"))
                zero_launch_counts()
                t0 = time.perf_counter()
                res = tinf.run_inference(spec, sampler=sampler, log_dir=os.path.join(root, name),
                                         resume=True, **kw)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                runs[name] = (res, raw.pop(), launch_counts())
                total = add_counts(total, runs[name][2])
        finally:
            setattr(tinf, runner, orig)
        (full, full_raw, l_full), (resumed, mid_raw, l_mid) = runs["full"], runs["mid"]
        if sampler == "smc":
            fields = ("particles", "logZ", "log_evidence_path", "lambdas", "acceptance")
            what = f"temper_steps={full_raw.num_steps} checkpoints={len(steps)}"
        else:
            fields = ("dead_u", "dead_logl", "dead_logw", "logZ", "insert_ranks")
            what = f"iterations={full_raw.num_iters} checkpoints={len(steps)}"
        diff = {f: float((getattr(mid_raw, f).double() - getattr(full_raw, f).double())
                         .nan_to_num(0.0, 0.0, 0.0).abs().max())
                for f in fields}
        equal = all(torch.equal(getattr(mid_raw, f), getattr(full_raw, f)) for f in fields)
        print(f"phase 20 resume {sampler}: {what} resumed_from_step={mid} "
              f"logz={full['logz']:.6f} resumed_logz={resumed['logz']:.6f} "
              f"bit_equal={equal} max_abs_diff={diff} wall_full_s={walls[0]:.2f} "
              f"wall_resumed_s={walls[1]:.2f} launches_full={l_full} launches_resumed={l_mid}")
        check(equal and resumed["logz"] == full["logz"]
              and np.array_equal(resumed["samples"], full["samples"]),
              f"phase 20: the resumed {sampler} run differs from the uninterrupted one: {diff}")
        check(l_mid["celerite_fwd"] > 0, f"the resumed {sampler} run launched no K1")
        if sampler == "smc":
            check(min(l_mid["celerite_fwd_aug"], l_mid["celerite_bwd"]) > 0,
                  "the resumed SMC run launched no K3/K4")
            # a checkpoint write of the 1024-particle state, from the card
            saved, _ = restore_checkpoint(ckpts)
            state = {"state": {k: v.to(dev) if isinstance(v, torch.Tensor) else v
                               for k, v in saved["state"].items()},
                     "generator": torch.Generator(device=dev).manual_seed(0)}
            tmp = os.path.join(root, "timing")
            ms = []
            for rep in range(5):
                t0 = time.perf_counter()
                path = save_checkpoint(tmp, state, rep)
                ms.append((time.perf_counter() - t0) * 1e3)
            print(f"phase 20 checkpoint write (SMC state, {SMC['num_particles']} particles, "
                  f"float32, on the card): ms={np.round(ms, 3).tolist()} "
                  f"median_ms={float(np.median(ms)):.3f} bytes={os.path.getsize(path)}")
    print("phase 20 resume: ok")
    return total


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def phase_multi_device(dev, out_dir):
    """Phase 21: the multi-device code on the card at world size 1. An
    in-process NCCL group of one rank and its CUDA mesh; sharded NS (256
    live points) and ChEES (64 chains, 100 + 100) through
    run_inference(mesh=) against their unsharded runs with the same seed
    (an all-reduce over one rank is the identity, so bit-equal); sharded
    SMC on the flagship (phase 14's particles and moves; random-walk
    moves, as the JAX package's sharded SMC) against phase 14's evidence
    gate; sharded NUTS (16 chains from prior draws, to the end of its
    first slow window) with finite draws and one pooled inverse mass.
    Each sharded path's K1 or K3/K4 launches are gated. Returns the
    launches of the sharded runs."""
    from datetime import timedelta

    import torch.distributed as dist

    import pioran_tpu_torch.inference as tinf
    from pioran_tpu_torch import parallel as par

    par.initialize_distributed(init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
                               rank=0, timeout=timedelta(seconds=120))
    total = {}
    try:
        check(dist.get_backend() == "nccl", f"backend {dist.get_backend()!r}, not nccl")
        mesh = par.make_mesh("chains", device_type="cuda")
        spec = flagship_f32(dev)

        # the collectives the sharded samplers make, by host clock: the
        # first one sets up the NCCL communicator
        x, g = torch.zeros(3, device=dev), torch.zeros(128, device=dev)
        outs = [torch.empty_like(g)]
        t0 = time.perf_counter()
        dist.all_reduce(x)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3

        def per_call_us(fn, n=500):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / n * 1e6

        print(f"phase 21 collectives (NCCL, one rank, host clock): first all_reduce "
              f"(communicator set-up) {first_ms:.1f} ms; all_reduce of 3 floats "
              f"{per_call_us(lambda: dist.all_reduce(x)):.1f} us; all_gather of 128 floats "
              f"{per_call_us(lambda: dist.all_gather(outs, g)):.1f} us a call")

        def run(label, fn, *a, **k):
            nonlocal total
            zero_launch_counts()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts()
            total = add_counts(total, launches) if label.startswith("sharded") else total
            return out, wall, launches

        for sampler, kw in (("ns", RESUME_NS), ("chees", MD_CHEES)):
            sh, w_sh, l_sh = run(f"sharded {sampler}", tinf.run_inference, spec,
                                 sampler=sampler, mesh=mesh, **kw)
            un, w_un, _ = run(sampler, tinf.run_inference, spec, sampler=sampler, **kw)
            equal = np.array_equal(sh["samples"], un["samples"])
            extra = (f"logz={sh['logz']:.6f} unsharded_logz={un['logz']:.6f}" if sampler == "ns"
                     else f"leapfrogs={sh['ncall'] // kw['num_chains']} "
                          f"unsharded_leapfrogs={un['ncall'] // kw['num_chains']}")
            print(f"phase 21 {sampler} on the mesh: {extra} samples_bit_equal={equal} "
                  f"mesh={sh['mesh']} wall_s={w_sh:.2f} unsharded_wall_s={w_un:.2f} "
                  f"launches={l_sh}")
            check(equal and sh.get("logz") == un.get("logz"),
                  f"phase 21: sharded {sampler} differs from the unsharded run")
            check(sh["mesh"]["n_devices_sharded"] == 1, f"mesh entry {sh['mesh']}")
            if sampler == "ns":
                width = kw["num_particles"] // 8  # n_delete: the width of every sweep
                check(l_sh["celerite_fwd"] >= sh["ncall"] / width,
                      f"sharded NS launches {l_sh} < sweeps")
            else:
                check(min(l_sh["celerite_fwd_aug"], l_sh["celerite_bwd"])
                      >= sh["ncall"] // kw["num_chains"], f"sharded ChEES launches {l_sh}")

        res, wall, l_smc = run("sharded smc", tinf.run_inference, spec, sampler="smc",
                               mesh=mesh, **SMC)
        print(f"phase 21 SMC on the mesh (random-walk moves): logz={res['logz']:.4f} "
              f"(gate {REF_LOGZ} +- {SMC_LOGZ_TOL}) temper_steps={res['num_temper_steps']} "
              f"wall_s={wall:.2f} launches={l_smc}")
        check(abs(res["logz"] - REF_LOGZ) <= SMC_LOGZ_TOL,
              f"sharded SMC logZ {res['logz']:.4f} outside {REF_LOGZ} +- {SMC_LOGZ_TOL}")
        check(l_smc["celerite_fwd"] >= res["num_temper_steps"] * SMC["num_moves"],
              f"sharded SMC launches {l_smc} < sweeps")

        prior = spec.prior
        gen = torch.Generator(device=dev).manual_seed(0)
        z0 = prior.to_unconstrained(prior.sample((MD_NUTS_CHAINS,), generator=gen,
                                                 dtype=spec.dtype, device=dev))
        (samples, stats), wall, l_nuts = run("sharded nuts", par.run_nuts_sharded,
                                             spec.logpost_batch, z0, gen, mesh, "chains",
                                             **MD_NUTS)
        inv_mass = stats["inv_mass"]
        leaves = int(stats["num_leaves"].sum() + stats["warmup_num_leaves"].sum())
        print(f"phase 21 NUTS on the mesh: chains={MD_NUTS_CHAINS} {MD_NUTS} leaves={leaves} "
              f"pooled_inv_mass={inv_mass[0].tolist()} wall_s={wall:.2f} launches={l_nuts}")
        check(bool(torch.isfinite(samples).all()) and samples.shape[:2]
              == (MD_NUTS_CHAINS, MD_NUTS["num_samples"]), "sharded NUTS draws")
        check(bool((inv_mass == inv_mass[0]).all()) and not bool((inv_mass == 1.0).all()),
              "sharded NUTS: the inverse mass is not one pooled estimate")
        check(min(l_nuts["celerite_fwd_aug"], l_nuts["celerite_bwd"]) >= leaves
              // MD_NUTS_CHAINS, f"sharded NUTS launches {l_nuts}")
    finally:
        dist.destroy_process_group()
    print("phase 21 multi-device (world size 1, NCCL): ok")
    return total


# ---------------------------------------------------------------------------
# phase 22: past 32 terms, the DRWCelerite flagship through the wide kernels
# ---------------------------------------------------------------------------

DRW = dict(basis_function="DRWCelerite")


def drw_spec(dev, dtype, n_components=20):
    """The flagship light curve under the DRWCelerite basis: two celerite
    terms a component, J = 2 n_components."""
    from pioran_tpu_torch import single_bending_model

    sub, xbar, va = load_subset()
    return single_bending_model(sub[:, 0], sub[:, 1], sub[:, 2], xbar, va, device=dev,
                                dtype=dtype, n_components=n_components, **DRW)


def wide_counts():
    """The wide kernels' launch counters, and the warp-per-chain ones'
    total (``narrow``)."""
    from pioran_tpu_torch.ops import cuda_celerite as cc, cuda_celerite_vjp as vjp

    return {"celerite_wide_fwd": cc.WIDE_LAUNCHES,
            "celerite_wide_fwd_multi": cc.WIDE_MULTI_LAUNCHES,
            "celerite_wide_tables": cc.WIDE_TABLES_LAUNCHES,
            "celerite_wide_fwd_aug": vjp.WIDE_FWD_AUG_LAUNCHES,
            "celerite_wide_bwd": vjp.WIDE_BWD_LAUNCHES,
            "celerite_wide_fwd_aug_multi": vjp.WIDE_FWD_AUG_MULTI_LAUNCHES,
            "celerite_wide_bwd_multi": vjp.WIDE_BWD_MULTI_LAUNCHES,
            "narrow": (cc.LAUNCHES + cc.MULTI_LAUNCHES + cc.TABLES_LAUNCHES + vjp.FWD_AUG_LAUNCHES
                       + vjp.BWD_LAUNCHES + vjp.FWD_AUG_MULTI_LAUNCHES + vjp.BWD_MULTI_LAUNCHES)}


def zero_wide_counts():
    from pioran_tpu_torch.ops import cuda_celerite as cc, cuda_celerite_vjp as vjp

    zero_launch_counts()
    cc.MULTI_LAUNCHES = 0
    vjp.FWD_AUG_MULTI_LAUNCHES = vjp.BWD_MULTI_LAUNCHES = 0
    cc.WIDE_LAUNCHES = cc.WIDE_MULTI_LAUNCHES = cc.WIDE_TABLES_LAUNCHES = 0
    vjp.WIDE_FWD_AUG_LAUNCHES = vjp.WIDE_BWD_LAUNCHES = 0
    vjp.WIDE_FWD_AUG_MULTI_LAUNCHES = vjp.WIDE_BWD_MULTI_LAUNCHES = 0


def drw_rows(spec, B, gen, nc):
    """DRWCelerite flagship inputs at B rows (J = 2 nc) from
    :func:`flagship_inputs`, lanes 0 and B - 1 not positive definite (the
    ragged batch's extra lane then adds nothing to t's cotangent)."""
    a, b, c, d, y, s2 = flagship_inputs(spec, B, gen, n_components=nc, **DRW)
    a[B - 1] = -50.0 * a[B - 1]
    return a, b, c, d, y, s2


def wide_gates(tag, ks, qs, ps, names):
    """Float64 kernel outputs ``ks[f64]`` within 1e-9 relative of the
    plain float64 ones ``ps`` (per row: ll relative to |ll|, tables and
    cotangents 2-norm relative); float32 ``ks[f32]`` against ``ps`` within
    PERF.md's gate on the plain float32 loop's own error ``qs`` (median and
    90th percentile of the rows within 3x; one-row outputs, t's summed
    cotangent, within 3x or 1e-5). Returns (the f64 worst error, the f32
    worst ratios (median, 90th percentile), the f32 max abs difference
    from the plain float32 outputs)."""
    err = lambda x, r: (x.double() - r.double()).abs()[:, 0] / r.double().abs()[:, 0] \
        if x.shape[1:] == (1,) and x.shape[0] > 1 else chain_err(x, r)  # noqa: E731
    worst64, ratios, max_abs = 0.0, [0.0, 0.0], 0.0
    for name, k64, k32, q, r in zip(names, ks[torch.float64], ks[torch.float32], qs, ps):
        e64 = float(err(k64, r).max())
        check(e64 <= 1e-9, f"{tag} f64 {name}: rel err {e64:.3e} > 1e-9")
        worst64 = max(worst64, e64)
        e_k, e_q = err(k32, r), err(q, r)
        if e_k.numel() > 1:
            ratios = [max(u, v) for u, v in zip(ratios, f32_spread(tag, name, e_k, e_q)[:2])]
        else:
            check(float(e_k) <= max(3.0 * float(e_q), 1e-5),
                  f"{tag} f32 {name}: kernel rel err {float(e_k):.3e} > 3 x the f32 plain "
                  f"loop's {float(e_q):.3e}")
        max_abs = max(max_abs, float((k32.double() - q.double()).abs().max()))
    return worst64, ratios, max_abs


def wide_place(shape) -> str:
    """Where a wide launch shape keeps the state and K4's T slots."""
    if shape.cpt <= 64:
        return (f"registers (2 threads a row, {shape.cpt} columns a thread), K4 T slots in smem "
                f"ks={shape.ks}")
    where = lambda x: "scratch" if x else "smem"  # noqa: E731
    return (f"past the registers (2 threads a row, cw={shape.cpt}), forward tail in "
            f"{where(shape.fwd_scratch)}, K4 G tail in {where(shape.carry_scratch)}, "
            f"slots in {where(shape.chunk_scratch)} ks={shape.ks}")


def hold_wide(spec64, nc, gen, dt, nv=None, model=None, batches=WIDE_BATCHES):
    """The wide K1 (K2 on ragged grids) and K3/K4 against their plain
    versions on the DRWCelerite flagship's coefficients at nc components,
    at each batch of ``batches`` (rows 0 to B - 1 of the largest, B;
    lanes 0 and B - 1 of that not positive definite): the plain loops run
    once at B in each dtype. Shared grid: the subset's t and host
    spacings ``dt``; ragged: ``model``'s padded grids. Returns {kernel:
    (f64 worst, f32 ratios, f32 max abs)}."""
    from pioran_tpu_torch.ops import cuda_celerite as cc
    from pioran_tpu_torch.ops import cuda_celerite_vjp as vjp
    from pioran_tpu_torch.ops.cuda_celerite_vjp import bwd, bwd_plain, fwd_aug, fwd_aug_plain

    dev, B = spec64.device, max(batches)
    if model is None:
        a, b, c, d, y, s2 = drw_rows(spec64, B, gen, nc)
        t = torch.as_tensor(spec64.t, dtype=torch.float64, device=dev)
        kw = dict(dt=dt)
    else:
        a, b, c, d, t, y, s2, nv, dt = multi_inputs(spec64, model, B, gen, n_components=nc, **DRW)
        a[B - 1] = -50.0 * a[B - 1]
        s2 = torch.where(vjp.live_steps(nv, t.shape[1]), s2, torch.ones_like(s2))
        kw = dict(dt=dt, n_valid=nv)
    args = {torch.float64: (a, b, c, d, t, y, s2)}
    args[torch.float32] = tuple(x.float() for x in args[torch.float64])
    def k1(xs, kwk):  # K1, or K2 on ragged grids
        if nv is None:
            return cc.batched_loglike(*xs, kwk["dt"])
        return cc.batched_loglike_multi(*xs, kwk["n_valid"], kwk["dt"])

    plain = {dtype: cc.batched_loglike_plain(*x, dt) if nv is None
             else cc.batched_loglike_multi_plain(*x, nv, dt) for dtype, x in args.items()}
    ll_p, res_p = fwd_aug_plain(*args[torch.float64], **kw)
    fin = torch.isfinite(ll_p)
    check(bool(~fin[0]) and bool(~fin[B - 1]) and int(fin.sum()) > B // 2,
          f"J={2 * nc}: -inf lanes of the plain loop {int((~fin).sum())}")
    g = torch.where(fin, torch.linspace(0.5, 1.5, B, dtype=torch.float64, device=dev), 0.0)
    ref = adjoint_rows(fin, ll_p, res_p, bwd_plain(*args[torch.float64], res_p, g, **kw))
    ll_q, res_q = fwd_aug_plain(*args[torch.float32], **kw)
    own = adjoint_rows(fin, ll_q, res_q, bwd_plain(*args[torch.float32], res_q, g.float(), **kw))
    out = {}
    for Bk in batches:
        f = fin[:Bk]
        ks1, ks, live = {}, {}, None if nv is None else vjp.live_steps(nv[:Bk], t.shape[-1])
        kwk = dict(kw, n_valid=nv[:Bk]) if nv is not None else kw
        if nv is not None:
            kwk["dt"] = dt[:Bk]
        for dtype, xs in args.items():
            xs = tuple(x[:Bk] if x.dim() == 2 else x for x in xs)
            v = k1(xs, kwk)
            ll, res = fwd_aug(*xs, **kwk)
            grads = bwd(*xs, res, g[:Bk].to(dtype), **kwk)
            torch.cuda.synchronize()
            tag = f"J={2 * nc} B={Bk} {str(dtype)[6:]}{' per-lane' if nv is not None else ''}"
            for name, val in (("K1/K2", v), ("K3", ll)):
                check(torch.equal(torch.isfinite(val), f), f"{tag} {name}: -inf lanes differ")
            check(all(x.dim() == 1 or bool((x[0] == 0).all()) for x in grads),
                  f"{tag}: non-PD lane's gradient")
            if live is not None:
                check(all(bool((x[~live] == 0).all()) for x in grads[4:]),
                      f"{tag}: t/y/sigma2 cotangents not zero past n_valid")
            ks1[dtype] = [v[f][:, None]]
            ks[dtype] = adjoint_rows(f, ll, res, grads)
        # lane B - 1 is -inf: the first B - 1 rows have the same finite
        # chains, and t's summed cotangent the same terms, as all B
        tag = f"J={2 * nc} B={Bk}"
        p1 = [plain[torch.float64][:Bk][f][:, None]]
        q1 = [plain[torch.float32][:Bk][f][:, None]]
        out.setdefault("K1", []).append(wide_gates(tag + " K1", ks1, q1, p1, ("ll",)))
        out.setdefault("K3", []).append(wide_gates(tag + " K3", {k: v[:8] for k, v in ks.items()},
                                                   own[:8], ref[:8], ADJ_NAMES[:8]))
        out.setdefault("K4", []).append(wide_gates(tag + " K4", {k: v[8:] for k, v in ks.items()},
                                                   own[8:], ref[8:], ADJ_NAMES[8:]))
    return {k: (max(x[0] for x in v), [max(x[1][i] for x in v) for i in range(2)],
                max(x[2] for x in v)) for k, v in out.items()}


def hold_wide_tables(spec64, nc, gen):
    """The wide K0 against its plain version at B = 65 and its first 64
    rows, on the DRWCelerite flagship's tables at nc components. Returns
    (f64 worst, f32 ratios, f32 max abs)."""
    from pioran_tpu_torch.ops.cuda_celerite import (
        build_tables, loglike_from_tables, loglike_from_tables_plain)

    B = max(WIDE_BATCHES)
    a, b, c, d, y, s2 = drw_rows(spec64, B, gen, nc)
    t = torch.as_tensor(spec64.t, dtype=torch.float64, device=spec64.device)
    res = []
    tabs = {}
    for dtype in (torch.float64, torch.float32):
        xs = [x.to(dtype) for x in (a, b, c, d, t, y, s2)]
        tabs[dtype] = (*build_tables(*xs[:5]), *xs[5:], xs[0].sum(1))
    plain = {k: loglike_from_tables_plain(*v) for k, v in tabs.items()}
    fin = torch.isfinite(plain[torch.float64])
    for Bk in WIDE_BATCHES:
        ks = {}
        for dtype, (U, V, phi, yy, ss, suma) in tabs.items():
            k = loglike_from_tables(U[..., :Bk], V[..., :Bk], phi[..., :Bk], yy[:Bk], ss[:Bk],
                                    suma[:Bk])
            torch.cuda.synchronize()
            check(torch.equal(torch.isfinite(k), fin[:Bk]), f"K0 J={2 * nc} B={Bk}: -inf lanes")
            ks[dtype] = [k[fin[:Bk]][:, None]]
        f = fin[:Bk]
        res.append(wide_gates(f"K0 J={2 * nc} B={Bk}", ks, [plain[torch.float32][:Bk][f][:, None]],
                              [plain[torch.float64][:Bk][f][:, None]], ("ll",)))
    return max(x[0] for x in res), [max(x[1][i] for x in res) for i in range(2)], \
        max(x[2] for x in res)


def phase_wide_times(dev, datasets):
    """Phase 22a, before the ChEES child (the card alone): each wide
    kernel's CUDA-event time at J = 40 and 64 on DRWCelerite flagship
    inputs (float32, N = 485) beside its bound; the plain versions' times
    at J = 40 at the same shapes; past the registers (J = 100, 128) K1,
    K3, K4, the per-lane K2, K3, K4 and (J = 100) K0, each with its plain
    version; the float64 value at the referee mean through the wide K1.
    Returns {kernel row: (ms, plain ms, (bytes, ops))}, J = 40 unless the
    row names its J."""
    import pioran_tpu_torch.inference as tinf
    from pioran_tpu_torch.ops import cuda_celerite as cc
    from pioran_tpu_torch.ops.cuda_celerite import (
        build_tables, loglike_from_tables, loglike_from_tables_plain)
    from pioran_tpu_torch.ops.cuda_celerite_vjp import (
        KC, bwd, bwd_plain, fwd_aug, fwd_aug_plain, live_steps)

    gen = torch.Generator(device=dev).manual_seed(22)
    spec32 = drw_spec(dev, torch.float32)
    N = len(spec32.t)
    t = torch.as_tensor(spec32.t, dtype=torch.float32, device=dev)
    dt = torch.as_tensor(np.diff(spec32.t.astype(np.float64)), device=dev)
    model = tinf._many_model(datasets, device=dev, dtype=torch.float32)
    rows, lines = {}, []

    def put(name, J, B, ms, cost, plain=None):
        bms, by = bound(*cost)
        lines.append(f"{name} J={J} B={B}: ms={ms:.4f} us_per_step={ms * 1e3 / N:.3f} "
                     f"bound_ms={bms:.5f} ({by}) x_bound={ms / bms:.1f}"
                     + (f" plain_ms={plain:.1f}" if plain is not None else ""))
        if J == 40 and (name not in rows or plain is not None):
            rows[name] = (ms, plain, cost)

    for nc in WIDE_TIMED_NC:
        J = 2 * nc
        basis = dict(n_components=nc, **DRW)
        for B in (128, 4096):
            a, b, c, d, y, s2 = flagship_inputs(spec32, B, gen, **basis)
            xs = (a, b, c, d, t, y, s2, dt)
            ms = cuda_ms(lambda: cc.batched_loglike(*xs), 10)  # noqa: B023
            plain = (cuda_ms(lambda: cc.batched_loglike_plain(*xs), 1)  # noqa: B023
                     if J == 40 and B == 128 else None)
            put("celerite_wide_fwd", J, B, ms, k1_cost(B, J, N), plain)
            if B == 4096:
                U, V, phi = build_tables(a, b, c, d, t)
                tabs = (U, V, phi, y, s2, a.sum(1))
                ms = cuda_ms(lambda: loglike_from_tables(*tabs), 5)  # noqa: B023
                plain = (cuda_ms(lambda: loglike_from_tables_plain(*tabs), 1)  # noqa: B023
                         if J == 40 else None)
                put("celerite_wide_tables", J, B, ms, tables_cost(B, J, N), plain)
                del U, V, phi, tabs
        for B in (512, 1024):
            a, b, c, d, y, s2 = flagship_inputs(spec32, B, gen, **basis)
            args = (a, b, c, d, t, y, s2)
            ll, res = fwd_aug(*args, dt=dt)
            g = torch.isfinite(ll).float()
            k3 = cuda_ms(lambda: fwd_aug(*args, dt=dt), 5)  # noqa: B023
            k4 = cuda_ms(lambda: bwd(*args, res, g, dt=dt), 3)  # noqa: B023
            first = J == 40 and B == 512
            p3 = cuda_ms(lambda: fwd_aug_plain(*args, dt=dt), 1) if first else None  # noqa: B023
            p4 = (cuda_ms(lambda: bwd_plain(*args, res, g, dt=dt), 1)  # noqa: B023
                  if first else None)
            c3, c4 = adjoint_cost(B, J, N, KC, 4, int(g.sum()))
            put("celerite_wide_fwd_aug", J, B, k3, c3, p3)
            put("celerite_wide_bwd", J, B, k4, c4, p4)
        B = MULTI_BATCHES[0]
        a, b, c, d, T, y, s2, nv, DT = multi_inputs(spec32, model, B, gen, **basis)
        s2 = torch.where(live_steps(nv, T.shape[1]), s2, torch.ones_like(s2))
        args = (a, b, c, d, T, y, s2)
        ll, res = fwd_aug(*args, dt=DT, n_valid=nv)
        g = torch.isfinite(ll).float()
        k2 = cuda_ms(lambda: cc._launch(*args, DT, nv), 10)  # noqa: B023
        k3 = cuda_ms(lambda: fwd_aug(*args, dt=DT, n_valid=nv), 5)  # noqa: B023
        k4 = cuda_ms(lambda: bwd(*args, res, g, dt=DT, n_valid=nv), 3)  # noqa: B023
        p2 = p3 = p4 = None
        if J == 40:
            p2 = cuda_ms(lambda: cc.batched_loglike_multi_plain(*args, nv, DT), 1)  # noqa: B023
            p3 = cuda_ms(lambda: fwd_aug_plain(*args, dt=DT, n_valid=nv), 1)  # noqa: B023
            p4 = cuda_ms(lambda: bwd_plain(*args, res, g, dt=DT, n_valid=nv), 1)  # noqa: B023
        nvn = nv.cpu().numpy()
        c2, c3, c4 = multi_costs(B, J, T.shape[1], KC, 4, nvn, g.bool().cpu().numpy())
        put("celerite_wide_fwd_multi", J, B, k2, c2, p2)
        put("celerite_wide_fwd_aug_multi", J, B, k3, c3, p3)
        put("celerite_wide_bwd_multi", J, B, k4, c4, p4)
    # past the registers: K1 at B = 128, K3 and K4 at B = 512, with their
    # plain versions at the same shapes, the kernel line's rows
    for nc in WIDE_PAST_NC:
        J = 2 * nc
        basis = dict(n_components=nc, **DRW)
        a, b, c, d, y, s2 = flagship_inputs(spec32, 128, gen, **basis)
        xs = (a, b, c, d, t, y, s2, dt)
        ms = cuda_ms(lambda: cc.batched_loglike(*xs), 10)  # noqa: B023
        plain = cuda_ms(lambda: cc.batched_loglike_plain(*xs), 1)  # noqa: B023
        put("celerite_wide_fwd", J, 128, ms, k1_cost(128, J, N), plain)
        rows[f"celerite_wide_fwd_j{J}"] = (ms, plain, k1_cost(128, J, N))
        a, b, c, d, y, s2 = flagship_inputs(spec32, 512, gen, **basis)
        args = (a, b, c, d, t, y, s2)
        ll, res = fwd_aug(*args, dt=dt)
        g = torch.isfinite(ll).float()
        k3 = cuda_ms(lambda: fwd_aug(*args, dt=dt), 5)  # noqa: B023
        k4 = cuda_ms(lambda: bwd(*args, res, g, dt=dt), 3)  # noqa: B023
        p3 = cuda_ms(lambda: fwd_aug_plain(*args, dt=dt), 1)  # noqa: B023
        p4 = cuda_ms(lambda: bwd_plain(*args, res, g, dt=dt), 1)  # noqa: B023
        c3, c4 = adjoint_cost(512, J, N, KC, 4, int(g.sum()))
        put("celerite_wide_fwd_aug", J, 512, k3, c3, p3)
        put("celerite_wide_bwd", J, 512, k4, c4, p4)
        rows[f"celerite_wide_fwd_aug_j{J}"] = (k3, p3, c3)
        rows[f"celerite_wide_bwd_j{J}"] = (k4, p4, c4)
        del res
        # the per-lane K2, K3 and K4 at the run_inference_many batch, and
        # K0 at J = 100 on B = 1024 flagship tables, with their plain
        # versions at the same shapes
        B = MULTI_BATCHES[0]
        a, b, c, d, T, y, s2, nv, DT = multi_inputs(spec32, model, B, gen, **basis)
        s2 = torch.where(live_steps(nv, T.shape[1]), s2, torch.ones_like(s2))
        args = (a, b, c, d, T, y, s2)
        ll, res = fwd_aug(*args, dt=DT, n_valid=nv)
        g = torch.isfinite(ll).float()
        k2 = cuda_ms(lambda: cc._launch(*args, DT, nv), 10)  # noqa: B023
        k3 = cuda_ms(lambda: fwd_aug(*args, dt=DT, n_valid=nv), 5)  # noqa: B023
        k4 = cuda_ms(lambda: bwd(*args, res, g, dt=DT, n_valid=nv), 3)  # noqa: B023
        # each plain loop warmed once at this width, so that its time holds
        # no first allocation of its checkpoints
        p2 = cuda_ms(lambda: cc.batched_loglike_multi_plain(*args, nv, DT), 1)  # noqa: B023
        p3 = cuda_ms(lambda: fwd_aug_plain(*args, dt=DT, n_valid=nv), 1)  # noqa: B023
        p4 = cuda_ms(lambda: bwd_plain(*args, res, g, dt=DT, n_valid=nv), 1)  # noqa: B023
        costs = multi_costs(B, J, T.shape[1], KC, 4, nv.cpu().numpy(), g.bool().cpu().numpy())
        for name, ms, plain, cost in zip(("fwd", "fwd_aug", "bwd"), (k2, k3, k4), (p2, p3, p4),
                                         costs):
            put(f"celerite_wide_{name}_multi", J, B, ms, cost, plain)
            rows[f"celerite_wide_{name}_multi_j{J}"] = (ms, plain, cost)
        del res
        if J == 100:
            a, b, c, d, y, s2 = flagship_inputs(spec32, B, gen, **basis)
            U, V, phi = build_tables(a, b, c, d, t)
            tabs = (U, V, phi, y, s2, a.sum(1))
            ms = cuda_ms(lambda: loglike_from_tables(*tabs), 5)  # noqa: B023
            plain = cuda_ms(lambda: loglike_from_tables_plain(*tabs), 1)  # noqa: B023
            put("celerite_wide_tables", J, B, ms, tables_cost(B, J, N), plain)
            rows["celerite_wide_tables_j100"] = (ms, plain, tables_cost(B, J, N))
            del U, V, phi, tabs
    for ln in lines:
        print(f"phase 22a times f32 N={N}: {ln}")

    # the float64 value at the referee mean through the wide K1
    spec64 = drw_spec(dev, torch.float64)
    before = wide_counts()
    ll = float(spec64.loglike_batch(torch.tensor([referee()["is_mean"]], dtype=torch.float64,
                                                 device=dev))[0])
    after = wide_counts()
    rel = abs(ll / DRW_LL64 - 1.0)
    print(f"phase 22a DRWCelerite f64 loglike at the referee mean (J=40): {ll!r} "
          f"(JAX package {DRW_LL64!r}, rel {rel:.2e}, gate 1e-9)")
    check(rel <= 1e-9, f"DRWCelerite f64 value {ll!r} off {DRW_LL64!r} by {rel:.2e}")
    check(after["celerite_wide_fwd"] == before["celerite_wide_fwd"] + 1
          and after["narrow"] == before["narrow"], "the value did not run the wide K1 alone")
    return rows


def phase_wide_smc(dev, out_dir):
    """Phase 22b, before the ChEES child: tempered SMC on the DRWCelerite
    flagship (J = 40) with phase 14's settings, through the wide K1 and
    K3/K4 alone. Returns its launches."""
    import pioran_tpu_torch.inference as tinf

    spec = drw_spec(dev, torch.float32)
    log_dir = os.path.join(out_dir, "smc_drw")
    zero_wide_counts()
    t0 = time.perf_counter()
    res = tinf.run_inference(spec, sampler="smc", log_dir=log_dir, **SMC)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = wide_counts()
    steps = res["num_temper_steps"]
    ref = referee()
    mean, sd = np.asarray(res["posterior"]["mean"]), np.asarray(res["posterior"]["stdev"])
    pulls = (mean - np.asarray(ref["is_mean"])) / np.asarray(ref["is_std"])
    width = sd / np.asarray(ref["is_std"])
    print(f"phase 22b SMC DRWCelerite (J=40): particles={SMC['num_particles']} "
          f"moves={SMC['num_moves']} (mala) logz={res['logz']:.4f} (gate {REF_LOGZ} +- "
          f"{DRW_LOGZ_TOL}) temper_steps={steps} ncall={res['ncall']} wall_s={wall:.2f} "
          f"ms_per_temper_step={wall / max(steps, 1) * 1e3:.1f} launches={counts}")
    print(f"phase 22b SMC DRWCelerite pulls vs referee: {np.round(pulls, 4).tolist()} "
          f"width ratios: {np.round(width, 4).tolist()}")
    check(abs(res["logz"] - REF_LOGZ) <= DRW_LOGZ_TOL,
          f"DRWCelerite SMC logZ {res['logz']:.4f} outside {REF_LOGZ} +- {DRW_LOGZ_TOL}")
    check(bool(np.all(np.abs(pulls) <= 0.5)), f"DRWCelerite SMC pull > 0.5 sd: {pulls}")
    check(bool(np.all((width >= 0.75) & (width <= 1.33))),
          f"DRWCelerite SMC width ratio outside [0.75, 1.33]: {width}")
    check(res["ncall"] == steps * SMC["num_moves"] * SMC["num_particles"], "SMC ncall formula")
    check(counts["celerite_wide_fwd"] >= steps * SMC["num_moves"],
          f"wide K1 launches {counts['celerite_wide_fwd']} < {steps * SMC['num_moves']} moves")
    check(min(counts["celerite_wide_fwd_aug"], counts["celerite_wide_bwd"])
          >= steps * (SMC["num_moves"] + 1), f"wide K3/K4 launches {counts} < gradients")
    check(counts["narrow"] == 0, f"the J = 40 fit launched a warp-per-chain kernel: {counts}")
    for rel in (("chains", "equal_weighted_post.txt"), ("info", "results.json")):
        check(os.path.isfile(os.path.join(log_dir, *rel)), f"{rel} not written")
    print("phase 22b SMC DRWCelerite: ok")
    return {k: v for k, v in counts.items() if k != "narrow"}


def phase_wide(dev, datasets):
    """Phase 22, beside the ChEES child: every wide kernel against its
    plain version on the DRWCelerite flagship's coefficients at 20, 35, 50
    and 64 components (J = 40, 70, 100, 128 at B = 65 and 64, and J = 40 at the
    SMC fit's 1024 particles; the per-lane forms at J = 40, 100 and 128 on
    phase 10's ragged datasets; K0 at J = 40, 100 and 128), then the paths
    of the entry points that have no sampler here: no-gradient sweeps of
    the DRWCelerite many-model (the wide K2), its value and gradient (the
    wide per-lane K3/K4) and flagship sweeps of batched_loglike_tables
    (the wide K0), (22c) the DRWCelerite flagship builder at 50 and 64
    components (J = 100, 128: the forms past the registers) and (22d) the
    same many-model and table paths at 50 and 64 components. Returns
    ({kernel: f32 max abs err}, those paths' launches)."""
    import pioran_tpu_torch.inference as tinf
    from pioran_tpu_torch.ops.cuda_celerite import batched_loglike_tables
    from pioran_tpu_torch.ops.cuda_celerite_vjp import KC, wide_shape
    from pioran_tpu_torch.samplers.chees import batch_value_and_grad

    gen = torch.Generator(device=dev).manual_seed(23)
    spec64 = drw_spec(dev, torch.float64)
    dt64 = torch.as_tensor(np.diff(spec64.t.astype(np.float64)), device=dev)
    max_abs, summary = {}, []
    # every width at B = 65 and 64; J = 40 also at the SMC fit's batch
    B_fit = SMC["num_particles"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for nc, batches in [(nc, WIDE_BATCHES) for nc in WIDE_NC] + [(WIDE_NC[0], (B_fit,))]:
        got = hold_wide(spec64, nc, gen, dt64, batches=batches)
        where = []
        for dtype in (torch.float64, torch.float32):
            where.append(f"{str(dtype)[6:]} " + wide_place(
                wide_shape(2 * nc, dtype, max(batches), KC, sms)))
        summary.append(f"J={2 * nc} B={batches} ({'; '.join(where)}): " + " ".join(
            f"{k} f64 {v[0]:.2e} f32 ratios {v[1][0]:.2f}/{v[1][1]:.2f}" for k, v in got.items()))
        for k, name in (("K1", "celerite_wide_fwd"), ("K3", "celerite_wide_fwd_aug"),
                        ("K4", "celerite_wide_bwd")):
            if nc in WIDE_PAST_NC:
                name = f"{name}_j{2 * nc}"
            max_abs[name] = max(max_abs.get(name, 0.0), got[k][2])
    model64 = tinf._many_model(datasets, device=dev, dtype=torch.float64)
    for nc in (WIDE_NC[0],) + WIDE_PAST_NC:
        got = hold_wide(spec64, nc, gen, None, model=model64)
        summary.append(f"per-lane J={2 * nc}: " + " ".join(
            f"{k} f64 {v[0]:.2e} f32 ratios {v[1][0]:.2f}/{v[1][1]:.2f}" for k, v in got.items()))
        for k, name in (("K1", "celerite_wide_fwd_multi"), ("K3", "celerite_wide_fwd_aug_multi"),
                        ("K4", "celerite_wide_bwd_multi")):
            max_abs[name + (f"_j{2 * nc}" if nc in WIDE_PAST_NC else "")] = got[k][2]
    # K0 at J = 40 and 100, each its row's error, and at J = 128
    tables_rows = {WIDE_NC[0]: "celerite_wide_tables", WIDE_PAST_NC[0]: "celerite_wide_tables_j100"}
    for nc in (WIDE_NC[0], WIDE_PAST_NC[0], WIDE_NC[-1]):
        w64, ratios, mx = hold_wide_tables(spec64, nc, gen)
        summary.append(f"K0 J={2 * nc}: f64 {w64:.2e} f32 ratios {ratios[0]:.2f}/{ratios[1]:.2f} "
                       f"f32 max abs {mx:.3e}")
        if nc in tables_rows:
            max_abs[tables_rows[nc]] = mx
    print(f"phase 22 wide kernels vs plain: ok N={len(spec64.t)} lanes 0 and B - 1 of the "
          f"largest batch non-PD (-inf, zero gradient); f64 gate 1e-9 relative, f32 gate 3x the plain loop's "
          f"own error at the rows' median and 90th percentile | " + " | ".join(summary))

    # the entry points' paths: counters zeroed, the path, counters read
    launches = {}
    model = tinf._many_model(datasets, device=dev, dtype=torch.float32, n_components=20, **DRW)
    B = MANY_D * MANY["num_chains"]
    TH = model.prior.sample((PATH_A_SWEEPS, B), generator=gen, dtype=torch.float32, device=dev)
    zero_wide_counts()
    with torch.no_grad():
        fin = [torch.isfinite(model.loglike_batch(x)).float().mean() for x in TH]
    torch.cuda.synchronize()
    c = wide_counts()
    check(c["celerite_wide_fwd_multi"] == PATH_A_SWEEPS and c["narrow"] == 0,
          f"DRWCelerite many-model sweeps: launches {c}")
    launches["celerite_wide_fwd_multi"] = c["celerite_wide_fwd_multi"]
    Z = many_rows(model, drw_spec(dev, torch.float32), B, gen)
    zero_wide_counts()
    lp, grad = batch_value_and_grad(model.logpost_batch, Z)
    lp2, _ = batch_value_and_grad(model.logpost_batch, Z + 0.01)
    torch.cuda.synchronize()
    c = wide_counts()
    check(c["celerite_wide_fwd_aug_multi"] == 2 and c["celerite_wide_bwd_multi"] == 2
          and c["narrow"] == 0, f"DRWCelerite many-model value and gradient: launches {c}")
    check(bool(torch.isfinite(grad[torch.isfinite(lp)]).all()) and bool(torch.isfinite(lp).any()),
          "DRWCelerite many-model gradient not finite")
    launches["celerite_wide_fwd_aug_multi"] = c["celerite_wide_fwd_aug_multi"]
    launches["celerite_wide_bwd_multi"] = c["celerite_wide_bwd_multi"]
    spec32 = drw_spec(dev, torch.float32)
    t = torch.as_tensor(spec32.t, dtype=torch.float32, device=dev)
    inputs = [flagship_inputs(spec32, TABLES_BATCHES[1], gen, n_components=20, **DRW)
              for _ in range(TABLES_SWEEPS)]
    zero_wide_counts()
    lls = [batched_loglike_tables(a, b, cc_, d, t, y, s2) for a, b, cc_, d, y, s2 in inputs]
    torch.cuda.synchronize()
    c = wide_counts()
    check(c["celerite_wide_tables"] == TABLES_SWEEPS and c["narrow"] == 0,
          f"DRWCelerite batched_loglike_tables sweeps: launches {c}")
    share = float(torch.stack([torch.isfinite(x).float().mean() for x in lls]).mean())
    check(share > 0.9, f"DRWCelerite table sweeps: finite share {share:.3f}")
    launches["celerite_wide_tables"] = c["celerite_wide_tables"]
    # 22c, past the registers: the DRWCelerite flagship at 50 and 64
    # components through the builder's entry points, two no-gradient
    # sweeps at B = 1024 and a value and gradient at B = 512
    past = []
    for nc in WIDE_PAST_NC:
        J = 2 * nc
        spec = drw_spec(dev, torch.float32, nc)
        TH = referee_thetas(spec, 1024, gen)
        Z = spec.prior.to_unconstrained(TH[:512])
        zero_wide_counts()
        with torch.no_grad():
            lls = [spec.loglike_batch(TH), spec.loglike_batch(TH.flip(0))]
        lp, grad = batch_value_and_grad(spec.logpost_batch, Z)
        torch.cuda.synchronize()
        c = wide_counts()
        check(c["celerite_wide_fwd"] == 2 and c["celerite_wide_fwd_aug"] == 1
              and c["celerite_wide_bwd"] == 1 and c["narrow"] == 0,
              f"DRWCelerite J={J} paths: launches {c}")
        share_j = float(torch.stack([torch.isfinite(x).float().mean() for x in lls]).mean())
        check(share_j > 0.9 and bool(torch.isfinite(grad[torch.isfinite(lp)]).all())
              and bool(torch.isfinite(lp).any()), f"DRWCelerite J={J}: finite share {share_j:.3f}")
        for k in ("fwd", "fwd_aug", "bwd"):
            launches[f"celerite_wide_{k}_j{J}"] = c[f"celerite_wide_{k}"]
        past.append(f"J={J} finite share {share_j:.4f} logpost max {float(lp.max()):.3f}")
    print(f"phase 22c past the registers: DRWCelerite flagship builders, 2 sweeps at B=1024 and "
          f"a value+gradient at B=512 each: " + "; ".join(past))
    launches.update(phase_wide_past_paths(dev, datasets, gen))
    print(f"phase 22 paths: DRWCelerite many-model ({MANY_D} datasets x {MANY['num_chains']} "
          f"chains) {PATH_A_SWEEPS} no-gradient sweeps (finite share "
          f"{float(torch.stack(fin).mean()):.3f}) and two value+gradient evaluations, "
          f"{TABLES_SWEEPS} batched_loglike_tables sweeps at B={TABLES_BATCHES[1]} (finite share "
          f"{share:.4f}); wide launches {launches}")
    print("phase 22 J > 32: ok")
    return max_abs, launches


def phase_wide_past_paths(dev, datasets, gen):
    """Phase 22d, past the registers on ragged grids and tables, through
    the entry points: the DRWCelerite many-model at 50 and 64 components
    (J = 100, 128), PAST_SWEEPS no-gradient sweeps (the per-lane K2) and a
    value and gradient (the per-lane K3/K4) each, then PAST_SWEEPS flagship
    sweeps of batched_loglike_tables at 50 components (K0 at J = 100).
    Returns those paths' launches."""
    import pioran_tpu_torch.inference as tinf
    from pioran_tpu_torch.ops.cuda_celerite import batched_loglike_tables
    from pioran_tpu_torch.samplers.chees import batch_value_and_grad

    B = MANY_D * MANY["num_chains"]
    launches, past = {}, []
    for nc in WIDE_PAST_NC:
        J = 2 * nc
        model = tinf._many_model(datasets, device=dev, dtype=torch.float32, n_components=nc,
                                 **DRW)
        TH = model.prior.sample((PAST_SWEEPS, B), generator=gen, dtype=torch.float32, device=dev)
        Z = many_rows(model, drw_spec(dev, torch.float32, nc), B, gen)
        zero_wide_counts()
        with torch.no_grad():
            fin_j = [torch.isfinite(model.loglike_batch(x)).float().mean() for x in TH]
        lp, grad = batch_value_and_grad(model.logpost_batch, Z)
        torch.cuda.synchronize()
        c = wide_counts()
        check(c["celerite_wide_fwd_multi"] == PAST_SWEEPS and c["celerite_wide_fwd_aug_multi"] == 1
              and c["celerite_wide_bwd_multi"] == 1 and c["narrow"] == 0,
              f"DRWCelerite many-model J={J}: launches {c}")
        check(bool(torch.isfinite(grad[torch.isfinite(lp)]).all())
              and bool(torch.isfinite(lp).any()), f"DRWCelerite many-model J={J}: gradient")
        for k in ("fwd", "fwd_aug", "bwd"):
            launches[f"celerite_wide_{k}_multi_j{J}"] = c[f"celerite_wide_{k}_multi"]
        past.append(f"many-model J={J} sweeps' finite share "
                    f"{float(torch.stack(fin_j).mean()):.4f} logpost max {float(lp.max()):.3f}")
    spec = drw_spec(dev, torch.float32, WIDE_PAST_NC[0])
    t = torch.as_tensor(spec.t, dtype=torch.float32, device=dev)
    inputs = [flagship_inputs(spec, TABLES_BATCHES[1], gen, n_components=WIDE_PAST_NC[0], **DRW)
              for _ in range(PAST_SWEEPS)]
    zero_wide_counts()
    lls = [batched_loglike_tables(a, b, cc_, d, t, y, s2) for a, b, cc_, d, y, s2 in inputs]
    torch.cuda.synchronize()
    c = wide_counts()
    check(c["celerite_wide_tables"] == PAST_SWEEPS and c["narrow"] == 0,
          f"DRWCelerite batched_loglike_tables J={2 * WIDE_PAST_NC[0]}: launches {c}")
    share_t = float(torch.stack([torch.isfinite(x).float().mean() for x in lls]).mean())
    check(share_t > 0.9, f"DRWCelerite table sweeps J={2 * WIDE_PAST_NC[0]}: finite share "
          f"{share_t:.3f}")
    launches["celerite_wide_tables_j100"] = c["celerite_wide_tables"]
    del inputs, lls
    past.append(f"batched_loglike_tables J={2 * WIDE_PAST_NC[0]} B={TABLES_BATCHES[1]} finite "
                f"share {share_t:.4f}")
    print(f"phase 22d past the registers, ragged grids and tables ({MANY_D} datasets x "
          f"{MANY['num_chains']} chains): {PAST_SWEEPS} no-gradient sweeps and a value+gradient "
          f"each, {PAST_SWEEPS} table sweeps: " + "; ".join(past))
    return launches


# ---------------------------------------------------------------------------
# phase 23: the time-sharded scan through the carry entries of K1, K3, K4
# ---------------------------------------------------------------------------

SEQ_N = 2**14            # 23a: a series split into SEQ_BLOCKS blocks, against one launch
# 23a: the same against the chained plain loops, in blocks of 133 steps: no
# whole number of K1's 32-step tables or of K3/K4's kc = 8 chunks
SEQ_SHORT_N = 4 * 133
SEQ_BLOCKS = 4
# (J, B): the warp-per-chain, the wide and the past-the-registers forms,
# each timed in 23c
SEQ_SHAPES = ((20, 64), (40, 16), (100, 8))
# 23c: the plain carry versions are timed on the first SEQ_PLAIN_K steps of
# the timed block, not all of it: a plain loop is a chain of host launches,
# 1-4 ms a step, so 4096 steps at J = 20 and 40 took about 50 s
SEQ_PLAIN_K = 512
SEQ_BUILDER_N = 2**15    # 23b: the builders' simulated light curve
# 23b: basis, J, B, the light curve's first N points; past the registers
# (DRWCelerite at 50 components) on 2^14 points, for its float64 K3
# checkpoints (0.5 GB a chain) and K4 sweeps (about 38 us a step)
SEQ_BUILDER = (("SHO", 20, 64, SEQ_BUILDER_N), ("DRWCelerite", 40, 16, SEQ_BUILDER_N),
               ("DRWCelerite", 100, 8, SEQ_N))
TERMS_A_COMPONENT = {"SHO": 1, "DRWCelerite": 2}
# the carry entries' counters: kernel name -> (module, counter)
CARRY_COUNTERS = {
    "celerite_fwd_carry": ("cc", "CARRY_LAUNCHES"),
    "celerite_fwd_aug_carry": ("vjp", "FWD_AUG_CARRY_LAUNCHES"),
    "celerite_bwd_carry": ("vjp", "BWD_CARRY_LAUNCHES"),
    "celerite_wide_fwd_carry": ("cc", "WIDE_CARRY_LAUNCHES"),
    "celerite_wide_fwd_aug_carry": ("vjp", "WIDE_FWD_AUG_CARRY_LAUNCHES"),
    "celerite_wide_bwd_carry": ("vjp", "WIDE_BWD_CARRY_LAUNCHES"),
}
# every other kernel counter, which the seq path must leave at 0
OTHER_COUNTERS = (("cc", "LAUNCHES"), ("cc", "MULTI_LAUNCHES"), ("cc", "TABLES_LAUNCHES"),
                  ("cc", "WIDE_LAUNCHES"), ("cc", "WIDE_MULTI_LAUNCHES"),
                  ("cc", "WIDE_TABLES_LAUNCHES"), ("vjp", "FWD_AUG_LAUNCHES"),
                  ("vjp", "BWD_LAUNCHES"), ("vjp", "FWD_AUG_MULTI_LAUNCHES"),
                  ("vjp", "BWD_MULTI_LAUNCHES"), ("vjp", "WIDE_FWD_AUG_LAUNCHES"),
                  ("vjp", "WIDE_BWD_LAUNCHES"), ("vjp", "WIDE_FWD_AUG_MULTI_LAUNCHES"),
                  ("vjp", "WIDE_BWD_MULTI_LAUNCHES"))


def _counter_modules():
    from pioran_tpu_torch.ops import cuda_celerite as cc, cuda_celerite_vjp as vjp

    return {"cc": cc, "vjp": vjp}


def carry_counts():
    """The carry entries' launch counters, and every other kernel's total
    (``others``)."""
    mods = _counter_modules()
    out = {k: getattr(mods[m], c) for k, (m, c) in CARRY_COUNTERS.items()}
    out["others"] = sum(getattr(mods[m], c) for m, c in OTHER_COUNTERS)
    return out


def zero_carry_counts():
    mods = _counter_modules()
    for m, c in (*CARRY_COUNTERS.values(), *OTHER_COUNTERS):
        setattr(mods[m], c, 0)


def carry_name(kind, J):
    """The kernel line's row of a carry entry (``kind`` "fwd", "fwd_aug" or
    "bwd") at J terms: narrow to 32, wide past it, past the registers
    (J > 64) a row of its own width."""
    if J <= 32:
        return f"celerite_{kind}_carry"
    return f"celerite_wide_{kind}_carry" + (f"_j{J}" if J > 64 else "")


def seq_inputs(J, B, N, seed, dev, dtype):
    """(a, b, c, d, t, y, sigma2) of B chains of J terms on N points, and
    the spacings dt (N - 1,) in float64, from a numpy generator seeded
    with ``seed``; positive-definite terms (|b d| < a c), lane 0 forced
    non-positive-definite."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, N / 4, N))
    a = np.abs(rng.normal(0.5, 0.2, (B, J))) / J
    c = np.abs(rng.normal(0.5, 0.2, (B, J)))
    d = np.abs(rng.normal(0.3, 0.1, (B, J)))
    b = 0.5 * a * c / (d + 1.0) * rng.uniform(-1, 1, (B, J))
    y = np.sin(t / 10)[None, :] + rng.normal(0, 0.3, (B, N))
    s2 = 0.05 + 0.01 * np.abs(rng.normal(size=(B, N)))
    a[0] = -50.0 * a[0]
    args = [torch.as_tensor(x, dtype=dtype, device=dev) for x in (a, b, c, d, t, y, s2)]
    return args, torch.as_tensor(np.diff(t), device=dev)


def seq_chain(args, dt64, nb, grad, g=None, plain=False):
    """The series split into ``nb`` blocks, each one call of the carry
    entries from the carry the block before ended with: K1's (``grad``
    False) or K3's, through ``seq_scan.run_block``, the helper the ring
    calls (with ``plain``, the plain versions' carry forms instead); with
    ``g``, K4's carry entry back over the blocks. Returns (ll, residual
    tables concatenated over the blocks or None, the 7 cotangents or
    None)."""
    from pioran_tpu_torch.ops import cuda_celerite as cc, cuda_celerite_vjp as vjp
    from pioran_tpu_torch.parallel.seq_scan import run_block

    a, b, c, d, t, y, s2 = args
    B, J = a.shape
    N = t.shape[0]
    K = N // nb
    dtg = torch.cat([dt64.new_zeros(1), dt64]).to(a.dtype)
    blocks = [slice(k * K, (k + 1) * K) for k in range(nb)]
    carry = vjp.neutral_carry(B, J, a)
    parts, saved = [], []
    for sl in blocks:
        xs = (a, b, c, d, t[sl], y[:, sl], s2[:, sl], dtg[sl], carry)
        if not plain:
            p, carry, res = run_block(*xs, grad)
        elif grad:
            p, carry, res = vjp.fwd_aug_plain(*xs[:8], carry=carry)
        else:
            (p, carry), res = cc._plain(*xs[:8], None, carry=carry), None
        parts.append(p)
        saved.append(res)
    logdet, quad, minD = parts[0][:, 0], parts[0][:, 1], parts[0][:, 2]
    for p in parts[1:]:
        logdet, quad, minD = logdet + p[:, 0], quad + p[:, 1], torch.minimum(minD, p[:, 2])
    ll = -0.5 * (logdet + quad + N * math.log(2 * math.pi))
    ll = torch.where((minD > 0) & torch.isfinite(ll), ll, torch.full_like(ll, -math.inf))
    if not grad:
        return ll, None, None
    res = [torch.cat([r[i] for r in saved], dim=1) for i in range(7)]
    if g is None:
        return ll, res, None
    g = torch.where(torch.isfinite(ll), g, torch.zeros_like(g))
    ain = a.new_zeros(B, vjp.adjoint_width(J))
    outs = [None] * nb
    for k in reversed(range(nb)):
        sl = blocks[k]
        xs = (a, b, c, d, t[sl], y[:, sl], s2[:, sl], saved[k], g, dtg[sl], ain)
        outs[k] = (vjp.bwd_plain(*xs[:10], carry=ain) if plain else vjp.bwd_carry(*xs))
        ain = outs[k][-1]
    coefs = [sum(o[i] for o in outs) for i in range(4)]
    tb = torch.cat([o[4] for o in outs])
    dtb = torch.cat([o[5] for o in outs])
    tbar = tb + dtb - torch.cat([dtb[1:], dtb.new_zeros(1)])
    return ll, res, (*coefs, tbar, torch.cat([o[6] for o in outs], dim=1),
                     torch.cat([o[7] for o in outs], dim=1))


def seq_rows(fin, ll, res, grads):
    """The rows :func:`adjoint_rows` compares, with whatever is None left out."""
    out = [ll[fin][:, None]]
    if res is not None:
        out += [x[fin] for x in res]
    if grads is not None:
        out += [x[None] if x.dim() == 1 else x[fin] for x in grads]
    return out


def carry_cost(kind, B, J, K, live, item=4):
    """(bytes, operations) of one carry entry on a block of K steps: the
    entry without a carry (:func:`k1_cost`, :func:`adjoint_cost`) plus
    its carries in and out and its partials."""
    C, A = 3 * J * J + 4 * J + 2, 3 * J * J + 2 * J
    if kind == "fwd":
        nbytes, ops = k1_cost(B, J, K, item)
        return nbytes + item * (2 * B * C + 3 * B), ops
    k3, k4 = adjoint_cost(B, J, K, 8, item, live)
    if kind == "fwd_aug":
        return k3[0] + item * (2 * B * C + 3 * B), k3[1]
    return k4[0] + item * 2 * B * A, k4[1]


def phase_seq_carry(dev, seed):
    """Phase 23a: each carry entry chained over SEQ_BLOCKS blocks through
    the ring's one-block helper, held against one launch of the entry
    without a carry at N = 2^14 (float64 1e-9; float32: the same step
    arithmetic, so only the order of the partial sums differs) and against
    the chained plain loops at N = SEQ_SHORT_N (phase 2's and phase 6's
    gates; past the registers, J = 100, float32 at the rows' median and
    90th percentile as phase 22); then, at every width, on one block of
    the long series (K = 4096), each carry entry's time against the entry
    without a carry, and its plain version's on the block's first
    SEQ_PLAIN_K steps. Returns {kernel: (max abs f32 err, ms, plain ms,
    cost)}."""
    from pioran_tpu_torch.ops import cuda_celerite as cc, cuda_celerite_vjp as vjp

    rows, times = {}, []
    plain_s = 0.0
    for J, B in SEQ_SHAPES:
        names = [carry_name(k, J) for k in ("fwd", "fwd_aug", "bwd")]
        worst = {n: 0.0 for n in names}
        errs_line = []
        # one launch against the chained carry entries, N = 2^14; float32
        # as phase 6 gates it, each output within 3x the float32 one
        # launch's own error against the float64 one launch
        ref64 = None
        for dtype in (torch.float64, torch.float32):
            args, dt64 = seq_inputs(J, B, SEQ_N, seed, dev, dtype)
            g = torch.linspace(0.5, 1.5, B, dtype=dtype, device=dev)
            k1 = cc._launch(*args, dt64)
            ll3, res3 = vjp.fwd_aug(*args, dt=dt64)
            fin = torch.isfinite(ll3)
            g = torch.where(fin, g, torch.zeros_like(g))
            grads = vjp.bwd(*args, res3, g, dt=dt64)
            c1, _, _ = seq_chain(args, dt64, SEQ_BLOCKS, False)
            c3, cres, cgrads = seq_chain(args, dt64, SEQ_BLOCKS, True, g)
            torch.cuda.synchronize()
            check(torch.equal(torch.isneginf(c1), torch.isneginf(k1))
                  and torch.equal(torch.isneginf(c3), ~fin) and bool(~fin[0]),
                  f"phase 23a J={J} {dtype}: the -inf lanes differ")
            check(bool(fin.sum() >= B - 1), f"phase 23a J={J}: {int((~fin).sum())} -inf lanes")
            e1 = rel_rows(c1[fin][:, None], k1[fin][:, None])
            chained, one = seq_rows(fin, c3, cres, cgrads), seq_rows(fin, ll3, res3, grads)
            e34 = [rel_rows(x, r) for x, r in zip(chained, one)]
            d1 = float((c1[fin].double() - k1[fin].double()).abs().max())
            d3 = float((c3[fin].double() - ll3[fin].double()).abs().max())
            tag = "f64" if dtype == torch.float64 else "f32"
            errs_line.append(f"{tag} K1 rel={e1:.2e} abs={d1:.2e} K3 value abs={d3:.2e} "
                             f"K3/K4 rows max rel={max(e34):.2e} "
                             f"({ADJ_NAMES[int(np.argmax(e34))]})")
            if dtype == torch.float64:
                check(max(e1, *e34) <= 1e-9, f"phase 23a J={J} f64: chained carry entries off "
                      f"one launch by {max(e1, *e34):.3e} > 1e-9")
                ref64 = [x.double() for x in one]
            else:
                check(max(d1, d3) <= 0.05, f"phase 23a J={J} f32: chained value off one launch "
                      f"by {max(d1, d3):.3e} nats > 0.05")
                ratio = 0.0
                for i, (x, q, r) in enumerate(zip(chained, one, ref64)):
                    e_k, e_q = rel_rows(x, r), rel_rows(q, r)
                    ratio = max(ratio, e_k / max(e_q, 1e-7))
                    check(e_k <= max(3.0 * e_q, 1e-5), f"phase 23a J={J} f32 {ADJ_NAMES[i]}: "
                          f"chained rel err {e_k:.3e} > 3 x one launch's {e_q:.3e}")
                errs_line.append(f"f32 chained/one-launch error ratio={ratio:.3f}")
            del res3, cres
        # against the chained plain loops, N = SEQ_SHORT_N
        a64, dt64 = seq_inputs(J, B, SEQ_SHORT_N, seed + 1, dev, torch.float64)
        a32 = [x.float() for x in a64]
        g = torch.linspace(0.5, 1.5, B, dtype=torch.float64, device=dev)
        p1, _, _ = seq_chain(a64, dt64, SEQ_BLOCKS, False, plain=True)
        p3, pres, pgrads = seq_chain(a64, dt64, SEQ_BLOCKS, True, g, plain=True)
        fin = torch.isfinite(p3)
        g = torch.where(fin, g, torch.zeros_like(g))
        refs = seq_rows(fin, p3, pres, pgrads)
        q1, _, _ = seq_chain(a32, dt64, SEQ_BLOCKS, False, plain=True)
        q3, qres, qgrads = seq_chain(a32, dt64, SEQ_BLOCKS, True, g.float(), plain=True)
        own = seq_rows(fin, q3, qres, qgrads)
        for args, gg in ((a64, g), (a32, g.float())):
            k1, _, _ = seq_chain(args, dt64, SEQ_BLOCKS, False)
            k3, kres, kgrads = seq_chain(args, dt64, SEQ_BLOCKS, True, gg)
            torch.cuda.synchronize()
            check(torch.equal(torch.isneginf(k1), torch.isneginf(p1))
                  and torch.equal(torch.isneginf(k3), ~fin),
                  f"phase 23a J={J}: -inf lanes differ from the chained plain loops")
            got = seq_rows(fin, k3, kres, kgrads)
            if args[0].dtype == torch.float64:
                e = [rel_rows(k1[fin][:, None], p1[fin][:, None])]
                e += [rel_rows(x, r) for x, r in zip(got, refs)]
                check(max(e) <= 1e-9, f"phase 23a J={J} f64: carry entries off the chained "
                      f"plain loops by {max(e):.3e} > 1e-9")
                errs_line.append(f"vs plain f64 max rel={max(e):.2e}")
                continue
            d1 = float((k1[fin].double() - q1[fin].double()).abs().max())
            check(d1 <= 0.05, f"phase 23a J={J} f32: K1 carry off the plain loop by {d1:.3e} "
                  "nats > 0.05")
            worst[names[0]] = d1
            ratio = 0.0
            for i, (x, q, r) in enumerate(zip(got, own, refs)):
                e_k, e_q = rel_rows(x, r), rel_rows(q, r)
                ratio = max(ratio, e_k / max(e_q, 1e-7))
                if J > 64 and x.shape[0] > 1:  # past the registers: the wide kernels' gate
                    f32_spread(f"phase 23a J={J}", ADJ_NAMES[i], chain_err(x, r), chain_err(q, r))
                else:
                    check(e_k <= max(3.0 * e_q, 1e-5), f"phase 23a J={J} f32 {ADJ_NAMES[i]}: "
                          f"kernel rel err {e_k:.3e} > 3 x the plain loop's {e_q:.3e}")
                key = names[1] if i < 8 else names[2]
                worst[key] = max(worst[key], float((x.double() - q.double()).abs().max()))
            errs_line.append(f"vs plain f32 K1 abs={d1:.2e} K3/K4 worst kernel/plain "
                             f"ratio={ratio:.3f}")
        print(f"phase 23a carry entries J={J} B={B}: ok N={SEQ_N} in {SEQ_BLOCKS} blocks vs "
              f"one launch, N={SEQ_SHORT_N} vs the chained plain loops, lane 0 non-PD: "
              + "; ".join(errs_line))
        # times on one block of the long series: each carry entry against
        # the same entry without a carry (in turns: carry, none, none,
        # carry), and its plain version (once) on the block's first
        # SEQ_PLAIN_K steps
        args, dt64 = seq_inputs(J, B, SEQ_N, seed, dev, torch.float32)
        K = SEQ_N // SEQ_BLOCKS
        a, b, c, d, t, y, s2 = args
        dtg = torch.cat([dt64.new_zeros(1), dt64]).float()
        sl = slice(K, 2 * K)
        _, carry, _ = vjp.fwd_aug_carry(a, b, c, d, t[:K], y[:, :K], s2[:, :K], dtg[:K],
                                        vjp.neutral_carry(B, J, a))
        blk = (a, b, c, d, t[sl], y[:, sl], s2[:, sl])
        _, cout, res = vjp.fwd_aug_carry(*blk, dtg[sl], carry)
        _, res0 = vjp.fwd_aug(*blk, dt=dt64[K:2 * K - 1])
        gg = torch.ones(B, device=dev)
        gg[0] = 0.0
        live = int(gg.sum())
        ain = torch.zeros(B, vjp.adjoint_width(J), device=dev)
        dts = dtg[sl]
        P = SEQ_PLAIN_K
        pblk = (a, b, c, d, t[K:K + P], y[:, K:K + P], s2[:, K:K + P])
        _, _, pres = vjp.fwd_aug_carry(*pblk, dts[:P], carry)
        fns = (  # (carry entry, the entry without a carry, the plain version)
            (lambda: cc.loglike_carry(*blk, dts, carry),  # noqa: B023
             lambda: cc._launch(*blk, dt64[K:2 * K - 1]),  # noqa: B023
             lambda: cc._plain(*pblk, dts[:P], None, carry=carry)),  # noqa: B023
            (lambda: vjp.fwd_aug_carry(*blk, dts, carry),  # noqa: B023
             lambda: vjp.fwd_aug(*blk, dt=dt64[K:2 * K - 1]),  # noqa: B023
             lambda: vjp.fwd_aug_plain(*pblk, dts[:P], carry=carry)),  # noqa: B023
            (lambda: vjp.bwd_carry(*blk, res, gg, dts, ain),  # noqa: B023
             lambda: vjp.bwd(*blk, res0, gg, dt=dt64[K:2 * K - 1]),  # noqa: B023
             lambda: vjp.bwd_plain(*pblk, pres, gg, dts[:P], carry=ain)))  # noqa: B023
        for name, kind, (with_carry, without, plain) in zip(names, ("fwd", "fwd_aug", "bwd"),
                                                            fns):
            m1, m0 = cuda_ms(with_carry, 10), cuda_ms(without, 10)
            m0, m1 = (m0 + cuda_ms(without, 10)) / 2, (m1 + cuda_ms(with_carry, 10)) / 2
            t0 = time.perf_counter()
            pms = once_ms(plain)
            plain_s += time.perf_counter() - t0
            rows[name] = (worst[name], m1, pms, carry_cost(kind, B, J, K, live))
            times.append(f"{name} J={J} B={B} K={K}: carry_ms={m1:.4f} no_carry_ms={m0:.4f} "
                         f"ratio={m1 / m0:.3f} plain_ms={pms:.2f} (first {P} steps)")
        del res, res0, pres
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    for ln in times:
        print(f"phase 23c times f32 (one block, CUDA events; {smi}): {ln}")
    for name, (err, ms, pms, cost) in rows.items():
        bms, by = bound(*cost)
        print(f"phase 23c {name} f32 block of {SEQ_N // SEQ_BLOCKS} steps: ms={ms:.4f} "
              f"bound_ms={bms:.5f} ({by}) plain_ms={pms:.2f} on its first {SEQ_PLAIN_K} steps "
              f"max_abs_err_f32={err:.3e} (against the chained plain loops at N={SEQ_SHORT_N})")
    print(f"phase 23c plain carry loops ({len(rows)}, {SEQ_PLAIN_K} steps each): "
          f"{plain_s:.1f} s in all")
    return rows


def seq_light_curve(seed, N):
    """A simulated light curve of N points from a numpy generator seeded
    with ``seed``: exponential gaps, an AR(1) log-flux, 2 % errors."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(0.5 + rng.exponential(0.5, N))
    t -= t[0]
    e = 0.05 * rng.normal(size=N)
    x = np.empty(N)
    x[0] = 0.0
    for i in range(1, N):
        x[i] = 0.995 * x[i - 1] + e[i]
    y = np.exp(0.3 * x)
    return t, y, 0.02 * y


def phase_seq_builder(dev, seed):
    """Phase 23b: ``single_bending_model(seq_mesh=)`` on a one-rank NCCL
    group (as phase 21 builds its group), SHO (J = 20, B = 64) and
    DRWCelerite (J = 40, B = 16) on a simulated light curve of N = 2^15,
    and DRWCelerite at 50 components (J = 100, B = 8: the carry entries
    past the registers) on its first 2^14 points: ``loglike_batch``, the
    scalar ``loglike`` (``logl(mesh=)``) and the ``logpost_batch``
    gradient against the spec without ``seq_mesh``, float64 within 1e-12
    relative. The plain loops and the scan are made to raise while the seq
    specs run. Returns the carry entries' launches on this path, by
    kernel row (J = 100 under its ``_j100`` rows)."""
    from datetime import timedelta

    import torch.distributed as dist

    from pioran_tpu_torch import parallel as par, single_bending_model
    from pioran_tpu_torch.ops import celerite as ocel, cuda_celerite as cc
    from pioran_tpu_torch.ops import cuda_celerite_vjp as vjp
    from pioran_tpu_torch.samplers.chees import batch_value_and_grad

    t_all, y_all, yerr_all = seq_light_curve(seed, SEQ_BUILDER_N)
    par.initialize_distributed(init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
                               rank=0, timeout=timedelta(seconds=120))
    launches = {}
    try:
        mesh = par.make_mesh("seq", device_type="cuda")

        def refuse(*a, **k):
            raise PhaseError("a plain loop or the scan ran on the seq path")

        for basis, J, B, N in SEQ_BUILDER:
            t, y, yerr = t_all[:N], y_all[:N], yerr_all[:N]
            xbar, va = float(np.mean(np.log(y))), float(np.var(np.log(y)))
            kw = dict(basis_function=basis, n_components=J // TERMS_A_COMPONENT[basis],
                      device=dev, dtype=torch.float64)
            seq = single_bending_model(t, y, yerr, xbar, va, seq_mesh=mesh, **kw)
            ref = single_bending_model(t, y, yerr, xbar, va, **kw)
            gen = torch.Generator(device=dev).manual_seed(seed + J)
            TH = seq.prior.sample((B,), generator=gen, dtype=torch.float64, device=dev)
            Z = seq.prior.to_unconstrained(TH)

            def evaluate(spec):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ll = spec.loglike_batch(TH)
                one = spec.loglike(TH[1])
                lp, gz = batch_value_and_grad(spec.logpost_batch, Z)
                torch.cuda.synchronize()
                return (ll, one, lp, gz), time.perf_counter() - t0

            (ll_r, one_r, lp_r, gz_r), _ = evaluate(ref)  # also sets up the allocator's pool
            saved = (cc._plain, vjp.fwd_aug_plain, vjp.bwd_plain, ocel.celerite_factor_solve)
            cc._plain = vjp.fwd_aug_plain = vjp.bwd_plain = refuse
            ocel.celerite_factor_solve = refuse
            zero_carry_counts()
            try:
                (ll, one, lp, gz), w_seq = evaluate(seq)
            finally:
                cc._plain, vjp.fwd_aug_plain, vjp.bwd_plain, ocel.celerite_factor_solve = saved
            counts = carry_counts()
            # walls once both are warm: the first seq call also sets up the
            # process group's communicator
            w_first, w_seq, w_ref = w_seq, evaluate(seq)[1], evaluate(ref)[1]
            # this width's three counters, under its kernel rows' names
            mine = {carry_name(k, J): counts[carry_name(k, min(J, 64))]
                    for k in ("fwd", "fwd_aug", "bwd")}
            check(counts["others"] == 0 and all(v >= 1 for v in mine.values())
                  and mine[carry_name("fwd", J)] == 2
                  and sum(counts.values()) - counts["others"] == sum(mine.values()),
                  f"phase 23b {basis} J={J}: launches {counts}")
            launches.update(mine)
            fin = torch.isfinite(ll_r)
            check(torch.equal(torch.isfinite(ll), fin) and torch.equal(torch.isfinite(lp), torch.isfinite(lp_r))
                  and bool(fin.sum() >= B // 2), f"phase 23b {basis}: finite rows differ "
                  f"({int(fin.sum())} of {B} finite)")
            e_ll = float(((ll - ll_r).abs() / ll_r.abs())[fin].max())
            e_one = abs(float(one) / float(one_r) - 1.0)
            fl = torch.isfinite(lp_r)
            e_g = rel_rows(gz[fl], gz_r[fl])
            e_lp = float(((lp - lp_r).abs() / lp_r.abs())[fl].max())
            print(f"phase 23b {basis} J={J} B={B} N={N} seq_mesh (one NCCL rank) vs "
                  f"unsharded f64: loglike_batch rel={e_ll:.2e} loglike rel={e_one:.2e} "
                  f"logpost rel={e_lp:.2e} gradient rows rel={e_g:.2e} (gates 1e-12); "
                  f"{int(fin.sum())} finite rows; wall_s seq={w_seq:.3f} unsharded={w_ref:.3f} "
                  f"(first seq call {w_first:.3f}); "
                  f"launches {mine}")
            check(max(e_ll, e_one, e_lp, e_g) <= 1e-12,
                  f"phase 23b {basis}: seq path off the unsharded spec by "
                  f"{max(e_ll, e_one, e_lp, e_g):.3e} > 1e-12")
    finally:
        dist.destroy_process_group()
    print("phase 23b seq_mesh builder (world size 1, NCCL): ok")
    return launches


def phase_seq(dev, seed):
    """Phase 23: the time-sharded scan (23a, 23c: the carry entries; 23b:
    the builder on a one-rank NCCL mesh). Returns (rows of 23a, launches
    of 23b)."""
    return phase_seq_carry(dev, seed), phase_seq_builder(dev, seed)


# Phase 24: the example scripts and the Kalman filters
CLI_SMC = ["--sampler", "smc", "--particles", "1024", "--moves", "12", "--seed", "7"]
CLI_RUNS = (  # CLI module, light curve (repository path), its own options
    ("single_pl", ("examples", "data", "simu.txt"), []),
    ("double_pl", ("tests", "data", "simu_double", "simu_double_subset_time_series.txt"), []),
    ("single_pl_periodicity",
     ("tests", "data", "simu_periodic", "simu_periodic_rednoise_subset_time_series.txt"), []),
    ("carma", ("examples", "data", "simu.txt"), ["--p", "2", "--q", "1"]),
)
# the keys of the JAX package's results.json for an SMC run
# (tests/test_torch_builders_smc.py)
SMC_RESULT_KEYS = {"paramnames", "sampler", "elapsed_s", "posterior", "maximum_likelihood",
                   "logz", "num_temper_steps", "ncall"}
PARITY_ARGS = ["--datasets", "single,docs", "--samplers", "smc"]
KALMAN_RTOL = {"sequential": 1e-8, "associative": 1e-6}  # tests/test_kalman.py's


def check_cli_run(name, root):
    """Phase 24a's gates on one CLI's output under ``root``: one run
    directory holding the cached subset file, chains/equal_weighted_post.txt
    and info/results.json with the JAX package's SMC keys, a finite logZ and
    a finite posterior."""
    runs = os.listdir(os.path.join(root, "inference"))
    check(len(runs) == 1, f"{name}: run directories {runs}")
    out = os.path.join(root, "inference", runs[0])
    subset = [f for f in os.listdir(out) if f.endswith("_subset_time_series.txt")]
    check(len(subset) == 1, f"{name}: cached subset files {subset}")
    for rel in (("chains", "equal_weighted_post.txt"), ("info", "results.json")):
        check(os.path.isfile(os.path.join(out, *rel)), f"{name}: {rel} not written")
    with open(os.path.join(out, "info", "results.json")) as fh:
        res = json.load(fh)
    check(set(res) == SMC_RESULT_KEYS, f"{name}: results.json keys {sorted(res)}")
    post = np.loadtxt(os.path.join(out, "chains", "equal_weighted_post.txt"), skiprows=1)
    check(math.isfinite(res["logz"]) and bool(np.all(np.isfinite(post)))
          and bool(np.all(np.isfinite(res["posterior"]["mean"]))),
          f"{name}: logZ {res['logz']} or the posterior not finite")
    return runs[0], res


def phase_cli(dev, smi):
    """Phase 24a and 24b: the four model CLIs' ``main`` (SMC, 1024
    particles, 12 MALA moves) and the parity CLI's SMC legs on single
    and docs, each in a temporary directory, through K1 and K3/K4 on the
    card. Returns the launches summed over the five calls."""
    import contextlib
    import importlib
    import tempfile

    total = {"celerite_fwd": 0, "celerite_fwd_aug": 0, "celerite_bwd": 0,
             "celerite_tables": 0}
    walls = {}
    for name, data, extra in CLI_RUNS:
        mod = importlib.import_module(f"pioran_tpu_torch.examples.{name}")
        with tempfile.TemporaryDirectory() as root, contextlib.chdir(root):
            zero_launch_counts()
            t0 = time.perf_counter()
            rc = mod.main([os.path.join(HERE, *data), *extra, *CLI_SMC])
            walls[name] = round(time.perf_counter() - t0, 2)
            launches = launch_counts()
            check(rc == 0, f"{name}.main returned {rc}")
            run, res = check_cli_run(name, root)
        print(f"phase 24a {name}: {run} logz={res['logz']:.4f} "
              f"temper_steps={res['num_temper_steps']} wall_s={walls[name]} "
              f"launches={launches}")
        check(min(launches["celerite_fwd"], launches["celerite_fwd_aug"],
                  launches["celerite_bwd"]) > 0, f"{name}: K1/K3/K4 not launched: {launches}")
        total = add_counts(total, launches)

    from pioran_tpu_torch.examples import parity

    with tempfile.TemporaryDirectory() as root:
        out = os.path.join(root, "parity")
        zero_launch_counts()
        t0 = time.perf_counter()
        rc = parity.main([*PARITY_ARGS, "--out", out])
        walls["parity"] = round(time.perf_counter() - t0, 2)
        launches = launch_counts()
        with open(os.path.join(out, "summary.json")) as fh:
            summary = json.load(fh)
    for tag, entry in summary["runs"].items():
        print(f"phase 24b parity {tag}: logz={entry['logz']:.4f} "
              f"diff={entry['logz_diff']:+.4f} max_pull={entry['max_pull']:.4f} "
              f"max_pull_referee={entry['max_pull_referee']:.4f} "
              f"width_ratio_referee={entry['width_ratio_referee']} pass={entry['pass']}")
    check(rc == 0 and sorted(summary["runs"]) == ["docs_smc", "single_smc"]
          and all(e["pass"] for e in summary["runs"].values()),
          f"parity CLI returned {rc}, runs {sorted(summary['runs'])}")
    check(summary["platform"] == "gpu" and summary["dtype"] == "float32",
          f"parity summary platform {summary['platform']} dtype {summary['dtype']}")
    check(min(launches["celerite_fwd"], launches["celerite_fwd_aug"],
              launches["celerite_bwd"]) > 0, f"parity: K1/K3/K4 not launched: {launches}")
    total = add_counts(total, launches)
    print(f"phase 24a/b CLIs: ok walls_s={walls} launches={launches} card: {smi}")
    return total


def phase_kalman(dev, smi):
    """Phase 24c: ``ops.kalman``'s sequential and associative filters on
    the card in float64 on the flagship light curve at FLAGSHIP_THETA,
    with the SHO basis (J = 20) and the DRWCelerite basis (J = 40),
    against K1's float64 value (the wide K1 at J = 40)."""
    from pioran_tpu_torch.models.psd import SingleBendingPowerLaw
    from pioran_tpu_torch.ops import cuda_celerite as cc, kalman
    from pioran_tpu_torch.ops.approx import approx
    from pioran_tpu_torch.ops.celerite import log_likelihood

    sub, _, _ = load_subset()
    f_min, f_max = 1.0 / (sub[-1, 0] - sub[0, 0]), 0.5 / np.min(np.diff(sub[:, 0]))
    t, y, yerr = (torch.as_tensor(sub[:, i], dtype=torch.float64, device=dev)
                  for i in range(3))
    a1, a2, f1, var, nu, mu = (torch.tensor(x, dtype=torch.float64, device=dev)
                               for x in FLAGSHIP_THETA)
    yc = torch.log(y) - mu
    s2 = nu * yerr**2 / y**2
    for basis in ("SHO", "DRWCelerite"):
        kern = approx(SingleBendingPowerLaw(a1, f1, a2), f_min, f_max, 20, var,
                      basis_function=basis)
        J = kern.a.shape[-1]
        before = cc.LAUNCHES + cc.WIDE_LAUNCHES
        ref = float(log_likelihood(kern, t, yc, s2))
        check(cc.LAUNCHES + cc.WIDE_LAUNCHES == before + 1, f"{basis}: K1 did not launch")
        for kind, sequential in (("sequential", True), ("associative", False)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ll = kalman.log_likelihood_kalman(kern, t, yc, s2, sequential=sequential)
            check(ll.device == t.device, f"{basis} {kind}: result on {ll.device}")
            ll = float(ll)
            ms = (time.perf_counter() - t0) * 1e3
            rel = abs(ll - ref) / abs(ref)
            print(f"phase 24c kalman {basis} J={J} {kind}: {ll:.10f} K1 {ref:.10f} "
                  f"rel={rel:.3e} (gate {KALMAN_RTOL[kind]:g}) wall_ms={ms:.1f}")
            check(rel <= KALMAN_RTOL[kind], f"{basis} {kind} Kalman filter {ll} against K1 {ref}")
    print(f"phase 24c kalman: ok card: {smi}")


def phase_examples(dev, smi):
    """Phase 24: 24a and 24b (the CLIs) and 24c (the Kalman filters);
    returns 24a/b's launches."""
    t0 = time.perf_counter()
    launches = phase_cli(dev, smi)
    phase_kalman(dev, smi)
    print(f"phase 24: ok wall_s={time.perf_counter() - t0:.1f} card: {smi}")
    return launches


def card_shared() -> bool:
    """Whether a second process may use the card: its compute mode is
    Default (not exclusive to one process, not prohibited)."""
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"compute mode: {mode}")
    return mode == "Default"


def start_chees(out_dir):
    """Phase 9 in a child process of this script on the same card (the
    kernels are already built); its output goes to a file under out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "phase9.log")
    with open(path, "w") as log:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--only-chees",
                                 "--out", out_dir], stdout=log, stderr=subprocess.STDOUT,
                                cwd=HERE)
    return proc, path


def finish_chees(proc, path):
    """Waits for the child's phase 9, prints its lines and returns its
    (launches, wall): the last line of its output is that JSON pair."""
    rc = proc.wait()
    with open(path) as fh:
        lines = fh.read().splitlines()
    for line in lines[:-1] if rc == 0 else lines:
        print(line)
    check(rc == 0 and bool(lines), f"phase 9 (child process) exited with {rc}")
    out = json.loads(lines[-1])
    return out["launches"], out["wall_s"]


def only_chees(out_dir) -> int:
    """The child's side of start_chees: phase 9 alone, then its launches
    and wall as the last line."""
    from pioran_tpu_torch import _build
    from pioran_tpu_torch.config import require_cuda

    dev = require_cuda()
    _build.load_all(("celerite_fwd", "celerite_adjoint"))
    t0 = time.perf_counter()
    launches = phase_chees(dev, out_dir)
    print(json.dumps({"launches": launches, "wall_s": round(time.perf_counter() - t0, 1)}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "build", "chip_smoke"),
                    help="directory for the NS, ChEES and multi-dataset runs' "
                         "ultranest-layout output")
    ap.add_argument("--serial", action="store_true",
                    help="run phase 9 in this process, so that every phase runs alone")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of phase 23's series and light curve (numpy)")
    ap.add_argument("--only-chees", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    if args.only_chees:
        return only_chees(args.out)
    from pioran_tpu_torch import single_bending_model

    t_start = time.perf_counter()
    walls = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        walls[name] = round(time.perf_counter() - t0, 1)
        return out

    dev, smi = timed("1", phase_build)
    sub, xbar, va = load_subset()
    specs = [single_bending_model(sub[:, 0], sub[:, 1], sub[:, 2], xbar, va,
                                  device=dev, dtype=dt)
             for dt in (torch.float64, torch.float32)]
    f32_err, (k_ms, p_ms) = timed("2", phase_kernel_vs_plain, *specs)
    timed("3", phase_long_n, dev)
    timed("4", phase_likelihood, dev)
    adj_err, timing = timed("6", phase_adjoint_vs_plain, *specs)
    timed("7", phase_flagship_grad, specs[0])
    timed("8", phase_long_n_grad, dev)
    datasets = many_datasets()
    k2_err, (k2_ms, k2_plain_ms, k2_nv) = timed("10", phase_multi_vs_plain, *specs, datasets)
    k2_launches, _ = timed("10a", phase_path_a, datasets, dev)
    multi_err, multi_timing = timed("11", phase_multi_adjoint_vs_plain, *specs, datasets)
    k0_launches, k0_err, k0_ms, k0_plain_ms, _ = timed("13", phase_tables, *specs)
    smc_launches = timed("14", phase_smc, dev, args.out)
    post_launches = timed("19", phase_post_fit, dev, args.out)
    resume_launches = timed("20", phase_resume, dev, args.out)
    mesh_launches = timed("21", phase_multi_device, dev, args.out)
    wide_times = timed("22a", phase_wide_times, dev, datasets)
    wide_smc_launches = timed("22b", phase_wide_smc, dev, args.out)
    seq_rows_, seq_launches = timed("23", phase_seq, dev, args.seed)
    # phase 22a's per-lane timings past 64 terms leave tens of GB in this
    # process's cache; the ChEES child, sharing the card, failed to create
    # its cusolver handle beside them, so hand the cache back first
    held = torch.cuda.memory_reserved(dev)
    torch.cuda.empty_cache()
    print(f"card memory reserved by this process before the ChEES child: {held / 2**30:.2f} GiB, "
          f"after emptying its cache {torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB")
    child = None if args.serial or not card_shared() else start_chees(args.out)
    try:
        if child is None:
            chees_launches = timed("9", phase_chees, dev, args.out)
        ns_launches = timed("5", phase_ns, dev, args.out)
        many_launches = timed("12", phase_many, dev, args.out, datasets)
        timed("15", phase_nuts_gaussian, dev)
        nuts_launches = timed("16", phase_nuts_flagship, dev, args.out)
        stepped_launches = timed("16b", phase_stepped, dev)
        timed("17", phase_builders, dev)
        builder_launches = timed("18", phase_builders_smc, dev, args.out)
        wide_err, wide_path_launches = timed("22", phase_wide, dev, datasets)
        cli_launches = timed("24", phase_examples, dev, smi)
        if child is not None:
            chees_launches, walls["9"] = finish_chees(*child)
    finally:
        if child is not None and child[0].poll() is None:
            child[0].kill()
            child[0].wait()
    overlap = ("" if child is None
               else " (9 in a child process beside 5, 12, 15-18, 16b, 22 and 24)")
    print(f"chip_smoke: all phases ok in {time.perf_counter() - t_start:.1f} s; "
          f"phase wall_s{overlap} {walls}; "
          f"launches on the main paths: NS {{'celerite_fwd': {ns_launches}}}, "
          f"ChEES {chees_launches}, multi-dataset no-gradient sweeps "
          f"{{'celerite_fwd_multi': {k2_launches}}}, run_inference_many {many_launches}, "
          f"batched_loglike_tables {{'celerite_tables': {k0_launches}}}, SMC {smc_launches}, "
          f"NUTS {nuts_launches}, host-stepped NUTS and ChEES (16b) {stepped_launches}, "
          f"SMC on the other builders {builder_launches}, "
          f"post-fit {post_launches}, resume {resume_launches}, multi-device {mesh_launches}, "
          f"DRWCelerite SMC (J=40) {wide_smc_launches}, J > 32 paths {wide_path_launches}, "
          f"seq_mesh builder (23b) {seq_launches}, CLIs (24a/b) {cli_launches}")

    # K1 at the NS sweep width (B = 128); K3 and K4 at the ChEES width (B = 512);
    # launches summed over the main paths that run them (NS, ChEES, SMC, NUTS,
    # the host-stepped runs, the other builders' SMC, the post-fit path, the
    # resumed and the sharded runs, the CLIs)
    t512 = timing[512]
    paths = (chees_launches, smc_launches, nuts_launches, stepped_launches, builder_launches,
             post_launches, resume_launches, mesh_launches, cli_launches)
    rows = {
        "celerite_fwd": (ns_launches + sum(p["celerite_fwd"] for p in paths), f32_err, k_ms,
                         p_ms, k1_cost(PHASE2_BATCHES[0])),
        "celerite_fwd_aug": (sum(p["celerite_fwd_aug"] for p in paths),
                             adj_err["celerite_fwd_aug"], t512["k3"], t512["p3"],
                             t512["cost"][0]),
        "celerite_bwd": (sum(p["celerite_bwd"] for p in paths), adj_err["celerite_bwd"],
                         t512["k4"], t512["p4"], t512["cost"][1]),
        # K2 and the per-lane K3/K4 at the run_inference_many batch (B = 1024)
        "celerite_fwd_multi": (k2_launches, k2_err, k2_ms, k2_plain_ms,
                               multi_costs(MULTI_BATCHES[0], 20, 485, 8, 4, k2_nv,
                                           k2_nv > 0)[0]),
        "celerite_fwd_aug_multi": (many_launches["celerite_fwd_aug_multi"],
                                   multi_err["celerite_fwd_aug_multi"], multi_timing["k3"],
                                   multi_timing["p3"], multi_timing["cost3"]),
        "celerite_bwd_multi": (many_launches["celerite_bwd_multi"],
                               multi_err["celerite_bwd_multi"], multi_timing["k4"],
                               multi_timing["p4"], multi_timing["cost4"]),
        # K0 at the final-sweep width (B = 4096) of its entry point's run
        "celerite_tables": (k0_launches, k0_err, k0_ms, k0_plain_ms,
                            tables_cost(TABLES_BATCHES[1])),
    }
    # the wide forms at J = 40 (phase 22a's widths); launches on phase
    # 22's paths: the DRWCelerite SMC fit (K1, K3/K4) and the entry points'
    # sweeps (K2, the per-lane K3/K4, K0)
    wide_launches = {**wide_smc_launches, **wide_path_launches}
    for name, (ms, plain_ms, cost) in wide_times.items():
        rows[name] = (wide_launches[name], wide_err[name], ms, plain_ms, cost)
    # the carry entries on one block of phase 23a's long series (K = 4096),
    # their plain versions on its first SEQ_PLAIN_K steps; launches on
    # phase 23b's seq_mesh builder path
    for name, (err, ms, plain_ms, cost) in seq_rows_.items():
        rows[name] = (seq_launches[name], err, ms, plain_ms, cost)
    kernels = []
    for name, (launches, err, ms, plain_ms, cost) in rows.items():
        src, replaces = KERNELS[name]
        bound_ms, bound_by = bound(*cost)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes the celerite recursion
            "library_ms": None,
            **({"plain_steps": SEQ_PLAIN_K} if name in seq_rows_ else {})})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
