#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--out DIR]

It builds the CUDA kernels from ``pioran_tpu_torch/csrc`` with nvcc
(K1, the forward ``celerite_fwd``; K3 and K4, the adjoint pair
``celerite_fwd_aug`` and ``celerite_bwd``; and their per-lane forms for
ragged per-chain time grids: K2 ``celerite_fwd_multi``,
``celerite_fwd_aug_multi`` and ``celerite_bwd_multi``), checks each
against its plain PyTorch version, and drives the port's main paths with
the flagship single-bending model (J = 20): on the reference's 485-point
light curve, nested sampling (``run_inference(sampler="ns")``, 1024 live
points, gated against the reference's ultranest evidence) and ChEES-HMC
seeded by ADVI with a dense metric (``run_inference(sampler="chees")``,
512 chains, 500 + 2400 iterations, gated against the importance-sampling
referee and on split-r̂); then the multi-dataset path on 16 ragged light
curves: a no-gradient sweep of ``batched_loglike_multi`` (K2) and
``run_inference_many`` (64 chains each from prior draws, 500 + 500
iterations, per-lane K3/K4; every dataset's mu gated, dataset 0, the
reference's subset, reported against the referee).
Between them it checks the flagship gradients and the N = 2^16 gradient.
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
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "celerite_fwd": (FWD_SRC, "pioran_tpu/ops/pallas_celerite.py:252"),  # _fused_kernel
    "celerite_fwd_aug": (ADJOINT_SRC, "pioran_tpu/ops/pallas_celerite_vjp.py:127"),
    "celerite_bwd": (ADJOINT_SRC, "pioran_tpu/ops/pallas_celerite_vjp.py:540"),
    # the same TPU kernels with per_lane_t=True (K2 is launched at :521)
    "celerite_fwd_multi": (FWD_SRC, "pioran_tpu/ops/pallas_celerite.py:252"),
    "celerite_fwd_aug_multi": (ADJOINT_SRC, "pioran_tpu/ops/pallas_celerite_vjp.py:127"),
    "celerite_bwd_multi": (ADJOINT_SRC, "pioran_tpu/ops/pallas_celerite_vjp.py:540"),
}
PHASE2_BATCHES = (128, 4096, 1000)  # NS sweep, final sweep, ragged edge
ADJ_BATCHES = (512, 8, 1000)        # ChEES batch, small, ragged edge
NS_LIVE = 1024
CHEES = dict(num_chains=512, num_warmup=500, num_samples=2400, hmc_max_leapfrogs=128)
MULTI_BATCHES = (1024, 4096, 1000)  # the run_inference_many batch, large, ragged edge
ADJ_MULTI_BATCHES = (1024, 7)      # the run_inference_many batch, ragged edge
MANY_D = 16                         # datasets of the multi-dataset run
MANY = dict(num_chains=64, num_warmup=500, num_samples=500, max_leapfrogs=128)  # JAX defaults
PATH_A_SWEEPS = 10                  # no-gradient K2 sweeps over the run's batch
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


def load_subset():
    """The reference's 485-point light curve and its #mean: header."""
    path = os.path.join(DATA, "simu_single", "simu_single_subset_time_series.txt")
    xbar = va = None
    with open(path) as fh:
        for line in fh:
            if line.startswith("#mean: "):
                left, right = line[len("#mean: "):].split(" va: ")
                xbar, va = float(left), float(right)
                break
    return np.loadtxt(path), xbar, va


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


def flagship_coefficients(spec, B, gen):
    """(theta, a, b, c, d) at B rows from :func:`referee_thetas`, through
    the port's own basis approximation; lane 0 is forced
    non-positive-definite."""
    from pioran_tpu_torch import SingleBendingPowerLaw, approx

    th = referee_thetas(spec, B, gen)
    kern = approx(SingleBendingPowerLaw(th[:, 0], th[:, 2], th[:, 1]),
                  spec.f_min, spec.f_max, 20, th[:, 3])
    a, b, c, d = (x.contiguous() for x in kern.coefficients())
    a[0] = -50.0 * a[0]
    return th, a, b, c, d


def flagship_inputs(spec, B, gen):
    """(a, b, c, d, y, sigma2) at B rows from :func:`flagship_coefficients`
    on the spec's own light curve; lane 0 is not positive definite."""
    dev, dt = spec.device, spec.dtype
    th, a, b, c, d = flagship_coefficients(spec, B, gen)
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


def multi_inputs(spec, model, B, gen):
    """(a, b, c, d, T, y, sigma2, n_valid, DT) at B ragged rows: the
    flagship coefficients of :func:`flagship_coefficients` on dataset
    i mod D's light curve, padded as the multi-dataset model pads it;
    lane 0 is not positive definite. sigma2 is left as the model gives it
    on the padding."""
    th, a, b, c, d = flagship_coefficients(spec, B, gen)
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
    libs = ("celerite_fwd", "celerite_adjoint")
    t0 = time.perf_counter()
    _build.load_all(libs)  # one nvcc per source, started together
    wall = time.perf_counter() - t0
    for name in libs:
        seconds, log = _build.build_info(name)
        print(f"phase 1 build: {name} nvcc_s={seconds:.2f} ptxas: {ptxas_summary(log)}")
    print(f"phase 1 build: ok device={torch.cuda.get_device_name(0)!r} wall_s={wall:.2f}")
    return dev, smi


def ptxas_summary(log: str) -> str:
    """'kernel<type,JP,grid> regs spill stores/loads' for each entry
    function in nvcc's -Xptxas -v output (grid: shared or per-lane t)."""
    out, cur, spill = [], None, None
    for ln in log.splitlines():
        m = re.search(r"(celerite_fwd_kernel|fwd_aug_kernel|bwd_kernel)I([fd])Li(\d+)ELb([01])E", ln)
        if "Compiling entry function" in ln and m:
            grid = "per-lane" if m.group(4) == "1" else "shared"
            cur, spill = f"{m.group(1)}<{m.group(2)},{m.group(3)},{grid}>", None
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
            if B in PHASE2_BATCHES[:2]:
                run_k = lambda: batched_loglike(a, b, c, d, t, y, s2, dt64)  # noqa: E731
                run_p = lambda: batched_loglike_plain(a, b, c, d, t, y, s2, dt64)  # noqa: E731
                times[(str(dtype)[6:], B)] = (cuda_ms(run_k, 20), cuda_ms(run_p, 2))
    b_ns = PHASE2_BATCHES[0]
    tstr = " ".join(f"{k[0]}/B={k[1]}: kernel_ms={v[0]:.4f} plain_ms={v[1]:.2f}"
                    + (f" bound_ms={bound(*k1_cost(k[1]))[0]:.5f}" if k[0] == "float32" else "")
                    for k, v in times.items())
    print(f"phase 2 kernel vs plain: ok N=485 J=20 B=128,4096,1000 with/without dt "
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
        KC, bwd, bwd_plain, fwd_aug, fwd_aug_plain, residual_bytes)
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
    for B in (512, 4096):
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
        tb, ck, sc = residual_bytes(B, 20, 485, KC, torch.float32)
        print(f"phase 6 times f32 B={B}: K3_ms={k3:.4f} K4_ms={k4:.4f} "
              f"logpost_value_and_grad_ms={vg:.3f} value_grad_evals_per_s={B / vg * 1e3:.1f}"
              + (f" K3_plain_ms={p3:.1f} K4_plain_ms={p4:.1f}" if p3 else "")
              + f" K3_bound_ms={bound(*cost[0])[0]:.4f} K4_bound_ms={bound(*cost[1])[0]:.4f}"
              f" residual_bytes tables={tb} ckpts={ck} k4_scratch={sc}")
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
          f"residual+scratch bytes f64={by['float64']} f32={by['float32']}")


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
        f"{k[0]}/B={k[1]}: K2_ms={v[0]:.4f}" + (f" plain_ms={v[1]:.2f}" if v[1] else "")
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "build", "chip_smoke"),
                    help="directory for the NS, ChEES and multi-dataset runs' "
                         "ultranest-layout output")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from pioran_tpu_torch import single_bending_model

    t_start = time.perf_counter()
    walls = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        walls[name] = round(time.perf_counter() - t0, 1)
        return out

    dev, _smi = timed("1", phase_build)
    sub, xbar, va = load_subset()
    specs = [single_bending_model(sub[:, 0], sub[:, 1], sub[:, 2], xbar, va,
                                  device=dev, dtype=dt)
             for dt in (torch.float64, torch.float32)]
    f32_err, (k_ms, p_ms) = timed("2", phase_kernel_vs_plain, *specs)
    timed("3", phase_long_n, dev)
    timed("4", phase_likelihood, dev)
    ns_launches = timed("5", phase_ns, dev, args.out)
    adj_err, timing = timed("6", phase_adjoint_vs_plain, *specs)
    timed("7", phase_flagship_grad, specs[0])
    timed("8", phase_long_n_grad, dev)
    chees_launches = timed("9", phase_chees, dev, args.out)
    datasets = many_datasets()
    k2_err, (k2_ms, k2_plain_ms, k2_nv) = timed("10", phase_multi_vs_plain, *specs, datasets)
    k2_launches, _ = timed("10a", phase_path_a, datasets, dev)
    multi_err, multi_timing = timed("11", phase_multi_adjoint_vs_plain, *specs, datasets)
    many_launches = timed("12", phase_many, dev, args.out, datasets)
    print(f"chip_smoke: all phases ok in {time.perf_counter() - t_start:.1f} s; "
          f"phase wall_s {walls}; "
          f"launches on the main paths: NS {{'celerite_fwd': {ns_launches}}}, "
          f"ChEES {chees_launches}, multi-dataset no-gradient sweeps "
          f"{{'celerite_fwd_multi': {k2_launches}}}, run_inference_many {many_launches}")

    # K1 at the NS sweep width (B = 128); K3 and K4 at the ChEES width (B = 512)
    t512 = timing[512]
    rows = {
        "celerite_fwd": (ns_launches + chees_launches["celerite_fwd"], f32_err, k_ms, p_ms,
                         k1_cost(PHASE2_BATCHES[0])),
        "celerite_fwd_aug": (chees_launches["celerite_fwd_aug"], adj_err["celerite_fwd_aug"],
                             t512["k3"], t512["p3"], t512["cost"][0]),
        "celerite_bwd": (chees_launches["celerite_bwd"], adj_err["celerite_bwd"],
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
    }
    kernels = []
    for name, (launches, err, ms, plain_ms, cost) in rows.items():
        src, replaces = KERNELS[name]
        bound_ms, bound_by = bound(*cost)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes the celerite recursion
            "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
