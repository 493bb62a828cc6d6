#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--out DIR]

It builds the CUDA celerite kernel from ``pioran_tpu_torch/csrc`` with
nvcc, checks it against its plain PyTorch version, and drives the port's
main path: the flagship single-bending model and nested sampling
(``run_inference(sampler="ns")``, 1024 live points, J = 20) on the
reference's 485-point light curve, gated against the reference's
ultranest evidence. Each phase prints one line; any failure exits
non-zero before the result lines. The last two lines are the kernel
table (JSON) and ``{"ok": true, "device": {...}}``. Without a card it
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
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
KERNEL_SRC = "pioran_tpu_torch/csrc/celerite_fwd.cu"
KERNEL_REPLACES = "pioran_tpu/ops/pallas_celerite.py:252"  # _fused_kernel
PHASE2_BATCHES = (128, 4096, 1000)  # NS sweep, final sweep, ragged edge
NS_LIVE = 1024


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


def flagship_inputs(spec, B, gen):
    """(a, b, c, d, y, sigma2) at B parameter rows scattered around the
    reference posterior, through the port's own model; lane 0 is forced
    non-positive-definite."""
    from pioran_tpu_torch import SingleBendingPowerLaw, approx

    with open(os.path.join(DATA, "simu_single", "is_referee.json")) as fh:
        ref = json.load(fh)
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
    kern = approx(SingleBendingPowerLaw(th[:, 0], th[:, 2], th[:, 1]),
                  spec.f_min, spec.f_max, 20, th[:, 3])
    a, b, c, d = (x.contiguous() for x in kern.coefficients())
    y = torch.as_tensor(spec.y, dtype=dt, device=dev)
    e = torch.as_tensor(spec.yerr, dtype=dt, device=dev)
    yv = (torch.log(y)[None, :] - th[:, 5:6]).contiguous()
    s2 = (th[:, 4:5] * e**2 / y**2).contiguous()
    a[0] = -50.0 * a[0]
    return a, b, c, d, yv, s2


def phase_build():
    from pioran_tpu_torch import _build
    from pioran_tpu_torch.config import require_cuda

    dev = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    _build.load("celerite_fwd")
    wall = time.perf_counter() - t0
    seconds, log = _build.build_info("celerite_fwd")
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    print(f"phase 1 build: ok device={torch.cuda.get_device_name(0)!r} "
          f"nvcc_s={seconds:.2f} load_s={wall:.2f} ptxas={regs}")
    return dev, smi


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
    log_dir = os.path.join(out_dir, "ns")
    cuda_celerite.LAUNCHES = 0
    res = run_inference(spec, sampler="ns", num_particles=NS_LIVE, log_dir=log_dir)
    torch.cuda.synchronize()
    launches = cuda_celerite.LAUNCHES
    mww = res["insertion_order_MWW_test"]
    print(f"phase 5 NS: logz={res['logz']:.4f} logzerr={res['logzerr']:.4f} "
          f"ess={res['ess']:.1f} ncall={res['ncall']} elapsed_s={res['elapsed_s']:.2f} "
          f"insertion_converged={mww['converged']} mww_z={mww['zscore']:.3f} "
          f"launches={launches} N={sub.shape[0]}")
    with open(os.path.join(DATA, "simu_single", "is_referee.json")) as fh:
        ref = json.load(fh)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "build", "chip_smoke"),
                    help="directory for the NS run's ultranest-layout output")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from pioran_tpu_torch import single_bending_model

    dev, _smi = phase_build()
    sub, xbar, va = load_subset()
    specs = [single_bending_model(sub[:, 0], sub[:, 1], sub[:, 2], xbar, va,
                                  device=dev, dtype=dt)
             for dt in (torch.float64, torch.float32)]
    f32_err, (k_ms, p_ms) = phase_kernel_vs_plain(*specs)
    phase_long_n(dev)
    phase_likelihood(dev)
    launches = phase_ns(dev, args.out)
    print(json.dumps({"kernels": [{
        "name": "celerite_fwd", "route": "cuda", "source": KERNEL_SRC,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": f32_err, "ms": k_ms, "plain_ms": p_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
