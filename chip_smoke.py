#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--out DIR]

It builds the CUDA kernels from ``pioran_tpu_torch/csrc`` with nvcc
(K1, the forward ``celerite_fwd``; K3 and K4, the adjoint pair
``celerite_fwd_aug`` and ``celerite_bwd``), checks each against its plain
PyTorch version, and drives the port's two main paths on the reference's
485-point light curve with the flagship single-bending model (J = 20):
nested sampling (``run_inference(sampler="ns")``, 1024 live points, gated
against the reference's ultranest evidence) and ChEES-HMC seeded by ADVI
with a dense metric (``run_inference(sampler="chees")``, 512 chains, 500
+ 2400 iterations, gated against the importance-sampling referee and on
split-r̂). Between them it checks the flagship gradient and the N = 2^16
gradient. Each phase prints its lines; any failure exits non-zero before
the result lines. The last two lines are the kernel table (JSON) and
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
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "celerite_fwd": ("pioran_tpu_torch/csrc/celerite_fwd.cu",
                     "pioran_tpu/ops/pallas_celerite.py:252"),  # _fused_kernel
    "celerite_fwd_aug": (ADJOINT_SRC, "pioran_tpu/ops/pallas_celerite_vjp.py:127"),
    "celerite_bwd": (ADJOINT_SRC, "pioran_tpu/ops/pallas_celerite_vjp.py:540"),
}
PHASE2_BATCHES = (128, 4096, 1000)  # NS sweep, final sweep, ragged edge
ADJ_BATCHES = (512, 8, 1000)        # ChEES batch, small, ragged edge
NS_LIVE = 1024
CHEES = dict(num_chains=512, num_warmup=500, num_samples=2400, hmc_max_leapfrogs=128)
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


def flagship_inputs(spec, B, gen):
    """(a, b, c, d, y, sigma2) at B rows from :func:`referee_thetas`,
    through the port's own model; lane 0 is forced non-positive-definite."""
    from pioran_tpu_torch import SingleBendingPowerLaw, approx

    dev, dt = spec.device, spec.dtype
    th = referee_thetas(spec, B, gen)
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
    """'kernel<type,JP> regs/spill-stores/spill-loads' for each entry
    function in nvcc's -Xptxas -v output."""
    out, cur, spill = [], None, None
    for ln in log.splitlines():
        m = re.search(r"(celerite_fwd_kernel|fwd_aug_kernel|bwd_kernel)I([fd])Li(\d+)E", ln)
        if "Compiling entry function" in ln and m:
            cur, spill = f"{m.group(1)}<{m.group(2)},{m.group(3)}>", None
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "build", "chip_smoke"),
                    help="directory for the NS and ChEES runs' ultranest-layout output")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from pioran_tpu_torch import single_bending_model

    t_start = time.perf_counter()
    dev, _smi = phase_build()
    sub, xbar, va = load_subset()
    specs = [single_bending_model(sub[:, 0], sub[:, 1], sub[:, 2], xbar, va,
                                  device=dev, dtype=dt)
             for dt in (torch.float64, torch.float32)]
    f32_err, (k_ms, p_ms) = phase_kernel_vs_plain(*specs)
    phase_long_n(dev)
    phase_likelihood(dev)
    ns_launches = phase_ns(dev, args.out)
    adj_err, timing = phase_adjoint_vs_plain(*specs)
    phase_flagship_grad(specs[0])
    phase_long_n_grad(dev)
    chees_launches = phase_chees(dev, args.out)
    print(f"chip_smoke: all phases ok in {time.perf_counter() - t_start:.1f} s; "
          f"launches on the main paths: NS {{'celerite_fwd': {ns_launches}}}, "
          f"ChEES {chees_launches}")

    # K1 at the NS sweep width (B = 128); K3 and K4 at the ChEES width (B = 512)
    t512 = timing[512]
    rows = {
        "celerite_fwd": (ns_launches + chees_launches["celerite_fwd"], f32_err, k_ms, p_ms,
                         k1_cost(PHASE2_BATCHES[0])),
        "celerite_fwd_aug": (chees_launches["celerite_fwd_aug"], adj_err["celerite_fwd_aug"],
                             t512["k3"], t512["p3"], t512["cost"][0]),
        "celerite_bwd": (chees_launches["celerite_bwd"], adj_err["celerite_bwd"],
                         t512["k4"], t512["p4"], t512["cost"][1]),
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
