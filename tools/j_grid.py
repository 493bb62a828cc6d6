#!/usr/bin/env python3
"""The port's celerite likelihood and its gradient over an N x J grid on
the card: N in {2^9, 2^12, 2^16} by J in {20, 32, 40, 64}, float32.

    python3 tools/j_grid.py [--out chiprun_out/j_grid.json] [--reps 3]

Each cell is ``benchmarks/bench_grid.py``'s problem (one random celerite
kernel with b = a and d = c, tiled over the batch with a 1% scatter on a,
lane 0 unscattered) at its batch, B = max(64, min(1024, 2^27 / N)). The
forward is ``batched_loglike`` without a gradient (K1 up to 32 terms, its
wide form past them); the value and gradient are ``batched_loglike`` under
autograd (K3 and K4, or their wide forms), at a batch halved from B until
``residual_bytes`` fits half the card's memory. Times are CUDA events over
``--reps`` runs after one warm-up. The error columns hold lane 0's float32
value against float64 (absolute, nats) and its float32 gradient against
float64 (2-norm relative, the four coefficient gradients together).
Imports torch and the port only; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NS = (2**9, 2**12, 2**16)
JS = (20, 32, 40, 64)


def problem(N, J, B, seed=0):
    """bench_grid.py's make_problem tiled to B rows: (a, b, c, d, t, y, s2)
    as float64 numpy, and the host spacings."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 1000.0, N))
    y = rng.normal(size=N)
    s2 = 0.05 + 0.1 * rng.uniform(size=N)
    a = rng.uniform(0.5, 2.0, J)
    c = rng.uniform(0.05, 0.5, J)
    A = np.tile(a, (B, 1)) * (1 + 0.01 * rng.normal(size=(B, J)))
    A[0] = a
    rows = lambda v: np.tile(v, (B, 1))  # noqa: E731
    return (A, rows(a), rows(c), rows(c), t, rows(y), rows(s2)), np.diff(t)


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def value_and_grad(args, dt):
    from pioran_tpu_torch.ops.cuda_celerite import batched_loglike

    coefs = [x.detach().requires_grad_(True) for x in args[:4]]
    ll = batched_loglike(*coefs, *args[4:], dt)
    grads = torch.autograd.grad(torch.where(torch.isfinite(ll), ll, 0.0).sum(), coefs)
    return ll, grads


def cell(N, J, reps, dev):
    from pioran_tpu_torch.ops.cuda_celerite import batched_loglike
    from pioran_tpu_torch.ops.cuda_celerite_vjp import KC, residual_bytes

    B = max(64, min(1024, (1 << 27) // N))
    Bg = B
    half = torch.cuda.get_device_properties(dev).total_memory // 2
    while Bg > 1 and sum(residual_bytes(Bg, J, N, KC, torch.float32)) > half:
        Bg //= 2
    np_args, dt_np = problem(N, J, B)
    to = lambda xs, dtype: [torch.as_tensor(x, dtype=dtype, device=dev) for x in xs]  # noqa: E731
    args = to(np_args, torch.float32)
    dt = torch.as_tensor(dt_np, device=dev)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: batched_loglike(*args, dt), reps)
        ll32 = batched_loglike(*args, dt)
    gargs = [x[:Bg] if x.dim() == 2 else x for x in args]
    vg_ms = cuda_ms(lambda: value_and_grad(gargs, dt), reps)
    _, g32 = value_and_grad(gargs, dt)
    # lane 0 in float64: the reference of both error columns
    lane0 = [torch.as_tensor(x[:1] if x.ndim == 2 else x, device=dev) for x in np_args]
    ll64, g64 = value_and_grad(lane0, dt)
    ll64 = ll64.detach()
    g32_0 = torch.cat([g[0].double() for g in g32])
    g64_0 = torch.cat([g[0] for g in g64])
    return {
        "N": N, "J": J, "B": B, "fwd_ms": fwd_ms, "fwd_evals_per_s": B / fwd_ms * 1e3,
        "grad_B": Bg, "value_grad_ms": vg_ms, "value_grad_evals_per_s": Bg / vg_ms * 1e3,
        "ll64_lane0": float(ll64[0]), "f32_abs_err": abs(float(ll32[0]) - float(ll64[0])),
        "f32_grad_rel_err": float((g32_0 - g64_0).norm() / g64_0.norm()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("chiprun_out", "j_grid.json"))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    from pioran_tpu_torch.config import require_cuda

    dev = require_cuda()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    rows = []
    print("| N | J | B | forward ms | forward evals/s | gradient B | value+gradient ms | "
          "value+gradient evals/s | f32 value err (nats) | f32 gradient rel err |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for N in NS:
        for J in JS:
            r = cell(N, J, args.reps, dev)
            rows.append(r)
            print(f"| {N} | {J} | {r['B']} | {r['fwd_ms']:.4f} | {r['fwd_evals_per_s']:.1f} | "
                  f"{r['grad_B']} | {r['value_grad_ms']:.4f} | "
                  f"{r['value_grad_evals_per_s']:.1f} | {r['f32_abs_err']:.3e} | "
                  f"{r['f32_grad_rel_err']:.3e} |", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"device": card, "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
