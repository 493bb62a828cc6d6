#!/usr/bin/env python3
"""The wide celerite kernels' times on the card, by where they keep their
state: K1 and K3 (the forward sweep) and K4 (the reverse sweep) past 32
terms, at J in {40, 64, 100}, B in {128, 1024}, N = 485, float32 and
float64, K4 at each placement of its carry and T chunk that its launch
shape can pick (both in shared memory, the chunk in the device scratch,
both there) and that fits, beside the one ``wide_bwd_shape`` picks.

    python3 tools/wide_times.py

CUDA-event milliseconds a launch (after one warm-up), on random celerite
kernels that are positive definite row by row. Imports torch and the port
only; needs a CUDA device.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PLACES = ((True, True), (True, False), (False, False))  # (G, chunk in shared memory)


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


def problem(B, J, N, dtype, dev, seed=1):
    """a c > b d term by term; t sorted, y normal, sigma2 in [0.05, 0.15]."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.1, 1.0, (B, J))
    b = 0.1 * a * rng.uniform(0.0, 1.0, (B, J))
    c = rng.uniform(0.05, 0.5, (B, J))
    d = c * rng.uniform(0.0, 1.0, (B, J))
    t = np.sort(rng.uniform(0, 100, N))
    y = rng.normal(size=(B, N))
    s2 = rng.uniform(0.05, 0.15, (B, N))
    return [torch.as_tensor(x, dtype=dtype, device=dev) for x in (a, b, c, d, t, y, s2)]


def forced(place):
    """A stand-in for ``wide_bwd_shape`` that keeps the carry G and the T
    chunk where ``place`` says (the launch refuses what does not fit)."""
    from pioran_tpu_torch.ops import cuda_celerite_vjp as vjp

    def shape(J, kc, dtype, B=1, sms=vjp.H100_SMS):
        ks = min(kc, vjp.WIDE_SUB)
        return ks, None, 0 if place[0] else 4 * J * J, 0 if place[1] else 3 * ks * J * (J | 1)
    return shape


def main() -> int:
    from pioran_tpu_torch.config import require_cuda
    from pioran_tpu_torch.ops import cuda_celerite as cc, cuda_celerite_vjp as vjp

    dev = require_cuda()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    default = vjp.wide_bwd_shape
    N = 485
    for dtype in (torch.float32, torch.float64):
        for J in (40, 64, 100):
            for B in (128, 1024):
                args = problem(B, J, N, dtype, dev)
                k1 = cuda_ms(lambda: cc.batched_loglike(*args), 3)  # noqa: B023
                k3 = cuda_ms(lambda: vjp.fwd_aug(*args), 2)  # noqa: B023
                ll, res = vjp.fwd_aug(*args)
                g = torch.isfinite(ll).to(dtype)
                state = vjp.wide_fwd_scratch(J, dtype)
                picked = vjp.wide_bwd_shape(J, vjp.KC, dtype, B, sms)
                line = (f"{str(dtype)[6:]} J={J} B={B}: K1 {k1:.4f} K3 {k3:.4f} (state in "
                        f"{'device memory' if state else 'shared memory'}) K4")
                for place in PLACES:
                    vjp.wide_bwd_shape = forced(place)
                    try:
                        ms = cuda_ms(lambda: vjp.bwd(*args, res, g), 2)  # noqa: B023
                    except RuntimeError:  # does not fit shared memory
                        continue
                    finally:
                        vjp.wide_bwd_shape = default
                    mark = "*" if (not picked[2], not picked[3]) == place else ""
                    line += f" {place}{mark} {ms:.4f}"
                print(line + " (G, chunk in shared memory; * the default)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
