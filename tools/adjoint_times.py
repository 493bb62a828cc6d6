#!/usr/bin/env python3
"""CUDA-event times of K3 and K4 (``ops.cuda_celerite_vjp``) on the card.

float32, J = 20, N = 485, kc = 8, host-f64 spacings, on synthetic inputs
(the per-step cost does not depend on the values), at B = 16 (the NUTS
leaf batch), 512 (ChEES), 1024 (``run_inference_many``) and 4096, for the
shared-grid kernels and the per-lane ones (every lane on the one grid,
n_valid = N). Also prints the adjoint library's ptxas registers and
spills and K4's launch shape. Run on a machine with the card:

    python3 tools/adjoint_times.py
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import cuda_ms, ptxas_summary  # noqa: E402
from pioran_tpu_torch import _build  # noqa: E402
from pioran_tpu_torch.ops import cuda_celerite_vjp as vjp  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("adjoint_times: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    _build.load("celerite_adjoint")
    seconds, log = _build.build_info("celerite_adjoint")
    print(f"build s {seconds:.1f}")
    for x in ptxas_summary(log).split("; "):
        print(x)
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    J, N = 20, 485

    def problem(B):
        f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
        return (f(rng.uniform(0.1, 0.6, (B, J))), f(rng.uniform(0.0, 0.2, (B, J))),
                f(rng.uniform(0.05, 0.35, (B, J))), f(rng.uniform(0.0, 0.4, (B, J))),
                f(np.sort(rng.uniform(0, 100, N))), f(rng.normal(size=(B, N))),
                f(rng.uniform(0.05, 0.15, (B, N))))

    for B in (16, 512, 1024, 4096):
        args = problem(B)
        dt = torch.as_tensor(np.diff(args[4].cpu().numpy().astype(np.float64)), device=dev)
        ll, res = vjp.fwd_aug(*args, dt=dt)
        g = torch.isfinite(ll).float()
        k3 = cuda_ms(lambda: vjp.fwd_aug(*args, dt=dt), 20)  # noqa: B023
        k4 = cuda_ms(lambda: vjp.bwd(*args, res, g, dt=dt), 20)  # noqa: B023
        print(f"B={B} K3_ms={k3:.4f} K4_ms={k4:.4f} "
              f"shape={vjp.bwd_launch_shape(torch.float32, J, 8, B)} finite={int(g.sum())}")
        T = args[4].expand(B, N).contiguous()
        DT = dt.expand(B, N - 1).contiguous()
        nv = torch.full((B,), N, device=dev)
        pargs = args[:4] + (T,) + args[5:]
        ll, res = vjp.fwd_aug(*pargs, dt=DT, n_valid=nv)
        k3 = cuda_ms(lambda: vjp.fwd_aug(*pargs, dt=DT, n_valid=nv), 20)  # noqa: B023
        k4 = cuda_ms(lambda: vjp.bwd(*pargs, res, g, dt=DT, n_valid=nv), 20)  # noqa: B023
        print(f"  per-lane B={B} K3_ms={k3:.4f} K4_ms={k4:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
