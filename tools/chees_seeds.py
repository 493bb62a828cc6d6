#!/usr/bin/env python3
"""Run a ChEES configuration of the port once per seed and print its
convergence per seed: r-hat, ESS, leapfrog count, the chains whose means
sit far from the pooled mean, pulls against the referee.

Run from the repository root on a machine with one NVIDIA H100:

    python3 tools/chees_seeds.py [--leg smoke|parity] [--float64] [--trace]
        [--bf16] [--jobs N] [--save-inits PATH.npy] 0 1 2

``--leg smoke`` (the default) is chip_smoke.py's phase 9 (512 chains,
500 + 1800, float32); ``--leg parity`` is the parity run's ChEES leg
(``python -m pioran_tpu_torch.examples.parity --datasets single
--samplers chees``: 512 chains, 500 + 300, dense metric, ADVI inits, the
single dataset's spec). Each seed runs what ``run_inference(sampler=
"chees", init="advi", mass="dense", seed=...)`` runs, with the same
random numbers, driving the transition itself so that ``--trace`` can
write every iteration's step size, trajectory length, leapfrog count and
mean accept rate to ``chiprun_out/chees_trace/<leg>_<dtype>[_bf16]_s<seed>.json``
and print its 25-iteration window means. ``--float64`` runs the model in
float64. ``--bf16`` rounds the operands of the metric's velocity and
kinetic-energy products to bfloat16 (``tools/chees_lockstep.py``
``bf16_products``), as a float32 matmul at a TPU's default precision
does. ``--jobs N`` runs the seeds in N child processes at once on the
card. ``--save-inits`` writes the first seed's ADVI inits (unconstrained,
float64) for ``tools/chees_lockstep.py --inits``. Each seed prints one
JSON line. Imports no JAX.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))
import chip_smoke as cs  # noqa: E402
from chees_lockstep import bf16_products  # noqa: E402
from pioran_tpu_torch import inference as tinf  # noqa: E402
from pioran_tpu_torch.samplers.chees import make_chees_transition  # noqa: E402

LEGS = {
    "smoke": dict(num_chains=512, num_warmup=500, num_samples=1800),
    "parity": dict(num_chains=512, num_warmup=500, num_samples=300),
}
MAX_LEAPFROGS = 128  # run_inference's hmc_max_leapfrogs


def _spec(leg, dtype, dev):
    if leg == "parity":
        from pioran_tpu_torch.examples import parity
        _, t, y, yerr, xbar, va = parity.load_dataset("single")
        return parity.build_spec("single", t, y, yerr, xbar, va, dev, dtype)
    sub, xbar, va = cs.load_subset()
    return tinf.single_bending_model(sub[:, 0], sub[:, 1], sub[:, 2], xbar, va, dtype=dtype,
                                     device=dev)


def _windows(x, w=25):
    x = np.asarray(x, np.float64)
    return [round(float(x[k:k + w].mean()), 6) for k in range(0, len(x), w)]


def run_seed(args, seed, dev):
    dtype = torch.float64 if args.float64 else torch.float32
    spec = _spec(args.leg, dtype, dev)
    cfg = LEGS[args.leg]
    C, W, S = cfg["num_chains"], cfg["num_warmup"], cfg["num_samples"]
    dim = spec.prior.dim
    t0 = time.time()
    gen = torch.Generator(device=dev).manual_seed(seed)
    z0 = tinf._chain_inits(spec, gen, C, "advi")
    advi_s = time.time() - t0
    if args.save_inits:
        np.save(args.save_inits, z0.double().cpu().numpy())
    transition, init = make_chees_transition(spec.logpost_batch, C, dim, dtype, dev, W,
                                             max_leapfrogs=MAX_LEAPFROGS, mass="dense")
    trace = {k: [] for k in ("step_size", "traj_length", "n_steps", "accept")}
    samples = []
    with bf16_products(dim) if args.bf16 else contextlib.nullcontext():
        state = init(z0)
        for it in range(W + S):
            state, (z, _, acc, n) = transition(state, it, it < W, gen)
            trace["step_size"].append(state["step_size"])
            trace["traj_length"].append(float(np.exp(state["log_tau"])))
            trace["n_steps"].append(n)
            trace["accept"].append(acc)
            if it >= W:
                samples.append(z)
    wall = time.time() - t0
    with torch.no_grad():
        chains_th = spec.prior.from_unconstrained(torch.stack(samples).transpose(0, 1))
    chains_th = chains_th.cpu().numpy()
    ncall = int(np.sum(trace["n_steps"])) * C
    ent = tinf._mcmc_entries(chains_th, ncall)
    pooled = chains_th.reshape(-1, dim)
    far = np.abs(chains_th.mean(1) - pooled.mean(0)) / pooled.std(0)
    ref = cs.referee()
    pulls = (pooled.mean(0) - np.asarray(ref["is_mean"])) / np.asarray(ref["is_std"])
    tag = f"{args.leg}_{'float64' if args.float64 else 'float32'}{'_bf16' if args.bf16 else ''}"
    out = {
        "seed": seed, "leg": args.leg, "dtype": str(dtype), "bf16": args.bf16,
        "wall": round(wall, 2), "advi_s": round(advi_s, 2), "ncall": ncall,
        "leapfrogs": ncall // C, "leapfrogs_per_it": round(ncall / C / (W + S), 3),
        "at_cap": int(np.sum(np.asarray(trace["n_steps"]) == MAX_LEAPFROGS)),
        "rhat_max": round(float(np.nanmax(ent["rhat"])), 4),
        "rhat": np.round(ent["rhat"], 4).tolist(), "ess": ent["ess"],
        "ess_per_mgrad": round(ent["ess"] / ncall * 1e6, 1),
        "chains_far_gt3sd": (far > 3).sum(0).tolist(), "pulls": np.round(pulls, 3).tolist(),
        "final_step_size": trace["step_size"][-1], "final_traj_length": trace["traj_length"][-1],
        "device": torch.cuda.get_device_name(0),
    }
    if args.trace:
        out["windows"] = {k: _windows(v) for k, v in trace.items()}
        d = os.path.join(ROOT, "chiprun_out", "chees_trace")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{tag}_s{seed}.json"), "w") as fh:
            json.dump({**out, "trace": trace}, fh)
    print(json.dumps(out), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("seeds", nargs="*", type=int)
    ap.add_argument("--leg", choices=sorted(LEGS), default="smoke")
    ap.add_argument("--float64", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--save-inits", default=None)
    args = ap.parse_args(argv)
    seeds = args.seeds or [0]
    if args.jobs > 1 and len(seeds) > 1:
        flags = [f for f, on in (("--float64", args.float64), ("--trace", args.trace),
                                 ("--bf16", args.bf16)) if on]
        procs, rc = [], 0
        for k, seed in enumerate(seeds):
            if len(procs) >= args.jobs:
                rc |= procs.pop(0).wait()
            extra = ["--save-inits", args.save_inits] if args.save_inits and k == 0 else []
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--leg",
                                           args.leg, *flags, *extra, str(seed)]))
        for p in procs:
            rc |= p.wait()
        return rc
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda")
    for seed in seeds:
        run_seed(args, seed, dev)
        args.save_inits = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
