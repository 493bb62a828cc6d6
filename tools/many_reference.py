#!/usr/bin/env python3
"""Hold the port's ``run_inference_many`` against the JAX package's on the
same inputs: the light curves of chip_smoke.py's phase 12 (dataset 0 is
the reference's 485-point subset), J = 20, float32, prior starts and a
diagonal metric, as both packages run it.

Run from the repository root:

    python3 tools/many_reference.py port --datasets 16 --seeds 0 1 2
    JAX_PLATFORMS=cpu python3 tools/many_reference.py jax --datasets 1 --seeds 0

``port`` runs ``pioran_tpu_torch.run_inference_many`` on the card;
``jax`` runs ``pioran_tpu.inference.run_inference_many`` where JAX runs
(on the CPU it evaluates the likelihood by its masked scan).
``--datasets`` keeps the first D light curves, so ``--datasets 1`` is
dataset 0 alone. Each seed prints one JSON line: leapfrogs, wall
seconds, every dataset's r̂_max and minimum bulk ESS, and dataset 0
against the importance-sampling referee: the pulls and width ratios of
the pooled draws, and the share of its chains whose median f_1 sits more
than 5 referee sd from the referee mean (chains left on an f_1 plateau).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def summary(results, C, ref):
    """The JSON fields of one run from its per-dataset results."""
    mean, sd = np.asarray(ref["is_mean"]), np.asarray(ref["is_std"])
    draws = np.asarray(results[0]["samples"])
    chains = draws.reshape(C, -1, 6)  # the samples are chain-major
    far = np.abs(np.median(chains[:, :, 2], axis=1) - mean[2]) > 5 * sd[2]
    rhat = [round(float(np.nanmax(r["rhat"])), 4) for r in results]
    return {
        "rhat_max": rhat,
        "ess_min": [round(float(r["ess"]), 1) for r in results],
        "converged": int(sum(x < 1.05 for x in rhat)),
        "ds0_pulls": np.round((draws.mean(0) - mean) / sd, 4).tolist(),
        "ds0_widths": np.round(draws.std(0) / sd, 4).tolist(),
        "ds0_stranded_chains": round(float(far.mean()), 4),
    }


def run_port(datasets, seed, cfg):
    import torch

    from pioran_tpu_torch import run_inference_many

    res = run_inference_many(datasets, seed=seed, dtype=torch.float32, **cfg)
    return res, torch.cuda.get_device_name(0)


def run_jax(datasets, seed, cfg):
    import jax

    from pioran_tpu.inference import run_inference_many

    res = run_inference_many(datasets, key=jax.random.PRNGKey(seed), **cfg)
    return res, jax.devices()[0].device_kind


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("impl", choices=("port", "jax"))
    ap.add_argument("--datasets", type=int, default=cs.MANY_D)
    ap.add_argument("--chains", type=int, default=cs.MANY["num_chains"])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = ap.parse_args(argv)
    datasets = cs.many_datasets()[:args.datasets]
    cfg = dict(cs.MANY, num_chains=args.chains)
    run = run_port if args.impl == "port" else run_jax
    for seed in args.seeds:
        t0 = time.perf_counter()
        res, kind = run(datasets, seed, cfg)
        wall = time.perf_counter() - t0
        print(json.dumps({
            "impl": args.impl, "device": kind, "seed": seed, "datasets": len(datasets),
            **cfg, "leapfrogs": res[0]["ncall"] // args.chains, "wall_s": round(wall, 2),
            **summary(res, args.chains, cs.referee())}), flush=True)


if __name__ == "__main__":
    main()
