#!/usr/bin/env python3
"""Run chip_smoke.py's ChEES configuration once per seed and print its
convergence per seed: the spread of r-hat, ESS and leapfrog count between
seeds, and the chains whose means sit far from the pooled mean.

Run from the repository root on a machine with one NVIDIA H100:

    python3 tools/chees_seeds.py [--float64] 0 1 2

Each seed prints one JSON line. ``--float64`` runs the model in float64
instead of chip_smoke.py's float32. Imports no JAX.
"""

import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from pioran_tpu_torch import run_inference, single_bending_model  # noqa: E402


def main(seeds, dtype):
    sub, xbar, va = cs.load_subset()
    spec = single_bending_model(sub[:, 0], sub[:, 1], sub[:, 2], xbar, va, dtype=dtype)
    ref = cs.referee()
    C, S = cs.CHEES["num_chains"], cs.CHEES["num_samples"]
    for seed in seeds:
        t0 = time.time()
        res = run_inference(spec, sampler="chees", init="advi", mass="dense", seed=seed,
                            **cs.CHEES)
        th = res["samples"].reshape(S, C, 6)
        pooled = th.reshape(-1, 6)
        far = np.abs(th.mean(0) - pooled.mean(0)) / pooled.std(0)
        pulls = (np.asarray(res["posterior"]["mean"]) - ref["is_mean"]) / np.asarray(ref["is_std"])
        print(json.dumps({
            "seed": seed, "wall": time.time() - t0, "leapfrogs": res["ncall"] // C,
            "ess": res["ess"], "rhat": np.round(res["rhat"], 4).tolist(),
            "ess_bulk": np.round(res["ess_bulk"], 0).tolist(),
            "chains_far_gt3sd": (far > 3).sum(0).tolist(),
            "max_far": far.max(0).round(2).tolist(), "pulls": np.round(pulls, 3).tolist(),
            "dtype": str(dtype), "device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    f64 = "--float64" in args
    main([int(x) for x in args if x != "--float64"] or [0],
         torch.float64 if f64 else torch.float32)
