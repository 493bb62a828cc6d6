#!/usr/bin/env python3
"""Hold the JAX package's log-posterior gradients of the model builders
against central finite differences on the CPU, beside the port's.

Run from the repository root:

    JAX_PLATFORMS=cpu python3 tools/jax_grad_check.py [--points 485 64]

For each model (double-bending, periodic in red noise, CARMA(2,1),
CARMA(3,2) with the flux offset c, CARMA(4,1)) and each light-curve
length, 4 rows from unit-cube points in [0.1, 0.9] (numpy seed 7) go
through ``logpost_unconstrained`` of the JAX spec. It prints one JSON
line a case with the largest 2-norm relative error per row, against
central differences (step 1e-6 in unconstrained space) of the jitted
JAX log-posterior, of:

- ``jit_vmap``: ``jax.jit(jax.vmap(jax.grad(f)))`` over the 4 rows;
- ``jit_row``: ``jax.jit(jax.grad(f))`` row by row;
- ``port``: the port's ``batch_value_and_grad`` of ``logpost_batch``
  (float64, the CPU: the kernels' plain versions).

Eager ``jax.grad`` is not run: on CARMA(3,2) it aborted the process
with a corrupted heap (jax 0.9.0, the CPU).
"""

import argparse
import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pioran_tpu import inference as jinf  # noqa: E402
from pioran_tpu_torch import inference as tinf  # noqa: E402
from pioran_tpu_torch.samplers.chees import batch_value_and_grad  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "data")
CASES = {
    "double": (("simu_double", "simu_double_subset_time_series.txt"),
               "double_bending_model", {}),
    "periodic": (("simu_periodic", "simu_periodic_rednoise_subset_time_series.txt"),
                 "periodic_rednoise_model", {}),
    "carma21": (("simu_single", "simu_single_subset_time_series.txt"), "carma_model",
                {"p": 2, "q": 1}),
    "carma32c": (("simu_single", "simu_single_subset_time_series.txt"), "carma_model",
                 {"p": 3, "q": 2, "use_c": True}),
    "carma41": (("simu_single", "simu_single_subset_time_series.txt"), "carma_model",
                {"p": 4, "q": 1}),
}


def load(parts, n):
    path = os.path.join(DATA, *parts)
    with open(path) as fh:
        for line in fh:
            if line.startswith("#mean: "):
                left, right = line[len("#mean: "):].split(" va: ")
                xbar, va = float(left), float(right)
                break
    A = np.loadtxt(path)[:n]
    return A[:, 0], A[:, 1], A[:, 2], xbar, va


def rel(g, ref):
    return float(np.max(np.linalg.norm(g - ref, axis=1) / np.linalg.norm(ref, axis=1)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, nargs="+", default=[485, 64])
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    for name, (parts, builder, kw) in CASES.items():
        for n in args.points:
            data = load(parts, n)
            jspec = getattr(jinf, builder)(*data, **kw)
            tspec = getattr(tinf, builder)(*data, device="cpu", **kw)
            U = np.random.default_rng(7).uniform(0.1, 0.9, (4, jspec.prior.dim))
            Z = np.asarray(jax.vmap(jspec.prior.to_unconstrained)(
                jax.vmap(jspec.prior.transform)(jnp.asarray(U))))
            f = jax.jit(jax.vmap(jspec.logpost_unconstrained))
            E = 1e-6 * np.eye(Z.shape[1])
            fd = np.stack([(np.asarray(f(jnp.asarray(z + E))) - np.asarray(f(jnp.asarray(z - E))))
                           / 2e-6 for z in Z])
            g_vmap = np.asarray(jax.jit(jax.vmap(jax.grad(jspec.logpost_unconstrained)))(
                jnp.asarray(Z)))
            g1 = jax.jit(jax.grad(jspec.logpost_unconstrained))
            g_row = np.stack([np.asarray(g1(jnp.asarray(z))) for z in Z])
            _, g_port = batch_value_and_grad(tspec.logpost_batch, torch.tensor(Z))
            print(json.dumps({"model": name, "points": n, "jit_vmap": rel(g_vmap, fd),
                              "jit_row": rel(g_row, fd), "port": rel(g_port.numpy(), fd)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
