"""CARMA(p, q) inference on a light curve, on the GPU.

The PyTorch counterpart of ``examples/carma.py`` (reference
docs/src/carma.md:63-200):

    python -m pioran_tpu_torch.examples.carma data.txt --p 2 --q 0 [--use-c]
        [--sampler ns|smc|nuts|chees|advi] [--particles 2048]
        [--dtype float32|float64] [--cpu] [--posterior-checks]

theta parameterizes the AR/MA quadratic factors as (u, b) with
u = c_quad - b^2/4, so the reference's root-band rejection holds with
prior probability 1 (see ``inference.carma_model``). Results land in
``inference/<name>_carma_p{p}q{q}/`` in the ultranest-style layout.

The run goes to the card; ``--cpu`` runs on the CPU, and without a card
and without ``--cpu`` it stops with ``RuntimeError``. ``--dtype`` stands
for the JAX script's ``--x64``. More GPUs: ``torchrun
--nproc_per_node=<n> -m pioran_tpu_torch.examples.carma data.txt
--mesh <n>``.
"""

import argparse
import os
import sys

from . import _common


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("data")
    ap.add_argument("--p", type=int, default=2)
    ap.add_argument("--q", type=int, default=0)
    ap.add_argument("--use-c", action="store_true",
                    help="fit the log-shift c: y -> log(y - c)")
    ap.add_argument("--sampler", default="ns",
                    choices=["ns", "smc", "nuts", "chees", "advi"])
    ap.add_argument("--particles", type=int, default=2048)
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--warmup", type=int, default=500)
    ap.add_argument("--samples", type=int, default=1000)
    ap.add_argument("--moves", type=int, default=12)
    ap.add_argument("--seed", type=int, default=123)
    _common.add_mesh_options(ap)
    _common.add_device_options(ap)
    ap.add_argument("--posterior-checks", action="store_true")
    return ap


def ppc_roots(sub, p: int, q: int):
    """(AR roots (P, p) complex128, MA coefficients (P, q + 1)) of the
    posterior rows ``sub`` (spec order): the conjugate pairs -b/2 +- i
    sqrt(u) of each (u, b) factor, the last root -r when p is odd, and the
    MA polynomial through ``models.carma.poly_from_conjugate_pairs``."""
    import numpy as np
    import torch

    from ..models.carma import poly_from_conjugate_pairs

    n_pairs = p // 2
    cols = []
    for k in range(n_pairs):
        u, b = sub[:, 2 * k], sub[:, 2 * k + 1]
        cols += [-b / 2 + 1j * np.sqrt(u), -b / 2 - 1j * np.sqrt(u)]
    if p % 2:
        cols.append(-sub[:, 2 * n_pairs] + 0j)
    ras = np.stack(cols, axis=-1)
    off = 2 * (p // 2) + (p % 2)
    if q > 0:
        th = torch.as_tensor(sub, dtype=torch.float64)
        pre = [-th[:, off + 2 * k + 1] / 2 for k in range(q // 2)]
        pim = [torch.sqrt(th[:, off + 2 * k]) for k in range(q // 2)]
        rr = [-th[:, off + 2 * (q // 2)]] if q % 2 else []
        betas = poly_from_conjugate_pairs(pre, pim, rr).numpy()
    else:
        betas = np.ones((len(sub), 1))
    return ras, betas


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    import numpy as np

    from ..inference import carma_model, run_inference
    from ..utils import extract_subset

    device, dtype, mesh = _common.setup(args)

    fname = os.path.basename(args.data).replace(
        ".txt", f"_carma_p{args.p}q{args.q}")
    out = os.path.join("inference", fname)
    os.makedirs(out, exist_ok=True)

    A = np.loadtxt(args.data, comments="#")
    t_all, y_all, yerr_all = A[:, 0], A[:, 1], A[:, 2]
    t, y, yerr, xbar, va = extract_subset(
        args.seed, os.path.join(out, fname), t_all, y_all, yerr_all
    )
    print(f"n={len(t)} xbar={xbar:.4f} va={va:.5f} "
          f"CARMA({args.p},{args.q}) use_c={args.use_c}")

    spec = carma_model(t, y, yerr, xbar, va, p=args.p, q=args.q,
                       use_c=args.use_c, device=device, dtype=dtype)

    print(f"Running {args.sampler} sampler...")
    results = run_inference(
        spec, sampler=args.sampler, seed=args.seed,
        mesh=mesh,
        num_particles=args.particles, num_chains=args.chains,
        num_warmup=args.warmup, num_samples=args.samples,
        num_moves=args.moves, log_dir=out,
    )
    _common.print_results(results, out, fmt="+.5g", logzerr=True)

    if args.posterior_checks:
        from ..diagnostics.ppc import plot_psd_ppc_carma

        print("Running CARMA PSD posterior predictive check...")
        sub = _common.ppc_subset(results["samples"])
        ras, betas = ppc_roots(sub, args.p, args.q)
        plot_psd_ppc_carma(
            ras, betas, sub[:, spec.names.index("variance")],
            sub[:, spec.names.index("ν")], t, y, yerr, p=args.p, q=args.q,
            path=_common.plots_dir(out),
            with_log_transform=True,
            make_figures=_common.figures_available(), device=spec.device,
        )
        print(f"  plots -> {os.path.join(out, 'plots')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
