"""Double-bending power-law PSD inference on a light curve, on the GPU.

The PyTorch counterpart of ``examples/double_pl.py`` (reference
examples/ultranest/double_pl.jl):

    python -m pioran_tpu_torch.examples.double_pl data.txt
        [--sampler ns|smc|nuts|chees|advi] [--dtype float32|float64] [--cpu]

8 parameters: (alpha_1, f_1, alpha_2, f_2, alpha_3, variance, nu, mu)
with ordered alphas and bend frequencies; log-transformed flux with
nu-scaled errors. Results land in ``inference/<name>_double/``.

The run goes to the card; ``--cpu`` runs on the CPU, and without a card
and without ``--cpu`` it stops with ``RuntimeError``. ``--dtype`` stands
for the JAX script's ``--x64``. More GPUs: ``torchrun
--nproc_per_node=<n> -m pioran_tpu_torch.examples.double_pl data.txt
--mesh <n>``.
"""

import argparse
import os
import sys

from . import _common


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("data")
    ap.add_argument("--sampler", default="ns", choices=["ns", "smc", "nuts", "chees", "advi"])
    ap.add_argument("--particles", type=int, default=2048)
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--warmup", type=int, default=500)
    ap.add_argument("--samples", type=int, default=1000)
    ap.add_argument("--moves", type=int, default=12)
    ap.add_argument("--move-kind", default="mala", choices=["rwm", "mala"])
    ap.add_argument("--components", type=int, default=20)
    ap.add_argument("--basis", default="SHO", choices=["SHO", "DRWCelerite"])
    ap.add_argument("--seed", type=int, default=123)
    _common.add_mesh_options(ap)
    _common.add_device_options(ap)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--posterior-checks", action="store_true")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    import numpy as np

    from ..inference import double_bending_model, run_inference
    from ..utils import extract_subset

    device, dtype, mesh = _common.setup(args)

    base = os.path.basename(args.data).replace(".txt", "_double")
    out = os.path.join("inference", base)
    os.makedirs(out, exist_ok=True)

    A = np.loadtxt(args.data, comments="#")
    t, y, yerr, xbar, va = extract_subset(
        args.seed, os.path.join(out, base), A[:, 0], A[:, 1], A[:, 2]
    )
    print(f"n={len(t)} xbar={xbar:.4f} va={va:.5f}")

    spec = double_bending_model(
        t, y, yerr, xbar, va,
        n_components=args.components, basis_function=args.basis,
        device=device, dtype=dtype,
    )

    print(f"Running {args.sampler} sampler...")
    results = run_inference(
        spec, sampler=args.sampler, seed=args.seed,
        mesh=mesh,
        num_particles=args.particles, num_chains=args.chains,
        num_warmup=args.warmup, num_samples=args.samples,
        num_moves=args.moves, smc_move=args.move_kind,
        log_dir=out, resume=args.resume,
    )
    _common.print_results(results, out)

    if args.posterior_checks:
        from ..diagnostics import run_posterior_predict_checks

        # spec order (a1,a2,a3,f1,f2,...) -> reference order (a1,f1,a2,f2,a3,...)
        perm = [0, 3, 1, 4, 2, 5, 6, 7]
        inv = [0, 2, 4, 1, 3, 5, 6, 7]
        sub = _common.ppc_subset(results["samples"])[:, perm]
        names = ["α₁", "f₁", "α₂", "f₂", "α₃", "variance", "ν", "μ"]

        def gp_model(tt, yy, ee, params):
            return spec.gp_model(tt, yy, ee, params[..., inv])

        run_posterior_predict_checks(
            sub, names, spec.paramnames_split, t, y, yerr,
            spec.psd_model, gp_model, True,
            path=_common.plots_dir(out),
            basis_function=args.basis, n_components=args.components,
            n_samples=min(100, len(sub)),
            make_figures=_common.figures_available(), device=spec.device,
            dtype=spec.dtype,
        )
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
