"""Single-bending power-law PSD inference on a light curve, on the GPU.

The PyTorch counterpart of ``examples/single_pl.py`` (reference
examples/ultranest/single_pl.jl):

    python -m pioran_tpu_torch.examples.single_pl data.txt
        [--sampler ns|smc|nuts|chees|advi] [--hmc-stepped] [--particles 2048]
        [--chains 16] [--dtype float32|float64] [--cpu] [--prior-checks]
        [--posterior-checks]

The file must have three columns: time, flux, flux error. Results land in
``inference/<name>_single/`` (chains/equal_weighted_post.txt +
info/results.json, ultranest-compatible layout) and plots in
``inference/<name>_single/plots/``.

The run goes to the card; ``--cpu`` runs on the CPU, and without a card
and without ``--cpu`` it stops with ``RuntimeError``. ``--dtype`` stands
for the JAX script's ``--x64``. ``--hmc-stepped`` is the JAX script's
switch to its host-stepped ChEES and NUTS drivers; the port's samplers
step from the host already, so it gives the same run (and, as there,
refuses ``--mesh``). More GPUs: ``torchrun --nproc_per_node=<n> -m
pioran_tpu_torch.examples.single_pl data.txt --mesh <n>`` (one process a
GPU), or ``--distributed`` on several nodes.
"""

import argparse
import os
import sys

from . import _common


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("data")
    ap.add_argument("--sampler", default="ns", choices=["ns", "smc", "nuts", "chees", "advi"])
    ap.add_argument("--init", default="prior", choices=["prior", "advi"],
                    help="chain inits for nuts/chees: raw prior draws, "
                    "or dispersed ADVI-seeded (advi_seeded_inits)")
    ap.add_argument("--mass", default="diag", choices=["diag", "dense"],
                    help="ChEES metric: diagonal, or full cross-chain "
                    "covariance (preconditions correlated ridges)")
    ap.add_argument("--hmc-stepped", action="store_true",
                    help="host-stepped ChEES and NUTS, as the JAX script's "
                    "(the port's samplers step from the host already: the "
                    "same run)")
    ap.add_argument("--particles", type=int, default=2048)
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--warmup", type=int, default=500)
    ap.add_argument("--samples", type=int, default=1000)
    ap.add_argument("--moves", type=int, default=12)
    ap.add_argument("--move-kind", default="mala", choices=["rwm", "mala"])
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--components", type=int, default=20)
    ap.add_argument("--basis", default="SHO", choices=["SHO", "DRWCelerite"])
    ap.add_argument("--use-c", action="store_true",
                    help="fit a flux offset c with the log(y - c) "
                    "transform (the reference docs workflow, "
                    "docs/src/single_pl.jl:63-100)")
    ap.add_argument("--alpha1-max", type=float, default=1.5)
    ap.add_argument("--variance-norm", action="store_true",
                    help="normalise the approximation by total variance "
                    "instead of band-integrated power")
    ap.add_argument("--seed", type=int, default=123)
    _common.add_mesh_options(ap)
    _common.add_device_options(ap)
    ap.add_argument("--prior-checks", action="store_true")
    ap.add_argument("--posterior-checks", action="store_true")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    import numpy as np
    import torch

    from ..inference import run_inference, single_bending_model
    from ..utils import extract_subset

    device, dtype, mesh = _common.setup(args)

    fname = os.path.basename(args.data).replace(".txt", "_single")
    out = os.path.join("inference", fname)
    os.makedirs(out, exist_ok=True)

    A = np.loadtxt(args.data, comments="#")
    t_all, y_all, yerr_all = A[:, 0], A[:, 1], A[:, 2]
    t, y, yerr, xbar, va = extract_subset(
        args.seed, os.path.join(out, fname), t_all, y_all, yerr_all
    )
    print(f"n={len(t)} xbar={xbar:.4f} va={va:.5f}")

    spec = single_bending_model(
        t, y, yerr, xbar, va,
        n_components=args.components, basis_function=args.basis,
        use_c=args.use_c, alpha1_max=args.alpha1_max,
        is_integrated_power=not args.variance_norm,
        device=device, dtype=dtype,
    )
    figures = (args.prior_checks or args.posterior_checks) and _common.figures_available()

    if args.prior_checks:
        from ..diagnostics import run_diagnostics

        print("Running prior predictive checks...")
        gen = torch.Generator(device=spec.device).manual_seed(args.seed)
        draws = spec.prior.sample((1000,), generator=gen, dtype=spec.dtype,
                                  device=spec.device).cpu().numpy()
        # columns in model order (alpha_1, f_1, alpha_2)
        psd_params = np.vstack([draws[:, 0], draws[:, 2], draws[:, 1]])
        run_diagnostics(
            psd_params, draws[:, 3], spec.f_min, spec.f_max,
            spec.psd_model, path=_common.plots_dir(out),
            basis_function=args.basis, n_components=args.components,
            make_figures=figures, device=spec.device, dtype=spec.dtype,
        )

    print(f"Running {args.sampler} sampler...")
    results = run_inference(
        spec, sampler=args.sampler, seed=args.seed,
        mesh=mesh,
        num_particles=args.particles, num_chains=args.chains,
        num_warmup=args.warmup, num_samples=args.samples,
        num_moves=args.moves, smc_move=args.move_kind,
        log_dir=out, resume=args.resume,
        init=args.init, mass=args.mass, hmc_stepped=args.hmc_stepped,
    )
    _common.print_results(results, out)

    if args.posterior_checks:
        from ..diagnostics import run_posterior_predict_checks

        print("Running posterior predictive checks...")
        # reporting order for PPC: model wants (a1, f1, a2) columns
        perm = [0, 2, 1, 3, 4, 5] + ([6] if args.use_c else [])
        inv = np.argsort(np.asarray(perm)).tolist()  # back to spec order
        sub = _common.ppc_subset(results["samples"][:, perm])
        ppc_names = ["α₁", "f₁", "α₂", "variance", "ν", "μ"] + (
            ["c"] if args.use_c else [])

        def gp_model(tt, yy, ee, params):
            return spec.gp_model(tt, yy, ee, params[..., inv])

        run_posterior_predict_checks(
            sub, ppc_names, spec.paramnames_split, t, y, yerr,
            spec.psd_model, gp_model, True,
            path=_common.plots_dir(out),
            basis_function=args.basis, n_components=args.components,
            n_samples=min(100, len(sub)),
            make_figures=figures, device=spec.device, dtype=spec.dtype,
        )
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
