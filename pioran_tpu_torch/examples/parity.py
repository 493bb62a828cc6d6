"""End-to-end posterior-parity runs on the GPU, with committed artifacts.

The PyTorch counterpart of ``examples/tpu_parity.py``. Reruns the
reference's three flagship nested-sampling analyses (reference
examples/ultranest/inference/{simu_single,simu_double,
simu_periodic_rednoise_123_factor}/info/results.json) and the docs
workflow ON the card in float32, on the exact cached data subsets
ultranest saw, and writes ultranest-layout artifacts plus a
machine-checkable summary:

    python -m pioran_tpu_torch.examples.parity --out artifacts/torch_parity \\
        [--datasets single,double,periodic,docs,carma,longn]
        [--samplers ns,smc,chees] [--particles 1024] [--seed 7]

Artifacts: ``<out>/<dataset>_<sampler>/chains/equal_weighted_post.txt``,
``.../info/results.json``, and ``<out>/summary.json`` holding, per run,
the logZ difference and per-parameter posterior-mean pulls vs the stored
baselines (tests/data/*/results.json), the pulls and width ratios against
the importance-sampling referees, and the card's name and power limit.
tests/test_torch_artifacts.py validates the committed summary against
the acceptance gates. Exits 1 unless every run in the summary passes.

The data come from the repository's ``tests/data``, so run it from a
checkout. ChEES and NUTS run with ADVI-seeded inits and
``hmc_stepped=True``, ChEES with the dense metric, as the JAX script's;
in the port that switch gives the same run as without it.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TESTDATA = os.path.join(ROOT, "tests", "data")
DTYPE = "float32"  # parity is proven in float32, the card's working dtype

# stored-order -> spec-order permutations (see tests/test_parity_models.py)
DATASETS = {
    "single": dict(
        dir="simu_single", subset="simu_single_subset_time_series.txt",
        perm=[0, 2, 1, 3, 4, 5], logz_tol=1.0, pull_tol=0.75,
    ),
    "double": dict(
        dir="simu_double", subset="simu_double_subset_time_series.txt",
        perm=[0, 2, 4, 1, 3, 5, 6, 7], logz_tol=1.2, pull_tol=1.0,
    ),
    "periodic": dict(
        dir="simu_periodic",
        subset="simu_periodic_rednoise_subset_time_series.txt",
        perm=[0, 2, 1, 3, 4, 5, 6, 7, 8], logz_tol=1.5, pull_tol=1.0,
    ),
    # the reference docs workflow: 7 params incl. flux offset c,
    # variance-normalised approximation (docs/src/data/inference)
    "docs": dict(
        dir="simu_docs", subset="subset_time_series.txt",
        perm=[0, 2, 1, 3, 4, 5, 6], logz_tol=1.0, pull_tol=1.0,
        kwargs=dict(use_c=True, alpha1_max=1.25, is_integrated_power=False),
    ),
}


def testdata(*parts) -> str:
    """A path under the repository's tests/data, or FileNotFoundError when
    the package runs outside a checkout that has it."""
    if not os.path.isdir(TESTDATA):
        raise FileNotFoundError(
            f"the parity runs read the reference's stored results and light curves "
            f"from the repository's tests/data, which is not at {TESTDATA}: run "
            f"from a checkout of the repository")
    return os.path.join(TESTDATA, *parts)


def _mean_va(path):
    """The (xbar, va) of a light curve's ``#mean: <xbar> va: <va>`` line."""
    with open(path) as fh:
        for line in fh:
            if line.startswith("#mean: "):
                left, right = line[len("#mean: "):].split(" va: ")
                return float(left), float(right)
    return None, None


def load_dataset(name):
    import numpy as np

    cfg = DATASETS[name]
    d = testdata(cfg["dir"])
    with open(os.path.join(d, "results.json")) as fh:
        stored = json.load(fh)
    path = os.path.join(d, cfg["subset"])
    A = np.loadtxt(path)
    xbar, va = _mean_va(path)
    return stored, A[:, 0], A[:, 1], A[:, 2], xbar, va


def load_longn():
    """The committed N = 2^14 synthetic light curve
    (tests/tools/make_longn.py): (t, y, yerr, xbar, va, truth)."""
    import numpy as np

    path = testdata("simu_longn", "longn_time_series.txt")
    A = np.loadtxt(path)
    truth = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("#truth: "):
                for kv in line[len("#truth: "):].split():
                    k, v = kv.split("=")
                    truth[k] = float(v)
    xbar, va = _mean_va(path)
    return A[:, 0], A[:, 1], A[:, 2], xbar, va, truth


def load_referee(name):
    """The committed importance-sampling referee for this dataset, if
    any (tests/tools/is_referee.py). The referee is the width/mean
    ground truth: on simu_single it showed the STORED ultranest run's
    f1 width is 0.61x the true posterior width (~30 IS standard errors
    low) while the samplers sit within a few % — so parity gates widths
    against the referee, not the stored run."""
    path = testdata(DATASETS[name]["dir"], "is_referee.json")
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        ref = json.load(fh)
    # an IS referee is only trustworthy with real effective sample size
    return ref if ref.get("ess", 0.0) > 500.0 else None


def build_spec(name, t, y, yerr, xbar, va, device, dtype):
    from ..inference import double_bending_model, periodic_rednoise_model, single_bending_model

    builders = {
        "single": single_bending_model,
        "double": double_bending_model,
        "periodic": periodic_rednoise_model,
        "docs": single_bending_model,
    }
    kwargs = DATASETS[name].get("kwargs", {})
    return builders[name](t, y, yerr, xbar, va, device=device, dtype=dtype, **kwargs)


def power_limit(device):
    """The card's power limit as nvidia-smi prints it ("700.00 W"), or None
    where nvidia-smi does not answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def device_record(device):
    """The summary's platform entries for the run's device."""
    import platform

    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "device_kind": torch.cuda.get_device_name(device),
                "power_limit": power_limit(device)}
    return {"platform": "cpu", "device_kind": platform.processor() or platform.machine(),
            "power_limit": None}


def run_carma(args, summary, device, dtype):
    """CARMA(2,1) self-consistency parity (no stored reference posterior
    exists for CARMA — reference test/test_carma.jl:62-69 pins only
    coefficients, docs/src/carma.md only the workflow). Gates: NS and
    SMC agree on logZ (within combined logzerr-scale tolerance) and on
    every posterior moment (cross-sampler pull < 0.5 combined sd,
    width ratios in [0.75, 1.33]); the ML point is re-checkable on CPU
    f64 by tests/test_torch_artifacts.py."""
    import numpy as np

    from ..inference import carma_model, run_inference

    stored, t, y, yerr, xbar, va = load_dataset("single")
    spec = carma_model(t, y, yerr, xbar, va, p=2, q=1, device=device, dtype=dtype)
    results = {}
    for sampler in ("ns", "smc"):
        tag = f"carma_{sampler}"
        log_dir = os.path.join(args.out, tag)
        print(f"== {tag}: N={len(t)} params={len(spec.names)} CARMA(2,1)")
        t0 = time.time()
        res = run_inference(
            spec, sampler=sampler, seed=args.seed,
            num_particles=args.particles, num_moves=args.moves,
            num_ns_mcmc=args.ns_mcmc,
            log_dir=log_dir, resume=args.resume,
        )
        res["wall_s"] = time.time() - t0
        results[sampler] = res

    m_ns = np.asarray(results["ns"]["posterior"]["mean"])
    m_smc = np.asarray(results["smc"]["posterior"]["mean"])
    s_ns = np.asarray(results["ns"]["posterior"]["stdev"])
    s_smc = np.asarray(results["smc"]["posterior"]["stdev"])
    comb = np.sqrt(s_ns**2 + s_smc**2)
    cross_pull = np.abs(m_ns - m_smc) / comb
    width_ratio = s_ns / s_smc
    logz_diff = results["ns"]["logz"] - results["smc"]["logz"]
    ok = (abs(logz_diff) < 1.5
          and float(cross_pull.max()) < 0.5
          and bool(np.all((width_ratio > 0.75) & (width_ratio < 1.33))))
    for sampler in ("ns", "smc"):
        res = results[sampler]
        entry = {
            "dataset": "carma", "sampler": sampler, "pq": [2, 1],
            "n_points": int(len(t)),
            "wall_s": round(res["wall_s"], 2),
            "logz": res["logz"],
            "logz_diff_cross_sampler": logz_diff,
            "cross_sampler_max_pull": float(cross_pull.max()),
            "cross_sampler_pulls": cross_pull.round(4).tolist(),
            "cross_sampler_width_ratio": width_ratio.round(4).tolist(),
            "ess": res.get("ess"),
            "ncall": res.get("ncall"),
            "ml_logl": res["maximum_likelihood"]["logl"],
            "ml_point": res["maximum_likelihood"]["point"],
            "paramnames": spec.names,
            "pass": bool(ok),
        }
        if sampler == "ns" and "insertion_order_MWW_test" in res:
            entry["insertion_order_MWW_test"] = res[
                "insertion_order_MWW_test"]
        summary["runs"][f"carma_{sampler}"] = entry
    print(f"   carma: logz_ns-logz_smc {logz_diff:+.3f} max cross pull "
          f"{cross_pull.max():.3f} -> {'PASS' if ok else 'FAIL'}")


def run_longn(args, summary, device, dtype):
    """Long-N f32 parity: SMC on the committed N = 2^14 synthetic light
    curve (tests/tools/make_longn.py, known generative truth) on the card
    in f32. Gates: the posterior covers the truth (pulls < 4 sd — a
    single realisation can legitimately sit 2-3 sd out on some axis) and
    the ML-point likelihood recomputes on CPU f64 to within 1 nat
    (tests/test_torch_artifacts.py) — the long-series accuracy the
    Kahan-compensated kernels buy."""
    import numpy as np

    from ..inference import run_inference, single_bending_model

    t, y, yerr, xbar, va, truth = load_longn()
    spec = single_bending_model(t, y, yerr, xbar, va, device=device, dtype=dtype)
    tag = "longn_smc"
    print(f"== {tag}: N={len(t)} (long-N f32 gate)")
    t0 = time.time()
    res = run_inference(
        spec, sampler="smc", seed=args.seed,
        num_particles=args.particles, num_moves=args.moves,
        smc_move="rwm", log_dir=os.path.join(args.out, tag),
    )
    wall = time.time() - t0
    mean = np.asarray(res["posterior"]["mean"])
    std = np.asarray(res["posterior"]["stdev"])
    tv = np.asarray([truth["alpha1"], truth["alpha2"], truth["f1"],
                     truth["variance"], truth["nu"], truth["mu"]])
    pull_truth = np.abs(mean - tv) / std
    ok = bool(np.all(pull_truth < 4.0))
    entry = {
        "dataset": "longn", "sampler": "smc", "n_points": int(len(t)),
        "wall_s": round(wall, 2),
        "logz": res["logz"],
        "truth_spec_order": tv.tolist(),
        "pull_vs_truth": pull_truth.round(3).tolist(),
        "max_pull_vs_truth": float(pull_truth.max()),
        "ml_logl": res["maximum_likelihood"]["logl"],
        "ml_point": res["maximum_likelihood"]["point"],
        "ncall": res.get("ncall"),
        "pass": ok,
    }
    summary["runs"][tag] = entry
    print(f"   longn: max pull vs truth {pull_truth.max():.2f} "
          f"wall {wall:.1f}s -> {'PASS' if ok else 'FAIL'}")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="artifacts/torch_parity")
    ap.add_argument("--datasets", default="single,double,periodic")
    ap.add_argument("--samplers", default="ns")
    ap.add_argument("--particles", type=int, default=1024)
    ap.add_argument("--moves", type=int, default=12)
    ap.add_argument("--ns-mcmc", type=int, default=8,
                    help="slice updates per NS replacement; raise when "
                    "the insertion-order MWW test flags under-mixed "
                    "replacement chains")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--chains", type=int, default=512,
                    help="ChEES/NUTS chain count for --samplers chees")
    ap.add_argument("--warmup", type=int, default=500)
    ap.add_argument("--nsamples", type=int, default=300)
    ap.add_argument("--resume", action="store_true",
                    help="checkpoint NS and SMC runs under <out>/<run>/checkpoints "
                    "and resume them from there when run again")
    return ap


def main(argv=None, *, device=None) -> int:
    """Runs the parity legs and writes ``<out>/summary.json``; 0 when every
    run in it passes. ``device``: the card by default (``RuntimeError``
    without one); ``device="cpu"`` for a check of the CLI itself."""
    args = parser().parse_args(argv)

    import numpy as np
    import torch

    from ..config import resolve_device
    from ..inference import run_inference

    device = resolve_device(device)
    dtype = getattr(torch, DTYPE)
    record = device_record(device)
    print(f"running on: {record['platform']} / {record['device_kind']} "
          f"power limit {record['power_limit']}")

    os.makedirs(args.out, exist_ok=True)
    spath = os.path.join(args.out, "summary.json")
    summary = {
        **record,
        "torch_version": torch.__version__,
        "dtype": DTYPE,
        "seed": args.seed,
        "particles": args.particles,
        "runs": {},
    }
    if os.path.exists(spath):
        # merge: keep prior runs (datasets are run incrementally)
        with open(spath) as fh:
            prev = json.load(fh)
        if prev.get("platform") == summary["platform"]:
            summary["runs"].update(prev.get("runs", {}))

    def write():
        # incremental write: a crash must not lose completed runs
        with open(spath, "w") as fh:
            json.dump(summary, fh, indent=2)

    for name in args.datasets.split(","):
        if name in ("carma", "longn"):
            (run_carma if name == "carma" else run_longn)(args, summary, device, dtype)
            write()
            continue
        stored, t, y, yerr, xbar, va = load_dataset(name)
        spec = build_spec(name, t, y, yerr, xbar, va, device, dtype)
        cfg = DATASETS[name]
        for sampler in args.samplers.split(","):
            tag = f"{name}_{sampler}"
            log_dir = os.path.join(args.out, tag)
            print(f"== {tag}: N={len(t)} params={len(spec.names)}")
            if sampler in ("chees", "nuts"):
                # the gradient-path parity leg: DISPERSED inits from an
                # overdispersed ADVI fit (no warm-start crutch), with the
                # JAX script's hmc_stepped (the same run here); ChEES
                # additionally gets the dense cross-chain metric (a
                # ChEES-only knob). Gates add rhat_max <= 1.02 on top of
                # the referee pull/width gates.
                kw = dict(num_chains=args.chains, num_warmup=args.warmup,
                          num_samples=args.nsamples, init="advi", hmc_stepped=True)
                if sampler == "chees":
                    kw.update(mass="dense")
            else:
                kw = dict(num_particles=args.particles,
                          num_moves=args.moves, num_ns_mcmc=args.ns_mcmc,
                          resume=args.resume)
            t0 = time.time()
            res = run_inference(spec, sampler=sampler, seed=args.seed,
                                log_dir=log_dir, **kw)
            wall = time.time() - t0
            ours_mean = np.asarray(res["posterior"]["mean"])
            ours_std = np.asarray(res["posterior"]["stdev"])
            inv = np.argsort(cfg["perm"])
            ref_mean = np.asarray(stored["posterior"]["mean"])
            ref_std = np.asarray(stored["posterior"]["stdev"])
            pull = np.abs(ours_mean[inv] - ref_mean) / ref_std
            width_ratio = ours_std[inv] / ref_std
            entry = {
                "dataset": name,
                "sampler": sampler,
                "n_points": int(len(t)),
                "wall_s": round(wall, 2),
                "logz": res.get("logz"),
                "logz_ref": stored["logz"],
                "logz_diff": (None if res.get("logz") is None
                              else res["logz"] - stored["logz"]),
                "logz_tol": cfg["logz_tol"],
                "max_pull": float(pull.max()),
                "pulls": pull.round(4).tolist(),
                "pull_tol": cfg["pull_tol"],
                "width_ratio": width_ratio.round(4).tolist(),
                "ess": res.get("ess"),
                "ncall": res.get("ncall"),
                "ml_logl": res["maximum_likelihood"]["logl"],
                "ml_logl_ref": stored["maximum_likelihood"]["logl"],
            }
            if sampler == "ns" and "insertion_order_MWW_test" in res:
                entry["insertion_order_MWW_test"] = res[
                    "insertion_order_MWW_test"]
            if sampler in ("chees", "nuts"):
                rhat = np.asarray(res["rhat"], np.float64)
                entry["rhat_max"] = float(np.nanmax(rhat))
                entry["rhat"] = res["rhat"]
                entry["ess_bulk"] = res["ess_bulk"]
                entry["ess_tail"] = res["ess_tail"]
                entry["ess_per_s"] = res.get("ess_per_s")
                entry["init"] = "advi-dispersed"
                if sampler == "chees":
                    entry["mass"] = kw["mass"]
                entry["num_chains"] = args.chains
            referee = load_referee(name)
            if referee is not None:
                is_mean = np.asarray(referee["is_mean"])
                is_std = np.asarray(referee["is_std"])
                entry["referee_ess"] = referee["ess"]
                entry["pull_vs_referee"] = (
                    np.abs(ours_mean - is_mean) / is_std).round(4).tolist()
                entry["max_pull_referee"] = float(
                    np.max(np.abs(ours_mean - is_mean) / is_std))
                entry["width_ratio_referee"] = (
                    ours_std / is_std).round(4).tolist()
            # stored-mean pull tolerance: the stored run's mean carries
            # its OWN bias (the referee measures it: up to 0.49 sd on
            # simu_single), so with a referee present the stored gate
            # widens by that demonstrated bias and the authoritative
            # mean/width gates move to the referee (tight: 0.5 sd /
            # [0.8, 1.25]).
            stored_tol = cfg["pull_tol"]
            if referee is not None:
                stored_tol += float(referee["max_stored_pull"])
            entry["pull_tol_effective"] = stored_tol
            ok = (entry["logz_diff"] is None
                  or abs(entry["logz_diff"]) < cfg["logz_tol"]) and \
                entry["max_pull"] < stored_tol
            if "rhat_max" in entry:
                # gradient-sampler convergence gate, from DISPERSED inits
                ok = ok and entry["rhat_max"] <= 1.02
            if referee is not None:
                wrr = np.asarray(entry["width_ratio_referee"])
                ok = ok and entry["max_pull_referee"] < 0.5
                # width gate [0.8, 1.25] widened by 3 IS standard errors
                # of the referee's own std estimate (~sd/sqrt(2 ESS);
                # optimistic for heavy-tailed IS weights, hence 3):
                # a 522-ESS referee cannot adjudicate widths to 2%
                rse = 3.0 / np.sqrt(2.0 * float(referee["ess"]))
                w_lo, w_hi = 0.8 * (1.0 - rse), 1.25 * (1.0 + rse)
                entry["width_gate_referee"] = [round(w_lo, 4),
                                               round(w_hi, 4)]
                ok = ok and bool(np.all((wrr > w_lo) & (wrr < w_hi)))
            entry["pass"] = bool(ok)
            summary["runs"][tag] = entry
            print(f"   logZ {entry['logz']} (ref {entry['logz_ref']}, "
                  f"diff {entry['logz_diff']}) max_pull {entry['max_pull']:.3f}"
                  f" wall {wall:.1f}s -> {'PASS' if ok else 'FAIL'}")
            write()

    write()
    n_pass = sum(r["pass"] for r in summary["runs"].values())
    print(f"{n_pass}/{len(summary['runs'])} runs pass -> {args.out}/summary.json")
    return 0 if n_pass == len(summary["runs"]) else 1


if __name__ == "__main__":
    sys.exit(main())
