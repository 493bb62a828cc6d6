#!/usr/bin/env python3
"""The wide celerite kernels' times on the card (J > 32, ``csrc/celerite_wide.cu``):
K0 (tables), K1, K2 (ragged per-lane grids), K3 and K4 at J in {40, 64, 70,
100, 128}, B in {128, 512, 1024}, N = 485, float32 and float64.

    python3 tools/wide_times.py [ROOT]              # one tree
    python3 tools/wide_times.py --old OLD_ROOT      # OLD_ROOT against this tree
    python3 tools/wide_times.py --ks [ROOT]         # K4 at every sub-chunk that fits
    python3 tools/wide_times.py --bounds            # each cell's bound (no card needed)
    [--terms 40 64] [--batches 512] [--dtypes float32] [--kernels K0 K3 K4]  # a part of the grid

ROOT (default: this checkout) is the tree whose ``pioran_tpu_torch`` is
timed. ``--old`` times two trees on one card in turns, old, new, new, old
(each a child process of this script, so each imports its own package;
say, the parent commit unpacked into an ignored directory with ``git
archive``), and prints each cell's mean of the two runs of each tree and
their ratio new/old. ``--ks`` times the register design's K4 (J <= 64) at
each sub-chunk length ks that fits shared memory (the launch shape forced
by standing in for ``wide_shape``), beside the one ``wide_shape`` picks.
``--bounds`` prints each cell's bound as PERF.md reckons it (chip_smoke.py's
cost functions on these inputs: the bytes read and written once at
3.35 TB/s, the operations at 67 TFLOP/s in float32 and 34 in float64,
the card's rates outside the tensor cores; K4 over every chain, since
every chain here is positive definite).

CUDA-event milliseconds a launch (after one warm-up), on random celerite
kernels that are positive definite term by term. Prints the card's name
and power limit first. Imports torch and the port only; needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 485
JS, BS = (40, 64, 70, 100, 128), (128, 512, 1024)


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


def problem(B, J, dtype, dev, seed=1):
    """a c > b d term by term; t sorted, y normal, sigma2 in [0.05, 0.15];
    per-lane grids with lengths in [N / 2, N] for K2."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.1, 1.0, (B, J))
    b = 0.1 * a * rng.uniform(0.0, 1.0, (B, J))
    c = rng.uniform(0.05, 0.5, (B, J))
    d = c * rng.uniform(0.0, 1.0, (B, J))
    t = np.sort(rng.uniform(0, 100, N))
    y = rng.normal(size=(B, N))
    s2 = rng.uniform(0.05, 0.15, (B, N))
    T = np.sort(rng.uniform(0, 100, (B, N)), axis=1)
    nv = rng.integers(N // 2, N + 1, B)
    put = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)  # noqa: E731
    shared = [put(x) for x in (a, b, c, d, t, y, s2)]
    T = put(T)
    return shared, (T, torch.diff(T, dim=1), torch.as_tensor(nv, dtype=torch.int32, device=dev))


def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def run_tree(root: str, tag: str, ks_mode: bool, grid) -> int:
    """Time ``root``'s wide kernels on ``grid`` (J, B, dtype names,
    kernels); one JSON line a cell."""
    sys.path.insert(0, root)
    from pioran_tpu_torch.ops import cuda_celerite as cc, cuda_celerite_vjp as vjp

    if not cc.__file__.startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {cc.__file__}, not the tree at {root}")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shape_fn = getattr(vjp, "wide_shape", None)
    js, bs, dtypes, kernels = grid
    for dtype in (getattr(torch, name) for name in dtypes):
        for J in js:
            for B in bs:
                args, (T, DT, nv) = problem(B, J, dtype, dev)
                ragged = (*args[:4], T, *args[5:])
                ll, res = vjp.fwd_aug(*args)
                g = torch.isfinite(ll).to(dtype)
                cell = dict(tree=tag, dtype=str(dtype)[6:], J=J, B=B)
                if ks_mode:
                    if shape_fn is None:
                        raise SystemExit("--ks needs a tree with wide_shape")
                    picked = shape_fn(J, dtype, B, vjp.KC, sms)
                    if not 0 < picked.cpt <= 64:
                        continue
                    for ks in range(1, vjp.WIDE_TAB + 1):
                        forced = picked._replace(ks=ks, chunk_scratch=0)
                        vjp.wide_shape = lambda *_a, **_k: forced  # noqa: B023
                        try:
                            ms = cuda_ms(lambda: vjp.bwd(*args, res, g), 2)  # noqa: B023
                        except RuntimeError:  # does not fit shared memory
                            continue
                        finally:
                            vjp.wide_shape = shape_fn
                        print(json.dumps(dict(cell, kernel="K4", ks=ks, ms=ms,
                                              picked=ks == picked.ks and not picked.chunk_scratch)),
                              flush=True)
                    continue
                tabs = None
                if "K0" in kernels:
                    a, b, c, d, t, y, s2 = args
                    tabs = (*cc.build_tables(a, b, c, d, t), y, s2, a.sum(1))
                runs = {
                    "K0": (lambda: cc.loglike_from_tables(*tabs), 5),  # noqa: B023
                    "K1": (lambda: cc.batched_loglike(*args), 10),  # noqa: B023
                    "K2": (lambda: cc._launch(*ragged, DT, nv), 10),  # noqa: B023
                    "K3": (lambda: vjp.fwd_aug(*args), 5),  # noqa: B023
                    "K4": (lambda: vjp.bwd(*args, res, g), 3),  # noqa: B023
                }
                for k in kernels:
                    print(json.dumps(dict(cell, kernel=k, ms=cuda_ms(*runs[k]))), flush=True)
                del args, ragged, res, tabs
    return 0


def bounds(grid) -> int:
    """Each cell's (bound ms, what bounds it); one JSON line a cell."""
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    js, bs, dtypes, kernels = grid
    for name in dtypes:
        item, peak = (4, 67e12) if name == "float32" else (8, 34e12)
        for J in js:
            for B in bs:
                nv = problem(B, J, torch.float32, torch.device("cpu"))[1][2].numpy()
                k3, k4 = cs.adjoint_cost(B, J, N, 8, item, B)
                costs = {"K0": cs.tables_cost(B, J, N, item), "K1": cs.k1_cost(B, J, N, item),
                         "K2": cs.multi_costs(B, J, N, 8, item, nv, np.ones(B, bool))[0],
                         "K3": k3, "K4": k4}
                for k in kernels:
                    nbytes, ops = costs[k]
                    tb, to = nbytes / cs.HBM_BYTES_S, ops / peak
                    print(json.dumps(dict(dtype=name, J=J, B=B, kernel=k,
                                          bound_ms=max(tb, to) * 1e3,
                                          by="bytes" if tb >= to else "operations")))
    return 0


def compare(old_root: str, new_root: str, grid_args) -> int:
    """Old, new, new, old in child processes; a table of means and ratios."""
    runs = []
    for tag, root in (("old", old_root), ("new", new_root), ("new", new_root), ("old", old_root)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--tag", tag, root,
                               *grid_args], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        runs += [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
        print(f"{tag} tree done ({root})", flush=True)
    cells = {}
    for r in runs:
        cells.setdefault((r["dtype"], r["J"], r["B"], r["kernel"]), {}).setdefault(
            r["tree"], []).append(r["ms"])
    worst = 0.0
    for (dtype, J, B, k), v in sorted(cells.items()):
        old, new = sum(v["old"]) / len(v["old"]), sum(v["new"]) / len(v["new"])
        worst = max(worst, new / old)
        print(f"{dtype} J={J} B={B} {k}: old_ms={old:.4f} ({', '.join(f'{x:.4f}' for x in v['old'])}) "
              f"new_ms={new:.4f} ({', '.join(f'{x:.4f}' for x in v['new'])}) new/old={new / old:.4f}",
              flush=True)
    print(f"largest new/old over the cells: {worst:.4f}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=HERE, help="the tree to time")
    ap.add_argument("--old", help="a second tree, timed against ROOT's in turns")
    ap.add_argument("--ks", action="store_true", help="K4 at every sub-chunk that fits")
    ap.add_argument("--bounds", action="store_true", help="each cell's bound, no card")
    ap.add_argument("--terms", type=int, nargs="*", default=list(JS))
    ap.add_argument("--batches", type=int, nargs="*", default=list(BS))
    ap.add_argument("--dtypes", nargs="*", default=["float32", "float64"])
    ap.add_argument("--kernels", nargs="*", default=["K0", "K1", "K2", "K3", "K4"])
    ap.add_argument("--tag", default="tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    grid = (args.terms, args.batches, args.dtypes, args.kernels)
    grid_args = ["--terms", *map(str, args.terms), "--batches", *map(str, args.batches),
                 "--dtypes", *args.dtypes, "--kernels", *args.kernels]
    if args.bounds:
        return bounds(grid)
    if not torch.cuda.is_available():
        print("wide_times: no CUDA device", file=sys.stderr)
        return 1
    if args.tag == "tree":
        print(smi(), flush=True)
    if args.old:
        return compare(os.path.abspath(args.old), os.path.abspath(args.root), grid_args)
    return run_tree(os.path.abspath(args.root), args.tag, args.ks, grid)


if __name__ == "__main__":
    sys.exit(main())
