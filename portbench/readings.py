"""The readings a cell's limits are set from, in one process on the card.

    python3 portbench/readings.py --workload <name> --seeds 11,12,... \
        --seconds <s> [--control] [--out <file.json>]

For each seed: one run of the cell (``harness.run_once``, untraced) and
its compared numbers, the program's readings; with ``--control`` also the
control's: the reference computed in float32 with its products in TF32
put in the program's place, on the run's compared inputs (a calls cell's
sampled rows, a fits cell's particles). Prints one JSON object and writes
it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, ROOT)
    import torch
    from portbench import check, harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = harness.load_benchmark()
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(device),
           "runs": [], "control": []}
    for seed in (int(s) for s in args.seeds.split(",")):
        keep = {}
        line = harness.run_once(bench, args.workload, seed, args.seconds, False, device,
                                time.time(), keep=keep)
        run = {"seed": seed, "correct": line["correct"], "attempted": line["attempted"],
               "checks": line["checks"], "metrics": line["metrics"]}
        out["runs"].append(run)
        print(json.dumps(run), flush=True)
        if args.control:
            config = keep["config"]
            model = check.reference_model(config, device)
            low = check.reference_model(config, device, dtype=torch.float32, tf32=True)
            nums = keep["kind"].control_numbers(keep["kept"], model, low, config, keep["mix"],
                                                keep["limits"])
            nums["seed"] = seed
            out["control"].append(nums)
            print(json.dumps({"control": nums}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
