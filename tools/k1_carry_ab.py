#!/usr/bin/env python3
"""K1's carry entry against K1 without a carry, on one block of a split
series: J = 20, B in {64, 512}, a block of 4096 steps (the second of a
2^14-point series from ``chip_smoke.seq_inputs``, seed 0, started from the
carry the first block ended with), float32 and float64, then the ptxas
registers and spills of K1's J = 20 instantiations.

    python3 tools/k1_carry_ab.py [ROOT] [TAG]

ROOT (default: this checkout) is the tree whose ``pioran_tpu_torch`` is
timed, so that two trees (say, a parent commit unpacked into an ignored
directory, and this one) can be compared on one card, in
turns: parent, change, change, parent. The inputs, the timing and the
ptxas parsing come from this checkout's ``chip_smoke.py``. CUDA-event
milliseconds a launch, each mean over 6 runs of 20 launches taken in
turns with the entry without a carry. The ptxas line is empty when the
tree's library was built by an earlier process. Imports torch and the
port only; needs a CUDA device.
"""

from __future__ import annotations

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else HERE
TAG = sys.argv[2] if len(sys.argv) > 2 else "tree"
sys.path.insert(0, ROOT)

import torch  # noqa: E402

_spec = importlib.util.spec_from_file_location("_smoke", os.path.join(HERE, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

from pioran_tpu_torch import _build  # noqa: E402
from pioran_tpu_torch.ops import cuda_celerite as cc, cuda_celerite_vjp as vjp  # noqa: E402

K = 4096


def main() -> int:
    if not cc.__file__.startswith(ROOT):
        raise SystemExit(f"imported {cc.__file__}, not the tree at {ROOT}")
    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.float64):
        for J, B in ((20, 64), (20, 512)):
            (a, b, c, d, t, y, s2), dt64 = cs.seq_inputs(J, B, 4 * K, 0, dev, dtype)
            dtg = torch.cat([dt64.new_zeros(1), dt64]).to(dtype)
            _, carry = cc.loglike_carry(a, b, c, d, t[:K], y[:, :K], s2[:, :K], dtg[:K],
                                        vjp.neutral_carry(B, J, a))
            sl = slice(K, 2 * K)
            blk = (a, b, c, d, t[sl], y[:, sl], s2[:, sl])
            with_carry = lambda: cc.loglike_carry(*blk, dtg[sl], carry)  # noqa: E731,B023
            without = lambda: cc._launch(*blk, dt64[K:2 * K - 1])  # noqa: E731,B023
            m1 = m0 = 0.0
            for _ in range(3):
                m1 += cs.cuda_ms(with_carry, 20)
                m0 += cs.cuda_ms(without, 20)
                m0 += cs.cuda_ms(without, 20)
                m1 += cs.cuda_ms(with_carry, 20)
            print(f"{TAG} {dtype} J={J} B={B} K={K}: carry_ms={m1 / 6:.4f} "
                  f"no_carry_ms={m0 / 6:.4f} ratio={m1 / m0:.4f}", flush=True)
    ptx = cs.ptxas_summary(_build.build_info("celerite_fwd")[1]).split("; ")
    print(TAG, "ptxas", [x for x in ptx if ",20," in x])
    return 0


if __name__ == "__main__":
    sys.exit(main())
