#!/usr/bin/env python3
"""Where a step of K1 spends its time, by clock64(), and K1's launch shape.

The design of ``csrc/celerite_fwd.cu`` up to commit b7b1754 ran the whole
O(J^2) column loop of a step on its serial chain, with per-step sincos
and exp and its columns carried by __shfl_sync; the design after it runs
that loop one step ahead, off the step's chain. This script
takes either source, inserts ``clock64()`` stamps around four parts of
a step of ``celerite_fwd_kernel``, builds the copy with nvcc under
``build/k1_probe/`` and runs K1 (the shared grid) at float32, B chains,
J = 20, N = 485, on synthetic inputs (the per-step cost does not depend
on the values). The parts:

- ``table``: the work of each 32-step block before its steps, per step
  (old: the block's loads of y, sigma2, t, dt; new: the staging copies,
  their wait, and the table of sincos and exp);
- ``chain_a``: old design, sincos, exp, U and V of the step; new design,
  the three-value butterfly of g, Q and h;
- ``columns``: the column loop (old: S_n and S_n U_n, on the chain; new:
  S_n and P_{n+1} = S_n u_{n+1}, the shadowed work) and f_n;
- ``chain_b``: old design, f_n, the butterfly of U.SU and U.f, D, zp, two
  divisions and the Kahan sums; new design, D, zp, the reciprocal, the W
  update and the next step's column rows with their __syncwarp;
- ``rest``: everything else, per step (old: the step's y, sigma2, t and
  dt shuffles; new: the step's loads of its row of the table and each
  block's logs and Kahan sums).

The stamps order what the compiler would interleave, so with them the
parts run one after another; the kernel's time without them, beside their
sum, shows how much of the shadowed work the new design hides. It prints
the cycles a chain spends in each part, per step, averaged over the
chains, and the kernel's time by CUDA events with and without the stamps.

``--warps 1 2 4`` builds the source once for each count of chains
(warps) a block and times K1 at B = 128, 1024 and 4096 with each, instead
of the stamps. Run on a machine with the card:

    git show b7b1754:pioran_tpu_torch/csrc/celerite_fwd.cu > build/k1_old.cu
    python3 tools/k1_probe.py build/k1_old.cu [--batch 128]
    python3 tools/k1_probe.py pioran_tpu_torch/csrc/celerite_fwd.cu
    python3 tools/k1_probe.py pioran_tpu_torch/csrc/celerite_fwd.cu --warps 1 2 4
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from chip_smoke import ptxas_summary  # noqa: E402
from pioran_tpu_torch import _build  # noqa: E402

J, N = 20, 485
PARTS = ("table", "chain_a", "columns", "chain_b")
# (anchors; text inserted before the first of them that the source holds
# exactly once, or None: the step's closing stamp after it). Where there
# are two, the first is the design after b7b1754, the second the design of
# b7b1754.
STAMPS = [
    (("  int buf = 0;\n  if (nsteps > 0) fetch(0, 0);",
      "  for (int base = 0; base < nsteps; base += 32) {"),
     "  long long p_t = 0, p_a = 0, p_c = 0, p_b = 0;\n  const long long p_start = clock64();\n"),
    (("    const int nk = min(kSteps, nsteps - base);\n",
      "    const int nk = min(32, nsteps - base);\n"),
     "    long long pt = clock64();\n"),
    (("    // this lane's ec and V of step base", "    for (int k = 0; k < nk; ++k) {"),
     "    p_t += clock64() - pt;\n"),
    (("      // the serial chain: g_n, with Q_n and h_n, in one butterfly.",
      "      T si, co;\n      Ops<T>::sincos_(di * tn, &si, &co);"),
     "      long long p0 = clock64();\n"),
    (("      // the shadow: S_n = ee o S_{n-1} + D_{n-1}",
      "      const T Wd0 = W0 * Dp, Wd1 = W1 * Dp;"),
     "      p_a += clock64() - p0;\n      p0 = clock64();\n"),
    (("      // the chain's scalars, one reciprocal and the W update",
      "      const T SU0 = su00 + su01;"),
     "      p_c += clock64() - p0;\n      p0 = clock64();\n"),
    (("      minD = Dn < minD ? Dn : minD;",),
     None),
    (("  if (lane == 0) {\n    const T ll",),
     "  if (lane == 0) {\n    long long* pr = k1_probe + 5 * chain;\n    pr[0] = p_t;\n"
     "    pr[1] = p_a;\n    pr[2] = p_c;\n    pr[3] = p_b;\n    pr[4] = clock64() - p_start;\n"
     "  }\n"),
]
PROBE_DECL = ("\n__device__ long long k1_probe[5 * 65536];\n"
              "extern \"C\" int k1_probe_read(void* out, int n) {\n"
              "  return static_cast<int>(cudaMemcpyFromSymbol(out, k1_probe, n * sizeof(long long)));\n}\n")
# the count of chains (warps) a block, in the old design and the new
WARPS = [(r"constexpr int kWarpsPerBlock = \d+;", "constexpr int kWarpsPerBlock = {w};"),
         (r"return B <= sms \? 1 : kWarps;", "return {w};")]


def instrument(src: str) -> str:
    for anchors, text in STAMPS:
        found = [x for x in anchors if src.count(x) == 1]
        if not found:
            raise SystemExit(f"no anchor found once in the source: {anchors!r}")
        anchor = found[0]
        if text is None:  # after the step's last statement
            src = src.replace(anchor, anchor + "\n      p_b += clock64() - p0;")
        else:
            src = src.replace(anchor, text + anchor)
    head, tail = src.split("namespace {", 1)
    return head + PROBE_DECL + "namespace {" + tail


def with_warps(src: str, w: int) -> str:
    for pat, rep in WARPS:
        new, n = re.subn(pat, rep.replace("{w}", str(w)), src)
        if n == 1:
            return new
    raise SystemExit("no count of warps a block found in the source")


def build(name: str, src: str) -> ctypes.CDLL:
    out_dir = os.path.join(os.path.dirname(HERE), "build", "k1_probe")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, f"k1_{name}.cu")
    with open(cu, "w") as fh:
        fh.write(src)
    lib = os.path.join(out_dir, f"libk1_{name}.so")
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib, cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(proc.stdout + proc.stderr)
    summary = ptxas_summary(proc.stdout + proc.stderr).split("; ")
    print(f"{name}: ptxas {[x for x in summary if x.startswith('celerite_fwd_kernel<f,')]}")
    out = ctypes.CDLL(lib)
    out.celerite_fwd_f32.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out.celerite_fwd_f32.restype = ctypes.c_int
    return out


def inputs(B: int, dev):
    rng = np.random.default_rng(0)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()  # noqa: E731
    a, b = f(rng.uniform(0.1, 0.6, (B, J))), f(rng.uniform(0.0, 0.2, (B, J)))
    c, d = f(rng.uniform(0.05, 0.35, (B, J))), f(rng.uniform(0.0, 0.4, (B, J)))
    t = f(np.sort(rng.uniform(0, 100, N)))
    y, s2 = f(rng.normal(size=(B, N))), f(rng.uniform(0.05, 0.15, (B, N)))
    return a, b, c, d, t, y, s2


def k1_ms(lib, B: int, dev, reps: int = 20) -> float:
    a, b, c, d, t, y, s2 = inputs(B, dev)
    out = torch.empty(B, dtype=torch.float32, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ptrs = [ctypes.c_void_p(x.data_ptr()) for x in (a, b, c, d, t)]
    rest = [ctypes.c_void_p(x.data_ptr()) for x in (y, s2, out)]

    def run():
        e = lib.celerite_fwd_f32(*ptrs, None, *rest, B, J, N, stream)
        assert e == 0, e
    run()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()), "non-finite K1 value"
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        run()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="a celerite_fwd.cu")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--warps", type=int, nargs="*", help="time these chains-per-block counts")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    with open(args.src) as fh:
        src = fh.read()
    old = "kWarpsPerBlock" in src
    design = "old" if old else "new"
    if args.warps:
        with ThreadPoolExecutor(len(args.warps)) as ex:
            libs = list(ex.map(lambda w: build(f"w{w}", with_warps(src, w)), args.warps))
        for w, lib in zip(args.warps, libs):
            ms = {B: k1_ms(lib, B, dev) for B in (128, 1024, 4096)}
            print(f"K1 {design} design f32 J={J} N={N} warps_per_block={w}: "
                  + " ".join(f"B={B} ms={v:.4f} us/step={v * 1e3 / N:.3f}" for B, v in ms.items()))
        return 0
    B = args.batch
    with ThreadPoolExecutor(2) as ex:
        plain, probe = ex.map(lambda p: build(p[0], p[1]),
                              [("plain", src), ("probe", instrument(src))])
    times = {"plain": k1_ms(plain, B, dev), "probe": k1_ms(probe, B, dev)}
    buf = np.zeros(5 * B, dtype=np.int64)
    probe.k1_probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    assert probe.k1_probe_read(buf.ctypes.data, 5 * B) == 0
    cyc = buf.reshape(B, 5).mean(0) / N
    rest = cyc[4] - cyc[:4].sum()
    print(f"K1 {design} design f32 B={B} J={J} N={N}: ms plain={times['plain']:.4f} "
          f"with stamps={times['probe']:.4f}; us/step {times['plain'] * 1e3 / N:.3f}")
    parts = zip(PARTS + ("rest",), list(cyc[:4]) + [rest])
    print(f"cycles per step (chain average): total={cyc[4]:.0f} "
          + " ".join(f"{n}={x:.0f} ({x / cyc[4]:.1%})" for n, x in parts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
