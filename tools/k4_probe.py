#!/usr/bin/env python3
"""Where a step of K4 spends its time, by clock64().

The design of ``csrc/celerite_adjoint.cu`` up to commit e84a936 rebuilt
each chunk's T blocks in a per-chain global scratch buffer (phase 1) and
read them back in the reverse sweep (phase 2); the design after it keeps
them in shared memory. This script takes either source, inserts
``clock64()`` stamps around phase 1, the Mbar loop, the scalar work
between it and the S-U loop, the S-U loop and the step's tail of
``bwd_kernel``, builds the copy with nvcc under
``build/k4_probe/`` and runs it at float32, B chains, J = 20, N = 485,
kc = 8, on synthetic inputs (the per-step cost does not depend on the
values). It prints the cycles a chain spends in each part, per step,
averaged over the chains, and the kernel's time by CUDA events with and
without the stamps. Run on a machine with the card:

    git show e84a936:pioran_tpu_torch/csrc/celerite_adjoint.cu > build/k4_old.cu
    python3 tools/k4_probe.py build/k4_old.cu [--batch 512]
    python3 tools/k4_probe.py pioran_tpu_torch/csrc/celerite_adjoint.cu
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from chip_smoke import ptxas_summary  # noqa: E402
from pioran_tpu_torch import _build  # noqa: E402
from pioran_tpu_torch.ops import cuda_celerite_vjp as vjp  # noqa: E402

# (anchors, of which the source holds one exactly once; text; inserted
# after the anchor, else before it). The first anchor is the design of
# e84a936, the second the shared-memory design after it.
STAMPS = [
    (("  const long long JJ = static_cast<long long>(J) * J;\n  const int nck = (N + kc - 1) / kc;\n"
      "  // this chain's scratch", "  int ch = nck - 1, sc = nsub(ch) - 1, buf = 0;"),
     "  long long p_phase1 = 0, p_mbar = 0, p_scal = 0, p_su = 0, p_tail = 0;\n"
     "  const long long p_start = clock64();\n", False),
    (("    // ---- phase 1:",), "    const long long p1 = clock64();\n", False),
    (("    // ---- phase 2:",), "    p_phase1 += clock64() - p1;\n", False),
    (("      // consume Mbar:",), "      const long long p2 = clock64();\n", False),
    (("      T Dbar = W0 * (T(0.5) * pw0 + m01w1)",),
     "      p_mbar += clock64() - p2;\n      const long long p4 = clock64();\n", False),
    (("      // q = S U with S = ee o T",),
     "      p_scal += clock64() - p4;\n      const long long p3 = clock64();\n", False),
    (("      U0bar += u0acc;",),
     "      p_su += clock64() - p3;\n      const long long p5 = clock64();\n", False),
    (("      if (lane == 0) {\n        ybar[cN + m] = zpbar;", "      kp = k;\n"),
     "      p_tail += clock64() - p5;\n", False),
    (("  if (row) {\n    abar[cj] = ab + sumabar;",),
     "  if (lane == 0) {\n    long long* pr = k4_probe + 6 * chain;\n    pr[0] = p_phase1;\n"
     "    pr[1] = p_mbar;\n    pr[2] = p_scal;\n    pr[3] = p_su;\n    pr[4] = p_tail;\n"
     "    pr[5] = clock64() - p_start;\n  }\n", False),
]
PROBE_DECL = ("\n__device__ long long k4_probe[6 * 65536];\n"
              "extern \"C\" int k4_probe_read(void* out, int n) {\n"
              "  return static_cast<int>(cudaMemcpyFromSymbol(out, k4_probe, n * sizeof(long long)));\n}\n")


def instrument(src: str) -> str:
    for anchors, text, after in STAMPS:
        found = [x for x in anchors if src.count(x) == 1]
        if not found:
            raise SystemExit(f"no anchor found once in the source: {anchors!r}")
        anchor = found[0]
        src = src.replace(anchor, anchor + text if after else text + anchor)
    head, tail = src.split("namespace {", 1)
    return head + PROBE_DECL + "namespace {" + tail


def build(src_path: str, probe: bool, jp: int) -> ctypes.CDLL:
    out_dir = os.path.join(os.path.dirname(HERE), "build", "k4_probe")
    os.makedirs(out_dir, exist_ok=True)
    with open(src_path) as fh:
        src = fh.read()
    name = "probe" if probe else "plain"
    cu = os.path.join(out_dir, f"k4_{name}.cu")
    with open(cu, "w") as fh:
        fh.write(instrument(src) if probe else src)
    lib = os.path.join(out_dir, f"libk4_{name}.so")
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib, cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(proc.stdout + proc.stderr)
    summary = ptxas_summary(proc.stdout + proc.stderr).split("; ")
    print(f"{name}: ptxas {[x for x in summary if x.startswith(f'bwd_kernel<f,{jp},shared>')]}")
    return ctypes.CDLL(lib)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="a celerite_adjoint.cu")
    ap.add_argument("--batch", type=int, default=512)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_probe: no CUDA device", file=sys.stderr)
        return 1
    B, J, N, kc = args.batch, 20, 485, 8
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()  # noqa: E731
    a, b = f(rng.uniform(0.1, 0.6, (B, J))), f(rng.uniform(0.0, 0.2, (B, J)))
    c, d = f(rng.uniform(0.05, 0.35, (B, J))), f(rng.uniform(0.0, 0.4, (B, J)))
    t = f(np.sort(rng.uniform(0, 100, N)))
    y, s2 = f(rng.normal(size=(B, N))), f(rng.uniform(0.05, 0.15, (B, N)))
    nck = -(-N // kc)
    new = lambda *s: torch.empty(*s, dtype=torch.float32, device=dev)  # noqa: E731
    ll = new(B)
    res = [new(B, N, J) for _ in range(4)] + [new(B, N), new(B, N), new(B, nck, 3, J, J)]
    with open(args.src) as fh:
        # the design of e84a936 takes a global scratch buffer; the one after
        # it takes the sub-chunk length and the chains per block instead
        old = "T* scratch" in fh.read()
    scratch = [new(B, kc, 4, J, J)] if old else []
    cpb, ks, _ = vjp.bwd_launch_shape(torch.float32, J, kc, B)
    tail = [] if old else [ctypes.c_int(ks), ctypes.c_int(cpb)]
    outs = [new(B, J) for _ in range(4)] + [new(B, N) for _ in range(4)]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
    ints = [ctypes.c_int(v) for v in (B, J, N, kc)]
    times = {}
    for probe in (False, True):
        lib = build(args.src, probe, 24 if old else 20)  # J = 20's instantiation
        lib.celerite_fwd_aug_f32.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.celerite_bwd_f32.argtypes = ([ctypes.c_void_p] * (23 if old else 22)
                                         + [ctypes.c_int] * len(ints + tail) + [ctypes.c_void_p])
        lib.celerite_fwd_aug_f32.restype = lib.celerite_bwd_f32.restype = ctypes.c_int
        err = lib.celerite_fwd_aug_f32(*map(p, (a, b, c, d, t)), None, p(y), p(s2), p(ll),
                                       *map(p, res), *ints, stream)
        assert err == 0, err
        g = torch.isfinite(ll).float()

        def k4():
            e = lib.celerite_bwd_f32(*map(p, (a, b, c, d, t)), None, p(g), *map(p, res),
                                     *map(p, scratch), *map(p, outs), *ints, *tail, stream)
            assert e == 0, e
        k4()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(20):
            k4()
        ev[1].record()
        torch.cuda.synchronize()
        times[probe] = ev[0].elapsed_time(ev[1]) / 20
        if probe:
            buf = np.zeros(6 * B, dtype=np.int64)
            lib.k4_probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
            assert lib.k4_probe_read(buf.ctypes.data, 6 * B) == 0
            cyc = buf.reshape(B, 6)[g.cpu().numpy() > 0].mean(0) / N
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    rest = cyc[5] - cyc[:5].sum()
    print(f"card: {smi}")
    print(f"K4 {'old' if old else 'new'} design f32 B={B} J={J} N={N} kc={kc}: ms "
          f"plain={times[False]:.4f} with stamps={times[True]:.4f}; us/step "
          f"{times[False] * 1e3 / N:.3f}")
    parts = zip(("phase1", "mbar_loop", "scalars", "su_loop", "tail", "rest"),
                list(cyc[:5]) + [rest])
    print(f"cycles per step (chain average): total={cyc[5]:.0f} "
          + " ".join(f"{n}={x:.0f} ({x / cyc[5]:.1%})" for n, x in parts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
