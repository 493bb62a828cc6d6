#!/usr/bin/env python3
"""Where a step of the wide K3 and K4 (``csrc/celerite_wide.cu``, J > 32)
spends its time, by clock64().

Takes the source of this checkout and, with ``--old``, another
``celerite_wide.cu`` (the design of commit d1cfca8, say), inserts
``clock64()`` stamps into a copy of each around the parts of the float32
K3 (``Aug``) and K4 step, builds the plain and the stamped copies with
nvcc under ``build/wide_probe/``, and runs them at J = 40 (``--terms``;
past 64 the form past the registers, against the old design's one thread
a row),
N = 485, kc = 8 on synthetic positive-definite inputs, at each B of
``--batches``; K4 of the old design at both placements its launch shape
could pick (the T chunk in shared memory, or in the device scratch). It
prints each copy's ptxas registers and spills, the kernels' CUDA-event
times with and without the stamps (plain old, new, new, old in turns),
and the cycles a chain spends in each part per step, averaged over the
chains. The stamps serialise what the compiler would overlap, so the
parts are upper bounds. Run on a machine with the card:

    git show d1cfca8:pioran_tpu_torch/csrc/celerite_wide.cu > build/wide_old.cu
    python3 tools/wide_probe.py --old build/wide_old.cu [--batches 512 1024]

Parts of the old design. K3: ``head`` (t, sincos, exp, the rows),
``bar`` (its barrier), ``cols`` (the column loop: T, S, q and the
checkpoint), ``red`` (the block sum of U.q and U.f), ``tail`` (W, the
residual stores, the Kahan sums). K4: ``phase1`` (the checkpoint copy and
the replays, per step of the sweep), ``loads`` (the step's rows, sincos,
exp), ``bar1``, ``gmv`` (G's row times W), ``red2`` (the block sum of
D-bar, zp-bar, sum W-bar W), ``scalars``, ``bar3``, ``cols`` (the column
loop: G, the U and ec cotangents), ``bar4``, ``chain`` (the coefficient
chain rule), ``red5`` (the block sum of t-bar and dt-bar, their stores).
Parts of the register design (its ``PROBE`` marks). K3: ``table`` (the
next block's table and, on warp 0 at a block's end, the last block's
logs and Kahan sums), ``cols``, ``reduce`` (the shuffles, the rows V - q
and the warps' partial sums), ``barrier``, ``tail`` (D, zp, W),
``ckpt_copy`` (the staged checkpoint's coalesced copy), ``stores`` (the
residual rows). K4: ``tables`` (the checkpoint's wait and the window's
build), ``phase1`` (the replays), ``gmv``, ``publish`` (V-bar and the
warps' partial sums), ``barrier``, ``scalars``, ``cols``, ``chain`` (the
chain rule, the t-bar and dt-bar sums, the next checkpoint's cp.async).
Imports torch and the port only; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from chip_smoke import ptxas_summary  # noqa: E402
from pioran_tpu_torch import _build  # noqa: E402
from pioran_tpu_torch.ops import cuda_celerite_vjp as vjp  # noqa: E402

N, KC = 485, 8
NF, NB = 8, 16  # stamp slots a chain: K3, K4
PROBE_DECL = (
    "\n__device__ long long wide_probe_fwd[8 * 65536];\n"
    "__device__ long long wide_probe_bwd[16 * 65536];\n"
    "extern \"C\" int wide_probe_read(void* fwd, void* bwd, int n) {\n"
    "  cudaError_t e = cudaMemcpyFromSymbol(fwd, wide_probe_fwd, 8LL * n * sizeof(long long));\n"
    "  if (e != cudaSuccess) return static_cast<int>(e);\n"
    "  return static_cast<int>(cudaMemcpyFromSymbol(bwd, wide_probe_bwd,\n"
    "                                               16LL * n * sizeof(long long)));\n}\n")


def _stamp(arr: str, k: int, var: str) -> str:
    return f"{arr}[{k}] += clock64() - {var}; {var} = clock64();\n"


# (anchor found exactly once, text before it, text after it)
OLD_FWD = ["head", "bar", "cols", "red", "tail"]
OLD_BWD = ["phase1", "loads", "bar1", "gmv", "red2", "scalars", "bar3", "cols", "bar4",
           "chain", "red5"]
OLD_STAMPS = [
    ("  for (int n = 0; n < nsteps; ++n) {\n",
     "  long long pf[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n  const long long f_start = clock64();\n",
     "    long long qf = clock64();\n"),
    ("    __syncthreads();  // this step's U and ec rows, and the last step's W row\n",
     _stamp("pf", 0, "qf"), _stamp("pf", 1, "qf")),
    ("    block_sum<T, 2>(sums, red);\n", _stamp("pf", 2, "qf"), _stamp("pf", 3, "qf")),
    ("    Dp = Dn;\n    zpp = zpn;\n", "", _stamp("pf", 4, "qf")),
    ("  if (Carry) {  // the state after the last step",
     "  if (Aug && G == kShared && r == 0) {\n    long long* pr = wide_probe_fwd + 8LL * chain;\n"
     "    for (int k = 0; k < 5; ++k) pr[k] = pf[k];\n    pr[7] = clock64() - f_start;\n  }\n",
     ""),
    ("  for (int ch = nck - 1; ch >= 0; --ch) {\n",
     "  long long pb[16] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  const long long b_start = clock64();\n", ""),
    ("      // ---- phase 1:", "      long long qp = clock64();\n", ""),
    ("      // ---- phase 2:", "      pb[0] += clock64() - qp;\n", ""),
    ("        const T tn = t[m];\n        const T dtn = step_dt(m);\n",
     "        long long qb = clock64();\n", ""),
    ("        __syncthreads();  // (1) the W row\n", _stamp("pb", 1, "qb"), _stamp("pb", 2, "qb")),
    ("        block_sum<T, 3>(sums, red);  // (2)\n", _stamp("pb", 3, "qb"),
     _stamp("pb", 4, "qb")),
    ("        __syncthreads();  // (3) the U, qbar and ec rows\n", _stamp("pb", 5, "qb"),
     _stamp("pb", 6, "qb")),
    ("        __syncthreads();  // (4) the exchange rows\n", _stamp("pb", 7, "qb"),
     _stamp("pb", 8, "qb")),
    ("        block_sum<T, 2>(tsum, red);  // (5)\n", _stamp("pb", 9, "qb"), ""),
    ("          p.dtb[cN + m] = tsum[1];\n        }\n", "", _stamp("pb", 10, "qb")),
    ("  if (act && h == 0) {\n    p.abar[cj] = ab + sumabar;",
     "  if (r == 0) {\n    long long* pr = wide_probe_bwd + 16LL * chain;\n"
     "    for (int k = 0; k < 11; ++k) pr[k] = pb[k];\n    pr[15] = clock64() - b_start;\n  }\n",
     ""),
]
# the register design: the kernels carry PROBE(...) marks that expand to
# nothing unless PIORAN_WIDE_PROBE is defined; the names of their slots
NEW_FWD = ["table", "cols", "reduce", "barrier", "tail", "ckpt_copy", "stores"]
NEW_BWD = ["tables", "phase1", "gmv", "publish", "barrier", "scalars", "cols", "chain"]


def instrument(src: str) -> str:
    if "split_bwd_kernel" in src:  # the register design: switch its marks on
        head, tail = src.split("namespace {", 1)
        return "#define PIORAN_WIDE_PROBE 1\n" + head + PROBE_DECL + "namespace {" + tail
    for anchor, before, after in OLD_STAMPS:
        if src.count(anchor) != 1:
            raise SystemExit(f"no anchor found once in the source: {anchor!r}")
        src = src.replace(anchor, before + anchor + after)
    head, tail = src.split("namespace {", 1)
    return head + PROBE_DECL + "namespace {" + tail


def build(name: str, src: str, stamped: bool):
    out_dir = os.path.join(os.path.dirname(HERE), "build", "wide_probe")
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{name}_{'stamped' if stamped else 'plain'}"
    cu = os.path.join(out_dir, f"wide_{tag}.cu")
    with open(cu, "w") as fh:
        fh.write(instrument(src) if stamped else src)
    lib = os.path.join(out_dir, f"libwide_{tag}.so")
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib, cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(proc.stdout + proc.stderr)
    summary = [x for x in ptxas_summary(proc.stdout + proc.stderr).split("; ")
               if x.startswith(("wide_fwd<f,shared,aug>", "wide_bwd<f,shared>", "split_fwd<f,",
                                "split_bwd<f,")) and "shared" in x and "carry" not in x]
    print(f"{tag}: ptxas {summary}", flush=True)
    return ctypes.CDLL(lib)


class Design:
    """One source's K3 and K4 entries (float32), with the arguments its C
    interface takes."""

    def __init__(self, name, src_path, J):
        with open(src_path) as fh:
            src = fh.read()
        # the register design up to 64 terms and, where the source has it,
        # past them (Tail); else past 64 the one-thread-a-row design (cpt 0)
        self.name, self.J = name, J
        self.new = "split_bwd_kernel" in src and (J <= 64 or "bool Tail" in src)
        with ThreadPoolExecutor(2) as ex:
            self.libs = dict(zip(("plain", "stamped"),
                                 ex.map(lambda s: build(name, src, s), (False, True))))
        nint = 5 if "split_bwd_kernel" in src else 4
        self.cpt = ([vjp.wide_cpt(J)] if self.new else [0]) if nint == 5 else []
        for lib in self.libs.values():
            lib.celerite_wide_fwd_aug_f32.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * nint
                                                      + [ctypes.c_void_p])
            lib.celerite_wide_bwd_f32.argtypes = ([ctypes.c_void_p] * 24
                                                  + [ctypes.c_int] * (nint + 1)
                                                  + [ctypes.c_void_p])
            lib.celerite_wide_fwd_aug_f32.restype = lib.celerite_wide_bwd_f32.restype = ctypes.c_int
        self.libs["stamped"].wide_probe_read.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]

    def placements(self, B):
        """K4's (label, ks, carry scratch values, chunk scratch values)."""
        J = self.J
        if self.new:
            s = vjp.wide_shape(J, torch.float32, B, KC)
            where = lambda x: "scratch" if x else "smem"  # noqa: E731
            return [(f"G tail in {where(s.carry_scratch)}, T slots in "
                     f"{where(s.chunk_scratch)} ks={s.ks}", s.ks, s.carry_scratch,
                     s.chunk_scratch)]
        # the one-thread-a-row design: G (R x R) in shared memory where it
        # fits beside its rows, the T chunk there too where it also fits
        ks, rows, G, chunk = min(KC, 8), 14 * J + 24, 4 * J * J, 3 * min(KC, 8) * J * (J | 1)
        carry = 0 if 4 * (rows + G) <= vjp.SMEM_BYTES else G
        out = [("chunk in scratch", ks, carry, chunk)]
        if 4 * (rows + (G if not carry else 0) + chunk) <= vjp.SMEM_BYTES:
            out.insert(0, ("chunk in smem", ks, carry, 0))
        return out


def inputs(B, J, dev):
    rng = np.random.default_rng(1)
    a = rng.uniform(0.1, 1.0, (B, J))
    b = 0.1 * a * rng.uniform(0.0, 1.0, (B, J))
    c = rng.uniform(0.05, 0.5, (B, J))
    d = c * rng.uniform(0.0, 1.0, (B, J))
    t = np.sort(rng.uniform(0, 100, N))
    y = rng.normal(size=(B, N))
    s2 = rng.uniform(0.05, 0.15, (B, N))
    return [torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()
            for x in (a, b, c, d, t, y, s2)]


def runners(design: Design, lib, args, place):
    """(K3 launch, K4 launch, K4's outputs) on ``args`` for one library."""
    a, b, c, d, t, y, s2 = args
    B, J = a.shape
    nck = -(-N // KC)
    new = lambda *s: torch.empty(*s, dtype=torch.float32, device=a.device)  # noqa: E731
    ll = new(B)
    res = [new(B, N, J) for _ in range(4)] + [new(B, N), new(B, N), new(B, nck, 3, J, J)]
    outs = [new(B, J) for _ in range(4)] + [new(B, N) for _ in range(4)]
    g = new(B).fill_(1.0)
    _, ks, carry, chunk = place
    scr = [new(B * carry) if carry else None, new(B * chunk) if chunk else None]
    p = lambda x: None if x is None else ctypes.c_void_p(x.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    cpt = design.cpt

    def k3():
        e = lib.celerite_wide_fwd_aug_f32(*map(p, (a, b, c, d, t)), None, p(y), p(s2), p(ll),
                                          *map(p, res), None, B, J, N, KC, *cpt, stream)
        assert e == 0, e

    def k4():
        e = lib.celerite_wide_bwd_f32(*map(p, (a, b, c, d, t)), None, p(g), *map(p, res),
                                      *map(p, outs), *map(p, scr), B, J, N, KC, ks, *cpt,
                                      stream)
        assert e == 0, e
    return k3, k4, (ll, outs)


def ms(run, reps=10):
    run()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        run()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def split_line(kind, names, buf, B, slots):
    cyc = buf.reshape(B, slots).astype(np.float64).mean(0) / N
    total = cyc[slots - 1]
    rest = total - cyc[:len(names)].sum()
    return (f"  {kind} cycles per step (chain average): total={total:.0f} "
            + " ".join(f"{n}={x:.0f} ({x / total:.1%})"
                       for n, x in zip(names + ["rest"], list(cyc[:len(names)]) + [rest])))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", help="another celerite_wide.cu to time and split beside this one")
    ap.add_argument("--batches", type=int, nargs="*", default=[512, 1024])
    ap.add_argument("--terms", type=int, default=40)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wide_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    J = args.terms
    srcs = [("new", os.path.join(_build.CSRC_DIR, "celerite_wide.cu"))]
    if args.old:
        srcs.insert(0, ("old", args.old))
    designs = [Design(name, path, J) for name, path in srcs]
    for B in args.batches:
        data = inputs(B, J, dev)
        for design in designs:
            fwd_names, bwd_names = (NEW_FWD, NEW_BWD) if design.new else (OLD_FWD, OLD_BWD)
            for place in design.placements(B):
                plain = runners(design, design.libs["plain"], data, place)
                stamped = runners(design, design.libs["stamped"], data, place)
                plain[0]()
                t3 = [ms(plain[0]), ms(plain[0])]
                t4 = [ms(plain[1], 3), ms(plain[1], 3)]
                s3, s4 = ms(stamped[0], 2), ms(stamped[1], 2)
                torch.cuda.synchronize()
                ok = bool(torch.isfinite(plain[2][0]).all()) and all(
                    bool(torch.isfinite(x).all()) for x in plain[2][1])
                print(f"{design.name} f32 J={J} B={B} N={N} K4 {place[0]}: K3 ms {t3[0]:.4f} "
                      f"{t3[1]:.4f} (stamped {s3:.4f}) K4 ms {t4[0]:.4f} {t4[1]:.4f} "
                      f"(stamped {s4:.4f}) finite={ok}", flush=True)
                fbuf = np.zeros(NF * B, dtype=np.int64)
                bbuf = np.zeros(NB * B, dtype=np.int64)
                assert design.libs["stamped"].wide_probe_read(fbuf.ctypes.data, bbuf.ctypes.data,
                                                               B) == 0
                print(split_line("K3", fwd_names, fbuf, B, NF), flush=True)
                print(split_line("K4", bwd_names, bbuf, B, NB), flush=True)
        del data
    return 0


if __name__ == "__main__":
    sys.exit(main())
