#!/usr/bin/env python3
"""K0 (the table-streaming kernel) in one call: two designs side by side,
and the new design at each launch shape.

Builds ``pioran_tpu_torch/csrc/celerite_tables.cu`` and, with ``--old``,
another source of the same C interface (the design of commit a2862e4,
say) with nvcc under ``build/k0_probe/``, prints each one's ptxas
registers and spills, then times K0 by CUDA events on tables from
``build_tables`` of synthetic coefficients (J = 20, N = 485; the per-step
cost does not depend on the values), in float32 and float64, at each B of
``--batches``, in turns old, new, new, old, and prints the two designs'
largest difference on the same inputs. ``--extra NAME=PATH`` builds and
times more variants of the source after them (design trials; their values
are not checked). ``--shapes`` times the new source
at every launch shape (chains a block, steps a chunk) that fits, beside
the shape the host picks.

``--split`` instead inserts ``clock64()`` stamps into a copy of the new
source and prints, at float32 and each B, the cycles a chain spends per
step in each part: ``wait`` (the `full` waits before a chunk), ``head``
(the step's own table reads), ``chain`` (the g/Q/h butterfly), ``cols``
(the column loop: S_n and P_{n+1}), ``tail`` (D, the reciprocal, W, the
next column rows and their __syncwarp), ``chunk_end`` (the logs, the
release, the wait on `empty` and the next copies) and the rest, with the
kernel's time with and without the stamps (the stamps serialise what the
compiler would overlap, and under the kernel's 168-register bound in
float32 at J <= 20 they spill, so there the parts are upper bounds);
``--shape CHAINS STEPS`` fixes the launch shape of the split. Run on a
machine with the card:

    git show a2862e4:pioran_tpu_torch/csrc/celerite_tables.cu > build/k0_old.cu
    python3 tools/k0_probe.py --old build/k0_old.cu [--shapes]
    python3 tools/k0_probe.py --split
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
from pioran_tpu_torch.ops.cuda_celerite import build_tables  # noqa: E402

J, N = 20, 485
HBM_BYTES_S = 3.35e12  # the H100 SXM's published HBM rate
PARTS = ("wait", "head", "chain", "cols", "tail", "chunk_end")
# (anchor, text inserted before it; None: after it)
STAMPS = [
    ("  for (int c = 0; c < nchunks; ++c) {\n    const int s = c % kStages;",
     "  long long pt[6] = {0, 0, 0, 0, 0, 0}, pc = 0, pq = 0;\n"
     "  const long long p_start = clock64();\n"),
    ("    mbar_wait(full + s, (c / kStages) & 1);", "    pc = clock64();\n"),
    ("    if (active) {\n      const T* sy = ys", "    pt[0] += clock64() - pc;\n"),
    ("          // this lane's V of step n + 1", "          pq = clock64();\n"),
    ("          // the serial chain: g_n",
     "          pt[1] += clock64() - pq;\n          pq = clock64();\n"),
    ("          // the shadow: S_n = ", "          pt[2] += clock64() - pq;\n          pq = clock64();\n"),
    ("          // the chain's scalars, one reciprocal",
     "          pt[3] += clock64() - pq;\n          pq = clock64();\n"),
    ("            qk = zpn * zpn * r;\n          }\n", None),
    ("      const int n_end = n0 + nk;", "      pc = clock64();\n"),
    ("      stage_chunk(cn);\n    }\n  }\n", None),
    ("    if (lane == 0) {\n      const T ll",
     "    if (lane == 0) {\n      long long* pr = k0_probe + 7 * chain;\n"
     "      for (int i = 0; i < 6; ++i) pr[i] = pt[i];\n      pr[6] = clock64() - p_start;\n"
     "    }\n"),
]
AFTER = {"            qk = zpn * zpn * r;\n          }\n": "          pt[4] += clock64() - pq;\n",
         "      stage_chunk(cn);\n    }\n  }\n": None}
PROBE_DECL = ("\n__device__ long long k0_probe[7 * 65536];\n"
              "extern \"C\" int k0_probe_read(void* out, int n) {\n"
              "  return static_cast<int>(cudaMemcpyFromSymbol(out, k0_probe, n * sizeof(long long)));\n}\n")


def _pattern(anchor: str) -> str:
    """The anchor as a regex that takes any indentation of its lines."""
    return "\n".join(r"[ ]*" + re.escape(ln.lstrip(" ")) if ln.strip() else re.escape(ln)
                     for ln in anchor.split("\n"))


def instrument(src: str) -> str:
    for anchor, text in STAMPS:
        found = re.findall(_pattern(anchor), src)
        if len(found) != 1:
            raise SystemExit(f"no anchor found once in the source: {anchor!r}")
        here = found[0]
        if text is not None:
            src = src.replace(here, text + here)
        elif anchor.startswith("      stage_chunk"):  # the chunk's end, after its copies
            src = src.replace(here, here[:-2] + "    pt[5] += clock64() - pc;\n  }\n")
        else:
            src = src.replace(here, here + AFTER[anchor])
    head, tail = src.split("namespace {", 1)
    return head + PROBE_DECL + "namespace {" + tail


def build(name: str, src_path: str) -> ctypes.CDLL:
    out_dir = os.path.join(os.path.dirname(HERE), "build", "k0_probe")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libk0_{name}.so")
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib, src_path],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(proc.stdout + proc.stderr)
    summary = [x for x in ptxas_summary(proc.stdout + proc.stderr).split("; ")
               if f",{(J + 3) // 4 * 4}," in x or ",24," in x]
    print(f"{name}: ptxas {summary}")
    out = ctypes.CDLL(lib)
    for fn in (out.celerite_tables_f32, out.celerite_tables_f64):
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    if hasattr(out, "celerite_tables_at_f32"):
        for fn in (out.celerite_tables_at_f32, out.celerite_tables_at_f64):
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return out


def host_shape(lib, B: int, item: int) -> str:
    """The launch shape the new source picks for B chains."""
    res = (ctypes.c_int * 5)()
    lib.celerite_tables_shape.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    assert lib.celerite_tables_shape(B, J, item, res) == 0
    return (f"chains={res[0]} steps={res[1]} smem={res[2]} blocks_per_sm={res[3]} "
            f"sms={res[4]}")


def inputs(B: int, dtype, dev):
    rng = np.random.default_rng(0)
    f = lambda x: torch.as_tensor(x, dtype=dtype, device=dev).contiguous()  # noqa: E731
    a, b = f(rng.uniform(0.1, 0.6, (B, J))), f(rng.uniform(0.0, 0.2, (B, J)))
    c, d = f(rng.uniform(0.05, 0.35, (B, J))), f(rng.uniform(0.0, 0.4, (B, J)))
    t = f(np.sort(rng.uniform(0, 100, N)))
    y, s2 = f(rng.normal(size=(B, N))), f(rng.uniform(0.05, 0.15, (B, N)))
    U, V, phi = build_tables(a, b, c, d, t)
    return U, V, phi, y, s2, a.sum(1).contiguous()


def runner(lib, args, shape=None):
    """A function that launches K0 once on ``args`` (and its output)."""
    U = args[0]
    B = U.shape[2]
    out = torch.empty(B, dtype=U.dtype, device=U.device)
    f32 = U.dtype == torch.float32
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ptrs = [ctypes.c_void_p(x.data_ptr()) for x in args] + [ctypes.c_void_p(out.data_ptr())]
    if shape is None:
        fn, extra = (lib.celerite_tables_f32 if f32 else lib.celerite_tables_f64), ()
    else:
        fn, extra = (lib.celerite_tables_at_f32 if f32 else lib.celerite_tables_at_f64), shape

    def run():
        e = fn(*ptrs, B, J, N, *extra, stream)
        assert e == 0, e
    return run, out


def ms(run, reps: int = 20) -> float:
    run()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        run()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def split(src_path: str, batches, dev, shape=None) -> int:
    out_dir = os.path.join(os.path.dirname(HERE), "build", "k0_probe")
    os.makedirs(out_dir, exist_ok=True)
    stamped = os.path.join(out_dir, "k0_stamped.cu")
    with open(src_path) as fh, open(stamped, "w") as out:
        out.write(instrument(fh.read()))
    with ThreadPoolExecutor(2) as ex:
        plain, probe = ex.map(lambda s: build(*s), [("plain", src_path), ("stamped", stamped)])
    probe.k0_probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for B in batches:
        data = inputs(B, torch.float32, dev)
        times = {name: ms(runner(lib, data, shape)[0]) for name, lib in (("plain", plain),
                                                                          ("stamped", probe))}
        buf = np.zeros(7 * B, dtype=np.int64)
        assert probe.k0_probe_read(buf.ctypes.data, 7 * B) == 0
        cyc = buf.reshape(B, 7).mean(0) / N
        rest = cyc[6] - cyc[:6].sum()
        print(f"K0 float32 B={B} J={J} N={N}: ms plain={times['plain']:.4f} "
              f"stamped={times['stamped']:.4f}; shape {shape or host_shape(plain, B, 4)}")
        print("  cycles per step (chain average): "
              + " ".join(f"{n}={x:.0f} ({x / cyc[6]:.1%})"
                         for n, x in zip(PARTS + ("rest", "total"),
                                         list(cyc[:6]) + [rest, cyc[6]])), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", help="another celerite_tables.cu to time beside the new one")
    ap.add_argument("--extra", nargs="*", default=[], help="NAME=PATH variants to time")
    ap.add_argument("--batches", type=int, nargs="*", default=[128, 1024, 4096])
    ap.add_argument("--shapes", action="store_true", help="time every launch shape")
    ap.add_argument("--split", action="store_true", help="cycles a step by part (float32)")
    ap.add_argument("--shape", type=int, nargs=2, metavar=("CHAINS", "STEPS"),
                    help="launch shape of the split runs (default: the host's pick)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k0_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    new_src = os.path.join(_build.CSRC_DIR, "celerite_tables.cu")
    if args.split:
        return split(new_src, args.batches, dev, args.shape)
    srcs = [("new", new_src)]
    if args.old:
        srcs.append(("old", args.old))
    srcs += [tuple(x.split("=", 1)) for x in args.extra]
    with ThreadPoolExecutor(len(srcs)) as ex:
        libs = dict(zip([s[0] for s in srcs], ex.map(lambda s: build(*s), srcs)))
    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        item = torch.empty((), dtype=dtype).element_size()
        for B in args.batches:
            data = inputs(B, dtype, dev)
            nbytes = item * (3 * N * 2 * J * B + 2 * B * N + 2 * B)
            sh = host_shape(libs["new"], B, item)
            new_run, new_out = runner(libs["new"], data)
            line = f"K0 {name} B={B} J={J} N={N}: "
            if "old" in libs:
                old_run, old_out = runner(libs["old"], data)
                t = [ms(old_run), ms(new_run), ms(new_run), ms(old_run)]
                fin = torch.isfinite(old_out)
                assert torch.equal(fin, torch.isfinite(new_out)), "-inf lanes differ"
                rel = float(((new_out[fin] - old_out[fin]).abs() / old_out[fin].abs()).max())
                old_ms, new_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
                line += (f"old_ms={old_ms:.4f} ({t[0]:.4f}, {t[3]:.4f}) new_ms={new_ms:.4f} "
                         f"({t[1]:.4f}, {t[2]:.4f}) speedup={old_ms / new_ms:.3f} "
                         f"max_rel_diff={rel:.3e} ")
            else:
                new_ms = ms(new_run)
                line += f"new_ms={new_ms:.4f} "
            line += (f"achieved={nbytes / new_ms * 1e-9:.4f} TB/s "
                     f"({nbytes / new_ms * 1e3 / HBM_BYTES_S:.2%} of 3.35); host shape {sh}")
            print(line, flush=True)
            for name_x, _ in srcs[2 if args.old else 1:]:
                run, _ = runner(libs[name_x], data)
                print(f"  {name_x}: ms={ms(run):.4f}", flush=True)
            if args.shapes:
                res = []
                for C in (1, 2, 4, 8):
                    for K in (4, 8, 16, 32):
                        run, _ = runner(libs["new"], data, (C, K))
                        try:
                            run()
                        except AssertionError:
                            continue  # the shape does not fit
                        res.append(f"({C},{K})={ms(run):.4f}")
                print(f"  shapes (chains, steps)=ms: {' '.join(res)}", flush=True)
            del data
    return 0


if __name__ == "__main__":
    sys.exit(main())
