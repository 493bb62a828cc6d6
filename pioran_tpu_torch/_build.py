"""Build and load the port's CUDA kernels at first use.

Each kernel source under ``pioran_tpu_torch/csrc/`` has a plain C
interface. It is compiled by ``nvcc`` for ``sm_90a`` into a shared
library under ``build/pioran_tpu_torch/`` beside the package (listed in
``.gitignore``) and loaded with ``ctypes``. The library's file name
carries a hash of the source and the flags, so an edited source is
rebuilt and a built one is reused within a checkout. Nothing here runs
at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "pioran_tpu_torch")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# name -> (library, seconds the build took (0.0 when reused), nvcc's output)
_LOADED: Dict[str, Tuple[ctypes.CDLL, float, str]] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the CUDA kernels are built from source at first use")


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu``, compiled on first
    use. Raises ``RuntimeError`` with nvcc's output if the build or the
    load fails."""
    if name in _LOADED:
        return _LOADED[name][0]
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha1(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(lib_path):
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {src}:\n"
                f"{' '.join(cmd)}\n{log}")
        os.replace(tmp, lib_path)  # atomic: concurrent builds agree
    try:
        lib = ctypes.CDLL(lib_path)
    except OSError as e:
        raise RuntimeError(f"loading {lib_path} failed: {e}\n{log}") from e
    _LOADED[name] = (lib, seconds, log)
    return lib


def load_all(names: Sequence[str]) -> List[ctypes.CDLL]:
    """:func:`load` for several sources, their nvcc builds run at once
    (one process each)."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as ex:
        return list(ex.map(load, names))


def build_info(name: str) -> Tuple[float, str]:
    """(build seconds, nvcc output) of a loaded library; seconds is 0.0
    when an earlier build in this checkout was reused."""
    _, seconds, log = _LOADED[name]
    return seconds, log
