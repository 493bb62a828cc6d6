"""The port imports nothing of JAX and nothing of the JAX package.

In a fresh interpreter where ``import jax`` fails, ``pioran_tpu_torch``
and every one of its submodules import, and afterwards no ``jax`` or
``jaxlib`` module and no ``pioran_tpu`` module is loaded. The card's
machine has no JAX, so a stray import there would stop the port.
"""

import json
import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
for name in ("jax", "jaxlib"):
    sys.modules[name] = None  # any import of them raises ImportError
import pioran_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(pioran_tpu_torch.__path__,
                                                     "pioran_tpu_torch."))
for name in names:
    importlib.import_module(name)
loaded = [m for m, mod in sys.modules.items() if mod is not None and (
    m.split(".")[0] in ("jax", "jaxlib", "pioran_tpu"))]
print(json.dumps({"modules": names, "loaded": loaded}))
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    for name in ("pioran_tpu_torch.diagnostics.ppc", "pioran_tpu_torch.diagnostics.lsp",
                 "pioran_tpu_torch.diagnostics.approx_checks", "pioran_tpu_torch.models.gp",
                 "pioran_tpu_torch.utils.subset", "pioran_tpu_torch.utils.samples",
                 "pioran_tpu_torch.inference", "pioran_tpu_torch.ops.cuda_celerite",
                 "pioran_tpu_torch.checkpoint", "pioran_tpu_torch.parallel.mesh",
                 "pioran_tpu_torch.parallel.sharded", "pioran_tpu_torch.parallel.seq_scan",
                 "pioran_tpu_torch.ops.kalman", "pioran_tpu_torch.examples._common",
                 "pioran_tpu_torch.examples.single_pl", "pioran_tpu_torch.examples.double_pl",
                 "pioran_tpu_torch.examples.single_pl_periodicity",
                 "pioran_tpu_torch.examples.carma", "pioran_tpu_torch.examples.parity"):
        assert name in res["modules"], name
