"""Shared parts of the example scripts: their device, dtype and mesh
options, the set-up those options ask for, figures and the printed
results.

Nothing here imports torch at module level, so a script's ``--help``
parses before the heavy imports.
"""

from __future__ import annotations

import os

MESH_HELP = ("shard the sampler over N processes, one GPU each (-1: all; "
             "0: all when more than one process is running, else a single "
             "GPU); launch with torchrun --nproc_per_node=N")
DISTRIBUTED_HELP = ("join a multi-node torch.distributed process group and use "
                    "the global ('hosts','chains') mesh (the analog of the "
                    "reference's mpirun/julia -p runs); launch with torchrun "
                    "on every node")


def add_mesh_options(ap) -> None:
    ap.add_argument("--mesh", type=int, default=0, metavar="N", help=MESH_HELP)
    ap.add_argument("--distributed", action="store_true", help=DISTRIBUTED_HELP)


def add_device_options(ap) -> None:
    """``--dtype`` (the JAX scripts' ``--x64``) and ``--cpu``."""
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64"],
                    help="working dtype of the data and the likelihood")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the card otherwise; without one the run stops)")


def setup(args):
    """(device, dtype, mesh) for a script's parsed options.

    The mesh comes first (``parallel.driver_mesh``: ``--mesh`` and
    ``--distributed`` under torchrun), since every rank builds its spec
    on its own device. ``--cpu`` runs on the CPU; otherwise the device is
    the rank's GPU, or the card, and without a card this raises
    ``RuntimeError`` before anything is written: there is no CPU
    fallback.
    """
    import torch

    from ..config import resolve_device
    from ..parallel import driver_mesh
    from ..parallel.mesh import mesh_device

    mesh = driver_mesh(args.mesh, args.distributed)
    if args.cpu:
        device = torch.device("cpu")
    elif mesh is not None:
        device = mesh_device(mesh)
    else:
        device = resolve_device(None)
    if mesh is not None:
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        print(f"mesh: {shape} over {mesh.size()} device(s)")
    return device, getattr(torch, args.dtype), mesh


def figures_available() -> bool:
    """Whether matplotlib imports; when it does not, say that the figures
    are skipped (the .txt outputs are written all the same)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("matplotlib is not installed: figures skipped, the .txt outputs written")
        return False
    return True


def print_results(results, out, fmt: str = "+.5f", logzerr: bool = False) -> None:
    """The posterior table, logZ and the elapsed time, as the JAX scripts
    print them."""
    for n, m, s in zip(results["paramnames"], results["posterior"]["mean"],
                       results["posterior"]["stdev"]):
        print(f"  {n:10s} {m:{fmt}} +/- {s:{fmt[1:]}}")
    if "logz" in results:
        err = (f" +- {results['logzerr']:.3f}"
               if logzerr and "logzerr" in results else "")
        print(f"  logZ = {results['logz']:.3f}{err}")
    print(f"  elapsed: {results['elapsed_s']:.1f}s -> {out}")


def ppc_subset(samples):
    """At most 200 posterior rows without replacement (numpy seed 0), as
    the JAX scripts pick them for the posterior predictive checks."""
    import numpy as np

    pick = np.random.default_rng(0).choice(len(samples), size=min(200, len(samples)),
                                           replace=False)
    return samples[pick]


def plots_dir(out) -> str:
    return os.path.join(out, "plots") + os.sep
