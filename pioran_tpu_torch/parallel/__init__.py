"""Multi-GPU parallelism: process groups, device meshes and sharded samplers.

The reference's distributed story is process-level: Distributed.jl
``pmap`` over chains and MPI worker farms for ultranest likelihoods
(reference examples/turing_distributed/single_pl.jl:1,80-81,
examples/ultranest/single_pl.jl:19-21). The port runs one process per GPU
on ``torch.distributed`` (NCCL on the card, gloo on the CPU):

- a 1-D or ("hosts", "chains") ``DeviceMesh``;
- chains and particles sharded over the mesh, one slice per rank;
- cross-chain warmup pooling, the SMC temperature search and resampling,
  and ChEES's adaptation statistics as ``all_reduce``/``all_gather``.

Launch with ``torchrun --nproc_per_node=<n> script.py`` and build the mesh
with ``driver_mesh(distributed=True)``. The JAX package's time-sharded
blockwise scan (``parallel/seq_scan.py``) is not ported.
"""

from .mesh import (
    driver_mesh,
    host_local_to_global,
    initialize_distributed,
    local_chain_count,
    make_mesh,
    make_mesh_2d,
)
from .sharded import (
    run_chees_sharded,
    run_nuts_sharded,
    run_smc_sharded,
    run_ns_sharded,
    sharded_batched_fn,
)

__all__ = [
    "driver_mesh",
    "make_mesh",
    "make_mesh_2d",
    "local_chain_count",
    "initialize_distributed",
    "host_local_to_global",
    "run_chees_sharded",
    "run_nuts_sharded",
    "run_smc_sharded",
    "run_ns_sharded",
    "sharded_batched_fn",
]
