"""Multi-GPU parallelism: process groups, device meshes and sharded samplers.

The reference's distributed story is process-level: Distributed.jl
``pmap`` over chains and MPI worker farms for ultranest likelihoods
(reference examples/turing_distributed/single_pl.jl:1,80-81,
examples/ultranest/single_pl.jl:19-21). The port runs one process per GPU
on ``torch.distributed`` (NCCL on the card, gloo on the CPU):

- a 1-D or ("hosts", "chains") ``DeviceMesh``;
- chains and particles sharded over the mesh, one slice per rank;
- cross-chain warmup pooling, the SMC temperature search and resampling,
  and ChEES's adaptation statistics as ``all_reduce``/``all_gather``;
- the time axis of one long light curve split into blocks over the ranks
  of a "seq" axis (``seq_scan``: the blockwise celerite scan, the state
  handed from rank to rank by point-to-point calls, chain micro-batches
  pipelined round the ring; the builders' ``seq_mesh=`` and
  ``ops.celerite.logl(mesh=)`` route through it).

Launch with ``torchrun --nproc_per_node=<n> script.py`` and build the mesh
with ``driver_mesh(distributed=True)``.
"""

from .mesh import (
    driver_mesh,
    host_local_to_global,
    initialize_distributed,
    local_chain_count,
    make_mesh,
    make_mesh_2d,
)
from .seq_scan import factor_solve_seq_sharded, logl_seq_pipelined, logl_seq_sharded
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
    "logl_seq_sharded",
    "factor_solve_seq_sharded",
    "logl_seq_pipelined",
]
