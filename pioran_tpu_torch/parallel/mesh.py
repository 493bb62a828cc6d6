"""Process groups and device meshes, PyTorch port of ``pioran_tpu.parallel.mesh``.

The reference's distributed story is multi-process on CPU: ``julia -p 6``
and ``pmap`` over chains (reference examples/turing_distributed/
single_pl.jl:1,80-81) and an MPI worker farm for ultranest likelihood
sweeps (reference examples/ultranest/single_pl.jl:19-21). The JAX package
drives every device from one process with a ``jax.sharding.Mesh``. Here,
as in ``torch.distributed``, there is one process per GPU: every rank
calls the same function with the same arguments, holds its own shard on
``cuda:LOCAL_RANK``, and the ranks meet in collectives (NCCL on the card,
gloo on the CPU). The mesh is PyTorch's own
``torch.distributed.device_mesh.DeviceMesh`` with named dimensions; its
``size`` of an axis stands for the JAX mesh's ``shape[axis]``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "make_mesh",
    "make_mesh_2d",
    "local_chain_count",
    "initialize_distributed",
    "host_local_to_global",
    "driver_mesh",
]


def _int_env(name: str) -> int:
    try:
        return int(os.environ.get(name, ""))
    except ValueError:
        return 0


def _cluster_env() -> Optional[Tuple[int, int, int]]:
    """(rank, world size, local rank) when a launcher describes more than
    one process: torchrun's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``, SLURM
    tasks or Open MPI ranks (the environments the JAX package's
    ``_detect_cluster_env`` knows, less the TPU pod's). Single-process
    launches (``srun -n 1``, ``mpirun -n 1``) give None."""
    if _int_env("WORLD_SIZE") > 1:
        return _int_env("RANK"), _int_env("WORLD_SIZE"), _int_env("LOCAL_RANK")
    if os.environ.get("SLURM_JOB_ID") and _int_env("SLURM_NTASKS") > 1:
        return _int_env("SLURM_PROCID"), _int_env("SLURM_NTASKS"), _int_env("SLURM_LOCALID")
    if _int_env("OMPI_COMM_WORLD_SIZE") > 1:
        return (_int_env("OMPI_COMM_WORLD_RANK"), _int_env("OMPI_COMM_WORLD_SIZE"),
                _int_env("OMPI_COMM_WORLD_LOCAL_RANK"))
    return None


def _local_world_size(world: int) -> int:
    """Processes on this node, from the launcher; the whole world when no
    launcher says (one node)."""
    for name in ("LOCAL_WORLD_SIZE", "SLURM_NTASKS_PER_NODE", "OMPI_COMM_WORLD_LOCAL_SIZE"):
        n = _int_env(name)
        if n > 0:
            return n
    return world


def initialize_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                           rank: Optional[int] = None, **kwargs) -> bool:
    """Join the process group; True when it holds more than one process.

    Initializes ``torch.distributed`` when called with a world size, or
    when torchrun, SLURM or Open MPI describe more than one process (the
    rendezvous then comes from ``MASTER_ADDR``/``MASTER_PORT``,
    ``init_method="env://"``). The backend is NCCL when CUDA is present,
    with ``torch.cuda.set_device`` of the launcher's local rank (0 when
    none is given), and gloo otherwise.
    Failures propagate: a misconfigured multi-process launch must stop,
    not run each process as a group of one. With no configuration at all
    this is a no-op returning False, so drivers can call it
    unconditionally, as the reference's drivers call ``MPI.Init()``
    (examples/ultranest/single_pl.jl:19-21). ``kwargs`` go to
    ``init_process_group`` (``timeout``, ...).
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    local_rank = _int_env("LOCAL_RANK")
    if world_size is None:
        env = _cluster_env()
        if env is None:
            return False
        rank, world_size, local_rank = env
    if rank is None:
        raise ValueError("initialize_distributed: a world_size needs its rank")
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend="nccl" if cuda else "gloo",
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kwargs)
    return dist.get_world_size() > 1


def _check_backend(device_type: str) -> None:
    """A CUDA mesh runs on NCCL, a CPU mesh on gloo; nothing else."""
    want = "nccl" if device_type == "cuda" else "gloo"
    backend = str(dist.get_backend())
    if want not in backend:
        raise RuntimeError(f"a {device_type} mesh needs the {want} backend, "
                           f"the process group has {backend!r}")


def _require_group() -> None:
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "parallel.initialize_distributed() (one process per GPU) first")


def _device_type(device_type: Optional[str]) -> str:
    return device_type or ("cuda" if torch.cuda.is_available() else "cpu")


def make_mesh(axis_name: str = "chains", device_type: Optional[str] = None):
    """A 1-D ``DeviceMesh`` over every rank of the process group, its one
    dimension named ``axis_name``. ``device_type``: "cuda" (NCCL) or
    "cpu" (gloo); the card when there is one.

    One axis is the right shape on one host: chains and particles are
    embarrassingly parallel, so the axis carries them and the only
    collectives are warmup pooling and evidence reductions.
    """
    from torch.distributed.device_mesh import init_device_mesh

    _require_group()
    device_type = _device_type(device_type)
    _check_backend(device_type)
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


def make_mesh_2d(axis_names: Tuple[str, str] = ("hosts", "chains"),
                 device_type: Optional[str] = None):
    """The (nodes x processes per node) ``DeviceMesh``: row h holds node
    h's ranks, so collectives over ``axis_names[0]`` cross nodes and
    those over ``axis_names[1]`` stay on a node. Processes per node come
    from the launcher (``LOCAL_WORLD_SIZE``, SLURM, Open MPI), else the
    whole group is one node. Every node must run as many processes."""
    from torch.distributed.device_mesh import init_device_mesh

    _require_group()
    device_type = _device_type(device_type)
    _check_backend(device_type)
    world = dist.get_world_size()
    per_node = _local_world_size(world)
    if world % per_node:
        raise ValueError(f"{world} processes not divisible by {per_node} per node")
    return init_device_mesh(device_type, (world // per_node, per_node),
                            mesh_dim_names=tuple(axis_names))


def driver_mesh(n_devices: int = 0, distributed: bool = False,
                axes: Tuple[str, str] = ("hosts", "chains")):
    """Top-of-script mesh setup for drivers, the analog of the
    reference drivers' opening ``MPI.Init()`` / ``julia -p 6``:

    - ``distributed=True``: join the process group
      (:func:`initialize_distributed`; launch with ``torchrun
      --nproc_per_node=<n> script.py``) and build the (nodes x processes
      per node) mesh of :func:`make_mesh_2d`.
    - ``n_devices > 0``: a 1-D mesh named ``axes[-1]`` over a process
      group of exactly ``n_devices`` ranks; one process with no group
      and ``n_devices == 1`` is a plain one-GPU run (None). One process
      drives one GPU, so more devices need more processes.
    - otherwise: the 1-D mesh over the process group when it holds more
      than one rank, else None (a plain one-GPU run).
    """
    if distributed:
        initialize_distributed()
        return make_mesh_2d(axes)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices > 0:
        if n_devices != world:
            raise ValueError(
                f"--mesh {n_devices} requested but the process group holds {world} "
                f"process(es): one process drives one GPU, so launch with "
                f"torchrun --nproc_per_node={n_devices}")
        return make_mesh(axes[-1]) if dist.is_initialized() else None
    if world > 1:
        return make_mesh(axes[-1])
    return None


def _axis_names(mesh, axis_name) -> Tuple[str, ...]:
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    for a in names:
        if a not in mesh.mesh_dim_names:
            raise ValueError(f"mesh has no axis {a!r}; its axes are {mesh.mesh_dim_names}")
    return names


def axis_size(mesh, axis_name) -> int:
    """The number of ranks along one named axis, or the product over a
    tuple of names (a batch sharded over both axes of the 2-D mesh)."""
    n = 1
    for a in _axis_names(mesh, axis_name):
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def axis_group(mesh, axis_name):
    """(process group, this rank's index along the axis, the axis size).
    A tuple of names must cover every axis of the mesh, which covers the
    whole process group; ranks then count in the mesh's row-major order,
    which is the group's."""
    names = _axis_names(mesh, axis_name)
    if len(names) == 1:
        group = mesh.get_group(names[0])
        return group, mesh.get_local_rank(names[0]), axis_size(mesh, names)
    if names != tuple(mesh.mesh_dim_names):
        raise ValueError(f"a batch sharded over several axes must cover the mesh's axes "
                         f"{mesh.mesh_dim_names} in order, got {names}")
    if axis_size(mesh, names) != dist.get_world_size():
        raise ValueError("the mesh does not cover the whole process group")
    return dist.group.WORLD, dist.get_rank(), dist.get_world_size()


def mesh_device(mesh) -> torch.device:
    """This rank's device on the mesh: ``cuda:<current device>`` on a CUDA
    mesh (``initialize_distributed`` sets it from the local rank), the
    CPU on a CPU mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def check_device(mesh, device, what: str = "the spec") -> None:
    """Raise unless ``device`` is this rank's own device on the mesh, and
    unless the mesh's collectives run on the backend for its device."""
    own = mesh_device(mesh)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev != own:
        raise ValueError(f"{what} is on {dev}, but this rank's device on the mesh is {own}")
    _check_backend(mesh.device_type)


def local_chain_count(total_chains: int, mesh, axis_name="chains") -> int:
    """Chains each rank holds when ``total_chains`` are sharded over the
    axis; raises unless they divide evenly."""
    n_dev = axis_size(mesh, axis_name)
    if total_chains % n_dev != 0:
        raise ValueError(
            f"total_chains={total_chains} must be divisible by mesh axis size {n_dev}")
    return total_chains // n_dev


def host_local_to_global(mesh, axis_name, local):
    """The global batch from every rank's local rows: an ``all_gather``
    along dim 0 over the axis, in rank order, returned on every rank.

    The port has no global sharded array, as JAX's
    ``make_array_from_process_local_data`` makes one: each rank holds a
    whole copy of the gathered tensor. Every rank's ``local`` must have
    the same shape.
    """
    group, _, n = axis_group(mesh, axis_name)
    local = local.contiguous()
    out = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(out, local, group=group)
    return torch.cat(out, dim=0)
