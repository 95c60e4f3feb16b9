"""Process groups, device meshes and rank launching (port of
``caelo_tpu/parallel/mesh.py``).

The JAX package names its parallel axes on a ``jax.sharding.Mesh``; here a
``torch.distributed.device_mesh.DeviceMesh`` carries the same two named
dimensions over the ranks of a process group, one rank per device:

* ``"data"``: frame- and batch-level data parallelism;
* ``"model"``: tensor parallelism over the patch AE's dense layers.

The backend follows the device: NCCL for CUDA ranks, gloo for CPU ranks.
Every sharded function of the port is SPMD: each rank of the mesh calls it
with the same global arguments and works on its own contiguous block of
the sharded axis (``shard_rows``); ``all_gather_rows`` assembles the whole.
"""
from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

AXES = ("data", "model")


def backend_for(device_type: str) -> str:
    """The process-group backend of ``device_type``: NCCL for CUDA, gloo
    for the CPU.  A CUDA world without NCCL raises rather than take gloo."""
    if device_type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA world needs NCCL, which this PyTorch "
                               "build lacks")
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device_type!r}")


def make_mesh(n_data: int | None = None, n_model: int = 1,
              device_type: str | None = None, ranks=None) -> DeviceMesh:
    """An ``(n_data, n_model)`` mesh named ``("data", "model")`` over
    ``ranks`` (default: every rank of the initialised world), row-major as
    the JAX mesh lays out its devices.  Every rank of the world must call
    it (it makes process groups); a rank outside ``ranks`` gets a mesh it
    is not part of.  ``device_type`` defaults to the world's: CUDA under
    NCCL, else the CPU."""
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    if n_data is None:
        n_data = len(ranks) // n_model
    if n_data < 1 or n_data * n_model > len(ranks):
        raise ValueError(f"a ({n_data}, {n_model}) mesh does not fit "
                         f"{len(ranks)} ranks")
    grid = torch.tensor(ranks[:n_data * n_model]).reshape(n_data, n_model)
    return DeviceMesh(device_type, grid, mesh_dim_names=AXES)


_WORLD_MESH: list = []      # [(the default process group, its make_mesh())]


def world_mesh() -> DeviceMesh:
    """``make_mesh()`` over the whole initialised world, made once per
    process group and then reused: each ``make_mesh`` makes new process
    groups (communicators), which live as long as the world."""
    world = dist.group.WORLD
    if not _WORLD_MESH or _WORLD_MESH[0][0] is not world:
        _WORLD_MESH[:] = [(world, make_mesh())]
    return _WORLD_MESH[0][1]


def data_sharding(mesh: DeviceMesh):
    """DTensor placements of an array whose leading axis is sharded over
    ``"data"`` and replicated over ``"model"`` (JAX's ``P("data")``)."""
    return (Shard(0), Replicate())


def replicated(mesh: DeviceMesh):
    """DTensor placements of an array every rank holds whole (``P()``)."""
    return (Replicate(), Replicate())


def axis(mesh: DeviceMesh, name: str = "data"):
    """``(group, index, size)`` of this rank along the mesh dimension
    ``name``."""
    return (mesh.get_group(name), mesh.get_local_rank(name),
            mesh.size(AXES.index(name)))


def block(n: int, index: int, size: int) -> slice:
    """The contiguous block of ``n`` rows that rank ``index`` of ``size``
    owns; the blocks are equal, so ``n`` must divide evenly."""
    if n % size:
        raise ValueError(f"{n} rows do not split evenly over {size} ranks")
    b = n // size
    return slice(index * b, (index + 1) * b)


def shard_rows(x, mesh: DeviceMesh, name: str = "data"):
    """This rank's block of the leading axis of ``x`` (a tensor, or a tuple
    or NamedTuple of tensors)."""
    if isinstance(x, tuple):
        return _like(x, (shard_rows(f, mesh, name) for f in x))
    _, index, size = axis(mesh, name)
    return x[block(x.shape[0], index, size)]


def all_gather_rows(x, mesh: DeviceMesh, name: str = "data"):
    """The blocks of every rank along ``name``, concatenated in rank order
    on the leading axis (a tensor, or a tuple or NamedTuple of
    tensors)."""
    if isinstance(x, tuple):
        return _like(x, (all_gather_rows(f, mesh, name) for f in x))
    group, _, size = axis(mesh, name)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def _like(x: tuple, fields) -> tuple:
    """``fields`` as a tuple of ``x``'s type (a NamedTuple or a tuple)."""
    return type(x)(*fields) if hasattr(x, "_fields") else tuple(fields)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, returned as a new tensor."""
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x


def broadcast_module(module: torch.nn.Module, group) -> None:
    """Copy the parameters and buffers of ``module`` on the first rank of
    ``group`` into every other rank's ``module``, in place."""
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in (*module.parameters(), *module.buffers()):
            dist.broadcast(t.data, src=src, group=group)


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device_type: str = "cuda"):
    """Join a world of ``num_processes`` ranks whose rendezvous is
    ``coordinator`` (``host:port`` or any ``init_method`` URL).  A single
    process returns at once, as the JAX function does."""
    if num_processes is None or num_processes <= 1:
        return
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    dist.init_process_group(backend_for(device_type), init_method=coordinator,
                            world_size=num_processes, rank=process_id)


def run_ranks(fn, n_ranks: int, args=(), device_type: str = "cuda") -> list:
    """Spawn ``n_ranks`` processes, each one rank of a fresh world (NCCL on
    CUDA device ``rank``, or gloo on the CPU with one torch thread a rank,
    as the ranks share the host's cores) that rendezvous through a file in
    a temporary directory, and
    return ``[fn(rank, n_ranks, *args) for each rank]``.

    ``fn`` must be importable by name (a module-level function) and return
    CPU tensors or plain data.  A rank that raises makes this raise; every
    process has ended when it returns."""
    import torch.multiprocessing as mp

    backend_for(device_type)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, nprocs=n_ranks, join=True,
                 args=(fn, n_ranks, device_type, tmp, args))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(n_ranks)]


def _rank_main(rank, fn, world, device_type, tmp, args):
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend_for(device_type), world_size=world,
                            rank=rank,
                            init_method="file://" + os.path.join(tmp, "store"))
    try:
        out = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
