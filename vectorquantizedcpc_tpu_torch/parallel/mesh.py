"""The (data, model) mesh's ranks: their launch, process groups and cards.

The counterpart of the JAX package's ``parallel/mesh.py``. JAX runs the
devices of its mesh inside one process per host; PyTorch runs one process
per card. A mesh of ``runtime.mesh_data`` = D by ``runtime.mesh_model`` = M
is therefore D x M processes, the ranks of one ``torch.distributed``
process group, each on its own card, started by torchrun
(``torch.distributed.run``). As JAX's ``make_mesh`` reshapes its devices
to (data, model) with the model axis contiguous, global rank = d M + m:

- a model group per data rank d: the M contiguous ranks d M .. d M + M - 1,
  which hold the shards of one train state and see the same batch share;
- a data group per model rank m: the D ranks d M + m, which hold the same
  shards and sum their gradients.

The JAX keys keep their meaning:

- ``mesh_data = D`` and ``mesh_model = M`` alone: the CLI starts D x M
  local ranks (``--standalone``); rank i runs on ``cuda:i``, as one JAX
  command uses D x M local devices;
- ``coordinator_address``, ``num_processes`` and ``process_id``: a cluster
  of ``num_processes`` hosts. Each host's CLI starts ``D M /
  num_processes`` local ranks as node ``process_id`` (global rank =
  ``process_id x local + local_rank``), whole model groups only; they meet
  at ``coordinator_address`` ("host:port");
- under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` set) the
  process is a rank already, the counterpart of JAX's pod auto-detection;
  D is the world over M.

A rank finds its place the same way in all three cases (``mesh_from_conf``).
The backend is NCCL for ranks on their own cards and gloo on the CPU or
when ranks share one card (``runtime.platform=cuda:N``).
"""

import os
from typing import List, NamedTuple, Optional

import torch
import torch.distributed as dist

from ..device import local_device
from .tensor import ModelGroup


class DataMesh(NamedTuple):
    """This process's place on the mesh: its data rank ``rank`` of
    ``world`` (D) and their ``group`` (None for D = 1), its card, and with
    M > 1 its ``model`` group."""

    group: Optional["dist.ProcessGroup"]
    rank: int
    world: int
    device: torch.device
    model: Optional[ModelGroup] = None


_MESH: Optional[tuple] = None  # (the world group, its DataMesh): new_group runs once


def check_runtime(runtime) -> None:
    """The mesh keys a run can take."""
    for key in ("mesh_data", "mesh_model"):
        if getattr(runtime, key) < 1:
            raise ValueError(f"runtime.{key}={getattr(runtime, key)} must be at least 1")
    cluster = (runtime.coordinator_address, runtime.num_processes, runtime.process_id)
    if any(v is not None for v in cluster) and any(v is None for v in cluster):
        raise ValueError(
            "runtime.coordinator_address, num_processes and process_id describe a cluster "
            f"together; got {cluster}"
        )


def _is_rank() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def launch_args(runtime) -> Optional[List[str]]:
    """torchrun's options for the ranks this CLI process must start, or
    None when it is a rank itself (started by torchrun) or the mesh is
    1 x 1. Raises before anything starts when the keys or the cards do not
    fit."""
    check_runtime(runtime)
    ranks = runtime.mesh_data * runtime.mesh_model
    if _is_rank() or (ranks == 1 and runtime.num_processes in (None, 1)):
        return None
    if runtime.num_processes is None:
        local, args = ranks, ["--standalone"]
    else:
        if ranks % runtime.num_processes or (ranks // runtime.num_processes) % runtime.mesh_model:
            raise ValueError(
                f"runtime.mesh_data x mesh_model = {runtime.mesh_data} x {runtime.mesh_model} "
                f"ranks do not divide over runtime.num_processes={runtime.num_processes} hosts "
                "in whole model groups (each host must hold a multiple of mesh_model ranks)"
            )
        if not 0 <= runtime.process_id < runtime.num_processes:
            raise ValueError(f"runtime.process_id={runtime.process_id} is not one of "
                             f"{runtime.num_processes} hosts")
        addr, _, port = runtime.coordinator_address.rpartition(":")
        if not addr or not port.isdigit():
            raise ValueError(f"runtime.coordinator_address={runtime.coordinator_address!r} "
                             "is not host:port")
        local = ranks // runtime.num_processes
        args = [f"--nnodes={runtime.num_processes}", f"--node-rank={runtime.process_id}",
                f"--master-addr={addr}", f"--master-port={port}"]
    local_device(runtime.platform, local - 1, local)  # more ranks than cards raises
    return [f"--nproc-per-node={local}", *args]


def start_ranks(args: List[str], module: str, argv: List[str]) -> None:
    """``python -m module argv...`` in each rank that torchrun's ``args``
    describe, waiting for all; when one fails torchrun stops the others and
    this raises."""
    from torch.distributed.run import main as torchrun

    torchrun([*args, "--module", module, *argv])


def backend_for(device: torch.device, platform: Optional[str], local_world: int) -> str:
    """NCCL for ranks on their own cards; gloo on the CPU and for ranks
    that share one card."""
    shared = platform is not None and ":" in str(platform) and local_world > 1
    return "nccl" if device.type == "cuda" and not shared else "gloo"


def initialize_distributed(runtime) -> DataMesh:
    """Join the process group as the rank the environment names (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), once,
    and make the mesh's data and model groups, once; returns this rank's
    place. Every rank makes every group, in the same order, as
    ``new_group`` requires."""
    global _MESH
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    device = local_device(runtime.platform, local_rank, local_world)
    m_size = runtime.mesh_model
    if world % m_size:
        raise ValueError(f"runtime.mesh_model={m_size} does not divide the process group's "
                         f"{world} ranks")
    if not dist.is_initialized():
        backend = backend_for(device, runtime.platform, local_world)
        kwargs = {}
        if backend == "nccl":
            torch.cuda.set_device(device)
            kwargs["device_id"] = device
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                                **kwargs)
        if rank == 0 and world > 1:
            print(f"Mesh: data={world // m_size} model={m_size} ({backend})", flush=True)
    if _MESH is not None and _MESH[0] is dist.group.WORLD:
        return _MESH[1]
    rank, world = dist.get_rank(), dist.get_world_size()
    d_size, d, m = world // m_size, rank // m_size, rank % m_size
    if m_size == 1:
        mesh = DataMesh(dist.group.WORLD, rank, world, device)
    else:
        model = data = None
        for i in range(d_size):  # the model groups, then the data groups
            g = dist.new_group([i * m_size + j for j in range(m_size)])
            model = g if i == d else model
        for j in range(m_size):
            g = dist.new_group([i * m_size + j for i in range(d_size)]) if d_size > 1 else None
            data = g if j == m else data
        mesh = DataMesh(data, d, d_size, device, ModelGroup(model, m, m_size))
    _MESH = (dist.group.WORLD, mesh)
    return mesh


def mesh_from_conf(runtime) -> Optional[DataMesh]:
    """This process's place on the mesh, or None for one process (the
    1 x 1 mesh). The trainers' one entry point, as in the JAX package.

    A rank (started by torchrun) joins its process group here, unless its
    process joined one already. A mesh of more than one rank in a process
    that is no rank raises: the CLI starts the ranks.
    """
    check_runtime(runtime)
    if _is_rank():
        mesh = initialize_distributed(runtime)
        if runtime.mesh_data not in (1, mesh.world):
            raise ValueError(f"runtime.mesh_data={runtime.mesh_data} but the process group "
                             f"has {mesh.world} x {runtime.mesh_model} ranks")
        return None if dist.get_world_size() == 1 else mesh
    if runtime.mesh_data * runtime.mesh_model > 1:
        n = runtime.mesh_data * runtime.mesh_model
        raise RuntimeError(
            f"runtime.mesh_data x mesh_model = {runtime.mesh_data} x {runtime.mesh_model} "
            f"needs {n} ranks: start them through the CLI (python -m "
            "vectorquantizedcpc_tpu_torch.cli.train_cpc runtime.mesh_data=D "
            "runtime.mesh_model=M ...) or torchrun"
        )
    return None


def barrier(mesh: Optional[DataMesh]) -> None:
    """Every rank of the mesh waits here for the others; nothing with one process."""
    if mesh is not None:
        dist.barrier()


def is_main(mesh: Optional[DataMesh]) -> bool:
    """Global rank 0, the one that writes to disk (or the only process)."""
    return mesh is None or dist.get_rank() == 0
