"""The data-parallel ranks: their launch, process group and cards.

The counterpart of the JAX package's ``parallel/mesh.py``. JAX runs the
devices of its data axis inside one process per host; PyTorch runs one
process per card. A mesh of ``runtime.mesh_data`` = N is therefore N
processes, the ranks of one ``torch.distributed`` process group, each on
its own card, started by torchrun (``torch.distributed.run``). The JAX keys
keep their meaning:

- ``mesh_data = N`` alone: the CLI starts N local ranks (``--standalone``);
  rank i runs on ``cuda:i``, as one JAX command uses N local devices;
- ``coordinator_address``, ``num_processes`` and ``process_id``: a cluster
  of ``num_processes`` hosts. Each host's CLI starts ``mesh_data /
  num_processes`` local ranks as node ``process_id`` (global rank =
  ``process_id x local + local_rank``); they meet at
  ``coordinator_address`` ("host:port");
- under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` set) the
  process is a rank already, the counterpart of JAX's pod auto-detection.

A rank finds its place the same way in all three cases (``mesh_from_conf``).
The backend is NCCL for ranks on their own cards and gloo on the CPU or
when ranks share one card (``runtime.platform=cuda:N``).
``runtime.mesh_model > 1`` (tensor parallelism) is not ported and raises.
"""

import os
from typing import List, NamedTuple, Optional

import torch
import torch.distributed as dist

from ..device import local_device


class DataMesh(NamedTuple):
    """This process's place on the data axis."""

    group: "dist.ProcessGroup"
    rank: int
    world: int
    device: torch.device


def check_runtime(runtime) -> None:
    """The mesh keys a run can take; tensor parallelism is not ported."""
    if runtime.mesh_model != 1:
        raise NotImplementedError(
            f"runtime.mesh_model={runtime.mesh_model}: tensor parallelism is not ported "
            "yet; the port runs data parallelism only (runtime.mesh_data)"
        )
    if runtime.mesh_data < 1:
        raise ValueError(f"runtime.mesh_data={runtime.mesh_data} must be at least 1")
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
    if _is_rank() or (runtime.mesh_data == 1 and runtime.num_processes in (None, 1)):
        return None
    if runtime.num_processes is None:
        local, args = runtime.mesh_data, ["--standalone"]
    else:
        if runtime.mesh_data % runtime.num_processes:
            raise ValueError(
                f"runtime.mesh_data={runtime.mesh_data} does not divide over "
                f"runtime.num_processes={runtime.num_processes} hosts"
            )
        if not 0 <= runtime.process_id < runtime.num_processes:
            raise ValueError(f"runtime.process_id={runtime.process_id} is not one of "
                             f"{runtime.num_processes} hosts")
        addr, _, port = runtime.coordinator_address.rpartition(":")
        if not addr or not port.isdigit():
            raise ValueError(f"runtime.coordinator_address={runtime.coordinator_address!r} "
                             "is not host:port")
        local = runtime.mesh_data // runtime.num_processes
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
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), once;
    returns this rank's place."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    device = local_device(runtime.platform, local_rank, local_world)
    if not dist.is_initialized():
        backend = backend_for(device, runtime.platform, local_world)
        kwargs = {}
        if backend == "nccl":
            torch.cuda.set_device(device)
            kwargs["device_id"] = device
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                                **kwargs)
        if rank == 0 and world > 1:
            print(f"Mesh: data={world} model=1 ({backend})", flush=True)
    return DataMesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(), device)


def mesh_from_conf(runtime) -> Optional[DataMesh]:
    """This process's place on the data axis, or None for one process
    (the 1 x 1 mesh). The trainers' one entry point, as in the JAX package.

    A rank (started by torchrun) joins its process group here, unless its
    process joined one already. ``mesh_data > 1`` in a process that is no
    rank raises: the CLI starts the ranks.
    """
    check_runtime(runtime)
    if _is_rank():
        mesh = initialize_distributed(runtime)
        if runtime.mesh_data not in (1, mesh.world):
            raise ValueError(f"runtime.mesh_data={runtime.mesh_data} but the process group "
                             f"has {mesh.world} ranks")
        return None if mesh.world == 1 else mesh
    if runtime.mesh_data > 1:
        raise RuntimeError(
            f"runtime.mesh_data={runtime.mesh_data} needs {runtime.mesh_data} ranks: start "
            "them through the CLI (python -m vectorquantizedcpc_tpu_torch.cli.train_cpc "
            "runtime.mesh_data=N ...) or torchrun"
        )
    return None


def barrier(mesh: Optional[DataMesh]) -> None:
    """Every rank waits here for the others; nothing with one process."""
    if mesh is not None:
        dist.barrier(group=mesh.group)


def is_main(mesh: Optional[DataMesh]) -> bool:
    """Rank 0, the one that writes to disk (or the only process)."""
    return mesh is None or mesh.rank == 0
