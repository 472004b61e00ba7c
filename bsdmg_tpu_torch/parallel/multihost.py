"""Multi-process initialisation and voxel-block sharding.

Port of ``bsdmg_tpu/parallel/multihost.py``. One code path for one process
and many: :func:`initialize` joins this process to the world when the
environment names one, then :func:`bsdmg_tpu_torch.parallel.make_mesh`
lays the world out. JAX drives every local device from one process; here
each device has a process of its own, so N local cards are N ranks
(``torchrun --nproc-per-node=N``), and the hosts of a cluster are joined
the same way.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from bsdmg_tpu_torch.parallel.launch import GROUP_TIMEOUT


def default_backend(device: torch.device | str = "cuda") -> str:
    """NCCL for a CUDA device, gloo otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_device(device: torch.device | str = "cuda") -> torch.device:
    """This rank's device: a bare ``"cuda"`` is ``cuda:LOCAL_RANK`` (0
    without a launcher), one card a local rank; any other device is itself."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, backend: str | None = None,
               device: torch.device | str = "cuda") -> None:
    """Join the default process group when this process is one rank of
    several; otherwise do nothing.

    The JAX package's variables come first: ``BSDMG_COORDINATOR``
    (``host:port`` of rank 0), ``BSDMG_NUM_PROCESSES`` and
    ``BSDMG_PROCESS_ID`` (or the arguments). Without a coordinator,
    ``torchrun``'s ``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR``/
    ``MASTER_PORT`` are used. ``backend`` defaults to NCCL for a CUDA
    ``device`` and gloo otherwise; a backend that fails to start raises.
    A process already in a group stays in it."""
    if dist.is_initialized():
        return
    backend = backend or default_backend(device)
    coordinator = coordinator or os.environ.get("BSDMG_COORDINATOR")
    if coordinator is not None:
        # `x or default` would send process 0 (falsy) to the environment
        if num_processes is None:
            num_processes = int(os.environ.get("BSDMG_NUM_PROCESSES", "1"))
        if process_id is None:
            process_id = int(os.environ.get("BSDMG_PROCESS_ID", "0"))
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id, timeout=GROUP_TIMEOUT)
    elif all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        dist.init_process_group(backend, init_method="env://", timeout=GROUP_TIMEOUT)


def shard_voxels(lowers: torch.Tensor, mesh, axis: str = "dp") -> torch.Tensor:
    """This rank's block of a voxel buffer sharded over the mesh's ``axis``:
    the rows padded with far-away voxels (lower corner 1e6) to a multiple
    of the axis's size, then split into that many contiguous blocks; ranks
    that share an ``axis`` coordinate hold the same block. Refinement and
    marching cubes are per voxel, so the blocks need no communication."""
    shards = mesh.size(mesh.mesh_dim_names.index(axis))
    pad = -lowers.shape[0] % shards
    if pad:
        lowers = torch.cat([lowers, torch.full((pad, 3), 1e6, dtype=lowers.dtype,
                                               device=lowers.device)])
    return lowers.chunk(shards)[mesh.get_local_rank(axis)]
