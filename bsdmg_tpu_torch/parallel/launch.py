"""Spawn a world of ranks on this host and collect what each returns.

    results = spawn(fn, 4, arg, device="cpu")      # 4 gloo ranks on the CPU
    results = spawn(fn, 2, arg, device="cuda:0")   # 2 gloo ranks on one card

``fn(device, *args)`` runs in each rank (imported by its module path: it
must be a module-level function) once the rank has joined a process group
over ``tcp://localhost:<free port>``; its return value, pickled, comes
back in rank order. The ranks are ``torch.multiprocessing`` processes: a
rank that fails stops the others, and the failed ranks' tracebacks are
raised in the caller. Every group has a timeout of :data:`GROUP_TIMEOUT` and the caller
waits at most ``timeout`` seconds before it kills every rank, so a hung
rank fails its caller instead of hanging it.
"""

from __future__ import annotations

import datetime
import multiprocessing
import pickle
import socket
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing

#: the longest a collective waits for the other ranks
GROUP_TIMEOUT = datetime.timedelta(seconds=60)


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_device(device: str, rank: int) -> torch.device:
    """The device of ``rank``: ``"cuda"`` is one card a rank, round robin
    over the cards; a device with an index (``"cuda:0"``) or ``"cpu"`` is
    every rank's."""
    if device == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(device)


def _rank_main(rank, world_size, port, backend, device, fn, args, results):
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        # one intra-op thread a rank: the ranks share the host's cores
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world_size, rank=rank, timeout=GROUP_TIMEOUT)
    try:
        out = fn(dev, *args)
    finally:
        dist.destroy_process_group()
    # bytes, not tensors: torch's pickler would share a tensor's storage,
    # which ends with this process
    results.put((rank, pickle.dumps(out)))


def _drain(results, out: dict) -> None:
    while not results.empty():
        rank, payload = results.get()
        out[rank] = pickle.loads(payload)


def _tracebacks(error_files: list[str]) -> list[str]:
    """Each failed rank's traceback, read from (and removing) its error file."""
    out = []
    for rank, name in enumerate(error_files):
        path = Path(name)
        if path.exists():
            out.append(f"rank {rank}:\n{pickle.loads(path.read_bytes())}")
            path.unlink()
    return out


def spawn(fn, world_size: int, *args, backend: str = "gloo", device: str = "cuda",
          timeout: float = 300.0) -> list:
    """Run ``fn(device, *args)`` in ``world_size`` new processes joined in
    one process group of ``backend``; returns each rank's result, in rank
    order. Raises ``RuntimeError`` with every failed rank's traceback, or
    when ``timeout`` seconds pass first."""
    results = multiprocessing.get_context("spawn").SimpleQueue()
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(world_size, free_port(), backend, device, fn, args, results),
        nprocs=world_size, join=False, daemon=True, start_method="spawn")
    out = {}
    deadline = time.monotonic() + timeout
    try:
        # drain while the ranks run, so that none blocks on a full pipe
        while not ctx.join(timeout=1.0):
            _drain(results, out)
            if time.monotonic() > deadline:
                raise RuntimeError(f"spawn: {world_size - len(out)} of {world_size} ranks gave "
                                   f"no result in {timeout} s")
        _drain(results, out)
    except (torch.multiprocessing.ProcessRaisedException,
            torch.multiprocessing.ProcessExitedException) as e:
        # join names the first rank it saw fail, often one whose peer went
        # away; every failed rank left its traceback in its error file
        raise RuntimeError("spawn: " + "\n".join(_tracebacks(ctx.error_files) or [str(e)])) from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    return [out[rank] for rank in range(world_size)]
