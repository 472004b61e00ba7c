"""Every collective of the port's multi-device paths, counted by kind.

The JAX package audits its sharded programs by counting the collective ops
in their partitioned HLO (``tests/test_collectives.py``). Here the
program is Python driving one process per device, so each collective goes
through this module, which counts the calls as the kernel wrappers count
their launches (``LAUNCHES``): a sharded frame is one ``all_gather``, a
training step one ``all_reduce``, the march and the refine none.

A group whose backend is gloo takes host tensors only; a CUDA tensor then
goes through host memory explicitly (two ranks that share one card run
gloo, since NCCL takes one rank a device).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

#: calls since :func:`reset`, by kind
COLLECTIVES = {"all_gather": 0, "all_reduce": 0}


def reset() -> None:
    for kind in COLLECTIVES:
        COLLECTIVES[kind] = 0


def _via_host(tensor: torch.Tensor, group) -> bool:
    return tensor.device.type != "cpu" and dist.get_backend(group) == "gloo"


def all_gather(tensor: torch.Tensor, group=None) -> list[torch.Tensor]:
    """Every rank's ``tensor`` (the same shape and dtype on each), in rank
    order, on ``tensor``'s device."""
    host = _via_host(tensor, group)
    src = tensor.cpu() if host else tensor.contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    COLLECTIVES["all_gather"] += 1
    dist.all_gather(out, src, group=group)
    return [t.to(tensor.device) for t in out] if host else out


def all_reduce(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``tensor`` over the group, in place; returns it. Every rank ends
    with the same bits."""
    COLLECTIVES["all_reduce"] += 1
    if _via_host(tensor, group):
        host = tensor.cpu()
        dist.all_reduce(host, group=group)
        tensor.copy_(host)
    else:
        dist.all_reduce(tensor, group=group)
    return tensor
