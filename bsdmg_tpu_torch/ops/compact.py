"""Stream compaction: the rows of a tensor where a mask is set.

Counterpart of ``bsdmg_tpu/ops/compact.py``. The JAX package compacts with a
stable sort on a 0/1 key into a fixed-capacity buffer because dynamic
scatters are slow on the TPU and shapes must be static there; on the GPU
``torch.nonzero`` (a prefix sum) gives the kept rows directly, in their
original order, at their true count.
"""

from __future__ import annotations

import torch


def compact(data: torch.Tensor, mask: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``(data[mask], count)``: the kept rows of ``(N, ...)`` ``data``, in
    order, and how many there are."""
    keep = mask.reshape(-1).nonzero().squeeze(1)
    return data.index_select(0, keep), int(keep.numel())
