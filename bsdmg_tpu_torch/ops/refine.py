"""Hierarchical voxel-field refinement (prune + subdivide).

Port of ``bsdmg_tpu/ops/refine.py`` (reference kernel:
cuda/modules/compute_mesh_generation.cu:12-62). Each voxel splits into 2x2x2
children; a child survives iff its 8 corners disagree on ``sdf <= 0``. The
8 children share corners, so the SDF runs on each parent's 3x3x3 lattice:
27 evaluations per parent instead of 64. The evaluation is plain PyTorch
(the scene descriptor's ``descriptor_csdf``), as it is XLA, not a kernel, in
the JAX package.

The JAX package's blocked two-stage sort, packed lattice keys, block-cap
retries and padded capacities answer TPU constraints and are left out; the
survivors are compacted with ``torch.nonzero``. They come out in parent
order, children in the reference's order; the JAX package returns them in
its sort's order. The survivor set is the same.
"""

from __future__ import annotations

import numpy as np
import torch

from bsdmg_tpu_torch.ops.compact import compact

#: (27, 3) lattice offsets in units of the child voxel size
LATTICE = np.stack(
    np.meshgrid(np.arange(3), np.arange(3), np.arange(3), indexing="ij"), axis=-1
).reshape(27, 3)

#: child (i, j, k) of the 8 children, in the reference's output order
#: n_id = i * 4 + j * 2 + k (compute_mesh_generation.cu:51)
CHILD_IJK = np.stack(
    np.meshgrid(np.arange(2), np.arange(2), np.arange(2), indexing="ij"), axis=-1
).reshape(8, 3)

#: corner offsets within a child, reference corner bit order c = x | y<<1 | z<<2
_CORNER_BITS = np.stack([(np.arange(8) >> b) & 1 for b in (0, 1, 2)], axis=-1)

#: lattice index of corner c of child k: (child_ijk + corner_xyz), i-major
CHILD_CORNER_IDX = np.array(
    [
        [(i + x) * 9 + (j + y) * 3 + (k + z) for x, y, z in _CORNER_BITS]
        for i, j, k in CHILD_IJK
    ],
    dtype=np.int64,
)


def _child_size(voxel_size) -> float:
    return float(np.float32(voxel_size) / np.float32(2.0))


def child_lowers(lowers: torch.Tensor, voxel_size) -> torch.Tensor:
    """Lower corners of the 8 children, ``(N, 8, 3)``, reference order."""
    offsets = torch.tensor(CHILD_IJK, dtype=torch.float32, device=lowers.device)
    return lowers[:, None, :] + offsets[None] * _child_size(voxel_size)


def refine_masks(csdf, lowers: torch.Tensor, voxel_size) -> torch.Tensor:
    """Border mask per child, ``(N, 8)``: a child is a border voxel iff its 8
    corner occupancies disagree (compute_mesh_generation.cu:36-49), read off
    the parent's 3x3x3 lattice. ``csdf(x, y, z) -> d`` on flat planes."""
    lattice = torch.tensor(LATTICE, dtype=torch.float32, device=lowers.device)
    lattice = lattice * _child_size(voxel_size)
    n = lowers.shape[0]
    px, py, pz = ((lowers[:, a : a + 1] + lattice[None, :, a]).reshape(-1) for a in range(3))
    inside = (csdf(px, py, pz) <= 0.0).reshape(n, 27)
    corners = inside[:, torch.as_tensor(CHILD_CORNER_IDX, device=lowers.device)]  # (N, 8, 8)
    return (corners != corners[..., :1]).any(dim=-1)


def refine_step(csdf, lowers: torch.Tensor, voxel_size) -> tuple[torch.Tensor, float]:
    """One level: ``(surviving child lowers (M, 3), child voxel size)``."""
    mask = refine_masks(csdf, lowers, voxel_size)
    children, _ = compact(child_lowers(lowers, voxel_size).reshape(-1, 3), mask)
    return children, _child_size(voxel_size)
