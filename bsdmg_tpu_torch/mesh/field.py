"""Voxel-field state for hierarchical mesh generation.

Port of ``bsdmg_tpu/mesh/field.py``, mirroring the reference's
``CudaVoxelField`` (src/cuda/mod.rs:41-46,105-122): a list of voxel lower
corners plus a cubic voxel size. The JAX field is a padded buffer with a
live count, for static shapes; here ``lowers`` holds exactly the live
voxels, on the device, and ``count`` is its length.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bsdmg_tpu_torch.config import MeshGenConfig
from bsdmg_tpu_torch.ops.cuda.csdf import sdf_fns
from bsdmg_tpu_torch.ops.refine import refine_step


@dataclasses.dataclass
class VoxelField:
    """Sparse voxel field: ``lowers`` ``(count, 3)`` float32 lower corners."""

    lowers: torch.Tensor
    voxel_size: float  # cubic voxel edge length
    level: int = 0  # refinement levels applied

    @property
    def count(self) -> int:
        return int(self.lowers.shape[0])

    def to_numpy(self) -> np.ndarray:
        return self.lowers.cpu().numpy()


def create_voxel_field(
    config: MeshGenConfig = MeshGenConfig(), device: torch.device | str = "cuda"
) -> VoxelField:
    """Dense initial grid: ``init_factor**3`` voxels of size
    ``bb_size/init_factor`` covering ``[-bb_size/2, bb_size/2]^3``
    (src/cuda/mod.rs:105-122), in the JAX package's float32 arithmetic."""
    n = config.init_factor
    size = config.bb_size / n
    axis = torch.arange(n, dtype=torch.float32, device=device) * size - config.bb_size / 2.0
    grid = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"), dim=-1)
    return VoxelField(lowers=grid.reshape(-1, 3), voxel_size=size, level=0)


def refine_field(scene, field: VoxelField) -> VoxelField:
    """One refinement level: split the surface-crossing voxels into their
    border children (``CudaHandler::refine_voxel_field``,
    src/cuda/mod.rs:124-202). ``scene`` is a scene descriptor or
    :class:`~bsdmg_tpu_torch.ops.cuda.csdf.SdfFns`."""
    csdf = sdf_fns(scene).value
    lowers, size = refine_step(csdf, field.lowers, field.voxel_size)
    return VoxelField(lowers=lowers, voxel_size=size, level=field.level + 1)
