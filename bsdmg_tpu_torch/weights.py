"""Parameters carried across from the JAX package.

The system has no weights: its state is a scene's parameter dict, the
camera, and in mesh generation the voxel field between levels. These
helpers turn the JAX package's values (anything ``numpy.asarray`` accepts,
float32) into this package's float32 tensors, so both packages compute from
the same numbers.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from bsdmg_tpu_torch.cam.camera import Camera
from bsdmg_tpu_torch.mesh.field import VoxelField


def _tensor(value, device) -> torch.Tensor:
    return torch.tensor(np.asarray(value, np.float32), device=device)


def params_from_numpy(params: Mapping[str, Any], device: torch.device | str) -> dict[str, torch.Tensor]:
    """``{name: array}`` -> ``{name: float32 tensor on device}``."""
    return {name: _tensor(value, device) for name, value in params.items()}


def camera_from_numpy(camera: Any, device: torch.device | str) -> Camera:
    """A camera with ``position``, ``forward``, ``up``, ``right`` and ``fov``
    fields (such as the JAX package's ``Camera``) -> :class:`Camera`."""
    return Camera(*(_tensor(getattr(camera, f), device) for f in Camera._fields))


def field_from_numpy(lowers, voxel_size, level, device: torch.device | str) -> VoxelField:
    """A voxel field from the JAX package (its ``VoxelField.to_numpy()``,
    ``voxel_size`` and ``level``, or a ``save_field`` checkpoint's arrays)
    -> :class:`VoxelField` on ``device``, so both packages refine and
    extract from the same voxels."""
    return VoxelField(
        lowers=_tensor(np.asarray(lowers, np.float32).reshape(-1, 3), device),
        voxel_size=float(np.float32(voxel_size)),
        level=int(level),
    )
