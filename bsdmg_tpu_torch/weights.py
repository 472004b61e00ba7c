"""Parameters carried across from the JAX package.

The system has no weights: its state is a scene's parameter dict, the
camera, in mesh generation the voxel field between levels, and in a
mesh-asset scene its baked grid. These helpers turn the JAX package's
values (anything ``numpy.asarray`` accepts, float32) into this package's
float32 tensors, so both packages compute from the same numbers, and
flatten a parameter dict into the vector the differentiable render's
kernels take, in the JAX package's leaf order, so that a flat gradient of
either package lines up with the other's index for index.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from bsdmg_tpu_torch.cam.camera import Camera
from bsdmg_tpu_torch.mesh.field import VoxelField
from bsdmg_tpu_torch.models.mesh_sdf import SdfGrid


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


def grid_from_numpy(values, lo, hi, device: torch.device | str) -> SdfGrid:
    """A baked grid from the JAX package (its ``SdfGrid``: ``values`` as
    numpy, ``lo``, ``hi``) -> :class:`SdfGrid` on ``device``, so both
    packages render the same table."""
    return SdfGrid(
        values=_tensor(values, device),
        lo=tuple(float(v) for v in lo),
        hi=tuple(float(v) for v in hi),
    )


#: ``((name, shape), ...)``: how :func:`flatten_params` laid the vector out
ParamLayout = tuple[tuple[str, tuple[int, ...]], ...]


def flatten_params(params: Mapping[str, Any]) -> tuple[torch.Tensor, ParamLayout]:
    """``(flat, layout)``: the parameters as one float32 vector, in
    ``jax.tree_util.tree_flatten``'s order (dict keys sorted), the
    counterpart of ``bsdmg_tpu/ops/pallas/diff_kernel.py::flatten_param_tree``.
    Differentiable: the vector keeps the tensors' autograd history."""
    names = sorted(params)
    values = [torch.as_tensor(params[n], dtype=torch.float32) for n in names]
    layout = tuple((n, tuple(v.shape)) for n, v in zip(names, values))
    return torch.cat([v.reshape(-1) for v in values]), layout


def param_offsets(layout: ParamLayout) -> dict[str, int]:
    """Each parameter's slot in :func:`flatten_params`'s vector: the index
    of its first value."""
    offsets, i = {}, 0
    for name, shape in layout:
        offsets[name] = i
        i += int(np.prod(shape)) if shape else 1
    return offsets


def unflatten_params(flat: torch.Tensor, layout: ParamLayout) -> dict[str, torch.Tensor]:
    """The inverse of :func:`flatten_params`: views of ``flat`` by name."""
    sizes = [int(np.prod(shape)) if shape else 1 for _, shape in layout]
    if sum(sizes) != flat.numel():
        raise ValueError(f"layout covers {sum(sizes)} values, the vector has {flat.numel()}")
    out = {}
    i = 0
    for (name, shape), n in zip(layout, sizes):
        out[name] = flat[i : i + n].reshape(shape)
        i += n
    return out
