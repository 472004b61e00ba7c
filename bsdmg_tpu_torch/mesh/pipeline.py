"""End-to-end mesh generation: field -> refine^k -> marching cubes -> weld.

Port of ``bsdmg_tpu/mesh/pipeline.py``, the functional equivalent of the
reference's interactive state machine (src/renderer/mod.rs:155-226) driving
``CudaHandler::{create_cuda_voxel_field, refine_voxel_field,
voxel_field_to_mesh}`` (src/cuda/mod.rs:105-346). The JAX package extracts
fields above 2^18 voxels in chunks, for its compile-time shapes; here the
whole field goes through one extraction, with the same result.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from bsdmg_tpu_torch.config import MeshGenConfig
from bsdmg_tpu_torch.mesh.field import VoxelField, create_voxel_field, refine_field
from bsdmg_tpu_torch.mesh.weld import weld_vertices
from bsdmg_tpu_torch.ops.marching_cubes import TriangleSoup, extract_triangles


@dataclasses.dataclass
class Mesh:
    """Indexed triangle mesh with per-vertex normals."""

    vertices: np.ndarray  # (V, 3) float32
    normals: np.ndarray  # (V, 3) float32
    faces: np.ndarray  # (T, 3) int32

    @property
    def vertex_count(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def triangle_count(self) -> int:
        return int(self.faces.shape[0])


def field_to_triangles(
    scene, field: VoxelField, config: MeshGenConfig = MeshGenConfig()
) -> TriangleSoup:
    """Marching cubes over a voxel field (cf. src/cuda/mod.rs:204-261).

    Voxels with more crossing edges than ``config.edge_budget`` (checkerboard
    cases) lose their triangles to the overflow; the extraction then reruns
    once with the full 12 lanes, so the result is always whole."""
    soup = extract_triangles(scene, field.lowers, field.voxel_size, config)
    if config.edge_budget < 12 and soup.edge_overflow > 0:
        soup = extract_triangles(
            scene, field.lowers, field.voxel_size, dataclasses.replace(config, edge_budget=12)
        )
    return soup


def triangles_to_mesh(soup: TriangleSoup, config: MeshGenConfig = MeshGenConfig()) -> Mesh:
    """Compact the valid triangles, move them to the host and weld shared
    vertices (cf. src/cuda/mod.rs:263-326)."""
    valid = soup.valid.reshape(-1)
    positions = soup.positions.reshape(-1, 3, 3)[valid].cpu().numpy()
    normals = soup.normals.reshape(-1, 3, 3)[valid].cpu().numpy()
    if positions.size == 0:
        return Mesh(
            vertices=np.zeros((0, 3), np.float32),
            normals=np.zeros((0, 3), np.float32),
            faces=np.zeros((0, 3), np.int32),
        )
    vertices, vertex_normals, faces = weld_vertices(positions, normals, config.weld_quantization)
    return Mesh(vertices=vertices, normals=vertex_normals, faces=faces)


def generate_mesh(
    scene,
    refine_steps: int = 3,
    config: MeshGenConfig = MeshGenConfig(),
    *,
    on_level: Callable[[VoxelField], None] | None = None,
    on_triangles: Callable[[TriangleSoup], None] | None = None,
    device: torch.device | str = "cuda",
    field: VoxelField | None = None,
) -> Mesh:
    """The whole pipeline: the initial field (or ``field``, resumed),
    ``refine_steps`` levels, marching cubes, weld. ``scene`` is a scene
    descriptor (``ops.cuda.csdf.compile_scene``); ``on_level`` sees each
    field, the first included, and ``on_triangles`` the extraction's
    triangles before the weld."""
    if field is None:
        field = create_voxel_field(config, device)
    if on_level is not None:
        on_level(field)
    for _ in range(refine_steps):
        field = refine_field(scene, field)
        if on_level is not None:
            on_level(field)
    soup = field_to_triangles(scene, field, config)
    if on_triangles is not None:
        on_triangles(soup)
    return triangles_to_mesh(soup, config)


def remesh_scene(grid, *, init_factor: int = 32, newton_iters: int = 8):
    """What ``remesh`` meshes a mesh asset's baked ``grid`` (``models/
    mesh_sdf.py`` ``SdfGrid``) as, as the JAX CLI's ``remesh`` does
    (``bsdmg_tpu/cli.py`` cmd_remesh): ``(descriptor, config, centre)``,
    the weights form of the grid (``grid_csdf``) shifted by its float32
    centre, and the box of its side."""
    from bsdmg_tpu_torch.ops.cuda.csdf import grid_descriptor

    center = np.asarray([(lo + hi) / 2 for lo, hi in zip(grid.lo, grid.hi)], np.float32)
    config = MeshGenConfig(init_factor=init_factor, bb_size=float(grid.hi[0] - grid.lo[0]),
                           newton_iters=newton_iters)
    return grid_descriptor(grid, form="weights", offset=center), config, center


def remesh(grid, *, init_factor: int = 32, refine: int = 2, newton_iters: int = 8,
           device: torch.device | str = "cuda",
           on_level: Callable[[VoxelField], None] | None = None,
           on_triangles: Callable[[TriangleSoup], None] | None = None) -> Mesh:
    """Re-extract a mesh asset's baked ``grid`` at ``init_factor *
    2^refine`` a side (:func:`remesh_scene`), the welded vertices moved
    back by the centre; ``on_level`` and ``on_triangles`` as in
    :func:`generate_mesh`."""
    desc, config, center = remesh_scene(grid, init_factor=init_factor, newton_iters=newton_iters)
    mesh = generate_mesh(desc, refine_steps=refine, config=config, device=device,
                         on_level=on_level, on_triangles=on_triangles)
    mesh.vertices = mesh.vertices + center
    return mesh
