"""Multi-device hierarchical mesh generation.

Port of ``bsdmg_tpu/parallel/mesh.py``. Refinement and extraction are per
voxel, so the field shards over the ranks with no communication in the
hot path: each rank refines its own voxels (``mesh/field.py::
refine_field``) and extracts their triangles (``mesh/pipeline.py::
field_to_triangles``: kernel K6, or K7 with ``interpolate_edges``). The
initial field is dealt round robin, rank ``r`` of ``N``
keeping live rows ``r::N``, so every rank sees a slice of the whole
surface. The only collectives are the final gathers: an ``all_gather`` of
the triangle counts and one of the padded triangles, then the host weld.

JAX's per-shard capacities, block caps and overflow retries
(``refine_step_blocked``, ``_shrink_sharded_jit``) manage TPU buffers; the
port's fields hold exactly their live voxels, so there is no
``local_capacity``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from bsdmg_tpu_torch.config import MeshGenConfig
from bsdmg_tpu_torch.mesh.field import VoxelField, create_voxel_field, refine_field
from bsdmg_tpu_torch.mesh.pipeline import Mesh, field_to_triangles, triangles_to_mesh
from bsdmg_tpu_torch.ops.marching_cubes import TriangleSoup
from bsdmg_tpu_torch.parallel.collectives import all_gather


def _gather_rows(rows: torch.Tensor) -> torch.Tensor:
    """Every rank's ``(n_r, k)`` rows concatenated in rank order: one
    ``all_gather`` of the counts, one of the rows padded to the largest."""
    n = torch.tensor([rows.shape[0]], dtype=torch.int64, device=rows.device)
    counts = [int(c) for c in all_gather(n)]
    padded = rows.new_zeros((max(max(counts), 1), rows.shape[1]))
    padded[: rows.shape[0]] = rows
    parts = all_gather(padded)
    return torch.cat([p[:c] for p, c in zip(parts, counts)])


class ShardedField:
    """A voxel field dealt over the ranks of ``mesh``: ``lowers`` holds this
    rank's live voxels ``(n, 3)``. Unlike :class:`VoxelField`, the live rows
    are per rank; :attr:`counts` and :meth:`gather` are collectives that
    every rank calls."""

    def __init__(self, lowers: torch.Tensor, voxel_size: float, level: int, mesh):
        self.lowers = lowers
        self.voxel_size = float(voxel_size)
        self.level = int(level)
        self.mesh = mesh

    @property
    def local(self) -> VoxelField:
        """This rank's voxels as a :class:`VoxelField`."""
        return VoxelField(lowers=self.lowers, voxel_size=self.voxel_size, level=self.level)

    @property
    def counts(self) -> np.ndarray:
        """Each rank's live count, in rank order (one ``all_gather``)."""
        n = torch.tensor([self.lowers.shape[0]], dtype=torch.int64, device=self.lowers.device)
        return np.array([int(c) for c in all_gather(n)], np.int64)

    @property
    def count(self) -> int:
        return int(self.counts.sum())

    def gather(self) -> VoxelField:
        """Every rank's voxels in one :class:`VoxelField`, in rank order (two
        ``all_gather``: the counts, then the voxels), for a checkpoint or
        any single-device consumer."""
        lowers = _gather_rows(self.lowers)
        return VoxelField(lowers=lowers, voxel_size=self.voxel_size, level=self.level)


def distribute_field(field: VoxelField, mesh) -> ShardedField:
    """Deal a field's voxels round robin onto the ranks: rank ``r`` of ``N``
    keeps rows ``r::N``. Every rank passes the same field."""
    lowers = field.lowers[dist.get_rank()::mesh.size()].contiguous()
    return ShardedField(lowers, field.voxel_size, field.level, mesh)


def refine_field_sharded(scene, sfield: ShardedField) -> ShardedField:
    """One refinement level of each rank's voxels; no collective. ``scene``
    is a scene descriptor (``ops/cuda/csdf.py::compile_scene``)."""
    refined = refine_field(scene, sfield.local)
    return ShardedField(refined.lowers, refined.voxel_size, refined.level, sfield.mesh)


def extract_sharded(scene, sfield: ShardedField,
                    config: MeshGenConfig = MeshGenConfig()) -> TriangleSoup:
    """Marching cubes over this rank's voxels (K6, or K7 with
    ``config.interpolate_edges``); no collective. Returns the rank's
    triangle soup; :func:`gather_triangles` joins the ranks'."""
    return field_to_triangles(scene, sfield.local, config)


def gather_triangles(soup: TriangleSoup, mesh) -> TriangleSoup:
    """Every rank's valid triangles in one soup, in rank order (two
    ``all_gather``: the counts, then the triangles)."""
    valid = soup.valid.reshape(-1)
    rows = torch.cat([soup.positions.reshape(-1, 9)[valid], soup.normals.reshape(-1, 9)[valid]], 1)
    tris = _gather_rows(rows)
    return TriangleSoup(
        positions=tris[:, :9].reshape(-1, 1, 3, 3),
        normals=tris[:, 9:].reshape(-1, 1, 3, 3),
        valid=torch.ones((tris.shape[0], 1), dtype=torch.bool, device=tris.device),
    )


def generate_mesh_sharded(scene, mesh, refine_steps: int = 3,
                          config: MeshGenConfig = MeshGenConfig(), *,
                          device: torch.device | str = "cuda") -> Mesh:
    """The sharded pipeline: distribute, ``refine_steps`` shard-local
    levels, shard-local extraction, the gather, the host weld. Every rank
    returns the same mesh, with the single-device ``generate_mesh``'s
    triangles and welded vertices (in another order)."""
    sfield = distribute_field(create_voxel_field(config, device), mesh)
    for _ in range(refine_steps):
        sfield = refine_field_sharded(scene, sfield)
    return triangles_to_mesh(gather_triangles(extract_sharded(scene, sfield, config), mesh), config)
