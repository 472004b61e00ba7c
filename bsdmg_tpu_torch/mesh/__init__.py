"""Mesh generation pipeline: voxel field -> refine -> marching cubes -> weld -> export."""

from bsdmg_tpu_torch.mesh.field import VoxelField, create_voxel_field, refine_field
from bsdmg_tpu_torch.mesh.pipeline import Mesh, generate_mesh, triangles_to_mesh
from bsdmg_tpu_torch.mesh.session import MeshGenSession, Stage
from bsdmg_tpu_torch.mesh.weld import weld_vertices

__all__ = [
    "VoxelField",
    "create_voxel_field",
    "refine_field",
    "Mesh",
    "MeshGenSession",
    "Stage",
    "generate_mesh",
    "triangles_to_mesh",
    "weld_vertices",
]
