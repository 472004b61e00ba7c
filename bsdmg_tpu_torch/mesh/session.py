"""Interactive mesh-generation session: the reference's stage machine.

Port of ``bsdmg_tpu/mesh/session.py``, the equivalent of the reference's
event-driven state machine (``RenderMeshGenStage``,
src/renderer/mod.rs:42-46, handled at :155-226):

* stage ``EMPTY``: :meth:`MeshGenSession.advance` creates the initial
  ``init_factor``^3 voxel field and a preview mesh (src/renderer/mod.rs:213-221);
* stage ``VOXEL_FIELD``: :meth:`MeshGenSession.refine` halves the voxel size
  keeping surface-crossing children and refreshes the preview (:166-188);
  :meth:`MeshGenSession.advance` extracts the final mesh (:196-201);
* stage ``MESH``: :meth:`MeshGenSession.advance` saves the OBJ and resets to
  ``EMPTY`` (:203-211, output path :11).

``refine`` outside ``VOXEL_FIELD`` is a warned no-op, as in the reference
(:182-186). Each extraction, the previews included, runs the whole field
through ``mesh/pipeline.py`` (kernel K6 on the card, K7 with
``interpolate_edges``), where the JAX package extracts in chunks
(``extract_mesh_chunked``); the mesh is the same.
"""

from __future__ import annotations

import enum
import logging

import torch

from bsdmg_tpu_torch.config import MeshGenConfig
from bsdmg_tpu_torch.mesh.export import save_obj
from bsdmg_tpu_torch.mesh.field import VoxelField, create_voxel_field, refine_field
from bsdmg_tpu_torch.mesh.pipeline import Mesh, field_to_triangles, triangles_to_mesh

log = logging.getLogger("bsdmg_tpu_torch")


class Stage(enum.Enum):
    """src/renderer/mod.rs:42-46."""

    EMPTY = "empty"
    VOXEL_FIELD = "voxel_field"
    MESH = "mesh"


class MeshGenSession:
    """The refine/advance stage machine over the mesh pipeline, for a scene
    descriptor (``ops.cuda.csdf.compile_scene``) on ``device``.

    >>> s = MeshGenSession(desc)
    >>> s.advance()           # EMPTY -> VOXEL_FIELD (creates the 32^3 field)
    >>> s.refine(); s.refine()
    >>> s.advance()           # VOXEL_FIELD -> MESH (marching cubes)
    >>> s.advance()           # MESH -> EMPTY (saves the OBJ, resets)
    """

    def __init__(
        self,
        scene,
        config: MeshGenConfig = MeshGenConfig(),
        *,
        output_path: str = "generated_mesh.obj",
        show_preview: bool = True,
        device: torch.device | str = "cuda",
    ):
        self.scene = scene
        self.config = config
        self.output_path = output_path  # src/renderer/mod.rs:11
        self.show_preview = show_preview  # RenderSettings, src/renderer/mod.rs:21-27
        self.device = device
        self.stage = Stage.EMPTY
        self.field: VoxelField | None = None
        self.mesh: Mesh | None = None
        self.preview: Mesh | None = None

    def _extract(self) -> Mesh:
        return triangles_to_mesh(field_to_triangles(self.scene, self.field, self.config),
                                 self.config)

    def _update_preview(self) -> None:
        if self.show_preview and self.field is not None:
            self.preview = self._extract()

    def refine(self) -> None:
        """One refinement pass; a no-op with a warning outside VOXEL_FIELD
        (src/renderer/mod.rs:166-188)."""
        if self.stage is not Stage.VOXEL_FIELD:
            log.warning("refine ignored: no voxel field present (stage=%s)", self.stage.value)
            return
        self.field = refine_field(self.scene, self.field)
        log.info("refined field: %d voxels at size %.5f", self.field.count, self.field.voxel_size)
        self._update_preview()

    def advance(self) -> None:
        """Advance the stage machine (src/renderer/mod.rs:191-225)."""
        if self.stage is Stage.EMPTY:
            self.field = create_voxel_field(self.config, self.device)
            self.stage = Stage.VOXEL_FIELD
            log.info("created voxel field: %d voxels at size %.5f", self.field.count,
                     self.field.voxel_size)
            self._update_preview()
        elif self.stage is Stage.VOXEL_FIELD:
            self.mesh = self._extract()
            self.stage = Stage.MESH
            log.info("extracted mesh: %d vertices, %d triangles", self.mesh.vertex_count,
                     self.mesh.triangle_count)
        else:  # MESH: save and reset
            save_obj(self.mesh, self.output_path)
            log.info("saved %s; session reset", self.output_path)
            self.stage = Stage.EMPTY
            self.field = None
            self.mesh = None
            self.preview = None
