"""Runtime configuration of the render and mesh-generation paths.

The same frozen dataclasses, with the same defaults, as the JAX package's
``bsdmg_tpu/config.py``. They are copied rather than imported because
``bsdmg_tpu/__init__.py`` imports jax; ``tests/test_torch_guards.py`` holds
the two copies equal field by field.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class MarchConfig:
    """Sphere-tracing budget (reference: cuda/includes/ray_marching.cu:10-12)."""

    step_limit: int = 256
    depth_limit: float = 500.0
    collision_distance: float = 1e-3

    #: 4th-order central-difference epsilon for empirical normals
    #: (reference: cuda/includes/signed_distance.cu:179).
    normal_epsilon: float = 1e-3

    #: Over-relaxation factor (Keinert et al. 2014). 1.0 is classic sphere
    #: tracing, the reference's semantics; the CUDA render kernel supports
    #: only that value and raises on any other.
    relaxation: float = 1.0


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render-target geometry (reference: src/renderer/mod.rs:10, src/main.rs:53)."""

    #: CUDA render texture in the reference is 2560x1440.
    width: int = 2560
    height: int = 1440

    #: Logical window the reference presents into (1920x1080); enters the ray
    #: transform through ``width_factor`` (cuda/modules/common.cu:75-88).
    screen_width: float = 1920.0
    screen_height: float = 1080.0

    #: Bevy's default ``PerspectiveProjection::fov`` (pi/4), in radians.
    fov: float = math.pi / 4.0

    march: MarchConfig = dataclasses.field(default_factory=MarchConfig)

    @property
    def texture_size(self) -> tuple[int, int]:
        return (self.width, self.height)

    @property
    def screen_size(self) -> tuple[float, float]:
        return (self.screen_width, self.screen_height)


@dataclasses.dataclass(frozen=True)
class MeshGenConfig:
    """Hierarchical mesh-generation geometry.

    Reference: cuda/includes/bindings.h:9-10 (``MESH_GENERATION_INIT_FACTOR``,
    ``MESH_GENERATION_BB_SIZE``), src/cuda/mod.rs:105-122 (initial field),
    cuda/includes/signed_distance.cu:227-240 (Newton projection).
    """

    #: Initial grid resolution per axis (32**3 voxels).
    init_factor: int = 32
    #: Bounding box is the cube [-bb_size/2, bb_size/2]^3.
    bb_size: float = 5.0

    #: Marching-cubes triangle budget per voxel (src/cuda/mod.rs:205).
    triangles_per_voxel: int = 5

    #: Newton projection of MC vertices onto the isosurface. The reference
    #: caps at 10_000 iterations (signed_distance.cu:232) which is pathological;
    #: Newton on an SDF converges in a handful of steps, so we bound it and
    #: verify surface distance in tests.
    newton_iters: int = 24
    newton_tolerance: float = 1e-5

    #: Vertex weld quantization (src/cuda/mod.rs:270: round(x * 1e5)).
    weld_quantization: float = 1e5

    #: Normal estimator inside the Newton projection: "grad" (the analytic
    #: gradient, reverse mode as jax.vjp takes it) or "fd4" (the reference's 12-eval stencil,
    #: signed_distance.cu:181-202). Both converge to the same |sd| <= tol
    #: fixpoint; exported vertex normals always use fd4 for parity.
    projection_normals: str = "grad"

    #: If True, place MC vertices at true sign-change interpolation along the
    #: edge. The reference uses fixed midpoints (edge interpolation commented
    #: out at cuda/includes/marching_cubes.cu:14), which is the default here
    #: for parity.
    interpolate_edges: bool = False

    #: Per-voxel crossing-edge budget for the Newton-projection stage. Of a
    #: voxel's 12 edges only the sign-crossing ones are ever referenced by a
    #: triangle (mean 4, max 6 measured on smooth scenes), so projecting a
    #: rank-compacted (N, edge_budget) layout instead of all (N, 12) lanes
    #: roughly doubles projection throughput. Voxels with more crossing
    #: edges (checkerboard MC cases, seen only on fractal scenes) have their
    #: triangles dropped and counted in ``TriangleSoup.edge_overflow``; the
    #: pipeline wrappers detect this and re-extract with the full 12-lane
    #: layout (= ``edge_budget=12``, bit-identical to the reference flow).
    edge_budget: int = 6

    #: SDF-side normal used by the winding fix (compute_mesh_generation.cu:
    #: 103-113 compares the geometric triangle normal against an fd4 normal
    #: at the centroid). "vertex_mean" reuses the already-computed vertex
    #: normals (flip decisions agree 100% on all smooth test scenes and
    #: avoid the centroid stencil's 60 SDF evals/voxel) and self-checks:
    #: triangles whose vertex normals nearly cancel (thin sheets/saddles,
    #: where the mean's sign is float noise) re-resolve with the centroid
    #: stencil on a rare path; "centroid_fd4" is the
    #: reference's exact estimator everywhere.
    winding_normals: str = "vertex_mean"

    normal_epsilon: float = 1e-3

    @property
    def bb_min(self) -> float:
        return -self.bb_size / 2.0

    @property
    def bb_max(self) -> float:
        return self.bb_size / 2.0
