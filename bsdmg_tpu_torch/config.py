"""Runtime configuration of the render path.

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
