"""Scene definitions ("model families") for the renderer and mesh generator.

A *scene* is a parameter dict and functions of it: ``Scene.sdf(params, p)``
maps the params and points ``(..., 3)`` to signed distances ``(...,)``, and
``Scene.csdf(params, x, y, z)`` takes coordinate planes. Keeping the
parameters out of the closure makes every scene differentiable (pixel
gradients with respect to SDF parameters) and shardable.
"""

from bsdmg_tpu_torch.models.compose import compose_scene, load_scene_spec
from bsdmg_tpu_torch.models.motion import (
    AxisCyclicMotion,
    RotateAxisMotion,
    SceneSettings,
    SphericCyclicMotion,
    Transform,
    apply_motion,
    set_center,
)
from bsdmg_tpu_torch.models.scenes import (
    SCENES,
    ReferenceCsdf,
    Scene,
    box_scene,
    default_object_params,
    get_scene,
    mandelbulb_scene,
    reference_object,
    reference_render_scene,
    sphere_scene,
    wrapped_object_scene,
)

__all__ = [
    "AxisCyclicMotion",
    "RotateAxisMotion",
    "SCENES",
    "ReferenceCsdf",
    "Scene",
    "SceneSettings",
    "SphericCyclicMotion",
    "Transform",
    "apply_motion",
    "box_scene",
    "compose_scene",
    "default_object_params",
    "get_scene",
    "load_scene_spec",
    "mandelbulb_scene",
    "reference_object",
    "reference_render_scene",
    "set_center",
    "sphere_scene",
    "wrapped_object_scene",
]
