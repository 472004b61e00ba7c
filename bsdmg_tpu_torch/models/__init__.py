from bsdmg_tpu_torch.models.compose import compose_scene, load_scene_spec
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
    "SCENES",
    "ReferenceCsdf",
    "Scene",
    "box_scene",
    "compose_scene",
    "default_object_params",
    "get_scene",
    "load_scene_spec",
    "mandelbulb_scene",
    "reference_object",
    "reference_render_scene",
    "sphere_scene",
    "wrapped_object_scene",
]
