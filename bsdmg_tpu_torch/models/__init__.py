from bsdmg_tpu_torch.models.scenes import (
    SCENES,
    ReferenceCsdf,
    Scene,
    default_object_params,
    get_scene,
    reference_object,
    reference_render_scene,
)

__all__ = [
    "SCENES",
    "ReferenceCsdf",
    "Scene",
    "default_object_params",
    "get_scene",
    "reference_object",
    "reference_render_scene",
]
