from bsdmg_tpu_torch.cam.camera import (
    Camera,
    camera_to_ray,
    generate_rays,
    look_at,
    ndc_to_camera,
    pixel_cone_radius,
    texture_to_ndc,
)

__all__ = [
    "Camera",
    "camera_to_ray",
    "generate_rays",
    "look_at",
    "ndc_to_camera",
    "pixel_cone_radius",
    "texture_to_ndc",
]
