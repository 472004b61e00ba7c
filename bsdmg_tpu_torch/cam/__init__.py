from bsdmg_tpu_torch.cam.camera import (
    Camera,
    camera_to_ray,
    generate_rays,
    look_at,
    ndc_to_camera,
    pixel_cone_radius,
    texture_to_ndc,
)
from bsdmg_tpu_torch.cam.sampling import (
    cubic_interpolate,
    fetch_2d,
    index_2d,
    ndc_to_interpolated_value,
)

__all__ = [
    "Camera",
    "camera_to_ray",
    "generate_rays",
    "look_at",
    "ndc_to_camera",
    "pixel_cone_radius",
    "texture_to_ndc",
    "cubic_interpolate",
    "fetch_2d",
    "index_2d",
    "ndc_to_interpolated_value",
]
