from bsdmg_tpu_torch.sdf.normals import normal_fd4
from bsdmg_tpu_torch.sdf.primitives import (
    sd_box,
    sd_box_c,
    sd_box_skeleton,
    sd_box_skeleton_c,
    sd_cylinder_c,
    sd_line,
    sd_mandelbulb,
    sd_mandelbulb_c,
    sd_sphere,
    sd_sphere_c,
    sd_torus_c,
    smooth_min,
    wrap,
)

__all__ = [
    "normal_fd4",
    "sd_box",
    "sd_box_c",
    "sd_box_skeleton",
    "sd_box_skeleton_c",
    "sd_cylinder_c",
    "sd_line",
    "sd_mandelbulb",
    "sd_mandelbulb_c",
    "sd_sphere",
    "sd_sphere_c",
    "sd_torus_c",
    "smooth_min",
    "wrap",
]
