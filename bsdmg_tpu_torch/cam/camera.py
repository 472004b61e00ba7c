"""Pinhole camera and ray generation.

Port of ``bsdmg_tpu/cam/camera.py``: the reference coordinate pipeline
(cuda/modules/common.cu:15-88) from texture pixel to NDC, camera plane and
world ray, with the ``width_factor`` that reconciles the render-texture
aspect with the presented-window aspect, and the per-pixel cone radius
(common.cu:94-184). Everything is float32, like the JAX package, and the
sums of three products run in the same order, so the two agree to rounding.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

SQRT_INV = 0.7071067811865475  # 1/sqrt(2), cuda/includes/utils.cu:14


class Camera(NamedTuple):
    """Camera basis (cuda/includes/bindings.h:23-29). Float32 tensors on one
    device; vectors are unit."""

    position: torch.Tensor  # (3,)
    forward: torch.Tensor  # (3,)
    up: torch.Tensor  # (3,)
    right: torch.Tensor  # (3,)
    fov: torch.Tensor  # () vertical field of view in radians


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of length 3."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ]
    )


def look_at(
    position,
    target=(0.0, 0.0, 0.0),
    world_up=(0.0, 1.0, 0.0),
    fov: float = math.pi / 4.0,
    *,
    device: torch.device | str = "cuda",
) -> Camera:
    """Camera at ``position`` looking at ``target``; ``fov`` in radians.

    Bevy's ``Transform::looking_at`` basis (src/renderer/mod.rs:264-273)."""
    position = _f32(position, device)
    target = _f32(target, device)
    world_up = _f32(world_up, device)

    forward = target - position
    forward = forward / _norm3(forward)
    right = _cross(forward, world_up)
    right = right / _norm3(right)
    up = _cross(right, forward)
    return Camera(position, forward, up, right, _f32(fov, device))


def texture_to_ndc(p: torch.Tensor, texture_size) -> torch.Tensor:
    """Pixel center -> [0,1]^2 NDC (common.cu:15-17)."""
    return (p + 0.5) / _f32(texture_size, p.device)


def ndc_to_camera(p: torch.Tensor, size) -> torch.Tensor:
    """NDC -> camera plane: x scaled by aspect, y flipped (common.cu:68-73)."""
    size = _f32(size, p.device)
    aspect = size[0] / size[1]
    return torch.stack(
        [(2.0 * p[..., 0] - 1.0) * aspect, 1.0 - 2.0 * p[..., 1]], dim=-1
    )


def camera_to_ray(p: torch.Tensor, camera: Camera, screen_size, texture_size) -> torch.Tensor:
    """Camera-plane point -> unit world ray direction (common.cu:75-88)."""
    screen = _f32(screen_size, p.device)
    tex = _f32(texture_size, p.device)
    width_factor = (screen[0] / tex[0]) * (tex[1] / screen[1])
    fov_fac = torch.tan(camera.fov / 2.0)
    d = (
        camera.forward
        + p[..., 1:2] * fov_fac * camera.up
        + p[..., 0:1] * fov_fac * width_factor * camera.right
    )
    return d / _norm3(d)[..., None]


def _pixel_to_dir(pix: torch.Tensor, camera: Camera, screen_size, texture_size) -> torch.Tensor:
    ndc = texture_to_ndc(pix, texture_size)
    cam = ndc_to_camera(ndc, texture_size)
    return camera_to_ray(cam, camera, screen_size, texture_size)


def pixel_cone_radius(
    pixel_coords: torch.Tensor, camera: Camera, screen_size, texture_size
) -> torch.Tensor:
    """Per-pixel cone radius at unit depth: the largest distance between the
    center ray and the rays through 4 corners offset by +-1/sqrt(2) px
    (common.cu:94-184)."""
    center = _pixel_to_dir(pixel_coords, camera, screen_size, texture_size)
    offsets = _f32(
        [
            [-SQRT_INV, -SQRT_INV],
            [-SQRT_INV, SQRT_INV],
            [SQRT_INV, -SQRT_INV],
            [SQRT_INV, SQRT_INV],
        ],
        pixel_coords.device,
    )
    corners = _pixel_to_dir(
        pixel_coords[..., None, :] + offsets, camera, screen_size, texture_size
    )  # (..., 4, 3)
    dist = _norm3(center[..., None, :] - corners)  # (..., 4)
    return dist.amax(dim=-1)


def generate_rays(camera: Camera, texture_size, screen_size):
    """Full-image ray bundle on the camera's device.

    Returns contiguous float32 ``(origins, directions, cone_radius)`` of
    shapes ``(H, W, 3), (H, W, 3), (H, W)``."""
    width, height = int(texture_size[0]), int(texture_size[1])
    device = camera.position.device
    xs = torch.arange(width, dtype=torch.float32, device=device)
    ys = torch.arange(height, dtype=torch.float32, device=device)
    pix = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)  # (H, W, 2)

    directions = _pixel_to_dir(pix, camera, screen_size, texture_size)
    cone = pixel_cone_radius(pix, camera, screen_size, texture_size)
    origins = camera.position.expand(directions.shape).contiguous()
    return origins, directions.contiguous(), cone.contiguous()
