"""Shading: two-colour Lambert mix, ACES filmic tonemap, RGBA8 conversion.

Port of ``bsdmg_tpu/ops/shade.py`` (reference: cuda/modules/compute_render.cu:
67-96 and cuda/includes/color.cu:7-22). The ACES step is written element by
element, as the fused TPU kernel's ``_aces_plane`` is, so the plain version
and the CUDA kernel run the same float32 operations in the same order.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from bsdmg_tpu_torch.config import MarchConfig
from bsdmg_tpu_torch.ops.trace import COLLISION, STEP_LIMIT, RayMarchHit, sphere_trace
from bsdmg_tpu_torch.sdf.normals import normal_fd4, normal_grad

# Collision gradient colors (compute_render.cu:73-76), in linear [0,1].
COLOR_LOW = (19.0 / 255.0, 9.0 / 255.0, 130.0 / 255.0)
COLOR_HIGH = (240.0 / 255.0, 103.0 / 255.0, 24.0 / 255.0)
LIGHT_DIR = (1.0, 1.0, 1.0)  # normalized below (compute_render.cu:67)

# ACES input/output matrices (color.cu:8-17). GLM mat3x3 constructor is
# column-major, so the rows here are the rows of the effective matrix.
_ACES_M1 = (
    (0.59719, 0.35458, 0.04823),
    (0.07600, 0.90834, 0.01566),
    (0.02840, 0.13383, 0.83777),
)
_ACES_M2 = (
    (1.60475, -0.53108, -0.07367),
    (-0.10208, 1.10813, -0.00605),
    (-0.00327, -0.07276, 1.07602),
)

# Stephen Hill's ACES curve fit: (v (v + A) - B) / (v (C v + D) + E)
ACES_CURVE = (0.0245786, 0.000090537, 0.983729, 0.4329510, 0.238081)


def light_direction() -> tuple[float, float, float]:
    """The unit light direction, in float64."""
    inv = 1.0 / math.sqrt(LIGHT_DIR[0] ** 2 + LIGHT_DIR[1] ** 2 + LIGHT_DIR[2] ** 2)
    return tuple(c * inv for c in LIGHT_DIR)


def _mat3(m, x, y, z):
    return (
        m[0][0] * x + m[0][1] * y + m[0][2] * z,
        m[1][0] * x + m[1][1] * y + m[1][2] * z,
        m[2][0] * x + m[2][1] * y + m[2][2] * z,
    )


def aces_planes(r, g, b):
    """ACES tonemap of ``(r, g, b)`` planes, clamped to [0, 1]."""
    ca, cb, cc, cd, ce = ACES_CURVE

    def curve(v):
        return (v * (v + ca) - cb) / (v * (cc * v + cd) + ce)

    vr, vg, vb = _mat3(_ACES_M1, r, g, b)
    rr, gg, bb = _mat3(_ACES_M2, curve(vr), curve(vg), curve(vb))
    return tuple(torch.clamp(v, 0.0, 1.0) for v in (rr, gg, bb))


def aces_tonemap(rgb: torch.Tensor) -> torch.Tensor:
    """ACES filmic tonemap of ``(..., 3)`` linear RGB (color.cu:7-22)."""
    return torch.stack(aces_planes(rgb[..., 0], rgb[..., 1], rgb[..., 2]), dim=-1)


def shade_planes(nx, ny, nz, outcome):
    """Lambert two-colour mix on collisions, white on step-limit, black
    otherwise, then ACES. Returns ``(r, g, b)`` planes."""
    lx, ly, lz = light_direction()
    t = (nx * lx + ny * ly + nz * lz + 1.0) * 0.5
    collided = outcome == COLLISION
    white = (outcome == STEP_LIMIT).to(torch.float32)
    r = torch.where(collided, COLOR_LOW[0] + t * (COLOR_HIGH[0] - COLOR_LOW[0]), white)
    g = torch.where(collided, COLOR_LOW[1] + t * (COLOR_HIGH[1] - COLOR_LOW[1]), white)
    b = torch.where(collided, COLOR_LOW[2] + t * (COLOR_HIGH[2] - COLOR_LOW[2]), white)
    return aces_planes(r, g, b)


def shade_hits(
    sdf: Callable[[torch.Tensor], torch.Tensor],
    hit: RayMarchHit,
    config: MarchConfig = MarchConfig(),
    *,
    use_grad_normal: bool = False,
) -> torch.Tensor:
    """Shade a traced ray batch into linear RGB ``(..., 3)``
    (compute_render.cu:67-89), with fd4 normals, or the analytic gradient's
    with ``use_grad_normal``."""
    device = hit.position.device
    light = torch.tensor(LIGHT_DIR, dtype=torch.float32, device=device)
    light = light / torch.linalg.vector_norm(light)
    if use_grad_normal:
        normal = normal_grad(sdf, hit.position)
    else:
        normal = normal_fd4(sdf, hit.position, config.normal_epsilon)

    t = ((normal * light).sum(dim=-1) + 1.0) / 2.0
    low = torch.tensor(COLOR_LOW, dtype=torch.float32, device=device)
    high = torch.tensor(COLOR_HIGH, dtype=torch.float32, device=device)
    collision_color = low + t[..., None] * (high - low)

    outcome = hit.outcome[..., None]
    color = torch.where(outcome == COLLISION, collision_color, 0.0)
    color = torch.where(outcome == STEP_LIMIT, 1.0, color)
    return aces_tonemap(color)


def to_rgba8(rgb: torch.Tensor) -> torch.Tensor:
    """Linear [0,1] RGB -> RGBA8, opaque alpha (compute_render.cu:91-96).
    The reference C-casts ``clamp(c,0,1) * 255``, which truncates."""
    rgb8 = (torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8)
    alpha = torch.full(rgb.shape[:-1] + (1,), 255, dtype=torch.uint8, device=rgb.device)
    return torch.cat([rgb8, alpha], dim=-1)


def render_image(
    sdf: Callable[[torch.Tensor], torch.Tensor],
    origins: torch.Tensor,
    directions: torch.Tensor,
    cone_radius: torch.Tensor,
    config: MarchConfig = MarchConfig(),
    *,
    use_grad_normal: bool = False,
) -> torch.Tensor:
    """Trace + shade a ray bundle to linear RGB ``(..., 3)`` with the plain
    oracle tracer."""
    hit = sphere_trace(sdf, origins, directions, cone_radius, config)
    return shade_hits(sdf, hit, config, use_grad_normal=use_grad_normal)


def render_image_c(
    csdf_p,
    params,
    origins: torch.Tensor,
    directions: torch.Tensor,
    cone_radius,
    config: MarchConfig = MarchConfig(),
    *,
    use_grad_normal: bool = False,
) -> torch.Tensor:
    """Component-form trace + shade with the scene as ``csdf_p(params, x,
    y, z)`` (``Scene.csdf``) at run-time ``params``: :func:`render_image`'s
    semantics on coordinate planes, in plain PyTorch (the march and fd4
    stencil of kernel K1's twin, ``ops/cuda/render_kernel.py``).
    ``use_grad_normal`` takes forward-mode analytic normals
    (``normal_jvp_c``) over the reference's fd4 stencil. Returns linear RGB
    ``(..., 3)``."""
    # imported here: render_kernel imports this module's colour constants
    from bsdmg_tpu_torch.ops.cuda.render_kernel import _fd_normal, _march
    from bsdmg_tpu_torch.sdf.normals import normal_jvp_c

    batch = origins.shape[:-1]
    cone = torch.as_tensor(cone_radius, dtype=torch.float32,
                           device=origins.device).broadcast_to(batch).reshape(-1)
    ox, oy, oz = (origins[..., a].reshape(-1) for a in range(3))
    dx, dy, dz = (directions[..., a].reshape(-1) for a in range(3))

    def f(x, y, z):
        return csdf_p(params, x, y, z)

    depth = torch.zeros_like(cone)
    with torch.no_grad():
        _, outcome, _, _, _ = _march(f, config, ox, oy, oz, dx, dy, dz, cone,
                                     torch.ones_like(cone, dtype=torch.bool), depth,
                                     torch.full_like(cone, config.depth_limit))
    px, py, pz = ox + depth * dx, oy + depth * dy, oz + depth * dz
    if use_grad_normal:
        nx, ny, nz = normal_jvp_c(f, px, py, pz)
    else:
        nx, ny, nz = _fd_normal(f, px, py, pz, config.normal_epsilon)
    return torch.stack(shade_planes(nx, ny, nz, outcome), dim=-1).reshape(*batch, 3)
