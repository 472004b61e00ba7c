from bsdmg_tpu_torch.ops.shade import (
    aces_tonemap,
    render_image,
    shade_hits,
    shade_planes,
    to_rgba8,
)
from bsdmg_tpu_torch.ops.trace import (
    COLLISION,
    DEPTH_LIMIT,
    STEP_LIMIT,
    RayMarchHit,
    sphere_trace,
)

__all__ = [
    "COLLISION",
    "DEPTH_LIMIT",
    "STEP_LIMIT",
    "RayMarchHit",
    "aces_tonemap",
    "render_image",
    "shade_hits",
    "shade_planes",
    "sphere_trace",
    "to_rgba8",
]
