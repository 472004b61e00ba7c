"""Sphere tracing with cone-radius adaptive thresholds: the plain oracle.

Port of ``bsdmg_tpu/ops/trace.py``. Semantics of the reference tracer
(cuda/includes/ray_marching.cu:14-49):

* collision when ``d <= cone_radius * depth + collision_distance``;
* step size ``d - cone_radius * depth``;
* outcomes Collision / StepLimit (default) / DepthLimit;
* ``steps`` counts completed advances.

The whole batch advances under per-ray active masks until every ray has
resolved. The CUDA render kernel (``ops/cuda/render_kernel.py``) is held
against this.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from bsdmg_tpu_torch.config import MarchConfig

# Outcome codes (reference: cuda/includes/bindings.h:12-14).
COLLISION = 0
STEP_LIMIT = 1
DEPTH_LIMIT = 2

SdfFn = Callable[[torch.Tensor], torch.Tensor]


class RayMarchHit(NamedTuple):
    """Batched ray-march result (cuda/includes/types.cu:8-14)."""

    steps: torch.Tensor  # (...,) int32 completed advances
    position: torch.Tensor  # (..., 3) final march position
    depth: torch.Tensor  # (...,) distance travelled along the ray
    outcome: torch.Tensor  # (...,) int32: COLLISION / STEP_LIMIT / DEPTH_LIMIT


def sphere_trace(
    sdf: SdfFn,
    origins: torch.Tensor,
    directions: torch.Tensor,
    cone_radius=0.0,
    config: MarchConfig = MarchConfig(),
) -> RayMarchHit:
    """March a batch of rays (``(..., 3)`` origins and unit directions)
    against ``sdf``; ``cone_radius`` is a scalar or ``(...,)``."""
    batch = origins.shape[:-1]
    device = origins.device
    cone = torch.as_tensor(cone_radius, dtype=torch.float32, device=device).broadcast_to(batch)

    position = origins
    depth = torch.zeros(batch, dtype=torch.float32, device=device)
    steps = torch.zeros(batch, dtype=torch.int32, device=device)
    outcome = torch.full(batch, STEP_LIMIT, dtype=torch.int32, device=device)
    active = torch.ones(batch, dtype=torch.bool, device=device)

    while bool(active.any()):
        collision_distance = cone * depth
        d = sdf(position)

        hit = active & (d <= collision_distance + config.collision_distance)
        outcome = torch.where(hit, COLLISION, outcome)

        advance = active & ~hit
        step = d - collision_distance
        depth = torch.where(advance, depth + step, depth)
        position = torch.where(
            advance[..., None], position + step[..., None] * directions, position
        )

        over_depth = advance & (depth > config.depth_limit)
        outcome = torch.where(over_depth, DEPTH_LIMIT, outcome)

        survived = advance & ~over_depth
        steps = torch.where(survived, steps + 1, steps)
        active = survived & (steps < config.step_limit)
    return RayMarchHit(steps, position, depth, outcome)
