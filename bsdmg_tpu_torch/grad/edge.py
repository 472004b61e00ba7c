"""Silhouette-aware gradient terms for inverse rendering.

Port of ``bsdmg_tpu/grad/edge.py``. The implicit-function re-attachment of
the differentiable render (``grad/diff_render.py``) differentiates pixels
whose outcome is stable; a hit that turns into a miss is a step that carries
no gradient. The closest-approach loss adds the boundary's information: the
march records, per ray, ``min_margin = min_t (f(x(t)) - cone*t)`` and the
depth ``t_min`` where it occurred, and by the envelope theorem the
parameter gradient of that margin is the gradient of one SDF evaluation at
the recorded point. Pixels whose outcome disagrees with the target get a
hinge on it: rays that should hit but miss pull their margin to zero
("appear"); rays that hit but should miss push it past a small band
("vanish").
"""

from __future__ import annotations

import torch

from bsdmg_tpu_torch.sdf.primitives import maximum

#: min_margin of a ray the march never sampled (slab-culled sky); the
#: march's initial value (ops/cuda/render_kernel.py::_march, csrc
#: diff_kernel.cu BSDMG_UNTRACKED). Comparisons use strict ``<``.
UNTRACKED = 1e9


def classify_target_miss(target: torch.Tensor) -> torch.Tensor:
    """Per-pixel miss mask of an RGB target ``(..., 3)``: True where it
    shows no surface, black (DepthLimit) or white (StepLimit, ACES(1) =
    0.6191 per channel); collision colours keep their minimum channel below
    0.35 and their maximum above 0.2."""
    mx = target.amax(dim=-1)
    mn = target.amin(dim=-1)
    return (mx < 0.05) | (mn > 0.5)


def edge_loss_planes(
    f,
    ox, oy, oz, dx, dy, dz,
    cone,
    t_min,
    min_margin,
    collided,
    target_state,
    band: float,
):
    """Per-pixel silhouette hinge loss on coordinate planes (unreduced).

    ``f(x, y, z)`` is the SDF with the differentiated parameters closed
    over; ``t_min`` and ``min_margin`` are the march's closest-approach
    record (constants); ``collided`` the current render's hits;
    ``target_state`` 0 where the target hits, 1 where it misses, -1 to
    ignore; ``band`` the margin the vanish hinge pushes past. The hinge is
    linear, zero wherever the outcomes already agree."""
    valid = target_state > -0.5
    tgt_miss = target_state > 0.5
    tracked = min_margin < UNTRACKED
    ex = ox + t_min * dx
    ey = oy + t_min * dy
    ez = oz + t_min * dz
    m = f(ex, ey, ez) - cone * t_min

    appear = valid & ~tgt_miss & ~collided & tracked
    vanish = valid & tgt_miss & collided
    e_app = maximum(m, 0.0)
    e_van = maximum(band - m, 0.0)
    return torch.where(appear, e_app, 0.0) + torch.where(vanish, e_van, 0.0)
