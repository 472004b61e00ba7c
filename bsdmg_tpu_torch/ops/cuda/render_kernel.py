"""The reference-scene render: wrappers of CUDA kernels K1, K2 and K3 and
their plain twins.

Counterpart of ``bsdmg_tpu/ops/pallas/render_kernel.py``. Its three
``pallas_call`` sites become three kernels (``csrc/render_kernel.cu``):

* K1, ``_trace_kernel(shade=True)``: per ray the slab cull
  (``_slab_cull``: a ray that cannot reach the scene box, inflated by
  ``cone * T* + eps + slack``, is retired at once with depth ``1.01 *
  depth_limit``; every other ray gets the box's exit depth as its stop
  depth, and the march starts at 0, as the reference's does), the march
  (``_march``, exact or over-relaxed), fd4 normals (``_fd_normal``), the
  Lambert two-colour mix (``shade_planes``) and ACES (``_aces_plane``). The
  default render, and both phases of block retirement;
* K2, ``_trace_kernel(shade=False)``: the march alone, resumable, over the
  full frame or over a device-resident list of rays;
* K3, ``_shade_kernel``: the epilogue alone, from depth and outcome.

:func:`render_image_cuda`, :func:`trace_cuda`, :func:`sphere_trace_cuda`
and :func:`shade_cuda` send CUDA tensors to the kernels and CPU tensors to
the plain PyTorch twins (:func:`render_image_planes_torch`,
:func:`trace_planes_torch`, :func:`shade_planes_torch`); nothing falls back
from one to the other.

``split`` is the near/far split of ``csdf.py::compile_scene_split``,
``(far, (lo, hi, slack))``: the rays of a warp (an 8x4 patch, or 32 rays of
K2's listed tail, listed in patch order) that all miss the near box march
``far`` alone (render_kernel.py:412-432), and K1 shades their hits with
``far`` (its fused epilogue, :380-384) where K3 shades every hit with the
full scene; the twins group the rays as the kernels do
(:func:`patch_groups`, :func:`listed_groups`).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from bsdmg_tpu_torch.config import MarchConfig
from bsdmg_tpu_torch.ops.cuda.build import load_library
from bsdmg_tpu_torch.ops.cuda.grid_box import MAX_GRID_RESOLUTION, GridBoxC, grid_box_c
from bsdmg_tpu_torch.ops.cuda.csdf import (
    COMPOSED_LARGE,
    MAX_GROUP_VALUES,
    MAX_GROUPS,
    CapsuleGroup,
    CapsuleSet,
    SceneDescriptor,
    descriptor_csdf,
    f32,
    kernel_structure,
    program_depths,
    program_slots,
)
from bsdmg_tpu_torch.ops.shade import (
    _ACES_M1,
    _ACES_M2,
    ACES_CURVE,
    COLOR_HIGH,
    COLOR_LOW,
    light_direction,
    shade_planes,
)
from bsdmg_tpu_torch.ops.trace import COLLISION, DEPTH_LIMIT, STEP_LIMIT, RayMarchHit

#: launches of K1, K2 and K3 in this process; each launch adds one to its own
LAUNCHES = 0
TRACE_LAUNCHES = 0
SHADE_LAUNCHES = 0
#: K1's launches by the structure they ran (``kernel_structure``'s index)
STRUCTURE_LAUNCHES: collections.Counter = collections.Counter()
#: launches of the near/far split's instantiations, ``"K1"``
#: (render_split_kernel) and ``"K2"`` (trace_split_kernel); each is counted
#: in LAUNCHES or TRACE_LAUNCHES too
SPLIT_LAUNCHES: collections.Counter = collections.Counter()

#: the kernel's source, relative to the repository root
SOURCE = "bsdmg_tpu_torch/csrc/render_kernel.cu"


# ---------------------------------------------------------------------------
# plain PyTorch twin
# ---------------------------------------------------------------------------


def _bounds_parts(bb):
    """``(lo, hi, slack)`` of a bounds tuple; a bare ``(lo, hi)`` gets the
    JAX package's default slack 0.1 (render_kernel.py::_bb_parts)."""
    if len(bb) > 2:
        return bb[0], bb[1], float(bb[2])
    return bb[0], bb[1], 0.1


def _cull_sphere(bb):
    """Centre and half-diagonal of the bounds, in float64 as the JAX
    package computes them on the host."""
    lo, hi, _ = _bounds_parts(bb)
    center = tuple((lo[a] + hi[a]) * 0.5 for a in range(3))
    radius = 0.5 * float(np.sqrt(sum((hi[a] - lo[a]) ** 2 for a in range(3))))
    return center, radius


def _slab_cull(bb, ox, oy, oz, dx, dy, dz, cone, config: MarchConfig):
    """Returns ``(miss, t_exit)`` for the bounds ``bb``
    (render_kernel.py::_slab_cull).

    A collision at depth t needs ``f <= cone*t + eps`` and
    ``f >= t - D - r - slack`` (D the origin's distance to the box centre, r
    the box's half-diagonal), so ``t <= T* = (D + r + slack + eps)/(1 - cone)``
    and the ray must pierce the box inflated by ``cone*T* + eps + slack``."""
    lo, hi, slack = _bounds_parts(bb)
    (cx, cy, cz), radius = _cull_sphere(bb)
    eps = config.collision_distance
    ex, ey, ez = ox - cx, oy - cy, oz - cz
    reach = torch.sqrt(ex * ex + ey * ey + ez * ez) + radius + slack + eps
    t_star = torch.where(
        cone < 0.5, reach / torch.clamp_min(1.0 - cone, 0.5), config.depth_limit
    )
    margin = cone * torch.clamp_max(t_star, config.depth_limit) + eps + slack

    def axis(o, d, lo_a, hi_a):
        d_safe = torch.where(torch.abs(d) < 1e-12, torch.where(d < 0, -1e-12, 1e-12), d)
        inv = 1.0 / d_safe
        t1 = (lo_a - margin - o) * inv
        t2 = (hi_a + margin - o) * inv
        return torch.minimum(t1, t2), torch.maximum(t1, t2)

    nx, fx = axis(ox, dx, lo[0], hi[0])
    ny, fy = axis(oy, dy, lo[1], hi[1])
    nz, fz = axis(oz, dz, lo[2], hi[2])
    tmin = torch.maximum(nx, torch.maximum(ny, nz))
    tmax = torch.minimum(fx, torch.minimum(fy, fz))
    t_enter = torch.clamp_min(tmin, 0.0)
    return tmax < t_enter, torch.clamp_min(tmax, 0.0)


def patch_groups(h: int, w: int, device) -> torch.Tensor:
    """Each ray's warp in K1's and K2's layout, flat int64: its 8x4 patch
    (csrc/render_kernel.cu tile_pixel), on which the near/far split votes."""
    py = torch.arange(h, device=device)[:, None] // 4
    px = torch.arange(w, device=device)[None, :] // 8
    return (py * -(-w // 8) + px).reshape(-1)


def listed_groups(index: torch.Tensor, count: torch.Tensor, n: int) -> torch.Tensor:
    """Each ray's warp in K2's listed launch, flat int64: the place of a
    listed ray in the list (:func:`compact_list`) over 32, -1 for a ray not
    listed."""
    k = int(count.item())
    groups = torch.full((n,), -1, dtype=torch.int64, device=index.device)
    groups[index[:k].long()] = torch.arange(k, device=index.device) // 32
    return groups


def far_rays(split, ox, oy, oz, dx, dy, dz, cone, config: MarchConfig, active,
             groups) -> torch.Tensor:
    """The near/far split's vote (render_kernel.cu march_split): the rays
    whose group holds no ``active`` ray that can reach the near box of
    ``split``; they march the far scene alone."""
    miss, _ = _slab_cull(split[1], ox, oy, oz, dx, dy, dz, cone, config)
    near = (active & ~miss).to(torch.int32)
    g = groups.clamp_min(0)
    counts = torch.zeros(int(g.max()) + 1 if g.numel() else 1, dtype=torch.int32,
                         device=g.device).index_add_(0, g, near)
    return counts[g] == 0


def _march(csdf, config: MarchConfig, ox, oy, oz, dx, dy, dz, cone, active, depth, limit,
           track_min: bool = False, *, steps0=None, outcome0=None, budget: int | None = None,
           omega: float = 1.0):
    """Sphere trace of the ``active`` rays of flat ray planes
    (render_kernel.py::_march). Updates ``depth`` in place and returns
    ``(steps, outcome, min_m, t_min, unresolved)``; with ``track_min``
    ``min_m`` and ``t_min`` are the closest-approach record, the minimum of
    ``f - cone*t`` over the sampled points and its depth (1e9 and 0 for a
    ray never sampled), else None.

    Resumable as the JAX function: ``steps0`` carries prior steps (default
    0), each active ray stops when its steps reach ``min(budget,
    step_limit)`` but always takes its first iteration, rays that are not
    active keep their ``outcome0`` (default DEPTH_LIMIT), and
    ``unresolved`` marks the rays that stopped at the budget short of the
    step limit.

    ``omega > 1`` is the over-relaxed step (``step_relaxed``,
    render_kernel.py:211-237): each step is ``omega`` times the safe one;
    when two consecutive safety spheres stop overlapping, the ray rewinds to
    ``depth - step_len + prev_r`` and steps exactly from there. That state
    starts at ``(0, 0, omega)`` at every call, so a relaxed march split into
    two calls is not one relaxed march, in the JAX package too.

    The rays still marching are gathered each step, so the cost follows the
    live rays; every per-ray operation is the kernel's."""
    relaxed = float(omega) > 1.0
    if track_min and relaxed:
        raise NotImplementedError("track_min requires exact stepping (omega=1)")
    eps = config.collision_distance
    step_cap = config.step_limit if budget is None else min(int(budget), config.step_limit)
    if steps0 is None:
        steps = torch.zeros_like(depth, dtype=torch.int32)
    else:
        steps = steps0.to(torch.int32, copy=True)
    if outcome0 is None:
        outcome = torch.full_like(steps, DEPTH_LIMIT)
    else:
        outcome = outcome0.to(torch.int32, copy=True)
    outcome[active] = STEP_LIMIT
    min_m = t_min = None
    if track_min:
        # 1e9 == grad/edge.py::UNTRACKED
        min_m = torch.full_like(depth, 1e9)
        t_min = torch.zeros_like(depth)
    if relaxed:
        prev_r = torch.zeros_like(depth)
        step_len = torch.zeros_like(depth)
        om = torch.full_like(depth, float(omega))
    live = active.nonzero().squeeze(1)
    while live.numel():
        t = depth[live]
        cd = cone[live] * t
        dist = csdf(ox[live] + t * dx[live], oy[live] + t * dy[live], oz[live] + t * dz[live])
        if track_min:
            m = dist - cd
            closer = m < min_m[live]
            min_m[live[closer]] = m[closer]
            t_min[live[closer]] = t[closer]
        if relaxed:
            r = dist - cd
            pr, sl = prev_r[live], step_len[live]
            fail = sl > torch.abs(pr) + torch.abs(r)
            t = torch.where(fail, t - sl + pr, t)
            o = torch.where(fail, 1.0, om[live])
            hit = ~fail & (dist <= cd + eps)
            advance = ~hit
            new_step = torch.where(fail, 0.0, o * r)
            t = torch.where(advance, t + new_step, t)
            depth[live] = t
            om[live] = o
            prev_r[live] = torch.where(fail, pr, r)
            step_len[live] = torch.where(advance, new_step, sl)
        else:
            hit = dist <= cd + eps
            advance = ~hit
            t = t + dist - cd
            depth[live[advance]] = t[advance]
        outcome[live[hit]] = COLLISION
        over = advance & (t > limit[live])
        outcome[live[over]] = DEPTH_LIMIT
        survived = advance & ~over
        s = steps[live] + survived.to(torch.int32)
        steps[live] = s
        live = live[survived & (s < step_cap)]
    unresolved = (outcome == STEP_LIMIT) & (steps >= step_cap) & (steps < config.step_limit)
    return steps, outcome, min_m, t_min, unresolved


def _fd_normal(csdf, px, py, pz, eps: float):
    """4th-order central-difference normal, 12 evaluations
    (render_kernel.py::_fd_normal)."""

    def deriv(fp2, fp1, fm1, fm2):
        return -fp2 + 8.0 * fp1 - 8.0 * fm1 + fm2

    gx = deriv(
        csdf(px + 2 * eps, py, pz), csdf(px + eps, py, pz),
        csdf(px - eps, py, pz), csdf(px - 2 * eps, py, pz),
    )
    gy = deriv(
        csdf(px, py + 2 * eps, pz), csdf(px, py + eps, pz),
        csdf(px, py - eps, pz), csdf(px, py - 2 * eps, pz),
    )
    gz = deriv(
        csdf(px, py, pz + 2 * eps), csdf(px, py, pz + eps),
        csdf(px, py, pz - eps), csdf(px, py, pz - 2 * eps),
    )
    inv = torch.rsqrt(torch.clamp_min(gx * gx + gy * gy + gz * gz, 1e-24))
    return gx * inv, gy * inv, gz * inv


def _flat_rays(origins, directions, cone):
    return (*(origins[..., a].reshape(-1) for a in range(3)),
            *(directions[..., a].reshape(-1) for a in range(3)), cone.reshape(-1))


def trace_planes_torch(scene_desc: SceneDescriptor, origins: torch.Tensor,
                       directions: torch.Tensor, cone: torch.Tensor, *carried, **options):
    """Plain PyTorch version of kernel K2, the resumable trace
    (render_kernel.py::_trace_kernel with ``shade=False``), on any device.

    The carried state ``(depth0, steps0, outcome0, active0)`` defaults to a
    fresh march: depth 0, steps 0, DEPTH_LIMIT and every ray active. The
    keyword ``options`` are ``config``, ``budget``, ``use_bb_skip`` (default
    True), ``omega`` (default 1), ``split`` and ``groups``. With
    ``use_bb_skip`` the active rays that cannot reach the scene's bounds
    keep their ``outcome0`` and get depth ``1.01 * depth_limit``
    (:355-368), the others stop at the box's exit depth; without it, or
    for an unbounded scene (the JAX package's ``bb=None``), at the depth
    limit.
    Rays that are not active keep their state. With ``split``, the active
    rays of a group (``groups``, default :func:`patch_groups`) that all miss
    its near box march its far scene (:func:`far_rays`). Returns ``(depth,
    steps, outcome, active)`` ``(H, W)`` planes; ``active`` (int32) marks
    the rays that stopped at ``budget`` short of the step limit
    (:281-283)."""
    return trace_far_planes_torch(scene_desc, origins, directions, cone, *carried,
                                  **options)[:4]


def trace_far_planes_torch(
    scene_desc: SceneDescriptor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    cone: torch.Tensor,
    depth0: torch.Tensor | None = None,
    steps0: torch.Tensor | None = None,
    outcome0: torch.Tensor | None = None,
    active0: torch.Tensor | None = None,
    *,
    config: MarchConfig = MarchConfig(),
    budget: int | None = None,
    use_bb_skip: bool = True,
    omega: float = 1.0,
    split=None,
    groups: torch.Tensor | None = None,
):
    """:func:`trace_planes_torch`'s four planes and a fifth, the ``(H, W)``
    bool plane of the rays that marched the far scene (all False without
    ``split``): the hits that K1 · split shades with it."""
    h, w = cone.shape
    ox, oy, oz, dx, dy, dz, c = _flat_rays(origins, directions, cone)
    if depth0 is None:
        depth = torch.zeros_like(c)
        active = torch.ones_like(c, dtype=torch.bool)
    else:
        depth = depth0.reshape(-1).clone()
        steps0, outcome0 = steps0.reshape(-1), outcome0.reshape(-1)
        active = active0.reshape(-1) != 0
    limit = torch.full_like(c, config.depth_limit)
    if use_bb_skip and scene_desc.bounds is not None:
        miss, t_exit = _slab_cull(scene_desc.bounds, ox, oy, oz, dx, dy, dz, c, config)
        depth[active & miss] = config.depth_limit * 1.01
        active = active & ~miss
        limit = torch.clamp_max(t_exit, config.depth_limit)
    marched_far = torch.zeros_like(active)
    if split is not None:
        far = far_rays(split, ox, oy, oz, dx, dy, dz, c, config, active,
                       patch_groups(h, w, c.device) if groups is None else groups)
        marched_far = active & far
        steps0, outcome0, _, _, _ = _march(
            descriptor_csdf(split[0]), config, ox, oy, oz, dx, dy, dz, c, marched_far, depth,
            limit, steps0=steps0, outcome0=outcome0, budget=budget, omega=omega,
        )
        active = active & ~far
    steps, outcome, _, _, unresolved = _march(
        descriptor_csdf(scene_desc), config, ox, oy, oz, dx, dy, dz, c, active, depth, limit,
        steps0=steps0, outcome0=outcome0, budget=budget, omega=omega,
    )
    return (depth.reshape(h, w), steps.reshape(h, w), outcome.reshape(h, w),
            unresolved.to(torch.int32).reshape(h, w), marched_far.reshape(h, w))


def shade_planes_torch(
    scene_desc: SceneDescriptor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    depth: torch.Tensor,
    outcome: torch.Tensor,
    config: MarchConfig = MarchConfig(),
    far=None,
) -> torch.Tensor:
    """Plain PyTorch version of kernel K3 (render_kernel.py::_shade_kernel),
    on any device: fd4 normals at the hits, the Lambert two-colour mix, white
    where the march hit the step limit, black elsewhere, then ACES. With
    ``far``, ``(far scene, mask)``, the hits of the ``(H, W)`` bool plane
    ``mask`` take their normals from the far scene: K1 · split's fused
    epilogue (render_kernel.py:380-384). Returns linear RGB ``(H, W, 3)``."""
    h, w = depth.shape
    ox, oy, oz, dx, dy, dz, _ = _flat_rays(origins, directions, depth)
    t_all, oc = depth.reshape(-1), outcome.reshape(-1)
    n = [torch.zeros_like(t_all) for _ in range(3)]
    hits = [(scene_desc, oc == COLLISION)]
    if far is not None:
        mask = far[1].reshape(-1)
        hits = [(scene_desc, hits[0][1] & ~mask), (far[0], hits[0][1] & mask)]
    for desc, rays in hits:
        hit = rays.nonzero().squeeze(1)
        if not hit.numel():
            continue
        t = t_all[hit]
        normal = _fd_normal(
            descriptor_csdf(desc), ox[hit] + t * dx[hit], oy[hit] + t * dy[hit],
            oz[hit] + t * dz[hit], config.normal_epsilon,
        )
        for plane, value in zip(n, normal):
            plane[hit] = value
    r, g, b = shade_planes(*n, oc)
    return torch.stack([r, g, b], dim=-1).reshape(h, w, 3)


def render_image_planes_torch(
    scene_desc: SceneDescriptor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    cone: torch.Tensor,
    config: MarchConfig = MarchConfig(),
    *,
    omega: float = 1.0,
    split=None,
):
    """Plain PyTorch version of kernel K1's render on any device: K2's twin
    from a fresh state, then K3's, which are K1's march (``omega > 1``
    relaxed; with ``split`` the near/far split) and epilogue; with
    ``split`` the far patches' hits are shaded with its far scene.

    Returns ``(rgb, depth, steps, outcome)``: linear RGB ``(H, W, 3)``
    float32, depth ``(H, W)`` float32, steps and outcome ``(H, W)`` int32."""
    depth, steps, outcome, _, far = trace_far_planes_torch(
        scene_desc, origins, directions, cone, config=config, omega=omega, split=split)
    rgb = shade_planes_torch(scene_desc, origins, directions, depth, outcome, config,
                             far=None if split is None else (split[0], far))
    return rgb, depth, steps, outcome


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


def _floats(n):
    return ctypes.c_float * n


class _CapsuleGroupC(ctypes.Structure):
    """``CapsuleGroup`` of csrc/scene_sdf.cuh."""

    _fields_ = [
        ("a0", ctypes.c_float),
        ("length", ctypes.c_float),
        ("v1", _floats(MAX_GROUP_VALUES)),
        ("v2", _floats(MAX_GROUP_VALUES)),
    ]


class _CapsuleSetC(ctypes.Structure):
    """``CapsuleSet`` of csrc/scene_sdf.cuh."""

    _fields_ = [
        ("radius", ctypes.c_float),
        ("groups", _CapsuleGroupC * MAX_GROUPS),
    ]


class _SceneDescC(ctypes.Structure):
    """``SceneDesc`` of csrc/scene_sdf.cuh: the scene, the march limits and
    the shading constants, all as the float32 values the plain twin computes
    with. The mesh kernels (K6, K7) take the same structure."""

    _fields_ = [
        ("object", _CapsuleSetC),
        ("frame", _CapsuleSetC),
        ("structure", ctypes.c_int),
        ("sphere_radius", ctypes.c_float),
        ("smooth_k", ctypes.c_float),
        ("inv_k", ctypes.c_float),
        ("k_6", ctypes.c_float),
        ("inv_rotation", _floats(9)),
        ("translation", _floats(3)),
        ("lo", _floats(3)),
        ("hi", _floats(3)),
        ("cull_center", _floats(3)),
        ("cull_radius", ctypes.c_float),
        ("slack", ctypes.c_float),
        ("collision_distance", ctypes.c_float),
        ("depth_limit", ctypes.c_float),
        ("cull_depth", ctypes.c_float),
        ("normal_epsilon", ctypes.c_float),
        ("step_limit", ctypes.c_int),
        ("light", _floats(3)),
        ("color_low", _floats(3)),
        ("color_delta", _floats(3)),
        ("aces_m1", _floats(9)),
        ("aces_m2", _floats(9)),
        ("aces_curve", _floats(5)),
        ("box_half", _floats(3)),
        ("scale", ctypes.c_float),
        ("cell", ctypes.c_float),
        ("half_cell", ctypes.c_float),
        ("program", ctypes.c_void_p),
        ("program_length", ctypes.c_int),
        ("walk_words", ctypes.c_int),
        ("grid_table", ctypes.c_void_p),
        ("grid", GridBoxC),
        ("grid_offset", _floats(3)),
        ("scratch", ctypes.c_void_p),
        ("scratch_threads", ctypes.c_int),
        ("program_depth", ctypes.c_int),
        ("program_frames", ctypes.c_int),
        ("split", ctypes.c_int),
        ("far", _CapsuleSetC),
        ("near_lo", _floats(3)),
        ("near_hi", _floats(3)),
        ("near_center", _floats(3)),
        ("near_radius", ctypes.c_float),
        ("near_slack", ctypes.c_float),
        ("frame_lo", _floats(3)),
        ("frame_hi", _floats(3)),
    ]


def _f32s(values):
    return [f32(v) for v in values]


def _capsule_group_c(g: CapsuleGroup) -> _CapsuleGroupC:
    return _CapsuleGroupC(g.a0, g.length, _floats(MAX_GROUP_VALUES)(*g.v1),
                          _floats(MAX_GROUP_VALUES)(*g.v2))


def _capsule_set_c(cs: CapsuleSet) -> _CapsuleSetC:
    return _CapsuleSetC(cs.radius, (_CapsuleGroupC * MAX_GROUPS)(*map(_capsule_group_c, cs.groups)))


def bounds_c(bb) -> dict:
    """The slab cull's fields of ``SceneDesc`` and ``ParamScene`` for the
    bounds ``bb``, as float32 values; zeros for an unbounded scene (None),
    which no kernel culls."""
    if bb is None:
        return dict(lo=_floats(3)(), hi=_floats(3)(), cull_center=_floats(3)(), cull_radius=0.0,
                    slack=0.0)
    lo, hi, slack = _bounds_parts(bb)
    center, radius = _cull_sphere(bb)
    return dict(
        lo=_floats(3)(*_f32s(lo)),
        hi=_floats(3)(*_f32s(hi)),
        cull_center=_floats(3)(*_f32s(center)),
        cull_radius=f32(radius),
        slack=f32(slack),
    )


def near_c(split) -> dict:
    """The near/far split's fields of ``SceneDesc`` and ``ParamScene``:
    ``split`` on, the near box's bounds as :func:`bounds_c` gives them;
    zeros for no split (None)."""
    b = bounds_c(None if split is None else split[1])
    return dict(split=int(split is not None), near_lo=b["lo"], near_hi=b["hi"],
                near_center=b["cull_center"], near_radius=b["cull_radius"], near_slack=b["slack"])


def march_c(config: MarchConfig) -> dict:
    """The march limits' fields of ``SceneDesc`` and ``ParamScene``."""
    return dict(
        collision_distance=f32(config.collision_distance),
        depth_limit=f32(config.depth_limit),
        cull_depth=f32(config.depth_limit * 1.01),
        step_limit=int(config.step_limit),
    )


def shading_c() -> dict:
    """The shading constants' fields of ``SceneDesc`` and ``ParamScene``
    (csrc/common.cuh reads them by name from either)."""
    return dict(
        light=_floats(3)(*_f32s(light_direction())),
        color_low=_floats(3)(*_f32s(COLOR_LOW)),
        color_delta=_floats(3)(*_f32s(h - l for h, l in zip(COLOR_HIGH, COLOR_LOW))),
        aces_m1=_floats(9)(*_f32s(v for row in _ACES_M1 for v in row)),
        aces_m2=_floats(9)(*_f32s(v for row in _ACES_M2 for v in row)),
        aces_curve=_floats(5)(*_f32s(ACES_CURVE)),
    )


def _grid_table(grid, device) -> torch.Tensor:
    """A grid's table as the grid structures read it: contiguous float32 on
    the CUDA ``device`` ("cuda": the current one), at most
    :data:`MAX_GRID_RESOLUTION` a side; raises otherwise."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    table, r = grid.values, grid.resolution
    if table.device != device:
        raise ValueError(f"the grid's table is on {table.device}, the launch on {device}")
    if table.dtype != torch.float32 or not table.is_contiguous() or table.shape != (r, r, r):
        raise ValueError(f"the grid's table must be a contiguous float32 ({r}, {r}, {r}) tensor")
    if not 2 <= r <= MAX_GRID_RESOLUTION:
        raise ValueError(f"a grid structure takes 2 <= R <= {MAX_GRID_RESOLUTION}, not {r}")
    return table


#: the axes of a capsule group's perpendicular values v1, v2, by its axis
#: (csrc/scene_sdf.cuh group_coords: the lower, then the higher other axis)
_PERPENDICULAR = {0: (1, 2), 1: (0, 2), 2: (0, 1)}


def frame_planes(frame: CapsuleSet) -> tuple[tuple[float, ...], tuple[float, ...]]:
    """``(lo, hi)``: per axis the two float32 values that every group of the
    wireframe ``frame`` takes as its perpendicular coordinates on that axis,
    the planes of its box (``SceneDesc::frame_lo``, ``frame_hi``, which the
    split's NearScene bound reads; csrc/scene_sdf.cuh frame_beyond). Raises
    for a wireframe whose groups take other values: the bound would not
    hold."""
    values = {0: set(), 1: set(), 2: set()}
    for g in frame.groups:
        b1, b2 = _PERPENDICULAR[g.axis]
        values[b1].update(f32(v) for v in g.v1)
        values[b2].update(f32(v) for v in g.v2)
    if any(len(v) != 2 for v in values.values()):
        raise ValueError(f"the wireframe is not a box's edges: its planes are {values}")
    return tuple(min(values[a]) for a in range(3)), tuple(max(values[a]) for a in range(3))


def frame_beyond_torch(frame: CapsuleSet, x, y, z, d) -> torch.Tensor:
    """The plain version of the split kernels' wireframe bound
    (csrc/scene_sdf.cuh frame_beyond), on float32 tensors: where True, the
    wireframe's term of the render scene's SDF exceeds the object's value
    ``d``, so its ``min`` is ``d``; NearScene leaves the term out there."""
    lo, hi = frame_planes(frame)
    a = [torch.minimum((c - lo[k]).abs(), (c - hi[k]).abs()) for k, c in enumerate((x, y, z))]
    m = torch.maximum(torch.minimum(a[0], a[1]), torch.minimum(torch.maximum(a[0], a[1]), a[2]))
    return (m > f32(1e-6)) & (m * f32(1.0 - 2.0**-20) - f32(frame.radius) > d)


def _check_split(desc: SceneDescriptor, split) -> None:
    """A split is a wireframe and a near box beside a reference scene with
    its wireframe, the structures K1 and K2 split (Box<true, *>)."""
    if split is None:
        return
    far, near = split
    if getattr(far, "kind", None) != "wireframe" or len(near) not in (2, 3):
        raise ValueError("split must be (far, (lo, hi[, slack])) of csdf.py::compile_scene_split")
    if desc.kind != "reference" or desc.frame is None:
        raise NotImplementedError(
            "the near/far split is built for the reference render scene (Box<true, *>), "
            "as compile_scene_split gives it"
        )
    frame_planes(desc.frame)


def scene_desc_c(desc: SceneDescriptor, config: MarchConfig = MarchConfig(),
                 device: torch.device | str = "cuda", split=None, *,
                 taped: bool = True) -> _SceneDescC:
    """The descriptor as the kernels take it (``SceneDesc``), with the
    index of the compiled structure it launches (:func:`kernel_structure`,
    which raises for a descriptor that matches none; its ``taped``, as
    there: by default the composed tier of the taped walk's caps, which
    every kernel takes, and with ``taped=False`` that of the forward walk
    alone, which only K1, K2 and K3 take) and the near/far ``split`` (None:
    none). A composed scene's
    node program is read from its buffer on the CUDA ``device`` ("cuda": the
    current one), uploaded there once (``NodeProgram.on_device``; each
    block of a small-tier launch stages its forward walk in shared memory,
    csrc/composed.cuh stage_walk); in the large tier its stacks
    live in a scratch buffer that each launch attaches
    (:func:`attach_scratch`). A grid's table is read where it lies, which
    must be that device."""
    _check_split(desc, split)
    structure = kernel_structure(desc, taped=taped)
    program = None if desc.program is None else desc.program.on_device(device)
    table = None if desc.grid is None else _grid_table(desc.grid, device)
    has_transform = desc.translation is not None
    rotation = [v for row in desc.inv_rotation for v in row] if has_transform else [0.0] * 9
    skeleton = desc.frame if desc.frame is not None else desc.object
    planes = frame_planes(desc.frame) if split is not None else ((0.0,) * 3,) * 2
    return _SceneDescC(
        object=_CapsuleSetC() if desc.object is None else _capsule_set_c(desc.object),
        frame=_CapsuleSetC() if skeleton is None else _capsule_set_c(skeleton),
        structure=structure,
        sphere_radius=desc.sphere_radius,
        smooth_k=desc.smooth_k,
        inv_k=desc.inv_k,
        k_6=desc.k_6,
        inv_rotation=_floats(9)(*rotation),
        translation=_floats(3)(*(desc.translation if has_transform else (0.0,) * 3)),
        normal_epsilon=f32(config.normal_epsilon),
        box_half=_floats(3)(*(desc.box_half or (0.0,) * 3)),
        scale=desc.scale or 0.0,
        cell=desc.cell or 0.0,
        half_cell=0.0 if desc.cell is None else f32(desc.cell / 2.0),
        program=None if program is None else program.data_ptr(),
        program_length=0 if program is None else len(desc.program),
        walk_words=0 if program is None else len(desc.program.walk),
        **dict(zip(("program_depth", "program_frames"),
                   program_depths(desc.program.instructions) if program is not None else (0, 0))),
        far=_CapsuleSetC() if split is None else _capsule_set_c(split[0].frame),
        **near_c(split),
        frame_lo=_floats(3)(*planes[0]),
        frame_hi=_floats(3)(*planes[1]),
        grid_table=None if table is None else table.data_ptr(),
        grid=GridBoxC() if table is None else grid_box_c(desc.grid.resolution, desc.grid.lo,
                                                          desc.grid.hi),
        grid_offset=_floats(3)(*(desc.offset or (0.0,) * 3)),
        **bounds_c(desc.bounds),
        **march_c(config),
        **shading_c(),
    )


def attach_scratch(desc_c: _SceneDescC, threads: int, device, *,
                   grad: bool = False) -> torch.Tensor | None:
    """For a node program in the large tier (``COMPOSED_LARGE``), a scratch
    buffer on ``device`` for a launch of ``threads`` threads, its stacks
    and frames and, with ``grad`` (K6, K7), its tape
    (``csdf.py::program_slots``), set in ``desc_c``; the caller keeps it
    until the launch is enqueued. None for any other structure."""
    if desc_c.structure != COMPOSED_LARGE:
        return None
    slots = program_slots(desc_c.program_length, desc_c.program_depth, desc_c.program_frames,
                          grad=grad)
    scratch = torch.empty(slots * threads, dtype=torch.float32, device=device)
    desc_c.scratch, desc_c.scratch_threads = scratch.data_ptr(), threads
    return scratch


def frame_threads(h: int, w: int) -> int:
    """The threads of K1's, K2's and K3's largest launch over an h x w
    frame: a 16x8 block of 128 threads a tile."""
    return -(-w // BLOCK_W) * -(-h // BLOCK_H) * 128


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel library with K1's, K2's and K3's entry points typed and the
    descriptor layout checked against the source's."""
    lib = load_library()
    ptr, i32, f32_c = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bsdmg_render.restype = i32
    lib.bsdmg_render.argtypes = [ptr] * 11 + [i32] * 4 + [f32_c, i32, i32, ptr]
    lib.bsdmg_trace.restype = i32
    lib.bsdmg_trace.argtypes = [ptr] * 14 + [i32] * 3 + [f32_c, i32, i32, ptr]
    lib.bsdmg_shade.restype = i32
    lib.bsdmg_shade.argtypes = [ptr] * 6 + [i32, i32, ptr]
    lib.bsdmg_scene_desc_size.restype = i32
    lib.bsdmg_scene_desc_size.argtypes = []
    lib.bsdmg_error_string.restype = ctypes.c_char_p
    lib.bsdmg_error_string.argtypes = [i32]
    size = lib.bsdmg_scene_desc_size()
    if size != ctypes.sizeof(_SceneDescC):
        raise RuntimeError(
            f"SceneDesc layout mismatch: {size} bytes in {SOURCE}, "
            f"{ctypes.sizeof(_SceneDescC)} in {__name__}"
        )
    return lib


#: K1's modes (csrc/render_kernel.cu): the default render; the first phase
#: of block retirement (a budget, the `active` plane written); its second
#: phase over a list of 16x8 blocks, in place
FRESH, PHASE_A, RESUME = 0, 1, 2

#: K1's block: 16x8 pixels, each of its 4 warps an 8x4 patch
BLOCK_W, BLOCK_H = 16, 8


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: cudaError {err} ({lib.bsdmg_error_string(err).decode()})"
        )


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _render_cuda(desc_c, origins, directions, cone, rgb, planes, *, cap: int, mode: int = FRESH,
                 active=None, blocks=None, cull: bool = True, omega: float = 1.0) -> None:
    """One launch of K1 from a prepared ``SceneDesc`` into ``rgb`` and the
    ``(depth, steps, outcome)`` ``planes`` (None: not written, FRESH only);
    ``blocks`` is RESUME's ``(list, count)``."""
    global LAUNCHES
    lib = library()
    h, w = cone.shape
    depth, steps, outcome = planes if planes is not None else (None,) * 3
    block_list, count = blocks if blocks is not None else (None, None)
    keep = attach_scratch(desc_c, frame_threads(h, w), cone.device)  # held until enqueued
    with torch.cuda.device(cone.device):
        err = lib.bsdmg_render(
            ctypes.addressof(desc_c), origins.data_ptr(), directions.data_ptr(), cone.data_ptr(),
            rgb.data_ptr(), _ptr(depth), _ptr(steps), _ptr(outcome), _ptr(active),
            _ptr(block_list), _ptr(count), mode, int(cull), int(omega > 1.0), cap, omega, h, w,
            _stream(cone),
        )
    _raise_on(err, lib, "render (K1)")
    LAUNCHES += 1
    STRUCTURE_LAUNCHES[desc_c.structure] += 1
    if desc_c.split:
        SPLIT_LAUNCHES["K1"] += 1


def _trace_cuda(desc_c, origins, directions, cone, carried, out, *, cap: int, active=None,
                rays=None, cull: bool = True, omega: float = 1.0) -> None:
    """One launch of K2 from a prepared ``SceneDesc``: the carried
    ``(depth0, steps0, outcome0, active0)`` planes (None: a fresh march)
    into the ``(depth, steps, outcome)`` planes ``out`` and ``active`` (None:
    not written); ``rays`` is the compacted tail's ``(list, count)``, marched
    in place (``out`` the carried planes)."""
    global TRACE_LAUNCHES
    lib = library()
    h, w = cone.shape
    ray_list, count = rays if rays is not None else (None, None)
    keep = attach_scratch(desc_c, frame_threads(h, w), cone.device)  # held until enqueued
    with torch.cuda.device(cone.device):
        err = lib.bsdmg_trace(
            ctypes.addressof(desc_c), origins.data_ptr(), directions.data_ptr(), cone.data_ptr(),
            *(map(_ptr, carried) if carried is not None else (None,) * 4),
            *(t.data_ptr() for t in out), _ptr(active), _ptr(ray_list), _ptr(count), int(cull),
            int(omega > 1.0), cap, omega, h, w, _stream(cone),
        )
    _raise_on(err, lib, "trace (K2)")
    TRACE_LAUNCHES += 1
    if desc_c.split:
        SPLIT_LAUNCHES["K2"] += 1


def _shade_cuda(desc_c, origins, directions, depth, outcome, rgb) -> None:
    """One launch of K3 from a prepared ``SceneDesc`` into ``rgb``."""
    global SHADE_LAUNCHES
    lib = library()
    h, w = depth.shape
    keep = attach_scratch(desc_c, frame_threads(h, w), depth.device)  # held until enqueued
    with torch.cuda.device(depth.device):
        err = lib.bsdmg_shade(
            ctypes.addressof(desc_c), origins.data_ptr(), directions.data_ptr(), depth.data_ptr(),
            outcome.data_ptr(), rgb.data_ptr(), h, w, _stream(depth),
        )
    _raise_on(err, lib, "shade (K3)")
    SHADE_LAUNCHES += 1


def compact_list(flags: torch.Tensor,
                 order: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(list, count)``: the indices of the nonzero entries of the flat
    int32 ``flags``, in order (or in the order of ``order``, a permutation
    of the indices, int32), and their number, both left on the device (no
    host sync): a cumsum of the flags, then a scatter. Entries of the list
    past the count are unspecified. The JAX package's fixed-capacity
    ``_gather_active``/``_scatter_back`` (render_kernel.py:592-634) move
    eleven planes only because Mosaic needs dense tiles; the kernels read
    this list instead."""
    n = flags.numel()
    if order is None:
        order = torch.arange(n, dtype=torch.int32, device=flags.device)
    else:
        flags = flags.index_select(0, order)
    position = torch.cumsum(flags, 0, dtype=torch.int32)
    slot = torch.where(flags != 0, position - 1, n).long()
    index = torch.empty(n + 1, dtype=torch.int32, device=flags.device)
    index.scatter_(0, slot, order)
    return index, position[-1:]


@functools.lru_cache(maxsize=8)
def patch_order(h: int, w: int, device) -> torch.Tensor:
    """The flat int32 indices of an ``(H, W)`` frame's pixels in 8x4-patch
    order: the patches in :func:`patch_groups`' order, each patch's pixels
    in lane order (csrc/render_kernel.cu tile_pixel's lane). The row tail's
    list with the near/far split (:func:`tail_list`) follows it, so that
    K2 · split's listed warps hold neighbouring rays. Cached per frame; the
    list gathers the flags through it as int32 (``index_select``), so no
    frame writes an int64 copy."""
    flat = torch.arange(h * w, device=device)
    py, px = flat // w, flat % w
    return torch.argsort(patch_groups(h, w, device) * 32 + (py % 4) * 8 + px % 8).to(torch.int32)


def tail_list(active: torch.Tensor, split) -> tuple[torch.Tensor, torch.Tensor]:
    """The row two-phase pipeline's tail, the list K2 marches 32 rays a
    warp: :func:`compact_list` of the ``(H, W)`` plane ``active``, with the
    near/far ``split`` in 8x4-patch order (:func:`patch_order`), so that a
    listed warp's rays vote and march as neighbours; without it row-major."""
    if split is None:
        return compact_list(active.reshape(-1))
    return compact_list(active.reshape(-1), patch_order(*active.shape, active.device))


def block_flags(active: torch.Tensor) -> torch.Tensor:
    """Flat int32 flags of K1's 16x8 blocks of the ``(H, W)`` plane
    ``active``, row-major: 1 where the block holds an active ray. The
    retirement granule of block retirement; the JAX package's is its 32x32
    swizzled block, one (8, 128) tile. The granule changes no pixel."""
    h, w = active.shape
    nbx, nby = -(-w // BLOCK_W), -(-h // BLOCK_H)
    padded = torch.nn.functional.pad(active, (0, nbx * BLOCK_W - w, 0, nby * BLOCK_H - h))
    return padded.reshape(nby, BLOCK_H, nbx, BLOCK_W).amax(dim=(1, 3)).reshape(-1)


def listed_flags(index: torch.Tensor, count: torch.Tensor, n: int) -> torch.Tensor:
    """The int32 flags of length ``n`` that are 1 at the first ``count``
    entries of ``index``: the inverse of :func:`compact_list`, which the
    twins take in place of a list."""
    flags = torch.zeros(n, dtype=torch.int32, device=index.device)
    flags[index[: int(count.item())].long()] = 1
    return flags


def block_rays(blocks: tuple[torch.Tensor, torch.Tensor], h: int, w: int) -> torch.Tensor:
    """The ``(H, W)`` int32 flags of the rays in the listed 16x8 blocks
    (``blocks`` from ``compact_list(block_flags(...))``)."""
    nbx, nby = -(-w // BLOCK_W), -(-h // BLOCK_H)
    flags = listed_flags(*blocks, nbx * nby).reshape(nby, 1, nbx, 1)
    return flags.expand(nby, BLOCK_H, nbx, BLOCK_W).reshape(nby * BLOCK_H, nbx * BLOCK_W)[:h, :w]


class _Frame:
    """The scene, rays and march options of one call, and the launches of a
    pipeline over them: the kernels for CUDA tensors, their plain twins for
    CPU tensors."""

    def __init__(self, desc, origins, directions, cone, config, use_bb_skip, omega, split=None):
        if desc.kind == "grid":
            raise NotImplementedError(
                "K1, K2 and K3 are not built for a grid: a mesh asset renders through "
                "ops/cuda/grid_kernel.py::render_image_grid"
            )
        if cone.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {cone.device}")
        self.desc, self.config = desc, config
        self.rays = (origins, directions, cone)
        # an unbounded scene (the wrapped object) has nothing to cull against
        self.cull = bool(use_bb_skip) and desc.bounds is not None
        self.omega = float(omega)
        self.split = split
        _check_split(desc, split)
        self.cuda = cone.device.type == "cuda"
        self.desc_c = (scene_desc_c(desc, config, cone.device, split, taped=False)
                       if self.cuda else None)

    def cap(self, budget: int | None) -> int:
        limit = self.config.step_limit
        return limit if budget is None else min(int(budget), limit)

    def _empty_planes(self):
        cone = self.rays[2]
        return (torch.empty_like(cone), *(torch.empty_like(cone, dtype=torch.int32)
                                          for _ in range(3)))

    def _twin(self, carried=None, budget=None, groups=None):
        """K2's twin, with the far plane (:func:`trace_far_planes_torch`)."""
        return trace_far_planes_torch(self.desc, *self.rays, *(carried or ()),
                                      config=self.config, budget=budget, use_bb_skip=self.cull,
                                      omega=self.omega, split=self.split, groups=groups)

    def _fused_shade(self, depth, outcome, far):
        """K1's epilogue on the twins' planes: the far patches' hits
        (``far``) shaded with the split's far scene."""
        return shade_planes_torch(self.desc, *self.rays[:2], depth, outcome, self.config,
                                  far=None if self.split is None else (self.split[0], far))

    def render(self, budget: int | None = None, planes: bool = False):
        """K1 from a fresh state: ``(rgb, depth, steps, outcome, active)``.
        With ``budget`` (PHASE_A) every plane is written; else (FRESH) the
        planes are None unless ``planes``, and ``active`` is None."""
        if not self.cuda:
            depth, steps, outcome, active, far = self._twin(budget=budget)
            rgb = self._fused_shade(depth, outcome, far)
        else:
            cone = self.rays[2]
            rgb = torch.empty((*cone.shape, 3), dtype=torch.float32, device=cone.device)
            depth = steps = outcome = active = None
            if planes or budget is not None:
                depth, steps, outcome, active = self._empty_planes()
            _render_cuda(self.desc_c, *self.rays, rgb,
                         None if depth is None else (depth, steps, outcome),
                         mode=FRESH if budget is None else PHASE_A,
                         active=None if budget is None else active, cull=self.cull,
                         omega=self.omega, cap=self.cap(budget))
        return rgb, depth, steps, outcome, None if budget is None else active

    def resume(self, rgb, planes, blocks) -> None:
        """K1 RESUME, in place: the active rays of the listed blocks march
        on from ``planes`` (depth, steps, outcome, active) to the step limit
        and are shaded into ``rgb``."""
        if self.cuda:
            _render_cuda(self.desc_c, *self.rays, rgb, planes[:3], mode=RESUME,
                         active=planes[3], blocks=blocks, cull=self.cull, omega=self.omega,
                         cap=self.cap(None))
            return
        resumed = planes[3] * block_rays(blocks, *self.rays[2].shape)
        *new, far = self._twin((*planes[:3], resumed))
        for old, value in zip(planes, new):
            old.copy_(value)
        shaded = self._fused_shade(new[0], new[2], far)
        rgb.copy_(torch.where(resumed[..., None] != 0, shaded, rgb))

    def trace(self, budget: int | None = None):
        """K2 from a fresh state: ``(depth, steps, outcome, active)``;
        ``active`` is None without ``budget``."""
        if not self.cuda:
            depth, steps, outcome, active, _ = self._twin(budget=budget)
        else:
            depth, steps, outcome, active = self._empty_planes()
            _trace_cuda(self.desc_c, *self.rays, None, (depth, steps, outcome),
                        active=None if budget is None else active, cull=self.cull,
                        omega=self.omega, cap=self.cap(budget))
        return depth, steps, outcome, None if budget is None else active

    def resume_trace(self, planes, rays) -> None:
        """K2 over the compacted tail, in place: the listed rays march on
        from ``planes`` (depth, steps, outcome, active) to the step limit."""
        if self.cuda:
            _trace_cuda(self.desc_c, *self.rays, planes, planes[:3], rays=rays, cull=self.cull,
                        omega=self.omega, cap=self.cap(None))
            return
        n = planes[3].numel()
        carried = (*planes[:3], listed_flags(*rays, n).reshape(planes[3].shape))
        for old, value in zip(planes[:3], self._twin(carried, groups=listed_groups(*rays, n))[:3]):
            old.copy_(value)

    def shade(self, depth, outcome) -> torch.Tensor:
        """K3: linear RGB ``(H, W, 3)``."""
        origins, directions, cone = self.rays
        if not self.cuda:
            return shade_planes_torch(self.desc, origins, directions, depth, outcome, self.config)
        rgb = torch.empty((*cone.shape, 3), dtype=torch.float32, device=cone.device)
        _shade_cuda(self.desc_c, origins, directions, depth, outcome, rgb)
        return rgb

    def trace_pipeline(self, two_phase: bool, phase_a_steps: int):
        """``_trace_pipeline``: K2 alone, or the row two-phase pipeline (K2
        with ``phase_a_steps``, then K2 over the compacted tail of
        unresolved rays, in place). Returns ``(depth, steps, outcome)``."""
        if not two_phase:
            return self.trace()[:3]
        planes = self.trace(phase_a_steps)
        self.resume_trace(planes, tail_list(planes[3], self.split))
        return planes[:3]


def _check_inputs(origins, directions, cone) -> None:
    for name, t, ndim in (("origins", origins, 3), ("directions", directions, 3), ("cone", cone, 2)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{name} must have {ndim} dimensions, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != cone.device:
            raise ValueError(f"{name} is on {t.device}, cone on {cone.device}")
    h, w = cone.shape
    if h == 0 or w == 0:
        raise ValueError(f"empty image: cone has shape {(h, w)}")
    for name, t in (("origins", origins), ("directions", directions)):
        if tuple(t.shape) != (h, w, 3):
            raise ValueError(f"{name} must have shape {(h, w, 3)}, got {tuple(t.shape)}")


def _check_planes(depth, outcome, cone_shape, device) -> None:
    for name, t, dtype in (("depth", depth, torch.float32), ("outcome", outcome, torch.int32)):
        if not isinstance(t, torch.Tensor) or t.dtype != dtype:
            raise TypeError(f"{name} must be a {dtype} tensor")
        if tuple(t.shape) != tuple(cone_shape) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {tuple(cone_shape)} tensor")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the rays on {device}")


def trace_cuda(
    scene_desc: SceneDescriptor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    cone: torch.Tensor,
    config: MarchConfig = MarchConfig(),
    *,
    two_phase: bool = False,
    phase_a_steps: int = 32,
    use_bb_skip: bool = True,
    omega: float | None = None,
    split=None,
):
    """Trace an ``(H, W)`` ray image of ``scene_desc``; the counterpart of
    ``trace_pallas``. Returns ``(depth, steps, outcome)`` planes.

    One K2 launch, or with ``two_phase`` the row two-phase pipeline: K2
    capped at ``phase_a_steps``, then K2 over the device-resident list of
    the rays still unresolved (:func:`tail_list`), in place. There is no
    tail capacity, so no overflow pass (the JAX package's ``tail_cap`` and
    phase C). Without ``use_bb_skip`` the march is not culled and stops at
    the depth limit.
    ``omega=None`` honours ``config.relaxation``; ``split`` is the near/far
    split (module docstring). CUDA tensors go through K2, CPU tensors
    through :func:`trace_planes_torch`."""
    omega = config.relaxation if omega is None else float(omega)
    _check_inputs(origins, directions, cone)
    frame = _Frame(scene_desc, origins, directions, cone, config, use_bb_skip, omega, split)
    return frame.trace_pipeline(bool(two_phase), phase_a_steps)


def sphere_trace_cuda(
    scene_desc: SceneDescriptor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    cone: torch.Tensor,
    config: MarchConfig = MarchConfig(),
) -> RayMarchHit:
    """The uncull'd sphere trace of an ``(H, W)`` ray image as
    :class:`~bsdmg_tpu_torch.ops.trace.RayMarchHit`, the counterpart of
    ``sphere_trace_pallas``: one K2 launch without the slab cull, the
    position ``origins + depth * directions``."""
    depth, steps, outcome = trace_cuda(scene_desc, origins, directions, cone, config,
                                       use_bb_skip=False)
    position = origins + depth[..., None] * directions
    return RayMarchHit(steps=steps, position=position, depth=depth, outcome=outcome)


def shade_cuda(
    scene_desc: SceneDescriptor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    depth: torch.Tensor,
    outcome: torch.Tensor,
    config: MarchConfig = MarchConfig(),
) -> torch.Tensor:
    """Shade traced planes (float32 ``depth``, int32 ``outcome``, ``(H,
    W)``) into linear RGB ``(H, W, 3)``; the counterpart of ``_shade_call``,
    whose ``(r, g, b)`` planes are this image's channels. CUDA tensors go
    through K3, CPU tensors through :func:`shade_planes_torch`."""
    _check_inputs(origins, directions, depth)
    _check_planes(depth, outcome, depth.shape, depth.device)
    frame = _Frame(scene_desc, origins, directions, depth, config, True, 1.0)
    return frame.shade(depth, outcome)


def render_image_cuda(
    scene_desc: SceneDescriptor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    cone: torch.Tensor,
    config: MarchConfig = MarchConfig(),
    *,
    return_planes: bool = False,
    use_bb_skip: bool = True,
    two_phase: bool | str = False,
    phase_a_steps: int = 32,
    omega: float | None = None,
    swizzle: bool = True,
    split=None,
):
    """Trace and shade an ``(H, W)`` ray image of ``scene_desc``; the
    counterpart of ``render_image_pallas``.

    ``origins`` and ``directions`` are contiguous float32 ``(H, W, 3)``,
    ``cone`` float32 ``(H, W)``, all on one device. CUDA tensors go through
    the kernels, CPU tensors through their plain twins. The paths:

    * the default: one launch of K1;
    * ``two_phase="block"``, block retirement: K1 capped at
      ``phase_a_steps``, then K1 over the device-resident list of its 16x8
      blocks that still hold an unresolved ray, in place (no block cap, no
      phase C);
    * ``two_phase=True``, the row two-phase pipeline of :func:`trace_cuda`
      (its tail listed in 8x4-patch order with the split,
      :func:`tail_list`), then K3;
    * ``swizzle=False``: K2, then K3. On the TPU the flag picks the
      unswizzled pipeline; here the pixel layout is the kernels' own 8x4
      warp patch either way, and the flag selects the unfused pipeline.

    Each equals the default image, but relaxed (``omega > 1``; ``None``
    honours ``config.relaxation``) two-phase paths, whose relaxed state
    restarts with each launch, as in the JAX package. Without
    ``use_bb_skip`` nothing is culled. ``split``, the near/far split
    (module docstring), runs in every path: a warp's patch marches the far
    scene where its rays all miss the near box; K1 (the default and block
    retirement) shades those hits with the far scene, as JAX's fused
    epilogue does, K3 (the row and unfused pipelines) every hit with the
    full scene, as ``_shade_kernel`` does. Returns linear RGB
    ``(H, W, 3)``, or ``(rgb, depth, steps, outcome)`` with
    ``return_planes=True``."""
    omega = config.relaxation if omega is None else float(omega)
    if two_phase not in (False, True, "block"):
        raise ValueError(f"two_phase must be False, True or 'block', got {two_phase!r}")
    if two_phase == "block" and not swizzle:
        raise ValueError("two_phase='block' requires the swizzled layout")
    _check_inputs(origins, directions, cone)
    frame = _Frame(scene_desc, origins, directions, cone, config, use_bb_skip, omega, split)
    if two_phase is True or not swizzle:
        depth, steps, outcome = frame.trace_pipeline(two_phase, phase_a_steps)
        rgb = frame.shade(depth, outcome)
    elif two_phase == "block":
        rgb, *planes = frame.render(phase_a_steps)
        frame.resume(rgb, planes, compact_list(block_flags(planes[3])))
        depth, steps, outcome = planes[:3]
    else:
        rgb, depth, steps, outcome, _ = frame.render(planes=return_planes)
    return (rgb, depth, steps, outcome) if return_planes else rgb
