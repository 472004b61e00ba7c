"""Fused trace + shade: the wrapper of CUDA kernel K1 and its plain twin.

Counterpart of ``bsdmg_tpu/ops/pallas/render_kernel.py``'s default path,
``render_image_pallas`` -> ``_render_fused_call`` -> one ``pallas_call`` of
``_trace_kernel(shade=True)``. Per ray, in order:

1. slab cull (``_slab_cull``): a ray that cannot reach the scene box,
   inflated by ``cone * T* + eps + slack``, is retired at once with depth
   ``1.01 * depth_limit`` and outcome DEPTH_LIMIT; every other ray gets the
   box's exit depth as its stop depth. There is no fast-forward to the
   entry depth: the march starts at 0, as the reference's does;
2. the exact sphere-trace march (``_march`` with ``omega = 1``);
3. fd4 normals (``_fd_normal``), the Lambert two-colour mix
   (``shade_planes``) and ACES (``_aces_plane``).

:func:`render_image_cuda` sends a CUDA tensor to the kernel
(``csrc/render_kernel.cu``) and a CPU tensor to
:func:`render_image_planes_torch`, its plain PyTorch twin; nothing falls
back from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from bsdmg_tpu_torch.config import MarchConfig
from bsdmg_tpu_torch.ops.cuda.build import load_library
from bsdmg_tpu_torch.ops.cuda.csdf import (
    MAX_GROUP_VALUES,
    MAX_GROUPS,
    CapsuleGroup,
    CapsuleSet,
    SceneDescriptor,
    descriptor_csdf,
    f32,
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
from bsdmg_tpu_torch.ops.trace import COLLISION, DEPTH_LIMIT, STEP_LIMIT

#: launches of the CUDA kernel in this process; the wrapper adds one per launch
LAUNCHES = 0

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


def _march(csdf, config: MarchConfig, ox, oy, oz, dx, dy, dz, cone, active, depth, limit,
           track_min: bool = False, *, steps0=None, outcome0=None, budget: int | None = None):
    """Exact sphere trace of the ``active`` rays of flat ray planes
    (render_kernel.py::_march, ``omega = 1``). Updates ``depth`` in place and
    returns ``(steps, outcome, min_m, t_min, unresolved)``; with
    ``track_min`` ``min_m`` and ``t_min`` are the closest-approach record,
    the minimum of ``f - cone*t`` over the sampled points and its depth (1e9
    and 0 for a ray never sampled), else None.

    Resumable as the JAX function: ``steps0`` carries prior steps (default
    0), each active ray stops when its steps reach ``min(budget,
    step_limit)`` but always takes its first iteration, rays that are not
    active keep their ``outcome0`` (default DEPTH_LIMIT), and
    ``unresolved`` marks the rays that stopped at the budget short of the
    step limit.

    The rays still marching are gathered each step, so the cost follows the
    live rays; every per-ray operation is the kernel's."""
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
        hit = dist <= cd + eps
        outcome[live[hit]] = COLLISION
        advance = ~hit
        t = t + dist - cd
        over = advance & (t > limit[live])
        depth[live[advance]] = t[advance]
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


def render_image_planes_torch(
    scene_desc: SceneDescriptor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    cone: torch.Tensor,
    config: MarchConfig = MarchConfig(),
):
    """Plain PyTorch version of kernel K1 on any device.

    Returns ``(rgb, depth, steps, outcome)``: linear RGB ``(H, W, 3)``
    float32, depth ``(H, W)`` float32, steps and outcome ``(H, W)`` int32."""
    h, w = cone.shape
    csdf = descriptor_csdf(scene_desc)
    ox, oy, oz = (origins[..., a].reshape(-1) for a in range(3))
    dx, dy, dz = (directions[..., a].reshape(-1) for a in range(3))
    c = cone.reshape(-1)

    miss, t_exit = _slab_cull(scene_desc.bounds, ox, oy, oz, dx, dy, dz, c, config)
    depth = torch.zeros_like(c)
    depth[miss] = config.depth_limit * 1.01
    limit = torch.clamp_max(t_exit, config.depth_limit)
    steps, outcome, *_ = _march(csdf, config, ox, oy, oz, dx, dy, dz, c, ~miss, depth, limit)

    n = [torch.zeros_like(c) for _ in range(3)]
    hit = (outcome == COLLISION).nonzero().squeeze(1)
    if hit.numel():
        t = depth[hit]
        normal = _fd_normal(
            csdf, ox[hit] + t * dx[hit], oy[hit] + t * dy[hit], oz[hit] + t * dz[hit],
            config.normal_epsilon,
        )
        for plane, value in zip(n, normal):
            plane[hit] = value
    r, g, b = shade_planes(*n, outcome)
    rgb = torch.stack([r, g, b], dim=-1).reshape(h, w, 3)
    return rgb, depth.reshape(h, w), steps.reshape(h, w), outcome.reshape(h, w)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


def _floats(n):
    return ctypes.c_float * n


class _CapsuleGroupC(ctypes.Structure):
    """``CapsuleGroup`` of csrc/scene_sdf.cuh."""

    _fields_ = [
        ("axis", ctypes.c_int),
        ("a0", ctypes.c_float),
        ("length", ctypes.c_float),
        ("n1", ctypes.c_int),
        ("n2", ctypes.c_int),
        ("v1", _floats(MAX_GROUP_VALUES)),
        ("v2", _floats(MAX_GROUP_VALUES)),
    ]


class _CapsuleSetC(ctypes.Structure):
    """``CapsuleSet`` of csrc/scene_sdf.cuh."""

    _fields_ = [
        ("radius", ctypes.c_float),
        ("n_groups", ctypes.c_int),
        ("groups", _CapsuleGroupC * MAX_GROUPS),
    ]


class _SceneDescC(ctypes.Structure):
    """``SceneDesc`` of csrc/scene_sdf.cuh: the scene, the march limits and
    the shading constants, all as the float32 values the plain twin computes
    with. The mesh kernels (K6, K7) take the same structure."""

    _fields_ = [
        ("object", _CapsuleSetC),
        ("frame", _CapsuleSetC),
        ("has_frame", ctypes.c_int),
        ("has_transform", ctypes.c_int),
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
    ]


def _f32s(values):
    return [f32(v) for v in values]


def _padded(values, n):
    return _floats(n)(*values, *([0.0] * (n - len(values))))


def _capsule_group_c(g: CapsuleGroup) -> _CapsuleGroupC:
    return _CapsuleGroupC(
        g.axis, g.a0, g.length, len(g.v1), len(g.v2),
        _padded(g.v1, MAX_GROUP_VALUES), _padded(g.v2, MAX_GROUP_VALUES),
    )


def _capsule_set_c(cs: CapsuleSet) -> _CapsuleSetC:
    return _CapsuleSetC(
        cs.radius,
        len(cs.groups),
        (_CapsuleGroupC * MAX_GROUPS)(*map(_capsule_group_c, cs.groups)),
    )


def bounds_c(bb) -> dict:
    """The slab cull's fields of ``SceneDesc`` and ``ParamScene`` for the
    bounds ``bb``, as float32 values."""
    lo, hi, slack = _bounds_parts(bb)
    center, radius = _cull_sphere(bb)
    return dict(
        lo=_floats(3)(*_f32s(lo)),
        hi=_floats(3)(*_f32s(hi)),
        cull_center=_floats(3)(*_f32s(center)),
        cull_radius=f32(radius),
        slack=f32(slack),
    )


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


def scene_desc_c(desc: SceneDescriptor, config: MarchConfig = MarchConfig()) -> _SceneDescC:
    """The descriptor as the kernels take it (``SceneDesc``)."""
    has_transform = desc.translation is not None
    rotation = [v for row in desc.inv_rotation for v in row] if has_transform else [0.0] * 9
    return _SceneDescC(
        object=_capsule_set_c(desc.object),
        frame=_capsule_set_c(desc.frame if desc.frame is not None else desc.object),
        has_frame=int(desc.frame is not None),
        has_transform=int(has_transform),
        sphere_radius=desc.sphere_radius,
        smooth_k=desc.smooth_k,
        inv_k=desc.inv_k,
        k_6=desc.k_6,
        inv_rotation=_floats(9)(*rotation),
        translation=_floats(3)(*(desc.translation if has_transform else (0.0,) * 3)),
        normal_epsilon=f32(config.normal_epsilon),
        **bounds_c(desc.bounds),
        **march_c(config),
        **shading_c(),
    )


def library() -> ctypes.CDLL:
    """The kernel library with K1's entry points typed and the descriptor
    layout checked against the source's."""
    lib = load_library()
    lib.bsdmg_render.restype = ctypes.c_int
    lib.bsdmg_render.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.bsdmg_scene_desc_size.restype = ctypes.c_int
    lib.bsdmg_scene_desc_size.argtypes = []
    lib.bsdmg_error_string.restype = ctypes.c_char_p
    lib.bsdmg_error_string.argtypes = [ctypes.c_int]
    size = lib.bsdmg_scene_desc_size()
    if size != ctypes.sizeof(_SceneDescC):
        raise RuntimeError(
            f"SceneDesc layout mismatch: {size} bytes in {SOURCE}, "
            f"{ctypes.sizeof(_SceneDescC)} in {__name__}"
        )
    return lib


def _render_cuda(desc, origins, directions, cone, config, return_planes):
    global LAUNCHES
    lib = library()
    h, w = cone.shape
    device = cone.device
    rgb = torch.empty((h, w, 3), dtype=torch.float32, device=device)
    depth = steps = outcome = None
    if return_planes:
        depth = torch.empty((h, w), dtype=torch.float32, device=device)
        steps = torch.empty((h, w), dtype=torch.int32, device=device)
        outcome = torch.empty((h, w), dtype=torch.int32, device=device)
    desc_c = scene_desc_c(desc, config)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.bsdmg_render(
            ctypes.addressof(desc_c),
            origins.data_ptr(), directions.data_ptr(), cone.data_ptr(),
            rgb.data_ptr(),
            0 if depth is None else depth.data_ptr(),
            0 if steps is None else steps.data_ptr(),
            0 if outcome is None else outcome.data_ptr(),
            h, w, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"render kernel launch failed: cudaError {err} "
            f"({lib.bsdmg_error_string(err).decode()})"
        )
    LAUNCHES += 1
    return rgb, depth, steps, outcome


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


def render_image_cuda(
    scene_desc: SceneDescriptor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    cone: torch.Tensor,
    config: MarchConfig = MarchConfig(),
    *,
    return_planes: bool = False,
):
    """Trace and shade an ``(H, W)`` ray image of ``scene_desc``.

    ``origins`` and ``directions`` are contiguous float32 ``(H, W, 3)``,
    ``cone`` float32 ``(H, W)``, all on one device. CUDA tensors go through
    kernel K1, CPU tensors through :func:`render_image_planes_torch`. Returns
    linear RGB ``(H, W, 3)``, or ``(rgb, depth, steps, outcome)`` with
    ``return_planes=True``."""
    if config.relaxation != 1.0:
        raise NotImplementedError(
            "the render kernel steps exactly (relaxation 1.0); over-relaxed "
            f"marching (relaxation={config.relaxation}) is not ported yet"
        )
    _check_inputs(origins, directions, cone)
    if cone.device.type == "cuda":
        out = _render_cuda(scene_desc, origins, directions, cone, config, return_planes)
    elif cone.device.type == "cpu":
        out = render_image_planes_torch(scene_desc, origins, directions, cone, config)
    else:
        raise ValueError(f"unsupported device {cone.device}")
    return out if return_planes else out[0]
