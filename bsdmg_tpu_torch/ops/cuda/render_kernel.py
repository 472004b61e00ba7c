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
"""

from __future__ import annotations

import ctypes
import functools

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
from bsdmg_tpu_torch.ops.trace import COLLISION, DEPTH_LIMIT, STEP_LIMIT, RayMarchHit

#: launches of K1, K2 and K3 in this process; each launch adds one to its own
LAUNCHES = 0
TRACE_LAUNCHES = 0
SHADE_LAUNCHES = 0

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


def trace_planes_torch(
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
):
    """Plain PyTorch version of kernel K2, the resumable trace
    (render_kernel.py::_trace_kernel with ``shade=False``), on any device.

    The carried state ``(depth0, steps0, outcome0, active0)`` defaults to a
    fresh march: depth 0, steps 0, DEPTH_LIMIT and every ray active. With
    ``use_bb_skip`` the active rays that cannot reach the scene's bounds keep
    their ``outcome0`` and get depth ``1.01 * depth_limit`` (:355-368), the
    others stop at the box's exit depth; without it at the depth limit.
    Rays that are not active keep their state. Returns ``(depth, steps,
    outcome, active)`` ``(H, W)`` planes; ``active`` (int32) marks the rays
    that stopped at ``budget`` short of the step limit (:281-283)."""
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
    if use_bb_skip:
        miss, t_exit = _slab_cull(scene_desc.bounds, ox, oy, oz, dx, dy, dz, c, config)
        depth[active & miss] = config.depth_limit * 1.01
        active = active & ~miss
        limit = torch.clamp_max(t_exit, config.depth_limit)
    steps, outcome, _, _, unresolved = _march(
        descriptor_csdf(scene_desc), config, ox, oy, oz, dx, dy, dz, c, active, depth, limit,
        steps0=steps0, outcome0=outcome0, budget=budget, omega=omega,
    )
    return (depth.reshape(h, w), steps.reshape(h, w), outcome.reshape(h, w),
            unresolved.to(torch.int32).reshape(h, w))


def shade_planes_torch(
    scene_desc: SceneDescriptor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    depth: torch.Tensor,
    outcome: torch.Tensor,
    config: MarchConfig = MarchConfig(),
) -> torch.Tensor:
    """Plain PyTorch version of kernel K3 (render_kernel.py::_shade_kernel),
    on any device: fd4 normals at the hits, the Lambert two-colour mix, white
    where the march hit the step limit, black elsewhere, then ACES. Returns
    linear RGB ``(H, W, 3)``."""
    h, w = depth.shape
    csdf = descriptor_csdf(scene_desc)
    ox, oy, oz, dx, dy, dz, _ = _flat_rays(origins, directions, depth)
    t_all, oc = depth.reshape(-1), outcome.reshape(-1)
    n = [torch.zeros_like(t_all) for _ in range(3)]
    hit = (oc == COLLISION).nonzero().squeeze(1)
    if hit.numel():
        t = t_all[hit]
        normal = _fd_normal(
            csdf, ox[hit] + t * dx[hit], oy[hit] + t * dy[hit], oz[hit] + t * dz[hit],
            config.normal_epsilon,
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
):
    """Plain PyTorch version of kernel K1's render on any device: K2's twin
    from a fresh state, then K3's, which are K1's march (``omega > 1``
    relaxed) and epilogue.

    Returns ``(rgb, depth, steps, outcome)``: linear RGB ``(H, W, 3)``
    float32, depth ``(H, W)`` float32, steps and outcome ``(H, W)`` int32."""
    depth, steps, outcome, _ = trace_planes_torch(scene_desc, origins, directions, cone,
                                                  config=config, omega=omega)
    rgb = shade_planes_torch(scene_desc, origins, directions, depth, outcome, config)
    return rgb, depth, steps, outcome


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
    with torch.cuda.device(cone.device):
        err = lib.bsdmg_render(
            ctypes.addressof(desc_c), origins.data_ptr(), directions.data_ptr(), cone.data_ptr(),
            rgb.data_ptr(), _ptr(depth), _ptr(steps), _ptr(outcome), _ptr(active),
            _ptr(block_list), _ptr(count), mode, int(cull), int(omega > 1.0), cap, omega, h, w,
            _stream(cone),
        )
    _raise_on(err, lib, "render (K1)")
    LAUNCHES += 1


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
    with torch.cuda.device(cone.device):
        err = lib.bsdmg_trace(
            ctypes.addressof(desc_c), origins.data_ptr(), directions.data_ptr(), cone.data_ptr(),
            *(map(_ptr, carried) if carried is not None else (None,) * 4),
            *(t.data_ptr() for t in out), _ptr(active), _ptr(ray_list), _ptr(count), int(cull),
            int(omega > 1.0), cap, omega, h, w, _stream(cone),
        )
    _raise_on(err, lib, "trace (K2)")
    TRACE_LAUNCHES += 1


def _shade_cuda(desc_c, origins, directions, depth, outcome, rgb) -> None:
    """One launch of K3 from a prepared ``SceneDesc`` into ``rgb``."""
    global SHADE_LAUNCHES
    lib = library()
    h, w = depth.shape
    with torch.cuda.device(depth.device):
        err = lib.bsdmg_shade(
            ctypes.addressof(desc_c), origins.data_ptr(), directions.data_ptr(), depth.data_ptr(),
            outcome.data_ptr(), rgb.data_ptr(), h, w, _stream(depth),
        )
    _raise_on(err, lib, "shade (K3)")
    SHADE_LAUNCHES += 1


def compact_list(flags: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(list, count)``: the indices of the nonzero entries of the flat
    int32 ``flags``, in order, and their number, both left on the device
    (no host sync): a cumsum of the flags, then a scatter. Entries of the
    list past the count are unspecified. The JAX package's fixed-capacity
    ``_gather_active``/``_scatter_back`` (render_kernel.py:592-634) move
    eleven planes only because Mosaic needs dense tiles; the kernels read
    this list instead."""
    n = flags.numel()
    position = torch.cumsum(flags, 0, dtype=torch.int32)
    slot = torch.where(flags != 0, position - 1, n).long()
    index = torch.empty(n + 1, dtype=torch.int32, device=flags.device)
    index.scatter_(0, slot, torch.arange(n, dtype=torch.int32, device=flags.device))
    return index, position[-1:]


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

    def __init__(self, desc, origins, directions, cone, config, use_bb_skip, omega):
        if cone.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {cone.device}")
        self.desc, self.config = desc, config
        self.rays = (origins, directions, cone)
        self.cull, self.omega = bool(use_bb_skip), float(omega)
        self.cuda = cone.device.type == "cuda"
        self.desc_c = scene_desc_c(desc, config) if self.cuda else None

    def cap(self, budget: int | None) -> int:
        limit = self.config.step_limit
        return limit if budget is None else min(int(budget), limit)

    def _empty_planes(self):
        cone = self.rays[2]
        return (torch.empty_like(cone), *(torch.empty_like(cone, dtype=torch.int32)
                                          for _ in range(3)))

    def _twin(self, carried=None, budget=None):
        return trace_planes_torch(self.desc, *self.rays, *(carried or ()), config=self.config,
                                  budget=budget, use_bb_skip=self.cull, omega=self.omega)

    def render(self, budget: int | None = None, planes: bool = False):
        """K1 from a fresh state: ``(rgb, depth, steps, outcome, active)``.
        With ``budget`` (PHASE_A) every plane is written; else (FRESH) the
        planes are None unless ``planes``, and ``active`` is None."""
        if not self.cuda:
            depth, steps, outcome, active = self._twin(budget=budget)
            rgb = shade_planes_torch(self.desc, *self.rays[:2], depth, outcome, self.config)
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
        carried = (*planes[:3], planes[3] * block_rays(blocks, *self.rays[2].shape))
        new = self._twin(carried)
        for old, value in zip(planes, new):
            old.copy_(value)
        rgb.copy_(shade_planes_torch(self.desc, *self.rays[:2], new[0], new[2], self.config))

    def trace(self, budget: int | None = None):
        """K2 from a fresh state: ``(depth, steps, outcome, active)``;
        ``active`` is None without ``budget``."""
        if not self.cuda:
            depth, steps, outcome, active = self._twin(budget=budget)
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
        carried = (*planes[:3], listed_flags(*rays, planes[3].numel()).reshape(planes[3].shape))
        for old, value in zip(planes[:3], self._twin(carried)):
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
        self.resume_trace(planes, compact_list(planes[3].reshape(-1)))
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
):
    """Trace an ``(H, W)`` ray image of ``scene_desc``; the counterpart of
    ``trace_pallas``. Returns ``(depth, steps, outcome)`` planes.

    One K2 launch, or with ``two_phase`` the row two-phase pipeline: K2
    capped at ``phase_a_steps``, then K2 over the device-resident list of
    the rays still unresolved, in place. There is no tail capacity, so no
    overflow pass (the JAX package's ``tail_cap`` and phase C). Without
    ``use_bb_skip`` the march is not culled and stops at the depth limit.
    ``omega=None`` honours ``config.relaxation``. CUDA tensors go through
    K2, CPU tensors through :func:`trace_planes_torch`."""
    omega = config.relaxation if omega is None else float(omega)
    _check_inputs(origins, directions, cone)
    frame = _Frame(scene_desc, origins, directions, cone, config, use_bb_skip, omega)
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
    * ``two_phase=True``, the row two-phase pipeline of :func:`trace_cuda`,
      then K3;
    * ``swizzle=False``: K2, then K3. On the TPU the flag picks the
      unswizzled pipeline; here the pixel layout is the kernels' own 8x4
      warp patch either way, and the flag selects the unfused pipeline.

    Each equals the default image, but relaxed (``omega > 1``; ``None``
    honours ``config.relaxation``) two-phase paths, whose relaxed state
    restarts with each launch, as in the JAX package. Without
    ``use_bb_skip`` nothing is culled. Returns linear RGB ``(H, W, 3)``,
    or ``(rgb, depth, steps, outcome)`` with ``return_planes=True``."""
    omega = config.relaxation if omega is None else float(omega)
    if two_phase not in (False, True, "block"):
        raise ValueError(f"two_phase must be False, True or 'block', got {two_phase!r}")
    if two_phase == "block" and not swizzle:
        raise ValueError("two_phase='block' requires the swizzled layout")
    _check_inputs(origins, directions, cone)
    frame = _Frame(scene_desc, origins, directions, cone, config, use_bb_skip, omega)
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
