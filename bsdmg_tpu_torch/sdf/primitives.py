"""Analytic SDF primitives and CSG combinators on ``(..., 3)`` point tensors.

Port of ``bsdmg_tpu/sdf/primitives.py`` (reference:
cuda/includes/signed_distance.cu), in the point form and in the component
form on coordinate planes, each in the JAX package's operation order: the
reference object's box skeleton, sphere and smooth minimum, the box, domain
wrap and mandelbulb of the other scenes, the torus and capped cylinder of
the composed scenes (``models/compose.py``), and the reference library's
helpers that no scene calls (the unit primitives, the simple and bounding
boxes, the infinite line, the smooth maximum, the AABB tests).

Where a function is differentiated, its ``min``, ``max`` and ``abs`` follow
JAX's derivative rules: at a tie each operand of ``minimum``/``maximum``
gets half the gradient (``torch.maximum`` does so; ``torch.clamp`` passes it
all), and ``abs`` has derivative +1 at 0 (``torch.abs`` has 0).
"""

from __future__ import annotations

import numpy as np
import torch

_SAFE_EPS = 1e-12

MAX_POSITIVE_F32 = 3.40282347e38
#: the same as the float32 it rounds to (torch refuses a Python float above
#: float32's largest)
_MAX_F32 = float(np.float32(MAX_POSITIVE_F32))


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, floored at sqrt(1e-12)."""
    return torch.sqrt(torch.clamp_min((v * v).sum(dim=-1), _SAFE_EPS))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=-1)


def maximum(a, b) -> torch.Tensor:
    """``jnp.maximum``: elementwise max of tensors or Python numbers, each
    operand getting half the gradient at a tie."""
    a, b = _tensors(a, b)
    return torch.maximum(a, b)


def minimum(a, b) -> torch.Tensor:
    """``jnp.minimum``, with :func:`maximum`'s tie rule."""
    a, b = _tensors(a, b)
    return torch.minimum(a, b)


def abs_(x: torch.Tensor) -> torch.Tensor:
    """``jnp.abs``, with derivative +1 at 0 as JAX has it."""
    return torch.where(x >= 0, x, -x)


def _tensors(a, b):
    like = a if isinstance(a, torch.Tensor) else b
    return (
        torch.as_tensor(a, dtype=like.dtype, device=like.device),
        torch.as_tensor(b, dtype=like.dtype, device=like.device),
    )


class _Mod(torch.autograd.Function):
    """``jnp.mod``: the value is ``torch.remainder``'s (the truncated
    remainder, plus the divisor where its sign differs); the derivative
    with respect to the divisor is JAX's, ``-sign(x/y) * floor(|x/y|)`` of
    the rounded quotient (lax.rem's rule), plus 1 where the divisor was
    added. ``torch.remainder``'s own, ``-floor(x/y)`` of the exact
    quotient, differs where the quotient rounds onto an integer."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return torch.remainder(x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = (v.detach() for v in ctx.saved_tensors)
        q = x / y
        rem = torch.fmod(x, y)
        plus = ((rem < 0) != (y < 0)) & (rem != 0)
        gy = -g * (torch.sign(q) * torch.floor(torch.abs(q))) + torch.where(plus, g, 0.0)
        gx = g
        if gx.shape != x.shape:
            gx = gx.sum_to_size(x.shape)
        if gy.shape != y.shape:
            gy = gy.sum_to_size(y.shape)
        return gx, gy


def mod(x, y) -> torch.Tensor:
    """``jnp.mod(x, y)`` (:class:`_Mod`) of tensors or Python numbers."""
    x, y = _tensors(x, y)
    return _Mod.apply(x, y)


def wrap(p: torch.Tensor, lower, higher) -> torch.Tensor:
    """Domain repetition: each coordinate wrapped into ``[lower, higher)``
    (signed_distance.cu:9-18), by :func:`mod`."""
    lower = torch.as_tensor(lower, dtype=p.dtype, device=p.device)
    higher = torch.as_tensor(higher, dtype=p.dtype, device=p.device)
    return lower + mod(p - lower, higher - lower)


def smooth_min(a: torch.Tensor, b: torch.Tensor, k) -> torch.Tensor:
    """Cubic smooth minimum with width ``k`` (signed_distance.cu:20-23):
    ``h = max(k - |a-b|, 0)/k;  min(a,b) - h^3 * k / 6``."""
    h = maximum(k - abs_(a - b), 0.0) / k
    return minimum(a, b) - h * h * h * k * (1.0 / 6.0)


def smooth_max(a: torch.Tensor, b: torch.Tensor, k) -> torch.Tensor:
    """Smooth maximum (dual of :func:`smooth_min`)."""
    return -smooth_min(-a, -b, k)


def sd_unit_sphere(p: torch.Tensor) -> torch.Tensor:
    """Sphere of *diameter* 1 at the origin (signed_distance.cu:82-84)."""
    return _norm(p) - 0.5


def sd_sphere(p: torch.Tensor, center=0.0, radius=1.0) -> torch.Tensor:
    center = torch.as_tensor(center, dtype=p.dtype, device=p.device)
    return _norm(p - center) - radius


def sd_ray(p: torch.Tensor, origin, direction) -> torch.Tensor:
    """Distance to the infinite line through ``origin`` with unit
    ``direction`` (signed_distance.cu:61-63, named ``sd_ray`` there)."""
    origin = torch.as_tensor(origin, dtype=p.dtype, device=p.device)
    direction = torch.as_tensor(direction, dtype=p.dtype, device=p.device)
    t = _dot(p - origin, direction)
    closest = origin + t[..., None] * direction
    return _norm(closest - p)


def sd_ray_segment(p: torch.Tensor, origin, direction, length) -> torch.Tensor:
    """Distance to a ray segment of given ``length`` (signed_distance.cu:65-75)."""
    t = torch.minimum(torch.clamp_min(_dot(p - origin, direction), 0.0), length)
    closest = origin + t[..., None] * direction
    return _norm(closest - p)


def sd_line(p: torch.Tensor, b0, b1) -> torch.Tensor:
    """Distance to the segment [b0, b1] (signed_distance.cu:77-80)."""
    b0 = torch.as_tensor(b0, dtype=p.dtype, device=p.device)
    b1 = torch.as_tensor(b1, dtype=p.dtype, device=p.device)
    seg = b1 - b0
    length = _norm(seg)
    direction = seg / torch.clamp_min(length, _SAFE_EPS)[..., None]
    return sd_ray_segment(p, b0, direction, length)


def sd_box(p: torch.Tensor, center=0.0, size=1.0) -> torch.Tensor:
    """Exact box SDF; ``size`` is the full extent (signed_distance.cu:86-91)."""
    center = torch.as_tensor(center, dtype=p.dtype, device=p.device)
    size = torch.as_tensor(size, dtype=p.dtype, device=p.device)
    q = abs_(p - center) - size / 2.0
    outside = _norm(maximum(q, 0.0))
    inside = minimum(q, 0.0).amax(dim=-1)
    return outside + inside


def sd_unit_cube(p: torch.Tensor) -> torch.Tensor:
    return sd_box(p, 0.0, 1.0)


def sd_simple_box(p: torch.Tensor, center, size) -> torch.Tensor:
    """Interior-only (non-exact outside) box distance (signed_distance.cu:115-118)."""
    center = torch.as_tensor(center, dtype=p.dtype, device=p.device)
    size = torch.as_tensor(size, dtype=p.dtype, device=p.device)
    q = abs_(p - center) - size / 2.0
    return minimum(q, 0.0).amax(dim=-1)


def sd_bounding_box(p: torch.Tensor, bb_min, bb_max) -> torch.Tensor:
    """Signed distance to an axis-aligned bounding volume as the largest of
    the six half-space distances (signed_distance.cu:120-131)."""
    bb_min = torch.as_tensor(bb_min, dtype=p.dtype, device=p.device)
    bb_max = torch.as_tensor(bb_max, dtype=p.dtype, device=p.device)
    return maximum((bb_min - p).amax(dim=-1), (p - bb_max).amax(dim=-1))


def _box_skeleton_edges(center, size, reference_compat: bool):
    """The 12 box edges as ``(starts, ends)``, each ``(12, 3)`` float32.

    Each edge starts at the low corner plus per-axis offsets
    (signed_distance.cu:93-113). The reference offsets the ``(dir+1)%3``
    axis by the size at index ``(dir+1)%2``, which misplaces 8 of the 12
    edges of a non-cubic box (signed_distance.cu:101).
    ``reference_compat=True`` keeps that geometry so renders match the
    reference; ``False`` builds a correct skeleton.
    """
    center = torch.as_tensor(center, dtype=torch.float32)
    size = torch.as_tensor(size, dtype=torch.float32, device=center.device)
    center = center.broadcast_to((3,))
    size = size.broadcast_to((3,))
    eye = torch.eye(3, dtype=torch.float32, device=center.device)
    low = center - size / 2.0

    starts = []
    ends = []
    for axis in range(3):
        a1 = (axis + 1) % 3
        a2 = (axis + 2) % 3
        s1 = (axis + 1) % 2 if reference_compat else a1
        s2 = a2  # the reference's a2 offset indexes correctly ((dir+2)%3)
        for c0 in (0, 1):
            for c1 in (0, 1):
                m0 = low
                if c0:
                    m0 = m0 + size[s1] * eye[a1]
                if c1:
                    m0 = m0 + size[s2] * eye[a2]
                m1 = m0 + size[axis] * eye[axis]
                starts.append(m0)
                ends.append(m1)
    return torch.stack(starts), torch.stack(ends)


def sd_box_skeleton(
    p: torch.Tensor,
    center,
    size,
    line_width,
    *,
    reference_compat: bool = True,
) -> torch.Tensor:
    """Rounded box wireframe: min over the 12 capsule edges minus
    ``line_width`` (signed_distance.cu:93-113)."""
    starts, ends = _box_skeleton_edges(center, size, reference_compat)
    d = sd_line(p[..., None, :], starts.to(p.device), ends.to(p.device))  # (..., 12)
    return d.amin(dim=-1) - line_width


# ---------------------------------------------------------------------------
# component form: coordinate planes x, y, z, parameters as scalars
# ---------------------------------------------------------------------------


def _vec3(v):
    """A 3-vector parameter as three scalars: a tuple or list (one value is
    repeated), a 0-d tensor or a (3,) tensor (sdf/primitives.py::_vec3)."""
    if isinstance(v, (tuple, list)):
        return (v[0], v[0], v[0]) if len(v) == 1 else tuple(v)
    v = torch.as_tensor(v, dtype=torch.float32)
    if v.dim() == 0:
        return (v, v, v)
    v = v.broadcast_to((3,))
    return (v[0], v[1], v[2])


def sd_sphere_c(x, y, z, center, radius):
    """Component form of :func:`sd_sphere`."""
    c = _vec3(center)
    dx, dy, dz = x - c[0], y - c[1], z - c[2]
    return torch.sqrt(dx * dx + dy * dy + dz * dz) - radius


def sd_box_skeleton_c(x, y, z, center, size, line_width, *, reference_compat=True):
    """Component form of :func:`sd_box_skeleton`, in the JAX package's
    operation order (sdf/primitives.py::sd_box_skeleton_c): per axis ``d``
    the capsules along ``d`` are ``axial + min(V1) + min(V2)`` with
    ``lo = c - s/2``, ``o1b = o1 - s1`` (``s1`` the size at ``(d+1)%2``
    under ``reference_compat``), then ``sqrt`` of the minimum over the axes
    minus ``line_width``."""
    center = _vec3(center)
    size = _vec3(size)
    coords = (x, y, z)
    lo = tuple(c - s / 2.0 for c, s in zip(center, size))

    best = None
    for d in range(3):
        a1, a2 = (d + 1) % 3, (d + 2) % 3
        r = coords[d] - lo[d]
        t = minimum(maximum(r, 0.0), size[d])  # jnp.clip(r, 0, size[d])
        e = r - t
        axial = e * e
        s1 = size[(d + 1) % 2] if reference_compat else size[a1]
        o1 = coords[a1] - lo[a1]
        o1b = o1 - s1
        o2 = coords[a2] - lo[a2]
        o2b = o2 - size[a2]
        m1 = torch.minimum(o1 * o1, o1b * o1b)
        m2 = torch.minimum(o2 * o2, o2b * o2b)
        d2 = axial + m1 + m2
        best = d2 if best is None else torch.minimum(best, d2)
    return torch.sqrt(best) - line_width


def sd_box_c(x, y, z, center, size):
    """Component form of :func:`sd_box` (exact box SDF, signed inside)."""
    c = _vec3(center)
    s = _vec3(size)
    qx = abs_(x - c[0]) - s[0] * 0.5
    qy = abs_(y - c[1]) - s[1] * 0.5
    qz = abs_(z - c[2]) - s[2] * 0.5
    ox = maximum(qx, 0.0)
    oy = maximum(qy, 0.0)
    oz = maximum(qz, 0.0)
    outside = torch.sqrt(ox * ox + oy * oy + oz * oz)
    inside = minimum(maximum(qx, maximum(qy, qz)), 0.0)
    return outside + inside


def sd_torus_c(x, y, z, center, major_radius, minor_radius):
    """Component-form torus in the xz plane (ring of ``major_radius``, tube
    of ``minor_radius``)."""
    c = _vec3(center)
    px, py, pz = x - c[0], y - c[1], z - c[2]
    ring = torch.sqrt(px * px + pz * pz) - major_radius
    return torch.sqrt(ring * ring + py * py) - minor_radius


def sd_cylinder_c(x, y, z, center, radius, height):
    """Component-form capped cylinder along +y (exact SDF)."""
    c = _vec3(center)
    px, py, pz = x - c[0], y - c[1], z - c[2]
    dr = torch.sqrt(px * px + pz * pz) - radius
    dy = abs_(py) - height * 0.5
    ox = maximum(dr, 0.0)
    oy = maximum(dy, 0.0)
    return minimum(maximum(dr, dy), 0.0) + torch.sqrt(ox * ox + oy * oy)


# ---------------------------------------------------------------------------
# fractals
# ---------------------------------------------------------------------------

MANDELBULB_POWER = 7.0
MANDELBULB_ITERS = 25


def _mandelbulb_power(time) -> float:
    """``7 * (1 + time * 0.001)`` in float32, as the JAX package computes it."""
    t = np.float32(time) * np.float32(0.001)
    return float(np.float32(MANDELBULB_POWER) * (np.float32(1.0) + t))


def sd_mandelbulb(p: torch.Tensor, time=0.0) -> torch.Tensor:
    """Mandelbulb distance estimator ``0.5 * log(r) * r / dr``
    (signed_distance.cu:29-53: power 7, 25 iterations, escape radius 2).
    A point stops iterating once it escapes; the loop ends when every point
    has, which changes no value."""
    power = _mandelbulb_power(time)
    z = p
    dr = torch.ones_like(p[..., 0])
    r = torch.zeros_like(dr)
    active = torch.ones_like(dr, dtype=torch.bool)
    for _ in range(MANDELBULB_ITERS):
        r_new = _norm(z)
        r = torch.where(active, r_new, r)
        cont = active & (r_new <= 2.0)
        safe_r = maximum(r_new, _SAFE_EPS)
        theta = torch.acos(minimum(maximum(z[..., 2] / safe_r, -1.0), 1.0)) * power
        phi = torch.atan2(z[..., 1], z[..., 0]) * power
        zr = safe_r**power
        dr_next = safe_r ** (power - 1.0) * power * dr + 1.0
        s_theta = torch.sin(theta)
        z_next = (
            zr[..., None]
            * torch.stack(
                [s_theta * torch.cos(phi), torch.sin(phi) * s_theta, torch.cos(theta)], dim=-1
            )
            + p
        )
        z = torch.where(cont[..., None], z_next, z)
        dr = torch.where(cont, dr_next, dr)
        active = cont
        if not bool(active.any()):
            break
    safe_r = maximum(r, _SAFE_EPS)
    return 0.5 * torch.log(safe_r) * r / dr


def sd_mandelbulb_c(x, y, z, time=0.0):
    """Component form of :func:`sd_mandelbulb`, with native ``torch.acos``
    and ``torch.atan2`` (the JAX package's exact default)."""
    power = float(MANDELBULB_POWER * (1.0 + float(time) * 0.001))
    zx, zy, zz = x, y, z
    dr = torch.ones_like(x)
    r = torch.zeros_like(x)
    active = torch.ones_like(x, dtype=torch.bool)
    for _ in range(MANDELBULB_ITERS):
        r_new = torch.sqrt(zx * zx + zy * zy + zz * zz)
        r = torch.where(active, r_new, r)
        cont = active & (r_new <= 2.0)
        safe_r = maximum(r_new, _SAFE_EPS)
        theta = torch.acos(minimum(maximum(zz / safe_r, -1.0), 1.0)) * power
        phi = torch.atan2(zy, zx) * power
        zr = safe_r**power
        dr_next = safe_r ** (power - 1.0) * power * dr + 1.0
        s_theta = torch.sin(theta)
        zx_n = zr * s_theta * torch.cos(phi) + x
        zy_n = zr * torch.sin(phi) * s_theta + y
        zz_n = zr * torch.cos(theta) + z
        zx = torch.where(cont, zx_n, zx)
        zy = torch.where(cont, zy_n, zy)
        zz = torch.where(cont, zz_n, zz)
        dr = torch.where(cont, dr_next, dr)
        active = cont
        if not bool(active.any()):
            break
    safe_r = maximum(r, _SAFE_EPS)
    return 0.5 * torch.log(safe_r) * r / dr


def sd_unit_mandelbulb(p: torch.Tensor) -> torch.Tensor:
    """Mandelbulb rescaled to about unit size (signed_distance.cu:55-57)."""
    return sd_mandelbulb(p / 0.4) * 0.4


# ---------------------------------------------------------------------------
# AABB helpers
# ---------------------------------------------------------------------------


def inside_aabb(p: torch.Tensor, bb_min, bb_max) -> torch.Tensor:
    """Componentwise containment test (signed_distance.cu:137-140)."""
    bb_min = torch.as_tensor(bb_min, dtype=p.dtype, device=p.device)
    bb_max = torch.as_tensor(bb_max, dtype=p.dtype, device=p.device)
    return ((bb_min <= p) & (p <= bb_max)).all(dim=-1)


def ray_distance_to_bb(origin: torch.Tensor, direction: torch.Tensor, bb_min,
                       bb_max) -> torch.Tensor:
    """Slab test: the distance along the ray to the AABB, 0 from inside it,
    +FLT_MAX on a miss (signed_distance.cu:142-175, without the per-axis
    early exits: the masks give the same result)."""
    bb_min = torch.as_tensor(bb_min, dtype=torch.float32, device=origin.device)
    bb_max = torch.as_tensor(bb_max, dtype=torch.float32, device=origin.device)
    eps = float(torch.finfo(torch.float32).eps)
    parallel = torch.abs(direction) < eps
    ood = 1.0 / torch.where(parallel, 1.0, direction)
    t1 = (bb_min - origin) * ood
    t2 = (bb_max - origin) * ood
    t_near = torch.where(parallel, -_MAX_F32, minimum(t1, t2))
    t_far = torch.where(parallel, _MAX_F32, maximum(t1, t2))
    tmin = t_near.amax(dim=-1)
    tmax = t_far.amin(dim=-1)
    parallel_miss = (parallel & ((origin < bb_min) | (origin > bb_max))).any(dim=-1)
    miss = parallel_miss | (tmin > tmax)
    dist = torch.where(tmin > 0, tmin, tmax)
    dist = torch.where(miss, _MAX_F32, dist)
    return torch.where(inside_aabb(origin, bb_min, bb_max), 0.0, dist)
