"""The SDF primitives of the reference scenes, on ``(..., 3)`` point tensors.

Port of the subset of ``bsdmg_tpu/sdf/primitives.py`` that the reference
object and render scene use (reference: cuda/includes/signed_distance.cu),
in the point form and in the component form on coordinate planes that the
differentiable render evaluates. The rest of that library comes with the
scenes that need it.

Where a function is differentiated, its ``min``, ``max`` and ``abs`` follow
JAX's derivative rules: at a tie each operand of ``minimum``/``maximum``
gets half the gradient (``torch.maximum`` does so; ``torch.clamp`` passes it
all), and ``abs`` has derivative +1 at 0 (``torch.abs`` has 0).
"""

from __future__ import annotations

import torch

_SAFE_EPS = 1e-12


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


def smooth_min(a: torch.Tensor, b: torch.Tensor, k) -> torch.Tensor:
    """Cubic smooth minimum with width ``k`` (signed_distance.cu:20-23):
    ``h = max(k - |a-b|, 0)/k;  min(a,b) - h^3 * k / 6``."""
    h = maximum(k - abs_(a - b), 0.0) / k
    return minimum(a, b) - h * h * h * k * (1.0 / 6.0)


def sd_sphere(p: torch.Tensor, center=0.0, radius=1.0) -> torch.Tensor:
    center = torch.as_tensor(center, dtype=p.dtype, device=p.device)
    return _norm(p - center) - radius


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
