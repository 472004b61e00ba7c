"""SDF of a triangle-mesh asset: the exact signed distance, its grid bake,
and the trilinear grid SDF that mesh-asset scenes render.

Port of ``bsdmg_tpu/models/mesh_sdf.py``. A one-time **grid bake** takes
exact point-to-triangle distances (Eberly's region decomposition) signed by
generalized winding numbers (Jacobson et al. 2013) at every node of a
regular lattice over the mesh's padded AABB; the runtime SDF is the
trilinear interpolation of the baked table, with a sound lower bound outside
the box. On the card the bake runs in a CUDA kernel
(``ops/cuda/bake_kernel.py``, ``csrc/bake_kernel.cu``); its plain twin,
:func:`mesh_signed_distance`, is ordinary PyTorch ops, in chunks of points
sized so that the ``(points, triangles)`` intermediates stay a few GB, as
the JAX package leaves it to XLA. The render's kernels (K8, K9, P1:
``ops/cuda/grid_kernel.py``) sample the same table, the mesh kernels (K6,
K7: ``ops/cuda/csdf.py::grid_descriptor``) too.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

#: point-triangle pairs per bake chunk: each (P, T) float32 plane is 16 MiB,
#: and a chunk keeps a few dozen of them alive, well under 1 GB
PAIR_BUDGET = 1 << 22


# ---------------------------------------------------------------------------
# exact point-triangle distance (Eberly's region decomposition, batched)
# ---------------------------------------------------------------------------


def _components(v):
    """The x, y, z planes of a ``(..., 3)`` tensor."""
    return v[..., 0], v[..., 1], v[..., 2]


def _sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def _dot(a, b):
    """Dot product of component triples, summed left to right."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _point_triangle_dist_sq(p, a, ab, ac):
    """Squared distance from points ``p (P, 1, 3)`` to triangles given by
    vertex ``a (T, 3)`` and edges ``ab, ac (T, 3)``. Returns ``(P, T)``.
    Computed on contiguous ``(P, T)`` component planes."""
    p, a, ab, ac = map(_components, (p, a, ab, ac))
    ap = _sub(p, a)
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)
    a00 = _dot(ab, ab)
    a01 = _dot(ab, ac)
    a11 = _dot(ac, ac)

    det = torch.clamp_min(a00 * a11 - a01 * a01, 1e-20)
    # unconstrained barycentric minimizer
    s = (a11 * d1 - a01 * d2) / det
    t = (a00 * d2 - a01 * d1) / det

    # clamp into the triangle: project onto the three edges and take the best
    def clamped_eval(s, t):
        s = torch.clamp(s, 0.0, 1.0)
        t = torch.minimum(torch.clamp_min(t, 0.0), 1.0 - s)
        q = tuple(ak + s * abk + t * ack - pk for ak, abk, ack, pk in zip(a, ab, ac, p))
        return _dot(q, q)

    # interior candidate (valid when s, t >= 0 and s + t <= 1)
    d_int = clamped_eval(s, t)

    # edge AB (t = 0): s* = d1 / a00
    s_ab = torch.clamp(d1 / torch.clamp_min(a00, 1e-20), 0.0, 1.0)
    d_ab = clamped_eval(s_ab, torch.zeros_like(s_ab))

    # edge AC (s = 0): t* = d2 / a11
    t_ac = torch.clamp(d2 / torch.clamp_min(a11, 1e-20), 0.0, 1.0)
    d_ac = clamped_eval(torch.zeros_like(t_ac), t_ac)

    # edge BC: parameterize s = 1 - u, t = u
    bc = _sub(ac, ab)
    bp = _sub(ap, ab)
    u = torch.clamp(_dot(bc, bp) / torch.clamp_min(_dot(bc, bc), 1e-20), 0.0, 1.0)
    d_bc = clamped_eval(1.0 - u, u)

    return torch.minimum(torch.minimum(d_int, d_ab), torch.minimum(d_ac, d_bc))


def _cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _winding_number(p, va, vb, vc):
    """Generalized winding number of points ``p (P, 1, 3)`` w.r.t. triangles
    ``va, vb, vc (T, 3)`` (van Oosterom & Strackee solid angles). ~0 outside,
    ~1 inside for watertight meshes."""
    p = _components(p)
    a = _sub(_components(va), p)  # (P, T) planes
    b = _sub(_components(vb), p)
    c = _sub(_components(vc), p)
    la = torch.sqrt(_dot(a, a))
    lb = torch.sqrt(_dot(b, b))
    lc = torch.sqrt(_dot(c, c))
    det = _dot(a, _cross(b, c))
    denom = la * lb * lc + _dot(a, b) * lc + _dot(b, c) * la + _dot(c, a) * lb
    omega = 2.0 * torch.atan2(det, denom)  # (P, T)
    return torch.sum(omega, dim=-1) / (4.0 * math.pi)


def _distance_winding_chunk(points, va, vb, vc):
    p = points[:, None, :]
    ab = vb - va
    ac = vc - va
    dist = torch.sqrt(torch.amin(_point_triangle_dist_sq(p, va, ab, ac), dim=-1))
    return dist, _winding_number(p, va, vb, vc)


def mesh_distance_winding(points, vertices, faces, chunk: int | None = None):
    """``(distance, winding number)`` of ``points (N, 3)`` to a triangle
    mesh, on the points' device, in chunks of ``chunk`` points (default: as
    many as keep ``chunk * triangles`` under :data:`PAIR_BUDGET`)."""
    points = torch.as_tensor(points, dtype=torch.float32).reshape(-1, 3)
    device = points.device
    vertices = torch.as_tensor(vertices, dtype=torch.float32, device=device)
    faces = torch.as_tensor(faces, dtype=torch.int64, device=device)
    va, vb, vc = (vertices[faces[:, k]] for k in range(3))
    if chunk is None:
        chunk = max(1, PAIR_BUDGET // max(1, faces.shape[0]))
    parts = [_distance_winding_chunk(points[i : i + chunk], va, vb, vc)
             for i in range(0, points.shape[0], chunk)]
    return torch.cat([d for d, _ in parts]), torch.cat([w for _, w in parts])


def mesh_signed_distance(points, vertices, faces, chunk: int | None = None) -> torch.Tensor:
    """Exact signed distance from ``points (N, 3)`` to a triangle mesh
    (:func:`mesh_distance_winding`): negative where the winding number
    exceeds 1/2. The plain twin of the bake kernel
    (``ops/cuda/bake_kernel.py``)."""
    dist, wn = mesh_distance_winding(points, vertices, faces, chunk)
    return torch.where(wn > 0.5, -dist, dist)


# ---------------------------------------------------------------------------
# baked grid SDF
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class SdfGrid:
    """Dense SDF samples on a regular grid over ``[lo, hi]^3``: ``values``
    an ``(R, R, R)`` float32 tensor, C order, on its device; ``lo``/``hi``
    tuples of Python floats (the float32 box corners)."""

    values: torch.Tensor
    lo: tuple
    hi: tuple

    @property
    def resolution(self) -> int:
        return int(self.values.shape[0])


def _linspace(start: np.float32, stop: np.float32, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` for float32 ends, by its formula:
    ``start * (1 - s) + stop * s`` with ``s = i / (num - 1)`` in float32,
    the last node ``stop``."""
    start, stop = np.float32(start), np.float32(stop)
    if num == 1:
        return np.asarray([start], np.float32)
    div = num - 1
    step = np.arange(div, dtype=np.float32) / np.float32(div)
    out = start * (np.float32(1) - step) + stop * step
    return np.concatenate([out, [stop]]).astype(np.float32)


def grid_box(vertices, padding: float = 0.1) -> tuple[np.ndarray, np.ndarray]:
    """``(lo, hi)``: the float32 corners of a mesh's AABB, made a cube and
    padded by ``padding`` of its extent on each side, in
    ``bake_mesh_grid``'s numpy arithmetic."""
    vertices = np.asarray(vertices, np.float32)
    lo = vertices.min(axis=0)
    hi = vertices.max(axis=0)
    extent = float((hi - lo).max())
    center = (lo + hi) / 2.0
    half = extent * (0.5 + padding)
    return center - half, center + half


def bake_mesh_grid(
    vertices,
    faces,
    resolution: int = 128,
    padding: float = 0.1,
    chunk: int | None = None,
    device: torch.device | str = "cuda",
) -> SdfGrid:
    """Bake a mesh into an ``SdfGrid`` on ``device``. ``padding`` is relative
    margin around the mesh AABB (so the zero level set never touches the
    grid boundary). On a CUDA device the bake kernel runs
    (``ops/cuda/bake_kernel.py``; ``chunk`` is the CPU twin's)."""
    from bsdmg_tpu_torch.ops.cuda.bake_kernel import bake

    lo, hi = grid_box(vertices, padding)
    axes = [torch.from_numpy(_linspace(lo[a], hi[a], resolution)).to(device) for a in range(3)]
    values = bake(axes, vertices, faces, chunk=chunk)
    return SdfGrid(
        values=values.reshape(resolution, resolution, resolution),
        lo=tuple(map(float, lo)),
        hi=tuple(map(float, hi)),
    )


def _outside_step(interior, outside):
    """Sound sphere-trace step for points OUTSIDE the grid box.

    The surface lies inside the box, so ``dist(p, S) >= outside`` (distance
    to the box) and, by the reverse triangle inequality through the clamp
    point b, ``dist(p, S) >= f(b) - |p - b| = interior - outside``: the
    larger of the two is the tightest sound step."""
    return torch.where(outside > 0.0, torch.maximum(outside, interior - outside), interior)


def _outside_distance(x, y, z, lo, hi):
    """Distance of coordinate planes to the box ``[lo, hi]`` (0 inside)."""
    ox = torch.clamp_min(torch.maximum(lo[0] - x, x - hi[0]), 0.0)
    oy = torch.clamp_min(torch.maximum(lo[1] - y, y - hi[1]), 0.0)
    oz = torch.clamp_min(torch.maximum(lo[2] - z, z - hi[2]), 0.0)
    sq = ox * ox + oy * oy + oz * oz
    return torch.where(sq > 0, torch.sqrt(torch.where(sq > 0, sq, 1.0)), 0.0)


def grid_sdf(grid: SdfGrid):
    """Trilinear interpolation SDF ``p (..., 3) -> (...,)`` with the sound
    outside-box fallback (:func:`_outside_step`)."""
    values = grid.values
    r = grid.resolution
    lo, hi, scale = (
        torch.tensor(v, dtype=torch.float32, device=values.device)
        for v in box_f32(r, grid.lo, grid.hi)[:3]
    )

    def sdf(p):
        q = (p - lo) * scale
        q_clamped = torch.clamp(q, 0.0, r - 1 - 1e-4)
        i0 = torch.floor(q_clamped).to(torch.int64)
        f = q_clamped - i0
        i1 = torch.clamp_max(i0 + 1, r - 1)

        def at(ix, iy, iz):
            return values[ix, iy, iz]

        x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
        x1, y1, z1 = i1[..., 0], i1[..., 1], i1[..., 2]
        fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]

        c00 = at(x0, y0, z0) + (at(x1, y0, z0) - at(x0, y0, z0)) * fx
        c10 = at(x0, y1, z0) + (at(x1, y1, z0) - at(x0, y1, z0)) * fx
        c01 = at(x0, y0, z1) + (at(x1, y0, z1) - at(x0, y0, z1)) * fx
        c11 = at(x0, y1, z1) + (at(x1, y1, z1) - at(x0, y1, z1)) * fx
        c0 = c00 + (c10 - c00) * fy
        c1 = c01 + (c11 - c01) * fy
        interior = c0 + (c1 - c0) * fz

        outside_vec = _components(torch.clamp_min(torch.maximum(lo - p, p - hi), 0.0))
        sq = _dot(outside_vec, outside_vec)
        outside = torch.where(sq > 0, torch.sqrt(torch.where(sq > 0, sq, 1.0)), 0.0)
        return _outside_step(interior, outside)

    return sdf


def box_f32(r: int, lo, hi):
    """``(lo, hi, scale, clip_hi)`` of a grid: the float32 corners, ``scale =
    (r - 1) / (hi - lo)`` in float32 as numpy computes it, and the clamp
    ``r - 1 - 1e-4`` in float32; all as Python floats."""
    lo32 = np.asarray(lo, np.float32)
    hi32 = np.asarray(hi, np.float32)
    scale = (r - 1) / (hi32 - lo32)
    as_floats = lambda v: tuple(float(c) for c in v)  # noqa: E731
    return as_floats(lo32), as_floats(hi32), as_floats(scale), float(np.float32(r - 1 - 1e-4))


def make_grid_interp_csdf(at, r: int, lo, hi):
    """Component-form trilinear grid interpolation, parameterized on the
    corner gather ``at(ix, iy, iz)``; the order of operations of kernel K8's
    sampler (``csrc/grid_sdf.cuh::InterpF32``). The scale multiplies: a
    division by a Python scalar on a CUDA tensor becomes a multiplication by
    its reciprocal."""
    lo, hi, scale, clip_hi = box_f32(r, lo, hi)

    def csdf(x, y, z):
        cx = torch.clamp((x - lo[0]) * scale[0], 0.0, clip_hi)
        cy = torch.clamp((y - lo[1]) * scale[1], 0.0, clip_hi)
        cz = torch.clamp((z - lo[2]) * scale[2], 0.0, clip_hi)
        x0, y0, z0 = torch.floor(cx), torch.floor(cy), torch.floor(cz)
        fx, fy, fz = cx - x0, cy - y0, cz - z0
        x0, y0, z0 = x0.to(torch.int64), y0.to(torch.int64), z0.to(torch.int64)
        x1 = torch.clamp_max(x0 + 1, r - 1)
        y1 = torch.clamp_max(y0 + 1, r - 1)
        z1 = torch.clamp_max(z0 + 1, r - 1)

        gx = 1 - fx
        c00 = at(x0, y0, z0) * gx + at(x1, y0, z0) * fx
        c10 = at(x0, y1, z0) * gx + at(x1, y1, z0) * fx
        c01 = at(x0, y0, z1) * gx + at(x1, y0, z1) * fx
        c11 = at(x0, y1, z1) * gx + at(x1, y1, z1) * fx
        c0 = c00 + (c10 - c00) * fy
        c1 = c01 + (c11 - c01) * fy
        interior = c0 + (c1 - c0) * fz
        return _outside_step(interior, _outside_distance(x, y, z, lo, hi))

    return csdf


def grid_csdf(grid: SdfGrid):
    """Component form of :func:`grid_sdf`: coordinate planes in, distance
    plane out, the corners gathered from the flat table."""
    r = grid.resolution
    flat = grid.values.reshape(-1)

    def at(ix, iy, iz):
        return flat[(ix * r + iy) * r + iz]

    return make_grid_interp_csdf(at, r, grid.lo, grid.hi)


@dataclasses.dataclass(frozen=True, eq=False)
class GridCsdf:
    """A mesh asset's ``Scene.csdf``: :func:`grid_csdf` of ``grid`` on
    coordinate planes, ``f(params, x, y, z)`` that reads no parameter (the
    JAX package's ``mesh_scene`` closes over the table). The image fit's
    kernels K4 and K5 (``ops/cuda/diff_kernel.py``) take it as their grid
    form, the table as data: its gradient is zero."""

    grid: SdfGrid

    def __call__(self, params, x, y, z) -> torch.Tensor:
        return grid_csdf(self.grid)(x, y, z)


def coarsen_grid_lower(grid: SdfGrid, resolution: int = 64) -> SdfGrid:
    """Sound *lower-bound* mip of a fine grid SDF for multi-level tracing.

    Each coarse vertex takes the MIN over all fine vertices within max-norm
    radius ``h_c + h_f`` of it, so the coarse trilinear value lower-bounds
    the fine one everywhere in the box: steps on the mip can never overshoot
    the fine surface. The windows are computed on the host in float64, as
    the JAX package computes them; each is a min over a slice of the table
    on its device."""
    r_f = grid.resolution
    r_c = int(resolution)
    lo = np.asarray(grid.lo, np.float64)
    hi = np.asarray(grid.hi, np.float64)
    out = grid.values
    for axis in range(3):
        h_f = (hi[axis] - lo[axis]) / (r_f - 1)
        h_c = (hi[axis] - lo[axis]) / (r_c - 1)
        w = h_c + h_f
        pooled = []
        for j in range(r_c):
            q = j * h_c
            i0 = max(int(np.ceil((q - w) / h_f - 1e-9)), 0)
            i1 = min(int(np.floor((q + w) / h_f + 1e-9)), r_f - 1)
            pooled.append(torch.amin(out.narrow(axis, i0, i1 + 1 - i0), dim=axis, keepdim=True))
        out = torch.cat(pooled, dim=axis)
    return SdfGrid(values=out.contiguous(), lo=grid.lo, hi=grid.hi)


def mesh_scene(vertices, faces, resolution: int = 128, name: str = "mesh",
               device: torch.device | str = "cuda"):
    """A Scene from a triangle mesh, its grid baked on ``device`` at once.
    Returns ``(scene, grid)``."""
    from bsdmg_tpu_torch.models.scenes import Scene

    grid = bake_mesh_grid(vertices, faces, resolution=resolution, device=device)
    sdf = grid_sdf(grid)
    scene = Scene(
        name, lambda params, p: sdf(p), {"grid": grid.values}, csdf=GridCsdf(grid), grid=grid,
    )
    return scene, grid
