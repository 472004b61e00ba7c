"""Scene compiler for the CUDA render kernel: ``Scene`` -> ``SceneDescriptor``.

Counterpart of ``bsdmg_tpu/ops/pallas/csdf.py``. The Pallas path bakes the
scene parameters into a Python closure that Mosaic traces into the kernel;
here the same numbers go into a small descriptor that the hand-written
kernel reads (``csrc/render_kernel.cu``, ``SceneDesc``) and that
:func:`descriptor_csdf` evaluates in plain PyTorch, as the kernel's twin.

Every value is derived on the host exactly as the JAX compiler derives it:
segment endpoints come from the float32 box-skeleton edges (with the
reference's ``(dir+1)%2`` quirk), are grouped into axis-aligned capsules in
float64 and rounded to 9 decimals, and every constant reaches the device as
the float32 that JAX's weak typing would give it. A box skeleton's squared
capsule distance is evaluated per segment as ``(axial + o1^2) + o2^2``, the
lower-index perpendicular axis first; because float rounding is monotonic,
its minimum over the 12 segments equals the JAX compiler's factorised
``axial + min(V1) + min(V2)`` bit for bit.

Only the two reference scenes compile; any other scene raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from bsdmg_tpu_torch.models.scenes import Scene
from bsdmg_tpu_torch.sdf.primitives import _box_skeleton_edges

CSdf = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]

#: segments in a box skeleton, and so in every capsule set of a descriptor
N_SEGMENTS = 12

#: scenes this compiler lowers
SUPPORTED = ("reference_object", "reference_render_scene")

#: line width of the render scene's bounding-box wireframe
FRAME_LINE_WIDTH = 0.05


def f32(v) -> float:
    """``v`` rounded to float32, as a Python float."""
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class CapsuleSet:
    """Axis-aligned capsules of one radius, as the kernel evaluates them.

    Segment ``i`` runs along ``axis[i]`` from ``a0[i]`` to
    ``a0[i] + length[i]``; ``p1[i]`` and ``p2[i]`` are its coordinates on the
    lower and the higher of the two other axes. All floats are float32
    values."""

    axis: tuple[int, ...]
    a0: tuple[float, ...]
    length: tuple[float, ...]
    p1: tuple[float, ...]
    p2: tuple[float, ...]
    radius: float


@dataclasses.dataclass(frozen=True)
class SceneDescriptor:
    """One reference scene, ready for the render kernel.

    ``object`` is the box skeleton of ``sd_obj``, ``frame`` the bounding-box
    wireframe of the render scene (None for the object alone).
    ``inv_rotation`` (rows of R^T) and ``translation`` are the object
    transform, None when it is the identity. ``bounds`` is
    ``(lo, hi, slack)`` from :func:`scene_bounds`; ``cull_center`` and
    ``cull_radius`` are the centre and half-diagonal of that box in float64,
    as the slab cull computes them on the host."""

    object: CapsuleSet
    frame: CapsuleSet | None
    sphere_radius: float
    smooth_k: float
    inv_k: float
    k_6: float
    inv_rotation: tuple[tuple[float, float, float], ...] | None
    translation: tuple[float, float, float] | None
    bounds: tuple
    cull_center: tuple[float, float, float]
    cull_radius: float


def _host(params) -> dict[str, np.ndarray]:
    """Params as float32 numpy arrays, wherever the tensors live."""
    out = {}
    for k, v in params.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v, np.float32)
    return out


def capsule_set(starts, ends, radius: float) -> CapsuleSet:
    """Group 12 axis-aligned segments into a :class:`CapsuleSet`, with the
    JAX compiler's float64 arithmetic and 9-decimal rounding
    (``bsdmg_tpu/ops/pallas/csdf.py::_axis_aligned_groups``)."""
    starts = np.asarray(starts, np.float64)
    ends = np.asarray(ends, np.float64)
    if starts.shape != (N_SEGMENTS, 3) or ends.shape != (N_SEGMENTS, 3):
        raise NotImplementedError(
            f"the render kernel takes exactly {N_SEGMENTS} segments per "
            f"capsule set, got {starts.shape}"
        )
    rows = []
    for s, e in zip(starts, ends):
        seg = e - s
        nz = np.nonzero(np.abs(seg) > 1e-12)[0]
        if len(nz) != 1:
            raise NotImplementedError(
                f"the render kernel takes axis-aligned segments only, got {s} -> {e}"
            )
        axis = int(nz[0])
        length = float(seg[axis])
        if length < 0:
            s, length = e, -length
        lower, higher = (a for a in range(3) if a != axis)
        rows.append(
            (
                axis,
                f32(round(float(s[axis]), 9)),
                f32(round(length, 9)),
                f32(round(float(s[lower]), 9)),
                f32(round(float(s[higher]), 9)),
            )
        )
    axis, a0, length, p1, p2 = zip(*rows)
    return CapsuleSet(axis, a0, length, p1, p2, f32(radius))


def box_skeleton_set(center, size, line_width: float, *, reference_compat=True) -> CapsuleSet:
    starts, ends = _box_skeleton_edges(center, size, reference_compat)
    return capsule_set(starts.numpy(), ends.numpy(), line_width)


def _object_transform(p: dict[str, np.ndarray]):
    """``(translation, rotation matrix)`` of the object params in float64, or
    None for the identity (csdf.py::_object_transform)."""
    oc = np.asarray(p.get("object_center", (0.0, 0.0, 0.0)), np.float64)
    oq = np.asarray(p.get("object_rotation", (1.0, 0.0, 0.0, 0.0)), np.float64)
    if np.allclose(oc, 0.0) and np.allclose(oq, (1.0, 0.0, 0.0, 0.0)):
        return None
    oq = oq / np.linalg.norm(oq)
    w, x, y, z = oq
    rot = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    return oc, rot


def _check_supported(scene: Scene) -> None:
    if scene.name not in SUPPORTED:
        raise NotImplementedError(
            f"the CUDA render path compiles only {SUPPORTED}, not scene "
            f"{scene.name!r}; other scenes are not ported yet"
        )


def _reference_object_bounds(p: dict[str, np.ndarray], reference_compat: bool):
    """Conservative AABB of ``sd_obj`` from its actual edge geometry
    (csdf.py::_reference_object_bounds), in the same float32 numpy
    arithmetic, so the bounds are equal."""
    starts, ends = _box_skeleton_edges(
        p["skeleton_center"], p["skeleton_size"], reference_compat
    )
    pts = np.concatenate([starts.numpy(), ends.numpy()], axis=0)
    lw = float(p["skeleton_line_width"])
    r = float(p["sphere_radius"])
    slack = float(p["smooth_k"]) / 6.0 + 1e-3
    lo = np.minimum(pts.min(axis=0) - lw, -r) - slack
    hi = np.maximum(pts.max(axis=0) + lw, r) + slack
    transform = _object_transform(p)
    if transform is not None:
        (tx, ty, tz), rot = transform
        corners = np.array(
            [
                [(lo[0], hi[0])[i], (lo[1], hi[1])[j], (lo[2], hi[2])[k]]
                for i in (0, 1)
                for j in (0, 1)
                for k in (0, 1)
            ]
        )
        moved = corners @ rot.T + np.array([tx, ty, tz])
        lo, hi = moved.min(axis=0), moved.max(axis=0)
    return lo, hi


def scene_bounds(scene: Scene, params=None) -> tuple:
    """Conservative AABB of the scene surface as ``((lx,ly,lz), (hx,hy,hz),
    slack)`` (csdf.py::scene_bounds). ``slack`` bounds the SDF's
    under-estimation (smooth-min k/6 + 1e-3); the slab cull's margin needs
    it to stay sound."""
    _check_supported(scene)
    p = _host(scene.params if params is None else params)
    lo, hi = _reference_object_bounds(p, scene.reference_compat)
    slack = float(p["smooth_k"]) / 6.0 + 1e-3
    if scene.name == "reference_render_scene":
        half = scene.bb_size / 2.0
        lo = np.minimum(lo, -half - FRAME_LINE_WIDTH - 1e-3)
        hi = np.maximum(hi, half + FRAME_LINE_WIDTH + 1e-3)
    return (tuple(map(float, lo)), tuple(map(float, hi)), slack)


def compile_scene(scene: Scene, params=None) -> SceneDescriptor:
    """Lower one of the reference scenes, with ``params`` (default: the
    scene's own), to a :class:`SceneDescriptor`."""
    _check_supported(scene)
    p = _host(scene.params if params is None else params)
    obj = box_skeleton_set(
        p["skeleton_center"], p["skeleton_size"], float(p["skeleton_line_width"]),
        reference_compat=scene.reference_compat,
    )
    frame = None
    if scene.name == "reference_render_scene":
        frame = box_skeleton_set(
            np.zeros(3), np.full(3, scene.bb_size), FRAME_LINE_WIDTH,
            reference_compat=scene.reference_compat,
        )
    k = float(p["smooth_k"])
    inv_rotation = translation = None
    transform = _object_transform(p)
    if transform is not None:
        oc, rot = transform
        translation = tuple(f32(v) for v in oc)
        inv_rotation = tuple(tuple(f32(v) for v in row) for row in rot.T)
    bounds = scene_bounds(scene, params)
    lo, hi = bounds[0], bounds[1]
    center = tuple((lo[a] + hi[a]) * 0.5 for a in range(3))
    radius = 0.5 * float(np.sqrt(sum((hi[a] - lo[a]) ** 2 for a in range(3))))
    return SceneDescriptor(
        object=obj,
        frame=frame,
        sphere_radius=f32(p["sphere_radius"]),
        smooth_k=f32(k),
        inv_k=f32(1.0 / k),
        k_6=f32(k / 6.0),
        inv_rotation=inv_rotation,
        translation=translation,
        bounds=bounds,
        cull_center=center,
        cull_radius=radius,
    )


def _capsule_set_csdf(cs: CapsuleSet, device) -> CSdf:
    """Plain version of the kernel's ``capsule_set``: min over the segments
    of ``(axial + o1^2) + o2^2``, then one sqrt, minus the radius."""
    axis = torch.tensor(cs.axis, device=device)
    lower = torch.tensor([1 if a == 0 else 0 for a in cs.axis], device=device)
    higher = torch.tensor([1 if a == 2 else 2 for a in cs.axis], device=device)

    def f32_tensor(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    a0, length, p1, p2 = (f32_tensor(v) for v in (cs.a0, cs.length, cs.p1, cs.p2))

    def f(x, y, z):
        p = torch.stack([x, y, z], dim=-1)
        r = p[..., axis] - a0
        t = torch.minimum(torch.clamp_min(r, 0.0), length)
        e = r - t
        o1 = p[..., lower] - p1
        o2 = p[..., higher] - p2
        d2 = (e * e + o1 * o1) + o2 * o2
        return torch.sqrt(d2.amin(dim=-1)) - cs.radius

    return f


def descriptor_csdf(desc: SceneDescriptor, device) -> CSdf:
    """The scene SDF of ``desc`` on coordinate planes, in plain PyTorch: the
    twin of the kernel's ``scene_sdf`` (csdf.py::reference_render_scene_csdf)."""
    skeleton = _capsule_set_csdf(desc.object, device)
    frame = None if desc.frame is None else _capsule_set_csdf(desc.frame, device)

    def f(x, y, z):
        ox, oy, oz = x, y, z
        if desc.translation is not None:
            tx, ty, tz = desc.translation
            ox, oy, oz = ox - tx, oy - ty, oz - tz
            m = desc.inv_rotation
            ox, oy, oz = (
                m[0][0] * ox + m[0][1] * oy + m[0][2] * oz,
                m[1][0] * ox + m[1][1] * oy + m[1][2] * oz,
                m[2][0] * ox + m[2][1] * oy + m[2][2] * oz,
            )
        skel = skeleton(ox, oy, oz)
        sph = torch.sqrt(ox * ox + oy * oy + oz * oz) - desc.sphere_radius
        h = torch.clamp_min(desc.smooth_k - torch.abs(skel - sph), 0.0) * desc.inv_k
        d = torch.minimum(skel, sph) - h * h * h * desc.k_6
        if frame is not None:
            d = torch.minimum(d, frame(x, y, z))
        return d

    return f
