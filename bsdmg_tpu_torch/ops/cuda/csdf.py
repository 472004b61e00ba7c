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
the float32 that JAX's weak typing would give it. A capsule set is held as
the JAX compiler's factorised parallel-edge groups (:class:`CapsuleGroup`):
per group ``(axial + min(V1)) + min(V2)``, then ``min`` across the groups;
because float rounding is monotonic, this equals the minimum over the
segments of ``(axial + o1^2) + o2^2`` bit for bit.

The gradient (:func:`descriptor_csdf_value_and_grad`, twin of the kernels'
``scene_sdf_grad``) walks the same groups backward, as ``jax.vjp`` of the
JAX compiler's SDF does: every ``min``/``max`` splits its cotangent evenly
at a tie, as JAX does. The lattice of the mesh path contains the
skeleton's symmetry planes, where such ties are common.

The kernels are compiled for the structure of these descriptors
(:func:`kernel_structure`): box-skeleton capsule sets of 3 groups along x,
y and z with 2 perpendicular coordinates per other axis, with or without
the wireframe and the object transform.

Only the two reference scenes compile; any other scene raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from bsdmg_tpu_torch.models.scenes import FRAME_LINE_WIDTH, Scene
from bsdmg_tpu_torch.sdf.primitives import _box_skeleton_edges

CSdf = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]

#: scenes this compiler lowers
SUPPORTED = ("reference_object", "reference_render_scene")

#: parallel-edge groups per capsule set, and distinct perpendicular
#: coordinates per group axis, that the kernels take (a box skeleton has 3
#: groups of 2 x 2)
MAX_GROUPS = 3
MAX_GROUP_VALUES = 2


def f32(v) -> float:
    """``v`` rounded to float32, as a Python float."""
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class CapsuleGroup:
    """Segments of one axis, start and length whose perpendicular
    coordinates form the cross product ``v1 x v2`` (``v1`` on the lower,
    ``v2`` on the higher of the two other axes, each ascending): one group
    of the JAX compiler's factorised capsule set
    (``csdf.py::capsule_set_sq_csdf``). Floats are float32 values."""

    axis: int
    a0: float
    length: float
    v1: tuple[float, ...]
    v2: tuple[float, ...]


@dataclasses.dataclass(frozen=True)
class CapsuleSet:
    """Axis-aligned capsules of one radius, as the kernels evaluate them:
    ``groups`` in the JAX compiler's order. ``radius`` is a float32 value."""

    radius: float
    groups: tuple[CapsuleGroup, ...]


@dataclasses.dataclass(frozen=True)
class SceneDescriptor:
    """One reference scene, ready for the render kernel.

    ``object`` is the box skeleton of ``sd_obj``, ``frame`` the bounding-box
    wireframe of the render scene (None for the object alone).
    ``inv_rotation`` (rows of R^T) and ``translation`` are the object
    transform, None when it is the identity. ``bounds`` is
    ``(lo, hi, slack)`` from :func:`scene_bounds`."""

    object: CapsuleSet
    frame: CapsuleSet | None
    sphere_radius: float
    smooth_k: float
    inv_k: float
    k_6: float
    inv_rotation: tuple[tuple[float, float, float], ...] | None
    translation: tuple[float, float, float] | None
    bounds: tuple


def _host(params) -> dict[str, np.ndarray]:
    """Params as float32 numpy arrays, wherever the tensors live."""
    out = {}
    for k, v in params.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v, np.float32)
    return out


def capsule_set(starts, ends, radius: float) -> CapsuleSet:
    """Group axis-aligned segments into a :class:`CapsuleSet`, with the JAX
    compiler's float64 arithmetic and 9-decimal rounding
    (``bsdmg_tpu/ops/pallas/csdf.py::_axis_aligned_groups``)."""
    starts = np.asarray(starts, np.float64)
    ends = np.asarray(ends, np.float64)
    groups: dict = {}
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
        key = (axis, round(float(s[axis]), 9), round(length, 9))
        perp = (round(float(s[lower]), 9), round(float(s[higher]), 9))
        groups.setdefault(key, []).append(perp)
    return CapsuleSet(f32(radius), tuple(_group(key, perps) for key, perps in groups.items()))


def _group(key, perps) -> CapsuleGroup:
    """One factorised group, as ``_axis_aligned_groups`` and
    ``capsule_set_sq_csdf`` build it: distinct coordinates sorted ascending."""
    v1 = sorted({p[0] for p in perps})
    v2 = sorted({p[1] for p in perps})
    if set(perps) != {(a, b) for a in v1 for b in v2}:
        raise NotImplementedError(
            f"capsule group {key}: perpendicular offsets {perps} are not a "
            "cross product; the kernels take factorised groups only"
        )
    if max(len(v1), len(v2)) > MAX_GROUP_VALUES:
        raise NotImplementedError(
            f"capsule group {key} has {len(v1)} x {len(v2)} offsets; the "
            f"kernels take at most {MAX_GROUP_VALUES} per axis"
        )
    axis, a0, length = key
    return CapsuleGroup(
        axis, f32(a0), f32(length), tuple(map(f32, v1)), tuple(map(f32, v2))
    )


def box_skeleton_set(center, size, line_width: float, *, reference_compat=True) -> CapsuleSet:
    starts, ends = _box_skeleton_edges(center, size, reference_compat)
    cs = capsule_set(starts.numpy(), ends.numpy(), line_width)
    if len(cs.groups) > MAX_GROUPS:
        raise NotImplementedError(
            f"{len(cs.groups)} capsule groups; the kernels take at most {MAX_GROUPS}"
        )
    return cs


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
    return SceneDescriptor(
        object=obj,
        frame=frame,
        sphere_radius=f32(p["sphere_radius"]),
        smooth_k=f32(k),
        inv_k=f32(1.0 / k),
        k_6=f32(k / 6.0),
        inv_rotation=inv_rotation,
        translation=translation,
        bounds=scene_bounds(scene, params),
    )


# ---------------------------------------------------------------------------
# the scene SDF, and its value and gradient
# ---------------------------------------------------------------------------


def _tie_weight(x, z, y):
    """JAX's reverse-mode weight of operand ``x`` of ``min(x, y)`` or
    ``max(x, y)`` whose result is ``z`` (``lax._balanced_eq``): 1 if ``x``
    alone attains ``z``, 1/2 at a tie, else 0."""
    return torch.where(x == z, 1.0, 0.0) / torch.where(y == z, 2.0, 1.0)


def _add_to_axis(grad: list, axis: int, value) -> None:
    grad[axis] = value if grad[axis] is None else grad[axis] + value


def _group_d2(g: CapsuleGroup, coords):
    r = coords[g.axis] - g.a0
    e = r - torch.clamp_max(torch.clamp_min(r, 0.0), g.length)
    c1 = coords[1 if g.axis == 0 else 0]
    c2 = coords[1 if g.axis == 2 else 2]

    def slot_min(c, values):
        d = c - values[0]
        m = d * d
        if len(values) > 1:
            d1 = c - values[1]
            m = torch.minimum(m, d1 * d1)
        return m

    return (e * e + slot_min(c1, g.v1)) + slot_min(c2, g.v2)


def _slot_bwd(c, values, ct):
    """Cotangent of coordinate ``c`` from ``min`` over its squared offsets to
    ``values``, given the cotangent ``ct`` of that minimum."""
    d0 = c - values[0]
    s0 = d0 * d0
    ct0 = ct
    if len(values) > 1:
        d1 = c - values[1]
        s1 = d1 * d1
        m = torch.minimum(s0, s1)
        ct0 = ct * _tie_weight(s0, m, s1)
        ct1 = ct * _tie_weight(s1, m, s0)
    a0 = ct0 * d0
    out = a0 + a0  # d(d*d) = ct*d + d*ct
    if len(values) > 1:
        a1 = ct1 * d1
        out = out + (a1 + a1)
    return out


def _group_bwd(g: CapsuleGroup, coords, ct, grad: list) -> None:
    r = coords[g.axis] - g.a0
    mx = torch.clamp_min(r, 0.0)  # jnp.clip: maximum(0, r), then minimum(length, .)
    t = torch.clamp_max(mx, g.length)
    e = r - t
    ce = ct * e
    ct_e = ce + ce
    ct_t = -ct_e
    ct_mx = ct_t * _tie_weight(mx, t, g.length)
    _add_to_axis(grad, g.axis, ct_e + ct_mx * _tie_weight(r, mx, 0.0))
    lo = 1 if g.axis == 0 else 0
    hi = 1 if g.axis == 2 else 2
    _add_to_axis(grad, lo, _slot_bwd(coords[lo], g.v1, ct))
    _add_to_axis(grad, hi, _slot_bwd(coords[hi], g.v2, ct))


def _capsule_set_value_grad(cs: CapsuleSet):
    """``f(x, y, z) -> (value, backward)`` of one capsule set, the twin of
    ``capsule_set_fwd``/``capsule_set_bwd`` in csrc/scene_sdf.cuh.
    ``backward(ct, grad)`` adds ``ct * d value / d coords`` to ``grad``."""

    def f(x, y, z):
        coords = (x, y, z)
        d2 = [_group_d2(g, coords) for g in cs.groups]
        best = [d2[0]]
        for v in d2[1:]:
            best.append(torch.minimum(best[-1], v))
        root = torch.sqrt(best[-1])

        def backward(ct, grad: list) -> None:
            w = ct * (0.5 / root)  # d sqrt(b) = (0.5 / sqrt(b)) db
            ctg = [None] * len(d2)
            for g in range(len(d2) - 1, 0, -1):
                ctg[g] = w * _tie_weight(d2[g], best[g], best[g - 1])
                w = w * _tie_weight(best[g - 1], best[g], d2[g])
            ctg[0] = w
            for group, c in zip(cs.groups, ctg):
                _group_bwd(group, coords, c, grad)

        return root - cs.radius, backward

    return f


def _object_coords(desc: SceneDescriptor, x, y, z):
    """World -> object coordinates (the object transform, when there is one)."""
    if desc.translation is None:
        return x, y, z
    tx, ty, tz = desc.translation
    x, y, z = x - tx, y - ty, z - tz
    m = desc.inv_rotation
    return (
        m[0][0] * x + m[0][1] * y + m[0][2] * z,
        m[1][0] * x + m[1][1] * y + m[1][2] * z,
        m[2][0] * x + m[2][1] * y + m[2][2] * z,
    )


def descriptor_csdf(desc: SceneDescriptor) -> CSdf:
    """The scene SDF of ``desc`` on coordinate planes, in plain PyTorch: the
    twin of the kernels' ``scene_sdf`` (csdf.py::reference_render_scene_csdf)."""
    skeleton = _capsule_set_value_grad(desc.object)
    frame = None if desc.frame is None else _capsule_set_value_grad(desc.frame)

    def f(x, y, z):
        ox, oy, oz = _object_coords(desc, x, y, z)
        skel = skeleton(ox, oy, oz)[0]
        sph = torch.sqrt(ox * ox + oy * oy + oz * oz) - desc.sphere_radius
        h = torch.clamp_min(desc.smooth_k - torch.abs(skel - sph), 0.0) * desc.inv_k
        d = torch.minimum(skel, sph) - h * h * h * desc.k_6
        if frame is not None:
            d = torch.minimum(d, frame(x, y, z)[0])
        return d

    return f


def kernel_structure(desc: SceneDescriptor) -> int:
    """The index of the compile-time structure the kernels launch for
    ``desc`` (``Box<Frame, Transform>`` in csrc/scene_sdf.cuh): ``2 *
    frame + transform``. Each capsule set must be a box skeleton as the
    kernels take it, 3 groups along x, y and z in that order with 2
    perpendicular coordinates per other axis; any other descriptor raises
    ``NotImplementedError``, for which no kernel is built."""
    sets = {"object": desc.object, "frame": desc.frame}
    for name, cs in sets.items():
        if cs is None:
            continue
        shape = [(g.axis, len(g.v1), len(g.v2)) for g in cs.groups]
        if shape != [(a, MAX_GROUP_VALUES, MAX_GROUP_VALUES) for a in range(MAX_GROUPS)]:
            raise NotImplementedError(
                f"{name} capsule groups (axis, values, values) {shape}: the kernels are built "
                f"for {MAX_GROUPS} groups along x, y and z with {MAX_GROUP_VALUES} x "
                f"{MAX_GROUP_VALUES} perpendicular coordinates"
            )
    return 2 * (desc.frame is not None) + (desc.translation is not None)


def descriptor_csdf_value_and_grad(desc: SceneDescriptor):
    """``f(x, y, z) -> (d, gx, gy, gz)``: the scene SDF of ``desc`` and its
    gradient on coordinate planes, in plain PyTorch; the twin of the
    kernels' ``scene_sdf_grad`` (csrc/scene_sdf.cuh).

    The gradient is reverse mode with a cotangent of 1, as ``jax.vjp`` of
    the JAX compiler's SDF (``compile_scene_csdf``) takes it: through the
    capsule groups, with every ``min``/``max`` splitting its cotangent
    evenly at a tie and ``abs`` passing +1 at 0. ``d`` equals
    :func:`descriptor_csdf` bit for bit."""
    skeleton = _capsule_set_value_grad(desc.object)
    frame = None if desc.frame is None else _capsule_set_value_grad(desc.frame)

    def f(x, y, z):
        ox, oy, oz = _object_coords(desc, x, y, z)
        # forward
        skel, skel_bwd = skeleton(ox, oy, oz)
        sroot = torch.sqrt(ox * ox + oy * oy + oz * oz)
        sph = sroot - desc.sphere_radius
        delta = skel - sph
        u = desc.smooth_k - torch.abs(delta)
        hm = torch.clamp_min(u, 0.0)
        h = hm * desc.inv_k
        h2 = h * h
        h3 = h2 * h
        m = torch.minimum(skel, sph)
        obj = m - h3 * desc.k_6
        d = obj
        if frame is not None:
            fd, frame_bwd = frame(x, y, z)
            d = torch.minimum(obj, fd)

        # backward, cotangent 1
        ct_obj = torch.ones_like(d) if frame is None else _tie_weight(obj, d, fd)
        ct_h3 = -ct_obj * desc.k_6
        ct_h2 = ct_h3 * h
        ct_h = (h2 * ct_h3 + ct_h2 * h) + h * ct_h2
        ct_u = (ct_h * desc.inv_k) * _tie_weight(u, hm, 0.0)
        ct_abs = -ct_u
        ct_delta = torch.where(delta >= 0.0, ct_abs, -ct_abs)  # jax: d|x| = +1 at 0
        ct_skel = ct_obj * _tie_weight(skel, m, sph) + ct_delta
        ct_sph = ct_obj * _tie_weight(sph, m, skel) - ct_delta
        ct_s2 = ct_sph * (0.5 / sroot)

        c = [None, None, None]
        skel_bwd(ct_skel, c)
        for a, o in enumerate((ox, oy, oz)):
            s = ct_s2 * o
            _add_to_axis(c, a, s + s)
        if desc.translation is not None:
            m9 = desc.inv_rotation
            g = [(m9[0][a] * c[0] + m9[1][a] * c[1]) + m9[2][a] * c[2] for a in range(3)]
        else:
            g = c
        if frame is not None:
            frame_bwd(_tie_weight(fd, d, obj), g)
        return (d, *g)

    return f


class SdfFns(NamedTuple):
    """A scene's SDF on coordinate planes, ``value(x, y, z) -> d``, and its
    value and gradient, ``value_and_grad(x, y, z) -> (d, gx, gy, gz)``: what
    the plain twins of the mesh kernels evaluate."""

    value: CSdf
    value_and_grad: Callable


def sdf_fns(scene: "SceneDescriptor | SdfFns") -> SdfFns:
    """The :class:`SdfFns` of a descriptor; an :class:`SdfFns` as it is."""
    if isinstance(scene, SdfFns):
        return scene
    return SdfFns(descriptor_csdf(scene), descriptor_csdf_value_and_grad(scene))
