"""The built-in scenes.

Port of ``bsdmg_tpu/models/scenes.py`` (composed scenes are
``models/compose.py``):

* ``sd_obj`` (cuda/modules/common.cu:222-226): ``smooth_min`` of a box
  skeleton (center 0, size (3, 1, 0.5), line width 0.1) and a sphere of
  radius 1, smoothing k = 0.5, under an optional rigid object transform;
* ``sd_scene`` (cuda/modules/compute_render.cu:3-19): ``sd_obj`` unioned
  with the mesh-generation bounding-box wireframe (size 5, line width 0.05);
* ``sphere``, ``box`` and ``mandelbulb`` (signed_distance.cu:29-91), and
  ``wrapped_object``, the reference object repeated on a cubic lattice.

Every constructor puts its parameters on ``device``, the card unless the
caller names another.

Each scene has its SDF on ``(..., 3)`` points (``Scene.sdf``) and on
coordinate planes (``Scene.csdf``: :class:`ReferenceCsdf`, :class:`SphereCsdf`,
:class:`MandelbulbCsdf`, :class:`WrappedCsdf`; a composed scene's is
``models/compose.py::ComposedCsdf``), the form the differentiable render
evaluates and kernels K4 and K5 mirror; the box has none.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from bsdmg_tpu_torch.sdf import primitives as sdf

Params = dict[str, torch.Tensor]
SceneFn = Callable[[Params, torch.Tensor], torch.Tensor]

#: line width of the render scene's bounding-box wireframe
FRAME_LINE_WIDTH = 0.05


@dataclasses.dataclass(frozen=True)
class Scene:
    """An SDF scene: ``sdf(params, p)`` on ``(..., 3)`` points plus its
    default params. ``reference_compat`` and ``bb_size`` record how the
    scene was built, so the scene compiler (``ops/cuda/csdf.py``) bakes the
    same geometry. ``csdf(params, x, y, z)`` is the same SDF on coordinate
    planes, differentiable with respect to ``params``. A mesh-asset scene
    (``models/mesh_sdf.py::mesh_scene``) carries its baked ``grid``, which
    the grid render (``ops/cuda/grid_kernel.py``) samples; a composed scene
(``models/compose.py``) its ``spec``."""

    name: str
    sdf: SceneFn
    params: Params
    reference_compat: bool = True
    bb_size: float = 5.0
    csdf: "Callable | None" = None
    grid: "SdfGrid | None" = None  # noqa: F821 (models/mesh_sdf.py)
    #: a composed scene's spec tree and node ids (models/compose.py), from
    #: which ops/cuda/csdf.py builds the kernels' node program and the
    #: bounds; None for the built-in scenes
    spec: "dict | None" = None

    def bind(self, params: Params | None = None) -> Callable[[torch.Tensor], torch.Tensor]:
        """Close over ``params`` (default params if None)."""
        bound = self.params if params is None else params
        scene_fn = self.sdf
        return lambda p: scene_fn(bound, p)


def _f32(value, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def default_object_params(device: torch.device | str = "cuda") -> Params:
    """Parameters of the reference object (common.cu:222-226), float32.

    ``object_center``/``object_rotation`` (quaternion w, x, y, z) are the
    JAX package's rigid-transform extension; the defaults are the identity."""
    return {
        "skeleton_center": _f32([0.0, 0.0, 0.0], device),
        "skeleton_size": _f32([3.0, 1.0, 0.5], device),
        "skeleton_line_width": _f32(0.1, device),
        "sphere_radius": _f32(1.0, device),
        "smooth_k": _f32(0.5, device),
        "object_center": _f32([0.0, 0.0, 0.0], device),
        "object_rotation": _f32([1.0, 0.0, 0.0, 0.0], device),
    }


def _quat_inv_rotate_c(q, x, y, z):
    """Rotate coordinate planes by the inverse of quaternion ``q`` (w,x,y,z),
    normalised first."""
    inv = torch.rsqrt(
        torch.clamp_min(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3], 1e-24)
    )
    w, qx, qy, qz = q[0] * inv, q[1] * inv, q[2] * inv, q[3] * inv
    # rows of R(q); the inverse rotation applies R^T, i.e. columns
    r00, r01, r02 = 1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - w * qz), 2 * (qx * qz + w * qy)
    r10, r11, r12 = 2 * (qx * qy + w * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - w * qx)
    r20, r21, r22 = 2 * (qx * qz - w * qy), 2 * (qy * qz + w * qx), 1 - 2 * (qx * qx + qy * qy)
    return (
        r00 * x + r10 * y + r20 * z,
        r01 * x + r11 * y + r21 * z,
        r02 * x + r12 * y + r22 * z,
    )


def _object_space_c(params: Params, x, y, z):
    """Map world coordinate planes into the object's local frame."""
    oc = params.get("object_center")
    if oc is not None:
        x, y, z = x - oc[0], y - oc[1], z - oc[2]
    oq = params.get("object_rotation")
    if oq is not None:
        x, y, z = _quat_inv_rotate_c(oq, x, y, z)
    return x, y, z


def _sd_obj_c(params: Params, x, y, z, *, reference_compat: bool = True) -> torch.Tensor:
    x, y, z = _object_space_c(params, x, y, z)
    a1 = sdf.sd_box_skeleton_c(
        x, y, z,
        params["skeleton_center"],
        params["skeleton_size"],
        params["skeleton_line_width"],
        reference_compat=reference_compat,
    )
    # the reference's sphere is pinned at the origin (common.cu:224)
    a2 = sdf.sd_sphere_c(x, y, z, (0.0, 0.0, 0.0), params["sphere_radius"])
    return sdf.smooth_min(a1, a2, params["smooth_k"])


@dataclasses.dataclass(frozen=True)
class ReferenceCsdf:
    """``f(params, x, y, z)``: a reference scene's SDF on coordinate planes
    (``models/scenes.py::_sd_obj_c`` and the render scene's ``cfn``), with
    the JAX package's operations in its order, computed from the parameter
    values at call time. ``frame_size`` is the render scene's wireframe
    size, None for the object alone. The kernels K4 and K5
    (``ops/cuda/diff_kernel.py``) evaluate the same function from these
    fields."""

    reference_compat: bool = True
    frame_size: float | None = None

    def __call__(self, params: Params, x, y, z) -> torch.Tensor:
        d = _sd_obj_c(params, x, y, z, reference_compat=self.reference_compat)
        if self.frame_size is None:
            return d
        return sdf.minimum(d, self.frame(x, y, z))

    def frame(self, x, y, z) -> torch.Tensor:
        """The render scene's wireframe alone, which reads no parameter: the
        far scene that K4 and K5 march under the near/far split."""
        size = float(self.frame_size)
        return sdf.sd_box_skeleton_c(
            x, y, z, (0.0, 0.0, 0.0), (size, size, size), FRAME_LINE_WIDTH,
            reference_compat=self.reference_compat,
        )


@dataclasses.dataclass(frozen=True)
class SphereCsdf:
    """The sphere scene's component form: a sphere of radius
    ``params["radius"]`` at the origin."""

    def __call__(self, params: Params, x, y, z) -> torch.Tensor:
        return sdf.sd_sphere_c(x, y, z, 0.0, params["radius"])


@dataclasses.dataclass(frozen=True)
class MandelbulbCsdf:
    """The mandelbulb scene's component form: the points divided by
    ``s = params["scale"] * 0.4``, the distance multiplied by it."""

    def __call__(self, params: Params, x, y, z) -> torch.Tensor:
        s = params["scale"] * 0.4
        return sdf.sd_mandelbulb_c(x / s, y / s, z / s) * s


@dataclasses.dataclass(frozen=True)
class WrappedCsdf:
    """The wrapped object's component form: each coordinate wrapped into
    the cell of period ``params["cell"]`` (``-half + mod(v + half, cell)``,
    ``half = cell / 2``), then the reference object, transform included."""

    def __call__(self, params: Params, x, y, z) -> torch.Tensor:
        cell = params["cell"]
        half = cell / 2.0
        wx = -half + sdf.mod(x + half, cell)
        wy = -half + sdf.mod(y + half, cell)
        wz = -half + sdf.mod(z + half, cell)
        return _sd_obj_c(params, wx, wy, wz)


def _sd_obj(params: Params, p: torch.Tensor, *, reference_compat: bool = True) -> torch.Tensor:
    x, y, z = _object_space_c(params, p[..., 0], p[..., 1], p[..., 2])
    p = torch.stack([x, y, z], dim=-1)
    a1 = sdf.sd_box_skeleton(
        p,
        params["skeleton_center"],
        params["skeleton_size"],
        params["skeleton_line_width"],
        reference_compat=reference_compat,
    )
    # the reference's sphere is pinned at the origin (common.cu:224)
    a2 = sdf.sd_sphere(p, 0.0, params["sphere_radius"])
    return sdf.smooth_min(a1, a2, params["smooth_k"])


def reference_object(
    *, reference_compat: bool = True, device: torch.device | str = "cuda"
) -> Scene:
    """The mesh-generation target object ``sd_obj``."""
    fn = lambda params, p: _sd_obj(params, p, reference_compat=reference_compat)
    return Scene(
        "reference_object", fn, default_object_params(device), reference_compat,
        csdf=ReferenceCsdf(reference_compat),
    )


def reference_render_scene(
    *,
    bb_size: float = 5.0,
    reference_compat: bool = True,
    device: torch.device | str = "cuda",
) -> Scene:
    """The render scene: object + bounding-box wireframe (compute_render.cu:3-19)."""

    def fn(params: Params, p: torch.Tensor) -> torch.Tensor:
        sd = _sd_obj(params, p, reference_compat=reference_compat)
        frame = sdf.sd_box_skeleton(
            p,
            torch.zeros(3, dtype=torch.float32, device=p.device),
            torch.full((3,), bb_size, dtype=torch.float32, device=p.device),
            FRAME_LINE_WIDTH,
            reference_compat=reference_compat,
        )
        return torch.minimum(sd, frame)

    return Scene(
        "reference_render_scene", fn, default_object_params(device),
        reference_compat, bb_size, ReferenceCsdf(reference_compat, bb_size),
    )


def sphere_scene(radius: float = 1.0, *, device: torch.device | str = "cuda") -> Scene:
    """A sphere of ``radius`` at the origin."""
    return Scene(
        "sphere",
        lambda q, p: sdf.sd_sphere(p, 0.0, q["radius"]),
        {"radius": _f32(radius, device)},
        csdf=SphereCsdf(),
    )


def box_scene(size=(1.0, 1.0, 1.0), *, device: torch.device | str = "cuda") -> Scene:
    """An axis-aligned box of full extent ``size`` at the origin; like the
    JAX package's, it has no component form."""
    return Scene("box", lambda q, p: sdf.sd_box(p, 0.0, q["size"]), {"size": _f32(size, device)})


def mandelbulb_scene(scale: float = 1.0, *, device: torch.device | str = "cuda") -> Scene:
    """The power-7 mandelbulb (signed_distance.cu:29-57), ``scale`` times
    the reference's unit size."""

    def fn(q, p):
        s = q["scale"] * 0.4
        return sdf.sd_mandelbulb(p / s) * s

    return Scene("mandelbulb", fn, {"scale": _f32(scale, device)}, csdf=MandelbulbCsdf())


def wrapped_object_scene(cell: float = 8.0, *, device: torch.device | str = "cuda") -> Scene:
    """The reference object repeated on a cubic lattice of period ``cell``
    by the ``wrap`` domain repetition (signed_distance.cu:9-18); a distance
    bound while the object (extent ~3.5) stays inside its cell. It has no
    bounds, so the render does not cull."""
    params = default_object_params(device)
    params["cell"] = _f32(cell, device)

    def fn(q, p):
        half = q["cell"] / 2.0
        return _sd_obj(q, sdf.wrap(p, -half.expand(3), half.expand(3)))

    return Scene("wrapped_object", fn, params, csdf=WrappedCsdf())


SCENES: dict[str, Callable[..., Scene]] = {
    "reference_object": reference_object,
    "reference_render_scene": reference_render_scene,
    "sphere": sphere_scene,
    "box": box_scene,
    "mandelbulb": mandelbulb_scene,
    "wrapped_object": wrapped_object_scene,
}


def get_scene(name: str, *, device: torch.device | str = "cuda", **kwargs) -> Scene:
    """The built-in scene ``name`` with its parameters on ``device``."""
    if name not in SCENES:
        raise KeyError(f"unknown scene {name!r}; available: {sorted(SCENES)}")
    return SCENES[name](device=device, **kwargs)
