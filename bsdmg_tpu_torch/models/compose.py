"""Composable scene specs: JSON/dict CSG trees as scenes.

Port of ``bsdmg_tpu/models/compose.py``. A scene is data: a nested spec of
primitives and CSG operators that lowers to

* a **param-traced** component SDF on tensors (:class:`ComposedCsdf`;
  every numeric field is an entry of the scene's params, so a composed
  scene is differentiable and fits as the built-ins do, ``cli fit`` from a
  depth map or, through kernels K4 and K5 and their parameter program
  ``ops/cuda/csdf.py::param_program``, from an image);
* a **node program** for the kernels (``ops/cuda/csdf.py::compile_scene``
  flattens ``Scene.spec`` into it; ``csrc/scene_sdf.cuh`` ``Composed``
  interprets it);
* conservative **bounds** for the render's slab cull, per node, with the
  cull's soundness contract (``f >= d(p, box) - slack``).

Spec format (JSON-compatible)::

    {"name": "snowman",
     "root": {"op": "smooth_union", "k": 0.4, "children": [
        {"prim": "sphere", "center": [0, 0, 0], "radius": 1.0},
        {"prim": "sphere", "center": [0, 1.2, 0], "radius": 0.6}]}}

Primitives: ``sphere``, ``box``, ``capsule``, ``box_skeleton``, ``torus``,
``cylinder``, ``plane``. Operators: ``union``, ``smooth_union`` (k),
``intersect``, ``subtract`` (first child minus the rest), ``shell``
(thickness), ``transform`` (offset + rotation quat, one ``child``),
``wrap`` (cell-periodic domain repetition, one ``child``; unbounded, so it
turns the slab cull off). Validation, parameter names (``n<i>_<field>`` in
DFS preorder) and error messages are the JAX package's.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from bsdmg_tpu_torch.models.scenes import Scene, _quat_inv_rotate_c
from bsdmg_tpu_torch.sdf import primitives as sdf
from bsdmg_tpu_torch.sdf.primitives import _vec3

# field -> (length, default); length 1 = scalar
_PRIM_FIELDS: dict[str, dict[str, tuple[int, Any]]] = {
    "sphere": {"center": (3, (0.0, 0.0, 0.0)), "radius": (1, 1.0)},
    "box": {"center": (3, (0.0, 0.0, 0.0)), "size": (3, (1.0, 1.0, 1.0))},
    "capsule": {
        "start": (3, (0.0, 0.0, 0.0)),
        "end": (3, (0.0, 1.0, 0.0)),
        "radius": (1, 0.1),
    },
    "box_skeleton": {
        "center": (3, (0.0, 0.0, 0.0)),
        "size": (3, (1.0, 1.0, 1.0)),
        "line_width": (1, 0.05),
    },
    # torus in the xz plane: major radius in xz, minor tube radius
    "torus": {
        "center": (3, (0.0, 0.0, 0.0)),
        "major_radius": (1, 1.0),
        "minor_radius": (1, 0.25),
    },
    # capped cylinder along +y
    "cylinder": {
        "center": (3, (0.0, 0.0, 0.0)),
        "radius": (1, 0.5),
        "height": (1, 1.0),
    },
    # half-space: dot(p, normal) - offset (normal need not be unit; it is
    # normalized at eval). Unbounded -> disables the slab cull.
    "plane": {
        "normal": (3, (0.0, 1.0, 0.0)),
        "offset": (1, 0.0),
    },
}
_OP_FIELDS: dict[str, dict[str, tuple[int, Any]]] = {
    "union": {},
    "intersect": {},
    "subtract": {},
    "smooth_union": {"k": (1, 0.5)},
    "shell": {"thickness": (1, 0.05)},
    "transform": {
        "offset": (3, (0.0, 0.0, 0.0)),
        "rotation": (4, (1.0, 0.0, 0.0, 0.0)),  # quat (w, x, y, z)
    },
    "wrap": {"cell": (3, (8.0, 8.0, 8.0))},
}
_UNARY_OPS = ("shell", "transform", "wrap")


def _children(node: dict) -> list[dict]:
    if "prim" in node:
        return []
    if node["op"] in _UNARY_OPS:
        return [node["child"]]
    return list(node["children"])


def _validate(node: dict, path: str = "root") -> None:
    if not isinstance(node, dict):
        raise ValueError(f"{path}: node must be a dict, got {type(node).__name__}")
    if "prim" in node:
        kind = node["prim"]
        if kind not in _PRIM_FIELDS:
            raise ValueError(
                f"{path}: unknown primitive {kind!r}; "
                f"available: {sorted(_PRIM_FIELDS)}"
            )
        fields = _PRIM_FIELDS[kind]
        allowed = {"prim"} | ({"reference_compat"} if kind == "box_skeleton" else set())
        extra = set(node) - set(fields) - allowed
    elif "op" in node:
        kind = node["op"]
        if kind not in _OP_FIELDS:
            raise ValueError(
                f"{path}: unknown operator {kind!r}; available: {sorted(_OP_FIELDS)}"
            )
        fields = _OP_FIELDS[kind]
        if kind in _UNARY_OPS:
            if "child" not in node:
                raise ValueError(f"{path}: operator {kind!r} needs a 'child'")
            extra = set(node) - set(fields) - {"op", "child"}
        else:
            ch = node.get("children")
            if not isinstance(ch, list) or len(ch) < (2 if kind == "subtract" else 1):
                raise ValueError(
                    f"{path}: operator {kind!r} needs a 'children' list"
                    + (" of >= 2 nodes" if kind == "subtract" else "")
                )
            extra = set(node) - set(fields) - {"op", "children"}
    else:
        raise ValueError(f"{path}: node needs a 'prim' or 'op' key")
    if extra:
        raise ValueError(f"{path}: unknown fields {sorted(extra)} for {kind!r}")
    for i, ch in enumerate(_children(node)):
        _validate(ch, f"{path}.children[{i}]")


def _assign_ids(node: dict, out: dict[int, str], counter: list[int]) -> None:
    out[id(node)] = f"n{counter[0]}"
    counter[0] += 1
    for ch in _children(node):
        _assign_ids(ch, out, counter)


def _fields_of(node: dict) -> dict[str, tuple[int, Any]]:
    return _PRIM_FIELDS[node["prim"]] if "prim" in node else _OP_FIELDS[node["op"]]


#: (kind, field) pairs whose spec value must be strictly positive: a zero
#: here is not a degenerate shape but a NaN factory (smooth_min divides by
#: k; wrap takes mod cell)
_MUST_BE_POSITIVE = {("smooth_union", "k"), ("wrap", "cell")}


def _collect_params(node: dict, ids: dict[int, str], params: dict, device) -> None:
    nid = ids[id(node)]
    kind = node.get("prim") or node["op"]
    for field, (length, default) in _fields_of(node).items():
        raw = node.get(field, default)
        arr = np.asarray(raw, np.float32)
        want = () if length == 1 else (length,)
        if arr.shape != want:
            raise ValueError(
                f"{nid} ({kind}).{field}: "
                f"expected shape {want or 'scalar'}, got {arr.shape}"
            )
        if (kind, field) in _MUST_BE_POSITIVE and not (arr > 0).all():
            raise ValueError(
                f"{nid} ({kind}).{field} must be strictly positive, got "
                f"{raw!r} — a zero produces NaN (smooth_min divides by k; "
                "wrap takes mod cell)"
            )
        params[f"{nid}_{field}"] = torch.tensor(arr, device=device)
    for ch in _children(node):
        _collect_params(ch, ids, params, device)


def _sd_capsule_c(x, y, z, a, b, radius):
    """Component-form capsule (segment [a, b] minus radius); safe at a == b."""
    a = _vec3(a)
    b = _vec3(b)
    sx, sy, sz = b[0] - a[0], b[1] - a[1], b[2] - a[2]
    rx, ry, rz = x - a[0], y - a[1], z - a[2]
    l2 = sdf.maximum(sx * sx + sy * sy + sz * sz, 1e-12)
    t = sdf.minimum(sdf.maximum((rx * sx + ry * sy + rz * sz) / l2, 0.0), 1.0)
    dx, dy, dz = rx - t * sx, ry - t * sy, rz - t * sz
    return torch.sqrt(dx * dx + dy * dy + dz * dz) - radius


def _eval(node: dict, get: Callable[[dict, str], Any], x, y, z):
    """Evaluate the spec on coordinate planes; ``get(node, field)`` gives a
    field's param tensor."""
    if "prim" in node:
        kind = node["prim"]
        if kind == "sphere":
            return sdf.sd_sphere_c(x, y, z, get(node, "center"), get(node, "radius"))
        if kind == "box":
            return sdf.sd_box_c(x, y, z, get(node, "center"), get(node, "size"))
        if kind == "capsule":
            return _sd_capsule_c(
                x, y, z, get(node, "start"), get(node, "end"), get(node, "radius")
            )
        if kind == "box_skeleton":
            # reference_compat defaults True, as in the JAX package: the
            # reference's %2 edge-placement bug is the parity default
            return sdf.sd_box_skeleton_c(
                x, y, z,
                get(node, "center"), get(node, "size"), get(node, "line_width"),
                reference_compat=bool(node.get("reference_compat", True)),
            )
        if kind == "torus":
            return sdf.sd_torus_c(
                x, y, z, get(node, "center"),
                get(node, "major_radius"), get(node, "minor_radius"),
            )
        if kind == "cylinder":
            return sdf.sd_cylinder_c(
                x, y, z, get(node, "center"),
                get(node, "radius"), get(node, "height"),
            )
        if kind == "plane":
            n = _vec3(get(node, "normal"))
            inv = torch.rsqrt(sdf.maximum(n[0] * n[0] + n[1] * n[1] + n[2] * n[2], 1e-24))
            return (x * n[0] + y * n[1] + z * n[2]) * inv - get(node, "offset")
        raise AssertionError(kind)

    op = node["op"]
    if op in ("union", "smooth_union", "intersect"):
        ds = [_eval(ch, get, x, y, z) for ch in node["children"]]
        out = ds[0]
        for d in ds[1:]:
            if op == "union":
                out = sdf.minimum(out, d)
            elif op == "intersect":
                out = sdf.maximum(out, d)
            else:
                out = sdf.smooth_min(out, d, get(node, "k"))
        return out
    if op == "subtract":
        ds = [_eval(ch, get, x, y, z) for ch in node["children"]]
        out = ds[0]
        for d in ds[1:]:
            out = sdf.maximum(out, -d)
        return out
    if op == "shell":
        return sdf.abs_(_eval(node["child"], get, x, y, z)) - get(node, "thickness")
    if op == "transform":
        off = _vec3(get(node, "offset"))
        x, y, z = x - off[0], y - off[1], z - off[2]
        x, y, z = _quat_inv_rotate_c(get(node, "rotation"), x, y, z)
        return _eval(node["child"], get, x, y, z)
    if op == "wrap":
        cell = _vec3(get(node, "cell"))
        hx, hy, hz = cell[0] * 0.5, cell[1] * 0.5, cell[2] * 0.5
        wx = -hx + sdf.mod(x + hx, cell[0])
        wy = -hy + sdf.mod(y + hy, cell[1])
        wz = -hz + sdf.mod(z + hz, cell[2])
        return _eval(node["child"], get, wx, wy, wz)
    raise AssertionError(op)


class ComposedCsdf:
    """A composed scene's component form, ``f(params, x, y, z)``: the spec
    tree (``Scene.spec``: the root and the node ids) evaluated by
    :func:`_eval` from the parameter values at call time. Kernels K4 and K5
    run it as a parameter program (``ops/cuda/csdf.py::param_program``)."""

    def __init__(self, spec: dict):
        self.spec = spec

    def __call__(self, params, x, y, z) -> torch.Tensor:
        ids = self.spec["ids"]
        return _eval(self.spec["root"], lambda node, field: params[f"{ids[id(node)]}_{field}"],
                     x, y, z)


def compose_scene(spec: dict, *, name: str | None = None,
                  device: torch.device | str = "cuda") -> Scene:
    """A :class:`~bsdmg_tpu_torch.models.scenes.Scene` from a spec dict,
    its params on ``device``.

    Every numeric field becomes a ``params`` entry keyed ``n<i>_<field>``
    (DFS preorder), so the scene works with the differentiable render and
    ``fit``. ``Scene.spec`` carries the tree and the node ids, for the
    kernels' node program (``ops/cuda/csdf.py``) and the bounds."""
    root = spec["root"] if "root" in spec else spec
    _validate(root)
    ids: dict[int, str] = {}
    _assign_ids(root, ids, [0])
    params: dict = {}
    _collect_params(root, ids, params, device)
    tree = {"root": root, "ids": ids}
    cfn = ComposedCsdf(tree)

    def fn(q, p):
        return cfn(q, p[..., 0], p[..., 1], p[..., 2])

    scene_name = name or spec.get("name", "composed")
    return Scene(scene_name, fn, params, csdf=cfn, spec=tree)


def load_scene_spec(path: str | Path, *, device: torch.device | str = "cuda") -> Scene:
    """Load a JSON scene spec file into a Scene with its params on ``device``."""
    spec = json.loads(Path(path).read_text())
    return compose_scene(spec, name=spec.get("name", Path(path).stem), device=device)


# ---------------------------------------------------------------------------
# bounds (ops/cuda/csdf.py::scene_bounds reads them)
# ---------------------------------------------------------------------------


def resolver(scene: Scene, params):
    """``(root, get)``: the spec's root and a field resolver that gives the
    field's value in ``params`` as Python floats (float64), as the JAX
    package's ``_resolver`` does."""
    root = scene.spec["root"]
    ids = scene.spec["ids"]

    def get(node, field):
        v = params[f"{ids[id(node)]}_{field}"]
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        v = np.asarray(v, np.float64)
        if v.shape == ():
            return float(v)
        return tuple(float(u) for u in v)

    return root, get


def _node_bounds(node: dict, get) -> tuple[np.ndarray, np.ndarray, float] | None:
    """(lo, hi, slack) satisfying the slab-cull contract, or None (unbounded).

    Contract (``_slab_cull``): the surface lies inside [lo, hi] and
    ``f(p) >= d(p, box) - slack`` everywhere.
    """
    if "prim" in node:
        kind = node["prim"]
        if kind == "sphere":
            c = np.asarray(get(node, "center"))
            r = float(get(node, "radius"))
            return c - r, c + r, 1e-3
        if kind == "box":
            c = np.asarray(get(node, "center"))
            h = np.asarray(get(node, "size")) / 2.0
            return c - h, c + h, 1e-3
        if kind == "capsule":
            a = np.asarray(get(node, "start"))
            b = np.asarray(get(node, "end"))
            r = float(get(node, "radius"))
            return np.minimum(a, b) - r, np.maximum(a, b) + r, 1e-3
        if kind == "box_skeleton":
            starts, ends = sdf._box_skeleton_edges(
                np.asarray(get(node, "center")),
                np.asarray(get(node, "size")),
                bool(node.get("reference_compat", True)),
            )
            pts = np.concatenate([starts.numpy(), ends.numpy()], axis=0)
            lw = float(get(node, "line_width"))
            return pts.min(axis=0) - lw, pts.max(axis=0) + lw, 1e-3
        if kind == "torus":
            c = np.asarray(get(node, "center"))
            reach = np.asarray(
                [
                    float(get(node, "major_radius")) + float(get(node, "minor_radius")),
                    float(get(node, "minor_radius")),
                    float(get(node, "major_radius")) + float(get(node, "minor_radius")),
                ]
            )
            return c - reach, c + reach, 1e-3
        if kind == "cylinder":
            c = np.asarray(get(node, "center"))
            r = float(get(node, "radius"))
            h = float(get(node, "height")) / 2.0
            reach = np.asarray([r, h, r])
            return c - reach, c + reach, 1e-3
        if kind == "plane":
            return None  # a half-space is unbounded
        raise AssertionError(kind)

    op = node["op"]
    if op in ("union", "smooth_union"):
        parts = [_node_bounds(ch, get) for ch in node["children"]]
        if any(p is None for p in parts):
            return None
        lo = np.min([p[0] for p in parts], axis=0)
        hi = np.max([p[1] for p in parts], axis=0)
        slack = max(p[2] for p in parts)
        if op == "smooth_union":
            # each smooth_min in the sequential fold undershoots min by up
            # to k/6; n children chain n-1 folds
            slack += (len(parts) - 1) * float(get(node, "k")) / 6.0
        return lo, hi, slack
    if op == "subtract":
        # the zero set lies inside the base child's shape, and f >= d_base:
        # the base child's box is the sound bound
        return _node_bounds(node["children"][0], get)
    if op == "intersect":
        # f >= d_j for every child j: any bounded child's box is sound (the
        # intersection of the boxes is not); the first bounded child's
        for ch in node["children"]:
            b = _node_bounds(ch, get)
            if b is not None:
                return b
        return None
    if op == "shell":
        inner = _node_bounds(node["child"], get)
        if inner is None:
            return None
        t = float(get(node, "thickness"))
        return inner[0] - t, inner[1] + t, inner[2]
    if op == "transform":
        inner = _node_bounds(node["child"], get)
        if inner is None:
            return None
        lo, hi, slack = inner
        off = np.asarray(get(node, "offset"))
        q = np.asarray(get(node, "rotation"), np.float64)
        q = q / np.linalg.norm(q)
        w, qx, qy, qz = q
        rot = np.array(
            [
                [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - w * qz), 2 * (qx * qz + w * qy)],
                [2 * (qx * qy + w * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - w * qx)],
                [2 * (qx * qz - w * qy), 2 * (qy * qz + w * qx), 1 - 2 * (qx * qx + qy * qy)],
            ]
        )
        corners = np.array(
            [[(lo[0], hi[0])[i], (lo[1], hi[1])[j], (lo[2], hi[2])[k]]
             for i in (0, 1) for j in (0, 1) for k in (0, 1)]
        )
        moved = corners @ rot.T + off
        return moved.min(axis=0), moved.max(axis=0), slack
    if op == "wrap":
        return None  # periodic repetition is unbounded
    raise AssertionError(op)


def composed_bounds(scene: Scene, params=None):
    """Conservative scene AABB for the slab cull, ``((lo), (hi), slack)``,
    or None for an unbounded scene."""
    p = scene.params if params is None else params
    root, get = resolver(scene, p)
    out = _node_bounds(root, get)
    if out is None:
        return None
    lo, hi, slack = out
    return (tuple(map(float, lo)), tuple(map(float, hi)), float(slack))
