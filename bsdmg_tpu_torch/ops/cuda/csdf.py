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
the wireframe and the object transform; the sphere, the box and the
mandelbulb; the reference object wrapped on a lattice.

The built-in scenes compile (:data:`SUPPORTED`), and so does a composed
scene (``models/compose.py``): its spec flattens into a node program
(:func:`node_program`) that the kernels' ``Composed`` structure
interprets (``csrc/composed.cuh``) and :func:`descriptor_csdf` and
:func:`descriptor_csdf_value_and_grad` interpret in plain PyTorch, with
the constants JAX's baked lowering forms. A mesh asset's baked grid
compiles to a grid descriptor (:func:`grid_descriptor`) that only the mesh
kernels K6 and K7 take, in the two forms the JAX package evaluates a grid
in. Any other scene raises ``NotImplementedError``. The sphere's and the
box's gradients are JAX's
reverse mode, as the reference scenes' are, and so NaN where JAX's is (the
box's inside, where ``sqrt``'s weight ``0.5 / 0`` meets a zero); the
mandelbulb's is forward mode through its 25-iteration loop, as the kernels
take it (a loop that leaves at the escape; JAX's reverse mode through its
masked iterations differs in rounding, and is NaN at more points).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from bsdmg_tpu_torch.models.mesh_sdf import SdfGrid, box_f32
from bsdmg_tpu_torch.models.scenes import FRAME_LINE_WIDTH, Scene
from bsdmg_tpu_torch.sdf.primitives import (
    MANDELBULB_ITERS,
    MANDELBULB_POWER,
    _box_skeleton_edges,
    sd_mandelbulb_c,
)

CSdf = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]

#: the mandelbulb's radius floor (primitives.py _SAFE_EPS) as a float32 value
_SAFE_EPS_F32 = float(np.float32(1e-12))

#: scenes this compiler lowers
SUPPORTED = (
    "reference_object", "reference_render_scene", "sphere", "box", "mandelbulb", "wrapped_object",
)

#: kernel_structure's indices of the other built-in scenes, of a composed
#: scene's node program in the small tier, of the wrapped object moved by
#: its object transform and of a node program in the large tier
#: (with_structure in csrc/scene_sdf.cuh); 0-3 are the reference scenes'
#: Box<Frame, Transform>
SPHERE, SOLID_BOX, MANDELBULB, WRAPPED, COMPOSED, WRAPPED_MOVED, COMPOSED_LARGE = (
    4, 5, 6, 7, 8, 11, 12)

#: kernel_structure's indices of a mesh asset's grid in its two forms
#: (with_mesh_structure in csrc/scene_sdf.cuh, which only K6 and K7 use):
#: "lerp", the points-form grid_sdf that ``cli mesh`` meshes, and
#: "weights", the component-form grid_csdf that ``cli remesh`` meshes
GRID_FORMS = {"lerp": 9, "weights": 10}

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


# ---------------------------------------------------------------------------
# a composed scene's node program
# ---------------------------------------------------------------------------

#: the node program's opcodes (csrc/scene_sdf.cuh Op): the 7 primitives, the
#: 7 operators as folds (union MIN, intersect MAX, subtract SUB, smooth_union
#: SMOOTH), shell, and the push and pop of a coordinate frame (transform,
#: wrap)
(OP_SPHERE, OP_BOX, OP_CAPSULE, OP_SKELETON, OP_TORUS, OP_CYLINDER, OP_PLANE, OP_MIN, OP_MAX,
 OP_SUB, OP_SMOOTH, OP_SHELL, OP_PUSH_TRANSFORM, OP_PUSH_WRAP, OP_POP) = range(15)
#: 32-bit words per instruction: opcode, operand index, 14 float32 constants
PROGRAM_WORDS = 16
PROGRAM_CONSTANTS = PROGRAM_WORDS - 2
#: the caps of the interpreters' small tier (csrc/program.cuh BSDMG_PROGRAM,
#: BSDMG_STACK, BSDMG_FRAMES): instructions, values on the stack at once,
#: nested coordinate frames; and of its parameter vector (csrc/param_sdf.cuh
#: BSDMG_MAX_PARAMS). A program beyond any of them runs in the large tier
#: (:func:`large_tier`), which has none. The three example scenes take at
#: most 10 instructions, 3 values and 1 frame. The forward walk of K1, K2
#: and K3 (:func:`walk_words`) keeps no tape, so PROGRAM_CAP does not bind
#: it; each block stages its words in shared memory, WALK_CAP of them
#: (csrc/composed.cuh BSDMG_WALK_WORDS, 32 KB).
PROGRAM_CAP = 64
STACK_CAP = 16
FRAME_CAP = 8
PARAM_CAP = 64
WALK_CAP = 8192
#: a forward-walk primitive's action on the value on top of the stack (its
#: header's bits 4-7; a fold's opcode there folds into it): the first value
#: of the stack, or a push of the top below it
WALK_SET, WALK_PUSH = 0, 1

_PRIMITIVE_OPS = {"sphere": OP_SPHERE, "box": OP_BOX, "capsule": OP_CAPSULE,
                  "box_skeleton": OP_SKELETON, "torus": OP_TORUS, "cylinder": OP_CYLINDER,
                  "plane": OP_PLANE}
_FOLD_OPS = {"union": OP_MIN, "intersect": OP_MAX, "subtract": OP_SUB, "smooth_union": OP_SMOOTH}


class Instruction(NamedTuple):
    """One node-program instruction: ``op``, ``arg`` (a fold's left operand:
    the index of the instruction that computed it; a pop's push) and the
    float32 ``constants`` (Python floats)."""

    op: int
    arg: int
    constants: tuple


def _rsqrt_f32(v: float) -> float:
    """``jax.lax.rsqrt`` of float32 ``max(v, 1e-24)`` in float32: the
    correctly rounded reciprocal square root of the float32 argument, as
    XLA's rsqrt gives it on these constants."""
    a = np.float32(max(np.float32(v), np.float32(1e-24)))
    return f32(1.0 / np.sqrt(np.float64(a)))


def _primitive_constants(kind: str, node: dict, get) -> tuple:
    """A primitive's constants as JAX's baked lowering forms them
    (``composed_baked_csdf``): each field a float64 Python value, arithmetic
    among them in float64, rounded to float32 where it meets a plane."""
    if kind == "sphere":
        return (*map(f32, get(node, "center")), f32(get(node, "radius")))
    if kind == "box":
        return (*map(f32, get(node, "center")), *(f32(v * 0.5) for v in get(node, "size")))
    if kind == "capsule":
        a, b = get(node, "start"), get(node, "end")
        seg = [bv - av for av, bv in zip(a, b)]
        l2 = max(np.float32(seg[0] * seg[0] + seg[1] * seg[1] + seg[2] * seg[2]),
                 np.float32(1e-12))
        return (*map(f32, a), *map(f32, seg), float(l2), f32(get(node, "radius")))
    if kind == "box_skeleton":
        c, sz = get(node, "center"), get(node, "size")
        compat = bool(node.get("reference_compat", True))
        lo = [f32(cv - sv / 2.0) for cv, sv in zip(c, sz)]
        s1 = [sz[(d + 1) % 2] if compat else sz[(d + 1) % 3] for d in range(3)]
        return (*lo, *map(f32, sz), *map(f32, s1), f32(get(node, "line_width")))
    if kind == "torus":
        return (*map(f32, get(node, "center")), f32(get(node, "major_radius")),
                f32(get(node, "minor_radius")))
    if kind == "cylinder":
        return (*map(f32, get(node, "center")), f32(get(node, "radius")),
                f32(get(node, "height") * 0.5))
    if kind == "plane":
        n = get(node, "normal")
        inv = _rsqrt_f32(n[0] * n[0] + n[1] * n[1] + n[2] * n[2])
        return (*map(f32, n), inv, f32(get(node, "offset")))
    raise AssertionError(kind)


def _rotation_f32(q) -> tuple:
    """``models/scenes.py::_quat_inv_rotate_c``'s ``r00 ... r22`` of the
    float64 quaternion ``q`` as JAX forms them: the norm squared in
    float64, its rsqrt in float32, then every product and sum in float32,
    row-major."""
    inv = np.float32(_rsqrt_f32(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]))
    w, x, y, z = (np.float32(v) * inv for v in q)
    one, two = np.float32(1.0), np.float32(2.0)
    r = ((one - two * (y * y + z * z), two * (x * y - w * z), two * (x * z + w * y)),
         (two * (x * y + w * z), one - two * (x * x + z * z), two * (y * z - w * x)),
         (two * (x * z - w * y), two * (y * z + w * x), one - two * (x * x + y * y)))
    return tuple(float(v) for row in r for v in row)


def postfix(root: dict) -> list[tuple[int, dict, int]]:
    """A spec's nodes in the programs' postfix order, as ``(op, node,
    arg)``: a primitive; a fold after its right operand, ``arg`` the index
    of its left operand's last entry (left to right, as the JAX package
    folds); shell after its child; transform and wrap as a push before their
    child and a pop after it, the pop's ``arg`` its push. The one walk that
    :func:`node_program` and :func:`param_program` share."""
    out: list[tuple[int, dict, int]] = []

    def walk(node: dict) -> None:
        if "prim" in node:
            out.append((_PRIMITIVE_OPS[node["prim"]], node, -1))
            return
        op = node["op"]
        if op in _FOLD_OPS:
            children = node["children"]
            walk(children[0])
            for child in children[1:]:
                left = len(out) - 1
                walk(child)
                out.append((_FOLD_OPS[op], node, left))
            return
        if op == "shell":
            walk(node["child"])
            out.append((OP_SHELL, node, -1))
            return
        push = len(out)
        out.append((OP_PUSH_TRANSFORM if op == "transform" else OP_PUSH_WRAP, node, -1))
        walk(node["child"])
        out.append((OP_POP, node, push))

    walk(root)
    return out


def node_program(scene: Scene, params) -> tuple[Instruction, ...]:
    """Flatten a composed scene's spec into its postfix node program at
    ``params`` (:func:`postfix`): a primitive pushes its value, a fold pops
    two values and pushes one, shell maps the top; transform and wrap push a
    coordinate frame before their child and pop it after. Any length,
    stack depth and nesting: :func:`large_tier` picks the kernels' tier."""
    from bsdmg_tpu_torch.models.compose import resolver

    root, get = resolver(scene, params)

    def constants(op: int, node: dict) -> tuple:
        if op <= OP_PLANE:
            return _primitive_constants(node["prim"], node, get)
        if op == OP_SMOOTH:
            return (f32(get(node, "k")), f32(1.0 / 6.0))
        if op == OP_SHELL:
            return (f32(get(node, "thickness")),)
        if op == OP_PUSH_TRANSFORM:
            return (*map(f32, get(node, "offset")), *_rotation_f32(get(node, "rotation")))
        if op == OP_PUSH_WRAP:
            cell = get(node, "cell")
            return (*map(f32, cell), *(f32(v * 0.5) for v in cell))
        return ()

    return tuple(Instruction(op, arg, constants(op, node)) for op, node, arg in postfix(root))


def large_tier(prog, n_values: int = 0, *, forward: bool = False) -> bool:
    """Whether a node or parameter program (with ``n_values`` parameter
    values) runs in the kernels' large tier: beyond any cap of the small
    tier (:data:`PROGRAM_CAP`, :data:`STACK_CAP`, :data:`FRAME_CAP`,
    :data:`PARAM_CAP`). With ``forward``, a node program's forward walk
    alone (K1, K2, K3: no tape, so no length cap): beyond the stack's or
    the frames' cap, or words beyond the :data:`WALK_CAP` that a block
    stages in shared memory. The one place the tier is chosen."""
    depth, frames = program_depths(prog)
    if depth > STACK_CAP or frames > FRAME_CAP:
        return True
    if forward:
        return len(walk_words(prog)) > WALK_CAP
    return len(prog) > PROGRAM_CAP or n_values > PARAM_CAP


def program_slots(length: int, depth: int, frames: int, *, grad: bool = False) -> int:
    """Floats of the large tier's scratch a thread takes for a node program
    of ``length`` instructions, ``depth`` values on the stack and ``frames``
    nested frames at once (:func:`program_depths`): its stack and frames (3
    a frame), and with ``grad`` its tape, cotangents and the backward's
    frames (6 a frame), csrc/composed.cuh's layout. (K4 and K5 size a
    parameter program's themselves, csrc/diff_kernel.cu program_scratch.)"""
    return depth + 3 * frames + ((length + depth + 6 * frames) if grad else 0)


def program_depths(prog) -> tuple[int, int]:
    """The most values on the stack and the most nested frames at once."""
    depth = frames = most = most_frames = 0
    for ins in prog:
        if ins.op <= OP_PLANE:
            depth += 1
        elif ins.op <= OP_SMOOTH:
            depth -= 1
        elif ins.op in (OP_PUSH_TRANSFORM, OP_PUSH_WRAP):
            frames += 1
        elif ins.op == OP_POP:
            frames -= 1
        most, most_frames = max(most, depth), max(most_frames, frames)
    return most, most_frames


def program_words(prog) -> np.ndarray:
    """The program as the kernels read it: ``(n, PROGRAM_WORDS)`` int32,
    each row the opcode, the operand index and the constants' float32 bits."""
    words = np.zeros((len(prog), PROGRAM_WORDS), np.int32)
    for i, ins in enumerate(prog):
        words[i, 0], words[i, 1] = ins.op, ins.arg
        consts = np.asarray(ins.constants, np.float32)
        words[i, 2:2 + len(consts)] = consts.view(np.int32)
    return words


def walk_words(prog) -> np.ndarray:
    """The node program's forward walk as K1, K2 and K3 read it from shared
    memory (csrc/composed.cuh composed_sdf): int32 words, an instruction a
    header (opcode in bits 0-3, action in 4-7, its words in 8-31) and the
    float32 bits of the constants it uses. The value on top of the stack
    lives in a register: a fold whose right operand is one
    primitive, inside any frames, is fused into that primitive (its action
    the fold's opcode, a smooth union's two constants after the
    primitive's), which folds its value into the top as ``fold(top,
    value)``, the fold's operand order; any other primitive sets the top
    (the stack empty: :data:`WALK_SET`) or pushes the top below it
    (:data:`WALK_PUSH`), and a fold left unfused pops its left operand.
    Shell, push and pop as in the node program, with the constants they
    use."""
    fused = {}  # a primitive's index: the index of the fold fused into it
    frames = (OP_PUSH_TRANSFORM, OP_PUSH_WRAP, OP_POP)
    for i, ins in enumerate(prog):
        if OP_MIN <= ins.op <= OP_SMOOTH:
            right = range(ins.arg + 1, i)
            prims = [j for j in right if prog[j].op <= OP_PLANE]
            if len(prims) == 1 and all(prog[j].op in frames for j in right if j != prims[0]):
                fused[prims[0]] = i
    words, depth = [], 0
    for i, ins in enumerate(prog):
        consts, action = ins.constants, 0
        if ins.op <= OP_PLANE:
            if i in fused:
                fold = prog[fused[i]]
                action, consts = fold.op, consts + fold.constants
            else:
                action, depth = WALK_SET if depth == 0 else WALK_PUSH, depth + 1
        elif ins.op <= OP_SMOOTH:
            if i in fused.values():
                continue
            depth -= 1
        words.append(ins.op | action << 4 | (1 + len(consts)) << 8)
        words.extend(np.asarray(consts, np.float32).view(np.int32).tolist())
    return np.asarray(words, np.int32)


class NodeProgram:
    """A composed scene's node program: the instructions, which the plain
    twins interpret, the words the kernels read (the taped walk's rows of
    :data:`PROGRAM_WORDS`, then the forward walk's :func:`walk_words`),
    uploaded to each CUDA device once and kept here (the descriptor owns the
    buffer)."""

    def __init__(self, instructions: tuple[Instruction, ...]):
        self.instructions = instructions
        self.words = program_words(instructions)
        self.walk = walk_words(instructions)
        self._on_device: dict = {}

    def __len__(self) -> int:
        return len(self.instructions)

    def on_device(self, device: torch.device | str = "cuda") -> torch.Tensor:
        """The words, the rows and then the walk, as one int32 tensor on the
        CUDA ``device`` ("cuda": the current one)."""
        device = torch.device(device)
        if device.index is None:
            device = torch.device(device.type, torch.cuda.current_device())
        if device not in self._on_device:
            words = np.concatenate([self.words.reshape(-1), self.walk])
            self._on_device[device] = torch.from_numpy(words).to(device)
        return self._on_device[device]


@dataclasses.dataclass(frozen=True)
class SceneDescriptor:
    """One built-in scene, ready for the kernels.

    ``kind`` is ``"reference"`` (the reference object or render scene),
    ``"wrapped"`` (the reference object on a lattice of period ``cell``),
    ``"sphere"`` (radius ``sphere_radius``), ``"box"`` (half extents
    ``box_half``), ``"composed"`` (a composed scene: its node
    ``program``), ``"mandelbulb"`` (``scale``: the JAX compiler's
    ``float(scale) * 0.4``, by which the points are divided and the
    distance multiplied) or ``"grid"`` (a mesh asset's baked ``grid``,
    interpolated in ``grid_form`` "lerp" or "weights", each point moved by
    ``offset`` first where it is not None). For the reference object,
    ``object`` is the box
    skeleton of ``sd_obj``, ``frame`` the bounding-box wireframe of the
    render scene (None for the object alone), ``inv_rotation`` (rows of
    R^T) and ``translation`` the object transform, None when it is the
    identity. ``bounds`` is ``(lo, hi, slack)`` from :func:`scene_bounds`,
    None for an unbounded scene. Floats are float32 values."""

    object: CapsuleSet | None
    frame: CapsuleSet | None
    sphere_radius: float
    smooth_k: float
    inv_k: float
    k_6: float
    inv_rotation: tuple[tuple[float, float, float], ...] | None
    translation: tuple[float, float, float] | None
    bounds: tuple | None
    kind: str = "reference"
    box_half: tuple[float, float, float] | None = None
    scale: float | None = None
    cell: float | None = None
    program: NodeProgram | None = None
    grid: SdfGrid | None = None
    grid_form: str = "lerp"
    offset: tuple[float, float, float] | None = None


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
    if scene.name not in SUPPORTED and scene.spec is None and scene.grid is None:
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


def scene_bounds(scene: Scene, params=None) -> tuple | None:
    """Conservative AABB of the scene surface as ``((lx,ly,lz), (hx,hy,hz),
    slack)`` (csdf.py::scene_bounds), None for the unbounded wrapped object.
    ``slack`` bounds the SDF's under-estimation (the reference object's
    smooth-min k/6 + 1e-3, the exact sphere's and box's 1e-3, the
    mandelbulb's 0.1); the slab cull's margin needs it to stay sound."""
    _check_supported(scene)
    if scene.grid is not None:
        return None  # a grid renders through ops/cuda/grid_kernel.py, which culls nothing
    p = _host(scene.params if params is None else params)
    if scene.spec is not None:
        from bsdmg_tpu_torch.models.compose import composed_bounds

        return composed_bounds(scene, p)
    if scene.name == "sphere":
        r = float(p["radius"]) + 1e-3
        return ((-r, -r, -r), (r, r, r), 1e-3)
    if scene.name == "box":
        half = np.asarray(p["size"], np.float64) / 2.0 + 1e-3
        return (tuple(map(float, -half)), tuple(map(float, half)), 1e-3)
    if scene.name == "mandelbulb":
        r = 1.25 * float(p["scale"]) + 1e-3
        return ((-r, -r, -r), (r, r, r), 0.1)
    if scene.name == "wrapped_object":
        return None
    lo, hi = _reference_object_bounds(p, scene.reference_compat)
    slack = float(p["smooth_k"]) / 6.0 + 1e-3
    if scene.name == "reference_render_scene":
        half = scene.bb_size / 2.0
        lo = np.minimum(lo, -half - FRAME_LINE_WIDTH - 1e-3)
        hi = np.maximum(hi, half + FRAME_LINE_WIDTH + 1e-3)
    return (tuple(map(float, lo)), tuple(map(float, hi)), slack)


def _reference_fields(scene: Scene, p: dict[str, np.ndarray]) -> dict:
    """The reference object's descriptor fields (and the render scene's
    wireframe)."""
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
    return dict(
        object=obj,
        frame=frame,
        sphere_radius=f32(p["sphere_radius"]),
        smooth_k=f32(k),
        inv_k=f32(1.0 / k),
        k_6=f32(k / 6.0),
        inv_rotation=inv_rotation,
        translation=translation,
    )


def grid_descriptor(grid: SdfGrid, form: str = "lerp", offset=None) -> SceneDescriptor:
    """A mesh asset's baked ``grid`` as the mesh kernels take it: ``form``
    "lerp" is ``grid_sdf`` (``bsdmg_tpu/models/mesh_sdf.py:193-245``, which
    ``cli mesh`` meshes through ``as_component``), "weights" is
    ``grid_csdf`` (:248-289, ``cli remesh``'s); ``offset`` (three floats,
    rounded to float32) is added to each point first, as ``cli remesh``
    shifts the field by the grid's centre."""
    if form not in GRID_FORMS:
        raise ValueError(f"grid form must be one of {sorted(GRID_FORMS)}, got {form!r}")
    return SceneDescriptor(
        object=None, frame=None, sphere_radius=0.0, smooth_k=0.0, inv_k=0.0, k_6=0.0,
        inv_rotation=None, translation=None, bounds=None, kind="grid", grid=grid,
        grid_form=form, offset=None if offset is None else tuple(f32(v) for v in offset),
    )


def compile_scene(scene: Scene, params=None) -> SceneDescriptor:
    """Lower a built-in scene, with ``params`` (default: the scene's own),
    to a :class:`SceneDescriptor`, with the constants of the JAX compiler
    (csdf.py::compile_scene_csdf); a mesh asset to its grid in the "lerp"
    form (:func:`grid_descriptor`), which ``params`` do not enter."""
    _check_supported(scene)
    if scene.grid is not None:
        return grid_descriptor(scene.grid)
    p = _host(scene.params if params is None else params)
    bounds = scene_bounds(scene, params)
    empty = dict(object=None, frame=None, sphere_radius=0.0, smooth_k=0.0, inv_k=0.0, k_6=0.0,
                 inv_rotation=None, translation=None, bounds=bounds)
    if scene.spec is not None:
        return SceneDescriptor(**empty, kind="composed", program=NodeProgram(node_program(scene, p)))
    if scene.name == "sphere":
        return SceneDescriptor(**{**empty, "sphere_radius": f32(p["radius"])}, kind="sphere")
    if scene.name == "box":
        half = tuple(f32(float(v) * 0.5) for v in np.broadcast_to(p["size"], (3,)))
        return SceneDescriptor(**empty, kind="box", box_half=half)
    if scene.name == "mandelbulb":
        return SceneDescriptor(**empty, kind="mandelbulb", scale=f32(float(p["scale"]) * 0.4))
    if scene.name == "wrapped_object":
        return SceneDescriptor(**_reference_fields(scene, p), bounds=None, kind="wrapped",
                               cell=f32(p["cell"]))
    return SceneDescriptor(**_reference_fields(scene, p), bounds=bounds)


def compile_scene_split(scene: Scene, params=None):
    """The near/far split of a scene, ``(far, (lo, hi, slack))``, or None
    for a scene without one (csdf.py::compile_scene_split): for the
    reference render scene, ``far`` is a descriptor (``kind="wireframe"``)
    of the frame wireframe alone, ``box_skeleton`` at 0 of size 5.0 and
    line width 0.05 with ``reference_compat=True``, and the bounds are the
    object's, slack ``smooth_k/6 + 1e-3``. A patch of rays that all miss
    the (caller-inflated) near box marches ``far`` alone
    (csrc/render_kernel.cu march_split; K4/K5 march the parameter form's
    wireframe, csrc/diff_kernel.cu)."""
    _check_supported(scene)
    if scene.name != "reference_render_scene" or scene.spec is not None:
        return None
    p = _host(scene.params if params is None else params)
    far = SceneDescriptor(
        object=None, frame=box_skeleton_set(np.zeros(3), np.full(3, 5.0), 0.05),
        sphere_radius=0.0, smooth_k=0.0, inv_k=0.0, k_6=0.0, inv_rotation=None,
        translation=None, bounds=None, kind="wireframe",
    )
    lo, hi = _reference_object_bounds(p, True)
    slack = float(p["smooth_k"]) / 6.0 + 1e-3
    return far, (tuple(map(float, lo)), tuple(map(float, hi)), slack)


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


def _reference_csdf(desc: SceneDescriptor) -> CSdf:
    """The reference scenes' SDF (csdf.py::reference_render_scene_csdf)."""
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


def _wrap_coord(v, half: float, cell: float):
    """``-half + jnp.mod(v + half, cell)`` (the wrap of signed_distance.cu:9-18)."""
    return -half + torch.remainder(v + half, cell)


def _wrapped(desc: SceneDescriptor, inner):
    """``inner`` on the lattice coordinates of ``desc.cell``; a gradient
    passes the wrap unchanged."""
    cell = desc.cell
    half = f32(cell / 2.0)

    def f(x, y, z):
        return inner(_wrap_coord(x, half, cell), _wrap_coord(y, half, cell),
                     _wrap_coord(z, half, cell))

    return f


def _box_csdf(desc: SceneDescriptor) -> CSdf:
    """csdf.py::box_csdf, centred at the origin: sd_box_c."""
    hx, hy, hz = desc.box_half

    def f(x, y, z):
        qx, qy, qz = torch.abs(x) - hx, torch.abs(y) - hy, torch.abs(z) - hz
        ox, oy, oz = (torch.clamp_min(q, 0.0) for q in (qx, qy, qz))
        outside = torch.sqrt(ox * ox + oy * oy + oz * oz)
        return outside + torch.clamp_max(torch.maximum(qx, torch.maximum(qy, qz)), 0.0)

    return f


# ---------------------------------------------------------------------------
# the node program's interpreter (csrc/scene_sdf.cuh composed_sdf and
# composed_sdf_grad), in plain PyTorch
# ---------------------------------------------------------------------------


def _div(a: torch.Tensor, k: float) -> torch.Tensor:
    """``a / k`` as a true float32 division on every device (a Python
    divisor makes a CUDA tensor multiply by its reciprocal)."""
    return a / torch.tensor(k, dtype=a.dtype, device=a.device)


def _frame_coords(ins: Instruction, coords):
    """The child frame's coordinates: a transform's ``x - offset``, then
    the rows of ``R^T`` (``r00*x + r10*y + r20*z``, ...); a wrap's
    ``-half + mod(v + half, cell)`` per axis."""
    k = ins.constants
    if ins.op == OP_PUSH_WRAP:
        return tuple(_wrap_coord(coords[a], k[3 + a], k[a]) for a in range(3))
    tx, ty, tz = (coords[a] - k[a] for a in range(3))
    r = k[3:]
    return tuple((r[a] * tx + r[3 + a] * ty) + r[6 + a] * tz for a in range(3))


def _primitive_value(ins: Instruction, coords):
    """A primitive's value, operation by operation as the JAX package's
    component-form primitive (``sd_sphere_c``, ``sd_box_c``,
    ``_sd_capsule_c``, ``sd_box_skeleton_c``, ``sd_torus_c``,
    ``sd_cylinder_c``, the plane) with baked constants; also the
    intermediates its backward reads."""
    k = ins.constants
    x, y, z = coords
    op = ins.op
    if op == OP_PLANE:
        return ((x * k[0] + y * k[1]) + z * k[2]) * k[3] - k[4], None
    p = (x - k[0], y - k[1], z - k[2])
    if op == OP_SPHERE:
        root = torch.sqrt((p[0] * p[0] + p[1] * p[1]) + p[2] * p[2])
        return root - k[3], (p, root)
    if op == OP_BOX:
        q = [torch.abs(p[a]) - k[3 + a] for a in range(3)]
        o = [torch.clamp_min(v, 0.0) for v in q]
        outside = torch.sqrt((o[0] * o[0] + o[1] * o[1]) + o[2] * o[2])
        m2 = torch.maximum(q[1], q[2])
        m3 = torch.maximum(q[0], m2)
        inside = torch.clamp_max(m3, 0.0)
        return outside + inside, (p, q, o, outside, m2, m3, inside)
    if op == OP_CAPSULE:
        s = k[3:6]
        dot = (p[0] * s[0] + p[1] * s[1]) + p[2] * s[2]
        qv = _div(dot, k[6])
        mx = torch.clamp_min(qv, 0.0)
        t = torch.clamp_max(mx, 1.0)
        d = [p[a] - t * s[a] for a in range(3)]
        root = torch.sqrt((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2])
        return root - k[7], (p, qv, mx, t, d, root)
    if op == OP_SKELETON:
        lo, size, s1 = k[0:3], k[3:6], k[6:9]
        c = (x, y, z)
        axes, best = [], []
        for d in range(3):
            a1, a2 = (d + 1) % 3, (d + 2) % 3
            r = c[d] - lo[d]
            mx = torch.clamp_min(r, 0.0)
            t = torch.clamp_max(mx, size[d])
            e = r - t
            o1 = c[a1] - lo[a1]
            o1b = o1 - s1[d]
            o2 = c[a2] - lo[a2]
            o2b = o2 - size[a2]
            q1, q1b, q2, q2b = o1 * o1, o1b * o1b, o2 * o2, o2b * o2b
            m1, m2 = torch.minimum(q1, q1b), torch.minimum(q2, q2b)
            d2 = (e * e + m1) + m2
            axes.append((r, mx, t, e, o1, o1b, o2, o2b, q1, q1b, q2, q2b, m1, m2, d2))
            best.append(d2 if d == 0 else torch.minimum(best[-1], d2))
        root = torch.sqrt(best[2])
        return root - k[9], (axes, best, root)
    if op == OP_TORUS:
        a = torch.sqrt(p[0] * p[0] + p[2] * p[2])
        ring = a - k[3]
        b = torch.sqrt(ring * ring + p[1] * p[1])
        return b - k[4], (p, a, ring, b)
    if op == OP_CYLINDER:
        a = torch.sqrt(p[0] * p[0] + p[2] * p[2])
        dr = a - k[3]
        dy = torch.abs(p[1]) - k[4]
        ox, oy = torch.clamp_min(dr, 0.0), torch.clamp_min(dy, 0.0)
        mxd = torch.maximum(dr, dy)
        inner = torch.clamp_max(mxd, 0.0)
        root = torch.sqrt(ox * ox + oy * oy)
        return inner + root, (p, a, dr, dy, ox, oy, mxd, inner, root)
    raise AssertionError(op)


def _twice(v):
    """``ct*x + x*ct`` of a square's backward, with ``v = ct * x``."""
    return v + v


def _primitive_bwd(ins: Instruction, coords, ct, acc: list) -> None:
    """Adds ``ct`` times the primitive's gradient to ``acc``, reverse mode
    with JAX's rules: ``sqrt``'s weight ``0.5 / root``, each ``min``/``max``
    splitting its cotangent at a tie (:func:`_tie_weight`), ``abs`` +1 at
    0, every cotangent computed even where it is 0 (so a NaN weight gives a
    NaN, as in ``jax.vjp``)."""
    k = ins.constants
    op = ins.op
    _, f = _primitive_value(ins, coords)
    g = [None, None, None]
    if op == OP_PLANE:
        c = ct * k[3]
        g = [c * k[0], c * k[1], c * k[2]]
    elif op == OP_SPHERE:
        p, root = f
        w = ct * (0.5 / root)
        g = [_twice(w * p[a]) for a in range(3)]
    elif op == OP_BOX:
        p, q, o, outside, m2, m3, inside = f
        ct_m3 = ct * _tie_weight(m3, inside, 0.0)
        ct_m2 = ct_m3 * _tie_weight(m2, m3, q[0])
        ct_in = [ct_m3 * _tie_weight(q[0], m3, m2), ct_m2 * _tie_weight(q[1], m2, q[2]),
                 ct_m2 * _tie_weight(q[2], m2, q[1])]
        w = ct * (0.5 / outside)
        for a in range(3):
            ct_q = _twice(w * o[a]) * _tie_weight(q[a], o[a], 0.0) + ct_in[a]
            g[a] = torch.where(p[a] >= 0.0, ct_q, -ct_q)
    elif op == OP_CAPSULE:
        p, qv, mx, t, d, root = f
        s = k[3:6]
        w = ct * (0.5 / root)
        ct_d = [_twice(w * d[a]) for a in range(3)]
        ct_t = -((ct_d[0] * s[0] + ct_d[1] * s[1]) + ct_d[2] * s[2])
        ct_q = (ct_t * _tie_weight(mx, t, 1.0)) * _tie_weight(qv, mx, 0.0)
        ct_dot = _div(ct_q, k[6])
        g = [ct_d[a] + ct_dot * s[a] for a in range(3)]
    elif op == OP_SKELETON:
        axes, best, root = f
        w = ct * (0.5 / root)
        cts = [None, None, w * _tie_weight(axes[2][-1], best[2], best[1])]
        w = w * _tie_weight(best[1], best[2], axes[2][-1])
        cts[1] = w * _tie_weight(axes[1][-1], best[1], best[0])
        cts[0] = w * _tie_weight(best[0], best[1], axes[1][-1])
        size = k[3:6]
        for d in range(3):
            r, mx, t, e, o1, o1b, o2, o2b, q1, q1b, q2, q2b, m1, m2, _ = axes[d]
            c = cts[d]
            ct_e = _twice(c * e)
            ct_mx = -ct_e * _tie_weight(mx, t, size[d])
            ct_r = ct_e + ct_mx * _tie_weight(r, mx, 0.0)
            ct_o1 = (_twice((c * _tie_weight(q1, m1, q1b)) * o1)
                     + _twice((c * _tie_weight(q1b, m1, q1)) * o1b))
            ct_o2 = (_twice((c * _tie_weight(q2, m2, q2b)) * o2)
                     + _twice((c * _tie_weight(q2b, m2, q2)) * o2b))
            for axis, v in ((d, ct_r), ((d + 1) % 3, ct_o1), ((d + 2) % 3, ct_o2)):
                _add_to_axis(g, axis, v)
    elif op == OP_TORUS:
        p, a, ring, b = f
        wb = ct * (0.5 / b)
        ct_ring = _twice(wb * ring)
        wa = ct_ring * (0.5 / a)
        g = [_twice(wa * p[0]), _twice(wb * p[1]), _twice(wa * p[2])]
    elif op == OP_CYLINDER:
        p, a, dr, dy, ox, oy, mxd, inner, root = f
        w = ct * (0.5 / root)
        ct_ox, ct_oy = _twice(w * ox), _twice(w * oy)
        ct_mxd = ct * _tie_weight(mxd, inner, 0.0)
        ct_dr = ct_mxd * _tie_weight(dr, mxd, dy) + ct_ox * _tie_weight(dr, ox, 0.0)
        ct_dy = ct_mxd * _tie_weight(dy, mxd, dr) + ct_oy * _tie_weight(dy, oy, 0.0)
        wa = ct_dr * (0.5 / a)
        g = [_twice(wa * p[0]), torch.where(p[1] >= 0.0, ct_dy, -ct_dy), _twice(wa * p[2])]
    else:
        raise AssertionError(op)
    for a in range(3):
        acc[a] = acc[a] + g[a]


def _fold_value(ins: Instruction, a, b):
    """A fold's value and the intermediates its backward reads."""
    if ins.op == OP_MIN:
        return torch.minimum(a, b), None
    if ins.op == OP_MAX:
        return torch.maximum(a, b), None
    if ins.op == OP_SUB:
        nb = -b
        return torch.maximum(a, nb), nb
    # smooth_min (sdf/primitives.py smooth_min): h = max(k - |a - b|, 0) / k,
    # min(a, b) - ((h*h*h) * k) * f32(1/6)
    k, c6 = ins.constants
    delta = a - b
    u = k - torch.abs(delta)
    hm = torch.clamp_min(u, 0.0)
    h = _div(hm, k)
    h2 = h * h
    m = torch.minimum(a, b)
    return m - ((h2 * h) * k) * c6, (delta, u, hm, h, h2, m)


def _fold_bwd(ins: Instruction, a, b, out, f, ct):
    """The cotangents of a fold's two operands."""
    if ins.op in (OP_MIN, OP_MAX):
        return ct * _tie_weight(a, out, b), ct * _tie_weight(b, out, a)
    if ins.op == OP_SUB:
        return ct * _tie_weight(a, out, f), -(ct * _tie_weight(f, out, a))
    k, c6 = ins.constants
    delta, u, hm, h, h2, m = f
    ct_h3 = (-ct * c6) * k
    ct_h2 = ct_h3 * h
    ct_h = (h2 * ct_h3 + ct_h2 * h) + h * ct_h2
    ct_u = _div(ct_h, k) * _tie_weight(u, hm, 0.0)
    ct_abs = -ct_u
    ct_delta = torch.where(delta >= 0.0, ct_abs, -ct_abs)  # jax: d|x| = +1 at 0
    return ct * _tie_weight(a, m, b) + ct_delta, ct * _tie_weight(b, m, a) - ct_delta


def _program_forward(prog, x, y, z):
    """Runs the program; returns the value of every instruction (a pop's
    is its frame's value, a push's None): the tape of the backward."""
    coords, frames, stack, tape = (x, y, z), [], [], []
    for ins in prog:
        out = None
        if ins.op <= OP_PLANE:
            out = _primitive_value(ins, coords)[0]
            stack.append(out)
        elif ins.op <= OP_SMOOTH:
            b, a = stack.pop(), stack.pop()
            out = _fold_value(ins, a, b)[0]
            stack.append(out)
        elif ins.op == OP_SHELL:
            out = torch.abs(stack.pop()) - ins.constants[0]
            stack.append(out)
        elif ins.op == OP_POP:
            coords = frames.pop()
            out = stack[-1]  # the frame's value, the fold's operand
        else:
            frames.append(coords)
            coords = _frame_coords(ins, coords)
        tape.append(out)
    return tape


def _program_csdf(prog) -> CSdf:
    """The program's value on coordinate planes, every instruction's value
    taped: the twin of the taped walk's value (``composed_forward``)."""
    return lambda x, y, z: _program_forward(prog, x, y, z)[-1]


def _walk_instructions(walk: np.ndarray) -> list[tuple[int, int, tuple, tuple]]:
    """The forward walk's words (:func:`walk_words`) read back as ``(op,
    action, constants, fused fold's constants)``, constants as Python
    floats."""
    out, pc = [], 0
    while pc < len(walk):
        head = int(walk[pc])
        op, action, size = head & 15, (head >> 4) & 15, head >> 8
        consts = tuple(float(v) for v in walk[pc + 1:pc + size].view(np.float32))
        cut = len(consts) - (2 if op <= OP_PLANE and action == OP_SMOOTH else 0)
        out.append((op, action, consts[:cut], consts[cut:]))
        pc += size
    return out


def walk_csdf(walk: np.ndarray) -> CSdf:
    """The forward walk's value on coordinate planes, in plain PyTorch:
    the twin of ``composed_sdf`` (csrc/composed.cuh), which K1, K2 and K3
    run, and bit for bit the node program's (:func:`_program_csdf`): the top
    of the stack a value of its own, the operations of
    :func:`_primitive_value` and :func:`_fold_value` in the same order. It
    reads the walk's words, which the tests check with it; the kernels'
    twins (:func:`descriptor_csdf`) run :func:`_program_csdf`, which reads
    the instructions, so the card holds the walk against an interpreter
    that does not share its encoding."""
    code = _walk_instructions(walk)

    def f(x, y, z):
        coords, frames, stack, top = (x, y, z), [], [], None
        for op, action, consts, fold_consts in code:
            if op <= OP_PLANE:
                value = _primitive_value(Instruction(op, -1, consts), coords)[0]
                if action == WALK_PUSH:
                    stack.append(top)
                if action in (WALK_SET, WALK_PUSH):
                    top = value
                else:
                    top = _fold_value(Instruction(action, -1, fold_consts), top, value)[0]
            elif op <= OP_SMOOTH:
                top = _fold_value(Instruction(op, -1, consts), stack.pop(), top)[0]
            elif op == OP_SHELL:
                top = torch.abs(top) - consts[0]
            elif op == OP_POP:
                coords = frames.pop()
            else:
                frames.append(coords)
                coords = _frame_coords(Instruction(op, -1, consts), coords)
        return top

    return f


def _program_value_and_grad(prog):
    """The program's value and gradient, reverse mode over the tape: the
    twin of ``composed_sdf_grad``. The backward walks the program from the
    end with a stack of cotangents: a fold pops its cotangent and pushes
    its left operand's, then its right one's, which the instructions just
    before it consume first; a primitive adds its gradient to the frame's
    accumulated one; a pop (met first) enters the frame again, its
    coordinates recomputed from the push, and the push leaves it, mapping
    the frame's gradient back (a transform by ``R``, a wrap unchanged)."""

    def f(x, y, z):
        tape = _program_forward(prog, x, y, z)
        zero = torch.zeros_like(x)
        coords, acc, frames = (x, y, z), [zero, zero, zero], []
        cts = [torch.ones_like(x)]
        for i in range(len(prog) - 1, -1, -1):
            ins = prog[i]
            if ins.op <= OP_PLANE:
                _primitive_bwd(ins, coords, cts.pop(), acc)
            elif ins.op <= OP_SMOOTH:
                a, b = tape[ins.arg], tape[i - 1]
                ct_a, ct_b = _fold_bwd(ins, a, b, tape[i], _fold_value(ins, a, b)[1], cts.pop())
                cts += [ct_a, ct_b]
            elif ins.op == OP_SHELL:
                ct = cts.pop()
                cts.append(torch.where(tape[i - 1] >= 0.0, ct, -ct))
            elif ins.op == OP_POP:
                frames.append((coords, acc))
                coords, acc = _frame_coords(prog[ins.arg], coords), [zero, zero, zero]
            else:
                if ins.op == OP_PUSH_TRANSFORM:
                    r = ins.constants[3:]
                    acc = [(r[3 * a] * acc[0] + r[3 * a + 1] * acc[1]) + r[3 * a + 2] * acc[2]
                           for a in range(3)]
                coords, parent = frames.pop()
                acc = [parent[a] + acc[a] for a in range(3)]
        return (tape[-1], *acc)

    return f


# ---------------------------------------------------------------------------
# a composed scene's parameter program: kernels K4 and K5
# (csrc/param_program.cuh)
# ---------------------------------------------------------------------------

#: 32-bit words per parameter-program instruction: opcode, operand index,
#: the flat slots of up to three fields, the box skeleton's reference_compat
PARAM_WORDS = 8

#: the fields an instruction reads, in the order of its slots
PARAM_FIELDS = {
    OP_SPHERE: ("center", "radius"),
    OP_BOX: ("center", "size"),
    OP_CAPSULE: ("start", "end", "radius"),
    OP_SKELETON: ("center", "size", "line_width"),
    OP_TORUS: ("center", "major_radius", "minor_radius"),
    OP_CYLINDER: ("center", "radius", "height"),
    OP_PLANE: ("normal", "offset"),
    OP_SMOOTH: ("k",),
    OP_SHELL: ("thickness",),
    OP_PUSH_TRANSFORM: ("offset", "rotation"),
    OP_PUSH_WRAP: ("cell",),
}


class ParamInstruction(NamedTuple):
    """One parameter-program instruction: ``op`` and ``arg`` as in
    :class:`Instruction`, ``slots`` the index in the flat parameter vector
    (``weights.flatten_params``) of the first value of each field of
    :data:`PARAM_FIELDS`, ``compat`` a box skeleton's reference_compat."""

    op: int
    arg: int
    slots: tuple
    compat: int = 0


def param_program(spec: dict, offsets: dict) -> tuple[ParamInstruction, ...]:
    """Flatten a composed scene's spec (``Scene.spec``) into the program
    that kernels K4 and K5 interpret (``csrc/param_program.cuh``): the node
    program's postfix order (:func:`postfix`), each instruction naming
    the slots of its fields in the flat vector (``offsets``: each
    parameter's first slot, ``weights.param_offsets``) where the node
    program holds baked constants. The kernels derive every constant from
    the parameter values at run time in float32, operation for operation as
    ``models/compose.py::_eval`` does, so the program's value equals the
    spec's component form bit for bit (:func:`param_program_csdf`). Any
    length, stack depth and nesting, as :func:`node_program`."""
    ids = spec["ids"]

    def slots(node: dict, op: int) -> tuple:
        return tuple(offsets[f"{ids[id(node)]}_{field}"] for field in PARAM_FIELDS.get(op, ()))

    def compat(node: dict, op: int) -> int:
        return int(bool(node.get("reference_compat", True))) if op == OP_SKELETON else 0

    return tuple(ParamInstruction(op, arg, slots(node, op), compat(node, op))
                 for op, node, arg in postfix(spec["root"]))


def param_program_words(prog) -> np.ndarray:
    """The program as the kernels read it: ``(n, PARAM_WORDS)`` int32, each
    row the opcode, the operand index, three slots (-1 where unused) and
    reference_compat."""
    words = np.full((len(prog), PARAM_WORDS), -1, np.int32)
    words[:, 5:] = 0
    for i, ins in enumerate(prog):
        words[i, 0], words[i, 1] = ins.op, ins.arg
        words[i, 2:2 + len(ins.slots)] = ins.slots
        words[i, 5] = ins.compat
    return words


class WrappedProgram(NamedTuple):
    """The wrapped object (``models/scenes.py::WrappedCsdf``) as a parameter
    program, for K5's reverse sweep (``csrc/param_program.cuh``; its march
    and dfdt keep ``csrc/param_forms.cuh WrappedForm``): wrap(transform(
    smooth_union(box_skeleton, sphere))), the transform where the
    parameters have one. ``prog`` reads the flat vector's ``n`` values and
    private slots after them: the cell three times (a wrap reads a cell a
    coordinate), then the sphere's centre, pinned at 0, and a present
    transform's absent part (a zero offset, the identity quaternion),
    ``constants`` their values. :meth:`extend` gives the vector the program
    reads, :meth:`fold` puts its slots' adjoints back on the flat vector.

    Private slots and a fold, not a flag on the wrap instruction that reads
    one cell for the three coordinates: the interpreter that every composed
    scene runs stays as it is, and the price is a few more adjoint rows a
    ray (in shared memory the small tier holds anyway) and a sum on the
    host. The program's value is ``WrappedCsdf``'s bit for bit: the same
    float32 operations in the same order (``cell * 0.5`` is ``cell / 2``
    exactly, ``x - 0`` is ``x``)."""

    prog: tuple
    n: int
    cell: int
    constants: tuple

    def extend(self, flat: torch.Tensor) -> torch.Tensor:
        """The vector the program reads: ``flat``, then the private slots."""
        rest = torch.tensor(self.constants, dtype=flat.dtype, device=flat.device)
        return torch.cat([flat, flat[self.cell].reshape(1).expand(3), rest])

    def fold(self, adjoints: torch.Tensor) -> torch.Tensor:
        """The adjoints of the flat vector from those of :meth:`extend`'s
        (its last axis): the cell's three copies summed onto the cell, the
        constants' dropped."""
        n = self.n
        out = adjoints[..., :n].clone()
        out[..., self.cell] += (adjoints[..., n] + adjoints[..., n + 1]) + adjoints[..., n + 2]
        return out


def wrapped_param_program(offsets: dict, n: int) -> WrappedProgram:
    """The wrapped object's parameter program for a flat vector of ``n``
    values whose slots are ``offsets`` (``weights.param_offsets``); the
    object transform's two parameters are optional, as the reference
    object's."""
    cell = n
    private = [0.0, 0.0, 0.0]  # the sphere's centre
    centre = n + 3
    prog = [ParamInstruction(OP_PUSH_WRAP, -1, (cell,))]
    moved = "object_center" in offsets or "object_rotation" in offsets
    if moved:
        def slot(name, absent):
            if name in offsets:
                return offsets[name]
            private.extend(absent)
            return n + 3 + len(private) - len(absent)

        prog.append(ParamInstruction(OP_PUSH_TRANSFORM, -1, (
            slot("object_center", (0.0, 0.0, 0.0)),
            slot("object_rotation", (1.0, 0.0, 0.0, 0.0)))))
    skeleton = len(prog)
    prog += [
        ParamInstruction(OP_SKELETON, -1, (offsets["skeleton_center"], offsets["skeleton_size"],
                                           offsets["skeleton_line_width"]), 1),
        ParamInstruction(OP_SPHERE, -1, (centre, offsets["sphere_radius"])),
        ParamInstruction(OP_SMOOTH, skeleton, (offsets["smooth_k"],)),
    ]
    if moved:
        prog.append(ParamInstruction(OP_POP, 1, ()))
    prog.append(ParamInstruction(OP_POP, 0, ()))
    return WrappedProgram(tuple(prog), n, offsets["cell"], tuple(private))


def _param_primitive(ins: ParamInstruction, prm, x, y, z):
    """A primitive's value from the parameter values ``prm(slot)``, as
    ``models/compose.py::_eval`` computes it."""
    from bsdmg_tpu_torch.models.compose import _sd_capsule_c
    from bsdmg_tpu_torch.sdf import primitives as sdf

    s = ins.slots
    vec = lambda slot: (prm(slot), prm(slot + 1), prm(slot + 2))
    if ins.op == OP_SPHERE:
        return sdf.sd_sphere_c(x, y, z, vec(s[0]), prm(s[1]))
    if ins.op == OP_BOX:
        return sdf.sd_box_c(x, y, z, vec(s[0]), vec(s[1]))
    if ins.op == OP_CAPSULE:
        return _sd_capsule_c(x, y, z, vec(s[0]), vec(s[1]), prm(s[2]))
    if ins.op == OP_SKELETON:
        return sdf.sd_box_skeleton_c(x, y, z, vec(s[0]), vec(s[1]), prm(s[2]),
                                     reference_compat=bool(ins.compat))
    if ins.op == OP_TORUS:
        return sdf.sd_torus_c(x, y, z, vec(s[0]), prm(s[1]), prm(s[2]))
    if ins.op == OP_CYLINDER:
        return sdf.sd_cylinder_c(x, y, z, vec(s[0]), prm(s[1]), prm(s[2]))
    n = vec(s[0])
    inv = torch.rsqrt(sdf.maximum(n[0] * n[0] + n[1] * n[1] + n[2] * n[2], 1e-24))
    return (x * n[0] + y * n[1] + z * n[2]) * inv - prm(s[1])


def param_program_csdf(prog):
    """``f(flat, x, y, z)``: the parameter program's value on coordinate
    planes from the flat parameter vector, instruction by instruction as
    the kernels' interpreter runs it (a stack of values and of coordinate
    frames). It equals the spec's component form bit for bit."""
    from bsdmg_tpu_torch.models.scenes import _quat_inv_rotate_c
    from bsdmg_tpu_torch.sdf import primitives as sdf

    def f(flat, x, y, z):
        prm = lambda slot: flat[slot]
        coords, frames, stack = (x, y, z), [], []
        for ins in prog:
            if ins.op <= OP_PLANE:
                stack.append(_param_primitive(ins, prm, *coords))
            elif ins.op <= OP_SMOOTH:
                b, a = stack.pop(), stack.pop()
                if ins.op == OP_MIN:
                    stack.append(sdf.minimum(a, b))
                elif ins.op == OP_MAX:
                    stack.append(sdf.maximum(a, b))
                elif ins.op == OP_SUB:
                    stack.append(sdf.maximum(a, -b))
                else:
                    stack.append(sdf.smooth_min(a, b, prm(ins.slots[0])))
            elif ins.op == OP_SHELL:
                stack.append(sdf.abs_(stack.pop()) - prm(ins.slots[0]))
            elif ins.op == OP_POP:
                coords = frames.pop()
            elif ins.op == OP_PUSH_TRANSFORM:
                frames.append(coords)
                off, q = ins.slots
                moved = tuple(coords[a] - prm(off + a) for a in range(3))
                coords = _quat_inv_rotate_c(flat[q:q + 4], *moved)
            else:
                frames.append(coords)
                cell = ins.slots[0]
                coords = tuple(-(prm(cell + a) * 0.5) + sdf.mod(coords[a] + prm(cell + a) * 0.5,
                                                                prm(cell + a))
                               for a in range(3))
        return stack[0]

    return f


# ---------------------------------------------------------------------------
# the reverse sweep of K5's composed scenes (csrc/param_program.cuh
# program_record, program_reverse), in plain PyTorch for the tests
# ---------------------------------------------------------------------------


class _Nd:
    """A nested dual number on planes, the kernels' ``Dual<N>`` and
    ``DualOf<N, C>`` (csrc/dual.cuh, nested_dual.cuh): ``v`` and each of
    ``t`` a plane or an ``_Nd`` one level down. An operand of a lower level
    (a plane, a float) takes part with zero tangents, as the kernels' mixed
    rules have it."""

    __slots__ = ("v", "t")

    def __init__(self, v, t):
        self.v, self.t = v, tuple(t)

    def __neg__(self):
        return _Nd(-self.v, (-x for x in self.t))

    def __add__(self, o):
        if _level(o) > _level(self):
            return o + self
        if isinstance(o, _Nd) and _level(o) == _level(self):
            return _Nd(self.v + o.v, (a + b for a, b in zip(self.t, o.t)))
        return _Nd(self.v + o, self.t)

    __radd__ = __add__

    def __sub__(self, o):
        return self + (-o)

    def __rsub__(self, o):
        return (-self) + o

    def __mul__(self, o):
        if _level(o) > _level(self):
            return o * self
        if isinstance(o, _Nd) and _level(o) == _level(self):
            return _Nd(self.v * o.v, (a * o.v + self.v * b for a, b in zip(self.t, o.t)))
        return _Nd(self.v * o, (a * o for a in self.t))

    __rmul__ = __mul__

    def __truediv__(self, o):
        if _level(o) > _level(self):
            return o.__rtruediv__(self)
        if isinstance(o, _Nd) and _level(o) == _level(self):
            v = self.v / o.v
            return _Nd(v, ((a - v * b) / o.v for a, b in zip(self.t, o.t)))
        return _Nd(self.v / o, (a / o for a in self.t))

    def __rtruediv__(self, o):
        v = o / self.v
        return _Nd(v, (-(v * b) / self.v for b in self.t))


def _level(x) -> int:
    return 1 + _level(x.v) if isinstance(x, _Nd) else 0


def _inner(x):
    """The plane of x's innermost value."""
    return _inner(x.v) if isinstance(x, _Nd) else x


def _tie(x, z, y):
    """dual.cuh tie_weight: 1 where x alone attains z, 1/2 at a tie, else 0."""
    return (x == z).to(z.dtype) / torch.where(y == z, 2.0, 1.0)


def _plane(x, like):
    return torch.as_tensor(x, dtype=like.dtype) if not isinstance(x, torch.Tensor) else x


def _minmax(a, b, pick):
    """min or max (``pick`` on planes) of a and b under the kernels' rules:
    the value ``pick``'s, each operand's tangents by its tie weight
    (dual.cuh chooser), an operand of a lower level without tangents."""
    la, lb = _level(a), _level(b)
    if la == 0 and lb == 0:
        like = a if isinstance(a, torch.Tensor) else b
        return pick(_plane(a, like), _plane(b, like))
    if lb > la:
        a, b, la, lb = b, a, lb, la
    z = _minmax(a.v, b.v if lb == la else b, pick)
    va = _inner(a)
    vb, vz = _plane(_inner(b), va), _inner(z)
    wa = _tie(va, vz, vb)
    if lb < la:
        return _Nd(z, (t * wa for t in a.t))
    wb = _tie(vb, vz, va)
    return _Nd(z, (x * wa + y * wb for x, y in zip(a.t, b.t)))


def _minn(a, b):
    return _minmax(a, b, torch.minimum)


def _maxn(a, b):
    return _minmax(a, b, torch.maximum)


def _fmax(a, b):
    """vmax: fmaxf's value (the other operand where one is NaN)."""
    return _minmax(a, b, torch.fmax)


def _abs(a):
    if not isinstance(a, _Nd):
        return torch.abs(a)
    neg = _inner(a) < 0
    return _nd_where(neg, -a, a)


def _nd_where(c, a, b):
    if isinstance(a, _Nd):
        return _Nd(_nd_where(c, a.v, b.v), (_nd_where(c, x, y) for x, y in zip(a.t, b.t)))
    return torch.where(c, a, b)


def _is_zero(x):
    if isinstance(x, _Nd):
        out = _is_zero(x.v)
        for t in x.t:
            out = out & _is_zero(t)
        return out
    return x == 0.0


def _zero_like(x):
    return _Nd(_zero_like(x.v), (_zero_like(t) for t in x.t)) if isinstance(x, _Nd) else x * 0.0


def _psqrt(a):
    """nested_dual.cuh psqrt: a zero tangent stays 0 where the weight
    0.5 / sqrt(x) is infinite."""
    if not isinstance(a, _Nd):
        return torch.sqrt(a)
    v = _psqrt(a.v)
    w = 0.5 / v
    return _Nd(v, (_nd_where(_is_zero(t), _zero_like(t), t * w) for t in a.t))


def _rsqrt(a):
    """dual.cuh vrsqrt: d rsqrt(x) = dx * (-0.5 * rsqrt(x) / x)."""
    if not isinstance(a, _Nd):
        return torch.rsqrt(a)
    v = _rsqrt(a.v)
    w = -0.5 * (v / a.v)
    return _Nd(v, (t * w for t in a.t))


def _seeded(v, j: int, n: int = 3):
    """v with the unit tangent j of n (none for j < 0)."""
    return _Nd(v, (torch.full_like(v, float(i == j)) for i in range(n)))


def _kernel_primitive(op: int, slots, compat: int, prm, c):
    """param_program.cuh program_primitive: a primitive's value at the
    coordinates ``c`` from ``prm(slot)``, the kernels' operations in their
    order, for any nested dual."""
    s0, s1, s2 = (tuple(slots) + (-1, -1, -1))[:3]
    if op == OP_PLANE:
        n = [prm(s0 + a) for a in range(3)]
        inv = _rsqrt(_maxn((n[0] * n[0] + n[1] * n[1]) + n[2] * n[2], 1e-24))
        return ((c[0] * n[0] + c[1] * n[1]) + c[2] * n[2]) * inv - prm(s1)
    if op == OP_SKELETON:
        size = [prm(s1 + a) for a in range(3)]
        lo = [prm(s0 + a) - size[a] / 2.0 for a in range(3)]
        best = None
        for d in range(3):
            a1, a2 = (d + 1) % 3, (d + 2) % 3
            r = c[d] - lo[d]
            e = r - _minn(_maxn(r, 0.0), size[d])
            o1 = c[a1] - lo[a1]
            o1b = o1 - (size[(d + 1) % 2] if compat else size[a1])
            o2 = c[a2] - lo[a2]
            o2b = o2 - size[a2]
            d2 = (e * e + _minn(o1 * o1, o1b * o1b)) + _minn(o2 * o2, o2b * o2b)
            best = d2 if d == 0 else _minn(best, d2)
        return _psqrt(best) - prm(s2)
    p = [c[a] - prm(s0 + a) for a in range(3)]
    if op == OP_SPHERE:
        return _psqrt((p[0] * p[0] + p[1] * p[1]) + p[2] * p[2]) - prm(s1)
    if op == OP_BOX:
        q = [_abs(p[a]) - prm(s1 + a) * 0.5 for a in range(3)]
        o = [_maxn(v, 0.0) for v in q]
        outside = _psqrt((o[0] * o[0] + o[1] * o[1]) + o[2] * o[2])
        return outside + _minn(_maxn(q[0], _maxn(q[1], q[2])), 0.0)
    if op == OP_CAPSULE:
        seg = [prm(s1 + a) - prm(s0 + a) for a in range(3)]
        l2 = _maxn((seg[0] * seg[0] + seg[1] * seg[1]) + seg[2] * seg[2], 1e-12)
        t = _minn(_maxn(((p[0] * seg[0] + p[1] * seg[1]) + p[2] * seg[2]) / l2, 0.0), 1.0)
        dx, dy, dz = (p[a] - t * seg[a] for a in range(3))
        return _psqrt((dx * dx + dy * dy) + dz * dz) - prm(s2)
    if op == OP_TORUS:
        ring = _psqrt(p[0] * p[0] + p[2] * p[2]) - prm(s1)
        return _psqrt(ring * ring + p[1] * p[1]) - prm(s2)
    dr = _psqrt(p[0] * p[0] + p[2] * p[2]) - prm(s1)
    dy = _abs(p[1]) - prm(s2) * 0.5
    ox, oy = _maxn(dr, 0.0), _maxn(dy, 0.0)
    return _minn(_maxn(dr, dy), 0.0) + _psqrt(ox * ox + oy * oy)


def _kernel_fold(op: int, k, a, b):
    if op == OP_MIN:
        return _minn(a, b)
    if op == OP_MAX:
        return _maxn(a, b)
    if op == OP_SUB:
        return _maxn(a, -b)
    h = _maxn(k - _abs(a - b), 0.0) / k
    return _minn(a, b) - (((h * h) * h) * k) * float(np.float32(1.0 / 6.0))


def _kernel_rotation(q):
    """param_sdf.cuh rotation: the matrix m of the quaternion q (m[0..8])."""
    inv = _rsqrt(_fmax(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3], 1e-24))
    w, x, y, z = (v * inv for v in q)
    return [1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z), 2.0 * (x * z + w * y),
            2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - w * x),
            2.0 * (x * z - w * y), 2.0 * (y * z + w * x), 1.0 - 2.0 * (x * x + y * y)]


def _kernel_mod(a, y):
    """nested_dual.cuh vmod: jnp.mod's value, its tangents JAX's."""
    av, yv = _inner(a), _inner(y)
    m = torch.fmod(av, yv)
    plus = (m != 0.0) & ((m < 0.0) != (yv < 0.0))
    m = torch.where(plus, m + yv, m)
    k = plus.to(av.dtype) - torch.trunc(av / yv)
    return _with_value(a + y * k, m)


def _with_value(x, m):
    return _Nd(_with_value(x.v, m), x.t) if isinstance(x, _Nd) else m


def _kernel_frame(op: int, slots, prm, c):
    """param_program.cuh program_frame: the child frame's coordinates."""
    if op == OP_PUSH_WRAP:
        out = []
        for a in range(3):
            cell = prm(slots[0] + a)
            half = cell * 0.5
            out.append(-half + _kernel_mod(c[a] + half, cell))
        return out
    m = _kernel_rotation([prm(slots[1] + j) for j in range(4)])
    v = [c[a] - prm(slots[0] + a) for a in range(3)]
    return [(m[a] * v[0] + m[a + 3] * v[1]) + m[a + 6] * v[2] for a in range(3)]


def _field_widths(op: int) -> tuple:
    """param_program.cuh LocalPrm's fields: the values of each."""
    if op in (OP_SMOOTH, OP_SHELL):
        return (1,)
    wide = op in (OP_BOX, OP_CAPSULE, OP_SKELETON)
    return (3, 3 if wide else 1) + ((1,) if op in (OP_CAPSULE, OP_SKELETON, OP_TORUS,
                                                   OP_CYLINDER) else ())


def _local_prm(flat, slots, widths, first: int, pass_: int):
    """LocalPrm: a slot's value as a Dual<3> of planes, seeded where its
    local place is in the pass; and the place's slot."""
    places = {}
    at = first
    for slot, width in zip(slots, widths):
        for i in range(width):
            places[slot + i] = at + i
        at += width

    def prm(slot):
        j = places[slot] - 3 * pass_
        return _seeded(flat[slot], j if 0 <= j < 3 else -1)

    return prm, {v: k for k, v in places.items()}, at


def _lift(a, j: int, ob):
    """Pass<T>::lift: the input a under the output's adjoint ob, seed j."""
    if not isinstance(a, _Nd):
        return _seeded(a, j)
    u = (ob.t[0] * a.t[0] + ob.t[1] * a.t[1]) + ob.t[2] * a.t[2]
    return _Nd(_seeded(a.v, j), (_seeded(u, -1),))


def _dpsi(r, j: int, ob):
    if not isinstance(ob, _Nd):
        return ob * r.t[j]
    return ob.v * r.v.t[j] + r.t[0].t[j]


def _add_input(abar, r, j: int, ob):
    if not isinstance(ob, _Nd):
        return abar + ob * r.t[j]
    dv = r.v.t[j]
    return _Nd(abar.v + (ob.v * dv + r.t[0].t[j]), (t + dv * o for t, o in zip(abar.t, ob.t)))


def param_program_adjoint_torch(prog, flat, x, y, z, seed, seed_grad=None):
    """Plain PyTorch version of K5's reverse sweep of a composed scene's
    parameter program (csrc/param_program.cuh program_record and
    program_reverse), the kernels' adjoint rules op by op in their order,
    on planes of points: the forward pass in float, or with ``seed_grad``
    in value and spatial gradient (the kernels' Dual<3>), its tape, then
    the walk back from the last instruction with the adjoint ``seed`` of
    the value and ``seed_grad`` (three planes) of the gradient. Each
    primitive's, fold's and shell's adjoint is forward mode over its inputs,
    three a pass, in the nested duals of the forward lanes' rules; a
    transform's its linear algebra and the rotation's forward mode in the
    quaternion; a wrap's vmod's. Returns ``(value, grad, flat_bar, x_bar)``:
    the value, its gradient (None without ``seed_grad``), the adjoints of
    the parameter vector ``(P, n)`` and of the points (three planes). The
    tests hold it against autograd and JAX; the card runs the kernel."""
    grad = seed_grad is not None
    values = _PlaneVector(flat, x)
    plain = values.__getitem__
    zeros = torch.zeros_like(x)
    point = [(_seeded(v, a) if grad else v) for a, v in enumerate((x, y, z))]
    c, frames, stack, tape = list(point), [], [], []
    for ins in prog:
        op = ins.op
        if op <= OP_PLANE:
            stack.append(_kernel_primitive(op, ins.slots, ins.compat, plain, c))
        elif op <= OP_SMOOTH:
            b, a = stack.pop(), stack.pop()
            tape += [a, b]
            k = plain(ins.slots[0]) if op == OP_SMOOTH else None
            stack.append(_kernel_fold(op, k, a, b))
        elif op == OP_SHELL:
            a = stack.pop()
            tape.append(a)
            stack.append(_abs(a) - plain(ins.slots[0]))
        elif op == OP_POP:
            tape += list(c)
            c = frames.pop()
        else:
            frames.append(c)
            c = _kernel_frame(op, ins.slots, plain, c)
    value = stack[0]
    adj = torch.zeros(x.shape + (flat.numel(),), dtype=x.dtype)

    def add(slot, v):
        adj[..., slot] += v

    zero_t = (lambda: _Nd(zeros, (zeros, zeros, zeros))) if grad else (lambda: zeros)
    ob0 = _Nd(seed * torch.ones_like(x), tuple(seed_grad)) if grad else seed * torch.ones_like(x)
    c, cb, frames, adjs = list(point), [zero_t() for _ in range(3)], [], [ob0]
    for ins in reversed(prog):
        op = ins.op
        if op <= OP_PLANE:
            ob = adjs.pop()
            widths = _field_widths(op)
            for pass_ in range(-(-(3 + sum(widths)) // 3)):
                prm, slot_of, end = _local_prm(values, ins.slots, widths, 3, pass_)
                xs = [_lift(c[a], a if pass_ == 0 else -1, ob) for a in range(3)]
                r = _kernel_primitive(op, ins.slots, ins.compat, prm, xs)
                for j in range(3):
                    place = 3 * pass_ + j
                    if place < 3:
                        cb[place] = _add_input(cb[place], r, j, ob)
                    elif place < end:
                        add(slot_of[place], _dpsi(r, j, ob))
        elif op <= OP_SMOOTH:
            ob = adjs.pop()
            b, a = tape.pop(), tape.pop()
            prm, _, _ = _local_prm(values, ins.slots[:1], (1,), 2, 0)
            k = prm(ins.slots[0]) if op == OP_SMOOTH else None
            r = _kernel_fold(op, k, _lift(a, 0, ob), _lift(b, 1, ob))
            adjs += [_add_input(zero_t(), r, 0, ob), _add_input(zero_t(), r, 1, ob)]
            if op == OP_SMOOTH:
                add(ins.slots[0], _dpsi(r, 2, ob))
        elif op == OP_SHELL:
            ob = adjs.pop()
            a = tape.pop()
            prm, _, _ = _local_prm(values, ins.slots[:1], (1,), 1, 0)
            r = _abs(_lift(a, 0, ob)) - prm(ins.slots[0])
            adjs.append(_add_input(zero_t(), r, 0, ob))
            add(ins.slots[0], _dpsi(r, 1, ob))
        elif op == OP_POP:
            frames.append((c, cb))
            c = [tape.pop(-3), tape.pop(-2), tape.pop(-1)]
            cb = [zero_t() for _ in range(3)]
        else:
            p, pb = frames.pop()
            _frame_adjoint(op, ins.slots, flat, p, cb, pb, add, grad)
            c, cb = p, pb
    if grad:
        return value.v, tuple(value.t), adj, tuple(v.v for v in cb)
    return value, None, adj, tuple(cb)


class _PlaneVector:
    """The parameter vector read as planes like ``like``'s."""

    def __init__(self, flat, like):
        self.flat, self.like = flat, like

    def __getitem__(self, slot):
        return self.flat[slot] * torch.ones_like(self.like)


def _pairing(a, b):
    if not isinstance(a, _Nd):
        return a * b
    return ((a.v * b.v + a.t[0] * b.t[0]) + a.t[1] * b.t[1]) + a.t[2] * b.t[2]


def _frame_adjoint(op: int, slots, flat, p, cb, pb, add, grad: bool) -> None:
    """param_program.cuh frame_adjoint: a push's adjoint, from the child
    frame's coordinates' adjoint ``cb`` into the parent's ``pb`` (in place)
    and the push's fields (``add(slot, plane)``), at the parent's ``p``."""
    val = (lambda v: v.v) if grad else (lambda v: v)  # noqa: E731
    if op == OP_PUSH_WRAP:
        for a in range(3):
            cell = flat[slots[0] + a]
            av = val(p[a]) + cell * 0.5
            m = torch.fmod(av, cell)
            plus = (m != 0.0) & ((m < 0.0) != (cell < 0.0))
            k = plus.to(av.dtype) - torch.trunc(av / cell)
            pb[a] = pb[a] + cb[a]
            add(slots[0] + a, val(cb[a]) * (-0.5 + (0.5 + k)))
        return
    q = [flat[slots[1] + j] for j in range(4)]
    m = _kernel_rotation(q)
    md = _kernel_rotation([_seeded(q[j].reshape(1), j, 4) for j in range(4)])
    qbar = [0.0] * 4
    for b in range(3):
        v = p[b] - flat[slots[0] + b]
        vbar = (cb[0] * m[3 * b] + cb[1] * m[3 * b + 1]) + cb[2] * m[3 * b + 2]
        pb[b] = pb[b] + vbar
        add(slots[0] + b, -val(vbar))
        for a in range(3):
            mbar = _pairing(cb[a], v)
            for j in range(4):
                qbar[j] = qbar[j] + mbar * md[a + 3 * b].t[j]
    for j in range(4):
        add(slots[1] + j, qbar[j])


# ---------------------------------------------------------------------------
# a mesh asset's grid, in its two forms
# ---------------------------------------------------------------------------


def _grid_value_and_grad(desc: SceneDescriptor, with_grad: bool):
    """The grid SDF of ``desc`` on coordinate planes: the trilinear
    interpolation of the baked table with the sound step outside its box
    (``bsdmg_tpu/models/mesh_sdf.py``), in ``desc.grid_form``: "lerp"
    (``grid_sdf``: ``c000 + (c100 - c000) * fx``) or "weights"
    (``grid_csdf``: ``c000 * (1 - fx) + c100 * fx``), each point moved by
    ``desc.offset`` first. ``f(x, y, z) -> d``, or with ``with_grad``
    ``(d, gx, gy, gz)``: the gradient is ``jax.vjp`` of that function with
    a cotangent of 1, written out (csrc/grid_sdf.cuh grid_scene is the
    same operations in the same order):

    * ``floor`` and the index casts carry nothing; ``jnp.clip``'s
      ``maximum(0, q)`` and ``minimum(clip_hi, .)``, the outside's maxima and
      the step's ``maximum`` weight their cotangents by JAX's tie rule
      (:func:`_tie_weight`); the square root's weight ``0.5 / sqrt(sq)`` is
      taken only where ``sq > 0``, as JAX's double ``where`` takes it;
    * where cotangents meet, they are summed in the order JAX's transpose
      accumulates them (its equations in reverse): ``fx``'s from the
      lerps of c11, c01, c10 and c00 in turn ("weights": each lerp's
      ``+ ct * c1``, then ``- ct * c0``), a coordinate's as ``(ct_hi -
      ct_lo) + ct_q * scale``, the outside's before the interior's."""
    grid = desc.grid
    flat, r = grid.values.reshape(-1), grid.resolution
    lo, hi, scale, clip_hi = box_f32(r, grid.lo, grid.hi)
    lerp, off = desc.grid_form == "lerp", desc.offset

    def f(x, y, z):
        u = (x, y, z) if off is None else (x + off[0], y + off[1], z + off[2])
        q = [(u[a] - lo[a]) * scale[a] for a in range(3)]
        m = [torch.clamp_min(v, 0.0) for v in q]
        c = [torch.clamp_max(v, clip_hi) for v in m]
        base = [torch.floor(v) for v in c]
        fx, fy, fz = (cv - bv for cv, bv in zip(c, base))
        i0 = [v.to(torch.int64) for v in base]
        i1 = [torch.clamp_max(v + 1, r - 1) for v in i0]

        def at(ix, iy, iz):
            return flat[(ix * r + iy) * r + iz]

        # a[dy][dz] = (corner at x0, corner at x1)
        a = [[(at(i0[0], (i0, i1)[dy][1], (i0, i1)[dz][2]),
               at(i1[0], (i0, i1)[dy][1], (i0, i1)[dz][2])) for dz in (0, 1)] for dy in (0, 1)]
        if lerp:
            cx = [[a0 + (a1 - a0) * fx for a0, a1 in row] for row in a]
        else:
            gx = 1 - fx
            cx = [[a0 * gx + a1 * fx for a0, a1 in row] for row in a]
        (c00, c01), (c10, c11) = cx
        c0 = c00 + (c10 - c00) * fy
        c1 = c01 + (c11 - c01) * fy
        interior = c0 + (c1 - c0) * fz
        below = [lo[k] - u[k] for k in range(3)]
        above = [u[k] - hi[k] for k in range(3)]
        m1 = [torch.maximum(b, t) for b, t in zip(below, above)]
        o = [torch.clamp_min(v, 0.0) for v in m1]
        sq = (o[0] * o[0] + o[1] * o[1]) + o[2] * o[2]
        out = sq > 0
        outside = torch.where(out, torch.sqrt(torch.where(out, sq, 1.0)), 0.0)
        diff = interior - outside
        mx = torch.maximum(outside, diff)
        d = torch.where(outside > 0.0, mx, interior)
        if not with_grad:
            return d

        # backward, cotangent 1
        w_diff = _tie_weight(diff, mx, outside)
        stepped = outside > 0.0
        ct_int = torch.where(stepped, w_diff, 1.0)
        ct_out = torch.where(stepped, _tie_weight(outside, mx, diff) - w_diff, 0.0)
        ct_sq = torch.where(out, ct_out * (0.5 / torch.where(out, outside, 1.0)), 0.0)
        ct_fz = ct_int * (c1 - c0)
        ct_c1 = ct_int * fz
        ct_c0 = ct_int - ct_c1
        ct_fy = ct_c1 * (c11 - c01) + ct_c0 * (c10 - c00)
        ct_c11 = ct_c1 * fy
        ct_c01 = ct_c1 - ct_c11
        ct_c10 = ct_c0 * fy
        ct_c00 = ct_c0 - ct_c10
        ct_fx = None
        for ct, (a0, a1) in ((ct_c11, a[1][1]), (ct_c01, a[0][1]), (ct_c10, a[1][0]),
                             (ct_c00, a[0][0])):
            if lerp:
                t = ct * (a1 - a0)
                ct_fx = t if ct_fx is None else ct_fx + t
            else:
                t = ct * a1
                ct_fx = (t if ct_fx is None else ct_fx + t) - ct * a0
        grad = []
        for k, ct_f in enumerate((ct_fx, ct_fy, ct_fz)):
            ct_m = ct_f * _tie_weight(m[k], c[k], clip_hi)
            ct_t = (ct_m * _tie_weight(q[k], m[k], 0.0)) * scale[k]
            s = ct_sq * o[k]
            ct_m1 = (s + s) * _tie_weight(m1[k], o[k], 0.0)
            ct_above = ct_m1 * _tie_weight(above[k], m1[k], below[k])
            ct_below = ct_m1 * _tie_weight(below[k], m1[k], above[k])
            grad.append((ct_above - ct_below) + ct_t)
        return (d, *grad)

    return f


def descriptor_csdf(desc: SceneDescriptor) -> CSdf:
    """The scene SDF of ``desc`` on coordinate planes, in plain PyTorch: the
    twin of the kernels' ``scene_sdf`` (csdf.py::compile_scene_csdf)."""
    if desc.kind == "grid":
        return _grid_value_and_grad(desc, False)
    if desc.kind == "composed":
        return _program_csdf(desc.program.instructions)
    if desc.kind == "wireframe":
        frame = _capsule_set_value_grad(desc.frame)
        return lambda x, y, z: frame(x, y, z)[0]
    if desc.kind == "sphere":
        r = desc.sphere_radius
        return lambda x, y, z: torch.sqrt(x * x + y * y + z * z) - r
    if desc.kind == "box":
        return _box_csdf(desc)
    if desc.kind == "mandelbulb":
        s = desc.scale
        return lambda x, y, z: sd_mandelbulb_c(x / s, y / s, z / s) * s
    if desc.kind == "wrapped":
        return _wrapped(desc, _reference_csdf(desc))
    return _reference_csdf(desc)


def kernel_structure(desc: SceneDescriptor, *, taped: bool = True) -> int:
    """The index of the compile-time structure the kernels launch for
    ``desc`` (with_structure in csrc/scene_sdf.cuh): ``2 * frame +
    transform`` for ``Box<Frame, Transform>``, the reference scenes;
    :data:`SPHERE`, :data:`SOLID_BOX`, :data:`MANDELBULB`; :data:`WRAPPED`
    for ``Wrapped<Box<false, false>>``, the wrapped reference object, and
    :data:`WRAPPED_MOVED` for ``Wrapped<Box<false, true>>``, the same
    object moved by its object transform (``cli animate --motion``);
    :data:`COMPOSED` for a node program within the small tier's caps,
    :data:`COMPOSED_LARGE` for one beyond them (:func:`large_tier`): the
    caps of the taped walk, which K6 and K7 run, unless ``taped`` is False
    (K1, K2 and K3: the forward walk's). Each
    capsule set must be a box
    skeleton as the kernels take it, 3 groups along x, y and z in that order
    with 2 perpendicular coordinates per other axis; any other descriptor
    raises ``NotImplementedError``, for which no kernel is built, and so
    does a wrapped object with a wireframe, which no scene builds. A grid's
    index is its form's (:data:`GRID_FORMS`), a structure of K6 and K7
    alone."""
    plain = {"sphere": SPHERE, "box": SOLID_BOX, "mandelbulb": MANDELBULB, "composed": COMPOSED}
    if desc.kind == "grid":
        return GRID_FORMS[desc.grid_form]
    if desc.kind == "composed" and large_tier(desc.program.instructions, forward=not taped):
        return COMPOSED_LARGE
    if desc.kind == "wireframe":
        raise NotImplementedError(
            "a wireframe alone is the far scene of a near/far split (compile_scene_split), "
            "which K1 and K2 march beside the scene it was split from; no structure renders it"
        )
    if desc.kind in plain:
        return plain[desc.kind]
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
    if desc.kind == "wrapped":
        if desc.frame is not None:
            raise NotImplementedError(
                "the kernels are built for the wrapped reference object without a wireframe "
                "(Wrapped<Box<false, false>>, Wrapped<Box<false, true>>)"
            )
        return WRAPPED if desc.translation is None else WRAPPED_MOVED
    return 2 * (desc.frame is not None) + (desc.translation is not None)


def _reference_value_and_grad(desc: SceneDescriptor):
    """The reference scenes' value and gradient, reverse mode."""
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


def _sphere_value_and_grad(desc: SceneDescriptor):
    """sphere_csdf at the origin, reverse mode: d sqrt(b) = (0.5 / sqrt(b))
    db, each square's cotangent ``ct*x + x*ct``."""
    r = desc.sphere_radius

    def f(x, y, z):
        root = torch.sqrt(x * x + y * y + z * z)
        w = 0.5 / root
        gx, gy, gz = w * x, w * y, w * z
        return root - r, gx + gx, gy + gy, gz + gz

    return f


def _box_value_and_grad(desc: SceneDescriptor):
    """sd_box_c at the origin, reverse mode with JAX's tie rules: the
    outside's ``sqrt`` and squares as the sphere's, each ``max``/``min``
    weighting its cotangent (:func:`_tie_weight`), ``abs`` passing +1 at
    0. Inside the box the outside distance is 0 and its weight ``0.5 / 0``
    meets a zero: NaN, as JAX's."""
    hx, hy, hz = desc.box_half

    def f(x, y, z):
        coords = (x, y, z)
        q = [torch.abs(c) - h for c, h in zip(coords, (hx, hy, hz))]
        o = [torch.clamp_min(v, 0.0) for v in q]
        outside = torch.sqrt(o[0] * o[0] + o[1] * o[1] + o[2] * o[2])
        m2 = torch.maximum(q[1], q[2])
        m3 = torch.maximum(q[0], m2)
        inside = torch.clamp_max(m3, 0.0)
        # backward, cotangent 1
        ct_m3 = _tie_weight(m3, inside, 0.0)
        ct_m2 = ct_m3 * _tie_weight(m2, m3, q[0])
        ct_in = [ct_m3 * _tie_weight(q[0], m3, m2), ct_m2 * _tie_weight(q[1], m2, q[2]),
                 ct_m2 * _tie_weight(q[2], m2, q[1])]
        w = 0.5 / outside
        grad = []
        for c, qa, oa, ia in zip(coords, q, o, ct_in):
            s = w * oa
            ct_q = (s + s) * _tie_weight(qa, oa, 0.0) + ia
            grad.append(torch.where(c >= 0.0, ct_q, -ct_q))
        return (outside + inside, *grad)

    return f


class _Dual(NamedTuple):
    """A value plane and its three tangent planes: the kernels' ``Dual<3>``
    (csrc/dual.cuh), each rule the same operations in the same order."""

    v: torch.Tensor
    t: tuple

    def __add__(self, o):
        if isinstance(o, _Dual):
            return _Dual(self.v + o.v, tuple(a + b for a, b in zip(self.t, o.t)))
        return _Dual(self.v + o, self.t)

    def __mul__(self, o):
        if isinstance(o, _Dual):
            return _Dual(self.v * o.v, tuple(a * o.v + self.v * b for a, b in zip(self.t, o.t)))
        return _Dual(self.v * o, tuple(a * o for a in self.t))

    def __truediv__(self, o):
        if isinstance(o, _Dual):
            v = self.v / o.v
            return _Dual(v, tuple((a - v * b) / o.v for a, b in zip(self.t, o.t)))
        return _Dual(self.v / o, tuple(a / o for a in self.t))

    def scaled(self, w):
        """The value ``w``'s plane with tangents ``t * w_prime``: a unary
        rule's result, ``w`` a ``(value, derivative)`` pair."""
        return _Dual(w[0], tuple(a * w[1] for a in self.t))


def _chooser(a: _Dual, b, z):
    """``min``/``max`` of ``a`` and the float ``b`` with value ``z``: JAX's
    tangent weight for ``a`` (dual.cuh chooser)."""
    wa = _tie_weight(a.v, z, b)
    return _Dual(z, tuple(t * wa for t in a.t))


def _where(c, a: _Dual, b: _Dual) -> _Dual:
    return _Dual(torch.where(c, a.v, b.v), tuple(torch.where(c, p, q) for p, q in zip(a.t, b.t)))


def _sincos(a: _Dual):
    s, c = torch.sin(a.v), torch.cos(a.v)
    return a.scaled((s, c)), a.scaled((c, -s))


def _mandelbulb_value_and_grad(desc: SceneDescriptor):
    """The mandelbulb and its gradient by forward mode with three tangents
    through the loop (scene_sdf.cuh mandelbulb_sdf_grad), each rule JAX's
    JVP: acos' = -1/sqrt(1 - x^2), atan2(y, x)' = (x dy - y dx) / (x^2 +
    y^2), (x^p)' = p x^(p-1), log' = 1/x. A point leaves the loop at its
    escape, as in the kernel; the value equals :func:`descriptor_csdf`'s."""
    s = desc.scale
    power = MANDELBULB_POWER

    def f(x, y, z):
        one, zero = torch.ones_like(x), torch.zeros_like(x)
        p = [_Dual(c / s, tuple((one if i == a else zero) / s for i in range(3)))
             for a, c in enumerate((x, y, z))]
        zx, zy, zz = p
        dr = _Dual(one, (zero, zero, zero))
        r = _Dual(zero, (zero, zero, zero))
        active = torch.ones_like(x, dtype=torch.bool)
        for _ in range(MANDELBULB_ITERS):
            sq = (zx * zx + zy * zy) + zz * zz
            rv = torch.sqrt(sq.v)
            r_new = sq.scaled((rv, 0.5 / rv))
            r = _where(active, r_new, r)
            cont = active & (r_new.v <= 2.0)
            sr = _chooser(r_new, _SAFE_EPS_F32, torch.clamp_min(r_new.v, _SAFE_EPS_F32))
            c = zz / sr
            c = _chooser(c, -1.0, torch.clamp_min(c.v, -1.0))
            c = _chooser(c, 1.0, torch.clamp_max(c.v, 1.0))
            theta = c.scaled((torch.acos(c.v), -(1.0 / torch.sqrt(1.0 - c.v * c.v)))) * power
            den = zx.v * zx.v + zy.v * zy.v
            wy, wx = zx.v / den, -zy.v / den
            phi = _Dual(torch.atan2(zy.v, zx.v),
                        tuple(b * wy + a * wx for a, b in zip(zx.t, zy.t))) * power
            p6 = torch.pow(sr.v, power - 1.0)
            zr = sr.scaled((torch.pow(sr.v, power), power * p6))
            dr_next = (sr.scaled((p6, (power - 1.0) * torch.pow(sr.v, power - 2.0))) * power
                       * dr) + 1.0
            s_theta, c_theta = _sincos(theta)
            s_phi, c_phi = _sincos(phi)
            zx_n = zr * s_theta * c_phi + p[0]
            zy_n = zr * s_phi * s_theta + p[1]
            zz_n = zr * c_theta + p[2]
            zx, zy, zz = _where(cont, zx_n, zx), _where(cont, zy_n, zy), _where(cont, zz_n, zz)
            dr = _where(cont, dr_next, dr)
            active = cont
            if not bool(active.any()):
                break
        sr = _chooser(r, _SAFE_EPS_F32, torch.clamp_min(r.v, _SAFE_EPS_F32))
        d = sr.scaled((torch.log(sr.v), 1.0 / sr.v)) * 0.5 * r / dr * s
        return (d.v, *d.t)

    return f


def descriptor_csdf_value_and_grad(desc: SceneDescriptor):
    """``f(x, y, z) -> (d, gx, gy, gz)``: the scene SDF of ``desc`` and its
    gradient on coordinate planes, in plain PyTorch; the twin of the
    kernels' ``scene_sdf_grad`` (csrc/scene_sdf.cuh).

    The gradient is reverse mode with a cotangent of 1, as ``jax.vjp`` of
    the JAX compiler's SDF (``compile_scene_csdf``) takes it: through the
    capsule groups, with every ``min``/``max`` splitting its cotangent
    evenly at a tie and ``abs`` passing +1 at 0; a wrap passes it
    unchanged. The mandelbulb's is forward mode
    (:func:`_mandelbulb_value_and_grad`). ``d`` equals
    :func:`descriptor_csdf` bit for bit. A grid's gradient is reverse mode
    too (:func:`_grid_value_and_grad`)."""
    if desc.kind == "grid":
        return _grid_value_and_grad(desc, True)
    if desc.kind == "composed":
        return _program_value_and_grad(desc.program.instructions)
    if desc.kind == "sphere":
        return _sphere_value_and_grad(desc)
    if desc.kind == "box":
        return _box_value_and_grad(desc)
    if desc.kind == "mandelbulb":
        return _mandelbulb_value_and_grad(desc)
    if desc.kind == "wrapped":
        return _wrapped(desc, _reference_value_and_grad(desc))
    return _reference_value_and_grad(desc)


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
