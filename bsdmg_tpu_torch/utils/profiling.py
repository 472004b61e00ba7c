"""Profiling: torch.profiler traces, the kernels' FP32 operation counts and
speed-of-light estimates on one NVIDIA H100.

Counterpart of ``bsdmg_tpu/utils/profiling.py``, re-based on the card. A
kernel's bound is the least time the card could take for its work: the
larger of the bytes it must move (each input read once, each output written
once) over the memory rate and its FP32 operations over the FP32 peak.
Operations are counted from the CUDA sources (``csrc/``) line by line: each
add, subtract, multiply, division, min, max, abs, sqrt (or rsqrt) and
compare counts one; a negation or a select counts none; a value that a
backward pass recomputes from its forward pass counts once. Where the work
depends on the data (a march that ends early), the counts take this run's
data: evaluations, advances and hits from the kernels' own planes
(:func:`march_work`). ``chip_smoke.py`` and ``bench.py`` both count with
these functions.
"""

from __future__ import annotations

import contextlib
import dataclasses
from pathlib import Path

import numpy as np
import torch

from bsdmg_tpu_torch.ops.cuda.csdf import (
    OP_BOX,
    OP_CAPSULE,
    OP_CYLINDER,
    OP_MAX,
    OP_MIN,
    OP_PLANE,
    OP_POP,
    OP_PUSH_TRANSFORM,
    OP_PUSH_WRAP,
    OP_SHELL,
    OP_SKELETON,
    OP_SMOOTH,
    OP_SPHERE,
    OP_SUB,
    OP_TORUS,
)

#: Peaks of one H100 SXM (NVIDIA's data sheet, at its 700 W limit): FP32
#: outside the tensor cores, and HBM.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the region with ``torch.profiler`` (the host, and the card when
    there is one) and write a Chrome trace, ``trace.json``, and a table of
    the kernels' times, ``kernels.txt``, into ``log_dir``; the counterpart of
    the JAX package's ``jax.profiler`` context."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
    sort = "self_cuda_time_total" if torch.cuda.is_available() else "self_cpu_time_total"
    (out / "kernels.txt").write_text(prof.key_averages().table(sort_by=sort, row_limit=40))


@dataclasses.dataclass(frozen=True)
class Roofline:
    """Speed-of-light estimate: the larger of ``ops`` FP32 operations over
    the FP32 peak and ``nbytes`` over the memory rate."""

    ops: float
    nbytes: float
    peak_ops: float = PEAK_FP32
    peak_bytes: float = PEAK_BYTES

    @property
    def compute_seconds(self) -> float:
        return self.ops / self.peak_ops

    @property
    def memory_seconds(self) -> float:
        return self.nbytes / self.peak_bytes

    @property
    def seconds(self) -> float:
        return max(self.compute_seconds, self.memory_seconds)

    @property
    def bound(self) -> str:
        return "bytes" if self.memory_seconds >= self.compute_seconds else "operations"

    def efficiency(self, measured_seconds: float) -> float:
        return self.seconds / measured_seconds


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """``(bound_ms, bound_by)``: the least time the card could take."""
    roof = Roofline(ops, nbytes)
    return roof.seconds * 1e3, roof.bound


# ---------------------------------------------------------------------------
# the reference scenes' SDF (csrc/scene_sdf.cuh) and the kernels around it
# ---------------------------------------------------------------------------

TIE = 3  # scene_sdf.cuh tie_weight: two compares, a division
INV_NORM = 8  # project.cuh inv_norm: 3 multiplies, 2 adds, max, sqrt, division
WINDING = 41  # mc_kernel.cu vertex-mean winding per valid triangle: edges 6,
# cross product 9, normal sum 6, dot 5, |g|^2 5, |a|^2 5, ambiguity test 4, flip test 1
RAY = 124  # render_kernel.cu per ray: slab cull 64 (centre offset 3, reach 9, T* 4,
# margin 4, 3 slab axes of 12, tmin/tmax 4, miss 2, limit 2), ACES 60 (two 3x3
# products of 15, 3 curves of 8, 3 clips of 2)
CULL = 64  # common.cuh slab_cull (RAY's cull part)
ACES = 60  # common.cuh aces (RAY's ACES part)
SHADE = 13  # common.cuh shade_collision: light dot 7, colour mix 6
MARCH_EVAL = 9  # a march evaluation beside its SDF: the point 6, cd, cd + eps, the hit test
MARCH_ADVANCE = 3  # (depth + dist) - cd and the depth-limit test


def capsule_ops(cs) -> int:
    """scene_sdf.cuh capsule_set_fwd: per group_d2 the axial clamp
    (subtract, max, min, subtract), per slot a subtract and a multiply for
    each value and a min between two, then ``(e*e + m1) + m2``; a min
    between groups, the sqrt and the radius."""
    def slot(n):
        return 2 * n + n - 1

    return sum(4 + slot(len(g.v1)) + slot(len(g.v2)) + 3 for g in cs.groups) + len(cs.groups) + 1


def capsule_bwd_ops(cs) -> int:
    """scene_sdf.cuh capsule_set_bwd without the forward's values: the sqrt's
    weight (division, multiply), two weighted cotangents per later group;
    per group_bwd 12 (ce, ct_e, ct_mx, ct_r, add_to_axis) and per slot_bwd
    3 for one value (ct*d, a + a, add_to_axis) or 14 for two (two weighted
    cotangents, two ct*d, two a + a, the sum, add_to_axis)."""
    def slot(n):
        return 3 if n == 1 else 14

    groups = sum(12 + slot(len(g.v1)) + slot(len(g.v2)) for g in cs.groups)
    return 2 + (len(cs.groups) - 1) * 2 * (1 + TIE) + groups


SPHERE = 7  # scene_sdf.cuh sphere_sdf: 3 multiplies, 2 adds, sqrt, subtract
SPHERE_GRAD = SPHERE + 7  # sphere_sdf_grad: the weight's division, 3 multiplies, 3 doubled sums
SOLID_BOX = 19  # solid_box_sdf: 3 x (abs, subtract, max), the outside's 3 squares,
# 2 adds and sqrt, the inside's 2 maxes and min, the sum
SOLID_BOX_GRAD = SOLID_BOX + TIE + (TIE + 1) + 1 + 3 * (TIE + 1) + 3 * (TIE + 5)  # = 63: the
# inside's weights (ct_m3 a TIE, ct_m2 a TIE and a product), the outside's weight (a
# division), per axis the inside's cotangent (TIE, product) and box_axis_bwd (product,
# sum, TIE, product, sum, the sign's compare)
WRAP = 6  # scene_sdf.cuh wrap_coord beside its fmodf: add, two compares, the
# divisor's sign compare, the conditional add, -half + m

#: FP32 operations of one call of each libm function the mandelbulb (and the
#: wrap) calls, on the path that call takes: chip_smoke.libm_probe runs the
#: function's PTX (nvcc -O3 -fmad=false, sm_90a) with a counter at the head
#: of each basic block (:func:`instrument_ptx`) on the arguments the twins
#: give these calls in the frames chip_smoke renders at 1920x1080
#: (:func:`mandelbulb_loops`, :func:`wrap_arguments`), and takes each
#: executed instruction at :func:`ptx_fp32_ops`; the mean per call, rounded
#: to 0.01. chip_smoke checks that its probe gives these counts (CUDA 12.8:
#: PERF.md). powf7 and powf6 are powf with the constant exponents 7 and 6.
LIBM = {"acosf": 30.0, "atan2f": 29.0, "powf7": 77.0, "powf6": 77.0, "sincosf": 28.0, "logf": 28.0,
        "fmodf": 10.64}

#: scene_sdf.cuh mandelbulb_de, per evaluation: the three divisions by the
#: scale, the final max, logf, 3 multiplies, a division and the scale
MANDELBULB_EVAL = 3 + 1 + LIBM["logf"] + 3 + 1 + 1
#: per loop trip: the radius (3 multiplies, 2 adds, sqrt) and the escape test
MANDELBULB_TRIP = 7
#: per full iteration: max, division, clip (2), acosf and its multiply,
#: atan2f and its multiply, the two powf, dr's 2 multiplies and add, two
#: sincosf, the new point (2 multiplies and an add, twice; a multiply and
#: an add)
MANDELBULB_ITERATION = (1 + 1 + 2 + LIBM["acosf"] + 1 + LIBM["atan2f"] + 1 + LIBM["powf7"]
                        + LIBM["powf6"] + 3 + 2 * LIBM["sincosf"] + 3 + 3 + 2)

#: PTX FP32 operations by opcode, in this module's convention (a min, max,
#: abs, compare, division, sqrt, conversion or special function one, an FMA
#: a multiply and an add); a negation, select, move or bit operation none
PTX_FP32_OPS = {"add": 1, "sub": 1, "mul": 1, "div": 1, "min": 1, "max": 1, "abs": 1, "sqrt": 1,
                "rsqrt": 1, "rcp": 1, "ex2": 1, "lg2": 1, "sin": 1, "cos": 1, "tanh": 1,
                "setp": 1, "set": 1, "testp": 1, "copysign": 1, "cvt": 1, "fma": 2, "mad": 2}


def ptx_fp32_ops(line: str) -> int:
    """FP32 operations of one PTX instruction (:data:`PTX_FP32_OPS`, where
    one of its types is f32); a predicated one counts as executed."""
    words = line.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    if not words:
        return 0
    op, *types = words[0].rstrip(";").split(".")
    return PTX_FP32_OPS.get(op, 0) if "f32" in types else 0


def instrument_ptx(ptx: str, counter: str = "block_count") -> tuple[str, list[int]]:
    """``(ptx, ops)``: ``ptx`` with a ``red.global.add.u64`` of counter k at
    the head of the k-th basic block of each function (its entry, a label,
    the instruction after a branch), the counters a global u64 array
    ``counter``; ``ops[k]`` is block k's FP32 operations
    (:func:`ptx_fp32_ops`). The executed operations of a launch are the
    counts times ``ops``."""
    out, ops = [], []
    depth, opening, pending = 0, False, False

    def block():
        out.append(f"\tred.global.add.u64 \t[{counter}+{8 * len(ops)}], 1;")
        ops.append(0)

    for line in ptx.splitlines():
        text = line.split("//")[0].strip()
        if depth == 0:
            out.append(line)
            if text.startswith(".address_size"):
                out.append(f".global .align 8 .u64 {counter}[@BLOCKS@];")
            if text.startswith("{"):
                depth, opening = 1, True
            continue
        depth += text.count("{") - text.count("}")
        if depth == 0 or not text:
            out.append(line)
            continue
        if opening and (text.startswith((".reg", ".local", ".shared", ".param", ".pragma"))):
            out.append(line)
            continue
        if text.endswith(":"):
            out.append(line)
            opening, pending = False, False
            block()
            continue
        if opening or (pending and not text.startswith(("{", "}", ".reg", ".param"))):
            block()
            opening, pending = False, False
        out.append(line)
        if ops:
            ops[-1] += ptx_fp32_ops(text)
        words = text.split()
        op = words[1] if words[0].startswith("@") and len(words) > 1 else words[0]
        if op.split(".")[0].rstrip(";") in ("bra", "ret", "exit"):
            pending = True
    return "\n".join(out).replace("@BLOCKS@", str(max(len(ops), 1))) + "\n", ops


@dataclasses.dataclass(frozen=True)
class LoopWork:
    """The mandelbulb's loop over a set of SDF evaluations, the work its
    data takes: the evaluations, their loop trips (escape tests) and full
    iterations (:func:`mandelbulb_loops` counts them for a frame)."""

    evaluations: int
    trips: int
    full: int

    def ops(self) -> int:
        return (self.evaluations * MANDELBULB_EVAL + self.trips * MANDELBULB_TRIP
                + self.full * MANDELBULB_ITERATION)

    def per_evaluation(self, evaluations: float) -> float:
        """The operations of ``evaluations`` evaluations with this work's
        mean trips and iterations."""
        return evaluations * self.ops() / max(self.evaluations, 1)


def _reference_sdf_ops(desc) -> int:
    n = capsule_ops(desc.object) + 7 + 10
    if desc.translation is not None:
        n += 18
    if desc.frame is not None:
        n += capsule_ops(desc.frame) + 1
    return n


#: composed.cuh, per node-program opcode (ops/cuda/csdf.py OP_*): the
#: forward (primitive_value, fold_value, the shell, frame_coords) and the
#: backward beside it (primitive_grad and the frame's three adds, fold_bwd,
#: the shell's compare, the push's mapping; what it recomputes of the
#: forward counts once, in the forward). Forward: the sphere 3 subtracts, 3
#: multiplies, 2 adds, sqrt, subtract; the box 3 x (subtract, abs,
#: subtract, max, multiply), 2 adds, sqrt, 3 max/min, add; the capsule 3
#: subtracts, the dot 5, division, max, min, 3 x (multiply, subtract), 3
#: multiplies, 2 adds, sqrt, subtract; the skeleton 3 axes of 17 (4
#: subtracts, max, min, 2 subtracts, 5 multiplies, 2 mins, 2 adds), 2 mins,
#: sqrt, subtract; the torus 3 subtracts, 2 x (2 multiplies, add, sqrt,
#: subtract); the cylinder 3 subtracts, 2 multiplies, add, sqrt, subtract,
#: abs, subtract, 3 max, min, 2 multiplies, add, sqrt, add; the plane 3
#: multiplies, 2 adds, multiply, subtract; a fold 1; the smooth union 11;
#: the shell abs and subtract; a transform 3 subtracts, 9 multiplies, 6
#: adds; a wrap three wrap_axis (WRAP, fmodf); a pop nothing.
PROGRAM_FORWARD = {
    OP_SPHERE: 10, OP_BOX: 22, OP_CAPSULE: 24, OP_SKELETON: 55, OP_TORUS: 13, OP_CYLINDER: 19,
    OP_PLANE: 7, OP_MIN: 1, OP_MAX: 1, OP_SUB: 1, OP_SMOOTH: 11, OP_SHELL: 2,
    OP_PUSH_TRANSFORM: 18, OP_PUSH_WRAP: 3 * (WRAP + LIBM["fmodf"]), OP_POP: 0,
}
#: backward: the sphere the weight (division, multiply), 3 doubled products
#: and the 3 adds into the frame; the box 5 weighted cotangents (TIE and a
#: multiply each), the weight 2, per axis 8 (multiply, add, TIE, multiply,
#: add, the sign's compare) and 3 adds; the capsule the weight 2, the doubled
#: products 6, ct_t 5, ct_q 2 x (TIE + 1), ct_dot 1, the gradient 6 and 3
#: adds; the skeleton the weight 2, the axes' four weighted cotangents 16,
#: per axis 37 (ce, ct_e, ct_mx 4, ct_r 5, four slot weights of 5, two
#: sums of 3), 6 adds between the axes and 3 into the frame; the torus 15,
#: the cylinder 38, the plane 7; min, max and subtract two weighted
#: cotangents (8); the smooth union 24 (ct_h3 2, ct_h2 1, ct_h 5, ct_u 5,
#: the sign 1, the operands' 2 x 5); the shell its sign's compare; a
#: transform's push R applied (15) and 3 adds, a wrap's 3 adds.
PROGRAM_BACKWARD = {
    OP_SPHERE: 11, OP_BOX: 49, OP_CAPSULE: 31, OP_SKELETON: 138, OP_TORUS: 15, OP_CYLINDER: 38,
    OP_PLANE: 7, OP_MIN: 8, OP_MAX: 8, OP_SUB: 8, OP_SMOOTH: 24, OP_SHELL: 1,
    OP_PUSH_TRANSFORM: 18, OP_PUSH_WRAP: 3, OP_POP: 0,
}


def program_ops(desc) -> tuple[float, float]:
    """``(forward, backward)``: a composed scene's node program's FP32
    operations (PROGRAM_FORWARD, PROGRAM_BACKWARD), one evaluation."""
    ops = [ins.op for ins in desc.program.instructions]
    return sum(PROGRAM_FORWARD[o] for o in ops), sum(PROGRAM_BACKWARD[o] for o in ops)


class _Stencil:
    """The shared-term count of a program's forward over the 12 fd4 points.
    A value is the set of axes whose shift moves it; an operation on values
    that depend on every axis runs at each of the 12 points, one on values
    that depend on fewer axes runs once at the centre and at the 4 points of
    each axis it depends on (the others share the centre's value). A
    product with a constant 0 is a constant, and a constant costs nothing.
    ``calls`` counts the operations of one evaluation (PROGRAM_FORWARD),
    ``constants`` those of them that are constants, ``ops`` those of the
    stencil."""

    def __init__(self):
        self.calls = self.constants = self.ops = 0.0

    def op(self, *values, weight: float = 1.0) -> frozenset:
        axes = frozenset().union(*values)
        self.calls += weight
        if not axes:
            self.constants += weight
        self.ops += weight * (12 if len(axes) == 3 else 1 + 4 * len(axes) if axes else 0)
        return axes

    def scale(self, value: frozenset, k: float) -> frozenset:
        """``value * k``, k a constant."""
        return self.op(value if k != 0.0 else frozenset())

    def sum_of_squares(self, a, b, c) -> frozenset:
        """``(a*a + b*b) + c*c``, then its sqrt."""
        return self.op(self.op(self.op(self.op(a), self.op(b)), self.op(c)))

    def primitive(self, ins, x, y, z) -> frozenset:
        """composed.cuh primitive_value, operation by operation."""
        k, op = ins.constants, ins.op
        if op == OP_PLANE:
            dot = self.op(self.op(self.scale(x, k[0]), self.scale(y, k[1])), self.scale(z, k[2]))
            return self.op(self.op(dot))
        if op == OP_SKELETON:
            c, best = (x, y, z), None
            for d in range(3):
                r = self.op(c[d])
                e = self.op(r, self.op(self.op(r)))  # max, min, r - t
                o = [self.op(c[(d + j) % 3]) for j in (1, 2)]  # o1, o2
                m = [self.op(self.op(oj), self.op(self.op(oj))) for oj in o]  # q, o', q', min
                d2 = self.op(self.op(self.op(e), m[0]), m[1])
                best = d2 if best is None else self.op(best, d2)
            return self.op(self.op(best))
        p = [self.op(v) for v in (x, y, z)]
        if op == OP_SPHERE:
            return self.op(self.sum_of_squares(*p))
        if op == OP_BOX:
            q = [self.op(self.op(v)) for v in p]  # |p| - h
            o = [self.op(v) for v in q]
            outside = self.sum_of_squares(*o)
            inside = self.op(self.op(q[0], self.op(q[1], q[2])))
            return self.op(outside, inside)
        if op == OP_CAPSULE:
            s = k[3:6]
            dot = self.op(self.op(self.scale(p[0], s[0]), self.scale(p[1], s[1])),
                          self.scale(p[2], s[2]))
            t = self.op(self.op(self.op(dot)))  # the division, max, min
            d = [self.op(p[a], self.scale(t, s[a])) for a in range(3)]
            return self.op(self.sum_of_squares(*d))
        ring = self.op(self.op(self.op(self.op(p[0]), self.op(p[2]))))  # sqrt(x*x + z*z) - k
        if op == OP_TORUS:
            return self.op(self.op(self.op(self.op(ring), self.op(p[1]))))
        # OP_CYLINDER
        dy = self.op(self.op(p[1]))
        ox, oy = self.op(ring), self.op(dy)
        return self.op(self.op(self.op(ring, dy)), self.op(self.op(self.op(ox), self.op(oy))))

    def frame(self, ins, x, y, z) -> tuple:
        """composed.cuh frame_coords."""
        k = ins.constants
        if ins.op == OP_PUSH_WRAP:
            return tuple(self.op(v, weight=WRAP + LIBM["fmodf"]) for v in (x, y, z))
        t = [self.op(v) for v in (x, y, z)]
        return tuple(self.op(self.op(self.scale(t[0], k[3 + a]), self.scale(t[1], k[6 + a])),
                             self.scale(t[2], k[9 + a])) for a in range(3))

    def program(self, instructions) -> None:
        x, y, z = frozenset({0}), frozenset({1}), frozenset({2})
        stack, frames = [], []
        for ins in instructions:
            if ins.op <= OP_PLANE:
                stack.append(self.primitive(ins, x, y, z))
            elif ins.op <= OP_SMOOTH:
                b = stack.pop()
                stack[-1] = self.op(stack[-1], b, weight=PROGRAM_FORWARD[ins.op])
            elif ins.op == OP_SHELL:
                stack[-1] = self.op(stack[-1], weight=2)
            elif ins.op == OP_POP:
                x, y, z = frames.pop()
            else:
                frames.append((x, y, z))
                x, y, z = self.frame(ins, x, y, z)


def program_stencil_ops(desc) -> float:
    """The shared-term fd4 stencil's work on a composed scene's program
    (:class:`_Stencil`): the 12 points' SDFs, where an instruction in the
    root frame, or under frames that keep the axes apart (a wrap, a
    transform without a rotation), shares its terms as SPHERE_STENCIL and
    BOX_STENCIL do, and one under a rotation runs whole at each point."""
    stencil = _Stencil()
    stencil.program(desc.program.instructions)
    return stencil.ops


def sdf_ops(desc) -> int:
    """scene_sdf.cuh scene_sdf. The reference scenes: the transform (3
    subtracts, 9 multiplies, 6 adds), the object's capsules, the sphere (3
    multiplies, 2 adds, sqrt, subtract), the smooth-min (subtract, abs,
    subtract, max, multiply, min, 3 multiplies, subtract), the frame's
    capsules and a min; the wrapped object the same beside three wraps
    (WRAP and fmodf each); the sphere SPHERE, the box SOLID_BOX, a grid
    GRID_SDF; a composed scene its program's forward (:func:`program_ops`);
    the near/far split's far scene (a wireframe alone) its capsules. The
    mandelbulb's depends on its data (:class:`LoopWork`) and raises here."""
    if desc.kind == "sphere":
        return SPHERE
    if desc.kind == "wireframe":
        return capsule_ops(desc.frame)
    if desc.kind == "box":
        return SOLID_BOX
    if desc.kind == "grid":
        return GRID_SDF[desc.grid_form]
    if desc.kind == "mandelbulb":
        raise ValueError("the mandelbulb's work depends on its data: count it with LoopWork")
    if desc.kind == "composed":
        return program_ops(desc)[0]
    n = _reference_sdf_ops(desc)
    if desc.kind == "wrapped":
        n += 3 * (WRAP + LIBM["fmodf"])
    return n


def grad_ops(desc) -> int:
    """scene_sdf.cuh scene_sdf_grad. The reference scenes: the forward
    (scene_sdf's operations), the smooth-min backward (ct_h3 1, ct_h2 1,
    ct_h 5, ct_u 5, ct_delta 1, ct_skel 5, ct_sph 5, ct_s2 2), the sphere's
    (3 multiplies, 3 doubled sums), the capsules' backward, the frame's two
    weights and the transposed rotation (15); the wrapped object's beside
    its wraps; the sphere SPHERE_GRAD, the box SOLID_BOX_GRAD; a composed
    scene its program's forward and backward. The mandelbulb's forward mode
    is not counted and raises."""
    if desc.kind == "sphere":
        return SPHERE_GRAD
    if desc.kind == "box":
        return SOLID_BOX_GRAD
    if desc.kind == "grid":
        return GRID_GRAD[desc.grid_form]
    if desc.kind == "mandelbulb":
        raise ValueError("the mandelbulb's gradient (forward mode through its loop) is not counted")
    if desc.kind == "composed":
        return sum(program_ops(desc))
    n = sdf_ops(desc) + 25 + 9 + capsule_bwd_ops(desc.object)
    if desc.frame is not None:
        n += 2 * TIE + capsule_bwd_ops(desc.frame)
    if desc.translation is not None:
        n += 15
    return n


def _term_of(axis: int, x: int) -> int:
    """Which term of a group along ``axis`` (scene_sdf.cuh group_d2) reads
    coordinate ``x``: 0 the axial one, 1 the lower slot's, 2 the higher's."""
    return 0 if axis == x else (1 if x == (1 if axis == 0 else 0) else 2)


def _stencil_set_ops(cs) -> int:
    """The shared-term stencil's work on one capsule set over its 12
    points: each group's three terms at the centre (the axial one 5:
    subtract, max, min, subtract, square; a slot 3n - 1 for n values); at
    each point each group's moved term and its sums (two adds, or one where
    the higher slot moved, whose axial-plus-lower sum the axis's four points
    share, counted once), then the minima, the sqrt and the radius."""
    def term(g, k):
        n = len(g.v1 if k == 1 else g.v2)
        return 5 if k == 0 else 3 * n - 1

    ops = sum(term(g, k) for g in cs.groups for k in range(3))
    for x in range(3):
        for g in cs.groups:
            k = _term_of(g.axis, x)
            ops += 4 * (term(g, k) + (1 if k == 2 else 2)) + (k == 2)
    return ops + 12 * (len(cs.groups) + 1)


#: project.cuh fd4_grad beside its SDFs: 2*eps, each point's shifted
#: coordinate (12) and the stencil's 5 per axis
STENCIL = 1 + 12 + 15
#: the sphere's shared-term stencil: its three squares once, per point a
#: square and its sums (two adds, or one on z, whose x*x + y*y is shared),
#: sqrt and radius
SPHERE_STENCIL = 3 + 4 * (3 + 3 + 2) + 1 + 12 * 2
#: the box's: per axis |c| - h, its max and square once (12), max(qy, qz)
#: and x*x + y*y once (2); per point the moved axis's 4, the outside's sums
#: (2, or 1 on z), sqrt, the inside's maxes and min (2 on x, whose
#: max(qy, qz) is shared, else 3) and the sum
BOX_STENCIL = 12 + 2 + 4 * ((4 + 2 + 1 + 2 + 1) + (4 + 2 + 1 + 3 + 1) + (4 + 1 + 1 + 3 + 1))


def fd4_ops(desc) -> int:
    """project.cuh fd4_grad, whose 12 unrolled SDFs share every term that a
    shift leaves alone (the shared-term stencil): STENCIL; the object: with
    a transform 12 whole object SDFs (transform 18, capsules, sphere 7,
    smooth union 10), else its capsule set's terms
    (:func:`_stencil_set_ops`), the sphere's three squares once, per point
    a square and its sums (two adds, or one on z, whose x*x + y*y is
    shared) and sqrt and radius, and the smooth union (10) per point; the
    wireframe's terms and a min per point. The wrapped object adds its
    three wraps at the centre and one a point; the sphere and the box are
    SPHERE_STENCIL and BOX_STENCIL, the near/far split's far scene (K1 ·
    split shades a far patch's hits with it) its wireframe's terms. The
    mandelbulb's stencil, rolled, is 12 whole evaluations whose work
    depends on the data (:class:`LoopWork`) and raises here. A composed
    scene's is its program's shared-term stencil
    (:func:`program_stencil_ops`), though its kernels roll the 12 points; a
    grid's is GRID_STENCIL, though its kernels roll them too."""
    if desc.kind == "sphere":
        return STENCIL + SPHERE_STENCIL
    if desc.kind == "box":
        return STENCIL + BOX_STENCIL
    if desc.kind == "mandelbulb":
        raise ValueError("the mandelbulb's stencil depends on its data: count it with LoopWork")
    if desc.kind == "composed":
        return STENCIL + program_stencil_ops(desc)
    if desc.kind == "grid":
        return STENCIL + GRID_STENCIL[desc.grid_form]
    if desc.kind == "wireframe":
        return STENCIL + _stencil_set_ops(desc.frame)
    wraps = 15 * (WRAP + LIBM["fmodf"]) if desc.kind == "wrapped" else 0
    if desc.translation is not None:
        obj = 12 * (18 + capsule_ops(desc.object) + 7 + 10)
    else:
        obj = _stencil_set_ops(desc.object) + 3 + 4 * (3 + 3 + 2) + 1 + 12 * 2 + 12 * 10
    frame = 0 if desc.frame is None else _stencil_set_ops(desc.frame) + 12
    return STENCIL + obj + frame + wraps


def newton_step_ops(desc, use_grad: bool) -> int:
    """project.cuh newton_project, one step: the value and gradient (the
    analytic one, or scene_sdf and fd4), inv_norm, the update (3 x multiply,
    multiply, subtract) and the stop test (abs, compare)."""
    grad = grad_ops(desc) if use_grad else sdf_ops(desc) + fd4_ops(desc)
    return grad + INV_NORM + 9 + 2


def mesh_ops(desc, use_grad: bool, newton_steps: int, normals: int, lanes: int = 0,
             valid_triangles: int = 0) -> int:
    """FP32 operations of K6 or K7 for this run's data: its Newton steps,
    fd4 unit normals (fd4_grad, inv_norm, 3 multiplies), K6's start points
    (3 multiplies, 3 adds per lane) and vertex-mean windings."""
    return (newton_steps * newton_step_ops(desc, use_grad)
            + normals * (fd4_ops(desc) + INV_NORM + 3) + lanes * 6 + valid_triangles * WINDING)


# ---------------------------------------------------------------------------
# the render kernels K1, K2 and K3 (csrc/render_kernel.cu)
# ---------------------------------------------------------------------------


def march_work(steps, outcome, depth) -> tuple[int, int, int]:
    """``(evaluations, advances, hits)`` of a fresh march, from its planes:
    an evaluation per step and one more where the march ended by a hit or
    the depth limit, none for a culled ray (depth ``1.01 * 500``, no step);
    an advance per step and one more past the depth limit."""
    culled = (outcome == 2) & (steps == 0) & (depth == float(np.float32(500.0 * 1.01)))
    marched = ~culled
    evals = steps.sum().item() + int(((outcome != 1) & marched).sum().item())
    advances = steps.sum().item() + int(((outcome == 2) & marched).sum().item())
    return evals, advances, int((outcome == 0).sum().item())


HIT_SHADING = 29  # render_kernel.cu shade_pixel beside its stencil: the point 6, the
# normalisation 7, the Lambert term 10, the colour mix 6


def shade_ops(desc) -> int:
    """A hit's fd4 normal and shading in K1 or K3 (render_kernel.cu
    shade_pixel): the shared-term stencil (:func:`fd4_ops`) and
    HIT_SHADING."""
    return fd4_ops(desc) + HIT_SHADING


def march_ops(desc, evals: int, advances: int, culled_rays: int,
              loop: LoopWork | None = None) -> int:
    """The exact march of K1 or K2: each evaluation its SDF and
    MARCH_EVAL, each advance MARCH_ADVANCE, and the slab cull of each ray
    that runs it. The mandelbulb's evaluations take ``loop``'s work, scaled
    to ``evals``."""
    sdf = loop.per_evaluation(evals) if desc.kind == "mandelbulb" else evals * sdf_ops(desc)
    return sdf + evals * MARCH_EVAL + advances * MARCH_ADVANCE + culled_rays * CULL


#: scene_sdf.cuh frame_beyond: per axis two subtracts, two abs and a min
#: (15); the median's two mins and two maxes; the m > 1e-6 test, the
#: shrink's multiply, the radius's subtract and the compare with d
FRAME_BOUND = 23


def near_march_ops(desc, evals: int, advances: int, proved: int) -> int:
    """The near patches' march of K1 · split and K2 · split as the
    function needs it: :func:`march_ops` of the render scene ``desc``, but
    at each of the ``proved`` evaluations where frame_beyond proves the
    wireframe's term larger than the object's value the object's SDF and
    FRAME_BOUND, not the wireframe's capsules and min."""
    saving = max(capsule_ops(desc.frame) + 1 - FRAME_BOUND, 0)
    return march_ops(desc, evals, advances, 0) - proved * saving


def near_shade_ops(desc, hits: int, proved_points: int) -> float:
    """K1 · split's near hits as the function needs them: :func:`shade_ops`
    of ``desc`` each, but at each of the ``proved_points`` stencil points
    where frame_beyond proves the wireframe's term larger FRAME_BOUND, not
    the point's twelfth of the wireframe's shared-term stencil (its terms
    and 12 mins; the centre terms spread over the points, so a hit with a
    point left unproved is charged no more than it needs)."""
    share = (_stencil_set_ops(desc.frame) + 12) / 12
    return hits * shade_ops(desc) - proved_points * max(share - FRAME_BOUND, 0)


def render_ops(desc, evals: int, advances: int, hits: int, pixels: int, *,
               march_loop: LoopWork | None = None, stencil_loop: LoopWork | None = None) -> int:
    """K1: the march, each hit's normal and shading (:func:`shade_ops`, the
    shared-term stencil, though K1's epilogue runs the 12 SDFs whole) and
    per pixel the slab cull, where the scene has bounds, and ACES (RAY).
    The mandelbulb's march takes ``march_loop``'s work, its hits' 12
    stencil points ``stencil_loop``'s (:func:`mandelbulb_loops`)."""
    per_pixel = RAY if desc.bounds is not None else ACES
    if desc.kind == "mandelbulb":
        shading = stencil_loop.per_evaluation(12 * hits) + hits * (STENCIL + HIT_SHADING)
    else:
        shading = hits * shade_ops(desc)
    return march_ops(desc, evals, advances, 0, march_loop) + shading + pixels * per_pixel


#: the rays whose calls give the libm probe its arguments: every
#: ARGUMENT_STRIDE-th of the frame, in row-major order
ARGUMENT_STRIDE = 97


def march_points(desc, origins, directions, cone):
    """The points K1's march evaluates on these rays, step by step: yields
    ``(rays, (x, y, z), planes)``, the flat indices of the rays that
    evaluate at this step, their points, and the twin's planes after it.
    The twin (``trace_planes_torch``, unchanged) is resumed one step a call
    from its own state, so each point is one its march evaluates: at the
    first step every ray it does not cull, at its origin; then each ray it
    left active, at its depth."""
    from bsdmg_tpu_torch.ops.cuda.render_kernel import trace_planes_torch

    o, d = origins.reshape(-1, 3), directions.reshape(-1, 3)
    depth = torch.zeros_like(cone.reshape(-1))
    planes = trace_planes_torch(desc, origins, directions, cone, budget=1)
    after, steps, outcome, _ = (p.reshape(-1) for p in planes)
    culled = (outcome == 2) & (steps == 0) & (after == float(np.float32(500.0 * 1.01)))
    rays = (~culled).nonzero().squeeze(1)
    step = 1
    while rays.numel():
        yield rays, tuple(o[rays, a] + depth[rays] * d[rays, a] for a in range(3)), planes
        depth = planes[0].reshape(-1)
        rays = (planes[3].reshape(-1) != 0).nonzero().squeeze(1)
        step += 1
        if rays.numel():
            planes = trace_planes_torch(desc, origins, directions, cone, *planes, budget=step)


def _sampled(rays):
    return rays % ARGUMENT_STRIDE == 0


def _stencil_points(origins, directions, planes):
    """K1's epilogue: each hit's point and its 12 fd4 points, ``(rays,
    centre, points)``, the points one ``(x, y, z)`` per shift."""
    from bsdmg_tpu_torch.config import MarchConfig

    depth, _, outcome, _ = (p.reshape(-1) for p in planes)
    rays = (outcome == 0).nonzero().squeeze(1)
    o, d = origins.reshape(-1, 3), directions.reshape(-1, 3)
    centre = tuple(o[rays, a] + depth[rays] * d[rays, a] for a in range(3))
    eps = MarchConfig().normal_epsilon
    points = [tuple(p + off if k == a else p for k, p in enumerate(centre))
              for a in range(3) for off in (2 * eps, eps, -eps, -2 * eps)]
    return rays, centre, points


def mandelbulb_escape(x, y, z, arguments: dict | None = None) -> tuple[int, int]:
    """A counting copy of the mandelbulb's escape loop (scene_sdf.cuh
    mandelbulb_de, as ``sd_mandelbulb_c`` computes it) at points divided
    by the scale: ``(trips, full)``, the escape tests and the iterations
    that continue, each point leaving at its escape as the kernels' does.
    With ``arguments``, each libm call's arguments on these points' path
    are appended to its list there (atan2f's as ``(y, x)`` pairs)."""
    zx, zy, zz = x, y, z
    r = torch.zeros_like(x)
    live = torch.arange(x.numel(), device=x.device)
    trips = full = 0
    record = arguments is not None
    for _ in range(25):
        rl = torch.sqrt(zx * zx + zy * zy + zz * zz)
        r[live] = rl
        cont = rl <= 2.0
        trips += live.numel()
        full += int(cont.sum())
        live, rl, zx, zy, zz = live[cont], rl[cont], zx[cont], zy[cont], zz[cont]
        if not live.numel():
            break
        sr = torch.clamp_min(rl, 1e-12)
        cos_arg = torch.clamp(zz / sr, -1.0, 1.0)
        theta = torch.acos(cos_arg) * 7.0
        phi = torch.atan2(zy, zx) * 7.0
        if record:
            arguments.setdefault("acosf", []).append(cos_arg)
            arguments.setdefault("atan2f", []).append(torch.stack([zy, zx], -1))
            arguments.setdefault("powf7", []).append(sr)
            arguments.setdefault("powf6", []).append(sr)
            arguments.setdefault("sincosf", []).extend([theta, phi])
        zr = sr ** 7.0
        s_theta = torch.sin(theta)
        zx = zr * s_theta * torch.cos(phi) + x[live]
        zy = zr * torch.sin(phi) * s_theta + y[live]
        zz = zr * torch.cos(theta) + z[live]
    if record:
        arguments.setdefault("logf", []).append(torch.clamp_min(r, 1e-12))
    return trips, full


def _count(work: list, point, sampled, arguments) -> None:
    trips, full = mandelbulb_escape(*point)
    work[0] += point[0].numel()
    work[1] += trips
    work[2] += full
    if arguments is not None and bool(sampled.any()):
        mandelbulb_escape(*(p[sampled] for p in point), arguments)


def mandelbulb_loops(desc, origins, directions, cone,
                     arguments: dict | None = None) -> tuple[LoopWork, LoopWork]:
    """``(march, stencil)``: the mandelbulb's loop work in K1's render of
    these rays, the march's points (:func:`march_points`) and each hit's 12
    fd4 points through :func:`mandelbulb_escape`. With ``arguments``, the
    libm calls' arguments of the sampled rays (every ARGUMENT_STRIDE-th)
    are gathered there."""
    s = desc.scale
    march = [0, 0, 0]
    planes = None
    for rays, point, planes in march_points(desc, origins, directions, cone):
        _count(march, [p / s for p in point], _sampled(rays), arguments)
    stencil = [0, 0, 0]
    rays, _, points = _stencil_points(origins, directions, planes)
    for point in points:
        _count(stencil, [p / s for p in point], _sampled(rays), arguments)
    return LoopWork(march[0], march[1], march[2]), LoopWork(stencil[0], stencil[1], stencil[2])


def wrap_arguments(desc, origins, directions, cone) -> dict:
    """``{"fmodf": pairs}``: the wrap's fmodf arguments ``(v + half, cell)``
    of the sampled rays (every ARGUMENT_STRIDE-th) in K1's render of the
    wrapped object: three at each march point and at each hit's centre, one
    at each of its 12 fd4 points (the shifted coordinate)."""
    half, cell = float(np.float32(desc.cell / 2.0)), desc.cell
    values = []
    planes = None
    for rays, point, planes in march_points(desc, origins, directions, cone):
        values += [p[_sampled(rays)] for p in point]
    rays, centre, points = _stencil_points(origins, directions, planes)
    sampled = _sampled(rays)
    values += [p[sampled] for p in centre]
    values += [point[a // 4][sampled] for a, point in enumerate(points)]
    v = torch.cat(values) + half
    return {"fmodf": [torch.stack([v, torch.full_like(v, cell)], -1)]}


def shade_pass_ops(desc, hits: int, pixels: int) -> int:
    """K3: each hit's normal and shading, and ACES per pixel."""
    return hits * shade_ops(desc) + pixels * ACES


RAY_BYTES = 28  # a ray's origin, direction and cone, float32
PLANES_BYTES = 12  # its depth, steps and outcome
RGB_BYTES = 12


def render_bytes(pixels: int) -> int:
    """K1 from a fresh state: each ray read, its RGB written."""
    return pixels * (RAY_BYTES + RGB_BYTES)


def trace_bytes(rays: int, active: bool = False) -> int:
    """K2 from a fresh state: each ray read, its depth, steps and outcome
    written, and with a step budget its ``active`` flag (4 B)."""
    return rays * (RAY_BYTES + PLANES_BYTES + 4 * active)


def shade_bytes(pixels: int, hits: int) -> int:
    """K3: each pixel's outcome read (4 B) and its RGB written; only a hit
    reads its depth (4 B), origin and direction (24 B)."""
    return pixels * (4 + RGB_BYTES) + hits * (4 + 24)


def resumed_work(desc, carried, final, count: int) -> tuple[int, int]:
    """``(FP32 operations, bytes)`` of K2 over a listed tail of ``count``
    rays, from the carried and the final ``(depth, steps, outcome[,
    active])`` planes: each listed ray reads its index (4 B), its ray and
    state (16 B), runs the cull again and writes its planes."""
    listed = carried[3] > 0
    taken = int((final[1] - carried[1])[listed].sum())
    ended = final[2][listed]
    evals = taken + int((ended != 1).sum())
    advances = taken + int((ended == 2).sum())
    return (march_ops(desc, evals, advances, count),
            count * (4 + RAY_BYTES + 16 + PLANES_BYTES))


def render_roofline(desc, width: int, height: int, avg_steps: float, hits: int = 0, *,
                    march_loop: LoopWork | None = None,
                    stencil_loop: LoopWork | None = None) -> Roofline:
    """Speed of light of K1's render at ``width`` x ``height``: every ray
    takes ``avg_steps`` march steps (an evaluation and an advance each; the
    bench passes the mean over K1's 8x4 warp patches of their slowest ray's
    steps, which is what the card executes), ``hits`` rays are shaded, and
    each moves :func:`render_bytes`; the mandelbulb's evaluations take the
    mean work of ``march_loop`` and ``stencil_loop``."""
    rays = width * height
    steps = rays * avg_steps
    return Roofline(render_ops(desc, steps, steps, hits, rays, march_loop=march_loop,
                               stencil_loop=stencil_loop), render_bytes(rays))


# ---------------------------------------------------------------------------
# the parameter form of the reference scenes (csrc/param_sdf.cuh): K4 and K5
# ---------------------------------------------------------------------------

SKELETON = 52  # skeleton_fwd: per axis 16 (offset, clamp 2, difference, four
# offsets, five squares, two mins, two adds), two mins across axes, sqrt, width
SKELETON_BWD = 138  # skeleton_bwd without recomputed values: the sqrt's weight 2,
# the min chain 16, per axis 40 (axial 12, two slots of 14)
TRANSFORM = 70  # translation 3, quaternion to matrix 52, rotation 15
SMOOTH_BWD = 32  # scene_value_grad's smooth-min and sphere backward


def param_sdf_ops(frame: bool, transform: bool) -> int:
    """param_sdf.cuh scene_value: the skeleton's low corner (6), the
    skeleton, the sphere (7), the smooth minimum (11); the transform; the
    wireframe's corner (6), skeleton and the min."""
    return 6 + SKELETON + 7 + 11 + (TRANSFORM if transform else 0) + (
        6 + SKELETON + 1 if frame else 0)


def param_grad_ops(frame: bool, transform: bool) -> int:
    """param_sdf.cuh scene_value_grad: the value, the smooth-min and sphere
    backward, the skeleton's backward, the rotation's transpose (15), the
    two tie weights of the wireframe's min and its skeleton's backward."""
    return (param_sdf_ops(frame, transform) + SMOOTH_BWD + SKELETON_BWD
            + (15 if transform else 0) + (2 * TIE + SKELETON_BWD if frame else 0))


def form_ops(desc, loop: LoopWork | None = None) -> tuple[float, float]:
    """``(sdf, grad)``: the FP32 operations of one evaluation of a scene's
    SDF, and of its value and gradient, in the parameter forms of K4 and K5
    (csrc/param_forms.cuh) other than the reference scenes'
    (:func:`param_sdf_ops`, :func:`param_grad_ops`): the least work of the
    function, the descriptor's count (``desc`` from
    ``ops/cuda/csdf.py::compile_scene`` at the same parameters; the forms
    derive the descriptor's constants from the parameters at run time,
    which this does not count): :func:`sdf_ops` and :func:`grad_ops`, a
    composed scene its node program's forward and backward. The
    mandelbulb's from ``loop`` (:func:`mandelbulb_loops` on the same rays),
    its value and gradient two evaluations (the value and one reverse
    pass, one operation per forward operation; the kernels take the three
    tangents forward)."""
    if desc.kind == "mandelbulb":
        one = loop.per_evaluation(1)
        return one, 2 * one
    return sdf_ops(desc), grad_ops(desc)


def k4_ops(npix, evals, advances, frame, transform, bounds, track, *, sdf=None,
           grad=None) -> float:
    """diff_kernel.cu march_params_kernel: the cull, each evaluation (the
    point 6, the SDF, cd, cd + eps, the hit test; the margin and its compare
    with track_min), each advance 3, and every ray's dfdt (the point 6,
    the value and gradient, the dot 5). ``sdf`` and ``grad`` replace the
    reference scenes' counts for another form (:func:`form_ops`)."""
    sdf = param_sdf_ops(frame, transform) if sdf is None else sdf
    grad = param_grad_ops(frame, transform) if grad is None else grad
    return (npix * (CULL if bounds else 0) + evals * (sdf + 9 + 2 * track)
            + advances * 3 + npix * (11 + grad))


def k5_ops(npix, evals, advances, hits, hinges, frame, transform, edge, *, sdf=None,
           grad=None, bounds=True, reverse=True) -> float:
    """diff_kernel.cu K5 (its march, tangent and sum launches) as the least
    work of the function, the loss and its gradient, whatever the number of
    parameters: K4's march and, per hit, its dfdt and guard (2); the loss,
    that is per hit the residual (SDF, 5), t_diff and q (8), the value and
    gradient, the normalisation (8) and normal (3), the shading and ACES, a
    miss's ACES, per pixel the squared error (9) and the warp sum (5), per
    hinge the point (6), the SDF and 7; and one reverse pass through the
    loss's parameter-dependent part, counted at one operation per forward
    operation (each operation's adjoint takes at least one, so this stays
    a lower bound; the kernels take the parameters' tangents forward, one
    lane each). ``sdf`` and ``grad`` as in :func:`k4_ops`; the cull where
    ``bounds``; without ``reverse`` (a scene that reads no parameter, a
    mesh asset's grid) the loss alone."""
    sdf = param_sdf_ops(frame, transform) if sdf is None else sdf
    grad = param_grad_ops(frame, transform) if grad is None else grad
    passes = 2 if reverse else 1
    return (npix * (CULL if bounds else 0) + evals * (sdf + 9 + 2 * edge) + advances * 3
            + hits * (6 + 11 + grad + 2 + passes * (sdf + 5 + 8 + grad + 8 + 3 + SHADE + ACES))
            + (npix - hits) * ACES + npix * 2 * 14 + hinges * (6 + passes * (sdf + 7)))


def grad_roofline(width: int, height: int, avg_steps: float, hits: int, *,
                  frame: bool = True, transform: bool = False) -> Roofline:
    """Speed of light of K5 (the fused loss and gradient, no edge term) at
    ``width`` x ``height``: every ray takes ``avg_steps`` march steps,
    ``hits`` rays differentiate their shading (:func:`k5_ops`), each ray
    reads 40 B (its ray and target colour)."""
    rays = width * height
    steps = rays * avg_steps
    return Roofline(k5_ops(rays, steps, steps, hits, 0, frame, transform, False), rays * 40)


# ---------------------------------------------------------------------------
# refine and marching cubes: the JAX package's models (bsdmg_tpu/utils/
# profiling.py), its formulas and constants, on this card's peaks
# ---------------------------------------------------------------------------


def csdf_flops_per_eval(csdf, fallback: float = 55.0) -> float:
    """FP32 operations of one evaluation of a scene's SDF: :func:`sdf_ops`
    of ``csdf``, a scene descriptor (``ops/cuda/csdf.py::compile_scene``),
    the count the kernels' bounds take. The JAX package asks XLA's cost
    analysis of the compiled SDF; this port counts its own CUDA source. A
    ``csdf`` that is no descriptor, or whose work depends on its data (the
    mandelbulb), gives ``fallback`` (the JAX package's 55 for the reference
    object)."""
    try:
        return float(sdf_ops(csdf))
    except (AttributeError, ValueError):
        return float(fallback)


#: the JAX package's single-pass bytes per refined parent (27 lattice
#: coordinate planes and values 432, 8 children's 3 planes written and
#: gathered 192, one fine sort 64, the output stack 24): its floor model of
#: the stage's traffic, kept as its formula
REFINE_BYTES_PER_PARENT = 712.0


def refine_roofline(parents: int, ops_per_eval: float = 55.0,
                    bytes_per_parent: float = REFINE_BYTES_PER_PARENT) -> Roofline:
    """Speed of light of one voxel-refinement level
    (``bsdmg_tpu/utils/profiling.py::refine_roofline``): 27 SDF evaluations
    per parent (the shared 3x3x3 lattice of its corners) and
    ``bytes_per_parent`` bytes each, on this card's FP32 and memory
    peaks."""
    return Roofline(parents * 27.0 * ops_per_eval, parents * bytes_per_parent)


#: evaluations of one Newton step's value and gradient, and of an fd4
#: normal, in the JAX package's marching-cubes model
MC_GRAD_EVAL_COST = 2.5
MC_NORMAL_EVALS = 12.0
#: K6's traffic per voxel, each input read once and each output written
#: once: 6 planes of 4 B in (the lower corner's 3, the crossing bits, the
#: two words of the triangle table) and 101 out (45 positions, 45 normals,
#: 5 dots, 5 ambients, the meta word); the JAX model's planes per lane
MC_VOXEL_BYTES = (6 + 101) * 4


def mc_roofline(lanes: int, budget: float, newton_steps: float,
                corner_evals_per_lane: float = 8.0, ops_per_eval: float = 55.0) -> Roofline:
    """Speed of light of the marching-cubes finish
    (``bsdmg_tpu/utils/profiling.py::mc_roofline``): per lane ``budget``
    Newton projections of ``newton_steps`` steps at MC_GRAD_EVAL_COST
    evaluations and an fd4 normal each, plus ``corner_evals_per_lane``
    corner evaluations; MC_VOXEL_BYTES a lane. A lane is a voxel:
    ``bench.mc_step_stats`` gives the port's voxels, their crossing edges
    per voxel as ``budget`` and an edge's mean steps, so the bytes are K6's
    own and the evaluations its edges'."""
    evals = budget * (newton_steps * MC_GRAD_EVAL_COST + MC_NORMAL_EVALS) + corner_evals_per_lane
    return Roofline(lanes * evals * ops_per_eval, lanes * MC_VOXEL_BYTES)


# ---------------------------------------------------------------------------
# the grid kernels K8, K9 and P1 (csrc/grid_sdf.cuh, csrc/grid_kernel.cu),
# a floor counting one; outside the grid box the step adds a sqrt, a max
# and a subtract, not counted here
# ---------------------------------------------------------------------------

BOX_STEP = 19  # outside_step: 3 axes of 4 (two subtracts, two maxes), |o|^2 5, two compares
INTERP = 59  # InterpF32: coordinates 3 x 4, floors 3, fractions 3, 1 - fx, four x-lerps
# of 3, two y-lerps and the z-lerp of 3, and BOX_STEP
HAT = 83  # Hat: per axis the coordinate 4, floor, the two weights 4 + 5 (42); four
# (x, y) weights; two z planes of 4 products and 3 adds; the z sum 3; BOX_STEP; margin

#: csrc/grid_sdf.cuh grid_scene, a mesh asset's grid as a scene of K6 and K7.
#: Its terms of one axis: the offset, the coordinate 4 (subtract, multiply,
#: max, min), the floor, the fraction and the outside's 4 (two subtracts,
#: two maxes); "weights" adds 1 - fx to the x axis
GRID_AXIS = 1 + 4 + 1 + 1 + 4
#: its terms of every axis: four x-lerps of 3 (sub, multiply, add;
#: "weights": two multiplies and an add), two y-lerps and the z-lerp of 3,
#: |o|^2 5, the two compares, and the step's difference and max, taken in
#: either case
GRID_POINT = 12 + 9 + 5 + 2 + 2
GRID_SDF = {"lerp": 3 * GRID_AXIS + GRID_POINT, "weights": 3 * GRID_AXIS + 1 + GRID_POINT}
#: its fd4 stencil beside STENCIL, counted as the shared-term stencil is: an
#: axis's terms at the centre and at the 4 points of that axis (a shift
#: along another leaves them alone), the terms of every axis (and the eight
#: gathers) at each of the 12 points
GRID_STENCIL = {form: 5 * (GRID_SDF[form] - GRID_POINT) + 12 * GRID_POINT
                for form in GRID_SDF}
#: its backward beside the value: the step's weights (a TIE; a TIE and a
#: subtract; the sqrt's weight, a multiply and a division), the z-, y- and
#: x-lerps' cotangents (ct_fz 1, ct_c1 1, ct_c0 1, ct_fy 3, the four corner
#: cotangents 4; fx's four terms summed, 4 multiplies and 3 adds, "weights"
#: 8 multiplies and 7 adds), and per axis 25 (the clamp's two TIEs and
#: products, the scale, the outside's square, its max's TIE and product,
#: the two bounds' TIEs and products, the difference and the sum)
GRID_GRAD = {form: GRID_SDF[form] + TIE + (TIE + 1) + 2 + 10 + fx + 3 * 25
             for form, fx in (("lerp", 7), ("weights", 15))}

#: the bake's FP32 operations per (node, triangle) pair, counted on its twin
#: (models/mesh_sdf.py _point_triangle_dist_sq, _winding_number): ap 3, d1 and
#: d2 5 each, s and t 4 each (2 multiplies, a subtract, a division); the
#: interior candidate 25 (clamp 2, t's max, 1 - s and min 3, q 15, |q|^2 5);
#: the ab and ac edges 17 each (a division, a clamp 2, a + s e - p 9, |q|^2
#: 5: the other coordinate is 0, and its term adds a signed zero, so
#: csrc/bake_kernel.cu edge_eval's bits are the twin's); bc 37 (bp 3, the
#: dot 5, a division, a clamp 2, 1 - u, the candidate 25); the three minima
#: and the running one 4; the solid angle: b - p and c - p 6 (a - p is -ap
#: exactly), the three lengths 18 (5 and a sqrt each), b x c 9, the
#: determinant 5, the denominator 23, atan2f (LIBM), the doubling and the
#: running sum 2
BAKE_PAIR = 21 + 25 + 2 * 17 + 37 + 4 + 6 + 18 + 9 + 5 + 23 + LIBM["atan2f"] + 2
#: per triangle, once: ab, ac and bc 9, ab.ab, ab.ac, ac.ac and bc.bc 20, the
#: determinant 4, the three floors 3
BAKE_TRIANGLE = 36
#: per node: the sqrt, the division by 4 pi, the compare
BAKE_NODE = 3


#: of BAKE_PAIR, the distance's (ap, d1, d2, s, t, the four candidates and
#: the minima) and the winding number's, which takes a - p (3) itself where
#: the distance is not evaluated
BAKE_DISTANCE = 21 + 25 + 2 * 17 + 37 + 4
BAKE_WINDING = BAKE_PAIR - BAKE_DISTANCE + 3
#: a cluster's bound against a brick (csrc/bake_kernel.cu cluster_bound):
#: per axis two subtracts and three maxima, the squares' sum 5 and the
#: scaling, and the compare
BAKE_CULL = 3 * 5 + 5 + 1 + 1


def bake_ops(nodes: int, triangles: int) -> float:
    """FP32 operations of the bake of ``nodes`` lattice nodes against
    ``triangles`` triangles, every node meeting every triangle."""
    return float(nodes) * triangles * BAKE_PAIR + nodes * BAKE_NODE + triangles * BAKE_TRIANGLE


def bake_design_ops(nodes: int, triangles: int, distance_pairs: int, bounds: int) -> float:
    """FP32 operations of the work the culled bake does: the winding number
    over every (node, triangle) pair, the distance over the ``distance_pairs``
    it evaluated, and ``bounds`` clusters' bounds against a brick."""
    return (float(nodes) * triangles * BAKE_WINDING + float(distance_pairs) * BAKE_DISTANCE
            + float(bounds) * BAKE_CULL + nodes * BAKE_NODE + triangles * BAKE_TRIANGLE)


def bake_bytes(resolution: int, triangles: int) -> int:
    """The bake's least traffic: the lattice's three axes and the
    triangles' vertices read (36 B each), the table written."""
    return 12 * resolution + 36 * triangles + 4 * resolution**3
