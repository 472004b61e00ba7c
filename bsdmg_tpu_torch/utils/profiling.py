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


def sdf_ops(desc) -> int:
    """scene_sdf.cuh scene_sdf: the transform (3 subtracts, 9 multiplies,
    6 adds), the object's capsules, the sphere (3 multiplies, 2 adds, sqrt,
    subtract), the smooth-min (subtract, abs, subtract, max, multiply, min,
    3 multiplies, subtract), the frame's capsules and a min."""
    n = capsule_ops(desc.object) + 7 + 10
    if desc.translation is not None:
        n += 18
    if desc.frame is not None:
        n += capsule_ops(desc.frame) + 1
    return n


def grad_ops(desc) -> int:
    """scene_sdf.cuh scene_sdf_grad: the forward (scene_sdf's operations),
    the smooth-min backward (ct_h3 1, ct_h2 1, ct_h 5, ct_u 5, ct_delta 1,
    ct_skel 5, ct_sph 5, ct_s2 2), the sphere's (3 multiplies, 3 doubled
    sums), the capsules' backward, the frame's two weights and the
    transposed rotation (15)."""
    n = sdf_ops(desc) + 25 + 9 + capsule_bwd_ops(desc.object)
    if desc.frame is not None:
        n += 2 * TIE + capsule_bwd_ops(desc.frame)
    if desc.translation is not None:
        n += 15
    return n


def fd4_ops(desc) -> int:
    """project.cuh fd4_grad: 2*eps, 12 SDFs at a shifted coordinate (an add
    each) and the stencil's 5 per axis."""
    return 1 + 12 * (sdf_ops(desc) + 1) + 15


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


def shade_ops(desc) -> int:
    """A hit's fd4 normal and shading (render_kernel.cu shade_pixel): the
    point (6), 2*eps, 12 shifted SDFs, the stencil (15), the normalisation
    (7), the Lambert term (10) and the colour mix (6)."""
    return 6 + 1 + 12 * (sdf_ops(desc) + 1) + 15 + 7 + 10 + 6


def march_ops(desc, evals: int, advances: int, culled_rays: int) -> int:
    """The exact march of K1 or K2: each evaluation its SDF and
    MARCH_EVAL, each advance MARCH_ADVANCE, and the slab cull of each ray
    that runs it."""
    return (evals * (sdf_ops(desc) + MARCH_EVAL) + advances * MARCH_ADVANCE
            + culled_rays * CULL)


def render_ops(desc, evals: int, advances: int, hits: int, pixels: int) -> int:
    """K1: the march, each hit's normal and shading, and per pixel the slab
    cull and ACES (RAY)."""
    return march_ops(desc, evals, advances, 0) + hits * shade_ops(desc) + pixels * RAY


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


def render_roofline(desc, width: int, height: int, avg_steps: float, hits: int = 0) -> Roofline:
    """Speed of light of K1's render at ``width`` x ``height``: every ray
    takes ``avg_steps`` march steps (an evaluation and an advance each; the
    bench passes the mean over K1's 8x4 warp patches of their slowest ray's
    steps, which is what the card executes), ``hits`` rays are shaded, and
    each moves :func:`render_bytes`."""
    rays = width * height
    steps = rays * avg_steps
    return Roofline(render_ops(desc, steps, steps, hits, rays), render_bytes(rays))


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


def k4_ops(npix, evals, advances, frame, transform, bounds, track) -> int:
    """diff_kernel.cu march_params_kernel: the cull, each evaluation (the
    point 6, the SDF, cd, cd + eps, the hit test; the margin and its compare
    with track_min), each advance 3, and every ray's dfdt (the point 6,
    the value and gradient, the dot 5)."""
    return (npix * (CULL if bounds else 0) + evals * (param_sdf_ops(frame, transform) + 9 + 2 * track)
            + advances * 3 + npix * (11 + param_grad_ops(frame, transform)))


def k5_ops(npix, evals, advances, hits, hinges, n_tangents, frame, transform, edge) -> int:
    """diff_kernel.cu loss_grad_kernel: K4's march and, per hit, its dfdt
    and guard (2), then in duals (each operation counted with one
    operation per tangent; a product's tangent takes 3, so this stays a
    lower bound) the residual (SDF, 5), t_diff and q (8), the value and
    gradient, the normalisation (8) and normal (3), the shading and ACES;
    a miss's ACES in float; per pixel the squared error (9) and the warp
    sum (5) in duals; per hinge the point (6) and in duals the SDF and 7."""
    t = n_tangents + 1
    sdf, grad = param_sdf_ops(frame, transform), param_grad_ops(frame, transform)
    return (npix * CULL + evals * (sdf + 9 + 2 * edge) + advances * 3
            + hits * (6 + 11 + grad + 2 + t * (sdf + 5 + 8 + grad + 8 + 3 + SHADE + ACES))
            + (npix - hits) * ACES + npix * t * 14 + hinges * (6 + t * (sdf + 7)))


def grad_roofline(width: int, height: int, avg_steps: float, hits: int, *,
                  n_tangents: int = 9, frame: bool = True, transform: bool = False) -> Roofline:
    """Speed of light of K5 (the fused loss and gradient, no edge term) at
    ``width`` x ``height``: every ray takes ``avg_steps`` march steps,
    ``hits`` rays differentiate their shading in ``n_tangents`` tangents,
    each ray reads 40 B (its ray and target colour)."""
    rays = width * height
    steps = rays * avg_steps
    return Roofline(k5_ops(rays, steps, steps, hits, 0, n_tangents, frame, transform, False),
                    rays * 40)


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
