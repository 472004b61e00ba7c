#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bsdmg_tpu_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times   # phase 1, the build and phase 2's kernel times
    python3 chip_smoke.py --grid-faults    # the grid form's bars under planted faults

Run from the repository root on a machine with an NVIDIA Hopper card, nvcc
and PyTorch built for CUDA. Phases, each reported on its own line:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build every kernel from bsdmg_tpu_torch/csrc with nvcc, one process per
   source, all started together; then the march probe: K1's march loop in
   the library's SASS (cuobjdump), ptxas's registers and spills of every
   K1, K2 and K5 instantiation (a K5 spill, or more than 128 registers,
   fails the run), the latency of one march step of the 1920x1080 frame's
   longest ray marched alone, and K5's 64x64 fit point against its longest
   ray alone; K4's march probe: ptxas's registers and the SASS loops of K4
   and of K5's march launch, the steps of the fit's target render at 64x64,
   512x512 and 1920x1080 beside K1's on the same 1920x1080 rays, K4 there
   with the step limit at 1, and the latency of one step of the 64x64
   point's longest ray marched alone; the stencil probe: ptxas's
   registers and stack and the SASS counts (instructions, MUFU, CALL, per
   loop) of K1, K3, K6 and K7, the kernels that run the fd4 stencil; the
   K1, K2, K3, K4 and K5 each alone in CUDA graphs (one JSON line, which
   the later phases reuse, and which compares two commits when run from
   each), with K3's hits at 1920x1080 (the warps that hold one, those that
   hold a miss too, the warps when each 16x8 tile lists its hits) and its
   bound, and K6 at levels 3 and 5, K7 at level 3 (on the staged path's
   inputs, the listed crossing edges, and on the JAX kernel's padded
   lanes) and K9's two levels, K8's finish and P1 on the 1080p torus and
   K8 fresh on its 64^3 mip (the gather route) alone (another line), with
   the Newton and march step statistics that set their warps' divergence
   (K7's SIMT efficiency in the padded and the listed order; for the grid
   launches, warp-steps in row order, 16x8-tile order and with each tile's
   marched rays compacted), K6's and K7's bounds from the tree's counts,
   ptxas's registers and spills of K6, K7, K8, K9 and P1, the SASS loops
   of K8 and K9, and ``cli mesh --interpolate-edges`` twice with its wall
   time (``--kernel-times`` runs this much and K4's probe);
3. the render path: ``cli render -o <tmp>.png`` at the default 1920x1080,
   which must launch K1;
4. K1 against its plain PyTorch version at 1920x1080 (bit for bit), and at
   256x144 against the committed golden render;
5. K1 and plain times from CUDA events at 1920x1080 and 2560x1440;
6. the bench path: ``cli bench --which render`` at 1920x1080 single-phase
   (must launch K1), ``--two-phase row`` (must launch K2 and K3),
   ``--two-phase block`` (K1 at least twice) and ``--roofline``, each
   printing its JSON; K2 (culled, uncull'd, phase A at 16, 32 and 48 steps
   and the tail after each, relaxed), K3 on K2's planes (and on a 100x37
   crop of them whose partial 16x8 tiles hold hits), and K1 relaxed,
   in phase A and resumed over its block list, against their plain
   versions bit for bit; the row, block and unfused images against K1's;
   each pipeline (K1, row, block, unfused) culled or not, exact or relaxed
   (omega 1.5), against the twins composed alike, bit for bit, at
   1920x1080 and 2560x1440; K1, K2 and K3 each alone at 1920x1080 and
   2560x1440, the pipelines through the wrapper; the divergence split
   (phase A capped at 16, 32 and 48 steps, the tail's list, phase B, K3,
   against K1) with bounds; K1's phase A at 16 and 48 steps against K1;
7. the mesh path: ``cli mesh -o <tmp>.obj`` at its defaults (level 3),
   which must launch K6 and give the JAX package's voxel, triangle and
   vertex counts; then ``cli mesh --interpolate-edges``, which must launch
   K7;
8. K6 and K7 against their plain versions at level 3 (bit for bit, and the
   JAX package's Pallas-vs-XLA bars; K7 on the staged path's listed
   crossing edges and on the padded lanes with inactive points), K6 also
   at level 5, and at level 3
   with the centroid winding, fd4 projection normals, and budgets 12, 6
   and 2 over the voxels with 256 checkerboard voxels (all 12 edges cross)
   appended;
9. K6 times (alone and through the wrapper) at levels 3 and 5, K7 at level
   3, the plain versions at level 3; the stage times of mesh generation: refine to level 5, then
   extraction, weld and OBJ write at levels 3 and 5, the native weld and
   OBJ writer (the defaults) beside the NumPy weld (equal faces) and the
   Python writer (equal lines but the header);
9b. the session path: ``cli session --scene reference_object --keys
   vbbbvv``, which must launch K6 once per extraction (5) and write
   ``cli mesh``'s counts; then each other built-in scene (sphere, box,
   wrapped_object, mandelbulb from (2, 1, -2)): ``cli render --scene`` at
   1920x1080 (K1 once), K1 against its twin and alone with its bound and
   registers, the row and block pipelines against the twins at 960x540,
   ``cli mesh --scene`` (K6) and ``--interpolate-edges`` (K7), and K6 and
   K7 against their twins at level 3: bit for bit with NaN at the same
   places, but the mandelbulb, held by its agreement bars (libm rounds
   differently: outcomes, depth and RGB of K1, row and block; K6's
   vertices and K7's points), its fractions printed; then the libm probe:
   the FP32 operations of one call of each libm function the mandelbulb
   and the wrap call, on the path each of the twins' arguments at
   1920x1080 takes (an instrumented PTX kernel), which must be
   utils/profiling.py LIBM;
9c. the composed scenes (examples/gadget, mushroom and snowman.json, and
   an unbounded spec with a plane, which K1 does not cull): ``cli render
   --scene <spec>.json`` at 1920x1080 (K1 once), K1 against its twin bit
   for bit and alone with its bound, registers, stack and local memory;
   the row and block pipelines against the twins at 960x540; ``cli mesh
   --scene`` (K6) and ``--interpolate-edges`` (K7), K6 and K7 against
   their twins at level 3 (NaN at the same places) and alone with their
   bounds; ``cli session --scene examples/snowman.json`` (K6 five times);
   ``cli animate`` at 480x270, 4 frames, orbiting the gadget and moving the
   gadget wrapped in a root transform (K1 once a frame);
10. the fit path: ``cli fit --image`` at its defaults (64x64, 60 steps),
    which must launch K4 (the target) and K5 once per step, with a falling
    loss; the same 60 steps through K4's and K5's plain versions on the
    card, with K5 held against its plain version at every step's
    parameters, and the two fits' parameters compared after 10 to 60 steps
    (beside a fit of the plain versions from a start one float32 step
    away, which shows how far rounding alone parts two fits); ``cli fit
    --image`` at 512x512 for 10 steps (the JAX package's training operating point) and
    ``--steps 0`` beside each size, for the time per step; ``cli fit``
    (depth) at its defaults, whose loss must fall;
11. K4 against its plain version with the scene's 16 parameter values and
    with the fit's 9 at 1920x1080, 512x512 and 64x64, track_min off and on
    (depth, steps, outcome, min_m and t_min bit for bit, dfdt within a
    bar), K5 against its plain version at 512x512 at the bench point and
    the fit point, the latter also with 16 values, and at the fit point at
    64x64 and 1920x1080 (the JAX package's bars, and bit-equal across two
    calls); K4 and K5 times (K5's launches alone in a CUDA graph) at the
    64x64 fit point, 512x512 and 1920x1080 with their bounds and the plain
    versions' beside them, registers and local memory; then the image fit
    of every other scene (FIT_SCENES: the sphere, the mandelbulb from
    (2, 1, -2), the wrapped object, the gadget, mushroom and snowman
    examples and the ground and lattice specs): ``cli fit --image`` at
    64x64 and 60 steps (K4 at least once, K5 60 times; the loss falls, or
    the kernels' first steps follow the plain versions'), K4 and K5 in the
    scene's parameter form against their plain versions at 64x64 and
    512x512 (K4 bit for bit but dfdt; K5 within the bars, NaN at the same
    places; the mandelbulb by its bars, BULB_*), their times alone with
    bounds, and ptxas's registers, stack and spills of each form's
    instantiations (a composed scene's reverse launch,
    ``loss_reverse_kernel``, in both tiers, which the wrapped object's K5
    runs too); K5's tangent launches counted by instantiation
    (``diff_kernel.TANGENT_LAUNCHES``, as K5 reports the launch it made):
    the wrapped object's the reverse sweep, the mandelbulb's its directions
    on 4 lanes a ray where 4 lanes a 16x8 list take no more blocks than the
    card has SMs (64x64; the same bits as one lane a ray:
    ``direction_bits``), in the fit and at each size; each scene's K4 and
    K5 (as the fit launched it, at 64x64) join the kernels line;
12. the mesh-asset path: ``tools/make_torus.py`` writes a torus OBJ and
    ``cli render --scene mesh:<tmp>/torus.obj --camera 3 1.5 -3`` bakes a
    128^3 grid and renders 1920x1080, which must launch K9 twice (the 32^3
    and 64^3 bf16 mips), K8 once (the fine finish) and P1 once (the hit
    normals); its PNG's hit pixels, the bake's peak device memory and the
    stage times (load, bake, mips, each level, finish, normals, shade,
    PNG) from the same steps on the CLI's grid; the native OBJ reader
    against the Python one on the torus (equal arrays);
13. each of those launches, K8 alone on the 64^3 mip (the gather route) and
    P1 on the stencil points against their plain versions on the same
    inputs (bit for bit); K8 resumed in place and through the public
    wrapper, on the 1080p finish state, on a 100x37 frame (fresh and
    resumed) and with no ray and every ray active; P1 on the probe's own
    inputs against the probe's trilinear oracle (1e-4), with ``torch.nn.functional.grid_sample``'s
    time beside it; the gather route's image against the contraction
    route's (>= 99% of pixels within 1e-3);
14. frame and kernel times of the mesh-asset render at the JAX bench's grid
    point (the reference object baked analytically at 128^3 over +-2.6,
    512x512 from (5, 2, -5)) and at the 1080p torus frame, with each
    kernel's bound; ptxas's registers and spills of grid_kernel.cu;
15. mesh-asset scenes through every verb: the bake kernel on the torus at
    128^3 (every node) and 256^3 (every 97th node and one lattice plane)
    against its twin (|values| bit for bit, signs but within 1e-4 of a
    winding number of 1/2), alone with the share of the distance pairs its
    cull evaluated and its bound, the work the function needs (the winding
    number over every pair, the distance over those pairs), the bound over
    all pairs beside it (``bake_all_pairs_ms``), and with the last triangle dropped and one triangle's winding flipped,
    each of which must fail its bar, and its cull's margin set negative,
    which must fail the magnitude bar on ``margin_axes``' node sets; ``cli mesh --scene mesh:<torus>`` (K6 and the bake once),
    ``--interpolate-edges`` (K7), ``cli remesh`` (K6), ``cli session`` (K6
    five times), ``cli animate --motion spheric`` (the grid route a frame,
    the motion ignored with a warning) and the depth ``cli fit``, with no
    plain twin of K6, K7 or the bake allowed, and ``fit --image`` (K4 once
    and K5 60 times in their grid form, ``MeshGridForm``, the loss ~0 at
    every logged step: the grid reads no parameter), with that form's K4
    and K5 against their plain versions on the 128^3 bake at 64x64 and
    512x512 (K4 bit for bit but dfdt, within 1e-5; K5's loss within 1e-4
    relative against a black target and within 1e-8 at the fit's target,
    its gradient zero), alone with their bounds (bytes with the table
    values read) and no spill; K6 and K7 over the grid structure
    in the lerp form at ``cli mesh``'s level 3 and K6 in the weights form at
    ``cli remesh``'s level 2 against their twins, bit for bit, alone with
    their bounds; the reference K6 and K7 at the registers they took
    before the grid structures and no spill; then BASELINE's mesh-asset configuration
    (``tools/e2e_mesh_1024.py``'s workload): the 256^3 bake, a 512x512
    render, the extraction from 32^3 with 5 refines (1024^3), the native
    weld and OBJ write, with each stage's seconds, the counts and the
    vertices' |sdf|;
16. the multi-device paths (``bsdmg_tpu_torch/parallel/``): in this
    process, a world of one rank on NCCL: ``cli render --sharded`` (K1) and
    ``--scene mesh:<torus>:128`` (K9 twice, K8, P1), each with the
    unsharded command's launches, one ``all_gather`` and its image bit for
    bit, ``cli mesh --sharded`` (K6) and ``--interpolate-edges`` (K7) with
    ``cli mesh``'s counts, ``cli bench --which scaling`` and
    ``scaling-proxy``; then two gloo ranks sharing the card
    (``parallel/launch.py``), whose sharded frames (K1; K2 and K3; block
    retirement; the torus) are bit-equal to the single-device frames,
    whose sharded mesh at levels 3 and 5 (K6) has the single-device
    triangles, vertices and sorted vertices, whose steps
    (``train_step_fused``, K5, at 512x512; ``train_step``, K4, at 64x64)
    meet the JAX bars against the single-device step with the ranks'
    parameters bit-equal, each path with its kernels' launches, its
    collectives and its wall time beside the unsharded path's; then the
    scaling benches at two ranks. Both ranks share one card: the times
    are striping and gathering costs, not scaling;
17. the wrapped object moved by its object transform (structure 11,
    ``Wrapped<Box<false, true>>``): its K1, K2, K3, K6 and K7
    instantiations without a spill, ``cli animate --motion axis --scene
    wrapped_object`` (K1 once a frame: structure 7 for the first, unmoved
    frame, 11 for each later one), K1 against its twin at 1920x1080
    bit for bit and alone with its bound, the row and block pipelines at
    320x180 and K6 and K7 at level 2 of init factor 16 against their twins;
18. ``cli bench --roofline --which all``: the refine and marching-cubes
    rooflines' share of the speed of light beside the render's and the
    grad's;
19. the near/far split (``compile_scene_split``) of the reference render
    scene at 1920x1080 and 2560x1440: each pipeline of
    ``render_image_cuda`` (K1; K1 twice; K2, K2 over the listed tail, K3;
    K2 and K3) with the split, bit for bit against the twins composed
    alike, and within the JAX package's bars of the frame without it (max
    |drgb| > 1e-3 on under 0.1% of the pixels, the mean under 1e-5); the
    split kernels' ptxas and SASS loops, their warp work (far patches,
    warp-steps, hits per warp, the row tail's listed launch after 16, 32
    and 48 steps) and the fused image against the row pipeline's; K1 and
    K2 alone with and without it, with bounds from this run's far and near
    evaluations and hits; K4 and K5 with the
    split at the bench's 512x512 point and the fit's 64x64 point against
    their twins (K4 bit for bit but dfdt; K5 within the bars) and alone
    with and without it;
20. K4 (512x512) and K8 (a 64^3 sphere grid) at ``relaxation=1.5``, bit
    for bit their results at 1.0;
21. K5's reverse sweep under planted faults (REVERSE_FAULTS: SMOOTH's
    parameter adjoint dropped, on the snowman; the wrap's cell adjoint
    without its quotient, on the wrapped object), each in a copy of the
    tree whose changed sources build in the background from the start
    (``FaultBuilds``): K5 on the fault's scene at 64x64 and 512x512 must
    hold its bars from this tree and fail them from the copy.

The composed scenes of phase 9c (and the image fit of the other scenes
beside phase 11) include two specs beyond the small tier of the
interpreters' caps (a union of 40 spheres, 79
instructions and 160 parameter values; ten nested transforms), which run
in the kernels' large tier (``ComposedLarge`` in K1-K3, K6, K7;
``ProgramLargeForm`` in K4, K5): ``cli render``, ``cli mesh`` and, for
the union, ``cli fit --image``, each kernel against its twin.

``--grid-faults`` builds a copy of the tree per planted fault of the grid
form (dfdt without its z term; the shading normal's z flipped) and
prints the bars each fails, beside the sound tree's (none).

Each path runs with every kernel's launch count set to 0 just before it and
read just after; a path that did not launch its kernel fails. Then one JSON
line describing each kernel (its bound from this run's counts: the bytes it
must move over HBM's rate, or its FP32 operations over the FP32 peak,
counted by ``bsdmg_tpu_torch/utils/profiling.py`` as the bench counts), the
card's line, and as the last line ``{"ok": true, "device": {...}}``. Any
failed phase raises and the script exits non-zero; without a CUDA device it
exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import io
import json
import logging
import math
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from bsdmg_tpu_torch.utils.profiling import (
    HAT,
    INTERP,
    MARCH_ADVANCE,
    MARCH_EVAL,
    MC_VOXEL_BYTES,
    bound,
    k4_ops,
    k5_ops,
    march_ops,
    march_work,
    mesh_ops,
    render_bytes,
    render_ops,
    resumed_work,
    shade_bytes,
    shade_pass_ops,
    trace_bytes,
)

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "render_256x144.npz"
SCREEN = (1920.0, 1080.0)
# bars of tests/test_torch_render_kernel.py and tests/test_pallas.py:117-119
OUTCOME_AGREEMENT = 0.999
DEPTH_ATOL = 1e-4
PIXEL_ATOL = 2e-2
PIXEL_SHARE = 0.999
MEAN_ATOL = 1e-4
# golden bars of tests/test_render.py:178-181
GOLDEN_SHARE = 0.995
GOLDEN_MEAN = 1e-3
# mesh bars of tests/test_mesh.py:314-320 (Pallas kernels against XLA)
POSITION_ATOL = 2e-5
NORMAL_ATOL = 2e-4
# `cli mesh` at its defaults, as the JAX package and the port give it on a CPU
MESH_LEVEL_VOXELS = [32768, 4136, 16532, 66124]
MESH_TRIANGLES = 132272
MESH_VERTICES = 66130

# bars of K4 and K5 against their plain versions: the JAX package's Pallas
# kernels against their oracles (tests/test_grad.py:296-301, :373-378);
# dfdt is the kernel's hand-written gradient against the plain version's
# autograd, which sum in other orders
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3
GRAD_ATOL = 1e-6
DFDT_ATOL = 1e-5
# `cli fit --image`'s defaults: its perturbation, learning rate and steps
FIT_PERTURB = {"sphere_radius": ("mul", 1.25), "smooth_k": ("mul", 0.7),
               "skeleton_line_width": ("mul", 1.3)}
FIT_LR = 0.2
FIT_STEPS = 60
FIT_SNAPSHOTS = (10, 20, 30, 40, 50, FIT_STEPS)
# the parameters of the CLI's Adam steps through the kernels and through
# their plain versions: after 10 steps within a twentieth of one step
# (0.02); after all 60 the watched ones within 5% of their values. From
# step ~20 the fit parts two runs whose gradients differ by rounding: on an
# NVIDIA H100 80GB HBM3 at 700 W, K5 stayed within the gradient bars at
# every step's parameters and no gradient's sign differed, yet after 60
# steps the runs parted by up to 2.9% (skeleton_line_width), and two runs of
# the plain versions whose starts differ by one float32 step in
# sphere_radius parted by up to 2.0%
FIT_PARAM_ATOL_10 = 1e-3
FIT_PARAM_RTOL = 5e-2
#: the mandelbulb's estimator overshoots far from the set: from the JAX
#: bench's camera every ray misses it, in both packages
MANDELBULB_CAMERA = (2.0, 1.0, -2.0)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def rays(width: int, height: int, device, camera=None):
    """The CLI's rays: from ``camera`` (default (5, 2, -5)) at the origin."""
    from bsdmg_tpu_torch.cam import generate_rays, look_at

    cam = look_at(camera or (5.0, 2.0, -5.0), fov=np.pi / 4, device=device)
    return generate_rays(cam, (width, height), SCREEN)


def edge_tile_window(hit: torch.Tensor, width: int, height: int) -> tuple[int, int, dict]:
    """``(y0, x0, hits)``: the window of ``hit`` (an ``(H, W)`` mask),
    ``width`` x ``height`` at even offsets, whose partial 16x8 tiles (the
    last column of tiles, the last row and their corner) hold the most
    hits and misses (the first that holds the largest least count of
    either in any of the three), and those tiles' hits."""
    tail_w, tail_h = width % 16, height % 8
    table = torch.nn.functional.pad(torch.cumsum(torch.cumsum(hit.long(), 0), 1), (1, 0, 1, 0))
    ny, nx = hit.shape[0] - height + 1, hit.shape[1] - width + 1

    def box(dy, dx, h, w):  # hits in [y0 + dy, +h) x [x0 + dx, +w) for every (y0, x0)
        return (table[dy + h:dy + h + ny, dx + w:dx + w + nx] - table[dy:dy + ny, dx + w:dx + w + nx]
                - table[dy + h:dy + h + ny, dx:dx + nx] + table[dy:dy + ny, dx:dx + nx])

    parts = {"column": (0, width - tail_w, height, tail_w),
             "row": (height - tail_h, 0, tail_h, width),
             "corner": (height - tail_h, width - tail_w, tail_h, tail_w)}
    counts = {k: box(*v) for k, v in parts.items()}
    least = torch.stack([torch.minimum(counts[k], h * w - counts[k])
                         for k, (_, _, h, w) in parts.items()]).amin(0)
    least[1::2] = -1
    least[:, 1::2] = -1
    y0, x0 = divmod(int(torch.argmax(least.reshape(-1))), nx)
    check(int(least[y0, x0]) > 0, "no window's partial tiles hold both hits and misses")
    return y0, x0, {k: int(v[y0, x0]) for k, v in counts.items()}


def compare(kernel, plain) -> dict:
    """Agreement of K1's ``(rgb, depth, steps, outcome)`` with the plain
    version's, checked against the bars."""
    rgb_k, depth_k, steps_k, out_k = kernel
    rgb_p, depth_p, steps_p, out_p = plain
    same = out_k == out_p
    both_hit = same & (out_k == 0)
    diff = (rgb_k - rgb_p).abs().amax(dim=-1)
    stats = {
        "outcome_agreement": same.float().mean().item(),
        "steps_mismatch": int((same & (steps_k != steps_p)).sum().item()),
        "depth_max_err": (depth_k - depth_p).abs()[both_hit].max().item() if both_hit.any() else 0.0,
        "pixel_share": (diff < PIXEL_ATOL).float().mean().item(),
        "mean_err": diff.mean().item(),
        "max_abs_err": diff.max().item(),
        "exact": bool(torch.equal(rgb_k, rgb_p) and torch.equal(depth_k, depth_p)
                      and torch.equal(steps_k, steps_p) and torch.equal(out_k, out_p)),
    }
    check(stats["outcome_agreement"] >= OUTCOME_AGREEMENT, f"outcome agreement {stats}")
    check(stats["steps_mismatch"] == 0, f"steps differ where outcomes agree {stats}")
    check(stats["depth_max_err"] <= DEPTH_ATOL, f"collision depth {stats}")
    check(stats["pixel_share"] >= PIXEL_SHARE, f"pixel share {stats}")
    check(stats["mean_err"] < MEAN_ATOL, f"mean image error {stats}")
    # built with -fmad=false, K1 runs the plain version's float32 operations
    # in the same order: anything but bit equality is a regression
    check(stats["exact"], f"K1 and its plain version are not bit-equal {stats}")
    return stats


def median_ms(fn, runs: int = 7, reps: int = 1, warmup: int = 2) -> float:
    """Median over ``runs`` of the CUDA-event time of ``reps`` calls of
    ``fn``, per call, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def timed_ms(fn):
    """``(fn(), ms)``: one call and its CUDA-event time, for a plain version
    whose result is compared as well as timed."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def reset_launches() -> None:
    from bsdmg_tpu_torch.ops.cuda import (
        bake_kernel,
        diff_kernel,
        grid_kernel,
        mc_kernel,
        mesh_kernel,
        render_kernel,
    )

    for module in (render_kernel, mc_kernel, mesh_kernel, bake_kernel):
        module.LAUNCHES = 0
    render_kernel.TRACE_LAUNCHES = 0
    render_kernel.SHADE_LAUNCHES = 0
    render_kernel.STRUCTURE_LAUNCHES.clear()
    render_kernel.SPLIT_LAUNCHES.clear()
    diff_kernel.MARCH_LAUNCHES = 0
    diff_kernel.LOSS_GRAD_LAUNCHES = 0
    diff_kernel.SPLIT_LAUNCHES.clear()
    diff_kernel.TANGENT_LAUNCHES.clear()
    diff_kernel.SUM_LAUNCHES.clear()
    for name in grid_kernel.LAUNCHES:
        grid_kernel.LAUNCHES[name] = 0


def render_phases(card: str, device) -> tuple[dict, dict]:
    """Phases 3-5: the render path and K1. Returns the kernels line's entry
    of K1 without the split (its launches those of the library call
    ``render_image_cuda`` without it: the CLI passes the split) and the
    launch counts of ``cli render``, which launches the split's K1."""
    from bsdmg_tpu_torch import cli
    from bsdmg_tpu_torch.models import reference_render_scene
    from bsdmg_tpu_torch.ops.cuda import render_kernel
    from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene
    from bsdmg_tpu_torch.ops.cuda.render_kernel import (
        render_image_cuda,
        render_image_planes_torch,
    )

    with tempfile.TemporaryDirectory() as tmp:
        png = Path(tmp) / "render.png"
        reset_launches()
        t0 = time.perf_counter()
        cli.main(["render", "-o", str(png)])
        seconds = time.perf_counter() - t0
        cli_counts = launch_counts()
        check(cli_counts["K1 split"] > 0, f"cli render did not launch K1 with the split: "
                                          f"{launched(cli_counts)}")
        check(png.is_file() and png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", "no PNG written")
        print(f"render path: cli render 1920x1080 -> {png.stat().st_size} B PNG in {seconds:.2f} s, "
              f"launches {launched(cli_counts)}")

    desc = compile_scene(reference_render_scene(device=device))
    o, d, c = rays(1920, 1080, device)
    reset_launches()
    kernel = render_image_cuda(desc, o, d, c, return_planes=True)
    launches = render_kernel.LAUNCHES
    check(launches > 0 and not render_kernel.SPLIT_LAUNCHES,
          "render_image_cuda without the split did not launch K1 alone")
    plain = render_image_planes_torch(desc, o, d, c)
    torch.cuda.synchronize()
    stats = compare(kernel, plain)
    _, _, steps, outcome = kernel
    counts = torch.bincount(outcome.reshape(-1), minlength=3).tolist()
    print(f"parity 1920x1080: {json.dumps(stats)} outcomes(collision, step, depth)={counts}")

    # this run's work (utils/profiling.py::render_ops)
    evals, advances, hits = march_work(steps, outcome, kernel[1])
    npix = 1920 * 1080
    ops = render_ops(desc, evals, advances, hits, npix)
    bound_ms, bound_by = bound(render_bytes(npix), ops)
    print(f"K1 work 1920x1080: {evals} march SDF evaluations, {hits} normals, "
          f"{ops:.4g} FP32 operations, {render_bytes(npix)} B; bound {bound_ms:.4f} ms ({bound_by})")

    golden = torch.from_numpy(np.load(GOLDEN)["image"]).to(device)
    img = render_image_cuda(desc, *rays(256, 144, device))
    diff = (img - golden).abs().amax(dim=-1)
    share, mean = (diff < PIXEL_ATOL).float().mean().item(), diff.mean().item()
    check(bool(torch.isfinite(img).all()) and img.shape == (144, 256, 3), "256x144 image")
    check(share > GOLDEN_SHARE and mean < GOLDEN_MEAN, f"golden: share {share} mean {mean}")
    print(f"golden 256x144: share under {PIXEL_ATOL} = {share:.6f}, mean {mean:.3e}")

    timings = {}
    for w, h in ((1920, 1080), (2560, 1440)):
        o, d, c = rays(w, h, device)
        k_ms = median_ms(lambda: render_image_cuda(desc, o, d, c), reps=5)
        p_ms = median_ms(lambda: render_image_planes_torch(desc, o, d, c), runs=5, warmup=1)
        timings[(w, h)] = (k_ms, p_ms)
        n = w * h
        print(f"time {w}x{h} on {card}: K1 {k_ms:.3f} ms ({n / k_ms * 1e3:.4g} rays/s), "
              f"plain {p_ms:.3f} ms ({n / p_ms * 1e3:.4g} rays/s)")

    k_ms, p_ms = timings[(1920, 1080)]
    return {
        "name": "K1 render_kernel<Box<true, false>> (fused trace+shade; render_image_cuda without "
                "the split)",
        "route": "cuda",
        "source": render_kernel.SOURCE,
        "replaces": "bsdmg_tpu/ops/pallas/render_kernel.py:336",
        "launches": launches,
        "max_abs_err": stats["max_abs_err"],
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, cli_counts


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def read_obj_counts(path: Path) -> tuple[int, int, int, bool]:
    """``(vertices, normals, faces, finite)`` of an OBJ file; ``finite``:
    every vertex and normal coordinate is a finite number."""
    v = vn = f = 0
    finite = True
    with open(path) as fh:
        for line in fh:
            tag = line[:2]
            if tag in ("v ", "vn"):
                finite = finite and all(np.isfinite(float(x)) for x in line.split()[1:])
                v, vn = (v + 1, vn) if tag == "v " else (v, vn + 1)
            elif tag == "f ":
                f += 1
    return v, vn, f, finite


def run_cli(argv: list[str]) -> tuple[dict, list[str], float]:
    """Runs ``cli <argv>`` with every launch count set to 0; returns the
    counts after it, the CLI's log lines and the seconds it took."""
    from bsdmg_tpu_torch import cli

    records = _Records()
    logger = logging.getLogger("bsdmg_tpu_torch")
    logger.addHandler(records)
    old_level = logger.level
    logger.setLevel(logging.INFO)
    try:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
    finally:
        logger.removeHandler(records)
        logger.setLevel(old_level)
    return launches, records.messages, seconds


# ---------------------------------------------------------------------------
# the trace-only and shade-only paths: K2, K3, and K1 resumed and relaxed
# ---------------------------------------------------------------------------

#: phase-A budgets of the divergence split: the JAX package's phase_a_steps
#: (32 is render_image_pallas's default, 48 the bench's)
PHASE_A_STEPS = (16, 32, 48)
#: `cli bench --which render` at its 1920x1080: single-phase (K1), row
#: two-phase (K2, K2 over the tail, K3), block retirement (K1 twice), and
#: the single-phase run with the roofline
BENCH_RUNS = {
    "plain": [],
    "row": ["--two-phase", "row"],
    "block": ["--two-phase", "block"],
    "roofline": ["--roofline"],
}


def run_bench(extra: list[str]) -> tuple[dict, dict, float]:
    """``cli bench --which render <extra>`` with every launch count set to
    0: its JSON, the counts after it and the seconds it took."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        counts, _, seconds = run_cli(["bench", "--which", "render", *extra])
    return json.loads(out.getvalue()), counts, seconds


def same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


def twin_pipeline(rk, desc, o, d, c, *, two_phase=False, phase_a_steps=32, use_bb_skip=True,
                  omega=1.0, split=None, fused=False):
    """The plain twins composed as ``render_image_cuda`` composes the
    kernels: a single march, or phase A capped at ``phase_a_steps`` then
    the rays of the row tail's list (``tail_list``: with the split in
    8x4-patch order, else row-major) or of the listed 16x8
    blocks resumed, then the shading; with ``split``, the rays grouped as
    the kernels group them (8x4 patches, the row tail's 32 listed rays), and
    in K1's pipelines (block retirement, or ``fused``) a far patch's hits
    shaded with the far scene and each launch shading only the rays it
    marched. Returns ``(rgb, depth, steps, outcome)``."""
    kw = dict(use_bb_skip=use_bb_skip, omega=omega, split=split)
    k1 = fused or two_phase == "block"

    def shade(planes, far):
        return rk.shade_planes_torch(desc, o, d, planes[0], planes[2], far=(
            (split[0], far) if k1 and split is not None else None))

    if two_phase is False:
        *planes, far = rk.trace_far_planes_torch(desc, o, d, c, **kw)
        return shade(planes, far), *planes[:3]
    *a, far = rk.trace_far_planes_torch(desc, o, d, c, budget=phase_a_steps, **kw)
    groups = None
    if two_phase == "block":
        active = a[3] * rk.block_rays(rk.compact_list(rk.block_flags(a[3])), *c.shape)
    else:
        listed = rk.tail_list(a[3], split)
        active = rk.listed_flags(*listed, c.numel()).reshape(c.shape)
        groups = rk.listed_groups(*listed, c.numel())
    *planes, far_b = rk.trace_far_planes_torch(desc, o, d, c, *a[:3], active, groups=groups,
                                               **kw)
    rgb = shade(planes, far_b)
    if two_phase == "block":
        rgb = torch.where(active[..., None] != 0, rgb, shade(a, far))
    return rgb, *planes[:3]


def trace_shade_phases(card: str, device, alone: dict) -> tuple[list[dict], dict]:
    """Phase 6: the bench path and kernels K2 and K3; ``alone`` is
    :func:`kernel_times`'s. Returns the kernels line's entries of K2
    without the split (its launches those of ``cli bench --roofline``'s
    step census, which takes no split) and K3, and each bench run's launch
    counts (the render cells pass the split)."""
    from bsdmg_tpu_torch.config import MarchConfig
    from bsdmg_tpu_torch.models import reference_render_scene
    from bsdmg_tpu_torch.ops.cuda import build
    from bsdmg_tpu_torch.ops.cuda import render_kernel as rk
    from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene

    report = build.resource_report("render_kernel.cu").splitlines()
    registers = sorted({int(line.split("Used ")[1].split()[0]) for line in report if "Used " in line})
    spills = {line.strip() for line in report if "spill" in line}
    print(f"render_kernel.cu: {sum('Compiling entry' in line for line in report)} kernels, "
          f"registers {registers}, {spills}")

    # the bench verb, each run with every launch count at 0 before it
    launches, outs = {}, {}
    for name, extra in BENCH_RUNS.items():
        out, counts, seconds = run_bench(extra)
        k = {n: counts[n] for n in ("K1", "K2", "K3", "K1 split", "K2 split")}
        print(f"bench path ({name}): cli bench --which render {' '.join(extra)} in {seconds:.2f} s, "
              f"launches {k}: {json.dumps(out)}")
        check(np.isfinite(out["render"]["rays_per_s"]) and out["render"]["rays_per_s"] > 0,
              f"cli bench {extra} printed {out}")
        launches[name], outs[name] = k, out
    check(launches["plain"]["K1"] > 0, f"cli bench did not launch K1: {launches['plain']}")
    check(launches["row"]["K2"] > 0 and launches["row"]["K3"] > 0,
          f"cli bench --two-phase row did not launch K2 and K3: {launches['row']}")
    check(launches["block"]["K1"] >= 2, f"cli bench --two-phase block: {launches['block']}")
    census = launches["roofline"]["K2"] - launches["roofline"]["K2 split"]
    check(launches["row"]["K2 split"] > 0 and census > 0,
          f"cli bench --two-phase row did not launch K2 with the split, or cli bench --roofline "
          f"K2 without it: {launches}")
    roof = outs["roofline"].get("roofline", {})
    check({"mean_steps", "mean_tile_max_steps", "max_steps", "mean_warp_max_steps",
           "speed_of_light_ms", "pct_of_roofline"} <= set(roof), f"cli bench --roofline: {roof}")

    # every mode of K2, K3, and K1 relaxed and resumed, against the twins
    cfg = MarchConfig()
    desc = compile_scene(reference_render_scene(device=device))
    o, d, c = rays(1920, 1080, device)
    npix = c.numel()
    exact, errors = {}, {}
    single = rk.trace_cuda(desc, o, d, c)
    exact["K2 culled"] = same(single, rk.trace_planes_torch(desc, o, d, c)[:3])
    uncull = rk.trace_cuda(desc, o, d, c, use_bb_skip=False)
    exact["K2 uncull'd"] = same(uncull, rk.trace_planes_torch(desc, o, d, c, use_bb_skip=False)[:3])
    frame = rk._Frame(desc, o, d, c, cfg, True, 1.0)
    tails = {}
    for n in PHASE_A_STEPS:
        planes = frame.trace(n)
        exact[f"K2 phase A {n}"] = same(planes, rk.trace_planes_torch(desc, o, d, c, budget=n))
        listed = rk.compact_list(planes[3].reshape(-1))
        carried = tuple(x.clone() for x in planes)
        frame.resume_trace(planes, listed)
        twin = rk.trace_planes_torch(desc, o, d, c, *carried)
        exact[f"K2 tail after {n}"] = same(planes[:3], twin[:3])
        exact[f"K2 phase A {n} + tail = single"] = same(planes[:3], single)
        tails[n] = (carried, listed, planes[:3])
    relaxed = rk.trace_cuda(desc, o, d, c, omega=1.5)
    relaxed_twin = rk.trace_planes_torch(desc, o, d, c, omega=1.5)[:3]
    exact["K2 relaxed"] = same(relaxed, relaxed_twin)
    errors["K2"] = max(_max_err(a, b) for a, b in zip(relaxed, relaxed_twin))
    shaded = rk.shade_cuda(desc, o, d, single[0], single[2])
    shaded_twin = rk.shade_planes_torch(desc, o, d, single[0], single[2])
    exact["K3"] = torch.equal(shaded, shaded_twin)
    errors["K3"] = _max_err(shaded, shaded_twin)
    # K3 on a 100x37 frame, whose last tile column (4 pixels) and row (5)
    # are partial, cut from the 1080p frame where those tiles hold hits and
    # misses
    y0, x0, edge_hits = edge_tile_window(single[2] == 0, 100, 37)
    crop = [x[y0:y0 + 37, x0:x0 + 100].contiguous() for x in (o, d, single[0], single[2])]
    exact["K3 100x37 edge tiles"] = torch.equal(rk.shade_cuda(desc, *crop),
                                                rk.shade_planes_torch(desc, *crop))
    k1_relaxed = rk.render_image_cuda(desc, o, d, c, return_planes=True, omega=1.5)
    exact["K1 relaxed"] = same(k1_relaxed, rk.render_image_planes_torch(desc, o, d, c, omega=1.5))
    rgb, *planes = frame.render(48)
    twin = rk.trace_planes_torch(desc, o, d, c, budget=48)
    exact["K1 phase A 48"] = same(planes, twin) and torch.equal(
        rgb, rk.shade_planes_torch(desc, o, d, twin[0], twin[2]))
    blocks = rk.compact_list(rk.block_flags(planes[3]))
    n_blocks = int(blocks[1].item())
    carried = (*(x.clone() for x in planes[:3]), planes[3] * rk.block_rays(blocks, *c.shape))
    frame.resume(rgb, planes, blocks)
    twin = rk.trace_planes_torch(desc, o, d, c, *carried)
    exact["K1 resumed over blocks"] = same(planes, twin) and torch.equal(
        rgb, rk.shade_planes_torch(desc, o, d, twin[0], twin[2]))
    base = rk.render_image_cuda(desc, o, d, c, return_planes=True)
    paths = {"row": dict(two_phase=True), "block": dict(two_phase="block", phase_a_steps=48),
             "swizzle=False": dict(swizzle=False)}
    for name, kw in paths.items():
        exact[f"{name} image = K1's"] = same(rk.render_image_cuda(desc, o, d, c, return_planes=True,
                                                                   **kw), base)
    # every pipeline culled or not, exact or relaxed, against the twins
    # composed alike: each instantiation of K1 and K2, and K3, at 1920x1080
    # and 2560x1440
    for size in ((1920, 1080), (2560, 1440)):
        ro, rd, rc = (o, d, c) if size == (1920, 1080) else rays(*size, device)
        for cull in (True, False):
            for omega in (1.0, 1.5):
                for name, kw in {"K1": {}, **paths}.items():
                    ours = rk.render_image_cuda(desc, ro, rd, rc, return_planes=True,
                                                use_bb_skip=cull, omega=omega, **kw)
                    twin = twin_pipeline(rk, desc, ro, rd, rc, use_bb_skip=cull, omega=omega,
                                         **{k: v for k, v in kw.items() if k != "swizzle"})
                    label = "culled" if cull else "uncull'd"
                    exact[f"{name} {label} omega {omega} {size[0]}x{size[1]} = twin"] = same(ours,
                                                                                            twin)
    torch.cuda.synchronize()
    print(f"parity 1920x1080, bit for bit: {json.dumps(exact)}; {n_blocks} of "
          f"{rk.block_flags(planes[3]).numel()} 16x8 blocks resumed after 48 steps; K3's "
          f"100x37 frame from ({x0}, {y0}), hits in its partial tiles {edge_hits}")
    check(all(exact.values()), f"not bit-equal: {[k for k, v in exact.items() if not v]}")

    # each kernel alone (prepared struct, preallocated outputs, a CUDA
    # graph of 20 launches); the twins and the pipelines by CUDA events
    desc_c = rk.scene_desc_c(desc, cfg)
    step_limit = cfg.step_limit

    times = {(w, h): {k: alone[f"{k} {w}x{h}"] for k in ("K1", "K2", "K3")}
             for w, h in ((1920, 1080), (2560, 1440))}
    for (w, h), t in times.items():
        print(f"time {w}x{h} on {card}, each kernel alone: " + ", ".join(
            f"{k} {v:.4f} ms ({w * h / v * 1e3:.4g} rays/s)" for k, v in t.items()))
    plain = {"K2": median_ms(lambda: rk.trace_planes_torch(desc, o, d, c), runs=5, warmup=1),
             "K3": median_ms(lambda: rk.shade_planes_torch(desc, o, d, single[0], single[2]),
                             runs=5, warmup=1)}
    wrapped = {name: median_ms(lambda: rk.render_image_cuda(desc, o, d, c, **kw), reps=5)
               for name, kw in {"K1": {}, **paths}.items()}
    print(f"time 1920x1080 on {card} through render_image_cuda (CUDA events): "
          f"{json.dumps(wrapped)}; plain twins {json.dumps(plain)}")

    # this run's work and bounds
    evals, advances, hits = march_work(single[1], single[2], single[0])
    k2_ops, k2_bytes = march_ops(desc, evals, advances, npix), trace_bytes(npix)
    k3_ops, k3_bytes = shade_pass_ops(desc, hits, npix), shade_bytes(npix, hits)
    k2_bound, k3_bound = bound(k2_bytes, k2_ops), bound(k3_bytes, k3_ops)
    print(f"K2 work 1920x1080: {evals} SDF evaluations, {k2_ops:.4g} FP32 operations, {k2_bytes} B; "
          f"bound {k2_bound[0]:.4f} ms ({k2_bound[1]}); K3: {hits} hits, {k3_ops:.4g} FP32 "
          f"operations, {k3_bytes} B; bound {k3_bound[0]:.4f} ms ({k3_bound[1]})")

    # the divergence split: phase A capped at n steps, the tail's list,
    # phase B over it (packed into full warps), K3; against K1 alone
    out = tuple(torch.empty_like(p) for p in single)
    active = torch.empty_like(single[2])
    k1_ms = times[(1920, 1080)]["K1"]
    for n in PHASE_A_STEPS:
        state, listed, final = tails[n]
        count = int(listed[1].item())
        a_ms = graph_ms(lambda: rk._trace_cuda(desc_c, o, d, c, None, out, active=active, cap=n))
        list_ms = graph_ms(lambda: rk.compact_list(state[3].reshape(-1)))
        b_ms = graph_ms(lambda: rk._trace_cuda(desc_c, o, d, c, state, out, rays=listed,
                                               cap=step_limit))
        ev, adv, _ = march_work(state[1], state[2], state[0])
        a_bound = bound(trace_bytes(npix, active=True), march_ops(desc, ev, adv, npix))
        b_ops, b_bytes = resumed_work(desc, state, final, count)
        split = {
            "phase_a_steps": n, "phase_a_ms": a_ms, "phase_a_bound_ms": a_bound[0],
            "tail_rays": count, "tail_share": count / npix, "list_ms": list_ms,
            "phase_b_ms": b_ms, "phase_b_bound_ms": bound(b_bytes, b_ops)[0],
            "shade_ms": times[(1920, 1080)]["K3"],
            "sum_ms": a_ms + list_ms + b_ms + times[(1920, 1080)]["K3"], "k1_ms": k1_ms,
        }
        print(f"divergence split on {card}: {json.dumps(split)}")

    # block retirement's two K1 launches alone (kernel_times), and the
    # pipeline through the wrapper
    a1_ms = {n: alone[f"K1 phase A {n} 1920x1080"] for n in (16, 48)}
    print(f"block retirement on {card}: K1 phase A (48 steps) {a1_ms[48]:.4f} ms, K1 over "
          f"{alone['K1 resume 48 blocks']} blocks {alone['K1 resume 48 1920x1080']:.4f} ms; the "
          f"pipeline {alone['block pipeline 48 1920x1080']:.4f} ms; K1 alone {k1_ms:.4f} ms")
    # K1's time split by steps: its phase A (shading included) at 16 and 48
    # steps, alone, and what the rays past 48 steps add
    split = {"phase_a_16_ms": a1_ms[16], "phase_a_48_ms": a1_ms[48], "k1_ms": k1_ms,
             "steps_16_48_ms": a1_ms[48] - a1_ms[16], "after_48_ms": k1_ms - a1_ms[48]}
    print(f"K1 split on {card}: {json.dumps(split)}")

    return [{
        "name": "K2 trace_kernel<Box<true, false>> (trace only, resumable; without the split)",
        "route": "cuda",
        "source": rk.SOURCE,
        "replaces": "bsdmg_tpu/ops/pallas/render_kernel.py:495",
        "launches": census,
        "max_abs_err": errors["K2"],
        "ms": times[(1920, 1080)]["K2"],
        "plain_ms": plain["K2"],
        "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1],
        "library_ms": None,
    }, {
        "name": "K3 shade_kernel (shade only)",
        "route": "cuda",
        "source": rk.SOURCE,
        "replaces": "bsdmg_tpu/ops/pallas/render_kernel.py:437",
        "launches": launches["row"]["K3"],
        "max_abs_err": errors["K3"],
        "ms": times[(1920, 1080)]["K3"],
        "plain_ms": plain["K3"],
        "bound_ms": k3_bound[0],
        "bound_by": k3_bound[1],
        "library_ms": None,
    }], launches


def run_cli_mesh(kernel: str, extra: list[str], obj: Path, *,
                 levels: bool = True) -> tuple[dict, float]:
    """``cli mesh -o obj <extra>`` with every launch count at 0: it must
    launch ``kernel`` and give the JAX package's voxel (from its level
    lines; ``levels=False`` for ``--sharded``, which logs none), triangle
    and vertex counts with finite coordinates. Returns the counts and the
    seconds."""
    counts, messages, seconds = run_cli(["mesh", "-o", str(obj), *extra])
    check(counts[kernel] > 0, f"cli mesh {' '.join(extra)} did not launch {kernel}: {counts}")
    v, vn, f, finite = read_obj_counts(obj)
    voxels = [int(m.split()[2]) for m in messages if m.startswith("level ")]
    print(f"mesh path ({kernel}): cli mesh {' '.join(extra)} -> voxels per level "
          f"{voxels if levels else '(not logged)'}, {f} triangles, {v} vertices, "
          f"{obj.stat().st_size} B OBJ in {seconds:.2f} s, launches {counts}")
    if not levels:
        voxels = MESH_LEVEL_VOXELS
    diffs = {
        "voxels": (voxels, MESH_LEVEL_VOXELS),
        "triangles": (f, MESH_TRIANGLES),
        "vertices": (v, MESH_VERTICES),
    }
    for what, (got, want) in diffs.items():
        if got != want:
            print(f"  {what} differ from the CPU's: {got} here, {want} there")
    check(vn == v and f > 0 and finite, f"OBJ has {v} vertices, {vn} normals, {f} faces, "
          f"finite {finite}")
    check(voxels == MESH_LEVEL_VOXELS and f == MESH_TRIANGLES and v == MESH_VERTICES,
          "mesh counts differ from the JAX package's")
    return counts, seconds


def mesh_path_phases() -> dict:
    """Phase 7: the mesh path through the CLI, with K6 and with K7."""
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, extra in (("K6", []), ("K7", ["--interpolate-edges"])):
            counts, _ = run_cli_mesh(name, extra, Path(tmp) / f"mesh_{name}.obj")
            launches[name] = counts[name]
    return launches


def k6_alone_ms(desc, args, kwargs) -> float:
    """K6's own time on the inputs ``(args, kwargs)`` of ``mc_fused``: a
    prepared struct and outputs, :func:`graph_ms`."""
    from bsdmg_tpu_torch.ops.cuda import mc_kernel
    from bsdmg_tpu_torch.ops.cuda.render_kernel import scene_desc_c

    desc_c, params = scene_desc_c(desc), mc_kernel.mc_params(**kwargs)
    out = mc_kernel.mc_outputs(args[0].numel(), args[0].device)
    return graph_ms(lambda: mc_kernel._mc_cuda(desc_c, args[:6], args[6], params, out))


def k7_alone_ms(desc, args, kwargs) -> float:
    """K7's own time on the inputs of ``project_edges``, as
    :func:`k6_alone_ms`."""
    from bsdmg_tpu_torch.ops.cuda import mesh_kernel
    from bsdmg_tpu_torch.ops.cuda.render_kernel import scene_desc_c

    desc_c = scene_desc_c(desc)
    params = (kwargs["iters"], kwargs["tol"], kwargs["eps"], kwargs["use_grad"])
    out = tuple(torch.empty_like(args[0]) for _ in range(6))
    return graph_ms(lambda: mesh_kernel._project_cuda(desc_c, args, params, out))


def with_checkerboard(args, count: int = 256):
    """K6's inputs with ``count`` voxels appended whose corners alternate in
    sign, so all 12 edges cross (the checkerboard field of
    tests/test_torch_mc_kernel.py), both parities, at the first voxels'
    corners."""
    from bsdmg_tpu_torch.ops.marching_cubes import TRI15, _int32
    from bsdmg_tpu_torch.ops.tables import MC_CORNER_OFFSETS

    parity = np.asarray(MC_CORNER_OFFSETS).sum(axis=1) % 2
    cases = [int(sum(1 << i for i in range(8) if parity[i] == p)) for p in (0, 1)]
    device = args[0].device
    nib = torch.tensor(TRI15[cases * (count // 2)], dtype=torch.int64, device=device)
    t0 = _int32(sum(nib[:, k] << (4 * k) for k in range(8)))
    t1 = _int32(sum(nib[:, k] << (4 * (k - 8)) for k in range(8, 15)))
    bits = torch.full((count,), 0xFFF, dtype=torch.int32, device=device)
    planes = [torch.cat([a, a[:count]]) for a in args[:3]]
    planes += [torch.cat([a, b]) for a, b in zip(args[3:6], (bits, t0, t1))]
    return (*planes, args[6])


def _max_err(a, b) -> float:
    return (a.double() - b.double()).abs().max().item() if a.numel() else 0.0


def mesh_kernel_phases(card: str, device, launches: dict, cfg=None, top: int = 5,
                       main_level: int = 3) -> list[dict]:
    """Phases 8 and 9: K6 and K7 against their plain versions, their times,
    and the stage times of mesh generation at level ``top``."""
    from bsdmg_tpu_torch.config import MeshGenConfig
    from bsdmg_tpu_torch.mesh.export import save_obj
    from bsdmg_tpu_torch.mesh.field import create_voxel_field, refine_field
    from bsdmg_tpu_torch.mesh.pipeline import field_to_triangles, triangles_to_mesh
    from bsdmg_tpu_torch.mesh.weld import weld_vertices
    from bsdmg_tpu_torch.models import reference_object
    from bsdmg_tpu_torch.ops.cuda import mc_kernel, mesh_kernel
    from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene, sdf_fns
    from bsdmg_tpu_torch.ops.marching_cubes import kernel_inputs

    cfg = cfg or MeshGenConfig()
    desc = compile_scene(reference_object(device=device))
    fns = sdf_fns(desc)

    # refine to level `top` stage by stage, keeping the fields; then
    # extraction, weld and OBJ write at the main path's level and at `top`
    stages = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fields = {0: create_voxel_field(cfg, device)}
    torch.cuda.synchronize()
    stages["field"] = time.perf_counter() - t0
    for level in range(1, top + 1):
        t0 = time.perf_counter()
        fields[level] = refine_field(desc, fields[level - 1])
        torch.cuda.synchronize()
        stages[f"refine L{level}"] = time.perf_counter() - t0
    for level in (main_level, top):
        t0 = time.perf_counter()
        soup = field_to_triangles(desc, fields[level], cfg)
        torch.cuda.synchronize()
        stages[f"extract L{level}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mesh = triangles_to_mesh(soup, cfg)
        stages[f"weld L{level} (incl. copy to host)"] = time.perf_counter() - t0
        # the native weld and OBJ writer (the defaults) beside their NumPy
        # and Python twins, on the same soup and mesh
        valid = soup.valid.reshape(-1)
        positions = soup.positions.reshape(-1, 3, 3)[valid].cpu().numpy()
        normals = soup.normals.reshape(-1, 3, 3)[valid].cpu().numpy()
        t0 = time.perf_counter()
        welded = weld_vertices(positions, normals, cfg.weld_quantization)
        stages[f"weld L{level} native"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        numpy_welded = weld_vertices(positions, normals, cfg.weld_quantization, use_native=False)
        stages[f"weld L{level} NumPy"] = time.perf_counter() - t0
        check(all(np.array_equal(a, b) for a, b in zip(welded, numpy_welded)),
              f"the native weld and the NumPy weld differ at level {level}")
        check(np.array_equal(welded[2], mesh.faces), "the pipeline's weld is not the native one")
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            save_obj(mesh, Path(tmp) / "mesh.obj")
            stages[f"OBJ write L{level}"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            save_obj(mesh, Path(tmp) / "python.obj", use_native=False)
            stages[f"OBJ write L{level} Python"] = time.perf_counter() - t0
            native_lines = (Path(tmp) / "mesh.obj").read_text().splitlines()
            python_lines = (Path(tmp) / "python.obj").read_text().splitlines()
            check(native_lines[0] == "# bsdmg_tpu generated mesh (native writer)"
                  and native_lines[1:] == python_lines[1:],
                  f"the native OBJ differs from the Python writer's at level {level}")
        print(f"level {level}: voxels per level {[fields[k].count for k in range(level + 1)]}, "
              f"{mesh.triangle_count} triangles, {mesh.vertex_count} vertices, "
              f"edge overflow {soup.edge_overflow}")
        check(mesh.triangle_count > 0 and np.isfinite(mesh.vertices).all(), f"level-{level} mesh")
        del soup, mesh
    print(f"stages on {card} (s, host clock after a sync): "
          + json.dumps({k: round(v, 6) for k, v in stages.items()}))

    # K6 against its plain version at the main path's level and at `top`
    k6 = {}
    for level in (main_level, top):
        f = fields[level]
        args, kwargs = kernel_inputs(desc, f.lowers, f.voxel_size, cfg)
        kern = mc_kernel.mc_fused_cuda(desc, *args, **kwargs)
        stats: dict = {}
        plain = mc_kernel.mc_fused_torch(fns, *args, stats=stats, **kwargs)
        torch.cuda.synchronize()
        valid = ((kern[4][:, None] >> torch.arange(5, device=device)) & 1) > 0
        res = {
            "voxels": f.count,
            "valid_triangles": int(valid.sum()),
            "meta_equal": bool(torch.equal(kern[4], plain[4])),
            "pos_max_err": _max_err(kern[0], plain[0]),
            "nrm_max_err": _max_err(kern[1], plain[1]),
            "exact": all(torch.equal(a, b) for a, b in zip(kern, plain)),
            "newton_steps": stats["newton_steps"],
        }
        print(f"parity K6 level {level}: {json.dumps(res)}")
        check(res["meta_equal"] and res["pos_max_err"] <= POSITION_ATOL
              and res["nrm_max_err"] <= NORMAL_ATOL, f"K6 level {level} bars {res}")
        check(res["exact"], f"K6 and its plain version are not bit-equal at level {level}")
        nact = torch.clamp_max(torch.stack([(args[3] >> e) & 1 for e in range(12)]).sum(0),
                               kwargs["budget"])
        lanes = int(nact.sum())
        ops = mesh_ops(desc, kwargs["use_grad"], stats["newton_steps"], lanes, lanes,
                       res["valid_triangles"])
        b_ms, b_by = bound(f.count * MC_VOXEL_BYTES, ops)
        k_ms = k6_alone_ms(desc, args, kwargs)
        w_ms = median_ms(lambda: mc_kernel.mc_fused_cuda(desc, *args, **kwargs),
                         runs=7, reps=5 if level == main_level else 2)
        p_ms = None
        if level == main_level:
            p_ms = median_ms(lambda: mc_kernel.mc_fused_torch(fns, *args, **kwargs), runs=5, warmup=1)
        k6[level] = dict(res, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, ops=ops)
        print(f"time K6 level {level} ({f.count} voxels, {lanes} projected edges) on {card}: "
              f"{k_ms:.4f} ms alone ({f.count / k_ms * 1e3:.4g} voxels/s), wrapper {w_ms:.4f} ms, "
              f"plain {'not timed' if p_ms is None else f'{p_ms:.3f} ms'}; {ops:.4g} FP32 "
              f"operations, {f.count * MC_VOXEL_BYTES} B; bound {b_ms:.4f} ms ({b_by})")
        del kern, plain

    # every other branch of K6 at the main path's level: the centroid
    # winding, fd4 projection normals, and budgets 12, 6 and 2 with voxels
    # whose 12 edges all cross appended (a block of them lists 384 edges;
    # at 6 part of their triangles overflow, at 2 every voxel's do)
    f = fields[main_level]
    for name, change in (("winding centroid_fd4", dict(winding_normals="centroid_fd4")),
                         ("projection fd4", dict(projection_normals="fd4")),
                         ("budget 12, checkerboard voxels", dict(edge_budget=12)),
                         ("budget 6, checkerboard voxels", dict(edge_budget=6)),
                         ("budget 2, checkerboard voxels", dict(edge_budget=2))):
        args, kwargs = kernel_inputs(desc, f.lowers, f.voxel_size, dataclasses.replace(cfg, **change))
        if "checkerboard" in name:
            args = with_checkerboard(args)
        kern = mc_kernel.mc_fused_cuda(desc, *args, **kwargs)
        plain = mc_kernel.mc_fused_torch(fns, *args, **kwargs)
        torch.cuda.synchronize()
        valid = ((kern[4][:, None] >> torch.arange(5, device=device)) & 1) > 0
        res = {"voxels": args[0].numel(), "valid_triangles": int(valid.sum()),
               "edge_overflow": int((kern[4] >> 5).sum()),
               "ambiguous": int(kern[3].sum()),
               "pos_max_err": _max_err(kern[0], plain[0]),
               "exact": all(torch.equal(a, b) for a, b in zip(kern, plain))}
        print(f"parity K6 level {main_level} {name}: {json.dumps(res)}")
        check(res["exact"], f"K6 ({name}) and its plain version are not bit-equal")
        check(res["edge_overflow"] > 0 if change.get("edge_budget", 12) < 12 else True,
              f"K6 ({name}) overflowed no voxel")
        del kern, plain

    # K7 against its plain version on the staged path's inputs (the listed
    # crossing edges) and on the JAX kernel's padded lanes, some inactive
    args, padded, kwargs = k7_inputs(desc, fields[main_level], cfg)
    active = padded[3] > 0
    check(all(torch.equal(a, b[active]) for a, b in zip(args, padded)),
          "the staged path does not hand K7 the listed crossing edges")
    check(not bool(active.all()), "the padded lanes have no inactive point")
    k7 = {}
    for name, points in (("pipeline", args), ("padded", padded)):
        kern = mesh_kernel.project_edges_cuda(desc, *points, **kwargs)
        stats = {}
        plain = mesh_kernel.project_edges_torch(fns, *points[:3], points[3].bool(), stats=stats,
                                                **kwargs)
        torch.cuda.synchronize()
        k7[name] = res = {
            "points": points[0].numel(),
            "active": int(points[3].sum()),
            "pos_max_err": max(_max_err(a, b) for a, b in zip(kern[:3], plain[:3])),
            "nrm_max_err": max(_max_err(a, b) for a, b in zip(kern[3:], plain[3:])),
            "exact": all(torch.equal(a, b) for a, b in zip(kern, plain)),
            "newton_steps": stats["newton_steps"],
        }
        print(f"parity K7 level {main_level} ({name}): {json.dumps(res)}")
        check(res["pos_max_err"] <= POSITION_ATOL and res["nrm_max_err"] <= NORMAL_ATOL,
              f"K7 bars ({name}) {res}")
        check(res["exact"], f"K7 and its plain version are not bit-equal ({name})")
    res = k7["pipeline"]
    m = args[0].numel()
    ops7 = mesh_ops(desc, kwargs["use_grad"], res["newton_steps"], m)
    b7_ms, b7_by = bound(m * (16 + 24), ops7)
    k7_ms = k7_alone_ms(desc, args, kwargs)
    w7_ms = median_ms(lambda: mesh_kernel.project_edges_cuda(desc, *args, **kwargs), reps=5)
    p7_ms = median_ms(
        lambda: mesh_kernel.project_edges_torch(fns, *args[:3], args[3].bool(), **kwargs),
        runs=5, warmup=1,
    )
    print(f"time K7 level {main_level} ({m} points) on {card}: {k7_ms:.4f} ms alone, wrapper "
          f"{w7_ms:.4f} ms, plain {p7_ms:.3f} ms; {ops7:.4g} FP32 operations, {m * 40} B; "
          f"bound {b7_ms:.4f} ms ({b7_by})")

    out = [{
        "name": "K6 mc_kernel (fused marching-cubes finish)",
        "route": "cuda",
        "source": mc_kernel.SOURCE,
        "replaces": "bsdmg_tpu/ops/pallas/mc_fused.py:77",
        "launches": launches["K6"],
        "max_abs_err": max(k6[main_level]["pos_max_err"], k6[main_level]["nrm_max_err"]),
        "ms": k6[main_level]["ms"],
        "plain_ms": k6[main_level]["plain_ms"],
        "bound_ms": k6[main_level]["bound_ms"],
        "bound_by": k6[main_level]["bound_by"],
        "library_ms": None,
    }, {
        "name": "K7 project_kernel (Newton edge projection)",
        "route": "cuda",
        "source": mesh_kernel.SOURCE,
        "replaces": "bsdmg_tpu/ops/pallas/mesh_kernel.py:66",
        "launches": launches["K7"],
        "max_abs_err": max(max(r["pos_max_err"], r["nrm_max_err"]) for r in k7.values()),
        "ms": k7_ms,
        "plain_ms": p7_ms,
        "bound_ms": b7_ms,
        "bound_by": b7_by,
        "library_ms": None,
    }]
    return out


def inflated(bounds, by: float):
    lo, hi, slack = bounds
    return (tuple(v - by for v in lo), tuple(v + by for v in hi), slack)


def shape_params(scene) -> dict:
    """The fit's parameters: the scene's, without the object transform."""
    return {k: v for k, v in scene.params.items() if k not in ("object_center", "object_rotation")}


def step_losses(messages: list[str]) -> list[float]:
    return [float(m.split("loss=")[1].split()[0]) for m in messages if m.startswith("step ")]


def plain_fit(scene, true: dict, start: dict, o, d, c, snapshots, shadow: bool = False):
    """``cli.fit_image``'s target and Adam steps through K4's and K5's plain
    versions on the card: returns the parameters after each of
    ``snapshots`` steps, the losses and, with ``shadow``, K5 against the
    plain version at every step's parameters (loss error, excess over the
    gradient bars, gradients, where the two gradients' signs differ)."""
    from bsdmg_tpu_torch.grad.diff_render import shade_diff_planes
    from bsdmg_tpu_torch.ops.cuda import diff_kernel as dk
    from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene_split, scene_bounds

    bounds = scene_bounds(scene)
    bb = None if bounds is None else inflated(bounds, 0.6)
    # the steps' near/far split, inflated as cli.fit_image inflates it
    split = compile_scene_split(scene)
    if split is not None:
        split = (split[0], inflated(split[1], 0.6))
    h, w = c.shape
    depth, _, outcome, dfdt = (x.reshape(-1)
                               for x in dk.march_params_torch(scene.csdf, true, o, d, c, bb=bb))
    planes = [o[..., a].reshape(-1) for a in range(3)] + [d[..., a].reshape(-1) for a in range(3)]
    rgb = shade_diff_planes(scene.csdf, true, *planes, c.reshape(-1), depth, dfdt, outcome)
    target = torch.stack(rgb, dim=-1).reshape(h, w, 3).detach()

    params = {k: v.detach().clone().requires_grad_() for k, v in start.items()}
    opt = torch.optim.Adam(list(params.values()), lr=FIT_LR * 0.1)
    snaps, losses = {}, []
    stats = {"loss_rel": [], "excess": [], "grads": {k: [] for k in params},
             "signs": {k: [] for k in params}}
    for i in range(max(snapshots)):
        loss, grads = dk.render_loss_grad_torch(scene.csdf, params, target, o, d, c, bb=bb,
                                                edge_weight=1.0, split=split)
        if shadow:
            k_loss, k_grads = dk.render_loss_grad_cuda(scene.csdf, params, target, o, d, c, bb=bb,
                                                       edge_weight=1.0, split=split)
            stats["loss_rel"].append(abs(k_loss.item() - loss.item()) / max(abs(loss.item()), 1e-30))
            stats["excess"].append(max(
                ((k_grads[k] - grads[k]).abs() - GRAD_ATOL - GRAD_RTOL * grads[k].abs()).max().item()
                for k in grads))
            for k in grads:
                stats["grads"][k].append(grads[k])
                stats["signs"][k].append(torch.sign(k_grads[k]) != torch.sign(grads[k]))
        opt.zero_grad()
        for k in params:
            params[k].grad = grads[k].clone()
        opt.step()
        losses.append(loss.item())
        if i + 1 in snapshots:
            snaps[i + 1] = {k: v.detach().clone() for k, v in params.items()}
    return snaps, losses, stats


def fit_path_phases(card: str, device) -> dict:
    """Phase 10: the fit path through the CLI; the kernels' 60 steps against
    their plain versions'; the time per step."""
    from bsdmg_tpu_torch import cli
    from bsdmg_tpu_torch.models import reference_render_scene

    out = {}
    # torch.optim's first use in a process imports more of torch; timed
    # here so that the CLI's first run below does not carry it
    t0 = time.perf_counter()
    torch.optim.Adam([torch.zeros(1, device=device, requires_grad=True)])
    print(f"fit path: torch.optim.Adam's first construction in this process {time.perf_counter() - t0:.2f} s")
    counts, messages, seconds = run_cli(["fit", "--image"])
    losses = step_losses(messages)
    print(f"fit path: cli fit --image (64x64, {FIT_STEPS} steps) in {seconds:.2f} s, launches {counts}; "
          f"loss {losses[0]:.4e} -> {losses[-1]:.4e}")
    print(f"  {messages[-1]}")
    check(counts["K4"] >= 1 and counts["K5"] == counts["K5 split"] == FIT_STEPS,
          f"cli fit --image launched K4 {counts['K4']} and K5 {counts['K5']} times, "
          f"{counts['K5 split']} of them with the split")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"fit --image loss did not fall: {losses}")
    out["launches"] = counts
    out["recovered"] = messages[-1]
    # the step time from warm runs: the first run pays one-time set-up
    _, _, base = run_cli(["fit", "--image", "--steps", "0"])
    _, _, warm = run_cli(["fit", "--image"])
    out["step_s_64"] = (warm - base) / FIT_STEPS
    print(f"  again, warm: {warm:.3f} s; with --steps 0: {base:.3f} s")

    # the CLI's steps through the kernels (`cli.fit_image`) and through
    # their plain versions, with K5 held against its plain version at every
    # step's parameters; and the plain versions again from a start one
    # float32 step away, to show how far rounding alone parts two fits
    scene = reference_render_scene(device=device)
    true = shape_params(scene)
    start = cli._apply_perturb(true, FIT_PERTURB)
    inf = torch.tensor(float("inf"), device=device)
    nudged_start = dict(start, sphere_radius=torch.nextafter(start["sphere_radius"], inf))
    o, d, c = rays(64, 64, device)
    logger = logging.getLogger("bsdmg_tpu_torch")
    old_level = logger.level
    logger.setLevel(logging.WARNING)
    try:
        kern = {n: cli.fit_image(scene, true, start, o, d, c, steps=n, lr=FIT_LR)
                for n in FIT_SNAPSHOTS}
    finally:
        logger.setLevel(old_level)
    plain, plain_losses, shadow = plain_fit(scene, true, start, o, d, c, FIT_SNAPSHOTS, shadow=True)
    nudged, _, _ = plain_fit(scene, true, nudged_start, o, d, c, FIT_SNAPSHOTS)

    watched = sorted(FIT_PERTURB)
    check(out["recovered"].startswith(f"recovered {cli._fmt(kern[FIT_STEPS][0], watched)} "),
          "the CLI's recovered parameters differ from the same steps run here")
    worst = max(shadow["loss_rel"])
    print(f"fit --image, K5 against its plain version at each of the {FIT_STEPS} steps' parameters: "
          f"loss rel err max {worst:.3e}, gradient excess over the bars max {max(shadow['excess']):.3e}")
    check(worst <= LOSS_RTOL and max(shadow["excess"]) <= 0,
          f"K5 outside the bars on the fit's path: {shadow}")
    parted = {}
    for n in FIT_SNAPSHOTS:
        k, p, q = kern[n][0], plain[n], nudged[n]
        parted[n] = {name: (abs(k[name] - p[name]).max().item(), abs(q[name] - p[name]).max().item())
                     for name in sorted(p)}
        leaf = max(parted[n], key=lambda name: parted[n][name][0])
        print(f"fit --image, {n} steps, kernels vs plain versions: largest difference "
              f"{parted[n][leaf][0]:.3e} in {leaf}; plain versions from the nudged start "
              f"{max(v[1] for v in parted[n].values()):.3e}; kernels {cli._fmt(k, watched)}, "
              f"plain {cli._fmt(p, watched)}")
    print("  per leaf after {}: |kernels - plain| / |nudged plain - plain| / "
          "median |gradient| over the steps / steps where K5's and the plain gradient's signs differ"
          .format(FIT_STEPS))
    for name in sorted(true):
        g = torch.stack(shadow["grads"][name]).abs().reshape(FIT_STEPS, -1)
        flips = (torch.stack(shadow["signs"][name]).reshape(FIT_STEPS, -1)).sum(0).tolist()
        print(f"    {name}: {parted[FIT_STEPS][name][0]:.3e} / {parted[FIT_STEPS][name][1]:.3e} / "
              f"{g.median(0).values.tolist()} / {flips}")
    err10 = max(v[0] for v in parted[10].values())
    check(err10 <= FIT_PARAM_ATOL_10, f"fit parameters after 10 steps differ by {err10}")
    k, p = kern[FIT_STEPS][0], plain[FIT_STEPS]
    rel = {name: ((k[name] - p[name]).abs() / p[name].abs()).max().item() for name in watched}
    print(f"  watched parameters after {FIT_STEPS} steps, kernels vs plain versions, relative "
          f"difference {json.dumps(rel)} (bar {FIT_PARAM_RTOL})")
    check(max(rel.values()) <= FIT_PARAM_RTOL, f"fit parameters after {FIT_STEPS} steps differ: {rel}")
    print(f"  losses, kernels {kern[FIT_STEPS][1][0]:.4e} -> {kern[FIT_STEPS][1][-1]:.4e}, plain "
          f"{plain_losses[0]:.4e} -> {plain_losses[-1]:.4e}; truth {cli._fmt(true, watched)}")
    check(plain_losses[-1] < plain_losses[0], "the plain versions' fit loss did not fall")

    counts, messages, seconds = run_cli(["fit", "--image", "--width", "512", "--height", "512",
                                         "--steps", "10"])
    _, _, base = run_cli(["fit", "--image", "--width", "512", "--height", "512", "--steps", "0"])
    losses = step_losses(messages)
    out["step_s_512"] = (seconds - base) / 10
    print(f"fit path 512x512: cli fit --image --steps 10 in {seconds:.2f} s (--steps 0: {base:.2f} s), "
          f"launches {counts}, loss {losses[0]:.4e} -> {losses[-1]:.4e}")
    check(counts["K4"] >= 1 and counts["K5"] == 10, f"512x512 fit launches {counts}")
    check(all(np.isfinite(losses)), "512x512 fit loss not finite")
    print(f"fit --image wall time per step on {card} (K5, Adam and host, host clock after a sync): "
          f"64x64 {out['step_s_64'] * 1e3:.2f} ms, 512x512 {out['step_s_512'] * 1e3:.2f} ms")

    counts, messages, seconds = run_cli(["fit"])
    losses = step_losses(messages)
    print(f"fit path (depth): cli fit in {seconds:.2f} s, launches {counts}, "
          f"loss {losses[0]:.4e} -> {losses[-1]:.4e}")
    print(f"  {messages[-1]}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"depth fit loss did not fall: {losses}")
    return out


def diff_kernel_phases(card: str, device, fit: dict, alone: dict) -> list[dict]:
    """Phase 11: K4 and K5 against their plain versions, their work, bounds
    and times (:func:`kernel_times`'s ``alone`` where it has them)."""
    from bsdmg_tpu_torch import cli
    from bsdmg_tpu_torch.config import MarchConfig
    from bsdmg_tpu_torch.grad import render_image_diff
    from bsdmg_tpu_torch.grad.edge import UNTRACKED, classify_target_miss
    from bsdmg_tpu_torch.models import reference_render_scene
    from bsdmg_tpu_torch.ops.cuda import build
    from bsdmg_tpu_torch.ops.cuda import diff_kernel as dk
    from bsdmg_tpu_torch.ops.cuda.csdf import scene_bounds

    # registers, stack and spill bytes per thread, as ptxas reported them
    for line in build.resource_report("diff_kernel.cu").splitlines():
        if "Compiling entry" in line or "spill" in line or "Used" in line:
            print(f"  ptxas: {line.strip()}")
    scene = reference_render_scene(device=device)
    bb6 = inflated(scene_bounds(scene), 0.6)
    bb25 = inflated(scene_bounds(scene), 0.25)
    true = shape_params(scene)

    # K4 with the scene's 16 parameter values (the transform included), and
    # with the 9 shape values `fit --image` passes it (no transform)
    k4 = {}
    for (w, h), params in [(size, params) for size in ((1920, 1080), (512, 512), (64, 64))
                           for params in (scene.params, true)]:
        o, d, c = rays(w, h, device)
        n_prm = sum(v.numel() for v in params.values())
        for track in (False, True):
            kern = dk.march_params_cuda(scene.csdf, params, o, d, c, bb=bb6, track_min=track)
            plain = dk.march_params_torch(scene.csdf, params, o, d, c, bb=bb6, track_min=track)
            torch.cuda.synchronize()
            res = {
                "exact": {name: bool(torch.equal(kern[i], plain[i]))
                          for i, name in enumerate(("depth", "steps", "outcome", "dfdt", "min_m",
                                                    "t_min")[:len(kern)])},
                "dfdt_max_err": _max_err(kern[3], plain[3]),
            }
            print(f"parity K4 {w}x{h}, {n_prm} parameters, track_min={track}: {json.dumps(res)}")
            check(all(v for n, v in res["exact"].items() if n != "dfdt"),
                  f"K4 {w}x{h}, {n_prm} parameters, is not bit-equal to its plain version")
            check(res["dfdt_max_err"] <= DFDT_ATOL, f"K4 dfdt {res}")
            k4[(w, h, n_prm, track)] = res

    k5 = {}
    o, d, c = rays(512, 512, device)
    fit_target = render_image_diff(scene.sdf, true, o, d, c, csdf=scene.csdf, bb=bb6).detach()
    perturbed = cli._apply_perturb(true, FIT_PERTURB)
    perturbed16 = cli._apply_perturb(scene.params, FIT_PERTURB)
    small = rays(64, 64, device)
    small_target = render_image_diff(scene.sdf, true, *small, csdf=scene.csdf, bb=bb6).detach()
    large = rays(1920, 1080, device)
    large_target = render_image_diff(scene.sdf, true, *large, csdf=scene.csdf, bb=bb6).detach()
    cases = {
        "bench": (true, torch.zeros_like(fit_target), bb25, 0.0, (o, d, c)),
        "fit": (perturbed, fit_target, bb6, 1.0, (o, d, c)),
        "fit, 16 parameters,": (perturbed16, fit_target, bb6, 1.0, (o, d, c)),
        "fit 64x64": (perturbed, small_target, bb6, 1.0, small),
        "fit 1920x1080": (perturbed, large_target, bb6, 1.0, large),
    }
    for name, (params, target, bb, edge, (o, d, c)) in cases.items():
        reset_launches()
        kern = dk.render_loss_grad_cuda(scene.csdf, params, target, o, d, c, bb=bb, edge_weight=edge)
        if name == "bench":
            # the library call without the split (cli fit --image passes it)
            k5_launches = dk.LOSS_GRAD_LAUNCHES - dk.SPLIT_LAUNCHES["K5"]
        again = dk.render_loss_grad_cuda(scene.csdf, params, target, o, d, c, bb=bb, edge_weight=edge)
        plain = dk.render_loss_grad_torch(scene.csdf, params, target, o, d, c, bb=bb, edge_weight=edge)
        torch.cuda.synchronize()
        loss_rel = abs(kern[0].item() - plain[0].item()) / abs(plain[0].item())
        excess = {k: ((kern[1][k] - plain[1][k]).abs() - GRAD_ATOL - GRAD_RTOL * plain[1][k].abs())
                  .max().item() for k in kern[1]}
        worst = max(excess, key=excess.get)
        res = {
            "loss": kern[0].item(), "plain_loss": plain[0].item(), "loss_rel_err": loss_rel,
            "worst_leaf": worst, "worst_excess_over_bars": excess[worst],
            "grad_max_abs_err": max(_max_err(kern[1][k], plain[1][k]) for k in kern[1]),
            "grad_max_rel_err": max(((kern[1][k] - plain[1][k]).abs()
                                     / plain[1][k].abs().clamp_min(1e-30)).max().item() for k in kern[1]),
            "reproducible": bool(torch.equal(kern[0], again[0])
                                 and all(torch.equal(kern[1][k], again[1][k]) for k in kern[1])),
        }
        print(f"parity K5 {name} point ({c.shape[1]}x{c.shape[0]}): {json.dumps(res)}")
        print(f"  grads {json.dumps({k: v.tolist() for k, v in kern[1].items()})}")
        check(loss_rel <= LOSS_RTOL and excess[worst] <= 0, f"K5 {name} point outside the bars {res}")
        check(res["reproducible"], f"K5 {name} point differs between two calls")
        k5[name] = res

    # work, bounds and times: K4 as the fit's target render calls it, K5
    # at the bench point (and the fit point at 512x512)
    timings = {}
    for w, h in ((64, 64), (512, 512), (1920, 1080)):
        o, d, c = rays(w, h, device)
        npix = w * h
        depth, steps, outcome, _ = dk.march_params_cuda(scene.csdf, true, o, d, c, bb=bb6)
        evals, advances, hits = march_work(steps, outcome, depth)
        ops = k4_ops(npix, evals, advances, True, False, True, False)
        b_ms, b_by = bound(npix * (28 + 16), ops)
        # the kernel from a prepared parameter struct, and the wrapper, which
        # also builds the struct (a copy of the parameters to the host)
        scene_c, _ = dk.param_scene_c(scene.csdf, true, bb=bb6)
        k_ms = alone.get(f"K4 {w}x{h}") or graph_ms(lambda: dk._march_cuda(scene_c, o, d, c, False))
        w_ms = median_ms(lambda: dk.march_params_cuda(scene.csdf, true, o, d, c, bb=bb6), reps=5)
        p_ms = median_ms(lambda: dk.march_params_torch(scene.csdf, true, o, d, c, bb=bb6),
                         runs=5, warmup=1)
        timings[("K4", w)] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"time K4 {w}x{h} on {card}: {k_ms:.4f} ms ({npix / k_ms * 1e3:.4g} rays/s), wrapper "
              f"{w_ms:.4f} ms, plain {p_ms:.3f} ms; {evals} SDF evaluations, {hits} hits, "
              f"{ops:.4g} FP32 operations, {npix * 44} B; bound {b_ms:.4f} ms ({b_by})")
        points = [("bench", true, torch.zeros((h, w, 3), device=device), bb25, 0.0)]
        if w == 512:
            points.append(("fit", perturbed, fit_target, bb6, 1.0))
        if w == 64:
            points = [("fit", perturbed, small_target, bb6, 1.0)]
        for name, params, target, bb, edge in points:
            depth, steps, outcome, _, min_m, _ = dk.march_params_cuda(scene.csdf, params, o, d, c,
                                                                      bb=bb, track_min=True)
            evals, advances, hits = march_work(steps, outcome, depth)
            hinges = 0
            if edge:
                miss = classify_target_miss(target)
                hit = outcome == 0
                hinges = int(((~miss & ~hit & (min_m < UNTRACKED)) | (miss & hit)).sum().item())
            ops = k5_ops(npix, evals, advances, hits, hinges, True, False, bool(edge))
            b_ms, b_by = bound(npix * (40 + 4 * bool(edge)), ops)
            scene_c, _ = dk.param_scene_c(scene.csdf, params, bb=bb)
            state = dk._target_state(target, None).contiguous() if edge else None
            k_ms = alone.get(f"K5 {w}x{h} {name}") or graph_ms(
                lambda: dk._loss_grad_cuda(scene_c, o, d, c, target, state, npix, edge,
                                           dk._band(MarchConfig(), None)))
            w_ms = median_ms(lambda: dk.render_loss_grad_cuda(scene.csdf, params, target, o, d, c,
                                                              bb=bb, edge_weight=edge), reps=5)
            p_ms = median_ms(lambda: dk.render_loss_grad_torch(scene.csdf, params, target, o, d, c,
                                                               bb=bb, edge_weight=edge),
                             runs=5, warmup=1)
            timings[("K5", w, name)] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
            print(f"time K5 {w}x{h} {name} point on {card}: {k_ms:.4f} ms ({npix / k_ms * 1e3:.4g} "
                  f"rays/s), wrapper {w_ms:.4f} ms, plain {p_ms:.3f} ms; {evals} SDF evaluations, "
                  f"{hits} hits, {hinges} hinges, {ops:.4g} FP32 operations, "
                  f"{npix * (40 + 4 * bool(edge))} B; bound {b_ms:.4f} ms ({b_by})")

    # where a fit --image step's time goes: K5 at the fit point of each size
    # against the step's wall time
    for size, step_s, k_ms in ((64, fit["step_s_64"], timings[("K5", 64, "fit")]["ms"]),
                               (512, fit["step_s_512"], timings[("K5", 512, "fit")]["ms"])):
        print(f"fit --image step at {size}x{size} on {card}: {step_s * 1e3:.3f} ms wall, of which K5 "
              f"at the fit point {k_ms:.4f} ms; Adam and host {step_s * 1e3 - k_ms:.3f} ms")
    k4_row = timings[("K4", 512)]
    k5_row = timings[("K5", 512, "bench")]
    # cli fit --image renders its target through K4 without the split, and
    # takes its steps through K5 with it
    k4_launches = fit["launches"]["K4"] - fit["launches"]["K4 split"]
    check(k4_launches > 0 and k5_launches > 0,
          f"K4 without the split in cli fit --image ({fit['launches']}) or K5 without it in "
          f"render_loss_grad_cuda ({k5_launches}) launched no time")
    return [{
        "name": "K4 march_params_kernel<ReferenceForm> (march under runtime parameters; without "
                "the split)",
        "route": "cuda",
        "source": dk.SOURCE,
        "replaces": "bsdmg_tpu/ops/pallas/diff_kernel.py:60",
        "launches": k4_launches,
        "max_abs_err": max(r["dfdt_max_err"] for r in k4.values()),
        **k4_row,
        "library_ms": None,
    }, {
        "name": "K5 loss_march_kernel<ReferenceForm> + loss_tangent_kernel + loss_grad_sum (fused "
                "image loss and gradient; render_loss_grad_cuda without the split)",
        "route": "cuda",
        "source": dk.SOURCE,
        "replaces": "bsdmg_tpu/ops/pallas/diff_kernel.py:232",
        "launches": k5_launches,
        "max_abs_err": max(r["grad_max_abs_err"] for r in k5.values()),
        **k5_row,
        "library_ms": None,
    }]


# ---------------------------------------------------------------------------
# the image fit of the other scenes: K4 and K5 in their other parameter forms
# ---------------------------------------------------------------------------

#: each scene's `cli fit --image` beside the reference scene's (phases 10
#: and 11): --perturb, the camera (None: the CLI's), and whether the fit's
#: loss falls, as it does in the JAX package's fit; where that fit does not
#: converge (the same argv through the JAX package's CLI on the CPU: the
#: wrapped object's loss rises, the gadget's and the ground's are NaN from
#: the first step, the lattice's rises and its parameter turns NaN), K5 is
#: held against its plain version at each of the
#: plain versions' first FIT_TWIN_STEPS steps' parameters instead, and the
#: kernels' parameters after those steps are printed beside the plain
#: versions'. They are not held: where a parameter's plain gradient is 0
#: (every pixel it moves renders as the target), the kernels' is ~1e-11
#: (their normal rounds otherwise), and Adam turns either into a whole
#: step (on an NVIDIA H100 80GB HBM3 at 700 W the gadget's parted by
#: 0.036 in 10 steps, the wrapped object's by 1.2e-4). The built-in scenes
#: by name, the specs by their files (scene_arguments).
FIT_SCENES = {
    "sphere": ("radius=1.2", None, True),
    "mandelbulb": ("scale=1.1", MANDELBULB_CAMERA, True),
    "wrapped_object": ("sphere_radius=1.2", None, False),
    "gadget": ("n3_radius=1.2", None, False),
    "mushroom": ("n3_radius=1.2", None, True),
    "snowman": ("n1_radius=1.2", None, True),
    "ground": ("n5_radius=1.1", None, False),
    "lattice": ("n2_minor_radius=1.2", None, False),
    "deep": ("n4_radius=1.2", None, False),
}
FIT_TWIN_STEPS = 10
#: the parameter form each scene's K4 and K5 take (csrc/param_forms.cuh)
FORM_OF = {"sphere": "SphereForm", "mandelbulb": "MandelbulbForm",
           "wrapped_object": "WrappedForm", "deep": "ProgramLargeForm"}
#: the mandelbulb's bars of K4 and K5 against their plain versions, whose
#: libm calls and whose gradients (forward over forward in the kernels,
#: autograd's reverse mode twice in the plain versions) round differently:
#: the outcomes (BULB_OUTCOMES) and the hits' depths within DEPTH_ATOL
#: (BULB_DEPTH_SHARE) as K1's; dfdt within BULB_DFDT_RTOL relative (and
#: DFDT_ATOL) on BULB_FIT_SHARE of the hits; K5's loss within BULB_LOSS_RTOL
#: relative. A few hits near the fractal's surface carry gradients far
#: larger than the rest (up to ~1e4 a tile at 512x512) and rounding sets
#: their value, so K5's gradient is held over the tiles of a BULB_GRID x
#: BULB_GRID split: of the live tiles (whose plain gradient exceeds
#: GRAD_ATOL; the others pass whatever the kernel gives), BULB_TILE_SHARE
#: within the K5 bars, at the CLI's 64x64 only (tools/bulb_faults.py: on an
#: NVIDIA H100 80GB HBM3 at 700 W the sound kernels hold 6 of the 8 live
#: tiles there and each planted fault none; at 512x512, where every live
#: tile holds such hits, the sound kernels hold few, and the share there
#: is printed, not held).
BULB_DFDT_RTOL = 1e-3
BULB_FIT_SHARE = 0.99
BULB_LOSS_RTOL = 1e-2
BULB_TILE_SHARE = 0.5
BULB_GRID = 8


def k5_excess(kernel, plain) -> float:
    """The largest excess of K5's gradient over the bars (<= 0 within
    them), NaN where the two gradients are NaN at different places."""
    worst = -math.inf
    for k in kernel:
        if not torch.equal(kernel[k].isnan(), plain[k].isnan()):
            return math.nan
        ok = ~plain[k].isnan()
        if ok.any():
            worst = max(worst, ((kernel[k] - plain[k]).abs() - GRAD_ATOL
                                - GRAD_RTOL * plain[k].abs())[ok].max().item())
    return worst


def bulb_readings(scene, params, o, d, c, target, bb) -> dict:
    """The mandelbulb's readings against the BULB_* bars at ``params`` on
    these rays: K4 against its plain version, K5's loss over the frame and
    its gradient over each tile of the BULB_GRID split, edge term on."""
    from bsdmg_tpu_torch.ops.cuda import diff_kernel as dk

    k4 = dk.march_params_cuda(scene.csdf, params, o, d, c, bb=bb)
    p4 = dk.march_params_torch(scene.csdf, params, o, d, c, bb=bb)
    k5 = dk.render_loss_grad_cuda(scene.csdf, params, target, o, d, c, bb=bb, edge_weight=1.0)
    p5 = dk.render_loss_grad_torch(scene.csdf, params, target, o, d, c, bb=bb, edge_weight=1.0)
    h, w = c.shape
    th, tw = h // BULB_GRID, w // BULB_GRID
    live = []
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            crop = [x[y0:y0 + th, x0:x0 + tw].contiguous() for x in (o, d, c, target)]
            kt = dk.render_loss_grad_cuda(scene.csdf, params, crop[3], *crop[:3], bb=bb,
                                          edge_weight=1.0, total_pixels=h * w)
            pt = dk.render_loss_grad_torch(scene.csdf, params, crop[3], *crop[:3], bb=bb,
                                           edge_weight=1.0, total_pixels=h * w)
            if max(v.abs().max().item() for v in pt[1].values()) > GRAD_ATOL:
                live.append(k5_excess(kt[1], pt[1]) <= 0)
    same = k4[2] == p4[2]
    hit = same & (k4[2] == 0)
    dfdt = (k4[3] - p4[3]).abs() <= DFDT_ATOL + BULB_DFDT_RTOL * p4[3].abs()
    return {"outcome_agreement": same.float().mean().item(),
            "hits": int(hit.sum()),
            "depth_share": ((k4[0] - p4[0]).abs()[hit] <= DEPTH_ATOL).float().mean().item(),
            "dfdt_share": dfdt[hit].float().mean().item(),
            "loss_rel": abs(k5[0].item() - p5[0].item()) / abs(p5[0].item()),
            "tiles": BULB_GRID * BULB_GRID, "live_tiles": len(live),
            "tile_share": float(np.mean(live)) if live else math.nan,
            "exact_k4": all(bool(torch.equal(a, b)) for i, (a, b) in enumerate(zip(k4, p4))
                            if i != 3)}


def bulb_failed(out: dict, tiles: bool) -> list[str]:
    """The BULB_* bars that :func:`bulb_readings`' ``out`` fails, the tile
    bar where ``tiles``."""
    bars = {"outcome_agreement": out["outcome_agreement"] >= BULB_OUTCOMES,
            "depth_share": out["depth_share"] >= BULB_DEPTH_SHARE,
            "dfdt_share": out["dfdt_share"] >= BULB_FIT_SHARE,
            "loss_rel": out["loss_rel"] <= BULB_LOSS_RTOL,
            "hits": out["hits"] > 0,
            "tile_share": not tiles or out["tile_share"] >= BULB_TILE_SHARE}
    return [k for k, ok in bars.items() if not ok]


def bulb_fit_bars(scene, params, o, d, c, target, bb, tiles: bool) -> dict:
    """:func:`bulb_readings`, checked against the BULB_* bars (the tile
    bar where ``tiles``)."""
    out = bulb_readings(scene, params, o, d, c, target, bb)
    failed = bulb_failed(out, tiles)
    check(not failed, f"mandelbulb K4/K5 bars {failed} fail: {out}")
    return out


def direction_bits(scene, params, o, d, c, target, bb) -> dict:
    """The mandelbulb's K5 (edge term on) over an image whose tangent
    launch takes a ray's directions on 4 lanes, against the same rays at
    one lane a ray: the image padded below with rays the slab cull drops
    (pointing away from the bounds) and a black target, to more 16x8 lists
    than the card has SMs, with the unpadded image's pixel count. Padded
    lists add zeros where the small image's sum has none, so the two must
    give the same bits. ``launches``: each call's tangent launches, as K5
    reported them."""
    from bsdmg_tpu_torch.ops.cuda import diff_kernel as dk

    h, w = c.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = 8 * (sms // ((w + 15) // 16) + 1) - h
    pad = lambda x, v: torch.cat([x, v.expand(rows, *x.shape[1:])]).contiguous()  # noqa: E731
    big = (pad(o, o[:1, :1]), pad(d, -d[:1, :1]), pad(c, c[:1, :1]),
           pad(target, torch.zeros_like(target[:1, :1])))
    lanes = []
    dk.TANGENT_LAUNCHES.clear()
    small = dk.render_loss_grad_cuda(scene.csdf, params, target, o, d, c, bb=bb, edge_weight=1.0)
    lanes.append(dict(dk.TANGENT_LAUNCHES))
    dk.TANGENT_LAUNCHES.clear()
    padded = dk.render_loss_grad_cuda(scene.csdf, params, big[3], *big[:3], bb=bb, edge_weight=1.0,
                                      total_pixels=h * w)
    lanes.append(dict(dk.TANGENT_LAUNCHES))
    same = bool(torch.equal(small[0], padded[0]) and all(
        torch.equal(small[1][k], padded[1][k]) for k in small[1]))
    return {"launches": lanes, "same_bits": same, "loss": [small[0].item(), padded[0].item()],
            "grad": [[small[1][k].item(), padded[1][k].item()] for k in small[1]]}


def expected_tangent(name: str, size: int) -> str | None:
    """The instantiation of K5's tangent launch that the redesigned forms
    take at size x size by the rules csrc/diff_kernel.cu records, None for
    the other scenes, to hold the launch K5 reports against: the wrapped
    object sweeps its lowered program in reverse, 4 lanes a ray where the
    image has no more 16x8 lists than the card has SMs (reverse_lanes); the
    mandelbulb takes its directions on 4 lanes a ray where 4 lanes a list
    take no more blocks than SMs (direction_lanes), else 1."""
    if name not in ("wrapped_object", "mandelbulb"):
        return None
    lists = ((size + 15) // 16) * ((size + 7) // 8)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if name == "wrapped_object":
        return f"loss_reverse_kernel<ProgramForm, {4 if lists <= sms else 1}>"
    return f"loss_tangent_form_kernel<MandelbulbForm, {4 if 4 * lists <= sms else 1}>"


def fit_scene_phases(card: str, device) -> list[dict]:
    """Phase 11b: `cli fit --image` of each scene of FIT_SCENES (one loop;
    `cli._get_scene` resolves names and spec files) at the CLI's 64x64 and
    60 steps (K4 at least once, K5 60 times; the loss falls, or the
    kernels' first steps follow the plain versions'); K4 (track_min off
    and on) and K5 (edge term off and on) against their plain versions at
    64x64 and 512x512 (the JAX bench's training point), the fit's start
    against the render at the true parameters (K4 bit-equal but dfdt,
    within DFDT_ATOL; K5 within the bars, NaN at the same places, two calls
    the same bits; the mandelbulb by its bars); K4's and K5's times alone
    (CUDA graphs from a prepared struct) and their plain versions', with
    bounds from this run's counts (`profiling.form_ops`); ptxas's
    registers, stack and spills of each form's instantiations. Returns the
    kernels line's K4 and K5 entries of each scene: K4 at 512x512, K5 as
    the fit launched it at 64x64, its 512x512 readings beside them
    (``at_512x512``)."""
    from bsdmg_tpu_torch import cli
    from bsdmg_tpu_torch.config import MarchConfig
    from bsdmg_tpu_torch.grad import render_image_diff
    from bsdmg_tpu_torch.grad.edge import UNTRACKED, classify_target_miss
    from bsdmg_tpu_torch.ops.cuda import diff_kernel as dk
    from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene, scene_bounds
    from bsdmg_tpu_torch.utils.profiling import form_ops, mandelbulb_loops

    units = ("diff_kernel.cu", "diff_split.cu", "diff_reverse.cu", "diff_lanes.cu")
    resources = [r for source in units
                 for r in kernel_resources(source, ("march_params_kernel<", "loss_march_kernel<",
                                                    "loss_tangent_form_kernel<",
                                                    "loss_reverse_kernel<"))]
    entries = []
    with tempfile.TemporaryDirectory() as tmp:
        arguments = scene_arguments(Path(tmp))
        for name, (perturb, camera, falls) in FIT_SCENES.items():
            arg = arguments.get(name, name)
            argv = ["fit", "--image", "--scene", arg, "--perturb", perturb]
            if camera:
                argv += ["--camera", *map(str, camera)]
            counts, messages, seconds = run_cli(argv)
            fit_tangents, fit_sums = dict(dk.TANGENT_LAUNCHES), dict(dk.SUM_LAUNCHES)
            losses = step_losses(messages)
            print(f"fit {name}: cli fit --image (64x64, {FIT_STEPS} steps) in {seconds:.2f} s, "
                  f"launches {counts}, K5's tangent launches {fit_tangents}, its sums "
                  f"{fit_sums}; loss {losses[0]:.4e} -> {losses[-1]:.4e}; {messages[-1]}")
            check(counts["K4"] >= 1 and counts["K5"] == FIT_STEPS,
                  f"cli fit --image --scene {name} launched K4 {counts['K4']} and K5 "
                  f"{counts['K5']} times")
            want = expected_tangent(name, 64)
            check(sum(fit_tangents.values()) == FIT_STEPS
                  and (want is None or fit_tangents == {want: FIT_STEPS}),
                  f"cli fit --image --scene {name}: K5's tangent launches {fit_tangents}, not "
                  f"{want} {FIT_STEPS} times")
            check(all(np.isfinite(losses)), f"fit --image --scene {name}: loss not finite {losses}")
            scene = cli._get_scene(arg, device)
            form = FORM_OF.get(name, "ProgramForm")
            true = dict(scene.params)
            start = cli._apply_perturb(true, cli._parse_perturb(perturb))
            bounds = scene_bounds(scene)
            bb = None if bounds is None else inflated(bounds, 0.6)
            if falls:
                check(losses[-1] < losses[0], f"fit --image --scene {name}: loss did not fall")
            else:
                o, d, c = rays(64, 64, device, camera)
                logger = logging.getLogger("bsdmg_tpu_torch")
                old_level = logger.level
                logger.setLevel(logging.WARNING)
                try:
                    kern, _ = cli.fit_image(scene, true, start, o, d, c, steps=FIT_TWIN_STEPS,
                                            lr=FIT_LR)
                finally:
                    logger.setLevel(old_level)
                plain, _, shadow = plain_fit(scene, true, start, o, d, c, (FIT_TWIN_STEPS,),
                                             shadow=True)
                err = max((kern[k] - plain[FIT_TWIN_STEPS][k]).abs().max().item() for k in kern)
                worst = (max(shadow["loss_rel"]), max(shadow["excess"]))
                print(f"  K5 against its plain version at the plain versions' first "
                      f"{FIT_TWIN_STEPS} steps' parameters: loss rel err max {worst[0]:.3e}, "
                      f"gradient excess over the bars max {worst[1]:.3e}; the kernels' parameters "
                      f"after them within {err:.3e} of the plain versions'")
                check(worst[0] <= LOSS_RTOL and worst[1] <= 0,
                      f"fit --scene {name}: K5 outside the bars on the fit's path {worst}")
            for r in resources:
                if f"<{form}" in r["kernel"]:
                    print(f"  ptxas: {r['kernel']}: {r['registers']} registers, {r['stack']} B "
                          f"stack, {r['spill_stores']} B spill stores, {r['spill_loads']} B spill "
                          f"loads")
            rows = {}
            for size in (64, 512):
                o, d, c = rays(size, size, device, camera)
                h, w = c.shape
                npix = w * h
                target = render_image_diff(scene.sdf, true, o, d, c, csdf=scene.csdf,
                                           bb=bb).detach()
                k4s = {}
                for track in (False, True):
                    k4 = dk.march_params_cuda(scene.csdf, start, o, d, c, bb=bb, track_min=track)
                    p4, ms = timed_ms(lambda: dk.march_params_torch(scene.csdf, start, o, d, c,
                                                                     bb=bb, track_min=track))
                    if not track:
                        p4_ms = ms
                    exact = {n: bool(torch.equal(k4[i], p4[i])) for i, n in enumerate(
                        ("depth", "steps", "outcome", "dfdt", "min_m", "t_min")[:len(k4)])}
                    both = ~(k4[3].isnan() | p4[3].isnan())
                    err = _max_err(k4[3][both], p4[3][both]) if both.any() else 0.0
                    print(f"parity K4 {name} {w}x{h}, track_min={track}: exact {json.dumps(exact)}, "
                          f"dfdt max err {err:.3e}, hits {int((k4[2] == 0).sum())}")
                    k4s[track] = (k4, p4, err, exact)
                    if name != "mandelbulb":
                        check(all(v for n, v in exact.items() if n != "dfdt"),
                              f"K4 {name} {w}x{h} is not bit-equal to its plain version")
                        check(err <= DFDT_ATOL and torch.equal(k4[3].isnan(), p4[3].isnan()),
                              f"K4 {name} {w}x{h} dfdt {err}")
                k5s = {}
                dk.TANGENT_LAUNCHES.clear()
                dk.SUM_LAUNCHES.clear()
                for edge in (0.0, 1.0):
                    k5 = dk.render_loss_grad_cuda(scene.csdf, start, target, o, d, c, bb=bb,
                                                  edge_weight=edge)
                    again = dk.render_loss_grad_cuda(scene.csdf, start, target, o, d, c, bb=bb,
                                                     edge_weight=edge)
                    p5, ms = timed_ms(lambda: dk.render_loss_grad_torch(
                        scene.csdf, start, target, o, d, c, bb=bb, edge_weight=edge))
                    if edge:
                        p5_ms = ms
                    res = {"loss": k5[0].item(), "plain_loss": p5[0].item(),
                           "loss_rel_err": abs(k5[0].item() - p5[0].item())
                           / max(abs(p5[0].item()), 1e-30),
                           "excess_over_bars": k5_excess(k5[1], p5[1]),
                           "grad_max_abs_err": max(
                               _max_err(k5[1][k].nan_to_num(0.0), p5[1][k].nan_to_num(0.0))
                               for k in k5[1]),
                           "reproducible": bool(torch.equal(k5[0], again[0]) and all(
                               torch.equal(k5[1][k], again[1][k]) for k in k5[1]))}
                    print(f"parity K5 {name} {w}x{h}, edge {edge}: {json.dumps(res)}")
                    check(res["reproducible"], f"K5 {name} {w}x{h} differs between two calls")
                    if name != "mandelbulb":
                        check(res["loss_rel_err"] <= LOSS_RTOL and res["excess_over_bars"] <= 0,
                              f"K5 {name} {w}x{h} outside the bars {res}")
                    k5s[edge] = res
                tangents, size_sums = dict(dk.TANGENT_LAUNCHES), dict(dk.SUM_LAUNCHES)
                want = expected_tangent(name, size)
                print(f"  K5's tangent launches at {w}x{h}: {tangents}, its sums {size_sums}")
                check(want is None or tangents == {want: 4},
                      f"K5 {name} {w}x{h}: tangent launches {tangents}, not {want} 4 times")
                if name == "mandelbulb":
                    bars = bulb_fit_bars(scene, start, o, d, c, target, bb, tiles=size == 64)
                    print(f"  mandelbulb bars at {w}x{h}: {json.dumps(bars)}")
                    if tangents == {f"loss_tangent_form_kernel<{form}, 4>": 4}:
                        bits = direction_bits(scene, start, o, d, c, target, bb)
                        print(f"  mandelbulb at 4 lanes a ray against 1 at {w}x{h}: "
                              f"{json.dumps(bits)}")
                        check(bits["same_bits"] and bits["launches"] == [
                                  {f"loss_tangent_form_kernel<{form}, 4>": 1},
                                  {f"loss_tangent_form_kernel<{form}, 1>": 1}],
                              f"the mandelbulb's K5 at 4 lanes a ray is not the one-lane "
                              f"launch's bits: {bits}")
                # times alone from prepared structs, the plain versions', bounds
                scene_c, _ = dk.param_scene_c(scene.csdf, start, bb=bb, device=device)
                state = dk._target_state(target, None).contiguous()
                k4_ms = graph_ms(lambda: dk._march_cuda(scene_c, o, d, c, False))
                k5_ms = graph_ms(lambda: dk._loss_grad_cuda(
                    scene_c, o, d, c, target, state, npix, 1.0, dk._band(MarchConfig(), None)))
                # the plain versions' times: their calls above (K4's without
                # track_min, K5's with the edge term)
                desc = compile_scene(scene, start)
                loop = mandelbulb_loops(desc, o, d, c)[0] if name == "mandelbulb" else None
                sdf, grad = form_ops(desc, loop)
                depth, steps, outcome, _, min_m, _ = k4s[True][0]
                evals, advances, hits = march_work(steps, outcome, depth)
                miss = classify_target_miss(target)
                hit = outcome == 0
                hinges = int(((~miss & ~hit & (min_m < UNTRACKED)) | (miss & hit)).sum().item())
                n_prm = scene_c.n_prm
                b4 = bound(npix * (28 + 16), k4_ops(npix, evals, advances, False, False,
                                                    bb is not None, False, sdf=sdf, grad=grad))
                b5 = bound(npix * 44, k5_ops(npix, evals, advances, hits, hinges, False, False, True,
                                             sdf=sdf, grad=grad, bounds=bb is not None))
                print(f"time K4 {name} {w}x{h} on {card}: {k4_ms:.4f} ms alone, plain {p4_ms:.3f} "
                      f"ms; {evals} SDF evaluations, {hits} hits; bound {b4[0]:.4f} ms ({b4[1]})")
                print(f"time K5 {name} {w}x{h} fit point on {card}: {k5_ms:.4f} ms alone"
                      f", plain {p5_ms:.3f} ms; {hits} hits, {hinges} hinges, {n_prm} parameter "
                      f"values; bound {b5[0]:.4f} ms ({b5[1]})")
                rows[size] = dict(tangent=" + ".join(tangents), sum=" + ".join(size_sums),
                                  k4=dict(ms=k4_ms, plain_ms=p4_ms, bound_ms=b4[0], bound_by=b4[1]),
                                  k5=dict(ms=k5_ms, plain_ms=p5_ms, bound_ms=b5[0], bound_by=b5[1]),
                                  k4_err=max(v[2] for v in k4s.values()),
                                  k5_err=max(v["grad_max_abs_err"] for v in k5s.values()))
            # the 64x64 readings are of the launches the fit made
            check(rows[64]["tangent"] == " + ".join(fit_tangents)
                  and rows[64]["sum"] == " + ".join(fit_sums),
                  f"K5 {name} at 64x64 launched {rows[64]['tangent']} + {rows[64]['sum']}, the "
                  f"fit {fit_tangents} + {fit_sums}")
            entries += [{
                "name": f"K4 march_params_kernel<{form}> ({name})",
                "route": "cuda",
                "source": dk.SOURCE,
                "replaces": "bsdmg_tpu/ops/pallas/diff_kernel.py:60",
                "launches": counts["K4"],
                "max_abs_err": max(r["k4_err"] for r in rows.values()),
                **rows[512]["k4"],
                "library_ms": None,
            }, {
                # the launches the fit made, at its 64x64; the 512x512 fit
                # point's, whose tangent launch may be another instantiation,
                # beside them
                "name": f"K5 loss_march_kernel<{form}> + {' + '.join(fit_tangents)} + "
                        f"{' + '.join(fit_sums)} ({name}, cli fit --image at 64x64)",
                "route": "cuda",
                "source": dk.SOURCE,
                "replaces": "bsdmg_tpu/ops/pallas/diff_kernel.py:232",
                "launches": counts["K5"],
                "max_abs_err": rows[64]["k5_err"],
                **rows[64]["k5"],
                "library_ms": None,
                "at_512x512": {"name": f"K5 loss_march_kernel<{form}> + {rows[512]['tangent']} + "
                                       f"{rows[512]['sum']}",
                               "max_abs_err": rows[512]["k5_err"], **rows[512]["k5"]},
            }]
    return entries


# ---------------------------------------------------------------------------
# the mesh-asset render: K8, K9 and P1
# ---------------------------------------------------------------------------

# P1 against the probe's trilinear oracle (tools/probe_mxu.py), and the
# image bar of tests/test_mesh_sdf.py:475-476 for the gather route against
# the contraction route
PROBE_ATOL = 1e-4
GRID_IMAGE_ATOL = 1e-3
GRID_IMAGE_SHARE = 0.99
TORUS_CAMERA = (3.0, 1.5, -3.0)
# launches of one `cli render --scene mesh:<torus.obj>` (a 128^3 grid)
GRID_LAUNCHES = {"K8": 1, "K9": 2, "P1": 1}

def png_pixels(path: Path) -> np.ndarray:
    """The ``(H, W, 4)`` pixels of a PNG as mesh/export.py::save_png writes
    it (8-bit RGBA, every row with filter 0)."""
    data = path.read_bytes()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path} is not a PNG")
    w, h = struct.unpack(">II", data[16:24])
    idat, pos = b"", 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 4 * w)
    check(bool((rows[:, 0] == 0).all()), "a PNG row uses a filter save_png does not write")
    return rows[:, 1:].reshape(h, w, 4)


def probe_oracle(t3: np.ndarray, cx, cy, cz) -> np.ndarray:
    """tools/probe_mxu.py's numpy trilinear oracle."""
    r = t3.shape[0]

    def tri(q):
        x0 = np.floor(q).astype(int)
        return x0, np.minimum(x0 + 1, r - 1), q - x0

    (x0, x1, fx), (y0, y1, fy), (z0, z1, fz) = tri(cx), tri(cy), tri(cz)
    exp = np.zeros(cx.shape)
    for dx, wxv in ((x0, 1 - fx), (x1, fx)):
        for dy, wyv in ((y0, 1 - fy), (y1, fy)):
            for dz, wzv in ((z0, 1 - fz), (z1, fz)):
                exp += wxv * wyv * wzv * t3[dx, dy, dz]
    return exp


def march_launch_work(state: dict, out, listed: bool = False) -> tuple[int, int, int, int]:
    """``(rays marched, evaluations, advances, ray bytes)`` of one grid
    march launch, from its resume state (empty: every ray from step 0) and
    its output, counted as K1's are. A marched ray reads its origin,
    direction and cone (28 B), on a resumed launch also its active flag,
    depth and steps (12 B), and writes depth, steps and outcome (12 B). A
    ray that is not active reads its flag (4 B) when the launch lists the
    active rays (``listed``: K8, csrc/grid_kernel.cu::grid_march_kernel), and
    else its flag, depth, steps and outcome (16 B) and writes 12 B (K9,
    contraction_kernel)."""
    steps, outcome = out[1].reshape(-1), out[2].reshape(-1)
    marched = torch.ones_like(outcome, dtype=torch.bool)
    steps0 = torch.zeros_like(steps)
    if state:
        marched, steps0 = state["active"].reshape(-1) > 0, state["steps0"].reshape(-1)
    taken = int((steps - steps0)[marched].sum())
    ended = outcome[marched]
    n, n_marched = outcome.numel(), int(marched.sum())
    idle = 4 if listed else 16 + 12
    ray_bytes = n_marched * (28 + (12 if state else 0) + 12) + (n - n_marched) * idle
    return (n_marched, taken + int(((ended == 0) | (ended == 2)).sum()),
            taken + int((ended == 2).sum()), ray_bytes)


def touched_table_bytes(sampler, rays, cfg, state: dict) -> int:
    """The bytes of the distinct table values that one grid march's samples
    read: the eight corners of each sample's cell, from the plain version's
    march on the same inputs (which samples exactly what the kernel does)."""
    from bsdmg_tpu_torch.models.mesh_sdf import box_f32
    from bsdmg_tpu_torch.ops.cuda import grid_kernel as tg

    r = sampler.r
    lo, _, scale, clip_hi = box_f32(r, sampler.lo, sampler.hi)
    cells, inner = [], tg.sampler_csdf

    def recording(s):
        f = inner(s)

        def csdf(x, y, z):
            index = 0
            for a, v in enumerate((x, y, z)):
                index = index * r + torch.floor(torch.clamp((v - lo[a]) * scale[a], 0.0,
                                                            clip_hi)).long()
            cells.append(torch.unique(index))
            return f(x, y, z)

        return csdf

    tg.sampler_csdf = recording
    try:
        tg.grid_march_torch(sampler, *rays, cfg, budget=cfg.step_limit, **state)
    finally:
        tg.sampler_csdf = inner
    base = torch.unique(torch.cat(cells))
    offsets = torch.tensor([dx * r * r + dy * r + dz for dx in (0, 1) for dy in (0, 1)
                            for dz in (0, 1)], device=base.device)
    corners = torch.unique((base[:, None] + offsets).reshape(-1))
    return corners.numel() * sampler.table.element_size()


def graph_ms(fn, reps: int = 20, runs: int = 7) -> float:
    """The kernels' own time of ``fn``: the median over ``runs`` of the
    CUDA-event time of one replay of a CUDA graph that holds ``reps`` calls
    of ``fn``, per call, so no host work stands between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return median_ms(graph.replay, runs=runs) / reps


def march_kernel_ms(sampler, rays, cfg, state: dict) -> float:
    """One grid march launch's own time: prepared structs, preallocated
    outputs, :func:`graph_ms`."""
    from bsdmg_tpu_torch.ops.cuda import grid_kernel as tg
    from bsdmg_tpu_torch.ops.cuda.grid_box import grid_box_c

    n = rays[2].numel()
    out = (torch.empty(n, device=rays[2].device), *(torch.empty(n, dtype=torch.int32,
                                                                 device=rays[2].device)
                                                     for _ in range(2)))
    box = grid_box_c(sampler.r, sampler.lo, sampler.hi)
    march = tg.grid_march_c(cfg, cfg.step_limit)
    planes = tuple(state[k] for k in ("active", "depth0", "steps0", "outcome0")) if state else ()
    return graph_ms(lambda: tg._march_cuda(sampler, box, march, *rays, planes, out))


def sample_kernel_ms(sampler, points) -> float:
    """One P1 launch's own time, as :func:`march_kernel_ms`."""
    from bsdmg_tpu_torch.ops.cuda import grid_kernel as tg
    from bsdmg_tpu_torch.ops.cuda.grid_box import grid_box_c

    out, box = torch.empty_like(points[0]), grid_box_c(sampler.r, sampler.lo, sampler.hi)
    return graph_ms(lambda: tg._sample_cuda(sampler, box, *points, out))


def staged_contraction(grid, rays, cfg) -> tuple[dict, list, tuple, torch.Tensor]:
    """The contraction route of render_image_grid step by step, each step
    timed on the host clock after a sync: returns the stage times, each
    march launch as ``(label, sampler, resume state, output)``, P1's
    stencil points and the linear RGB image."""
    from bsdmg_tpu_torch.ops.cuda import grid_kernel as tg
    from bsdmg_tpu_torch.ops.shade import shade_planes

    stages, launches = {}, []

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return out

    levels = timed("mips", lambda: tg.make_contraction_levels(grid))
    state = {}
    for level in levels:
        out = timed(f"level {level.r}^3", lambda: tg.grid_march(
            level, *rays, cfg, budget=cfg.step_limit, **state))
        kind = "bf16" if level.kind == tg.HAT_BF16 else "f32"
        launches.append((f"K9 {level.r}^3 {kind}", level, state, out))
        active, steps = tg.resume_state(out[1], out[2])
        state = dict(active=active, depth0=out[0], steps0=steps, outcome0=out[2])
    if levels[-1].kind != tg.HAT_F32:
        sampler = tg.interp_sampler(grid)
        out = timed("finish", lambda: tg.grid_march(sampler, *rays, cfg, budget=cfg.step_limit,
                                                    **state))
        launches.append(("K8 fine finish", sampler, state, out))
    depth, _, outcome = out
    hit, px, py, pz = tg.hit_points(*rays[:2], depth, outcome)
    normals = timed("normals", lambda: tg.fd4_normal(tg.interp_sampler(grid), px, py, pz,
                                                     cfg.normal_epsilon))

    def shade():
        planes = [torch.zeros(depth.numel(), device=depth.device) for _ in range(3)]
        for plane, value in zip(planes, normals):
            plane[hit] = value
        return torch.stack(shade_planes(*planes, outcome), dim=-1).reshape(*rays[2].shape, 3)

    rgb = timed("shade", shade)
    return stages, launches, tg.fd4_stencil(px, py, pz, cfg.normal_epsilon), rgb


def grid_frame(label: str, card: str, grid, rays, cfg, *, plain: bool) -> dict:
    """Frame and kernel times of the contraction route of one frame: the
    frame's wall time (host clock after a sync, median of 5, warm), each
    launch's own time (:func:`graph_ms`) and its wrapper's (CUDA events,
    median of 7) from its own inputs, its work and bound, and with
    ``plain`` its plain version's time. K8's bound counts the table values
    its samples read (:func:`touched_table_bytes`), with the bound of every
    ray's planes and the whole table beside it; K9's and P1's count each
    table whole, once (an upper estimate of the bytes the samples touch), so
    the bound from the rays' bytes alone is printed beside them."""
    from bsdmg_tpu_torch.ops.cuda import grid_kernel as tg

    levels = tg.make_contraction_levels(grid)
    n = rays[2].numel()
    frames = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tg.render_image_grid(grid, *rays, cfg, mode="contraction", levels=levels)
        torch.cuda.synchronize()
        frames.append(time.perf_counter() - t0)
    frame_s = statistics.median(frames[1:])
    print(f"frame {label} on {card}: {frame_s * 1e3:.3f} ms wall ({n / frame_s:.4g} rays/s), "
          f"host clock after a sync, median of 5 warm frames")
    _, launches, stencil, _ = staged_contraction(grid, rays, cfg)
    rows = {}

    def row(name, ms, w_ms, p_ms, ops, ray_bytes, table_bytes):
        nbytes = ray_bytes + table_bytes
        b_ms, b_by = bound(nbytes, ops)
        rows[name] = dict(ms=ms, wrapper_ms=w_ms, plain_ms=p_ms, bound_ms=b_ms, ops=ops,
                          nbytes=nbytes)
        return (f"wrapper {w_ms:.4f} ms, plain {'not timed' if p_ms is None else f'{p_ms:.3f} ms'}; "
                f"{ops:.4g} FP32 operations, {nbytes} B ({ray_bytes} B of rays or points); "
                f"bound {b_ms:.4f} ms ({b_by}), from the rays' or points' bytes alone "
                f"{bound(ray_bytes, ops)[0]:.4f} ms")

    for name, sampler, state, out in launches:
        k8 = sampler.kind == tg.INTERP_F32
        marched, evals, advances, ray_bytes = march_launch_work(state, out, listed=k8)
        ops = evals * ((INTERP if k8 else HAT) + MARCH_EVAL) + advances * MARCH_ADVANCE
        if k8:
            # K8's bound for the work it must do: the flags, the active rays'
            # planes and the table values its samples read; beside it the
            # bound of every ray's planes and the whole table
            touched = touched_table_bytes(sampler, rays, cfg, state)
            whole = march_launch_work(state, out)[3] + sampler.table.numel() * 4
            print(f"bound {name} {label}: {ray_bytes} B of rays and {touched} B of table values "
                  f"read ({bound(ray_bytes + touched, ops)[0]:.4f} ms); every ray's planes and "
                  f"the whole table {whole} B ({bound(whole, ops)[0]:.4f} ms)")
        ms = march_kernel_ms(sampler, rays, cfg, state)
        w_ms = median_ms(lambda: tg.grid_march_cuda(sampler, *rays, cfg, budget=cfg.step_limit,
                                                    **state), reps=5)
        p_ms = None
        if plain:
            p_ms = median_ms(lambda: tg.grid_march_torch(sampler, *rays, cfg, budget=cfg.step_limit,
                                                         **state), runs=3, warmup=1)
        text = row(name, ms, w_ms, p_ms, ops, ray_bytes,
                   touched if k8 else sampler.table.numel() * sampler.table.element_size())
        print(f"time {name} {label} on {card}: {ms:.4f} ms ({marched / ms * 1e3:.4g} marched rays/s, "
              f"{marched} of {n} rays, {evals} samples), {text}")
    sampler = tg.interp_sampler(grid)
    points = stencil[0].numel()
    ms = sample_kernel_ms(sampler, stencil)
    w_ms = median_ms(lambda: tg.grid_sample_cuda(sampler, *stencil), reps=5)
    p_ms = median_ms(lambda: tg.grid_sample_torch(sampler, *stencil), runs=3, warmup=1) if plain else None
    text = row("P1", ms, w_ms, p_ms, points * INTERP, points * 16, sampler.table.numel() * 4)
    print(f"time P1 normals {label} on {card}: {ms:.4f} ms ({points} points, "
          f"{points / ms * 1e3:.4g} samples/s), {text}")
    device_ms = sum(r["ms"] for r in rows.values())
    print(f"frame {label}: the kernels take {device_ms:.3f} ms of the {frame_s * 1e3:.3f} ms frame")
    rows["frame_s"] = frame_s
    return rows


def grid_march_parity(name: str, sampler, rays, state: dict, cfg) -> float:
    """One grid march launch against its plain version on the same inputs,
    bit for bit; returns the largest depth difference."""
    from bsdmg_tpu_torch.ops.cuda import grid_kernel as tg

    kern = tg.grid_march_cuda(sampler, *rays, cfg, budget=cfg.step_limit, **state)
    plain = tg.grid_march_torch(sampler, *rays, cfg, budget=cfg.step_limit, **state)
    torch.cuda.synchronize()
    differ = (kern[0] != plain[0]) | (kern[1] != plain[1]) | (kern[2] != plain[2])
    res = {
        "rays": kern[0].numel(),
        "marched": int(state["active"].sum()) if state else kern[0].numel(),
        "differing_rays": int(differ.sum()),
        "depth_max_err": _max_err(kern[0], plain[0]),
        "steps_max_diff": int((kern[1] - plain[1]).abs().max()),
        "outcomes": torch.bincount(kern[2], minlength=3).tolist(),
    }
    print(f"parity {name}: {json.dumps(res)}")
    check(res["differing_rays"] == 0, f"{name} and its plain version are not bit-equal: {res}")
    return res["depth_max_err"]


def contraction_state(levels, rays, cfg) -> dict:
    """The resume state that the contraction route's levels leave for its
    fine finish (grid_kernel.py::grid_trace_contraction)."""
    from bsdmg_tpu_torch.ops.cuda import grid_kernel as tg

    state = {}
    for level in levels:
        out = tg.grid_march(level, *rays, cfg, budget=cfg.step_limit, **state)
        active, steps = tg.resume_state(out[1], out[2])
        state = dict(active=active, depth0=out[0], steps0=steps, outcome0=out[2])
    return state


def k8_in_place_parity(name: str, sampler, rays, state: dict, cfg) -> None:
    """K8 resumed in place (grid_kernel.py::grid_march_into, the routes'
    finish) on copies of ``state``'s planes against the plain version, bit
    for bit."""
    from bsdmg_tpu_torch.ops.cuda import grid_kernel as tg

    planes = [state[k].clone().reshape(-1) for k in ("depth0", "steps0", "outcome0")]
    tg.grid_march_into(sampler, *rays, cfg, active=state["active"], depth=planes[0],
                       steps=planes[1], outcome=planes[2], budget=cfg.step_limit)
    plain = tg.grid_march_torch(sampler, *rays, cfg, budget=cfg.step_limit, **state)
    torch.cuda.synchronize()
    differ = int(((planes[0] != plain[0]) | (planes[1] != plain[1]) | (planes[2] != plain[2])).sum())
    print(f"parity {name}, in place: {differ} of {planes[0].numel()} rays differ, "
          f"{int(state['active'].sum())} marched")
    check(differ == 0, f"{name} in place and its plain version are not bit-equal")


def k8_branch_parity(grid, rays, finish: dict, cfg, levels) -> None:
    """K8's branches against its plain version, bit for bit: in place on the
    frame's finish state; a 100x37 frame (not a multiple of 16 wide) fresh,
    resumed through the public wrapper and in place; and, on both frames,
    resume states with no ray and with every ray active."""
    from bsdmg_tpu_torch.cam import generate_rays, look_at
    from bsdmg_tpu_torch.ops.cuda import grid_kernel as tg

    h, w = rays[2].shape
    small = generate_rays(look_at(TORUS_CAMERA, device=rays[2].device), (100, 37), (100.0, 37.0))
    state = contraction_state(levels, small, cfg)
    sampler = tg.interp_sampler(grid)
    k8_in_place_parity(f"K8 fine finish {w}x{h}", sampler, rays, finish, cfg)
    grid_march_parity("K8 fresh 100x37", sampler, small, {}, cfg)
    for frame, label, base in ((rays, f"{w}x{h}", finish), (small, "100x37", state)):
        cases = {"fine finish": base,
                 "no ray active": dict(base, active=torch.zeros_like(base["active"])),
                 "every ray active": dict(base, active=torch.ones_like(base["active"]))}
        for case, st in cases.items():
            if frame is small or case != "fine finish":
                name = f"K8 {case} {label}"
                grid_march_parity(name, sampler, frame, st, cfg)
                k8_in_place_parity(name, sampler, frame, st, cfg)


def grid_phases(card: str, device, resolution: int = 128, size=(1920, 1080),
                bench=(512, 128)) -> list[dict]:
    """Phases 12-14: the mesh-asset path through the CLI (a ``resolution``^3
    grid, ``size`` pixels); K8, K9 and P1 against their plain versions and
    P1 against the probe's oracle; the gather route against the contraction
    route; frame and kernel times, also at the bench point (``bench``: its
    square image's side and its grid's resolution)."""
    import torch.nn.functional as F

    from bsdmg_tpu_torch import cli
    from bsdmg_tpu_torch.cam import generate_rays, look_at
    from bsdmg_tpu_torch.config import MarchConfig
    from bsdmg_tpu_torch.mesh.export import load_obj, save_png
    from bsdmg_tpu_torch.models import reference_object
    from bsdmg_tpu_torch.models.mesh_sdf import SdfGrid, _linspace, coarsen_grid_lower
    from bsdmg_tpu_torch.ops.cuda import build
    from bsdmg_tpu_torch.ops.cuda import grid_kernel as tg
    from bsdmg_tpu_torch.ops.shade import to_rgba8

    cfg = MarchConfig()
    for line in build.resource_report("grid_kernel.cu").splitlines():
        if "Compiling entry" in line or "spill" in line or "Used" in line:
            print(f"  ptxas: {line.strip()}")

    with tempfile.TemporaryDirectory() as tmp:
        obj, png = Path(tmp) / "torus.obj", Path(tmp) / "torus.png"
        made = subprocess.run([sys.executable, str(ROOT / "tools" / "make_torus.py"), str(obj)],
                              capture_output=True, text=True, check=True, timeout=300)
        print(f"mesh-asset path: {made.stdout.strip()}")
        # the CLI's grid, kept for the phases below (a second bake would
        # take as long as the first)
        grids, bake = [], cli.mesh_scene

        def keep_grid(*args, **kwargs):
            scene, grid = bake(*args, **kwargs)
            grids.append(grid)
            return scene, grid

        cli.mesh_scene = keep_grid
        torch.cuda.synchronize(device)  # CUDA initialised, whichever phase runs first
        torch.cuda.reset_peak_memory_stats(device)
        try:
            counts, messages, seconds = run_cli([
                "render", "--scene", f"mesh:{obj}:{resolution}", "--camera", *map(str, TORUS_CAMERA),
                "--width", str(size[0]), "--height", str(size[1]), "-o", str(png),
            ])
        finally:
            cli.mesh_scene = bake
        peak = torch.cuda.max_memory_allocated(device)
        launches = {k: counts[k] for k in GRID_LAUNCHES}
        pixels = png_pixels(png)
        hits = int((pixels[..., :3] != 0).any(axis=-1).sum())
        print(f"mesh-asset path: cli render --scene mesh:torus.obj:{resolution} --camera 3 1.5 -3 "
              f"-> {size[0]}x{size[1]}, "
              f"{png.stat().st_size} B PNG, {hits} pixels not background, in {seconds:.2f} s; "
              f"launches {launches}; peak device memory {peak / 2**20:.1f} MiB")
        for message in messages:
            print(f"  cli: {message}")
        check(launches == GRID_LAUNCHES, f"cli render --scene mesh: launched {launches}, "
              f"not {GRID_LAUNCHES}")
        check(pixels.shape == (size[1], size[0], 4) and hits > 0, f"PNG {pixels.shape}, {hits} hits")

        # the same steps on the CLI's grid, staged and timed
        (grid,) = grids
        t0 = time.perf_counter()
        src = load_obj(obj)
        stages = {"load": time.perf_counter() - t0}
        t0 = time.perf_counter()
        python = load_obj(obj, use_native=False)
        stages["load (Python reader)"] = time.perf_counter() - t0
        check(all(np.array_equal(getattr(src, k), getattr(python, k))
                  for k in ("vertices", "normals", "faces")),
              "the native OBJ reader and the Python one read the torus differently")
        bake_line = next(m for m in messages if m.startswith("loaded "))
        stages["bake (cli)"] = float(bake_line.rsplit(" in ", 1)[1].rstrip("s"))
        rays = generate_rays(look_at(TORUS_CAMERA, device=device), size, SCREEN)
        more, launches_in, stencil, rgb = staged_contraction(grid, rays, cfg)
        stages.update(more)
        t0 = time.perf_counter()
        save_png(to_rgba8(rgb).cpu().numpy(), Path(tmp) / "staged.png")
        stages["PNG"] = time.perf_counter() - t0
        print(f"stages on {card} (s, host clock after a sync; {src.triangle_count} triangles, "
              f"{grid.resolution}^3): " + json.dumps({k: round(v, 6) for k, v in stages.items()}))
        check(np.array_equal(png_pixels(Path(tmp) / "staged.png"), pixels),
              "the staged steps' PNG differs from cli render's")
        outcome = launches_in[-1][3][2]
        counts_out = torch.bincount(outcome, minlength=3).tolist()
        print(f"  outcomes (collision, step limit, depth limit) {counts_out}; "
              f"{counts_out[0] + counts_out[1]} pixels not background")
        check(counts_out[0] + counts_out[1] == hits, "hit pixels differ from the PNG's")

    # each launch of the path against its plain version, bit for bit
    errors = {}
    for name, sampler, state, _ in launches_in:
        errors[name] = grid_march_parity(f"{name} torus {size[0]}x{size[1]}", sampler, rays, state, cfg)
    coarse = coarsen_grid_lower(grid, tg.MID_RESOLUTION)
    grid_march_parity(f"K8 on the 64^3 mip (gather route) torus {size[0]}x{size[1]}", tg.interp_sampler(coarse),
                      rays, {}, cfg)
    k8_branch_parity(grid, rays, launches_in[-1][2], cfg, tg.make_contraction_levels(grid))
    sampler = tg.interp_sampler(grid)
    kern = tg.grid_sample_cuda(sampler, *stencil)
    plain = tg.grid_sample_torch(sampler, *stencil)
    torch.cuda.synchronize()
    p1_err = _max_err(kern, plain)
    print(f"parity P1 on the torus frame's {kern.numel()} stencil points: "
          f"{int((kern != plain).sum())} values differ, max {p1_err:.3e}")
    check(torch.equal(kern, plain), "P1 and its plain version are not bit-equal")

    # P1 on the probe's own inputs
    r = 32
    t3 = torch.arange(r**3, dtype=torch.float32, device=device) % 97
    coords = np.random.default_rng(0).uniform(0.0, r - 1.001, (3, 512)).astype(np.float32)
    cx, cy, cz = (torch.from_numpy(c).to(device) for c in coords)
    probe = tg.Sampler(tg.HAT_F32, t3, r, (0.0,) * 3, (r - 1.0,) * 3)
    got = tg.grid_sample_cuda(probe, cx, cy, cz)
    oracle = probe_oracle(t3.cpu().numpy().reshape(r, r, r), *coords)
    probe_err = float(np.abs(got.cpu().numpy() - oracle).max())
    t2 = t3.reshape(r * r, r).T.contiguous()
    contraction = tg.probe_contraction_torch(t2, cx[None], cy[None], cz[None])
    volume = t3.reshape(1, 1, r, r, r)
    normalized = torch.stack([cz, cy, cx], dim=-1).reshape(1, 1, 1, -1, 3) / (r - 1) * 2 - 1
    library = F.grid_sample(volume, normalized, mode="bilinear", align_corners=True).reshape(-1)
    print(f"P1 probe (T3 = arange(32^3) % 97, 512 points): max error against the probe's oracle "
          f"{probe_err:.3e}; the plain version bit-equal "
          f"{torch.equal(got, tg.grid_sample_torch(probe, cx, cy, cz))}; the probe's contraction "
          f"(matmul) {float(np.abs(contraction[0].cpu().numpy() - oracle).max()):.3e}; "
          f"F.grid_sample {float(np.abs(library.cpu().numpy() - oracle).max()):.3e}")
    check(probe_err <= PROBE_ATOL, f"P1 off the probe's oracle by {probe_err}")
    p1_probe_ms = sample_kernel_ms(probe, (cx, cy, cz))
    gs_probe_ms = graph_ms(lambda: F.grid_sample(volume, normalized, mode="bilinear",
                                                 align_corners=True))
    print(f"time P1 probe (512 points) on {card}: {p1_probe_ms:.4f} ms, F.grid_sample "
          f"{gs_probe_ms:.4f} ms (each in a CUDA graph of 20 calls)")

    # the gather route against the contraction route on the torus frame
    gather = tg.render_image_grid(grid, *rays, cfg, mode="gather")
    diff = (gather - rgb).abs().amax(dim=-1)
    share = (diff < GRID_IMAGE_ATOL).float().mean().item()
    print(f"gather route against contraction route, torus frame: share under {GRID_IMAGE_ATOL} "
          f"= {share:.6f}, max {diff.max().item():.3e}")
    check(share >= GRID_IMAGE_SHARE, f"gather and contraction images differ: share {share}")

    # frame and kernel times: the torus frame, then the JAX bench's
    # grid point (bench.py:84-105: the reference object baked analytically
    # at 128^3 over +-2.6, 512x512 from (5, 2, -5), screen 512x512)
    torus = grid_frame(f"torus {size[0]}x{size[1]}", card, grid, rays, cfg, plain=True)
    scene = reference_object(device=device)
    axis = torch.from_numpy(_linspace(np.float32(-2.6), np.float32(2.6), bench[1])).to(device)
    values = scene.csdf(scene.params, *torch.meshgrid(axis, axis, axis, indexing="ij"))
    bench_grid = SdfGrid(values=values.contiguous(), lo=(-2.6,) * 3, hi=(2.6,) * 3)
    side = bench[0]
    bench_rays = generate_rays(look_at((5.0, 2.0, -5.0), device=device), (side, side),
                               (float(side), float(side)))
    bench = grid_frame(f"bench point {side}x{side}", card, bench_grid, bench_rays, cfg, plain=False)

    # P1's library yardstick at the path's shape: F.grid_sample of the
    # stencil points on the torus table (its border rule is not the grid
    # SDF's outside step: a time, not a result)
    lo, hi = torch.tensor(grid.lo, device=device), torch.tensor(grid.hi, device=device)
    points = torch.stack([stencil[2], stencil[1], stencil[0]], dim=-1)
    normalized = ((points - lo.flip(0)) / (hi - lo).flip(0) * 2 - 1).reshape(1, 1, 1, -1, 3)
    volume = grid.values.reshape(1, 1, *grid.values.shape)
    gs_ms = graph_ms(lambda: F.grid_sample(volume, normalized, mode="bilinear",
                                           align_corners=True))
    print(f"time F.grid_sample on the torus frame's {stencil[0].numel()} stencil points on {card}: "
          f"{gs_ms:.4f} ms (P1 {torus['P1']['ms']:.4f} ms)")
    print(f"bench point frame {bench['frame_s'] * 1e3:.3f} ms; torus frame "
          f"{torus['frame_s'] * 1e3:.3f} ms")

    k9 = [name for name in torus if name.startswith("K9")]
    k9_ops = sum(torus[n]["ops"] for n in k9)
    k9_bytes = sum(torus[n]["nbytes"] for n in k9)
    k9_bound, k9_by = bound(k9_bytes, k9_ops)
    k8_bound, k8_by = bound(torus["K8 fine finish"]["nbytes"], torus["K8 fine finish"]["ops"])
    p1_bound, p1_by = bound(torus["P1"]["nbytes"], torus["P1"]["ops"])
    return [{
        "name": "K9 contraction_kernel<T> (contraction ladder level; both levels of a frame)",
        "route": "cuda",
        "source": tg.SOURCE,
        "replaces": "bsdmg_tpu/ops/pallas/grid_kernel.py:307",
        "launches": launches["K9"],
        "max_abs_err": max(errors[n] for n in k9),
        "ms": sum(torus[n]["ms"] for n in k9),
        "plain_ms": sum(torus[n]["plain_ms"] for n in k9),
        "bound_ms": k9_bound,
        "bound_by": k9_by,
        "library_ms": None,
    }, {
        "name": "K8 grid_march_kernel<Resumed> (grid march; the fine finish, in place)",
        "route": "cuda",
        "source": tg.SOURCE,
        "replaces": "bsdmg_tpu/ops/pallas/grid_kernel.py:72",
        "launches": launches["K8"],
        "max_abs_err": errors["K8 fine finish"],
        "ms": torus["K8 fine finish"]["ms"],
        "plain_ms": torus["K8 fine finish"]["plain_ms"],
        "bound_ms": k8_bound,
        "bound_by": k8_by,
        "library_ms": None,
    }, {
        "name": "P1 grid_sample_kernel<InterpF32> (grid sampler; the hit normals)",
        "route": "cuda",
        "source": tg.SOURCE,
        "replaces": "tools/probe_mxu.py:28",
        "launches": launches["P1"],
        "max_abs_err": max(p1_err, probe_err),
        "ms": torus["P1"]["ms"],
        "plain_ms": torus["P1"]["plain_ms"],
        "bound_ms": p1_bound,
        "bound_by": p1_by,
        "library_ms": gs_ms,
    }]


# ---------------------------------------------------------------------------
# the march probe: K1's march loop in SASS, registers and spills, and the
# latency of one march step of a ray marched alone
# ---------------------------------------------------------------------------

#: K1's default instantiation (culled, exact, FRESH) for the render scene
K1_DEFAULT = "render_kernel<Box<true, false>, true, false, 0>"


def toolkit_tool(name: str) -> str:
    """A CUDA toolkit program beside nvcc (cuobjdump, cu++filt)."""
    from bsdmg_tpu_torch.ops.cuda import build

    return str(Path(build.nvcc_path()).parent / name)


def demangled(names: list[str]) -> dict[str, str]:
    """Kernel names as cu++filt gives them, without the return type and the
    arguments, template arguments written as in the source:
    ``render_kernel<Box<true, false>, true, false, 0>``."""
    import re

    out = subprocess.run([toolkit_tool("cu++filt"), *names], capture_output=True, text=True,
                         check=True, timeout=60)
    short = {}
    for name, full in zip(names, out.stdout.splitlines(), strict=True):
        depth, cut = 0, len(full)
        for k in range(len(full) - 1, -1, -1):  # the argument list: the last (...)
            depth += {")": 1, "(": -1}.get(full[k], 0)
            if depth == 0:
                cut = k
                break
        head = full[:cut].removeprefix("void ")
        head = re.sub(r"\(bool\)1", "true", re.sub(r"\(bool\)0", "false", head))
        short[name] = re.sub(r"\((?:int|unsigned int)\)(-?\d+)", r"\1", head)
    return short


def kernel_resources(source: str, prefixes: tuple[str, ...]) -> list[dict]:
    """ptxas's registers, stack and spill bytes of the kernels of ``source``
    whose demangled names start with one of ``prefixes``."""
    from bsdmg_tpu_torch.ops.cuda import build

    kernels = build.kernel_resources(source)
    names = demangled([k["kernel"] for k in kernels])
    rows = [dict(k, kernel=names[k["kernel"]]) for k in kernels]
    return [r for r in rows if r["kernel"].startswith(prefixes)]


_SASS: dict = {}


def sass_functions(library: Path) -> dict[str, list]:
    """Each kernel's SASS in the library, ``{demangled name: [(address,
    instruction), ...]}``, disassembled once a build of the library (the
    probes read it four times)."""
    import re

    key = (str(library), library.stat().st_mtime_ns)
    if key in _SASS:
        return _SASS[key]
    out = subprocess.run([toolkit_tool("cuobjdump"), "-sass", str(library)], capture_output=True,
                         text=True, check=True, timeout=600)
    functions, current = {}, None
    for line in out.stdout.splitlines():
        if "Function : " in line:
            current = line.split("Function : ")[1].strip()
            functions[current] = []
        elif current is not None:
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if m:
                functions[current].append((int(m.group(1), 16), m.group(2)))
    names = demangled(sorted(functions))
    _SASS[key] = {names[f]: code for f, code in functions.items()}
    return _SASS[key]


def loops_of(code: list) -> list[dict]:
    """The loops of one kernel's SASS: each backward branch with its target,
    the static instruction count of the body, its SFU (MUFU), shuffle,
    vote and branch instructions, and its global, shared and constant
    loads."""
    import re

    loops = []
    for addr, text in code:
        targets = re.findall(r"0x[0-9a-f]+", text) if re.search(r"\bBRA\b", text) else []
        if targets and int(targets[-1], 16) <= addr:
            start = int(targets[-1], 16)
            body = [x for a, x in code if start <= a <= addr]
            opcodes = Counter(x.split()[1 if x.startswith("@") else 0].split(".")[0] for x in body)
            loops.append({"from": hex(start), "to": hex(addr), "instructions": len(body),
                          **{op.lower(): sum(op in x for x in body)
                             for op in ("MUFU", "SHFL", "VOTE", "BRA", "CALL")},
                          **{op.lower(): opcodes[op]
                             for op in ("LDG", "LDS", "LDC", "LD", "LDL", "STL", "ULDC")},
                          "opcodes": dict(opcodes.most_common(12))})
    return loops


def sass_loops(library: Path, kernel: str) -> list[dict]:
    """The loops of ``kernel`` (a demangled name without its arguments) in
    the library's SASS (:func:`loops_of`)."""
    functions = sass_functions(library)
    check(kernel in functions, f"{kernel} not in the library's SASS")
    return loops_of(functions[kernel])


def sass_kernel_loops(library: Path, prefixes: tuple[str, ...]) -> dict[str, list]:
    """:func:`loops_of` each kernel whose demangled name starts with one of
    ``prefixes``."""
    return {k: loops_of(code) for k, code in sass_functions(library).items()
            if k.startswith(prefixes)}


def march_probe(card: str, device, kernel: str = K1_DEFAULT) -> dict:
    """The march probe. K1's loops in SASS (``kernel``; its first loop is
    the march step); ptxas's registers and spills of every K1, K2 and K5
    instantiation; the latency of one march step of the 1920x1080 frame's
    longest ray marched alone (K2 over a list of that one ray: a CUDA graph
    with the step budget at 1, then at the step limit; the difference over
    the steps between); and, for K5 at the 64x64 fit point, its longest
    ray alone through K4 and K5 (1x1 images) beside K5 over the frame."""
    from bsdmg_tpu_torch import cli
    from bsdmg_tpu_torch.config import MarchConfig
    from bsdmg_tpu_torch.grad import render_image_diff
    from bsdmg_tpu_torch.models import reference_render_scene
    from bsdmg_tpu_torch.ops.cuda import build
    from bsdmg_tpu_torch.ops.cuda import diff_kernel as dk
    from bsdmg_tpu_torch.ops.cuda import render_kernel as rk
    from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene, scene_bounds
    from bsdmg_tpu_torch.ops.trace import DEPTH_LIMIT

    out: dict = {"loops": sass_loops(build.build(), kernel)}
    print(f"march probe: {kernel} loops in SASS (static instructions; the first is the "
          f"march step): {json.dumps(out['loops'])}")
    resources = (kernel_resources("render_kernel.cu", ("render_kernel<", "trace_kernel<"))
                 + kernel_resources("diff_kernel.cu", ("loss_",)))
    for r in resources:
        print(f"  ptxas: {r['kernel']}: {r['registers']} registers, {r['stack']} B stack, "
              f"{r['spill_stores']} B spill stores, {r['spill_loads']} B spill loads")
    out["resources"] = resources

    cfg = MarchConfig()
    desc = compile_scene(reference_render_scene(device=device))
    desc_c = rk.scene_desc_c(desc, cfg)
    o, d, c = rays(1920, 1080, device)
    _, steps, _ = rk.trace_cuda(desc, o, d, c)
    i = int(torch.argmax(steps).item())
    n = int(steps.reshape(-1)[i].item())
    carried = (torch.zeros_like(c), torch.zeros_like(steps),
               torch.full_like(steps, DEPTH_LIMIT), torch.ones_like(steps))
    planes = tuple(torch.empty_like(p) for p in (c, steps, steps))
    listed = (torch.tensor([i], dtype=torch.int32, device=device),
              torch.ones(1, dtype=torch.int32, device=device))
    lone = {}
    for cap in (1, cfg.step_limit):
        lone[cap] = graph_ms(lambda: rk._trace_cuda(desc_c, o, d, c, carried, planes, cap=cap,
                                                    rays=listed))
        check(int(planes[1].reshape(-1)[i].item()) == min(cap, n), f"lone ray, budget {cap}")
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, check=True, timeout=60).stdout.split()[0]
    out["step_us"] = (lone[cfg.step_limit] - lone[1]) * 1e3 / (n - 1)
    out["lone_ray_steps"] = n
    print(f"march probe on {card}: the longest 1920x1080 ray ({n} steps) alone, K2 at budget 1 "
          f"{lone[1]:.4f} ms, at {cfg.step_limit} {lone[cfg.step_limit]:.4f} ms: "
          f"{out['step_us']:.4f} us a step ({out['step_us'] * float(clock):.0f} cycles at the "
          f"maximum SM clock, {clock} MHz)")

    # K5 at the 64x64 fit point: its longest ray alone through K4 and K5
    scene = reference_render_scene(device=device)
    bb = inflated(scene_bounds(scene), 0.6)
    true = shape_params(scene)
    params = cli._apply_perturb(true, FIT_PERTURB)
    o, d, c = rays(64, 64, device)
    target = render_image_diff(scene.sdf, true, o, d, c, csdf=scene.csdf, bb=bb).detach()
    scene_c, _ = dk.param_scene_c(scene.csdf, params, bb=bb)
    _, steps, _, _ = dk._march_cuda(scene_c, o, d, c, False)
    j = int(torch.argmax(steps).item())
    band = dk._band(cfg, None)

    def one(x, k):
        return x.reshape(-1, *x.shape[2:])[k].reshape(1, 1, *x.shape[2:]).contiguous()

    def k5(o, d, c, target):
        state = dk._target_state(target, None).contiguous()
        return graph_ms(lambda: dk._loss_grad_cuda(scene_c, o, d, c, target, state, c.numel(),
                                                   1.0, band))

    ray = [one(x, j) for x in (o, d, c, target)]
    k4_alone = graph_ms(lambda: dk._march_cuda(scene_c, *ray[:3], False))
    out["k5_64"] = {"longest_steps": int(steps.reshape(-1)[j].item()), "k4_lone_ms": k4_alone,
                    "k5_lone_ms": k5(*ray), "k5_frame_ms": k5(o, d, c, target)}
    print(f"march probe on {card}: K5 at the 64x64 fit point {json.dumps(out['k5_64'])}")
    k5 = [r for r in resources if r["kernel"].startswith(REFERENCE_K5)]
    check(bool(k5) and all(r["spill_stores"] == r["spill_loads"] == 0 and r["registers"] <= 128
                           for r in k5), f"a reference K5 kernel spills or takes over 128 "
                                         f"registers: {k5}")
    return out


#: K5's launches for the reference scenes' form (csrc/param_forms.cuh
#: ReferenceForm); the other forms' tangent launch, loss_tangent_form_kernel,
#: is held to no register count
REFERENCE_K5 = ("loss_march_kernel<ReferenceForm", "loss_tangent_kernel<", "loss_grad_sum")
#: the reference scenes' structures (csrc/scene_sdf.cuh Box<Frame, Transform>)
#: in K1, K2, K3, K6 and K7, and their parameter form in K4 and K5, none of
#: which may spill; K1's fresh march on the render scene holds K1_REGISTERS,
#: K4 and K5's march launch at most REFERENCE_MARCH_REGISTERS
REFERENCE_KERNELS = (("render_kernel.cu", ("render_kernel<Box<", "trace_kernel<Box<",
                                           "shade_kernel<Box<")),
                     ("mc_kernel.cu", ("mc_kernel<Box<",)),
                     ("project_kernel.cu", ("project_kernel<Box<",)),
                     ("diff_kernel.cu", ("march_params_kernel<ReferenceForm",) + REFERENCE_K5))
K1_REGISTERS = 32
REFERENCE_MARCH_REGISTERS = 53


def reference_resources(card: str) -> list[dict]:
    """ptxas's registers and spills of every reference instantiation of K1,
    K2, K3, K4, K5, K6 and K7 (REFERENCE_KERNELS): fails where one spills,
    where K1_DEFAULT takes other than K1_REGISTERS registers, or where a
    reference march of K4 or K5 takes more than REFERENCE_MARCH_REGISTERS."""
    rows = {prefix: kernel_resources(source, (prefix,))
            for source, prefixes in REFERENCE_KERNELS for prefix in prefixes}
    spilled = [r for found in rows.values() for r in found if r["spill_stores"] or r["spill_loads"]]
    k1 = [r for r in rows["render_kernel<Box<"] if r["kernel"] == K1_DEFAULT]
    print(f"reference instantiations on {card}: "
          f"{json.dumps({p: len(found) for p, found in rows.items()})} kernels, spilling "
          f"{json.dumps(spilled)}; {K1_DEFAULT}: {k1}")
    check(all(rows.values()) and not spilled, f"a reference instantiation spills: {spilled}")
    check(len(k1) == 1 and k1[0]["registers"] == K1_REGISTERS,
          f"{K1_DEFAULT} takes other than {K1_REGISTERS} registers: {k1}")
    marches = rows["march_params_kernel<ReferenceForm"] + rows["loss_march_kernel<ReferenceForm"]
    check(all(r["registers"] <= REFERENCE_MARCH_REGISTERS for r in marches),
          f"a reference march of K4 or K5 takes over {REFERENCE_MARCH_REGISTERS} registers: "
          f"{marches}")
    return [r for found in rows.values() for r in found]


#: the kernels that run the fd4 stencil, at their main paths' scene structures
STENCIL_KERNELS = (("render_kernel.cu", K1_DEFAULT), ("render_kernel.cu", "shade_kernel<Box<true, false>>"),
                   ("mc_kernel.cu", "mc_kernel<Box<false, false>>"),
                   ("project_kernel.cu", "project_kernel<Box<false, false>>"))


def stencil_probe(card: str) -> dict:
    """ptxas's registers, stack and spills of K1, K3, K6 and K7 at their
    main paths' structures, and each one's SASS: its static instructions,
    MUFU (the square roots' and divisions' first steps) and CALL (their
    slow paths) in all and in each loop (:func:`loops_of`)."""
    from bsdmg_tpu_torch.ops.cuda import build

    functions = sass_functions(build.build())
    out = {}
    for source, name in STENCIL_KERNELS:
        found = [r for r in kernel_resources(source, (name,)) if r["kernel"] == name]
        check(len(found) == 1 and name in functions, f"{name} not in the build of {source}")
        code = functions[name]
        out[name] = {**{k: found[0][k] for k in ("registers", "stack", "spill_stores")},
                     "instructions": len(code), "mufu": sum("MUFU" in x for _, x in code),
                     "call": sum("CALL" in x for _, x in code),
                     "loops": [{k: loop[k] for k in ("instructions", "mufu", "call")}
                               for loop in loops_of(code)]}
    print(f"stencil kernels on {card} (ptxas; SASS static instructions, MUFU, CALL, and per "
          f"loop): {json.dumps(out)}")
    return out


def step_histogram(steps: torch.Tensor, limit: int) -> dict:
    """Summary of a march's steps per ray: the largest, the mean, the rays
    at the step limit, the warp-steps in 8x4 patches (K1's and K4's warps)
    and the histogram in bins of 8 steps."""
    from bsdmg_tpu_torch.bench import WARP, _block_max

    s = steps.long()
    return {"max": int(s.max()), "mean": s.float().mean().item(),
            "at_limit": int((s >= limit).sum()),
            "warp_steps": int(_block_max(s.cpu().numpy(), WARP).sum()),
            "bins_of_8": torch.bincount(s.reshape(-1) // 8, minlength=limit // 8 + 1).tolist()}


def march_params_probe(card: str, device) -> dict:
    """K4's march step: ptxas's registers, stack and spills and the SASS
    loops of K4 (march_params_kernel) and of K5's march launch
    (loss_march_kernel); the steps of the fit's target render (K4 with the
    9 shape values and the trust region) at 64x64, 512x512 and 1920x1080,
    beside K1's steps on the same 1920x1080 rays; and the latency of one
    step of the 64x64 point's longest ray marched alone (K4 on a 1x1 image
    in a CUDA graph, with the step limit at 1 and at its default; the
    difference over the steps between), and K4 over the 1920x1080 frame
    with the step limit at 1 (its work besides the march)."""
    from bsdmg_tpu_torch.config import MarchConfig
    from bsdmg_tpu_torch.models import reference_render_scene
    from bsdmg_tpu_torch.ops.cuda import build
    from bsdmg_tpu_torch.ops.cuda import diff_kernel as dk
    from bsdmg_tpu_torch.ops.cuda import render_kernel as rk
    from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene, scene_bounds

    out: dict = {}
    for r in kernel_resources("diff_kernel.cu", ("march_params", "loss_march")):
        print(f"  ptxas: {r['kernel']}: {r['registers']} registers, {r['stack']} B stack, "
              f"{r['spill_stores']} B spill stores, {r['spill_loads']} B spill loads")
    for kernel, loops in sass_kernel_loops(build.build(), ("march_params_kernel<ReferenceForm",
                                                           "loss_march_kernel<ReferenceForm")).items():
        print(f"  SASS loops of {kernel}: {json.dumps(loops)}")
    cfg = MarchConfig()
    scene = reference_render_scene(device=device)
    scene_c, _ = dk.param_scene_c(scene.csdf, shape_params(scene),
                                  bb=inflated(scene_bounds(scene), 0.6))
    one = type(scene_c).from_buffer_copy(scene_c)  # the march stops after one step
    one.step_limit = 1
    for w, h in ((64, 64), (512, 512), (1920, 1080)):
        o, d, c = rays(w, h, device)
        steps = dk._march_cuda(scene_c, o, d, c, False)[1]
        out[f"K4 steps {w}x{h}"] = step_histogram(steps, cfg.step_limit)
        if w == 1920:
            k1 = rk.trace_cuda(compile_scene(scene), o, d, c)[1]
            out[f"K1 steps {w}x{h}"] = step_histogram(k1, cfg.step_limit)
            # what is not the march: the cull, one step, dfdt and the planes
            out["K4 1920x1080 ms at step limit 1"] = graph_ms(
                lambda: dk._march_cuda(one, o, d, c, False))
        if w == 64:
            j = int(torch.argmax(steps).item())
            n = int(steps.reshape(-1)[j].item())
            ray = [x.reshape(-1, *x.shape[2:])[j].reshape(1, 1, *x.shape[2:]).contiguous()
                   for x in (o, d, c)]
            lone = {cap: graph_ms(lambda: dk._march_cuda(sc, *ray, False))
                    for cap, sc in ((1, one), (cfg.step_limit, scene_c))}
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, check=True, timeout=60).stdout.split()[0]
    out["k4_lone"] = {"longest_steps": n, "ms_at_1": lone[1], "ms": lone[cfg.step_limit],
                      "step_us": (lone[cfg.step_limit] - lone[1]) * 1e3 / (n - 1)}
    out["k4_lone"]["step_cycles"] = out["k4_lone"]["step_us"] * float(clock)
    print(f"K4 march probe on {card} (cycles at the maximum SM clock, {clock} MHz): "
          f"{json.dumps(out)}")
    return out


def shade_hit_stats(outcome: torch.Tensor) -> dict:
    """What sets K3's stencil work on a traced frame's outcome plane: the
    hits; the warps of K1's layout (8x4 patches of 16x8 tiles) that hold a
    hit, and of those the ones that hold a miss too (a thread a pixel runs
    the stencil there on part of the warp); and the sum over 16x8 tiles of
    ceil(hits / 32), the warps that shade when each tile's hits are listed."""
    from bsdmg_tpu_torch.bench import WARP, _block_max

    hit = (outcome == 0).cpu().numpy().astype(np.int64)
    h, w = hit.shape
    warp_hits = _block_max(hit, WARP) > 0
    warp_misses = _block_max(1 - hit, WARP) > 0
    tiles = np.pad(hit, ((0, -h % 8), (0, -w % 16))).reshape((h + 7) // 8, 8, (w + 15) // 16, 16)
    per_tile = tiles.sum(axis=(1, 3))
    return {"pixels": h * w, "hits": int(hit.sum()), "warps": int(warp_hits.size),
            "warps_with_a_hit": int(warp_hits.sum()),
            "warps_with_a_hit_and_a_miss": int((warp_hits & warp_misses).sum()),
            "tile_listed_warps": int(((per_tile + 31) // 32).sum())}


def kernel_times(card: str, device) -> dict:
    """K1, K2, K3, K4 and K5 each alone (:func:`graph_ms`, prepared structs
    and outputs): K1, K2 and K3 (on K2's planes; with its hit statistics and
    bound at 1920x1080) at 1920x1080 and 2560x1440, K1's phase A at 16 and
    48 steps and its resume over the 16x8 blocks still active after 48 at
    1920x1080 (beside the block pipeline through the wrapper, by CUDA
    events), K4 (the fit's target render) at 1920x1080, 512x512 and 64x64,
    K5 at the 512x512 bench and fit points and the 64x64 fit point."""
    from bsdmg_tpu_torch import cli
    from bsdmg_tpu_torch.config import MarchConfig
    from bsdmg_tpu_torch.grad import render_image_diff
    from bsdmg_tpu_torch.models import reference_render_scene
    from bsdmg_tpu_torch.ops.cuda import diff_kernel as dk
    from bsdmg_tpu_torch.ops.cuda import render_kernel as rk
    from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene, scene_bounds

    cfg = MarchConfig()
    scene = reference_render_scene(device=device)
    desc = compile_scene(scene)
    desc_c = rk.scene_desc_c(desc, cfg)
    times = {}
    for w, h in ((1920, 1080), (2560, 1440)):
        o, d, c = rays(w, h, device)
        rgb = torch.empty((h, w, 3), device=device)
        planes = (torch.empty_like(c), *(torch.empty_like(c, dtype=torch.int32) for _ in range(3)))
        times[f"K1 {w}x{h}"] = graph_ms(lambda: rk._render_cuda(desc_c, o, d, c, rgb, None,
                                                                cap=cfg.step_limit))
        times[f"K2 {w}x{h}"] = graph_ms(lambda: rk._trace_cuda(desc_c, o, d, c, None, planes[:3],
                                                               cap=cfg.step_limit))
        # K3 on the frame's traced planes
        traced = rk.trace_cuda(desc, o, d, c)
        times[f"K3 {w}x{h}"] = graph_ms(lambda: rk._shade_cuda(desc_c, o, d, traced[0], traced[2],
                                                               rgb))
        if w == 1920:
            stats = shade_hit_stats(traced[2])
            k3_bound = bound(shade_bytes(c.numel(), stats["hits"]),
                             shade_pass_ops(desc, stats["hits"], c.numel()))
            print(f"K3 {w}x{h} on {card}: {json.dumps(stats)}; bound {k3_bound[0]:.4f} ms "
                  f"({k3_bound[1]}, {shade_pass_ops(desc, stats['hits'], c.numel()):.4g} FP32 "
                  f"operations, {shade_bytes(c.numel(), stats['hits'])} B)")
        if w == 1920:
            for n in (16, 48):
                times[f"K1 phase A {n} {w}x{h}"] = graph_ms(
                    lambda: rk._render_cuda(desc_c, o, d, c, rgb, planes[:3], mode=rk.PHASE_A,
                                            active=planes[3], cap=n))
            # the resume from phase A's state, which a copy (timed alone and
            # taken off) restores before each launch
            blocks = rk.compact_list(rk.block_flags(planes[3]))
            state = [x.clone() for x in (rgb, *planes)]
            work = [torch.empty_like(x) for x in state]

            def restore():
                for dst, src in zip(work, state):
                    dst.copy_(src)

            def resume():
                restore()
                rk._render_cuda(desc_c, o, d, c, work[0], work[1:4], mode=rk.RESUME,
                                active=work[4], blocks=blocks, cap=cfg.step_limit)

            times["K1 resume 48 blocks"] = int(blocks[1].item())
            times[f"K1 resume 48 {w}x{h}"] = graph_ms(resume) - graph_ms(restore)
            times[f"block pipeline 48 {w}x{h}"] = median_ms(
                lambda: rk.render_image_cuda(desc, o, d, c, two_phase="block", phase_a_steps=48),
                reps=20)
    bb6, bb25 = inflated(scene_bounds(scene), 0.6), inflated(scene_bounds(scene), 0.25)
    true = shape_params(scene)
    perturbed = cli._apply_perturb(true, FIT_PERTURB)
    band = dk._band(cfg, None)
    scene_c, _ = dk.param_scene_c(scene.csdf, true, bb=bb6)
    o, d, c = rays(1920, 1080, device)
    times["K4 1920x1080"] = graph_ms(lambda: dk._march_cuda(scene_c, o, d, c, False))
    for side in (512, 64):
        o, d, c = rays(side, side, device)
        times[f"K4 {side}x{side}"] = graph_ms(lambda: dk._march_cuda(scene_c, o, d, c, False))
        if side == 512:
            zero = torch.zeros((side, side, 3), device=device)
            bench_c, _ = dk.param_scene_c(scene.csdf, true, bb=bb25)
            times["K5 512x512 bench"] = graph_ms(
                lambda: dk._loss_grad_cuda(bench_c, o, d, c, zero, None, c.numel(), 0.0, band))
        target = render_image_diff(scene.sdf, true, o, d, c, csdf=scene.csdf, bb=bb6).detach()
        state = dk._target_state(target, None).contiguous()
        fit_c, _ = dk.param_scene_c(scene.csdf, perturbed, bb=bb6)
        times[f"K5 {side}x{side} fit"] = graph_ms(
            lambda: dk._loss_grad_cuda(fit_c, o, d, c, target, state, c.numel(), 1.0, band))
    print(f"kernels alone on {card} (ms, CUDA graphs): {json.dumps(times)}")
    return times


# ---------------------------------------------------------------------------
# the mesh and grid kernels alone: K6, K7, K8, K9 and P1, with the Newton
# and march step statistics that set their divergence, and ptxas and SASS
# ---------------------------------------------------------------------------


def mesh_fields(desc, cfg, device, top: int):
    """The reference object's voxel fields from the initial one to ``top``."""
    from bsdmg_tpu_torch.mesh.field import create_voxel_field, refine_field

    fields = {0: create_voxel_field(cfg, device)}
    for level in range(1, top + 1):
        fields[level] = refine_field(desc, fields[level - 1])
    return fields


def torus_grid(device, resolution: int = 128):
    """tools/make_torus.py's torus OBJ baked as `cli render --scene mesh:`
    bakes it (``resolution``^3)."""
    from bsdmg_tpu_torch.mesh.export import load_obj
    from bsdmg_tpu_torch.models.mesh_sdf import bake_mesh_grid

    with tempfile.TemporaryDirectory() as tmp:
        obj = Path(tmp) / "torus.obj"
        subprocess.run([sys.executable, str(ROOT / "tools" / "make_torus.py"), str(obj)],
                       capture_output=True, text=True, check=True, timeout=300)
        src = load_obj(obj)
    return bake_mesh_grid(src.vertices, src.faces, resolution=resolution, device=device)


def warp_max_stats(steps: torch.Tensor, groups: torch.Tensor) -> dict:
    """Steps of work items and the warp each runs in (``groups``, any
    labels): the mean, the mean over warps of their maximum, and the SIMT
    efficiency, the steps taken over 32 lanes times the warps' maxima."""
    steps = steps.long()
    _, g = torch.unique(groups, return_inverse=True)
    top = torch.zeros(int(g.max()) + 1 if g.numel() else 0, dtype=torch.long,
                      device=steps.device).scatter_reduce(0, g, steps, "amax")
    return {"mean": steps.float().mean().item(), "mean_warp_max": top.float().mean().item(),
            "simt_efficiency": steps.sum().item() / max(32 * top.sum().item(), 1)}


def newton_step_stats(desc, fns, args, kwargs) -> dict:
    """K6's Newton steps per projected edge from its plain version on the
    card: their sum, the valid triangles, the histogram, and the mean warp
    maximum in two orders. The voxel
    order runs 32 voxels a warp, each edge of the 12 in turn over the lanes
    whose voxel projects it; the edge order runs 32 consecutive projected
    edges a warp, in lists of the edges of 32 voxels (rank order)."""
    from bsdmg_tpu_torch.ops.cuda import mc_kernel

    stats: dict = {}
    meta = mc_kernel.mc_fused_torch(fns, *args, stats=stats, **kwargs)[4]
    steps = stats["newton_point_steps"]  # the twin's edges: voxel by voxel, in rank order
    vox, edge, _, slot = mc_kernel.edge_slots(args[3], kwargs["budget"])
    block = vox // mc_kernel.BLOCK_VOXELS
    listed = torch.bincount(vox, minlength=args[3].numel())

    def rounds(voxels: int, threads: int) -> dict:
        """Blocks of ``voxels`` voxels and ``threads`` threads: the share
        of blocks whose list takes a thread more than one edge, and the
        share of the threads' turns that project an edge."""
        per = torch.nn.functional.pad(listed, (0, -listed.numel() % voxels)).reshape(-1, voxels)
        turns = (per.sum(dim=1) + threads - 1) // threads
        return {"over_one_round": (turns > 1).float().mean().item(),
                "busy": per.sum().item() / (threads * turns).sum().item()}

    return {
        "edges": vox.numel(),
        "newton_steps": stats["newton_steps"],
        "valid_triangles": int(((meta[:, None] >> torch.arange(5, device=meta.device)) & 1).sum()),
        "blocks": {f"{v}/{t}": rounds(v, t) for v, t in ((32, 128), (28, 128), (60, 256))},
        "histogram": torch.bincount(steps.long(), minlength=kwargs["iters"] + 1).tolist(),
        "voxel_order": warp_max_stats(steps, (vox // 32) * 12 + edge),
        "edge_order": warp_max_stats(steps, block * 12 + slot // 32),
    }


def k7_inputs(desc, field, cfg):
    """K7's inputs at a field: ``(pipeline, padded, kwargs)``, the listed
    crossing edges that the staged path hands K7 (``kernel_inputs``, every
    point active) and the JAX kernel's padded lanes (an ``active`` mask)."""
    from bsdmg_tpu_torch.ops import marching_cubes as mc

    cfg = dataclasses.replace(cfg, interpolate_edges=True)
    args, kwargs = mc.kernel_inputs(desc, field.lowers, field.voxel_size, cfg)
    padded = mc.padded_inputs(desc, field.lowers, field.voxel_size, cfg)[0]
    return args, padded, kwargs


def projection_step_stats(fns, padded, kwargs) -> dict:
    """K7's Newton steps per point (inactive points take none) from its
    plain version on the card over the padded lanes, 32 consecutive points
    a warp in two orders: the padded lanes, and the listed crossing edges
    (the active points in voxel order)."""
    from bsdmg_tpu_torch.ops.cuda import mesh_kernel

    stats: dict = {}
    mesh_kernel.project_edges_torch(fns, *padded[:3], padded[3].bool(), stats=stats, **kwargs)
    steps = stats["newton_point_steps"]
    active = padded[3] > 0
    lanes = torch.arange(steps.numel(), device=steps.device)
    listed = torch.arange(int(active.sum()), device=steps.device)
    return {"points": steps.numel(), "active": int(active.sum()),
            "newton_steps": stats["newton_steps"],
            "histogram": torch.bincount(steps.long()[active]).tolist(),
            "active_mean": steps[active].float().mean().item(),
            "padded_order": warp_max_stats(steps, lanes // 32),
            "listed_order": warp_max_stats(steps[active], listed // 32)}


def warp_steps(steps: torch.Tensor, warps: torch.Tensor) -> int:
    """The sum over warps of the warp's largest step count: what a launch
    that runs each warp until its slowest ray ends pays in warp-steps."""
    top = torch.zeros(int(warps.max()) + 1, dtype=torch.long, device=steps.device)
    return int(top.scatter_reduce(0, warps, steps.long(), "amax").sum())


def march_step_stats(out, state: dict, shape) -> dict:
    """The steps one grid march launch takes per ray (0 for a ray it does
    not march): the mean over the marched rays; the mean warp maximum with
    32 consecutive rays of a row a warp and with 8x4 patches of 16x8 tiles
    a warp (K1's and K2's order); and the warp-steps (:func:`warp_steps`)
    in those two orders and with each 16x8 tile's marched rays listed in
    thread order and taken 32 a warp (K8's order since its redesign),
    beside the marched steps over 32 (every warp full)."""
    from bsdmg_tpu_torch.bench import WARP, _block_max

    taken = out[1].reshape(-1).long()
    marched = torch.ones_like(taken, dtype=torch.bool)
    if state:
        marched = state["active"].reshape(-1) > 0
        taken = torch.where(marched, taken - state["steps0"].reshape(-1).long(), 0)
    plane = taken.reshape(shape).cpu().numpy()
    h, w = shape
    flat = torch.arange(h * w, device=taken.device)
    py, px = flat // w, flat % w
    tile = (py // 8) * ((w + 15) // 16) + px // 16
    slot = (((py % 8) // 4) * 2 + (px % 16) // 8) * 32 + (py % 4) * 8 + px % 8
    order = torch.argsort(tile * 128 + slot)  # launch order
    listed = order[marched[order]]  # each tile's marched rays in thread order
    listed_tile = tile[listed]
    per_tile = torch.bincount(listed_tile, minlength=int(tile.max()) + 1)
    rank = torch.arange(listed.numel(), device=listed.device) \
        - (torch.cumsum(per_tile, 0) - per_tile)[listed_tile]
    listed_steps = taken[listed]
    return {"marched": int(marched.sum()), "mean": taken[marched].float().mean().item(),
            "row_warp_max": float(_block_max(plane.reshape(1, -1), (1, 32)).mean()),
            "tile_warp_max": float(_block_max(plane, WARP).mean()),
            "warp_steps": {"row": warp_steps(taken, flat // 32),
                           "tile": warp_steps(taken, tile * 4 + slot // 32),
                           "tile_compacted": warp_steps(listed_steps, listed_tile * 4 + rank // 32),
                           "full_warps": int(taken.sum()) / 32}}


def mesh_grid_kernel_times(card: str, device, times: dict) -> dict:
    """K6 at levels 3 and 5 and K7 at level 3 of the reference object, and
    K9's two levels, K8's finish and P1's normals on the 1920x1080 torus
    frame, each alone (:func:`graph_ms`, prepared structs and outputs),
    with the wrappers' times beside (CUDA events); the step statistics of
    each; ptxas's registers
    and spills; the SASS loops of K9. Adds the times to ``times``; returns
    the step statistics."""
    from bsdmg_tpu_torch.cam import generate_rays, look_at
    from bsdmg_tpu_torch.config import MarchConfig, MeshGenConfig
    from bsdmg_tpu_torch.models import reference_object
    from bsdmg_tpu_torch.models.mesh_sdf import coarsen_grid_lower
    from bsdmg_tpu_torch.ops.cuda import build
    from bsdmg_tpu_torch.ops.cuda import grid_kernel as tg
    from bsdmg_tpu_torch.ops.cuda import mc_kernel, mesh_kernel
    from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene, sdf_fns
    from bsdmg_tpu_torch.ops.marching_cubes import kernel_inputs

    cfg = MeshGenConfig()
    desc = compile_scene(reference_object(device=device))
    fns = sdf_fns(desc)
    fields = mesh_fields(desc, cfg, device, 5)
    probes: dict = {}
    bounds = {}
    for level in (3, 5):
        f = fields[level]
        args, kwargs = kernel_inputs(desc, f.lowers, f.voxel_size, cfg)
        times[f"K6 level {level}"] = k6_alone_ms(desc, args, kwargs)
        times[f"K6 level {level} wrapper"] = median_ms(
            lambda: mc_kernel.mc_fused_cuda(desc, *args, **kwargs), reps=5)
        probes[f"K6 level {level}"] = probe = newton_step_stats(desc, fns, args, kwargs)
        ops = mesh_ops(desc, kwargs["use_grad"], probe["newton_steps"], probe["edges"],
                       probe["edges"], probe["valid_triangles"])
        bounds[f"K6 level {level}"] = (*bound(f.count * MC_VOXEL_BYTES, ops), ops)
    f = fields[3]
    pipeline, padded, kwargs = k7_inputs(desc, f, cfg)
    for name, args in (("", pipeline), (" padded", padded)):
        times[f"K7 level 3{name}"] = k7_alone_ms(desc, args, kwargs)
    times["K7 level 3 wrapper"] = median_ms(
        lambda: mesh_kernel.project_edges_cuda(desc, *pipeline, **kwargs), reps=5)
    probes["K7 level 3"] = probe = projection_step_stats(fns, padded, kwargs)
    for name, args in (("", pipeline), (" padded", padded)):
        m = args[0].numel()
        ops = mesh_ops(desc, kwargs["use_grad"], probe["newton_steps"], m)
        bounds[f"K7 level 3{name}"] = (*bound(m * (16 + 24), ops), ops)
    del fields

    grid, march = torus_grid(device), MarchConfig()
    size = (1920, 1080)
    frame = generate_rays(look_at(TORUS_CAMERA, device=device), size, SCREEN)
    _, launches, stencil, _ = staged_contraction(grid, frame, march)
    # the gather route's first launch: K8 fresh over the 64^3 mip
    mip = tg.interp_sampler(coarsen_grid_lower(grid, tg.MID_RESOLUTION))
    fresh = tg.grid_march_cuda(mip, *frame, march, budget=march.step_limit)
    for name, sampler, state, out in [*launches, ("K8 64^3 mip fresh", mip, {}, fresh)]:
        times[f"{name} torus"] = march_kernel_ms(sampler, frame, march, state)
        probes[f"{name} torus"] = march_step_stats(out, state, (size[1], size[0]))
    times["P1 torus normals"] = sample_kernel_ms(tg.interp_sampler(grid), stencil)
    print(f"mesh and grid kernels alone on {card} (ms, CUDA graphs; wrappers by CUDA events): "
          + json.dumps({k: v for k, v in times.items() if k.startswith(("K6", "K7", "K8", "K9",
                                                                          "P1"))}))
    print(f"step statistics on {card}: {json.dumps(probes)}")
    print("bounds of K6 and K7 from this tree's counts (ms, by, FP32 operations): "
          + json.dumps(bounds))
    for source, prefixes in (("mc_kernel.cu", ("mc_",)), ("project_kernel.cu", ("project_",)),
                             ("grid_kernel.cu", ("grid_", "contraction_"))):
        for r in kernel_resources(source, prefixes):
            print(f"  ptxas: {r['kernel']}: {r['registers']} registers, {r['stack']} B stack, "
                  f"{r['spill_stores']} B spill stores, {r['spill_loads']} B spill loads")
    for kernel, loops in sass_kernel_loops(build.build(), ("grid_march_kernel",
                                                           "contraction_kernel")).items():
        print(f"  SASS loops of {kernel}: {json.dumps(loops)}")
    return probes


def mesh_cli_seconds(card: str) -> list[float]:
    """``cli mesh --interpolate-edges`` at its defaults (level 3) twice in
    this process (:func:`run_cli_mesh`): its wall seconds (host clock,
    after a sync), the second run warm."""
    with tempfile.TemporaryDirectory() as tmp:
        runs = [run_cli_mesh("K7", ["--interpolate-edges"], Path(tmp) / "mesh.obj")[1]
                for _ in range(2)]
    print(f"cli mesh --interpolate-edges on {card}: seconds {json.dumps(runs)}")
    return runs



# ---------------------------------------------------------------------------
# the session verb, the other built-in scenes, and the libm the mandelbulb
# calls
# ---------------------------------------------------------------------------

#: the scenes beside the reference ones, each through K1 (K2 + K3 in the row
#: pipeline), K6 and K7
NEW_SCENES = ("sphere", "box", "wrapped_object", "mandelbulb")
#: the frame K1 is timed on, and the smaller one of the pipelines' parity
SCENE_FRAME = (1920, 1080)
SCENE_PARITY_FRAME = (960, 540)
#: the structure each scene's K1 runs (csrc/scene_sdf.cuh), culled but the
#: unbounded wrapped object
NEW_SCENE_K1 = {
    "sphere": "render_kernel<Sphere, true, false, 0>",
    "box": "render_kernel<SolidBox, true, false, 0>",
    "wrapped_object": "render_kernel<Wrapped<Box<false, false>>, false, false, 0>",
    "mandelbulb": "render_kernel<Mandelbulb, true, false, 0>",
}
#: the mandelbulb's bars against its twins (libm rounds differently in the
#: kernels and in torch): outcomes, depth within DEPTH_ATOL on the hits
#: both have, RGB within PIXEL_ATOL on the pixels whose outcomes agree (the
#: bars of tests/test_torch_scenes.py against the JAX package), the valid
#: triangles, and K6's vertices (on the triangles both have) and K7's
#: points with all three coordinates within POSITION_ATOL, a NaN only
#: beside a NaN (set from the card's readings, PERF.md)
BULB_OUTCOMES = 0.995
BULB_DEPTH_SHARE = 0.99
BULB_RGB_SHARE = 0.99
BULB_TRIANGLES = 0.01
BULB_K6_POSITIONS = 0.94
BULB_K7_POSITIONS = 0.95
#: a full cli session: create, three refines, extract, save; an extraction
#: (K6) after each of the first five steps
SESSION_KEYS = "vbbbvv"
SESSION_EXTRACTIONS = 5


def same_nan(a, b) -> bool:
    """Bit-equal tensors but NaN, which must sit at the same places."""
    if a.dtype.is_floating_point:
        return bool(torch.equal(a.isnan(), b.isnan())
                    and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))
    return bool(torch.equal(a, b))


def bulb_fractions(kernel, plain) -> dict:
    """The mandelbulb's render bars: the share of pixels whose outcomes
    agree, of the hits both have whose depths agree within DEPTH_ATOL, and
    of the pixels whose outcomes agree whose RGB agrees within PIXEL_ATOL."""
    same_outcome = kernel[3] == plain[3]
    both = same_outcome & (kernel[3] == 0)
    close = (kernel[1] - plain[1]).abs()[both] <= DEPTH_ATOL
    rgb = (kernel[0] - plain[0]).abs().amax(-1)[same_outcome] < PIXEL_ATOL
    out = {"outcome_agreement": same_outcome.float().mean().item(),
           "common_hits": int(both.sum()),
           "depth_share": close.float().mean().item() if close.numel() else 1.0,
           "rgb_share": rgb.float().mean().item(),
           "bit_equal_pixels": (kernel[0] == plain[0]).all(-1).float().mean().item()}
    check(out["outcome_agreement"] >= BULB_OUTCOMES and out["depth_share"] >= BULB_DEPTH_SHARE
          and out["rgb_share"] >= BULB_RGB_SHARE and out["common_hits"] > 0,
          f"mandelbulb bars {out}")
    return out


def bulb_positions(k6, t6, k7, t7, active7) -> dict:
    """The mandelbulb's mesh bars: the valid triangles of K6 and its twin,
    the share of the vertices of the triangles both have, and of K7's
    active points, whose three coordinates agree within POSITION_ATOL (a
    NaN agrees only with a NaN: the twin's Newton steps end at NaN on some
    points, as the JAX package's)."""
    def bits(meta):
        return ((meta[:, None] >> torch.arange(5, device=meta.device)) & 1).bool()

    valid = [int(bits(m[4]).sum()) for m in (k6, t6)]
    both = bits(k6[4]) & bits(t6[4])
    def close(a, b):
        return ((a - b).abs() <= POSITION_ATOL) | (a.isnan() & b.isnan())

    # (voxels, triangles, vertices, xyz)
    close6 = close(k6[0], t6[0]).reshape(-1, 5, 3, 3).all(-1)[both]
    close7 = torch.stack([close(a, b) for a, b in zip(k7[:3], t7[:3])], -1).all(-1)[active7]
    out = {"valid_triangles": valid, "K6 vertices within 2e-5": close6.float().mean().item(),
           "K7 points within 2e-5": close7.float().mean().item(),
           "K6 vertices": close6.numel(), "K7 points": close7.numel(),
           "K6 NaN vertices": int(t6[0].reshape(-1, 5, 3, 3).isnan().any(-1)[both].sum()),
           "K7 NaN points": int(t7[0][active7].isnan().sum())}
    check(abs(valid[0] - valid[1]) <= BULB_TRIANGLES * valid[1]
          and out["K6 vertices within 2e-5"] >= BULB_K6_POSITIONS
          and out["K7 points within 2e-5"] >= BULB_K7_POSITIONS
          and close6.numel() > 0 and close7.numel() > 0, f"mandelbulb mesh bars {out}")
    return out


LIBM_PROBE_SOURCE = r"""
#define PROBE(name, expr) extern "C" __global__ void probe_##name( \
    const float* a, const float* b, float* o, float* o2, int n) { \
  const int i = blockIdx.x * blockDim.x + threadIdx.x; \
  if (i < n) { expr; } }
PROBE(acosf, o[i] = acosf(a[i]))
PROBE(atan2f, o[i] = atan2f(a[i], b[i]))
PROBE(powf7, o[i] = powf(a[i], 7.0f))
PROBE(powf6, o[i] = powf(a[i], 6.0f))
PROBE(logf, o[i] = logf(a[i]))
PROBE(fmodf, o[i] = fmodf(a[i], b[i]))
PROBE(sincosf, sincosf(a[i], &o[i], &o2[i]))
"""
#: the most arguments the probe takes of each function (a strided subset)
LIBM_ARGUMENTS = 1 << 22


def _cu(lib, name: str, *args) -> None:
    err = getattr(lib, name)(*args)
    check(err == 0, f"{name} returned CUresult {err}")


def counted_launch(ptx: str, blocks: int, kernel: str, tensors, n: int) -> np.ndarray:
    """Launch ``kernel`` of the instrumented ``ptx`` (utils/profiling.py
    instrument_ptx, ``blocks`` counters) over ``n`` threads through the
    driver API (the module JIT-compiled by the driver, in torch's context)
    and return each block's execution count."""
    import ctypes

    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuLaunchKernel.argtypes = [ctypes.c_void_p, *[ctypes.c_uint] * 7, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
    torch.cuda.synchronize()
    module, fn = ctypes.c_void_p(), ctypes.c_void_p()
    ptr, size = ctypes.c_uint64(), ctypes.c_size_t()
    _cu(lib, "cuModuleLoadData", ctypes.byref(module), ctypes.c_char_p(ptx.encode()))
    try:
        _cu(lib, "cuModuleGetFunction", ctypes.byref(fn), module, kernel.encode())
        _cu(lib, "cuModuleGetGlobal_v2", ctypes.byref(ptr), ctypes.byref(size), module,
            b"block_count")
        _cu(lib, "cuMemsetD8_v2", ptr, ctypes.c_ubyte(0), size)
        values = [ctypes.c_uint64(t.data_ptr()) for t in tensors] + [ctypes.c_int(n)]
        params = (ctypes.c_void_p * len(values))(*[ctypes.addressof(v) for v in values])
        _cu(lib, "cuLaunchKernel", fn, (n + 255) // 256, 1, 1, 256, 1, 1, 0, None, params, None)
        _cu(lib, "cuCtxSynchronize")
        counts = np.zeros(blocks, np.uint64)
        _cu(lib, "cuMemcpyDtoH_v2", counts.ctypes.data_as(ctypes.c_void_p), ptr, size)
    finally:
        lib.cuModuleUnload(module)
    return counts


def libm_probe(card: str, arguments: dict) -> dict:
    """FP32 operations of one call of each libm function the mandelbulb and
    the wrap call, on the path each call takes: a kernel that makes the
    call once a thread, in the PTX nvcc makes of it with the library's
    flags, a counter at the head of each basic block
    (profiling.instrument_ptx), run on ``arguments`` (what the twins give
    these calls in the 1080p frames, profiling.mandelbulb_loops and
    wrap_arguments); the executed operations (profiling.ptx_fp32_ops)
    over the calls. They must be profiling.LIBM, the counts the bounds
    take."""
    from bsdmg_tpu_torch.ops.cuda import build
    from bsdmg_tpu_torch.utils import profiling

    with tempfile.TemporaryDirectory() as tmp:
        src, ptx = Path(tmp) / "libm_probe.cu", Path(tmp) / "libm_probe.ptx"
        src.write_text(LIBM_PROBE_SOURCE)
        subprocess.run([build.nvcc_path(), "-ptx", "-arch=sm_90a", *build.NUMERIC_FLAGS, "-O3",
                        "-o", str(ptx), str(src)], capture_output=True, text=True, check=True,
                       timeout=300)
        text, ops = profiling.instrument_ptx(ptx.read_text())
    ops = np.asarray(ops, np.float64)
    counts, calls = {}, {}
    for name in profiling.LIBM:
        args = torch.cat([a.reshape(len(a), -1) for a in arguments[name]]).float()
        args = args[::max(1, -(-len(args) // LIBM_ARGUMENTS))]
        n = len(args)
        a = args[:, 0].contiguous()
        b = (args[:, 1] if args.shape[1] > 1 else a).contiguous()
        outs = [torch.empty_like(a), torch.empty_like(a)]
        executed = counted_launch(text, len(ops), f"probe_{name}", (a, b, *outs), n)
        counts[name] = round(float(executed.astype(np.float64) @ ops) / n, 2)
        calls[name] = n
    print(f"libm on {card} (FP32 operations per call on the path taken, PTX -O3 -fmad=false "
          f"sm_90a, the twins' arguments at 1920x1080): {json.dumps(counts)} over calls "
          f"{json.dumps(calls)}; utils/profiling.py LIBM {json.dumps(profiling.LIBM)}")
    check(counts == profiling.LIBM, f"libm counts {counts} are not profiling.LIBM {profiling.LIBM}")
    return counts


def session_phase(card: str) -> dict:
    """``cli session --scene reference_object --keys vbbbvv``: its stage
    log, K6 launched once per extraction (the previews and the mesh), and
    the OBJ's counts those of ``cli mesh`` at level 3. (The default scene,
    the render scene, is meshed with its wireframe, as in the JAX CLI.)"""
    with tempfile.TemporaryDirectory() as tmp:
        obj = Path(tmp) / "session.obj"
        counts, messages, seconds = run_cli(["session", "--scene", "reference_object", "--keys",
                                             SESSION_KEYS, "-o", str(obj)])
        v, vn, f, finite = read_obj_counts(obj)
        header = obj.read_text().split("\n", 1)[0]
    log = [m for m in messages if m.startswith(("session step", "created", "refined",
                                                "extracted", "saved", "final"))]
    print(f"session path on {card}: cli session --keys {SESSION_KEYS} in {seconds:.2f} s, "
          f"launches {counts}; log {json.dumps(log)}")
    voxels = [int(m.split(": ")[1].split()[0]) for m in log if m.startswith(("created", "refined"))]
    check(counts["K6"] == SESSION_EXTRACTIONS, f"cli session launched K6 {counts['K6']} times")
    check(voxels == MESH_LEVEL_VOXELS, f"session voxels {voxels}")
    check(f == MESH_TRIANGLES and v == MESH_VERTICES and vn == v and finite,
          f"session OBJ: {f} triangles, {v} vertices")
    check(header == "# bsdmg_tpu generated mesh (native writer)", f"session OBJ header {header}")
    return {"launches": counts["K6"], "seconds": seconds}


#: the composed scenes (models/compose.py) of scene_phases: the three
#: examples, and two unbounded specs, so K1 runs its uncull'd Composed
#: instantiation: a root union with a plane, and a wrap root over every
#: other primitive and operator, a rotation and a reference_compat false
#: skeleton (tests/test_torch_compose.py GROUND and LATTICE)
COMPOSED_EXAMPLES = ("gadget", "mushroom", "snowman")
GROUND_SPEC = {"name": "ground", "root": {"op": "union", "children": [
    {"prim": "plane", "normal": [0.0, 1.0, 0.1], "offset": -1.0},
    {"op": "subtract", "children": [
        {"op": "intersect", "children": [
            {"prim": "box", "center": [0.0, 0.0, 0.0], "size": [1.6, 1.6, 1.6]},
            {"prim": "sphere", "radius": 1.0}]},
        {"prim": "capsule", "start": [-1.2, 0.0, 0.0], "end": [1.2, 0.0, 0.0], "radius": 0.35},
        {"prim": "cylinder", "radius": 0.4, "height": 3.0}]},
    {"op": "shell", "thickness": 0.03,
     "child": {"prim": "torus", "center": [0.0, 0.9, 0.0], "major_radius": 0.5,
               "minor_radius": 0.1}}]}}
LATTICE_SPEC = {"name": "lattice", "root": {"op": "wrap", "cell": [3.0, 2.5, 3.0], "child": {
    "op": "smooth_union", "k": 0.3, "children": [
        {"prim": "torus", "center": [0.0, 0.0, 0.0], "major_radius": 0.7, "minor_radius": 0.18},
        {"op": "transform", "offset": [0.0, 0.2, 0.0], "rotation": [0.8660254, 0.5, 0.0, 0.0],
         "child": {"prim": "cylinder", "radius": 0.2, "height": 1.2}},
        {"prim": "box_skeleton", "size": [1.6, 1.2, 1.0], "line_width": 0.04,
         "reference_compat": False}]}}}
#: specs beyond the small tier of the interpreters' caps, which the kernels
#: run in their large tier (ComposedLarge, ProgramLargeForm): a union of 40
#: spheres (79 instructions, 160 parameter values) and ten nested
#: transforms (10 frames); tests/test_torch_mesh.py holds the same specs
#: against the JAX package
DEEP_SPEC = {"name": "deep", "root": {"op": "union", "children": [
    {"prim": "sphere", "center": [-1.6 + 0.8 * (i % 5), -1.4 + 0.4 * (i // 5),
                                  0.3 * ((i * 7) % 3) - 0.3],
     "radius": 0.22 + 0.01 * (i % 4)} for i in range(40)]}}
NESTED_SPEC = {"op": "union", "children": [
    {"prim": "torus", "major_radius": 0.8, "minor_radius": 0.3},
    {"prim": "capsule", "start": [-0.6, 0.0, 0.0], "end": [0.6, 0.7, 0.0], "radius": 0.3},
    {"prim": "sphere", "center": [0.7, 0.5, 0.0], "radius": 0.45}]}
for _ in range(10):
    NESTED_SPEC = {"op": "transform", "offset": [0.06, -0.03, 0.02],
                   "rotation": [0.9950042, 0.0, 0.0998334, 0.0], "child": NESTED_SPEC}
NESTED_SPEC = {"name": "nested", "root": NESTED_SPEC}
#: a right-nested union of 18 spheres: 18 values on the stack, beyond the
#: 16 of the small tier of both walks, so K1 takes the large tier
RIGHT_NESTED_SPEC = {"prim": "sphere", "center": [1.5, 0.0, 0.0], "radius": 0.3}
for _i in range(17):
    RIGHT_NESTED_SPEC = {"op": "union", "children": [
        {"prim": "sphere", "center": [-1.5 + 0.17 * _i, 0.4 * float(np.sin(_i)), 0.0],
         "radius": 0.25}, RIGHT_NESTED_SPEC]}
RIGHT_NESTED_SPEC = {"name": "right-nested", "root": RIGHT_NESTED_SPEC}
#: the reference render scene written as a spec: the interpreter's cost
#: against the fixed Box<true, false> structure on the same geometry
REFERENCE_SPEC = {"name": "reference_as_spec", "root": {"op": "union", "children": [
    {"op": "smooth_union", "k": 0.5, "children": [
        {"prim": "box_skeleton", "size": [3.0, 1.0, 0.5], "line_width": 0.1},
        {"prim": "sphere", "radius": 1.0}]},
    {"prim": "box_skeleton", "size": [5.0, 5.0, 5.0], "line_width": 0.05}]}}
#: K1 of a composed scene in the small tier, culled, exact, FRESH
COMPOSED_K1 = "render_kernel<Composed, true, false, 0>"
#: its march step in SASS before the forward walk (the taped walk's rows
#: read from device memory; tools/composed_probe.py, PERF.md): the step's
#: static instructions, those of the interpreter loop inside it, and that
#: loop's local loads and stores and global loads
PARENT_WALK_SASS = {"march step": 671, "interpreter loop": 643, "ldl": 6, "stl": 6, "ldg": 53}
#: cli animate's frame and frame count
ANIMATE_SIZE = (480, 270)
ANIMATE_FRAMES = 4


def scene_arguments(tmp: Path) -> dict[str, str]:
    """The ``--scene`` of each scene of :func:`scene_phases`: the other
    built-in scenes by name, the composed ones by their JSON files (the
    specs defined here written into ``tmp``; the last two run in the
    kernels' large tier)."""
    out = {name: name for name in NEW_SCENES}
    out.update({name: str(ROOT / "examples" / f"{name}.json") for name in COMPOSED_EXAMPLES})
    for spec in (GROUND_SPEC, LATTICE_SPEC, DEEP_SPEC, NESTED_SPEC):
        path = tmp / f"{spec['name']}.json"
        path.write_text(json.dumps(spec))
        out[spec["name"]] = str(path)
    return out


def scene_phases(card: str, device) -> tuple[dict, dict, list[dict]]:
    """Each other built-in scene and each composed scene
    (:func:`scene_arguments`): ``cli render --scene`` at SCENE_FRAME (K1
    once), K1 against its twin at SCENE_FRAME (the mandelbulb at
    SCENE_PARITY_FRAME, by its bars), K1 alone at SCENE_FRAME (a CUDA graph
    of 20) with its bound and ptxas's registers, stack and spills; the row
    (K2, K2, K3) and block (K1 twice) pipelines against the twins composed
    alike at SCENE_PARITY_FRAME; ``cli mesh --scene`` (K6) and
    ``--interpolate-edges`` (K7) at level 3 with their counts, and K6 and
    K7 against their twins on that field. Bit for bit, NaN at the same
    places (the gadget's and the box's boxes give their "grad" projections
    NaN, in the JAX package too), but the mandelbulb, by its bars. A
    composed scene also takes :func:`composed_kernel_times`. Returns the
    results by scene, the libm calls' arguments for :func:`libm_probe` (the
    mandelbulb's and the wrapped object's at SCENE_FRAME), and the kernels'
    entries of the Composed instantiations (the gadget's numbers)."""
    from bsdmg_tpu_torch import cli
    from bsdmg_tpu_torch.cam import generate_rays, look_at
    from bsdmg_tpu_torch.config import MarchConfig, MeshGenConfig
    from bsdmg_tpu_torch.mesh.field import create_voxel_field, refine_field
    from bsdmg_tpu_torch.ops.cuda import mc_kernel, mesh_kernel
    from bsdmg_tpu_torch.ops.cuda import render_kernel as rk
    from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene, sdf_fns
    from bsdmg_tpu_torch.ops.marching_cubes import kernel_inputs
    from bsdmg_tpu_torch.utils import profiling

    cfg, mesh_cfg = MarchConfig(), MeshGenConfig()
    registers = {r["kernel"]: r for source in ("render_kernel.cu", "render_split.cu")
                 for r in kernel_resources(source, ("render_kernel<",))}
    for source, prefix in (("mc_kernel.cu", "mc_kernel<Composed"),
                           ("project_kernel.cu", "project_kernel<Composed")):
        for r in kernel_resources(source, (prefix,)):
            print(f"  ptxas: {r['kernel']}: {r['registers']} registers, {r['stack']} B stack, "
                  f"{r['spill_stores']} B spill stores, {r['spill_loads']} B spill loads")
    out, arguments, entries = {}, {}, []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name, scene_arg in scene_arguments(tmp).items():
            bulb, composed = name == "mandelbulb", scene_arg.endswith(".json")
            camera = MANDELBULB_CAMERA if bulb else (5.0, 2.0, -5.0)
            res = {}
            counts, _, seconds = run_cli(["render", "--scene", scene_arg, "--camera",
                                          *map(str, camera), "--width", str(SCENE_FRAME[0]),
                                          "--height", str(SCENE_FRAME[1]), "-o",
                                          str(tmp / "x.png")])
            check(counts["K1"] == 1, f"cli render --scene {name} launched K1 {counts['K1']} times")
            res["cli_render_s"], launches = seconds, {"K1": counts["K1"]}
            desc = compile_scene(cli._get_scene(scene_arg, device))

            def frame(w, h):
                return generate_rays(look_at(camera, fov=np.pi / 4, device=device), (w, h),
                                     SCREEN)

            o, d, c = frame(*SCENE_FRAME)
            kernel = rk.render_image_cuda(desc, o, d, c, return_planes=True)
            if bulb:
                small = frame(*SCENE_PARITY_FRAME)
                res["K1 parity frame"] = bulb_fractions(
                    rk.render_image_cuda(desc, *small, return_planes=True),
                    rk.render_image_planes_torch(desc, *small))
            else:
                plain, plain_ms = timed_ms(lambda: rk.render_image_planes_torch(desc, o, d, c))
                check(all(same_nan(a, b) for a, b in zip(kernel, plain)),
                      f"K1 and its twin differ on {name} at {SCENE_FRAME}")
                res["K1 timed frame"] = "bit-equal"
                k1_err = (kernel[0] - plain[0]).abs().max().item()
            _, depth, steps, outcome = kernel
            evals, advances, hits = march_work(steps, outcome, depth)
            loops = {}
            if bulb:
                loops = dict(zip(("march_loop", "stencil_loop"),
                                 profiling.mandelbulb_loops(desc, o, d, c, arguments)))
                res["loops"] = {k: dataclasses.asdict(v) for k, v in loops.items()}
            elif desc.kind == "wrapped":
                arguments.update(profiling.wrap_arguments(desc, o, d, c))
            ops = render_ops(desc, evals, advances, hits, c.numel(), **loops)
            res["bound_ms"], res["bound_by"] = bound(render_bytes(c.numel()), ops)
            cull = desc.bounds is not None
            desc_c = rk.scene_desc_c(desc, cfg, device, taped=False)
            rgb = torch.empty((*c.shape, 3), device=device)
            res["K1 ms"] = graph_ms(lambda: rk._render_cuda(desc_c, o, d, c, rgb, None,
                                                            cap=cfg.step_limit, cull=cull))
            res["hits"], res["evaluations"], res["ops"] = hits, evals, ops
            # the tier of K1's forward walk, and of K6's and K7's taped one
            tiers = tuple("ComposedLarge" if rk.kernel_structure(desc, taped=taped)
                          == rk.COMPOSED_LARGE else "Composed" for taped in (False, True))
            k1 = registers[NEW_SCENE_K1[name] if name in NEW_SCENE_K1
                           else f"render_kernel<{tiers[0]}, {str(cull).lower()}, false, 0>"]
            res["registers"] = {k: k1[k] for k in ("registers", "stack", "spill_stores")}
            small = frame(*SCENE_PARITY_FRAME)
            for tp in (True, "block"):
                got = rk.render_image_cuda(desc, *small, return_planes=True, two_phase=tp)
                twin = twin_pipeline(rk, desc, *small, two_phase=tp)
                key = "row" if tp is True else "block"
                if bulb:
                    res[key] = bulb_fractions(got, twin)
                else:
                    check(all(same_nan(a, b) for a, b in zip(got, twin)),
                          f"the {key} pipeline and its twin differ on {name}")
                    res[key] = "bit-equal"
            for kname, extra in (("K6", []), ("K7", ["--interpolate-edges"])):
                obj = tmp / f"{kname}.obj"
                counts, _, seconds = run_cli(["mesh", "--scene", scene_arg, "-o", str(obj),
                                              *extra])
                check(counts[kname] >= 1, f"cli mesh --scene {name} {extra} launched no {kname}")
                v, _, f, finite = read_obj_counts(obj)
                res[f"cli mesh {kname}"] = {"triangles": f, "vertices": v, "finite": finite,
                                            "seconds": seconds, "launches": counts[kname]}
                launches[kname] = counts[kname]
            field = create_voxel_field(mesh_cfg, device)
            for _ in range(3):
                field = refine_field(desc, field)
            args, kwargs = kernel_inputs(desc, field.lowers, field.voxel_size, mesh_cfg)
            k6 = mc_kernel.mc_fused_cuda(desc, *args, **kwargs)
            t6, t6_ms = timed_ms(lambda: mc_kernel.mc_fused_torch(sdf_fns(desc), *args, **kwargs))
            args7, _, kwargs7 = k7_inputs(desc, field, mesh_cfg)
            k7 = mesh_kernel.project_edges_cuda(desc, *args7, **kwargs7)
            t7, t7_ms = timed_ms(lambda: mesh_kernel.project_edges_torch(
                sdf_fns(desc), *args7[:3], args7[3].bool(), **kwargs7))
            torch.cuda.synchronize()
            if bulb:
                res["K6/K7 level 3"] = {"voxels": field.count,
                                        **bulb_positions(k6, t6, k7, t7, args7[3].bool())}
            else:
                check(all(same_nan(a, b) for a, b in zip(k6, t6)),
                      f"K6 and its twin differ on {name}")
                check(all(same_nan(a, b) for a, b in zip(k7, t7)),
                      f"K7 and its twin differ on {name}")
                res["K6/K7 level 3"] = {"voxels": field.count, "edges": args7[0].numel(),
                                        "nan_positions": int(k6[0].isnan().sum()),
                                        "K7 nan points": int(k7[0].isnan().sum()), "exact": True}
            if composed:
                res.update(composed_kernel_times(desc, args, kwargs, args7, kwargs7, field.count,
                                                 (plain_ms, t6_ms, t7_ms)))
                if name in ("gadget", "deep", "nested"):
                    entries += composed_entries(res, launches, k1_err, (k6, t6), (k7, t7), name,
                                                tiers)
            print(f"{'composed scene' if composed else 'scene'} {name} on {card}: "
                  f"{json.dumps(res)}")
            out[name] = res
    return out, arguments, entries


def composed_kernel_times(desc, args, kwargs, args7, kwargs7, voxels: int,
                          plain_ms: tuple[float, float, float]) -> dict:
    """A composed scene's numbers beside :func:`scene_phases`' own: the
    program's FP32 operations per evaluation (forward, backward), and K6
    and K7 alone on the level-3 field (:func:`k6_alone_ms`,
    :func:`k7_alone_ms`) with their bounds from this field's Newton steps;
    ``plain_ms``, the times of the twins' calls there (K1's at
    SCENE_FRAME, K6's, K7's), beside them."""
    from bsdmg_tpu_torch.ops.cuda.csdf import sdf_fns
    from bsdmg_tpu_torch.utils import profiling

    fns = sdf_fns(desc)
    res = {"instructions": len(desc.program), "program ops": profiling.program_ops(desc),
           "stencil ops": profiling.fd4_ops(desc), "plain ms": plain_ms[0]}
    probe = newton_step_stats(desc, fns, args, kwargs)
    k6_ops = mesh_ops(desc, kwargs["use_grad"], probe["newton_steps"], probe["edges"],
                      probe["edges"], probe["valid_triangles"])
    res["K6 ms"] = k6_alone_ms(desc, args, kwargs)
    res["K6 plain ms"] = plain_ms[1]
    res["K6 bound"] = bound(voxels * MC_VOXEL_BYTES, k6_ops)
    m = args7[0].numel()
    k7_ops = mesh_ops(desc, kwargs7["use_grad"],
                      projection_step_stats(fns, args7, kwargs7)["newton_steps"], m)
    res["K7 ms"] = k7_alone_ms(desc, args7, kwargs7)
    res["K7 plain ms"] = plain_ms[2]
    res["K7 bound"] = bound(m * (16 + 24), k7_ops)
    return res


def composed_entries(res: dict, launches: dict, k1_err: float, k6, k7, name: str = "gadget",
                     tiers: tuple[str, str] = ("Composed", "Composed")) -> list[dict]:
    """The kernels line's entries of the instantiations of K1 (``tiers[0]``,
    Composed or the large tier's ComposedLarge, as the forward walk's caps
    pick it), K6 and K7 (``tiers[1]``, the taped walk's), from the
    composed scene ``name``'s results (``k6`` and ``k7``: the kernel's
    planes and the twin's)."""
    from bsdmg_tpu_torch.ops.cuda import mc_kernel, mesh_kernel
    from bsdmg_tpu_torch.ops.cuda import render_kernel as rk

    common = {"route": "cuda", "library_ms": None}
    return [
        {"name": f"K1 render_kernel<{tiers[0]}> ({name}, 1920x1080)", "source": rk.SOURCE,
         "replaces": "bsdmg_tpu/ops/pallas/render_kernel.py:336", "launches": launches["K1"],
         "max_abs_err": k1_err, "ms": res["K1 ms"], "plain_ms": res["plain ms"],
         "bound_ms": res["bound_ms"], "bound_by": res["bound_by"], **common},
        {"name": f"K6 mc_kernel<{tiers[1]}> ({name}, level 3)", "source": mc_kernel.SOURCE,
         "replaces": "bsdmg_tpu/ops/pallas/mc_fused.py:77", "launches": launches["K6"],
         "max_abs_err": _max_err(k6[0][0].nan_to_num(0.0), k6[1][0].nan_to_num(0.0)),
         "ms": res["K6 ms"], "plain_ms": res["K6 plain ms"], "bound_ms": res["K6 bound"][0],
         "bound_by": res["K6 bound"][1], **common},
        {"name": f"K7 project_kernel<{tiers[1]}> ({name}, level 3)", "source": mesh_kernel.SOURCE,
         "replaces": "bsdmg_tpu/ops/pallas/mesh_kernel.py:66", "launches": launches["K7"],
         "max_abs_err": _max_err(k7[0][0].nan_to_num(0.0), k7[1][0].nan_to_num(0.0)),
         "ms": res["K7 ms"], "plain_ms": res["K7 plain ms"], "bound_ms": res["K7 bound"][0],
         "bound_by": res["K7 bound"][1], **common},
    ]


def walk_sass(library: Path) -> dict:
    """COMPOSED_K1's march step in SASS: the first loop of over 100
    instructions (the march; its body starts first) and the largest loop
    inside it (the interpreter), with that loop's local, global, shared and
    constant loads and local stores (:func:`loops_of`)."""
    loops = sorted((lp for lp in sass_loops(library, COMPOSED_K1) if lp["instructions"] > 100),
                   key=lambda lp: int(lp["from"], 16))
    march = loops[0]
    inner = max((lp for lp in loops[1:] if int(lp["to"], 16) <= int(march["to"], 16)),
                key=lambda lp: lp["instructions"])
    return {"march step": march["instructions"], "interpreter loop": inner["instructions"],
            **{k: inner[k] for k in ("ldl", "stl", "ldg", "lds", "ldc", "uldc", "bra", "mufu")}}


def composed_phases(card: str, device) -> None:
    """9c. The composed scenes' paths that :func:`scene_phases` does not
    take: the interpreter's cost, K1 alone on the reference render scene
    written as a spec beside the fixed ``Box<true, false>``, each bit-equal
    to its twin, and K1 of the right-nested union (the large tier, by its
    stack) bit-equal to its twin; COMPOSED_K1's
    march step in SASS beside the parent's (:func:`walk_sass`,
    PARENT_WALK_SASS), and no spill in any Composed K1; ``cli session
    --scene examples/snowman.json --keys vbbbvv`` (K6 five times); ``cli
    animate`` at ANIMATE_SIZE, ANIMATE_FRAMES frames, orbiting the gadget
    and moving (``--rotate --motion spheric``) the gadget wrapped in a root
    ``transform``: K1 once a frame."""
    from bsdmg_tpu_torch.config import MarchConfig
    from bsdmg_tpu_torch.models import compose_scene, reference_render_scene
    from bsdmg_tpu_torch.ops.cuda import build
    from bsdmg_tpu_torch.ops.cuda import render_kernel as rk
    from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene

    cfg = MarchConfig()
    o, d, c = rays(*SCENE_FRAME, device)
    rgb = torch.empty((*c.shape, 3), device=device)
    cost = {}
    for label, scene in (("spec", compose_scene(REFERENCE_SPEC, device=device)),
                         ("Box<true, false>", reference_render_scene(device=device))):
        desc = compile_scene(scene)
        desc_c = rk.scene_desc_c(desc, cfg, device, taped=False)
        planes = rk.render_image_cuda(desc, o, d, c, return_planes=True)
        check(all(same_nan(a, b) for a, b in zip(planes, rk.render_image_planes_torch(desc, o, d, c))),
              f"K1 and its twin differ on {label} at {SCENE_FRAME}")
        evals, advances, hits = march_work(planes[2], planes[3], planes[1])
        cost[label] = {"K1 ms": graph_ms(lambda: rk._render_cuda(desc_c, o, d, c, rgb, None,
                                                                 cap=cfg.step_limit)),
                       "evaluations": evals, "hits": hits,
                       "bound": bound(render_bytes(c.numel()),
                                      render_ops(desc, evals, advances, hits, c.numel()))}
    print(f"interpreter cost on {card}: the reference render scene at {SCENE_FRAME}, "
          f"K1 alone, bit-equal to its twin: {json.dumps(cost)}")
    desc = compile_scene(compose_scene(RIGHT_NESTED_SPEC, device=device))
    check(all(rk.kernel_structure(desc, taped=taped) == rk.COMPOSED_LARGE
              for taped in (False, True)), "the right-nested union left the large tier")
    planes = rk.render_image_cuda(desc, o, d, c, return_planes=True)
    check(all(same_nan(a, b) for a, b in zip(planes, rk.render_image_planes_torch(desc, o, d, c))),
          f"K1 and its twin differ on the right-nested union at {SCENE_FRAME}")
    hits = int((planes[3] == 0).sum())
    check(hits > 0, "K1 of the right-nested union hits nothing")
    print(f"right-nested union on {card}: K1 (ComposedLarge) bit-equal to its twin at "
          f"{SCENE_FRAME}, {hits} hits")
    print(f"forward walk in SASS: {COMPOSED_K1}'s march step {json.dumps(walk_sass(build.build()))}"
          f", the parent's {json.dumps(PARENT_WALK_SASS)}")
    k1 = kernel_resources("render_kernel.cu", ("render_kernel<Composed,",))
    check(len(k1) == 12 and all(r["spill_stores"] == r["spill_loads"] == 0 for r in k1),
          f"a Composed K1 instantiation spills: {k1}")

    examples = {name: ROOT / "examples" / f"{name}.json" for name in ("gadget", "snowman")}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        session = tmp / "session.obj"
        counts, messages, seconds = run_cli(["session", "--scene", str(examples["snowman"]),
                                             "--keys", SESSION_KEYS, "-o", str(session)])
        v, _, f, finite = read_obj_counts(session)
        print(f"composed session on {card}: cli session --scene snowman --keys {SESSION_KEYS} in "
              f"{seconds:.2f} s, launches {counts}, {f} triangles, {v} vertices")
        check(counts["K6"] == SESSION_EXTRACTIONS, f"cli session launched K6 {counts['K6']} times")
        check(f > 0 and finite, f"composed session OBJ: {f} triangles, finite {finite}")

        moving = tmp / "gadget_moving.json"
        gadget = json.loads(examples["gadget"].read_text())
        moving.write_text(json.dumps({"name": "gadget_moving",
                                      "root": {"op": "transform", "child": gadget["root"]}}))
        for label, scene, extra in (("orbit", examples["gadget"], []),
                                    ("motion", moving, ["--rotate", "--motion", "spheric"])):
            prefix = tmp / label
            counts, messages, seconds = run_cli(
                ["animate", "--scene", str(scene), "--width", str(ANIMATE_SIZE[0]), "--height",
                 str(ANIMATE_SIZE[1]), "--frames", str(ANIMATE_FRAMES), "-o", str(prefix), *extra])
            frames = sorted(tmp.glob(f"{label}_*.png"))
            print(f"composed animate {label} on {card}: {len(frames)} frames in {seconds:.2f} s, "
                  f"launches {counts}")
            check(counts["K1"] == ANIMATE_FRAMES and len(frames) == ANIMATE_FRAMES,
                  f"cli animate {label} launched K1 {counts['K1']} times, {len(frames)} frames")
            check(not any("motion ignored" in m for m in messages), f"animate {label}: {messages}")


# ---------------------------------------------------------------------------
# mesh-asset scenes through every verb: K6 and K7 over the grid structure,
# the bake kernel, and BASELINE's mesh-asset configuration
# ---------------------------------------------------------------------------

#: the bake's bars: |values| bit-equal at every node compared, signs equal
#: but where the twin's winding number lies within BAKE_WN_BAND of 1/2; at
#: 256^3 the nodes compared are every BAKE_STRIDE-th and the lattice plane
#: through the planted faults' triangle (the twin takes minutes for all)
BAKE_WN_BAND = 1e-4
BAKE_STRIDE = 97
#: ptxas's registers of the reference K6 and K7, Box<false, false>, on the
#: tree before the grid structures were added (tools/time_kernels_alone.py
#: prints them for any checkout: its "ptxas" lines and stencil_probe's);
#: those are other instantiations and must not move them
REFERENCE_MESH_REGISTERS = {"mc_kernel<": 71, "project_kernel<": 65}
#: cli session's script and its K6 launches (as the reference object's)
ASSET_KEYS = "vbbbvv"
#: the animate phase's frames and size
ASSET_FRAMES = 2
ASSET_SIZE = (480, 270)
#: BASELINE's mesh-asset configuration (tools/e2e_mesh_1024.py's workload):
#: bake, render, extraction from 32^3 with 5 refines (1024^3)
E2E_RESOLUTION = 256
E2E_SIZE = 512
E2E_REFINES = 5


@contextlib.contextmanager
def no_twins():
    """The plain twins of K6, K7 and the bake raise while it lasts: a path
    on the card that reached one would fail."""
    from bsdmg_tpu_torch.ops.cuda import bake_kernel, mc_kernel, mesh_kernel

    def refuse(*args, **kwargs):
        raise RuntimeError("a plain twin ran on the card's path")

    saved = [(mc_kernel, "mc_fused_torch"), (mesh_kernel, "project_edges_torch"),
             (bake_kernel, "bake_torch")]
    originals = [getattr(m, n) for m, n in saved]
    try:
        for m, n in saved:
            setattr(m, n, refuse)
        yield
    finally:
        for (m, n), fn in zip(saved, originals):
            setattr(m, n, fn)


def bake_bars(values, dist, wn) -> dict:
    """The bake kernel's ``values`` at some nodes against its twin's
    distance and winding number there."""
    flips = torch.signbit(values) != (wn > 0.5)
    near = (wn - 0.5).abs() < BAKE_WN_BAND
    return {"nodes": values.numel(), "magnitude_differ": int((values.abs() != dist).sum()),
            "sign_differ": int(flips.sum()), "sign_differ_off_band": int((flips & ~near).sum()),
            "twin_near_half": int(near.sum())}


def bake_failed(bars: dict) -> list[str]:
    return [k for k in ("magnitude_differ", "sign_differ_off_band") if bars[k]]


#: the node sets that see a negative margin of the bake's distance bound: per
#: edge of the torus's top ring from the vertex at MARGIN_EDGE_FIRST on
#: (MARGIN_EDGES of them), a 16^3 lattice whose every brick is one point
#: (each axis value repeated as often as a brick spans it) above the edge's
#: midpoint at MARGIN_HEIGHTS: the two triangles on either side of the edge
#: meet the point at one distance, rounded apart, from two clusters whose
#: boxes' tops bound that distance to within the margin, so a bound that
#: grows by the margin skips the cluster the seed did not take
#: (tests/test_torch_bake_cull.py finds it with bake_cull_torch)
MARGIN_EDGE_FIRST = 2256
MARGIN_EDGES = 4
MARGIN_HEIGHTS = (1e-6, 3e-6, 1e-5, 3e-5)


def margin_axes(vertices: np.ndarray, device) -> list[list[torch.Tensor]]:
    """The lattices of MARGIN_EDGE_FIRST's node sets: each three (16,) axes."""
    top = np.where(vertices[:, 1] == vertices[:, 1].max())[0]
    at = int(np.where(top == MARGIN_EDGE_FIRST)[0][0])
    out = []
    for n in range(at, at + MARGIN_EDGES):
        a, b = vertices[top[n % len(top)]], vertices[top[(n + 1) % len(top)]]
        mx, _, mz = (a + b) * np.float32(0.5)
        ys = np.repeat(np.float32(a[1]) + np.asarray(MARGIN_HEIGHTS, np.float32), 4)
        out.append([torch.full((16,), float(mx), device=device), torch.from_numpy(ys).to(device),
                    torch.full((16,), float(mz), device=device)])
    return out


def make_torus():
    """``tools/make_torus.py``'s torus, ``(vertices, faces)`` as it makes
    them (its OBJ rounds the vertices to 6 decimals)."""
    spec = importlib.util.spec_from_file_location("make_torus", ROOT / "tools" / "make_torus.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.torus()


def margin_faults(device) -> dict:
    """The bake kernel on margin_axes' node sets of make_torus' torus against
    its twin: the nodes whose magnitude differs with the margin as it is and
    set negative (a planted fault in the wrapper, ``bake_kernel.MARGIN``,
    which the kernel takes as its eta), which must be none and some."""
    from bsdmg_tpu_torch.ops.cuda import bake_kernel as bk

    vertices, faces = make_torus()
    sets = margin_axes(vertices, device)
    plain = [bk.bake_torch(axes, vertices, faces).abs() for axes in sets]
    out = {}
    sound = bk.MARGIN
    try:
        for name, margin in (("margin", sound), ("margin set negative", -sound)):
            bk.MARGIN = margin
            out[name] = sum(int((bk.bake_cuda(axes, vertices, faces).abs() != p).sum())
                            for axes, p in zip(sets, plain))
    finally:
        bk.MARGIN = sound
    return out


def bake_phases(card: str, device, src) -> tuple[dict, dict]:
    """The bake kernel on the torus at 128^3 (every node against the twin,
    timed both) and 256^3 (every BAKE_STRIDE-th node and one lattice plane
    against the twin), each alone with its bound, that of the work the
    function needs (the winding number over every pair, the distance over
    the pairs its cull kept, whose share it prints), and beside it the bound
    over all pairs (the kernels line's ``bake_all_pairs_ms``); the last triangle dropped
    and one triangle's winding flipped, each of which must fail its bar;
    the margin of the cull's bound set negative, which must fail the
    magnitude bar on margin_axes' node sets. Returns the kernels line's
    entry (without launches) and the 128^3 lattice's values."""
    from bsdmg_tpu_torch.models.mesh_sdf import _linspace, grid_box, mesh_distance_winding
    from bsdmg_tpu_torch.ops.cuda import bake_kernel as bk
    from bsdmg_tpu_torch.utils import profiling

    faces = np.asarray(src.faces)
    dropped = faces[:-1]
    flipped = faces.copy()
    flipped[-1] = flipped[-1][[0, 2, 1]]
    centroid = src.vertices[faces[-1]].mean(axis=0)
    lo, hi = grid_box(src.vertices)
    out = {}
    for r in (128, 256):
        axes = [torch.from_numpy(_linspace(lo[a], hi[a], r)).to(device) for a in range(3)]
        prep = bk.prepare(axes, src.vertices, faces)
        values = torch.empty(r**3, dtype=torch.float32, device=device)
        pairs = torch.zeros(bk.brick_count(r), dtype=torch.int32, device=device)
        bk._bake_cuda(axes, prep, values, pairs)
        evaluated = int(pairs.long().sum().item())
        ms = median_ms(lambda: bk._bake_cuda(axes, prep, values), runs=3 if r == 128 else 2,
                       warmup=1 if r == 128 else 0)
        # the bound of the work the function needs: the winding number over
        # every pair, the distance over the pairs the cull kept; the
        # all-pairs count (profiling.bake_ops) beside it
        clusters = prep.boxes.shape[0]
        bound_ms, by = bound(profiling.bake_bytes(r, len(faces)), profiling.bake_design_ops(
            r**3, len(faces), evaluated, 2 * bk.brick_count(r) * clusters))
        all_pairs_ms, all_pairs_by = bound(profiling.bake_bytes(r, len(faces)),
                                           profiling.bake_ops(r**3, len(faces)))
        if r == 128:
            nodes = None
            points = bk.lattice(axes)
        else:
            plane = int(np.abs(axes[0].cpu().numpy() - centroid[0]).argmin())
            nodes = torch.cat([torch.arange(0, r**3, BAKE_STRIDE, device=device),
                               plane * r * r + torch.arange(r * r, device=device)]).unique()
            points = torch.stack([axes[0][nodes // (r * r)], axes[1][(nodes // r) % r],
                                  axes[2][nodes % r]], dim=-1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist, wn = mesh_distance_winding(points, src.vertices, faces)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        pick = (lambda v: v) if nodes is None else (lambda v: v[nodes])
        bars = bake_bars(pick(values), dist, wn)
        faults = {}
        for name, fault in (("last triangle dropped", dropped), ("winding flipped", flipped)):
            faults[name] = bake_bars(pick(bk.bake_cuda(axes, src.vertices, fault)), dist, wn)
        where = ("every node" if nodes is None else
                 f"{bars['nodes']} nodes: every {BAKE_STRIDE}th and the plane of x index {plane}")
        share = evaluated / (r**3 * len(faces))
        print(f"bake {r}^3 on {card} ({len(faces)} triangles, {clusters} clusters, {where}): "
              f"kernel {ms:.4f} ms alone (CUDA events), twin {plain_s:.3f} s on those nodes; "
              f"distance pairs evaluated {evaluated} ({share:.4%} of all); bound {bound_ms:.4f} "
              f"ms ({by}: the winding number over every pair, the distance over those), "
              f"{all_pairs_ms:.4f} ms ({all_pairs_by}) over all pairs; "
              f"bars {json.dumps(bars)}; planted faults {json.dumps(faults)}")
        check(not bake_failed(bars), f"the bake kernel fails its bars at {r}^3: {bars}")
        if r == 256:
            check("magnitude_differ" in bake_failed(faults["last triangle dropped"]),
                  "the magnitude bar does not see the last triangle dropped")
            check("sign_differ_off_band" in bake_failed(faults["winding flipped"]),
                  "the sign bar does not see one triangle's winding flipped")
        out[r] = {"ms": ms, "plain_s": plain_s, "bound_ms": bound_ms, "bound_by": by,
                  "all_pairs_ms": all_pairs_ms, "values": values if r == 128 else None,
                  "err": _max_err(pick(values).abs(), dist)}
    margins = margin_faults(device)
    print(f"bake margin on {card}: nodes whose magnitude differs on the margin's node sets "
          f"{json.dumps(margins)}")
    check(margins["margin"] == 0, "the bake differs from its twin on the margin's node sets")
    check(margins["margin set negative"] > 0, "the magnitude bar does not see a negative margin")
    for row in kernel_resources("bake_kernel.cu", ("bake_kernel",)):
        print(f"  ptxas: {row['kernel']}: {row['registers']} registers, {row['stack']} B stack, "
              f"{row['spill_stores']} B spill stores, {row['spill_loads']} B spill loads")
    entry = {"name": "bake_kernel (mesh-asset bake, the torus at 128^3)", "route": "cuda",
             "source": "bsdmg_tpu_torch/csrc/bake_kernel.cu",
             "replaces": "bsdmg_tpu/models/mesh_sdf.py:108 (XLA in the JAX package, no TPU kernel)",
             "max_abs_err": out[128]["err"], "ms": out[128]["ms"],
             "plain_ms": out[128]["plain_s"] * 1e3, "bound_ms": out[128]["bound_ms"],
             "bound_by": out[128]["bound_by"], "bake_all_pairs_ms": out[128]["all_pairs_ms"],
             "library_ms": None}
    print(f"bake 256^3 on {card}: {out[256]['ms']:.4f} ms alone, bound {out[256]['bound_ms']:.4f} "
          f"ms ({out[256]['bound_by']}), {out[256]['all_pairs_ms']:.4f} ms over all pairs")
    return entry, out[128]["values"]


def asset_cli(argv: list[str]) -> tuple[dict, list[str], float]:
    """``cli <argv>`` with no plain twin of K6, K7 or the bake allowed."""
    with no_twins():
        return run_cli(argv)


def grid_kernel_phase(card: str, label: str, desc, field, cfg, launches: dict,
                      with_k7: bool) -> list[dict]:
    """K6 (and K7) over a grid structure at ``field``'s voxels against
    their twins on the card, bit for bit with NaN at the same places; each
    alone with its bound and the twin's time; the kernels line's entries."""
    from bsdmg_tpu_torch.ops.cuda import mc_kernel, mesh_kernel
    from bsdmg_tpu_torch.ops.cuda.csdf import sdf_fns
    from bsdmg_tpu_torch.ops.marching_cubes import kernel_inputs

    fns = sdf_fns(desc)
    args, kwargs = kernel_inputs(desc, field.lowers, field.voxel_size, cfg)
    kern = mc_kernel.mc_fused_cuda(desc, *args, **kwargs)
    t0 = time.perf_counter()
    twin = mc_kernel.mc_fused_torch(fns, *args, **kwargs)
    torch.cuda.synchronize()
    k6_plain = (time.perf_counter() - t0) * 1e3
    equal = [same_nan(a, b) for a, b in zip(kern, twin)]
    valid = int(((kern[4][:, None] >> torch.arange(5, device=kern[4].device)) & 1).sum())
    probe = newton_step_stats(desc, fns, args, kwargs)
    k6_ops = mesh_ops(desc, kwargs["use_grad"], probe["newton_steps"], probe["edges"],
                      probe["edges"], probe["valid_triangles"])
    k6_bound = bound(field.count * MC_VOXEL_BYTES, k6_ops)
    k6_ms = k6_alone_ms(desc, args, kwargs)
    print(f"K6 over {label}: {field.count} voxels, {valid} triangles, {probe['edges']} edges, "
          f"{probe['newton_steps']} Newton steps; bit-equal to its twin (pos, nrm, dot, amb, meta) "
          f"{equal}, NaN {int(kern[0].isnan().sum())}; alone {k6_ms:.4f} ms, twin "
          f"{k6_plain:.1f} ms, bound {k6_bound[0]:.4f} ms ({k6_bound[1]}, {k6_ops:.4g} operations)")
    check(all(equal), f"K6 over {label} differs from its twin: {equal}")
    common = {"route": "cuda", "library_ms": None}
    entries = [{"name": f"K6 mc_kernel<{desc_structure(desc)}> ({label})", "source": mc_kernel.SOURCE,
                "replaces": "bsdmg_tpu/ops/pallas/mc_fused.py:77", "launches": launches["K6"],
                "max_abs_err": _max_err(kern[0].nan_to_num(0.0), twin[0].nan_to_num(0.0)),
                "ms": k6_ms, "plain_ms": k6_plain, "bound_ms": k6_bound[0],
                "bound_by": k6_bound[1], **common}]
    if with_k7:
        cfg7 = dataclasses.replace(cfg, interpolate_edges=True)
        args7, kwargs7 = kernel_inputs(desc, field.lowers, field.voxel_size, cfg7)
        kern7 = mesh_kernel.project_edges_cuda(desc, *args7, **kwargs7)
        t0 = time.perf_counter()
        twin7 = mesh_kernel.project_edges_torch(fns, *args7[:3], args7[3].bool(), **kwargs7)
        torch.cuda.synchronize()
        k7_plain = (time.perf_counter() - t0) * 1e3
        equal7 = [same_nan(a, b) for a, b in zip(kern7, twin7)]
        m = args7[0].numel()
        k7_ops = mesh_ops(desc, kwargs7["use_grad"],
                          projection_step_stats(fns, args7, kwargs7)["newton_steps"], m)
        k7_bound = bound(m * (16 + 24), k7_ops)
        k7_ms = k7_alone_ms(desc, args7, kwargs7)
        print(f"K7 over {label}: {m} listed edges; bit-equal to its twin {equal7}; alone "
              f"{k7_ms:.4f} ms, twin {k7_plain:.1f} ms, bound {k7_bound[0]:.4f} ms ({k7_bound[1]})")
        check(all(equal7), f"K7 over {label} differs from its twin: {equal7}")
        entries.append({"name": f"K7 project_kernel<{desc_structure(desc)}> ({label})",
                        "source": mesh_kernel.SOURCE,
                        "replaces": "bsdmg_tpu/ops/pallas/mesh_kernel.py:66",
                        "launches": launches["K7"],
                        "max_abs_err": _max_err(kern7[0].nan_to_num(0.0), twin7[0].nan_to_num(0.0)),
                        "ms": k7_ms, "plain_ms": k7_plain, "bound_ms": k7_bound[0],
                        "bound_by": k7_bound[1], **common})
    return entries


def desc_structure(desc) -> str:
    """A grid descriptor's structure as the source names it."""
    return f"GridScene<{'GRID_LERP' if desc.grid_form == 'lerp' else 'GRID_WEIGHTS'}>"


def e2e_asset_phase(card: str, device, obj: Path) -> None:
    """BASELINE's mesh-asset configuration on the port at full width
    (tools/e2e_mesh_1024.py's workload): the torus OBJ, its 256^3 bake, a
    512x512 render from (3, 1.5, -3) on the contraction route, the
    extraction from 32^3 with 5 refines (1024^3) through ``mesh.pipeline.
    remesh`` (the weights form shifted by the grid's centre, 24 Newton
    iterations, K6), its native weld, and the OBJ write; each stage's
    seconds, the counts, and the vertices' |sdf| on the baked field
    (grid_sdf's lerps at the vertices, as the tool measures)."""
    from bsdmg_tpu_torch.cam import generate_rays, look_at
    from bsdmg_tpu_torch.mesh.export import load_obj, save_obj
    from bsdmg_tpu_torch.mesh.pipeline import remesh, remesh_scene
    from bsdmg_tpu_torch.models.mesh_sdf import bake_mesh_grid
    from bsdmg_tpu_torch.ops.cuda import grid_kernel as tg
    from bsdmg_tpu_torch.ops.cuda.csdf import descriptor_csdf, grid_descriptor

    stages: dict = {}
    clock = []

    def lap(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name] = now - clock[-1]
        clock.append(now)

    reset_launches()
    torch.cuda.synchronize()
    clock.append(time.perf_counter())
    src = load_obj(obj)
    lap("load")
    grid = bake_mesh_grid(src.vertices, src.faces, resolution=E2E_RESOLUTION, device=device)
    lap(f"bake {E2E_RESOLUTION}^3")
    levels = tg.make_contraction_levels(grid)
    lap("contraction levels")
    rays = generate_rays(look_at(TORUS_CAMERA, device=device), (E2E_SIZE, E2E_SIZE),
                         (float(E2E_SIZE), float(E2E_SIZE)))
    for frame in ("render frame 1", "render frame 2"):
        img = tg.render_image_grid(grid, *rays, mode="contraction", levels=levels)
        lap(frame)
    lit = float((img.sum(-1) > 0.01).float().mean())
    voxels = []

    def on_level(field):
        voxels.append(field.count)
        lap(f"refine to level {len(voxels) - 1}" if len(voxels) > 1 else "initial field")

    with no_twins():
        mesh = remesh(grid, refine=E2E_REFINES, newton_iters=24, device=device,
                      on_level=on_level, on_triangles=lambda soup: lap("extraction (K6)"))
    lap("weld (native)")
    with tempfile.TemporaryDirectory() as tmp:
        save_obj(mesh, Path(tmp) / "torus_1024.obj")
        lap("OBJ write (native)")
        size = (Path(tmp) / "torus_1024.obj").stat().st_size
    center = remesh_scene(grid)[2]
    lerp = descriptor_csdf(grid_descriptor(grid, "lerp", center))
    v = torch.from_numpy(mesh.vertices - center).to(device)
    sd = lerp(v[:, 0].contiguous(), v[:, 1].contiguous(), v[:, 2].contiguous()).abs()
    from bsdmg_tpu_torch.ops.cuda import bake_kernel, mc_kernel

    print(f"BASELINE mesh-asset configuration on {card} (tools/e2e_mesh_1024.py's workload; "
          f"{src.triangle_count} triangles): stages (s, host clock after a sync) "
          f"{json.dumps({k: round(x, 6) for k, x in stages.items()})}; render lit fraction "
          f"{lit:.3f}; voxels per level {voxels}; mesh {mesh.vertex_count} vertices, "
          f"{mesh.triangle_count} triangles, OBJ {size} B; vertex |sdf| mean "
          f"{sd.mean().item():.3e} max {sd.max().item():.3e}; launches K6 {mc_kernel.LAUNCHES}, "
          f"bake {bake_kernel.LAUNCHES}")
    check(mc_kernel.LAUNCHES >= 1 and bake_kernel.LAUNCHES == 1,
          "the mesh-asset configuration did not launch K6 and the bake")
    check(mesh.triangle_count > 0 and bool(torch.isfinite(sd).all()) and sd.max().item() < 1e-3,
          f"the 1024^3 mesh: {mesh.triangle_count} triangles, |sdf| max {sd.max().item()}")


def asset_phases(card: str, device) -> list[dict]:
    """Mesh-asset scenes through every verb on the card: the bake kernel
    against its twin (:func:`bake_phases`); ``cli mesh --scene mesh:``
    (K6, and K7 with ``--interpolate-edges``), ``cli remesh``, ``cli
    session`` and ``cli animate`` of the torus, each with the bake and no
    plain twin of K6, K7 or the bake; the depth ``cli fit`` (plain PyTorch,
    as JAX's XLA) and ``fit --image`` (K4's and K5's grid form,
    :func:`grid_form_phase`); K6 and K7 over the
    grid structure against their twins in the lerp form at ``cli mesh``'s
    defaults (level 3, bb 5) and K6 in the weights form at ``cli
    remesh``'s (128^3, init 32, refine 2); the reference K6 and K7 keep
    their registers (REFERENCE_MESH_REGISTERS) and no spill; then
    BASELINE's configuration (:func:`e2e_asset_phase`). Returns the kernels line's entries."""
    from bsdmg_tpu_torch.config import MeshGenConfig
    from bsdmg_tpu_torch.mesh.export import load_obj
    from bsdmg_tpu_torch.mesh.field import create_voxel_field, refine_field
    from bsdmg_tpu_torch.mesh.pipeline import remesh_scene
    from bsdmg_tpu_torch.models.mesh_sdf import SdfGrid, grid_box
    from bsdmg_tpu_torch.ops.cuda.csdf import grid_descriptor

    entries = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        obj = tmp / "torus.obj"
        subprocess.run([sys.executable, str(ROOT / "tools" / "make_torus.py"), str(obj)],
                       capture_output=True, text=True, check=True, timeout=300)
        src = load_obj(obj)
        bake_entry, values = bake_phases(card, device, src)
        lo, hi = grid_box(src.vertices)
        grid = SdfGrid(values=values.reshape(128, 128, 128), lo=tuple(map(float, lo)),
                       hi=tuple(map(float, hi)))

        runs = {}
        for name, argv, want in (
            ("mesh", ["mesh", "--scene", f"mesh:{obj}", "-o", str(tmp / "m.obj")],
             {"K6": 1, "K7": 0, "bake": 1}),
            ("mesh --interpolate-edges", ["mesh", "--scene", f"mesh:{obj}", "--interpolate-edges",
                                          "-o", str(tmp / "k7.obj")], {"K6": 0, "K7": 1, "bake": 1}),
            ("remesh", ["remesh", "-i", str(obj), "-o", str(tmp / "r.obj")],
             {"K6": 1, "K7": 0, "bake": 1}),
            ("session", ["session", "--scene", f"mesh:{obj}", "--keys", ASSET_KEYS, "-o",
                         str(tmp / "s.obj")], {"K6": SESSION_EXTRACTIONS, "K7": 0, "bake": 1}),
            ("animate", ["animate", "--scene", f"mesh:{obj}", "--frames", str(ASSET_FRAMES),
                         "--width", str(ASSET_SIZE[0]), "--height", str(ASSET_SIZE[1]), "--rotate",
                         "--motion", "spheric", "--camera", *map(str, TORUS_CAMERA), "-o",
                         str(tmp / "frame")],
             {"K1": 0, "bake": 1, **{k: n * ASSET_FRAMES for k, n in GRID_LAUNCHES.items()}}),
            ("fit", ["fit", "--scene", f"mesh:{obj}:16", "--perturb", "grid=1.1", "--steps", "2"],
             {"K4": 0, "K5": 0, "bake": 1}),
        ):
            counts, messages, seconds = asset_cli(argv)
            runs[name] = counts
            out = {"mesh": "m.obj", "mesh --interpolate-edges": "k7.obj", "remesh": "r.obj",
                   "session": "s.obj"}.get(name)
            tail = ""
            if out:
                v, vn, f, finite = read_obj_counts(tmp / out)
                tail = f"; {f} triangles, {v} vertices, finite {finite}"
                check(f > 0 and v == vn and finite, f"cli {name} of the torus: {v}, {vn}, {f}")
            shown = [m for m in messages if m.startswith(("level", "mesh:", "remeshed", "baked",
                                                          "loaded", "extracted", "step",
                                                          "recovered", "scene"))]
            print(f"mesh-asset cli {name} on {card} in {seconds:.2f} s: launches "
                  f"{ {k: counts[k] for k in want} }{tail}; log {json.dumps(shown)[:1500]}")
            check(all(counts[k] == n for k, n in want.items()),
                  f"cli {name} --scene mesh: launched {counts}, not {want}")
            if name == "animate":
                check(any("motion ignored" in m for m in messages),
                      "animate --motion of a mesh asset did not warn")
        entries += grid_form_phase(card, device, obj, grid)

        # K6 and K7 over the grid structure against their twins
        cfg = MeshGenConfig()
        lerp = grid_descriptor(grid)
        field = create_voxel_field(cfg, device)
        for _ in range(3):
            field = refine_field(lerp, field)
        entries += grid_kernel_phase(card, "mesh asset, lerp form, cli mesh level 3", lerp, field,
                                     cfg, {"K6": runs["mesh"]["K6"],
                                           "K7": runs["mesh --interpolate-edges"]["K7"]}, True)
        weights, rcfg, _ = remesh_scene(grid)
        field = create_voxel_field(rcfg, device)
        for _ in range(2):
            field = refine_field(weights, field)
        entries += grid_kernel_phase(card, "mesh asset, weights form, cli remesh level 2",
                                     weights, field, rcfg, {"K6": runs["remesh"]["K6"]}, False)
        del field
        e2e_asset_phase(card, device, obj)
    bake_entry["launches"] = runs["mesh"]["bake"]
    entries.append(bake_entry)

    for source, prefix in (("mc_kernel.cu", "mc_kernel<"), ("project_kernel.cu", "project_kernel<")):
        want = REFERENCE_MESH_REGISTERS[prefix]
        rows = kernel_resources(source, (prefix,))
        for row in rows:
            if "GridScene" in row["kernel"] or row["kernel"].endswith("<Box<false, false>>"):
                print(f"  ptxas: {row['kernel']}: {row['registers']} registers, {row['stack']} B "
                      f"stack, {row['spill_stores']} B spill stores, {row['spill_loads']} B spill loads")
        ref = [r for r in rows if r["kernel"].endswith("<Box<false, false>>")]
        check(len(ref) == 1 and ref[0]["registers"] == want and not ref[0]["spill_stores"],
              f"the reference {prefix}Box<false, false>> moved from {want} registers: {ref}")

    return entries


# ---------------------------------------------------------------------------
# the last modules: the moved wrapped object (structure 11), K4's and K5's
# grid form, the refine and MC rooflines
# ---------------------------------------------------------------------------

#: the wrapped object moved by its object transform (csrc/scene_sdf.cuh
#: with_structure 11), ``cli animate --motion axis``'s frames after the first
MOVED_STRUCTURE = "Wrapped<Box<false, true>>"
MOVED_K1 = f"render_kernel<{MOVED_STRUCTURE}, false, false, 0>"
#: the motion time of the held frame, and the small frame of K2 + K3 and
#: the level of K6 and K7 there (init factor 16, two refines)
MOVED_TIME = 1.3
MOVED_SMALL = (320, 180)
MOVED_MESH = (16, 2)
#: K4's and K5's grid form (csrc/param_forms.cuh), the frames it is held
#: and timed on, and the fit's loss bar: the target and each step render
#: the same frame, so the kernels' loss is rounding (each pixel's colour
#: 1e-4 off would read 1e-8)
GRID_FORM = "MeshGridForm"
GRID_FIT_SIZES = (64, 512)
GRID_FIT_LOSS = 1e-8
#: the planted faults of ``--grid-faults``: each must fail a bar of
#: :func:`grid_form_readings` (the dfdt bar; the loss bar)
GRID_FAULTS = {
    "dfdt without z": ("bsdmg_tpu_torch/csrc/param_forms.cuh",
                       "    return (g[0] * d[0] + g[1] * d[1]) + g[2] * d[2];",
                       "    return g[0] * d[0] + g[1] * d[1];"),
    # the light is (1, 1, 1): a normal with two components swapped shades
    # alike, so the fault flips one
    "normal z flipped": ("bsdmg_tpu_torch/csrc/param_forms.cuh",
                         "      mesh_grid_value<true>(s, x, g);\n    }",
                         "      mesh_grid_value<true>(s, x, g);\n      g[2] = -g[2];\n    }"),
}


def moved_params(scene, device) -> dict:
    """The wrapped object's parameters at MOVED_TIME under ``--motion
    axis`` and a rotation: its object transform moved, as ``cli animate``
    moves it."""
    from bsdmg_tpu_torch.models import motion

    view = {k: scene.params[k] for k in ("object_center", "object_rotation")}
    return dict(scene.params, **motion.motion_params(
        view, MOVED_TIME, axis_cyclic=motion.AxisCyclicMotion(),
        rotate_axis=motion.RotateAxisMotion(), device=device))


def moved_wrap_phase(card: str, device) -> list[dict]:
    """17. The wrapped object moved by its object transform, structure 11
    (``Wrapped<Box<false, true>>``): ptxas's registers, stack and spills of
    its K1, K2, K3, K6 and K7 instantiations (none may spill); ``cli animate
    --motion axis --scene wrapped_object`` (K1 once a frame, counted by
    structure: the first frame, unmoved, on structure 7, each later one on
    11, the launches the kernels line reports); K1 against its
    twin at 1920x1080 bit for bit, NaN at the same places, alone (a CUDA
    graph of 20) with its bound; the row pipeline (K2, K2, K3) and the block
    one at 320x180 and K6 and K7 at level 2 of init factor 16, each against
    its twins once. Returns the kernels line's K1 entry."""
    from bsdmg_tpu_torch.cam import generate_rays, look_at
    from bsdmg_tpu_torch.config import MarchConfig, MeshGenConfig
    from bsdmg_tpu_torch.mesh.field import create_voxel_field, refine_field
    from bsdmg_tpu_torch.models import get_scene
    from bsdmg_tpu_torch.ops.cuda import mc_kernel, mesh_kernel
    from bsdmg_tpu_torch.ops.cuda import render_kernel as rk
    from bsdmg_tpu_torch.ops.cuda.csdf import (
        WRAPPED,
        WRAPPED_MOVED,
        compile_scene,
        kernel_structure,
        sdf_fns,
    )
    from bsdmg_tpu_torch.ops.marching_cubes import kernel_inputs

    start = time.perf_counter()
    rows = [r for source, prefix in (("render_kernel.cu", ("render_kernel<", "trace_kernel<",
                                                           "shade_kernel<")),
                                     ("mc_kernel.cu", ("mc_kernel<",)),
                                     ("project_kernel.cu", ("project_kernel<",)))
            for r in kernel_resources(source, prefix) if MOVED_STRUCTURE in r["kernel"]]
    for r in rows:
        print(f"  ptxas: {r['kernel']}: {r['registers']} registers, {r['stack']} B stack, "
              f"{r['spill_stores']} B spill stores, {r['spill_loads']} B spill loads")
    unmoved = [r for source, prefix in (("render_kernel.cu", ("render_kernel<", "trace_kernel<",
                                                              "shade_kernel<")),
                                        ("mc_kernel.cu", ("mc_kernel<",)),
                                        ("project_kernel.cu", ("project_kernel<",)))
               for r in kernel_resources(source, prefix)
               if "Wrapped<Box<false, false>>" in r["kernel"]]
    check(len(rows) == len(unmoved) and not any(r["spill_stores"] or r["spill_loads"]
                                                for r in rows),
          f"the {MOVED_STRUCTURE} instantiations are not the unmoved object's "
          f"{len(unmoved)} without spills: {rows}")
    k1_row = next(r for r in rows if r["kernel"] == MOVED_K1)

    with tempfile.TemporaryDirectory() as tmp:
        counts, messages, seconds = run_cli(
            ["animate", "--scene", "wrapped_object", "--motion", "axis", "--frames",
             str(ANIMATE_FRAMES), "--width", str(ANIMATE_SIZE[0]), "--height",
             str(ANIMATE_SIZE[1]), "-o", str(Path(tmp) / "w")])
        structures = dict(rk.STRUCTURE_LAUNCHES)
    print(f"moved wrapped object: cli animate --motion axis --scene wrapped_object "
          f"({ANIMATE_SIZE}, {ANIMATE_FRAMES} frames) in {seconds:.2f} s, launches "
          f"{launched(counts)}, K1 by structure {structures}")
    # the first frame, at t = 0, is the unmoved object; every later one moved
    check(counts["K1"] == ANIMATE_FRAMES and not any("motion ignored" in m for m in messages),
          f"animate --motion of the wrapped object launched K1 {counts['K1']} times")
    check(structures == {WRAPPED: 1, WRAPPED_MOVED: ANIMATE_FRAMES - 1},
          f"animate --motion's frames ran K1's structures {structures}, not {WRAPPED} once "
          f"and {WRAPPED_MOVED} {ANIMATE_FRAMES - 1} times")

    scene = get_scene("wrapped_object", device=device)
    desc = compile_scene(scene, moved_params(scene, device))
    check(kernel_structure(desc) == WRAPPED_MOVED, "the moved wrapped object is not structure 11")

    def frame(w, h):
        return generate_rays(look_at((5.0, 2.0, -5.0), fov=np.pi / 4, device=device), (w, h),
                             SCREEN)

    o, d, c = frame(*SCENE_FRAME)
    kernel = rk.render_image_cuda(desc, o, d, c, return_planes=True)
    t0 = time.perf_counter()
    plain = rk.render_image_planes_torch(desc, o, d, c)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(all(same_nan(a, b) for a, b in zip(kernel, plain)),
          f"K1 and its twin differ on the moved wrapped object at {SCENE_FRAME}")
    _, depth, steps, outcome = kernel
    evals, advances, hits = march_work(steps, outcome, depth)
    b1 = bound(render_bytes(c.numel()), render_ops(desc, evals, advances, hits, c.numel()))
    cfg = MarchConfig()
    desc_c = rk.scene_desc_c(desc, cfg, device)
    rgb = torch.empty((*c.shape, 3), device=device)
    k1_ms = graph_ms(lambda: rk._render_cuda(desc_c, o, d, c, rgb, None, cap=cfg.step_limit,
                                             cull=False))
    res = {"K1 ms": k1_ms, "plain ms": plain_ms, "bound_ms": b1[0], "bound_by": b1[1],
           "hits": hits, "evaluations": evals, "exact": True,
           "registers": {k: k1_row[k] for k in ("registers", "stack", "spill_stores")}}

    small = frame(*MOVED_SMALL)
    for tp in (True, "block"):
        got = rk.render_image_cuda(desc, *small, return_planes=True, two_phase=tp)
        twin = twin_pipeline(rk, desc, *small, two_phase=tp)
        check(all(same_nan(a, b) for a, b in zip(got, twin)),
              f"the {tp} pipeline and its twin differ on the moved wrapped object")
    mesh_cfg = MeshGenConfig(init_factor=MOVED_MESH[0])
    field = create_voxel_field(mesh_cfg, device)
    for _ in range(MOVED_MESH[1]):
        field = refine_field(desc, field)
    args, kwargs = kernel_inputs(desc, field.lowers, field.voxel_size, mesh_cfg)
    k6 = mc_kernel.mc_fused_cuda(desc, *args, **kwargs)
    t6 = mc_kernel.mc_fused_torch(sdf_fns(desc), *args, **kwargs)
    args7, _, kwargs7 = k7_inputs(desc, field, mesh_cfg)
    k7 = mesh_kernel.project_edges_cuda(desc, *args7, **kwargs7)
    t7 = mesh_kernel.project_edges_torch(sdf_fns(desc), *args7[:3], args7[3].bool(), **kwargs7)
    torch.cuda.synchronize()
    check(all(same_nan(a, b) for a, b in zip(k6, t6)) and all(same_nan(a, b) for a, b in zip(k7, t7)),
          "K6 or K7 and its twin differ on the moved wrapped object")
    res.update({"row and block at": MOVED_SMALL, "K6/K7 voxels": field.count,
                "K7 points": args7[0].numel(), "valid triangles": int(
                    ((k6[4][:, None] >> torch.arange(5, device=device)) & 1).sum())})
    print(f"moved wrapped object ({MOVED_STRUCTURE}) on {card}: {json.dumps(res)}; "
          f"the phase in {time.perf_counter() - start:.1f} s")
    return [{"name": f"K1 {MOVED_K1} (wrapped object moved, 1920x1080)", "route": "cuda",
             "source": rk.SOURCE, "replaces": "bsdmg_tpu/ops/pallas/render_kernel.py:336",
             "launches": structures[WRAPPED_MOVED],
             "max_abs_err": (kernel[0] - plain[0]).abs().max().item(),
             "ms": k1_ms, "plain_ms": plain_ms, "bound_ms": b1[0], "bound_by": b1[1],
             "library_ms": None}]


class _Touched:
    """A mesh asset's component SDF that records the table values each call
    reads (the eight corners of each point's cell, as ``grid_csdf`` gathers
    them): :func:`grid_form_readings` counts a kernel's bytes by them."""

    def __init__(self, csdf):
        from bsdmg_tpu_torch.models.mesh_sdf import box_f32

        self.csdf = csdf
        grid = csdf.grid
        self.r = grid.resolution
        self.box = box_f32(self.r, grid.lo, grid.hi)
        self.read = torch.zeros(self.r**3, dtype=torch.bool, device=grid.values.device)

    def __call__(self, params, x, y, z):
        lo, _, scale, clip_hi = self.box
        with torch.no_grad():
            base = [torch.floor(torch.clamp((v.detach() - lo[a]) * scale[a], 0.0, clip_hi)).long()
                    for a, v in enumerate((x, y, z))]
            for dx in (0, 1):
                for dy in (0, 1):
                    for dz in (0, 1):
                        i = [torch.clamp_max(b + s, self.r - 1) for b, s in zip(base, (dx, dy, dz))]
                        self.read[((i[0] * self.r + i[1]) * self.r + i[2]).reshape(-1)] = True
        return self.csdf(params, x, y, z)

    def nbytes(self) -> int:
        return 4 * int(self.read.sum().item())


def grid_form_readings(scene, device, timed: bool = False) -> dict:
    """K4's and K5's grid form (``MeshGridForm``) on the mesh asset
    ``scene`` from TORUS_CAMERA against their twins at each GRID_FIT_SIZES
    frame: K4 (track_min off and on) bit for bit but dfdt (within
    DFDT_ATOL, NaN at the same places); K5 (edge term off and on) against
    a black target, its loss within LOSS_RTOL relative, and at the fit's
    target (the render at the scene's parameters) within GRID_FIT_LOSS,
    its gradient zero bit for bit, two calls the same bits. With
    ``timed``, each kernel alone (a CUDA graph of 20 from a prepared
    struct), its twin's time and its bound (``profiling.form_ops``; bytes
    with the table values read, counted by :class:`_Touched`)."""
    from bsdmg_tpu_torch.config import MarchConfig
    from bsdmg_tpu_torch.grad import render_image_diff
    from bsdmg_tpu_torch.grad.edge import UNTRACKED, classify_target_miss
    from bsdmg_tpu_torch.ops.cuda import diff_kernel as dk
    from bsdmg_tpu_torch.ops.cuda.csdf import grid_descriptor
    from bsdmg_tpu_torch.utils.profiling import form_ops

    params = dict(scene.params)
    out = {}
    for size in GRID_FIT_SIZES:
        o, d, c = rays(size, size, device, TORUS_CAMERA)
        npix = c.numel()
        fit_target = render_image_diff(scene.sdf, params, o, d, c, csdf=scene.csdf).detach()
        res = {"k4_exact": True, "dfdt_err": 0.0, "k5": {}}
        for track in (False, True):
            k4 = dk.march_params_cuda(scene.csdf, params, o, d, c, track_min=track)
            p4 = dk.march_params_torch(scene.csdf, params, o, d, c, track_min=track)
            torch.cuda.synchronize()
            res["k4_exact"] &= all(bool(torch.equal(a, b)) for i, (a, b) in enumerate(zip(k4, p4))
                                   if i != 3)
            both = ~(k4[3].isnan() | p4[3].isnan())
            res["k4_exact"] &= bool(torch.equal(k4[3].isnan(), p4[3].isnan()))
            res["dfdt_err"] = max(res["dfdt_err"], _max_err(k4[3][both], p4[3][both]))
        res["hits"] = int((k4[2] == 0).sum())
        for tname, target in (("black", torch.zeros_like(fit_target)), ("fit", fit_target)):
            for edge in (0.0, 1.0):
                k5 = dk.render_loss_grad_cuda(scene.csdf, params, target, o, d, c,
                                              edge_weight=edge)
                again = dk.render_loss_grad_cuda(scene.csdf, params, target, o, d, c,
                                                 edge_weight=edge)
                p5 = dk.render_loss_grad_torch(scene.csdf, params, target, o, d, c,
                                               edge_weight=edge)
                torch.cuda.synchronize()
                kl, pl = k5[0].item(), p5[0].item()
                res["k5"][f"{tname} edge {edge}"] = {
                    "loss": kl, "plain_loss": pl, "abs_err": abs(kl - pl),
                    "rel_err": abs(kl - pl) / max(abs(pl), 1e-30),
                    "zero_grad": all(bool(torch.equal(k5[1][k], torch.zeros_like(v)))
                                     for k, v in params.items()),
                    "reproducible": bool(torch.equal(k5[0], again[0]))}
        if timed:
            scene_c, _ = dk.param_scene_c(scene.csdf, params, device=device)
            state = dk._target_state(fit_target, None).contiguous()
            band = dk._band(MarchConfig(), None)
            res["K4 ms"] = graph_ms(lambda: dk._march_cuda(scene_c, o, d, c, False))
            res["K5 ms"] = graph_ms(lambda: dk._loss_grad_cuda(
                scene_c, o, d, c, fit_target, state, npix, 1.0, band))
            # the plain versions ran above: one timed call each
            res["K4 plain ms"] = median_ms(lambda: dk.march_params_torch(
                scene.csdf, params, o, d, c), runs=1, warmup=0)
            res["K5 plain ms"] = median_ms(lambda: dk.render_loss_grad_torch(
                scene.csdf, params, fit_target, o, d, c, edge_weight=1.0), runs=1, warmup=0)
            touched4, touched5 = _Touched(scene.csdf), _Touched(scene.csdf)
            depth, steps, outcome, _, min_m, _ = dk.march_params_torch(touched4, params, o, d, c,
                                                                       track_min=True)
            dk.render_loss_grad_torch(touched5, params, fit_target, o, d, c, edge_weight=1.0)
            sdf, grad = form_ops(grid_descriptor(scene.csdf.grid, "weights"))
            evals, advances, hits = march_work(steps, outcome, depth)
            miss = classify_target_miss(fit_target)
            hit = outcome == 0
            hinges = int(((~miss & ~hit & (min_m < UNTRACKED)) | (miss & hit)).sum().item())
            res["K4 bound"] = bound(npix * (28 + 16) + touched4.nbytes(),
                                    k4_ops(npix, evals, advances, False, False, False, False,
                                           sdf=sdf, grad=grad))
            res["K5 bound"] = bound(npix * 44 + touched5.nbytes(),
                                    k5_ops(npix, evals, advances, hits, hinges, False, False, True,
                                           sdf=sdf, grad=grad, bounds=False, reverse=False))
            res.update({"table bytes read": [touched4.nbytes(), touched5.nbytes()],
                        "evaluations": evals, "hinges": hinges})
        out[size] = res
    return out


def grid_form_failed(readings: dict) -> list[str]:
    """The bars of :func:`grid_form_readings` that ``readings`` fail."""
    failed = []
    for size, res in readings.items():
        if not res["k4_exact"]:
            failed.append(f"{size}: K4 not bit-equal but dfdt")
        if not res["dfdt_err"] <= DFDT_ATOL:
            failed.append(f"{size}: dfdt {res['dfdt_err']:.3e}")
        for case, k5 in res["k5"].items():
            within = (k5["rel_err"] <= LOSS_RTOL if case.startswith("black")
                      else k5["abs_err"] <= GRID_FIT_LOSS)
            if not (within and k5["zero_grad"] and k5["reproducible"]):
                failed.append(f"{size}: K5 {case} {k5}")
    return failed


def grid_form_phase(card: str, device, obj: Path, grid) -> list[dict]:
    """15b. ``cli fit --image --scene mesh:<torus>`` (the 128^3 bake, 64x64,
    60 Adam steps: K4 once, K5 60 times through their grid form, the loss
    within GRID_FIT_LOSS at every logged step: the grid reads no parameter
    and nothing moves, as in the JAX package); ptxas's registers, stack
    and spills of the form's K4 and K5 instantiations (none may spill);
    :func:`grid_form_readings` on ``grid`` (the bake phase's table) with its
    bars and times. Returns the kernels line's K4 and K5 entries (512x512,
    K5 at the fit's target)."""
    from bsdmg_tpu_torch.ops.cuda import diff_kernel as dk

    start = time.perf_counter()
    rows = kernel_resources("diff_kernel.cu", (f"march_params_kernel<{GRID_FORM}",
                                               f"loss_march_kernel<{GRID_FORM}",
                                               f"loss_tangent_form_kernel<{GRID_FORM}"))
    for r in rows:
        print(f"  ptxas: {r['kernel']}: {r['registers']} registers, {r['stack']} B stack, "
              f"{r['spill_stores']} B spill stores, {r['spill_loads']} B spill loads")
    check(len(rows) == 4 and not any(r["spill_stores"] or r["spill_loads"] for r in rows),
          f"the {GRID_FORM} instantiations of K4 and K5 are not 4 without spills: {rows}")
    counts, messages, seconds = asset_cli(["fit", "--image", "--scene", f"mesh:{obj}",
                                           "--perturb", "grid=1.1"])
    losses = step_losses(messages)
    print(f"grid form: cli fit --image --scene mesh:<torus> (128^3, 64x64, {FIT_STEPS} steps) "
          f"in {seconds:.2f} s, launches {launched(counts)}, logged losses {losses}")
    check(counts["K4"] == 1 and counts["K5"] == FIT_STEPS,
          f"fit --image --scene mesh: launched K4 {counts['K4']} and K5 {counts['K5']} times")
    check(len(losses) == 7 and all(abs(v) <= GRID_FIT_LOSS for v in losses),
          f"fit --image --scene mesh: losses {losses}")
    readings = grid_form_readings(grid_scene(grid), device, timed=True)
    print(f"grid form ({GRID_FORM}) K4 and K5 on the torus's 128^3 bake from {TORUS_CAMERA} on "
          f"{card}: {json.dumps(readings, default=str)}")
    failed = grid_form_failed(readings)
    check(not failed, f"K4 or K5 in the grid form fails its bars: {failed}")
    res = readings[512]
    k5_err = max(k5["abs_err"] for r in readings.values() for k5 in r["k5"].values())
    print(f"grid form: the phase in {time.perf_counter() - start:.1f} s")
    common = {"route": "cuda", "source": dk.SOURCE, "library_ms": None}
    return [{"name": f"K4 march_params_kernel<{GRID_FORM}> (mesh asset, 512x512)",
             "replaces": "bsdmg_tpu/ops/pallas/diff_kernel.py:60", "launches": counts["K4"],
             "max_abs_err": max(r["dfdt_err"] for r in readings.values()), "ms": res["K4 ms"],
             "plain_ms": res["K4 plain ms"], "bound_ms": res["K4 bound"][0],
             "bound_by": res["K4 bound"][1], **common},
            {"name": f"K5 loss_march_kernel<{GRID_FORM}> + loss_tangent_form_kernel<{GRID_FORM}> "
                     "+ loss_grad_sum (mesh asset, 512x512, fit point)",
             "replaces": "bsdmg_tpu/ops/pallas/diff_kernel.py:232", "launches": counts["K5"],
             "max_abs_err": k5_err, "ms": res["K5 ms"], "plain_ms": res["K5 plain ms"],
             "bound_ms": res["K5 bound"][0], "bound_by": res["K5 bound"][1], **common}]


def planted_copy(tmp: Path, name: str, path: str, old: str, new: str,
                 built: bool = False) -> Path:
    """A copy of the port's tree (this file, ``tools/``, ``examples/`` and
    ``bsdmg_tpu_torch/`` without its builds, or with ``built`` its
    ``_build`` too, so that only the sources that include the planted file
    build again) in ``tmp``, ``old`` replaced by ``new`` in ``path``
    (where it stands once)."""
    copy = tmp / name.replace(" ", "_").replace("'", "")
    copy.mkdir()
    shutil.copy2(ROOT / "chip_smoke.py", copy)
    shutil.copytree(ROOT / "tools", copy / "tools")
    shutil.copytree(ROOT / "examples", copy / "examples")
    skip = ("__pycache__",) if built else ("__pycache__", "_build")
    shutil.copytree(ROOT / "bsdmg_tpu_torch", copy / "bsdmg_tpu_torch",
                    ignore=shutil.ignore_patterns(*skip))
    source = (copy / path).read_text()
    check(source.count(old) == 1, f"fault {name}: the line is not in {path} once")
    (copy / path).write_text(source.replace(old, new))
    return copy


def faulted_copies(faults: dict, command, timeout: float = 900):
    """For each ``name: (path, old, new)`` of ``faults``: a planted copy
    (:func:`planted_copy`) in a temporary directory and ``command`` run from
    the copy's root; yields ``(name, the completed process)``. The checkout
    does not change."""
    with tempfile.TemporaryDirectory() as tmp:
        for name, (path, old, new) in faults.items():
            copy = planted_copy(Path(tmp), name, path, old, new)
            yield name, subprocess.run(command, cwd=copy, capture_output=True, text=True,
                                       timeout=timeout)


class FaultBuilds:
    """Planted copies (:func:`planted_copy` with the checkout's build) whose
    kernels build in the background from the start, while the other phases
    run; :meth:`run` then runs a command from each copy, and :meth:`close`
    stops what is left and removes the copies."""

    def __init__(self, faults: dict):
        self.tmp = Path(tempfile.mkdtemp(prefix="bsdmg_faults_"))
        self.copies, self.builds = {}, {}
        for name, (path, old, new) in faults.items():
            copy = planted_copy(self.tmp, name, path, old, new, built=True)
            self.copies[name] = copy
            self.builds[name] = subprocess.Popen(
                [sys.executable, "-c", "from bsdmg_tpu_torch.ops.cuda import build; build.build()"],
                cwd=copy, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def run(self, command, timeout: float = 600):
        """Yields ``(name, the completed process)`` of ``command(name)`` from
        each copy once its build has ended (raising where it failed)."""
        for name, copy in self.copies.items():
            _, err = self.builds[name].communicate(timeout=timeout)
            check(self.builds[name].returncode == 0, f"fault {name}: the build failed: {err[-2000:]}")
            yield name, subprocess.run(command(name), cwd=copy, capture_output=True, text=True,
                                       timeout=timeout)

    def close(self) -> None:
        for proc in self.builds.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(self.tmp, ignore_errors=True)


#: the planted faults of K5's reverse sweep (csrc/param_program.cuh), each
#: with the scene whose K5 bars it must fail: SMOOTH's parameter adjoint
#: dropped, which the snowman's smooth union's k reaches; the wrap's cell
#: adjoint without the quotient's term (0 for a point in the centre cell),
#: which the wrapped object's hits in the cells beside it reach
REVERSE_FAULTS = {
    "SMOOTH's parameter adjoint dropped": (
        "bsdmg_tpu_torch/csrc/param_program.cuh",
        "  if (op == OP_SMOOTH) adj.add(prm.s0, PT::dpsi(r, 2, ob));\n", ""),
    "the wrap's cell adjoint without its quotient": (
        "bsdmg_tpu_torch/csrc/param_program.cuh",
        "adj.add(s0 + a, adj_value(cb[a]) * (-0.5f + (0.5f + k)));",
        "adj.add(s0 + a, adj_value(cb[a]) * (-0.5f + 0.5f));"),
}
REVERSE_FAULT_SCENES = {"SMOOTH's parameter adjoint dropped": "snowman",
                        "the wrap's cell adjoint without its quotient": "wrapped_object"}


def reverse_fault_readings(device, name: str) -> dict:
    """K5 against its plain version (edge term on) on the fit start of
    scene ``name`` of FIT_SCENES at 64x64 and 512x512: the loss's relative
    error and the gradient's excess over the bars, per size."""
    from bsdmg_tpu_torch import cli
    from bsdmg_tpu_torch.grad import render_image_diff
    from bsdmg_tpu_torch.ops.cuda import diff_kernel as dk
    from bsdmg_tpu_torch.ops.cuda.csdf import scene_bounds

    example = ROOT / "examples" / f"{name}.json"
    scene = cli._get_scene(str(example) if example.exists() else name, device)
    true = dict(scene.params)
    start = cli._apply_perturb(true, cli._parse_perturb(FIT_SCENES[name][0]))
    bounds = scene_bounds(scene)
    bb = None if bounds is None else inflated(bounds, 0.6)
    out = {}
    for size in (64, 512):
        o, d, c = rays(size, size, device)
        target = render_image_diff(scene.sdf, true, o, d, c, csdf=scene.csdf, bb=bb).detach()
        k5 = dk.render_loss_grad_cuda(scene.csdf, start, target, o, d, c, bb=bb, edge_weight=1.0)
        p5 = dk.render_loss_grad_torch(scene.csdf, start, target, o, d, c, bb=bb, edge_weight=1.0)
        out[size] = {"loss_rel_err": abs(k5[0].item() - p5[0].item()) / abs(p5[0].item()),
                     "excess_over_bars": k5_excess(k5[1], p5[1])}
    return out


def reverse_fault_bars(name: str) -> None:
    """Prints :func:`reverse_fault_readings` of scene ``name`` as JSON from
    this tree's kernels, built anew (run from a planted copy's root by
    :func:`reverse_faults`)."""
    from bsdmg_tpu_torch.ops.cuda import build

    build.build()
    print(json.dumps(reverse_fault_readings(torch.device("cuda", 0), name)))


def reverse_faults(card: str, device, builds: FaultBuilds) -> None:
    """K5's bars on each scene of REVERSE_FAULT_SCENES from this tree and
    from each planted copy of REVERSE_FAULTS on its scene (built in the
    background since the start): the sound tree must hold them, each fault
    fail them."""
    def failed(out: dict) -> bool:
        return any(not (r["loss_rel_err"] <= LOSS_RTOL and r["excess_over_bars"] <= 0)
                   for r in out.values())

    for scene in sorted(set(REVERSE_FAULT_SCENES.values())):
        bars = reverse_fault_readings(device, scene)
        print(f"reverse faults on {card}: the sound tree's K5 on {scene}: {json.dumps(bars)}")
        check(not failed(bars), f"the sound tree fails K5's bars on {scene}: {bars}")
    for name, out in builds.run(lambda fault: [
            sys.executable, "-c",
            f"import chip_smoke; chip_smoke.reverse_fault_bars({REVERSE_FAULT_SCENES[fault]!r})"]):
        scene = REVERSE_FAULT_SCENES[name]
        bars = json.loads(out.stdout.strip().splitlines()[-1]) if out.returncode == 0 else None
        print(f"reverse faults on {card}: {name}: K5 on {scene} {json.dumps(bars)}; "
              f"{out.stderr.strip()[-600:]}")
        check(bars is not None and failed(bars), f"the fault {name} fails no bar of K5")


def grid_fault_bars() -> None:
    """Prints, as JSON, the bars of :func:`grid_form_readings` that this
    tree's grid form fails on the torus's 128^3 bake, its kernels built
    anew (run from a copy's root by :func:`grid_faults`)."""
    from bsdmg_tpu_torch.ops.cuda import build

    build.build()
    device = torch.device("cuda", 0)
    print(json.dumps(grid_form_failed(grid_form_readings(torus_scene(device), device))))


def grid_faults(device) -> None:
    """``--grid-faults``: :func:`grid_form_readings` on the torus's 128^3
    bake from this tree and from a copy per GRID_FAULTS fault (each built
    anew, :func:`faulted_copies`), with the bars each fails: the sound tree
    must fail none, each fault at least one."""
    sound = grid_form_failed(grid_form_readings(torus_scene(device), device))
    print(f"grid faults: the sound tree fails {sound}")
    check(not sound, f"the sound tree fails {sound}")
    command = [sys.executable, "-c", "import chip_smoke; chip_smoke.grid_fault_bars()"]
    for name, out in faulted_copies(GRID_FAULTS, command):
        failed = json.loads(out.stdout.strip().splitlines()[-1]) if out.returncode == 0 else None
        print(f"grid faults: {name} fails {failed}; {out.stderr.strip()[-600:]}")
        check(bool(failed), f"the fault {name} fails no bar")


def grid_scene(grid):
    """A baked ``grid`` as ``cli fit --scene mesh:`` fits it: its table the
    one parameter, its component form :class:`GridCsdf`, which reads none."""
    from bsdmg_tpu_torch.models.mesh_sdf import GridCsdf
    from bsdmg_tpu_torch.models.scenes import Scene

    return Scene("mesh", lambda params, p: None, {"grid": grid.values}, csdf=GridCsdf(grid),
                 grid=grid)


def torus_scene(device):
    """tools/make_torus.py's torus at its 128^3 bake, as :func:`grid_scene`."""
    return grid_scene(torus_grid(device, TORUS_RESOLUTION))


ROOFLINE_SECTIONS = ("refine_roofline", "mc_roofline")


def roofline_phase(card: str) -> None:
    """18. ``cli bench --roofline --which all`` at the JAX bench's points:
    each section with the JAX CLI's keys; the refine and MC rooflines'
    share of the speed of light (the MC one's lanes K6's voxels, each
    charged its crossing edges' Newton steps, counted by K6's twin,
    ``bench.mc_step_stats``, and its planes once); K1, K6 and K5
    launched."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        counts, _, seconds = run_cli(["bench", "--which", "all", "--roofline"])
    res = json.loads(out.getvalue())
    print(f"cli bench --roofline --which all on {card} in {seconds:.1f} s, launches "
          f"{launched(counts)}: {json.dumps(res)}")
    check(all(counts[k] for k in ("K1", "K6", "K5")), f"bench --which all launched {counts}")
    for key in ROOFLINE_SECTIONS:
        share = res[key]["pct_of_roofline"]
        check(share is not None and 0 < share, f"{key}: pct_of_roofline {share}")


# ---------------------------------------------------------------------------
# the multi-device paths: bsdmg_tpu_torch/parallel/
# ---------------------------------------------------------------------------

#: two ranks on the one card: NCCL takes one rank a device, so they run gloo
PARALLEL_RANKS = 2
PARALLEL_MODES = (False, True, "block")
PARALLEL_MESH_LEVELS = (3, 5)
#: the fused step at the JAX package's training point, the other at the fit's
FUSED_STEP_SIZE = 512
DIFF_STEP_SIZE = 64
STEP_LR = 1e-2
#: the sharded step's all-reduced gradient against the unsharded gradient,
#: relative to the latter's norm
STEP_GRAD_REL = 1e-5
SPAWN_SECONDS = 300.0
#: the torus OBJ's grid, as `cli render --scene mesh:<torus>:128` bakes it
TORUS_RESOLUTION = 128
#: benchmark_scaling_overhead's frame, its default
PROXY_SIZE = (256, 256)
_GATHER = {"all_gather": 1, "all_reduce": 0}
#: each sharded path of the ranks: the kernels it must launch, its collectives
PARALLEL_EXPECTED = {
    "frame two_phase=False": (("K1",), _GATHER),
    "frame two_phase=True": (("K2", "K3"), _GATHER),
    "frame two_phase=block": (("K1",), _GATHER),
    "torus grid frame": (("K9", "K8", "P1"), _GATHER),
    **{f"mesh level {lv}": (("K6",), {"all_gather": 2, "all_reduce": 0})
       for lv in PARALLEL_MESH_LEVELS},
    f"train_step_fused {FUSED_STEP_SIZE}x{FUSED_STEP_SIZE}": (("K5",),
                                                             {"all_gather": 0, "all_reduce": 1}),
    f"train_step {DIFF_STEP_SIZE}x{DIFF_STEP_SIZE}": (("K4",), {"all_gather": 0, "all_reduce": 1}),
}


def launch_counts() -> dict:
    """Every kernel's launch count now; ``"K1 split"`` and the like count
    the near/far split's instantiations, whose launches ``"K1"`` and the
    like count too."""
    from bsdmg_tpu_torch.ops.cuda import (
        bake_kernel,
        diff_kernel,
        grid_kernel,
        mc_kernel,
        mesh_kernel,
        render_kernel,
    )

    return {"K1": render_kernel.LAUNCHES, "K2": render_kernel.TRACE_LAUNCHES,
            "K3": render_kernel.SHADE_LAUNCHES,
            "K4": diff_kernel.MARCH_LAUNCHES, "K5": diff_kernel.LOSS_GRAD_LAUNCHES,
            "K6": mc_kernel.LAUNCHES, "K7": mesh_kernel.LAUNCHES, **grid_kernel.LAUNCHES,
            "bake": bake_kernel.LAUNCHES,
            **{f"{k} split": render_kernel.SPLIT_LAUNCHES[k] for k in ("K1", "K2")},
            **{f"{k} split": diff_kernel.SPLIT_LAUNCHES[k] for k in ("K4", "K5")}}


def launched(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_path(fn, device) -> tuple:
    """``(result, seconds, launches, collectives)`` of one call of ``fn``
    with every launch and collective count set to 0 just before it."""
    from bsdmg_tpu_torch.parallel import collectives

    reset_launches()
    collectives.reset()
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0, launched(launch_counts()), dict(collectives.COLLECTIVES)


def host_ms(fn, device, runs: int = 7, warmup: int = 2) -> float:
    """Median host-clock ms of ``fn()`` ended by a sync: a gloo collective
    waits on the host, where CUDA events do not see it."""
    for _ in range(warmup):
        fn()
    sync(device)
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def frame_costs(mesh, device, frame) -> dict:
    """What sharding adds to the reference scene's frame: the sharded and
    the unsharded frame, and the frame's ``all_gather`` alone (each rank's
    bands as one RGB buffer), host ms."""
    from bsdmg_tpu_torch.models import reference_render_scene
    from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene
    from bsdmg_tpu_torch.ops.cuda.render_kernel import render_image_cuda
    from bsdmg_tpu_torch.parallel import render_sharded_pallas
    from bsdmg_tpu_torch.parallel.collectives import all_gather
    from bsdmg_tpu_torch.parallel.sharding import band_rows

    desc = compile_scene(reference_render_scene(device=device))
    o, d, c = rays(*frame, device)
    bands = torch.zeros((band_rows(frame[1], mesh.size(), 0, device).numel(), frame[0], 3),
                        device=device)
    return {"sharded_ms": host_ms(lambda: render_sharded_pallas(desc, o, d, c, mesh), device),
            "unsharded_ms": host_ms(lambda: render_image_cuda(desc, o, d, c), device),
            "all_gather_ms": host_ms(lambda: all_gather(bands), device)}


def sorted_rows(v: np.ndarray) -> np.ndarray:
    return v[np.lexsort(v.T)]


def step_params(scene, fused: bool) -> dict:
    """The parameters a step fits: the fused step's shape parameters (the
    bench's), every parameter through the differentiable render."""
    skip = ("object_center", "object_rotation") if fused else ()
    return {k: v.clone().requires_grad_() for k, v in scene.params.items() if k not in skip}


def step_bounds(scene):
    """The bench's bounds of the fused step: the scene's, 0.25 wider."""
    from bsdmg_tpu_torch.ops.cuda.csdf import scene_bounds

    lo, hi, slack = scene_bounds(scene)
    return tuple(v - 0.25 for v in lo), tuple(v + 0.25 for v in hi), slack


def _stepped(loss, params: dict) -> tuple:
    """``(loss, params, gradients)`` after a step."""
    return (float(loss.detach()), {k: v.detach() for k, v in params.items()},
            {k: v.grad.detach() for k, v in params.items()})


def unsharded_step(scene, fused: bool, size: int, device):
    """One SGD step on the whole frame on one device, no collective:
    ``(loss, params, gradients)``."""
    from bsdmg_tpu_torch.grad import render_image_diff
    from bsdmg_tpu_torch.ops.cuda.diff_kernel import render_loss_grad_cuda

    o, d, c = rays(size, size, device)
    target = torch.zeros((size, size, 3), device=device)
    p = step_params(scene, fused)
    opt = torch.optim.SGD(list(p.values()), lr=STEP_LR)
    if fused:
        loss, grads = render_loss_grad_cuda(scene.csdf, {k: v.detach() for k, v in p.items()},
                                            target, o, d, c, bb=step_bounds(scene))
        for k, g in grads.items():
            p[k].grad = g
    else:
        img = render_image_diff(scene.sdf, p, o, d, c, csdf=scene.csdf)
        loss = torch.mean((img - target) ** 2)
        loss.backward()
    opt.step()
    return _stepped(loss, p)


def sharded_step(scene, mesh, fused: bool, size: int, device):
    """The same step through ``train_step_fused`` (K5) or ``train_step``
    (K4) on this rank's interleaved block: ``(loss, params, gradients)``,
    the gradients as the step's ``all_reduce`` summed them."""
    from bsdmg_tpu_torch.parallel import shard_rays, train_step, train_step_fused
    from bsdmg_tpu_torch.parallel.sharding import shard_image

    o, d, c, _ = shard_rays(*rays(size, size, device), mesh)
    target = shard_image(torch.zeros((size, size, 3), device=device), mesh)
    p = step_params(scene, fused)
    opt = torch.optim.SGD(list(p.values()), lr=STEP_LR)
    if fused:
        _, loss = train_step_fused(scene.csdf, p, opt, target, o, d, c, mesh, bb=step_bounds(scene))
    else:
        _, loss = train_step(scene.sdf, p, opt, target, o, d, c, mesh, csdf=scene.csdf)
    return _stepped(loss, p)


def step_bars(sharded, single) -> dict:
    """A sharded step against the unsharded one: the JAX bars (the loss;
    the parameters after the step), and the all-reduced gradient within
    :data:`STEP_GRAD_REL` of the unsharded gradient's norm. Against a black
    target ``lr * g`` is mostly below the parameter bar, which alone would
    pass a gradient off by a uniform factor."""
    (loss, params, grads), (ref_loss, ref_params, ref_grads) = sharded, single
    excess = max(((params[k] - v).abs() - GRAD_ATOL - GRAD_RTOL * v.abs()).max().item()
                 for k, v in ref_params.items())
    g, ref = (torch.cat([x[k].reshape(-1) for k in ref_grads]) for x in (grads, ref_grads))
    ref_norm = ref.norm().item()
    grad_rel = (g - ref).norm().item() / ref_norm if ref_norm > 0 else math.inf
    jax_bars = abs(loss - ref_loss) <= LOSS_RTOL * abs(ref_loss) and excess <= 0
    return {"loss": loss, "loss_rel": abs(loss - ref_loss) / abs(ref_loss),
            "param_excess": excess, "jax_bars": jax_bars, "grad_norm": ref_norm,
            "grad_rel": grad_rel, "ok": jax_bars and grad_rel <= STEP_GRAD_REL}


def parallel_rank(device, inputs: dict) -> dict:
    """One of :data:`PARALLEL_RANKS` gloo ranks on the one card: each
    sharded path (the frame in every mode, the torus's grid frame, the mesh
    at each level, both steps; sizes from ``inputs``) with its launches,
    collectives and wall time (a second, warm call), held against the
    single-device result on the same card; then the scaling benches."""
    from bsdmg_tpu_torch import bench
    from bsdmg_tpu_torch.models import reference_object, reference_render_scene
    from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene
    from bsdmg_tpu_torch.ops.cuda.grid_kernel import make_contraction_levels, render_image_grid
    from bsdmg_tpu_torch.ops.cuda.render_kernel import render_image_cuda
    from bsdmg_tpu_torch.parallel import (
        generate_mesh_sharded,
        make_mesh,
        render_grid_sharded,
        render_sharded_pallas,
    )
    from bsdmg_tpu_torch.weights import grid_from_numpy

    mesh = make_mesh(device=device, backend="gloo")
    out = {"world": mesh.size(), "paths": {}}

    def path(name, fn, single, compare):
        fn()
        result, seconds, launches, colls = timed_path(fn, device)
        out["paths"][name] = {"seconds": seconds, "launches": launches, "collectives": colls,
                              **compare(result, single())}

    def frames(a, b):
        return {"exact": bool(torch.equal(a, b)), "max_abs_err": (a - b).abs().max().item()}

    scene = reference_render_scene(device=device)
    desc = compile_scene(scene)
    frame = inputs["frame"]
    o, d, c = rays(*frame, device)
    for mode in PARALLEL_MODES:
        path(f"frame two_phase={mode}",
             lambda: render_sharded_pallas(desc, o, d, c, mesh, two_phase=mode),
             lambda: render_image_cuda(desc, o, d, c, two_phase=mode, phase_a_steps=48), frames)

    grid = grid_from_numpy(*inputs["torus"], device)
    levels = make_contraction_levels(grid)
    torus_rays = rays(*frame, device, camera=TORUS_CAMERA)
    path("torus grid frame", lambda: render_grid_sharded(grid, *torus_rays, mesh, levels=levels),
         lambda: render_image_grid(grid, *torus_rays, mode="contraction", levels=levels), frames)

    obj = compile_scene(reference_object(device=device))
    for level, ref in inputs["meshes"].items():

        def same_mesh(m, _):
            err = float(np.abs(sorted_rows(m.vertices) - ref["sorted"]).max())
            return {"triangles": m.triangle_count, "vertices": m.vertex_count,
                    "max_abs_err": err,
                    "ok": (m.triangle_count, m.vertex_count) == ref["counts"] and err <= 1e-6}

        path(f"mesh level {level}", lambda: generate_mesh_sharded(obj, mesh, level, device=device),
             lambda: None, same_mesh)

    for name, fused, size in inputs["steps"]:
        path(f"{name} {size}x{size}", lambda: sharded_step(scene, mesh, fused, size, device),
             lambda: unsharded_step(scene, fused, size, device),
             lambda a, b: {**step_bars(a, b),
                           "params": {k: v.cpu().numpy() for k, v in a[1].items()}})
    out["frame_costs"] = frame_costs(mesh, device, frame)
    out["scaling"] = bench.benchmark_scaling(*frame, device=device)
    out["scaling_proxy"] = bench.benchmark_scaling_overhead(*inputs["proxy"], device=device)
    return out


def world_of_one_phases(tmp: Path, torus: Path, device) -> None:
    """``cli render --sharded`` (reference scene and the torus) and ``cli
    mesh --sharded`` (K6; K7 with ``--interpolate-edges``) in a world of one
    rank on NCCL, each against the unsharded command: the same launches, the
    same image bit for bit, the same counts (the voxels through
    ``refine_field_sharded``); then ``cli bench --which scaling`` and
    ``scaling-proxy``."""
    from bsdmg_tpu_torch.config import MeshGenConfig
    from bsdmg_tpu_torch.mesh.field import create_voxel_field
    from bsdmg_tpu_torch.models import reference_object
    from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene
    from bsdmg_tpu_torch.parallel import (
        collectives,
        distribute_field,
        make_mesh,
        refine_field_sharded,
    )

    size = ["--width", str(SCENE_FRAME[0]), "--height", str(SCENE_FRAME[1])]
    renders = {"reference": size, "torus": [*size, "--scene", f"mesh:{torus}:{TORUS_RESOLUTION}",
                                            "--camera", *map(str, TORUS_CAMERA)]}
    for name, extra in renders.items():
        images = {}
        for sharded in (False, True):
            npy = tmp / f"{name}_{sharded}.npy"
            collectives.reset()
            counts, _, seconds = run_cli(["render", *(["--sharded"] if sharded else []), *extra,
                                          "-o", str(npy)])
            images[sharded] = (np.load(npy), launched(counts), seconds,
                               dict(collectives.COLLECTIVES))
        (a, la, sa, _), (b, lb, sb, cb) = images[False], images[True]
        print(f"parallel, world of one (NCCL): cli render --sharded {name} {SCENE_FRAME} in "
              f"{sb:.3f} s (unsharded {sa:.3f} s), launches {lb} (unsharded {la}), "
              f"collectives {cb}, bit-equal {np.array_equal(a, b)}")
        check(lb == la, f"render --sharded {name} launched {lb}, the unsharded {la}")
        check(cb == {"all_gather": 1, "all_reduce": 0}, f"render --sharded collectives {cb}")
        check(np.array_equal(a, b), f"render --sharded {name} differs from render")
    for kernel, extra in (("K6", []), ("K7", ["--interpolate-edges"])):
        collectives.reset()
        counts, seconds = run_cli_mesh(kernel, ["--sharded", *extra], tmp / f"sharded_{kernel}.obj",
                                       levels=False)
        colls = dict(collectives.COLLECTIVES)
        print(f"parallel, world of one (NCCL): cli mesh --sharded {' '.join(extra)} in "
              f"{seconds:.2f} s, launches {launched(counts)}, collectives {colls}")
        check(colls == {"all_gather": 2, "all_reduce": 0},
              f"mesh --sharded ran the collectives {colls}, not the triangle gather's two")
    # the CLI logs no level: the voxels of the same pipeline, counted here
    sfield = distribute_field(create_voxel_field(MeshGenConfig(), device), make_mesh(device=device))
    voxels = [sfield.count]
    obj = compile_scene(reference_object(device=device))
    for _ in MESH_LEVEL_VOXELS[1:]:
        sfield = refine_field_sharded(obj, sfield)
        voxels.append(sfield.count)
    print(f"parallel, world of one (NCCL): sharded voxels per level {voxels}")
    check(voxels == MESH_LEVEL_VOXELS, f"sharded voxels {voxels}, not {MESH_LEVEL_VOXELS}")
    for which in ("scaling", "scaling-proxy"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            run_cli(["bench", "--which", which, *size])
        print(f"parallel, world of one (NCCL): cli bench --which {which}: "
              f"{json.dumps(json.loads(out.getvalue()))}")


def parallel_phases(card: str, device) -> None:
    """Phase 16: the multi-device paths (``bsdmg_tpu_torch/parallel/``). In
    this process, a world of one rank on NCCL through the CLI; then
    :data:`PARALLEL_RANKS` gloo ranks sharing the one card, whose frames
    (K1; K2 and K3; block retirement; the torus's K9, K8 and P1) must be
    bit-equal to the single-device frames, whose sharded mesh (K6) must
    have the single-device counts and vertices, and whose steps (K5, K4)
    must meet the JAX bars against the single-device step. Both ranks
    share the card: the times are striping and gathering costs, not
    scaling."""
    import torch.distributed as dist

    from bsdmg_tpu_torch.mesh.pipeline import generate_mesh
    from bsdmg_tpu_torch.models import reference_object, reference_render_scene
    from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene
    from bsdmg_tpu_torch.ops.cuda.grid_kernel import make_contraction_levels, render_image_grid
    from bsdmg_tpu_torch.ops.cuda.render_kernel import render_image_cuda
    from bsdmg_tpu_torch.parallel.launch import spawn

    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        torus = tmp / "torus.obj"
        subprocess.run([sys.executable, str(ROOT / "tools" / "make_torus.py"), str(torus)],
                       capture_output=True, text=True, check=True, timeout=300)
        world_of_one_phases(tmp, torus, device)
    from bsdmg_tpu_torch.parallel import make_mesh

    costs = frame_costs(make_mesh(device=device), device, SCENE_FRAME)
    print(f"parallel, world of one (NCCL): {SCENE_FRAME} frame costs, host ms: {json.dumps(costs)}")
    dist.destroy_process_group()

    grid = torus_grid(device, TORUS_RESOLUTION)
    scene = reference_render_scene(device=device)
    desc = compile_scene(scene)
    o, d, c = rays(*SCENE_FRAME, device)
    single_seconds = {}
    for mode in PARALLEL_MODES:
        frame = lambda: render_image_cuda(desc, o, d, c, two_phase=mode, phase_a_steps=48)  # noqa: E731
        frame()
        single_seconds[f"frame two_phase={mode}"] = timed_path(frame, device)[1]
    levels = make_contraction_levels(grid)
    torus_rays = rays(*SCENE_FRAME, device, camera=TORUS_CAMERA)
    grid_frame = lambda: render_image_grid(grid, *torus_rays, mode="contraction", levels=levels)  # noqa: E731
    grid_frame()
    single_seconds["torus grid frame"] = timed_path(grid_frame, device)[1]
    obj = compile_scene(reference_object(device=device))
    meshes = {}
    for level in PARALLEL_MESH_LEVELS:
        m, single_seconds[f"mesh level {level}"], _, _ = timed_path(
            lambda: generate_mesh(obj, level, device=device), device)
        meshes[level] = {"counts": (m.triangle_count, m.vertex_count),
                         "sorted": sorted_rows(m.vertices)}
    steps = (("train_step_fused", True, FUSED_STEP_SIZE), ("train_step", False, DIFF_STEP_SIZE))
    for name, fused, size in steps:
        unsharded_step(scene, fused, size, device)
        single_seconds[f"{name} {size}x{size}"] = timed_path(
            lambda: unsharded_step(scene, fused, size, device), device)[1]
    inputs = {"frame": SCENE_FRAME, "steps": steps, "proxy": PROXY_SIZE, "meshes": meshes,
              "torus": (grid.values.cpu().numpy(), grid.lo, grid.hi)}
    t0 = time.perf_counter()
    results = spawn(parallel_rank, PARALLEL_RANKS, inputs, backend="gloo", device=str(device),
                    timeout=SPAWN_SECONDS)
    print(f"parallel: {PARALLEL_RANKS} gloo ranks on one {card} in {time.perf_counter() - t0:.1f} s "
          "(both share the card: striping and gathering costs, not scaling)")
    for name in results[0]["paths"]:
        rows = [r["paths"][name] for r in results]
        shown = {k: v for k, v in rows[0].items() if k != "params"}
        print(f"parallel, {PARALLEL_RANKS} ranks: {name}: rank 0 {json.dumps(shown)}; "
              f"rank 1 {rows[1]['seconds']:.4f} s; unsharded "
              f"{single_seconds[name]:.4f} s")
        for rank, row in enumerate(rows):
            check(row.get("exact", True) and row.get("ok", True),
                  f"rank {rank}: {name} differs from the single-device path: {row}")
            check(row["launches"], f"rank {rank}: {name} launched no kernel")
        if "params" in rows[0]:
            check(all(np.array_equal(v, rows[1]["params"][k]) for k, v in rows[0]["params"].items()),
                  f"{name}: the ranks' parameters differ")
    for name, row in results[0]["paths"].items():
        kernels, colls = PARALLEL_EXPECTED[name]
        check(all(row["launches"].get(k) for k in kernels), f"{name} launched {row['launches']}")
        check(row["collectives"] == colls, f"{name} ran the collectives {row['collectives']}")
    for key in ("frame_costs", "scaling", "scaling_proxy"):
        print(f"parallel, {PARALLEL_RANKS} ranks: {key} {json.dumps(results[0][key])}")
    print(f"parallel: every phase passed in {time.perf_counter() - start:.1f} s")


# ---------------------------------------------------------------------------
# the near/far split (K1, K2, K4, K5), and exact stepping at any relaxation
# (K4, K8)
# ---------------------------------------------------------------------------

#: each pipeline of render_image_cuda, and the launches of one frame
SPLIT_PIPELINES = {"fused": ({}, {"K1": 1, "K1 split": 1}),
                   "block": ({"two_phase": "block"}, {"K1": 2, "K1 split": 2}),
                   "row": ({"two_phase": True}, {"K2": 2, "K2 split": 2, "K3": 1}),
                   "unfused": ({"swizzle": False}, {"K2": 1, "K2 split": 1, "K3": 1})}
#: the frames of the render pipelines with the split
SPLIT_FRAMES = (SCENE_FRAME, (2560, 1440))
#: the split's kernels whose SASS loops the split phase prints
SPLIT_SASS = ("render_split_kernel<Box<true, false>, true, false, 0>",
              "trace_split_kernel<Box<true, false>, true, false, false>")
#: K4's and K5's points: the JAX bench's grad cell at 512x512 (bounds and
#: near box inflated by 0.25, a black target, no edge term) and the CLI's
#: fit at 64x64 (by 0.6, the render at the true parameters, the edge term)
SPLIT_POINTS = {"bench": (512, 0.25, 0.0), "fit": (64, 0.6, 1.0)}


def split_probe():
    """``tools/split_probe.py`` as a module: its statistics of the split's
    warp work (``frame_stats``, ``tail_stats``)."""
    spec = importlib.util.spec_from_file_location("split_probe", ROOT / "tools" / "split_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def split_bars(rgb, unsplit) -> dict:
    """The JAX package's bars of a split render against the frame without
    the split (tests/test_pallas.py:320-323): max |drgb| > 1e-3 on fewer
    than 0.1% of the pixels, the mean below 1e-5."""
    diff = (rgb - unsplit).abs().amax(dim=-1)
    out = {"share_over_1e-3": (diff > 1e-3).float().mean().item(), "mean": diff.mean().item()}
    check(out["share_over_1e-3"] < 1e-3 and out["mean"] < 1e-5,
          f"the split's frame outside JAX's bars of the frame without it: {out}")
    return out


def split_work(rk, bounds, split, o, d, c, planes, cfg) -> tuple[dict, dict]:
    """The march work (:func:`march_work`) of the far patches' rays and of
    the others', the far ones grouped as the kernels group them (the rays
    culled by ``bounds`` take no part)."""
    flat = rk._flat_rays(o, d, c)
    miss, _ = rk._slab_cull(bounds, *flat, cfg)
    far = rk.far_rays(split, *flat, cfg, ~miss, rk.patch_groups(*c.shape, c.device))
    depth, steps, outcome = (p.reshape(-1) for p in planes)
    return ({"far": march_work(steps[far], outcome[far], depth[far]),
             "near": march_work(steps[~far], outcome[~far], depth[~far])},
            {"far_rays": int(far.sum()), "rays": far.numel()})


def near_proofs(rk, desc, split, o, d, c, planes, cfg) -> dict:
    """Where the split kernels' near scene leaves the wireframe's term out
    (csrc/scene_sdf.cuh near_sdf, its plain version
    ``render_kernel.frame_beyond_torch`` with the object's value): the near
    patches' march replayed on the twin from a fresh state, each
    evaluation's point tested, and each near hit's 12 stencil points. The
    near evaluations and stencil points and those proved; whether the
    replay's depth and steps are K1 · split's ``planes``' (depth, steps,
    outcome) at every near ray."""
    from bsdmg_tpu_torch.ops.cuda.csdf import descriptor_csdf

    full = descriptor_csdf(desc)
    obj = descriptor_csdf(dataclasses.replace(desc, frame=None))

    def counted(tally):
        def csdf(x, y, z):
            beyond = rk.frame_beyond_torch(desc.frame, x, y, z, obj(x, y, z))
            tally[0] += x.numel()
            tally[1] += beyond.sum()
            return full(x, y, z)
        return csdf

    flat = rk._flat_rays(o, d, c)
    miss, t_exit = rk._slab_cull(desc.bounds, *flat, cfg)
    near = ~miss & ~rk.far_rays(split, *flat, cfg, ~miss, rk.patch_groups(*c.shape, c.device))
    depth = torch.zeros_like(flat[6])
    march, stencil = [0, torch.zeros((), dtype=torch.long, device=c.device)], [0, 0]
    steps, outcome, *_ = rk._march(counted(march), cfg, *flat, near, depth,
                                   torch.clamp_max(t_exit, cfg.depth_limit))
    hit = (near & (outcome == 0)).nonzero().squeeze(1)
    t = depth[hit]
    rk._fd_normal(counted(stencil), *(flat[a][hit] + t * flat[a + 3][hit] for a in range(3)),
                  cfg.normal_epsilon)
    kernel_depth, kernel_steps = (p.reshape(-1)[near] for p in planes[:2])
    return {"near_evaluations": march[0], "proved_evaluations": int(march[1]),
            "near_stencil_points": stencil[0], "proved_stencil_points": int(stencil[1]),
            "replay_equal": bool(torch.equal(depth[near], kernel_depth)
                                 and torch.equal(steps[near], kernel_steps))}


def split_phases(card: str, device, main_launches: dict) -> list[dict]:
    """The near/far split (``compile_scene_split``) of the reference render
    scene: ptxas and the SASS loops of its K1 and K2; at each of
    SPLIT_FRAMES each pipeline of ``render_image_cuda`` (K1; K1 twice; K2,
    K2 over the listed tail, K3; K2 and K3) with the split against the
    twins composed alike (bit for bit) and within the JAX package's bars of
    the frame without it; at SCENE_FRAME what sets their warp work
    (``tools/split_probe.py`` frame_stats: far patches, warp-steps, hits per
    warp; the row tail after each of PHASE_A_STEPS, its listed launch alone
    and tail_stats), the fused image against the row pipeline's (equal but
    possibly at far hits, which K3 shades with the full scene); K1 and K2
    alone with and without the split at SPLIT_FRAMES (CUDA graphs of 20),
    with their bounds from this run's work (the far patches' evaluations
    and hits at the wireframe's counts); K4 and
    K5 with the split at SPLIT_POINTS against their twins (K4 bit-equal but
    dfdt, within DFDT_ATOL; K5 within the bars, two calls the same bits)
    and alone with and without it. Returns the kernels line's entries of
    the split instantiations, their launches those of the main path's runs
    in ``main_launches`` (``cli render``: K1; ``cli bench --two-phase
    row``: K2; ``cli fit --image``: K5) or, for K4, which no command
    launches with the split, those of ``march_params_cuda(..., split=)``."""
    from bsdmg_tpu_torch import cli
    from bsdmg_tpu_torch.config import MarchConfig
    from bsdmg_tpu_torch.grad import render_image_diff
    from bsdmg_tpu_torch.models import reference_render_scene
    from bsdmg_tpu_torch.ops.cuda import build
    from bsdmg_tpu_torch.ops.cuda import diff_kernel as dk
    from bsdmg_tpu_torch.ops.cuda import render_kernel as rk
    from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene, compile_scene_split, scene_bounds
    from bsdmg_tpu_torch.utils import profiling

    cfg = MarchConfig()
    scene = reference_render_scene(device=device)
    desc, split = compile_scene(scene), compile_scene_split(scene)
    probe = split_probe()
    for r in (kernel_resources("render_split.cu", ("render_split_kernel<", "trace_split_kernel<"))
              + kernel_resources("diff_split.cu", ("march_params_split_kernel<",
                                                   "loss_march_split_kernel<"))):
        print(f"  ptxas: {r['kernel']}: {r['registers']} registers, {r['stack']} B stack, "
              f"{r['spill_stores']} B spill stores, {r['spill_loads']} B spill loads")
    for name in SPLIT_SASS:
        print(f"split SASS loops of {name} (static instructions, MUFU; the march steps first, "
              f"Far's with one MUFU): {json.dumps(sass_loops(build.build(), name))}")
    res, launches = {}, {}
    for size in SPLIT_FRAMES:
        o, d, c = rays(*size, device)
        twins = {}
        for name, (kw, want) in SPLIT_PIPELINES.items():
            reset_launches()
            kernel = rk.render_image_cuda(desc, o, d, c, return_planes=True, split=split, **kw)
            torch.cuda.synchronize()
            launches[name] = launched(launch_counts())
            check(launches[name] == want, f"the {name} pipeline with the split launched "
                                          f"{launches[name]}, not {want}")
            # the fused pipeline's twin (K1's plain version) shades a far
            # patch's hits with the far scene, the unfused one's as K3 does
            two_phase = kw.get("two_phase", False)
            key = (two_phase, name == "fused")
            if key not in twins:
                twins[key] = timed_ms(lambda: twin_pipeline(rk, desc, o, d, c, two_phase=two_phase,
                                                            split=split, fused=key[1]))
            plain = twins[key][0]
            stats = compare(kernel, plain)
            unsplit = rk.render_image_cuda(desc, o, d, c, return_planes=True, **kw)
            label = f"{name} {size[0]}x{size[1]}"
            res[label] = {**split_bars(kernel[0], unsplit[0]), "exact": stats["exact"],
                          "steps": int(kernel[2].sum()), "steps_unsplit": int(unsplit[2].sum()),
                          "outcomes_equal": bool(torch.equal(kernel[3], unsplit[3]))}
            print(f"split {label} pipeline: {json.dumps(res[label])}")
            if size != SCENE_FRAME:
                continue
            if name == "fused":
                k1_err, fused = stats["max_abs_err"], kernel
            if name == "row":
                k2_err, row = _max_err(kernel[1], plain[1]), kernel
        if size == SCENE_FRAME:
            k1_plain, k1_planes = twins[(False, True)][1], fused[1:]
            k2_plain = median_ms(lambda: rk.trace_planes_torch(desc, o, d, c, split=split),
                                 runs=1, warmup=0)
            scene_rays = (o, d, c)
    o, d, c = scene_rays
    npix = c.numel()

    # what sets the kernels' warp work, and the fused image against the row
    # pipeline's (K3 shades a far patch's hits with the full scene)
    stats = probe.frame_stats(rk, desc, split, o, d, c, k1_planes, cfg)
    flat = rk._flat_rays(o, d, c)
    miss, _ = rk._slab_cull(desc.bounds, *flat, cfg)
    far_hit = (fused[3] == 0).reshape(-1) & rk.far_rays(split, *flat, cfg, ~miss,
                                                        rk.patch_groups(*c.shape, c.device))
    differ = (fused[0] != row[0]).any(dim=-1).reshape(-1)
    stats["fused_vs_row_differing_far_hits"] = int((differ & far_hit).sum())
    stats["fused_vs_row_differing_other_pixels"] = int((differ & ~far_hit).sum())
    print(f"split frame {SCENE_FRAME}: {json.dumps(stats)}")
    check(stats["fused_vs_row_differing_other_pixels"] == 0,
          f"the fused and the row images differ beyond far patches' hits: {stats}")

    # the row tail after phase A, listed in patch order (tail_list): the
    # listed launch alone from phase A's state (split_probe.listed_tail_ms)
    # and its warps
    split_c = rk.scene_desc_c(desc, cfg, device, split)
    frame = rk._Frame(desc, o, d, c, cfg, True, 1.0, split)
    tails = {}
    for n in PHASE_A_STEPS:
        phase_a = frame.trace(n)
        listed = rk.tail_list(phase_a[3], split)
        ms, final = probe.listed_tail_ms(graph_ms, rk, split_c, (o, d, c), phase_a, listed,
                                         cfg.step_limit)
        index = listed[0][:int(listed[1].item())].long()
        tails[n] = {"ms": ms, **probe.tail_stats(rk, split, o, d, c, phase_a, final, index, cfg)}
    print(f"split row tails on {card} (patch order): {json.dumps(tails)}")

    # alone, from prepared structs, with and without the split; the bounds
    # charge a near evaluation or stencil point where frame_beyond proves
    # the wireframe's term larger at the object's count and the bound's
    work, rays_of = split_work(rk, desc.bounds, split, o, d, c, k1_planes, cfg)
    (ef, af, hf), (en, an, hn) = work["far"], work["near"]
    proofs = near_proofs(rk, desc, split, o, d, c, k1_planes, cfg)
    check(proofs["replay_equal"], f"the near patches' replayed march differs from K1 · split's "
                                  f"planes: {proofs}")
    far = split[0]
    k1_rest = march_ops(far, ef, af, 0) + hf * profiling.shade_ops(far) + npix * profiling.RAY
    k1_bound = bound(render_bytes(npix), k1_rest
                     + profiling.near_march_ops(desc, en, an, proofs["proved_evaluations"])
                     + profiling.near_shade_ops(desc, hn, proofs["proved_stencil_points"]))
    k1_full = bound(render_bytes(npix), k1_rest + march_ops(desc, en, an, 0)
                    + hn * profiling.shade_ops(desc))
    k2_far = march_ops(far, ef, af, npix)
    k2_bound = bound(trace_bytes(npix), k2_far
                     + profiling.near_march_ops(desc, en, an, proofs["proved_evaluations"]))
    k2_full = bound(trace_bytes(npix), k2_far + march_ops(desc, en, an, 0))
    print(f"split near proofs {SCENE_FRAME}: {json.dumps(proofs)}; K1 bound {k1_bound[0]:.4f} ms "
          f"({k1_bound[1]}), {k1_full[0]:.4f} with every near evaluation and stencil point at "
          f"the full scene's count; K2 bound {k2_bound[0]:.4f} ms ({k2_bound[1]}), "
          f"{k2_full[0]:.4f} so")
    alone = {}
    for size in SPLIT_FRAMES:
        so, sd, sc = rays(*size, device)
        rgb = torch.empty((*sc.shape, 3), device=device)
        planes = tuple(torch.empty_like(sc, dtype=t)
                       for t in (torch.float32, torch.int32, torch.int32))
        for label, sp in (("split", split), ("unsplit", None)):
            desc_c = rk.scene_desc_c(desc, cfg, device, sp)
            key = f"{label} {size[0]}x{size[1]}"
            alone[f"K1 {key}"] = graph_ms(lambda: rk._render_cuda(desc_c, so, sd, sc, rgb, None,
                                                                  cap=cfg.step_limit))
            alone[f"K2 {key}"] = graph_ms(lambda: rk._trace_cuda(desc_c, so, sd, sc, None, planes,
                                                                 cap=cfg.step_limit))
    frame_key = f"{SCENE_FRAME[0]}x{SCENE_FRAME[1]}"
    print(f"split alone on {card}: {json.dumps(alone)}; {rays_of['far_rays']} of "
          f"{rays_of['rays']} rays in far patches; evaluations far {ef}, near {en}; hits far {hf}, "
          f"near {hn}; K1 bound {k1_bound[0]:.4f} ms ({k1_bound[1]}), K2 bound {k2_bound[0]:.4f} "
          f"ms ({k2_bound[1]}); plain K1 {k1_plain:.1f} ms, K2 {k2_plain:.1f} ms")

    # K4 and K5 with the split
    true = shape_params(scene)
    diff, rows = {}, {}
    for point, (size, by, edge) in SPLIT_POINTS.items():
        o, d, c = rays(size, size, device)
        n = c.numel()
        bb = inflated(scene_bounds(scene), by)
        sp = (split[0], inflated(split[1], by))
        params = true if point == "bench" else cli._apply_perturb(true, FIT_PERTURB)
        target = (torch.zeros((size, size, 3), device=device) if point == "bench" else
                  render_image_diff(scene.sdf, true, o, d, c, csdf=scene.csdf, bb=bb).detach())
        reset_launches()
        k4 = dk.march_params_cuda(scene.csdf, params, o, d, c, bb=bb, track_min=bool(edge),
                                  split=sp)
        k5 = dk.render_loss_grad_cuda(scene.csdf, params, target, o, d, c, bb=bb,
                                      edge_weight=edge, split=sp)
        counts = launched(launch_counts())
        check(counts == {"K4": 1, "K5": 1, "K4 split": 1, "K5 split": 1},
              f"K4/K5 with the split launched {counts}")
        if point == "bench":
            k4_launches = counts["K4 split"]
        again = dk.render_loss_grad_cuda(scene.csdf, params, target, o, d, c, bb=bb,
                                         edge_weight=edge, split=sp)
        p4, p4_ms = timed_ms(lambda: dk.march_params_torch(scene.csdf, params, o, d, c, bb=bb,
                                                           track_min=bool(edge), split=sp))
        p5, p5_ms = timed_ms(lambda: dk.render_loss_grad_torch(scene.csdf, params, target, o, d, c,
                                                               bb=bb, edge_weight=edge, split=sp))
        u4 = dk.march_params_cuda(scene.csdf, params, o, d, c, bb=bb, track_min=bool(edge))
        torch.cuda.synchronize()
        hit = u4[2] == 0
        out = {
            "K4 exact": {k: bool(torch.equal(k4[i], p4[i])) for i, k in enumerate(
                ("depth", "steps", "outcome", "dfdt", "min_m", "t_min")[:len(k4)])},
            "K4 dfdt max err": _max_err(k4[3], p4[3]),
            "K4 outcomes = unsplit": bool(torch.equal(k4[2], u4[2])),
            "K4 hit depth vs unsplit": (k4[0] - u4[0]).abs()[hit].max().item(),
            "K5 loss": k5[0].item(), "K5 plain loss": p5[0].item(),
            "K5 loss rel err": abs(k5[0].item() - p5[0].item()) / max(abs(p5[0].item()), 1e-30),
            "K5 excess over bars": k5_excess(k5[1], p5[1]),
            "K5 grad max abs err": max(_max_err(k5[1][k], p5[1][k]) for k in k5[1]),
            "K5 reproducible": bool(torch.equal(k5[0], again[0]) and all(
                torch.equal(k5[1][k], again[1][k]) for k in k5[1])),
        }
        print(f"split K4/K5 {point} point ({size}x{size}): {json.dumps(out)}")
        check(all(v for k, v in out["K4 exact"].items() if k != "dfdt"),
              f"K4 with the split is not bit-equal to its plain version: {out}")
        check(out["K4 dfdt max err"] <= DFDT_ATOL, f"K4 with the split, dfdt: {out}")
        check(out["K4 outcomes = unsplit"]
              and out["K4 hit depth vs unsplit"] <= cfg.collision_distance,
              f"K4 with the split against it without: {out}")
        check(out["K5 loss rel err"] <= LOSS_RTOL and out["K5 excess over bars"] <= 0
              and out["K5 reproducible"], f"K5 with the split outside the bars: {out}")
        diff[point] = out
        # alone, with and without the split, and the bounds of this work
        state = dk._target_state(target, None).contiguous() if edge else None
        band = dk._band(cfg, None)
        for label, s_ in (("split", sp), ("unsplit", None)):
            scene_c, _ = dk.param_scene_c(scene.csdf, params, bb=bb, device=device, split=s_)
            rows[(point, label, "K4")] = graph_ms(lambda: dk._march_cuda(scene_c, o, d, c, False))
            rows[(point, label, "K5")] = graph_ms(
                lambda: dk._loss_grad_cuda(scene_c, o, d, c, target, state, n, edge, band))
        # the bounds of this work: the far patches' evaluations and dfdt at
        # the wireframe's counts (the skeleton and its backward)
        work, rays_of = split_work(rk, bb, sp, o, d, c, k4[:3], cfg)
        (ef, af, hf), (en, an, hn) = work["far"], work["near"]
        nf, track = rays_of["far_rays"], bool(edge)
        far_sdf, far_grad = profiling.SKELETON, profiling.SKELETON + profiling.SKELETON_BWD
        full_sdf, full_grad = profiling.param_sdf_ops(True, False), profiling.param_grad_ops(True,
                                                                                             False)
        k4_b = bound(n * (28 + 16), k4_ops(n - nf, en, an, True, False, True, track)
                     + k4_ops(nf, ef, af, True, False, True, track, sdf=far_sdf, grad=far_grad))
        hinges = 0
        if edge:
            from bsdmg_tpu_torch.grad.edge import UNTRACKED, classify_target_miss

            miss, hits = classify_target_miss(target), k4[2] == 0
            hinges = int(((~miss & ~hits & (k4[4] < UNTRACKED)) | (miss & hits)).sum().item())
        k5_b = bound(n * (40 + 4 * track),
                     k5_ops(n, ef + en, af + an, hf + hn, hinges, True, False, track)
                     - ef * (full_sdf - far_sdf) - hf * (full_grad - far_grad))
        rows[(point, "bounds")] = (k4_b, k5_b, p4_ms, p5_ms, rays_of)
        print(f"split alone {point} point ({size}x{size}) on {card}: K4 "
              f"{rows[(point, 'split', 'K4')]:.4f} ms (unsplit {rows[(point, 'unsplit', 'K4')]:.4f}),"
              f" K5 {rows[(point, 'split', 'K5')]:.4f} ms (unsplit "
              f"{rows[(point, 'unsplit', 'K5')]:.4f}); {rays_of['far_rays']} of {rays_of['rays']} "
              f"rays in far patches; bounds K4 {k4_b[0]:.4g} ms ({k4_b[1]}), K5 {k5_b[0]:.4g} ms "
              f"({k5_b[1]}); plain K4 {p4_ms:.2f} ms, K5 {p5_ms:.2f} ms")

    common = {"route": "cuda", "library_ms": None}
    k4_b, k5_b, p4_ms, p5_ms, _ = rows[("bench", "bounds")]
    return [
        {"name": f"K1 render_split_kernel<Box<true, false>> (near/far split, {SCENE_FRAME[0]}x"
                 f"{SCENE_FRAME[1]})", "source": rk.SOURCE,
         "replaces": "bsdmg_tpu/ops/pallas/render_kernel.py:336",
         "launches": main_launches["cli render"]["K1 split"], "max_abs_err": k1_err,
         "ms": alone[f"K1 split {frame_key}"],
         "plain_ms": k1_plain, "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
         "bound_full_scene_near_ms": k1_full[0], **common},
        {"name": f"K2 trace_split_kernel<Box<true, false>> (near/far split, {SCENE_FRAME[0]}x"
                 f"{SCENE_FRAME[1]})", "source": rk.SOURCE,
         "replaces": "bsdmg_tpu/ops/pallas/render_kernel.py:495",
         "launches": main_launches["cli bench --two-phase row"]["K2 split"], "max_abs_err": k2_err,
         "ms": alone[f"K2 split {frame_key}"],
         "plain_ms": k2_plain, "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
         "bound_full_scene_near_ms": k2_full[0], **common},
        {"name": "K4 march_params_split_kernel (near/far split, 512x512; march_params_cuda with "
                 "split=)", "source": dk.SOURCE,
         "replaces": "bsdmg_tpu/ops/pallas/diff_kernel.py:60", "launches": k4_launches,
         "max_abs_err": max(v["K4 dfdt max err"] for v in diff.values()),
         "ms": rows[("bench", "split", "K4")], "plain_ms": p4_ms, "bound_ms": k4_b[0],
         "bound_by": k4_b[1], **common},
        {"name": "K5 loss_march_split_kernel + loss_tangent_kernel + loss_grad_sum (near/far "
                 "split, 512x512)", "source": dk.SOURCE,
         "replaces": "bsdmg_tpu/ops/pallas/diff_kernel.py:232",
         "launches": main_launches["cli fit --image"]["K5 split"],
         "max_abs_err": max(v["K5 grad max abs err"] for v in diff.values()),
         "ms": rows[("bench", "split", "K5")], "plain_ms": p5_ms, "bound_ms": k5_b[0],
         "bound_by": k5_b[1], **common},
    ]


def relaxation_phase(card: str, device) -> None:
    """K4 and K8 step exactly whatever ``config.relaxation`` says, as the
    JAX kernels do: at relaxation 1.5 each is bit-equal to itself at 1.0
    (K4 at 512x512 on the reference scene, K8 on a 64^3 sphere grid at
    960x540)."""
    from bsdmg_tpu_torch.config import MarchConfig
    from bsdmg_tpu_torch.models import reference_render_scene
    from bsdmg_tpu_torch.models.mesh_sdf import SdfGrid
    from bsdmg_tpu_torch.ops.cuda import diff_kernel as dk
    from bsdmg_tpu_torch.ops.cuda import grid_kernel as tg
    from bsdmg_tpu_torch.ops.cuda.csdf import scene_bounds

    relaxed, exact = MarchConfig(relaxation=1.5), MarchConfig()
    scene = reference_render_scene(device=device)
    bb = inflated(scene_bounds(scene), 0.6)
    o, d, c = rays(512, 512, device)
    reset_launches()
    k4 = [dk.march_params_cuda(scene.csdf, scene.params, o, d, c, cfg, bb=bb, track_min=True)
          for cfg in (relaxed, exact)]
    ax = torch.linspace(-1.5, 1.5, 64, device=device)
    x, y, z = torch.meshgrid(ax, ax, ax, indexing="ij")
    grid = SdfGrid(values=(torch.sqrt(x * x + y * y + z * z) - 1.0).contiguous(), lo=(-1.5,) * 3,
                   hi=(1.5,) * 3)
    o, d, c = rays(*SCENE_PARITY_FRAME, device, (2.5, 1.0, -2.5))
    k8 = [tg.grid_march_cuda(tg.interp_sampler(grid), o, d, c, cfg) for cfg in (relaxed, exact)]
    torch.cuda.synchronize()
    counts = launched(launch_counts())
    out = {"K4": same(*k4), "K8": same(*k8), "launches": counts,
           "K8 hits": int((k8[0][2] == 0).sum())}
    print(f"relaxation 1.5 against 1.0 on {card}: {json.dumps(out)}")
    check(out["K4"] and out["K8"] and counts.get("K4") == 2 and counts.get("K8") == 2,
          f"K4 or K8 at relaxation 1.5 differs from 1.0: {out}")


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if argv not in ([], ["--kernel-times"], ["--grid-faults"]):
        print(f"usage: chip_smoke.py [--kernel-times | --grid-faults], not {argv}",
              file=sys.stderr)
        return 2

    from bsdmg_tpu_torch.ops.cuda import build

    device = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    start = t0 = time.perf_counter()
    library = build.build()
    print(f"build: {library.relative_to(ROOT)} from {[s.name for s in build.sources()]} "
          f"in {time.perf_counter() - t0:.1f} s")
    if argv[:1] == ["--grid-faults"]:
        grid_faults(device)
        return 0
    if argv:
        # the kernels alone and nothing else: run from each of two checkouts
        # (this file copied into the other) to compare them on one card
        stencil_probe(card)
        mesh_grid_kernel_times(card, device, kernel_times(card, device))
        mesh_cli_seconds(card)
        march_params_probe(card, device)
        return 0

    # the reverse sweep's planted copies build in the background meanwhile
    fault_builds = FaultBuilds(REVERSE_FAULTS)

    def phase(fn, *args):
        """``fn(*args)``, its seconds printed: where the run's time goes."""
        t = time.perf_counter()
        out = fn(*args)
        print(f"phase {fn.__name__}: {time.perf_counter() - t:.1f} s")
        return out

    try:
        kernels = run_phases(phase, card, device, fault_builds)
    finally:
        fault_builds.close()
    print(f"chip_smoke: every phase passed in {time.perf_counter() - start:.1f} s, the build "
          "included")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def run_phases(phase, card: str, device, fault_builds: FaultBuilds) -> list[dict]:
    """Every phase of the main run, each through ``phase``; returns the
    kernels line's entries."""
    phase(reference_resources, card)
    phase(march_probe, card, device)
    phase(stencil_probe, card)
    phase(march_params_probe, card, device)
    alone = phase(kernel_times, card, device)
    phase(mesh_grid_kernel_times, card, device, alone)
    k1, render_counts = phase(render_phases, card, device)
    kernels = [k1]
    entries, bench_counts = phase(trace_shade_phases, card, device, alone)
    kernels += entries
    launches = phase(mesh_path_phases)
    kernels += phase(mesh_kernel_phases, card, device, launches)
    phase(session_phase, card)
    _, arguments, composed = phase(scene_phases, card, device)
    kernels += composed
    phase(composed_phases, card, device)
    phase(libm_probe, card, arguments)
    fit = phase(fit_path_phases, card, device)
    kernels += phase(diff_kernel_phases, card, device, fit, alone)
    kernels += phase(fit_scene_phases, card, device)
    kernels += phase(grid_phases, card, device)
    kernels += phase(asset_phases, card, device)
    phase(parallel_phases, card, device)
    kernels += phase(moved_wrap_phase, card, device)
    phase(roofline_phase, card)
    kernels += phase(split_phases, card, device, {
        "cli render": render_counts, "cli bench --two-phase row": bench_counts["row"],
        "cli fit --image": fit["launches"]})
    phase(relaxation_phase, card, device)
    phase(reverse_faults, card, device, fault_builds)
    return kernels


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
