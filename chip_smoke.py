#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bsdmg_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper card, nvcc
and PyTorch built for CUDA. Phases, each reported on its own line:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build every kernel from bsdmg_tpu_torch/csrc with nvcc, one process per
   source, all started together;
3. the render path: ``cli render -o <tmp>.png`` at the default 1920x1080,
   which must launch K1;
4. K1 against its plain PyTorch version at 1920x1080 (bit for bit), and at
   256x144 against the committed golden render;
5. K1 and plain times from CUDA events at 1920x1080 and 2560x1440;
6. the mesh path: ``cli mesh -o <tmp>.obj`` at its defaults (level 3),
   which must launch K6 and give the JAX package's voxel, triangle and
   vertex counts; then ``cli mesh --interpolate-edges``, which must launch
   K7;
7. K6 and K7 against their plain versions at level 3 (bit for bit, and the
   JAX package's Pallas-vs-XLA bars), K6 also at level 5;
8. K6 times at levels 3 and 5, K7 at level 3, the plain versions at level
   3; the stage times of mesh generation: refine to level 5, then
   extraction, weld and OBJ write at levels 3 and 5.

Each path runs with every kernel's launch count set to 0 just before it and
read just after; a path that did not launch its kernel fails. Then one JSON
line describing each kernel (its bound from this run's counts: the bytes it
must move over HBM's rate, or its FP32 operations over the FP32 peak), the
card's line, and as the last line ``{"ok": true, "device": {...}}``. Any
failed phase raises and the script exits non-zero; without a CUDA device it
exits non-zero at once.
"""

from __future__ import annotations

import json
import logging
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

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

# Peaks of one H100 SXM (NVIDIA's data sheet): FP32
# outside the tensor cores and HBM. A kernel's bound is the larger of its
# bytes over the memory rate and its FP32 operations over the FP32 peak.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

# FP32 operations, counted from the sources line by line: each add,
# subtract, multiply, division, min, max, abs, sqrt (or rsqrt) and compare
# counts one; a negation or a select counts none; a value that a backward
# pass recomputes from its forward pass counts once.
TIE = 3  # scene_sdf.cuh tie_weight: two compares, a division
INV_NORM = 8  # project.cuh inv_norm: 3 multiplies, 2 adds, max, sqrt, division
WINDING = 41  # mc_kernel.cu vertex-mean winding per valid triangle: edges 6,
# cross product 9, normal sum 6, dot 5, |g|^2 5, |a|^2 5, ambiguity test 4, flip test 1
RAY = 124  # render_kernel.cu per ray: slab cull 64 (centre offset 3, reach 9, T* 4,
# margin 4, 3 slab axes of 12, tmin/tmax 4, miss 2, limit 2), ACES 60 (two 3x3
# products of 15, 3 curves of 8, 3 clips of 2)


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


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """``(bound_ms, bound_by)``: the least time the card could take."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_FP32
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def rays(width: int, height: int, device):
    from bsdmg_tpu_torch.cam import generate_rays, look_at

    cam = look_at((5.0, 2.0, -5.0), fov=np.pi / 4, device=device)
    return generate_rays(cam, (width, height), SCREEN)


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


def reset_launches() -> None:
    from bsdmg_tpu_torch.ops.cuda import mc_kernel, mesh_kernel, render_kernel

    for module in (render_kernel, mc_kernel, mesh_kernel):
        module.LAUNCHES = 0


def render_phases(card: str, device) -> dict:
    """Phases 3-5: the render path and K1."""
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
        launches = render_kernel.LAUNCHES
        check(launches > 0, "cli render did not launch K1")
        check(png.is_file() and png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", "no PNG written")
        print(f"render path: cli render 1920x1080 -> {png.stat().st_size} B PNG in {seconds:.2f} s, "
              f"K1 launches {launches}")

    desc = compile_scene(reference_render_scene(device=device))
    o, d, c = rays(1920, 1080, device)
    kernel = render_image_cuda(desc, o, d, c, return_planes=True)
    plain = render_image_planes_torch(desc, o, d, c)
    torch.cuda.synchronize()
    stats = compare(kernel, plain)
    _, _, steps, outcome = kernel
    counts = torch.bincount(outcome.reshape(-1), minlength=3).tolist()
    print(f"parity 1920x1080: {json.dumps(stats)} outcomes(collision, step, depth)={counts}")

    # this run's work (render_kernel.cu): a march evaluation per step, one
    # more where the march ended by a hit or the depth limit, none for a
    # culled ray; each costs the SDF, the point (6), cd and cd + eps (2) and
    # the hit test (1), and each advance (a step, or the last one past the
    # depth limit) 3 more; a hit's fd4 normal and shading add the point (6),
    # 2*eps, 12 shifted SDFs, the stencil (15), the normalisation (7), the
    # Lambert term (10) and the colour mix (6)
    culled = (outcome == 2) & (steps == 0) & (kernel[1] == float(np.float32(500.0 * 1.01)))
    marched = ~culled
    evals = steps.sum().item() + int(((outcome != 1) & marched).sum().item())
    advances = steps.sum().item() + int(((outcome == 2) & marched).sum().item())
    hits = counts[0]
    npix = 1920 * 1080
    sdf = sdf_ops(desc)
    ops = (evals * (sdf + 9) + advances * 3 + hits * (6 + 1 + 12 * (sdf + 1) + 15 + 7 + 10 + 6)
           + npix * RAY)
    bound_ms, bound_by = bound(npix * (12 + 12 + 4 + 12), ops)
    print(f"K1 work 1920x1080: {evals} march SDF evaluations, {hits} normals, "
          f"{ops:.4g} FP32 operations, {npix * 40} B; bound {bound_ms:.4f} ms ({bound_by})")

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
        "name": "K1 render_kernel (fused trace+shade)",
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
    }


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


def mesh_cli(argv: list[str]) -> tuple[dict, list[str], float]:
    """Runs ``cli mesh`` with every launch count set to 0; returns the
    counts after it, the CLI's log lines and the seconds it took."""
    from bsdmg_tpu_torch import cli
    from bsdmg_tpu_torch.ops.cuda import mc_kernel, mesh_kernel

    records = _Records()
    logger = logging.getLogger("bsdmg_tpu_torch")
    logger.addHandler(records)
    old_level = logger.level
    logger.setLevel(logging.INFO)
    try:
        reset_launches()
        t0 = time.perf_counter()
        cli.main(["mesh", *argv])
        seconds = time.perf_counter() - t0
        launches = {"K6": mc_kernel.LAUNCHES, "K7": mesh_kernel.LAUNCHES}
    finally:
        logger.removeHandler(records)
        logger.setLevel(old_level)
    return launches, records.messages, seconds


def mesh_path_phases() -> dict:
    """Phase 6: the mesh path through the CLI, with K6 and with K7."""
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, extra in (("K6", []), ("K7", ["--interpolate-edges"])):
            obj = Path(tmp) / f"mesh_{name}.obj"
            counts, messages, seconds = mesh_cli(["-o", str(obj), *extra])
            check(counts[name] > 0, f"cli mesh {' '.join(extra)} did not launch {name}: {counts}")
            v, vn, f, finite = read_obj_counts(obj)
            voxels = [int(m.split()[2]) for m in messages if m.startswith("level ")]
            print(f"mesh path ({name}): cli mesh {' '.join(extra)} -> voxels per level {voxels}, "
                  f"{f} triangles, {v} vertices, {obj.stat().st_size} B OBJ in {seconds:.2f} s, "
                  f"launches {counts}")
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
            launches[name] = counts[name]
    return launches


def _max_err(a, b) -> float:
    return (a.double() - b.double()).abs().max().item() if a.numel() else 0.0


def mesh_ops(desc, use_grad: bool, newton_steps: int, normals: int, lanes: int = 0,
             valid_triangles: int = 0) -> int:
    """FP32 operations of K6 or K7 for this run's data: its Newton steps,
    fd4 unit normals (fd4_grad, inv_norm, 3 multiplies), K6's start points
    (3 multiplies, 3 adds per lane) and vertex-mean windings."""
    return (newton_steps * newton_step_ops(desc, use_grad)
            + normals * (fd4_ops(desc) + INV_NORM + 3) + lanes * 6 + valid_triangles * WINDING)


def mesh_kernel_phases(card: str, device, launches: dict, cfg=None, top: int = 5,
                       main_level: int = 3) -> list[dict]:
    """Phases 7 and 8: K6 and K7 against their plain versions, their times,
    and the stage times of mesh generation at level ``top``."""
    import dataclasses

    from bsdmg_tpu_torch.config import MeshGenConfig
    from bsdmg_tpu_torch.mesh.export import save_obj
    from bsdmg_tpu_torch.mesh.field import create_voxel_field, refine_field
    from bsdmg_tpu_torch.mesh.pipeline import field_to_triangles, triangles_to_mesh
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
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            save_obj(mesh, Path(tmp) / "mesh.obj")
            stages[f"OBJ write L{level}"] = time.perf_counter() - t0
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
        b_ms, b_by = bound(f.count * (24 + 404), ops)
        k_ms = median_ms(lambda: mc_kernel.mc_fused_cuda(desc, *args, **kwargs),
                         runs=7, reps=5 if level == main_level else 2)
        p_ms = None
        if level == main_level:
            p_ms = median_ms(lambda: mc_kernel.mc_fused_torch(fns, *args, **kwargs), runs=5, warmup=1)
        k6[level] = dict(res, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, ops=ops)
        print(f"time K6 level {level} ({f.count} voxels, {lanes} projected edges) on {card}: "
              f"{k_ms:.4f} ms ({f.count / k_ms * 1e3:.4g} voxels/s), plain "
              f"{'not timed' if p_ms is None else f'{p_ms:.3f} ms'}; {ops:.4g} FP32 operations, "
              f"{f.count * 428} B; bound {b_ms:.4f} ms ({b_by})")
        del kern, plain

    # K7 against its plain version on the staged path's inputs
    f = fields[main_level]
    args, kwargs = kernel_inputs(desc, f.lowers, f.voxel_size,
                                 dataclasses.replace(cfg, interpolate_edges=True))
    kern = mesh_kernel.project_edges_cuda(desc, *args, **kwargs)
    stats = {}
    plain = mesh_kernel.project_edges_torch(fns, *args[:3], args[3].bool(), stats=stats, **kwargs)
    torch.cuda.synchronize()
    m = args[0].numel()
    res = {
        "points": m,
        "active": int(args[3].sum()),
        "pos_max_err": max(_max_err(a, b) for a, b in zip(kern[:3], plain[:3])),
        "nrm_max_err": max(_max_err(a, b) for a, b in zip(kern[3:], plain[3:])),
        "exact": all(torch.equal(a, b) for a, b in zip(kern, plain)),
        "newton_steps": stats["newton_steps"],
    }
    print(f"parity K7 level {main_level}: {json.dumps(res)}")
    check(res["pos_max_err"] <= POSITION_ATOL and res["nrm_max_err"] <= NORMAL_ATOL,
          f"K7 bars {res}")
    check(res["exact"], "K7 and its plain version are not bit-equal")
    ops7 = mesh_ops(desc, kwargs["use_grad"], stats["newton_steps"], m)
    b7_ms, b7_by = bound(m * (16 + 24), ops7)
    k7_ms = median_ms(lambda: mesh_kernel.project_edges_cuda(desc, *args, **kwargs), reps=5)
    p7_ms = median_ms(
        lambda: mesh_kernel.project_edges_torch(fns, *args[:3], args[3].bool(), **kwargs),
        runs=5, warmup=1,
    )
    print(f"time K7 level {main_level} ({m} points) on {card}: {k7_ms:.4f} ms, plain {p7_ms:.3f} ms; "
          f"{ops7:.4g} FP32 operations, {m * 40} B; bound {b7_ms:.4f} ms ({b7_by})")

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
        "max_abs_err": max(res["pos_max_err"], res["nrm_max_err"]),
        "ms": k7_ms,
        "plain_ms": p7_ms,
        "bound_ms": b7_ms,
        "bound_by": b7_by,
        "library_ms": None,
    }]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2

    from bsdmg_tpu_torch.ops.cuda import build

    device = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    library = build.build()
    print(f"build: {library.relative_to(ROOT)} from {[s.name for s in build.sources()]} "
          f"in {time.perf_counter() - t0:.1f} s")

    kernels = [render_phases(card, device)]
    launches = mesh_path_phases()
    kernels += mesh_kernel_phases(card, device, launches)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
