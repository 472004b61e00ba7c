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
6. the bench path: ``cli bench --which render`` at 1920x1080 single-phase
   (must launch K1), ``--two-phase row`` (must launch K2 and K3),
   ``--two-phase block`` (K1 at least twice) and ``--roofline``, each
   printing its JSON; K2 (culled, uncull'd, phase A at 16, 32 and 48 steps
   and the tail after each, relaxed), K3 on K2's planes, and K1 relaxed,
   in phase A and resumed over its block list, against their plain
   versions bit for bit; the row, block and unfused images against K1's;
   each pipeline (K1, row, block, unfused) culled or not, exact or relaxed
   (omega 1.5), against the twins composed alike, bit for bit;
   K1, K2 and K3 each alone at 1920x1080 and 2560x1440, the pipelines
   through the wrapper; the divergence split (phase A capped at 16, 32
   and 48 steps, the tail's list, phase B, K3, against K1) with bounds;
7. the mesh path: ``cli mesh -o <tmp>.obj`` at its defaults (level 3),
   which must launch K6 and give the JAX package's voxel, triangle and
   vertex counts; then ``cli mesh --interpolate-edges``, which must launch
   K7;
8. K6 and K7 against their plain versions at level 3 (bit for bit, and the
   JAX package's Pallas-vs-XLA bars), K6 also at level 5;
9. K6 times at levels 3 and 5, K7 at level 3, the plain versions at level
   3; the stage times of mesh generation: refine to level 5, then
   extraction, weld and OBJ write at levels 3 and 5;
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
11. K4 against its plain version with the scene's 16 parameter values at
    1920x1080 and 512x512 and with the fit's 9 at 512x512 and 64x64
    (depth, steps, outcome, min_m and t_min bit for bit, dfdt within a
    bar), K5 against its plain version at 512x512 at the bench point and
    the fit point, the latter also with 16 values, and at the fit point at
    64x64 (the JAX package's bars, and bit-equal across two calls); K4 and
    K5 times with the plain versions' beside them, registers and local
    memory;
12. the mesh-asset path: ``tools/make_torus.py`` writes a torus OBJ and
    ``cli render --scene mesh:<tmp>/torus.obj --camera 3 1.5 -3`` bakes a
    128^3 grid and renders 1920x1080, which must launch K9 twice (the 32^3
    and 64^3 bf16 mips), K8 once (the fine finish) and P1 once (the hit
    normals); its PNG's hit pixels, the bake's peak device memory and the
    stage times (load, bake, mips, each level, finish, normals, shade,
    PNG) from the same steps on the CLI's grid;
13. each of those launches, K8 alone on the 64^3 mip (the gather route) and
    P1 on the stencil points against their plain versions on the same
    inputs (bit for bit); P1 on the probe's own inputs against the probe's
    trilinear oracle (1e-4), with ``torch.nn.functional.grid_sample``'s
    time beside it; the gather route's image against the contraction
    route's (>= 99% of pixels within 1e-3);
14. frame and kernel times of the mesh-asset render at the JAX bench's grid
    point (the reference object baked analytically at 128^3 over +-2.6,
    512x512 from (5, 2, -5)) and at the 1080p torus frame, with each
    kernel's bound; ptxas's registers and spills of grid_kernel.cu.

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
import io
import json
import logging
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from bsdmg_tpu_torch.utils.profiling import (
    HAT,
    INTERP,
    MARCH_ADVANCE,
    MARCH_EVAL,
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

def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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
    from bsdmg_tpu_torch.ops.cuda import (
        diff_kernel,
        grid_kernel,
        mc_kernel,
        mesh_kernel,
        render_kernel,
    )

    for module in (render_kernel, mc_kernel, mesh_kernel):
        module.LAUNCHES = 0
    render_kernel.TRACE_LAUNCHES = 0
    render_kernel.SHADE_LAUNCHES = 0
    diff_kernel.MARCH_LAUNCHES = 0
    diff_kernel.LOSS_GRAD_LAUNCHES = 0
    for name in grid_kernel.LAUNCHES:
        grid_kernel.LAUNCHES[name] = 0


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


def run_cli(argv: list[str]) -> tuple[dict, list[str], float]:
    """Runs ``cli <argv>`` with every launch count set to 0; returns the
    counts after it, the CLI's log lines and the seconds it took."""
    from bsdmg_tpu_torch import cli
    from bsdmg_tpu_torch.ops.cuda import (
        diff_kernel,
        grid_kernel,
        mc_kernel,
        mesh_kernel,
        render_kernel,
    )

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
        launches = {"K1": render_kernel.LAUNCHES, "K2": render_kernel.TRACE_LAUNCHES,
                    "K3": render_kernel.SHADE_LAUNCHES,
                    "K4": diff_kernel.MARCH_LAUNCHES, "K5": diff_kernel.LOSS_GRAD_LAUNCHES,
                    "K6": mc_kernel.LAUNCHES, "K7": mesh_kernel.LAUNCHES, **grid_kernel.LAUNCHES}
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
                  omega=1.0):
    """The plain twins composed as ``render_image_cuda`` composes the
    kernels: a single march, or phase A capped at ``phase_a_steps`` then
    the rays of the row tail's list or of the listed 16x8 blocks resumed,
    then the shading. Returns ``(rgb, depth, steps, outcome)``."""
    kw = dict(use_bb_skip=use_bb_skip, omega=omega)
    if two_phase is False:
        planes = rk.trace_planes_torch(desc, o, d, c, **kw)[:3]
    else:
        a = rk.trace_planes_torch(desc, o, d, c, budget=phase_a_steps, **kw)
        if two_phase == "block":
            active = a[3] * rk.block_rays(rk.compact_list(rk.block_flags(a[3])), *c.shape)
        else:
            active = rk.listed_flags(*rk.compact_list(a[3].reshape(-1)), c.numel()).reshape(c.shape)
        planes = rk.trace_planes_torch(desc, o, d, c, *a[:3], active, **kw)[:3]
    return rk.shade_planes_torch(desc, o, d, planes[0], planes[2]), *planes


def trace_shade_phases(card: str, device) -> list[dict]:
    """Phase 6: the bench path and kernels K2 and K3."""
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
        k = {n: counts[n] for n in ("K1", "K2", "K3")}
        print(f"bench path ({name}): cli bench --which render {' '.join(extra)} in {seconds:.2f} s, "
              f"launches {k}: {json.dumps(out)}")
        check(np.isfinite(out["render"]["rays_per_s"]) and out["render"]["rays_per_s"] > 0,
              f"cli bench {extra} printed {out}")
        launches[name], outs[name] = k, out
    check(launches["plain"]["K1"] > 0, f"cli bench did not launch K1: {launches['plain']}")
    check(launches["row"]["K2"] > 0 and launches["row"]["K3"] > 0,
          f"cli bench --two-phase row did not launch K2 and K3: {launches['row']}")
    check(launches["block"]["K1"] >= 2, f"cli bench --two-phase block: {launches['block']}")
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
    k1_relaxed = rk.render_image_cuda(desc, o, d, c, return_planes=True, omega=1.5)
    exact["K1 relaxed"] = same(k1_relaxed, rk.render_image_planes_torch(desc, o, d, c, omega=1.5))
    rgb, *planes = frame.render(48)
    twin = rk.trace_planes_torch(desc, o, d, c, budget=48)
    exact["K1 phase A 48"] = same(planes, twin) and torch.equal(
        rgb, rk.shade_planes_torch(desc, o, d, twin[0], twin[2]))
    blocks = rk.compact_list(rk.block_flags(planes[3]))
    n_blocks = int(blocks[1].item())
    carried = (*(x.clone() for x in planes[:3]), planes[3] * rk.block_rays(blocks, *c.shape))
    block_state = tuple(x.clone() for x in (rgb, *planes))
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
    # composed alike: each instantiation of K1 and K2, and K3
    for cull in (True, False):
        for omega in (1.0, 1.5):
            for name, kw in {"K1": {}, **paths}.items():
                ours = rk.render_image_cuda(desc, o, d, c, return_planes=True, use_bb_skip=cull,
                                            omega=omega, **kw)
                twin = twin_pipeline(rk, desc, o, d, c, use_bb_skip=cull, omega=omega,
                                     **{k: v for k, v in kw.items() if k != "swizzle"})
                label = "culled" if cull else "uncull'd"
                exact[f"{name} {label} omega {omega} = twin"] = same(ours, twin)
    torch.cuda.synchronize()
    print(f"parity 1920x1080, bit for bit: {json.dumps(exact)}; {n_blocks} of "
          f"{rk.block_flags(planes[3]).numel()} 16x8 blocks resumed after 48 steps")
    check(all(exact.values()), f"not bit-equal: {[k for k, v in exact.items() if not v]}")

    # each kernel alone (prepared struct, preallocated outputs, a CUDA
    # graph of 20 launches); the twins and the pipelines by CUDA events
    desc_c = rk.scene_desc_c(desc, cfg)
    step_limit = cfg.step_limit

    def alone(width, height):
        ro, rd, rc = rays(width, height, device)
        planes = rk.trace_cuda(desc, ro, rd, rc)
        out = tuple(torch.empty_like(p) for p in planes)
        img = torch.empty((height, width, 3), device=device)
        return {
            "K1": graph_ms(lambda: rk._render_cuda(desc_c, ro, rd, rc, img, None, cap=step_limit)),
            "K2": graph_ms(lambda: rk._trace_cuda(desc_c, ro, rd, rc, None, out, cap=step_limit)),
            "K3": graph_ms(lambda: rk._shade_cuda(desc_c, ro, rd, planes[0], planes[2], img)),
        }

    times = {size: alone(*size) for size in ((1920, 1080), (2560, 1440))}
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

    # block retirement's two K1 launches alone: phase A, and the resume from
    # phase A's state (a copy of it, timed and taken off, restores it)
    rgb_b, planes_b = torch.empty_like(rgb), [torch.empty_like(p) for p in planes]
    work = [torch.empty_like(x) for x in block_state]

    def restore():
        for dst, src in zip(work, block_state):
            dst.copy_(src)

    def resume():
        restore()
        rk._render_cuda(desc_c, o, d, c, work[0], work[1:4], mode=rk.RESUME, active=work[4],
                        blocks=blocks, cap=step_limit)

    a1_ms = graph_ms(lambda: rk._render_cuda(desc_c, o, d, c, rgb_b, planes_b[:3], mode=rk.PHASE_A,
                                             active=planes_b[3], cap=48))
    copy_ms = graph_ms(restore)
    print(f"block retirement on {card}: K1 phase A (48 steps) {a1_ms:.4f} ms, K1 over "
          f"{n_blocks} blocks {graph_ms(resume) - copy_ms:.4f} ms (restore {copy_ms:.4f} ms taken "
          f"off); K1 alone {k1_ms:.4f} ms")

    return [{
        "name": "K2 trace_kernel (trace only, resumable)",
        "route": "cuda",
        "source": rk.SOURCE,
        "replaces": "bsdmg_tpu/ops/pallas/render_kernel.py:495",
        "launches": launches["row"]["K2"],
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
    }]


def mesh_path_phases() -> dict:
    """Phase 7: the mesh path through the CLI, with K6 and with K7."""
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, extra in (("K6", []), ("K7", ["--interpolate-edges"])):
            obj = Path(tmp) / f"mesh_{name}.obj"
            counts, messages, seconds = run_cli(["mesh", "-o", str(obj), *extra])
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


def mesh_kernel_phases(card: str, device, launches: dict, cfg=None, top: int = 5,
                       main_level: int = 3) -> list[dict]:
    """Phases 8 and 9: K6 and K7 against their plain versions, their times,
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
    from bsdmg_tpu_torch.ops.cuda.csdf import scene_bounds

    bb = inflated(scene_bounds(scene), 0.6)
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
                                                edge_weight=1.0)
        if shadow:
            k_loss, k_grads = dk.render_loss_grad_cuda(scene.csdf, params, target, o, d, c, bb=bb,
                                                       edge_weight=1.0)
            stats["loss_rel"].append(abs(k_loss.item() - loss.item()) / abs(loss.item()))
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
    check(counts["K4"] >= 1 and counts["K5"] == FIT_STEPS,
          f"cli fit --image launched K4 {counts['K4']} and K5 {counts['K5']} times")
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


def diff_kernel_phases(card: str, device, fit: dict) -> list[dict]:
    """Phase 11: K4 and K5 against their plain versions, their work, bounds
    and times."""
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
    for (w, h), params in (((1920, 1080), scene.params), ((512, 512), scene.params),
                           ((512, 512), true), ((64, 64), true)):
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
    cases = {
        "bench": (true, torch.zeros_like(fit_target), bb25, 0.0, (o, d, c)),
        "fit": (perturbed, fit_target, bb6, 1.0, (o, d, c)),
        "fit, 16 parameters,": (perturbed16, fit_target, bb6, 1.0, (o, d, c)),
        "fit 64x64": (perturbed, small_target, bb6, 1.0, small),
    }
    for name, (params, target, bb, edge, (o, d, c)) in cases.items():
        kern = dk.render_loss_grad_cuda(scene.csdf, params, target, o, d, c, bb=bb, edge_weight=edge)
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
    for w, h in ((512, 512), (1920, 1080)):
        o, d, c = rays(w, h, device)
        npix = w * h
        depth, steps, outcome, _ = dk.march_params_cuda(scene.csdf, true, o, d, c, bb=bb6)
        evals, advances, hits = march_work(steps, outcome, depth)
        ops = k4_ops(npix, evals, advances, True, False, True, False)
        b_ms, b_by = bound(npix * (28 + 16), ops)
        # the kernel from a prepared parameter struct, and the wrapper, which
        # also builds the struct (a copy of the parameters to the host)
        scene_c, _ = dk.param_scene_c(scene.csdf, true, bb=bb6)
        k_ms = median_ms(lambda: dk._march_cuda(scene_c, o, d, c, False), reps=20)
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
        for name, params, target, bb, edge in points:
            depth, steps, outcome, _, min_m, _ = dk.march_params_cuda(scene.csdf, params, o, d, c,
                                                                      bb=bb, track_min=True)
            evals, advances, hits = march_work(steps, outcome, depth)
            hinges = 0
            if edge:
                miss = classify_target_miss(target)
                hit = outcome == 0
                hinges = int(((~miss & ~hit & (min_m < UNTRACKED)) | (miss & hit)).sum().item())
            ops = k5_ops(npix, evals, advances, hits, hinges, 9, True, False, bool(edge))
            b_ms, b_by = bound(npix * (40 + 4 * bool(edge)), ops)
            scene_c, _ = dk.param_scene_c(scene.csdf, params, bb=bb)
            state = dk._target_state(target, None).contiguous() if edge else None
            k_ms = median_ms(lambda: dk._loss_grad_cuda(scene_c, o, d, c, target, state, npix, edge,
                                                        dk._band(MarchConfig(), None)), reps=20)
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
    scene_c, _ = dk.param_scene_c(scene.csdf, perturbed, bb=bb6)
    state = dk._target_state(small_target, None).contiguous()
    k5_small = median_ms(lambda: dk._loss_grad_cuda(scene_c, *small, small_target, state, 64 * 64, 1.0,
                                                    dk._band(MarchConfig(), None)), reps=20)
    for size, step_s, k_ms in ((64, fit["step_s_64"], k5_small),
                               (512, fit["step_s_512"], timings[("K5", 512, "fit")]["ms"])):
        print(f"fit --image step at {size}x{size} on {card}: {step_s * 1e3:.3f} ms wall, of which K5 "
              f"at the fit point {k_ms:.4f} ms; Adam and host {step_s * 1e3 - k_ms:.3f} ms")
    k4_row = timings[("K4", 512)]
    k5_row = timings[("K5", 512, "bench")]
    return [{
        "name": "K4 march_params_kernel (march under runtime parameters)",
        "route": "cuda",
        "source": dk.SOURCE,
        "replaces": "bsdmg_tpu/ops/pallas/diff_kernel.py:60",
        "launches": fit["launches"]["K4"],
        "max_abs_err": max(r["dfdt_max_err"] for r in k4.values()),
        **k4_row,
        "library_ms": None,
    }, {
        "name": "K5 loss_grad_kernel (fused image loss and gradient)",
        "route": "cuda",
        "source": dk.SOURCE,
        "replaces": "bsdmg_tpu/ops/pallas/diff_kernel.py:232",
        "launches": fit["launches"]["K5"],
        "max_abs_err": max(r["grad_max_abs_err"] for r in k5.values()),
        **k5_row,
        "library_ms": None,
    }]


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


def march_launch_work(state: dict, out) -> tuple[int, int, int, int]:
    """``(rays marched, evaluations, advances, ray bytes)`` of one grid
    march launch, from its resume state (empty: every ray from step 0) and
    its output, counted as K1's are. A marched ray reads its origin,
    direction and cone (28 B), on a resumed launch also its active flag,
    depth and steps (12 B), and writes depth, steps and outcome (12 B); a
    ray that is not active reads those three and its outcome (16 B) and
    writes 12 B (csrc/grid_kernel.cu::grid_march_kernel)."""
    steps, outcome = out[1].reshape(-1), out[2].reshape(-1)
    marched = torch.ones_like(outcome, dtype=torch.bool)
    steps0 = torch.zeros_like(steps)
    if state:
        marched, steps0 = state["active"].reshape(-1) > 0, state["steps0"].reshape(-1)
    taken = int((steps - steps0)[marched].sum())
    ended = outcome[marched]
    n, n_marched = outcome.numel(), int(marched.sum())
    ray_bytes = n_marched * (28 + (12 if state else 0) + 12) + (n - n_marched) * (16 + 12)
    return (n_marched, taken + int(((ended == 0) | (ended == 2)).sum()),
            taken + int((ended == 2).sum()), ray_bytes)


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

    n = rays[2].numel()
    out = (torch.empty(n, device=rays[2].device), *(torch.empty(n, dtype=torch.int32,
                                                                 device=rays[2].device)
                                                     for _ in range(2)))
    box, march = tg.grid_box_c(sampler), tg.grid_march_c(cfg, cfg.step_limit)
    planes = tuple(state[k] for k in ("active", "depth0", "steps0", "outcome0")) if state else ()
    return graph_ms(lambda: tg._march_cuda(sampler, box, march, *rays, planes, out))


def sample_kernel_ms(sampler, points) -> float:
    """One P1 launch's own time, as :func:`march_kernel_ms`."""
    from bsdmg_tpu_torch.ops.cuda import grid_kernel as tg

    out, box = torch.empty_like(points[0]), tg.grid_box_c(sampler)
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
    ``plain`` its plain version's time. A bound's bytes count each table
    whole, once: an upper estimate of the table bytes the samples touch,
    so the bound from the rays' bytes alone is printed beside it."""
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

    def row(name, ms, w_ms, p_ms, ops, ray_bytes, table):
        nbytes = ray_bytes + table.numel() * table.element_size()
        b_ms, b_by = bound(nbytes, ops)
        rows[name] = dict(ms=ms, wrapper_ms=w_ms, plain_ms=p_ms, bound_ms=b_ms, ops=ops,
                          nbytes=nbytes)
        return (f"wrapper {w_ms:.4f} ms, plain {'not timed' if p_ms is None else f'{p_ms:.3f} ms'}; "
                f"{ops:.4g} FP32 operations, {nbytes} B ({ray_bytes} B of rays or points); "
                f"bound {b_ms:.4f} ms ({b_by}), from the rays' or points' bytes alone "
                f"{bound(ray_bytes, ops)[0]:.4f} ms")

    for name, sampler, state, out in launches:
        marched, evals, advances, ray_bytes = march_launch_work(state, out)
        ops = evals * ((INTERP if sampler.kind == tg.INTERP_F32 else HAT) + MARCH_EVAL) \
            + advances * MARCH_ADVANCE
        ms = march_kernel_ms(sampler, rays, cfg, state)
        w_ms = median_ms(lambda: tg.grid_march_cuda(sampler, *rays, cfg, budget=cfg.step_limit,
                                                    **state), reps=5)
        p_ms = None
        if plain:
            p_ms = median_ms(lambda: tg.grid_march_torch(sampler, *rays, cfg, budget=cfg.step_limit,
                                                         **state), runs=3, warmup=1)
        text = row(name, ms, w_ms, p_ms, ops, ray_bytes, sampler.table)
        print(f"time {name} {label} on {card}: {ms:.4f} ms ({marched / ms * 1e3:.4g} marched rays/s, "
              f"{marched} of {n} rays, {evals} samples), {text}")
    sampler = tg.interp_sampler(grid)
    points = stencil[0].numel()
    ms = sample_kernel_ms(sampler, stencil)
    w_ms = median_ms(lambda: tg.grid_sample_cuda(sampler, *stencil), reps=5)
    p_ms = median_ms(lambda: tg.grid_sample_torch(sampler, *stencil), runs=3, warmup=1) if plain else None
    text = row("P1", ms, w_ms, p_ms, points * INTERP, points * 16, sampler.table)
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
        "name": "K9 grid_march_kernel<Hat> (contraction ladder level; both levels of a frame)",
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
        "name": "K8 grid_march_kernel<InterpF32> (grid march; the fine finish)",
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
    kernels += trace_shade_phases(card, device)
    launches = mesh_path_phases()
    kernels += mesh_kernel_phases(card, device, launches)
    fit = fit_path_phases(card, device)
    kernels += diff_kernel_phases(card, device, fit)
    kernels += grid_phases(card, device)

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
