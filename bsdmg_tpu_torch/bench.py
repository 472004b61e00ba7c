"""Operating-point benchmarks of the port: rays/s of the render, voxels/s of
refine and marching cubes, rays/s of the fused loss and gradient, and the
sharded frame's scaling and sharding overhead over the world's ranks.

Counterpart of ``bsdmg_tpu/bench.py``, at the same operating points: the
reference scene from (5, 2, -5) at 1920x1080 (``benchmark_render``), the
reference object at init factor 64 (``benchmark_refine``, and
``benchmark_marching_cubes`` two levels down), the reference scene's five
shape parameters at 512x512 (``benchmark_render_grad``). Each time comes
from :func:`_slope_time` over ``k`` calls of the work with one
``torch.cuda.synchronize()`` at the end of each timed call, so it is the
work's own time per call, host work included, without the fixed cost of a
sync. On a CPU device the same code times the plain twins: a CPU number,
never a device one.
"""

from __future__ import annotations

import statistics
import time
from typing import Any, Callable

import numpy as np
import torch

from bsdmg_tpu_torch.cam import generate_rays, look_at
from bsdmg_tpu_torch.config import MeshGenConfig
from bsdmg_tpu_torch.grad import render_image_diff, render_loss_and_grad
from bsdmg_tpu_torch.mesh.field import VoxelField, create_voxel_field, refine_field
from bsdmg_tpu_torch.mesh.pipeline import field_to_triangles
from bsdmg_tpu_torch.models import get_scene, reference_object, reference_render_scene
from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene, compile_scene_split, scene_bounds, sdf_fns
from bsdmg_tpu_torch.ops.cuda.mc_kernel import edge_slots, mc_fused_torch
from bsdmg_tpu_torch.ops.cuda.render_kernel import BLOCK_H, BLOCK_W, render_image_cuda, trace_cuda
from bsdmg_tpu_torch.ops.marching_cubes import kernel_inputs
from bsdmg_tpu_torch.parallel.collectives import all_reduce
from bsdmg_tpu_torch.parallel.multihost import local_device
from bsdmg_tpu_torch.parallel.sharding import (
    make_mesh,
    render_sharded_pallas,
    shard_image,
    shard_rays,
    train_step,
)

#: the JAX package's (8, 128) vector tile, over which it takes its tile maxima
TILE = (8, 128)
#: one warp's pixels in K1 and K2: an 8x4 patch, 4 rows of 8
WARP = (BLOCK_H // 2, BLOCK_W // 2)


def _slope_time(make_many: Callable[[int], float], k1: int = 1, k2: int = 8, iters: int = 3,
                passes: int = 3, agree: Callable[[float], float] = float) -> float:
    """Seconds per call of the work from a robust multi-point slope.

    ``make_many(k)`` runs the work ``k`` times and returns a host float
    after one ``torch.cuda.synchronize()``. The slope in ``k`` removes the
    fixed cost of a timed call. As the JAX package's: three ``k`` points
    spanning ``[k1, k2]``, the best of ``iters`` per point, the median of
    the pairwise slopes (Theil-Sen) per pass, the median over ``passes``;
    a slope that jitter swallowed widens ``k2`` and fails past 64. Each
    point's time passes through ``agree`` (the ranks' mean, where the work
    is a sharded frame: every rank then takes the same decisions)."""

    def best(k):
        b = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            make_many(k)
            b = min(b, time.perf_counter() - t0)
        return b

    make_many(k1)
    while True:
        ks = sorted({k1, (k1 + k2) // 2, k2})
        for k in ks:
            make_many(k)
        pass_slopes = []
        for _ in range(passes):
            t = {k: agree(best(k)) for k in ks}
            pair = [(t[b] - t[a]) / (b - a) for i, a in enumerate(ks) for b in ks[i + 1:]]
            pass_slopes.append(statistics.median(pair))
        slope = statistics.median(pass_slopes)
        if slope > 0:
            return slope
        if k2 - k1 >= 64:
            raise RuntimeError(
                f"non-positive slope {slope:.3e}s between k={k1} and k={k2}; "
                "timing jitter exceeded the workload delta"
            )
        k2 *= 2
        iters += 1


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rays(width: int, height: int, device: torch.device):
    cam = look_at((5.0, 2.0, -5.0), fov=np.pi / 4, device=device)
    return generate_rays(cam, (width, height), (1920.0, 1080.0))


def benchmark_render(
    width: int = 1920,
    height: int = 1080,
    *,
    two_phase: bool | str = False,
    phase_a_steps: int = 48,
    unroll: int = 1,
    device: str | torch.device = "cuda",
    scene: str = "reference_render_scene",
) -> dict[str, Any]:
    """Rays/s of the render of the built-in ``scene`` (the reference render
    scene by default) through ``render_image_cuda``, with the scene's
    near/far split (``compile_scene_split``), as the JAX package's bench.

    ``two_phase`` True is the row two-phase pipeline (K2, K2 over the tail,
    K3), ``"block"`` block retirement (K1 twice), False one K1 launch.
    Frame ``i`` offsets the origins by ``1e-6 * i``, as the JAX package's
    frames do; each frame's image is summed on the device. ``unroll``
    frames make one step of ``k``; on one stream they run one after the
    other."""
    device = torch.device(device)
    built = get_scene(scene, device=device)
    desc, split = compile_scene(built), compile_scene_split(built)
    origins, dirs, cone = _rays(width, height, device)

    def many(k: int) -> float:
        acc = torch.zeros((), device=device)
        for i in range(k * unroll):
            img = render_image_cuda(desc, origins + 1e-6 * i, dirs, cone, two_phase=two_phase,
                                    phase_a_steps=phase_a_steps, split=split)
            acc = acc + img.sum()
        _sync(device)
        return float(acc)

    per_frame = _slope_time(many, k1=2, k2=8, iters=3) / unroll
    return {
        "rays_per_s": width * height / per_frame,
        "seconds_per_frame": per_frame,
        "width": width,
        "height": height,
        "unroll": unroll,
        "device": str(device),
    }


def _block_max(plane: np.ndarray, block: tuple[int, int]) -> np.ndarray:
    """Maxima of ``plane`` over ``block``-sized tiles; a tile at the frame's
    edge takes the pixels it has."""
    bh, bw = block
    h, w = plane.shape
    padded = np.pad(plane, ((0, -h % bh), (0, -w % bw)))
    return padded.reshape(padded.shape[0] // bh, bh, padded.shape[1] // bw, bw).max(axis=(1, 3))


def render_step_stats(width: int = 1920, height: int = 1080, *,
                      device: str | torch.device = "cuda",
                      scene: str = "reference_render_scene") -> dict[str, Any]:
    """Step statistics of the trace of ``scene`` (the reference render scene
    by default), from ``trace_cuda``'s
    steps plane: the mean per ray, the mean over (8, 128) tiles of their
    maximum (what the JAX package's tile-synchronised march runs), the
    maximum, and the mean over K1's and K2's 8x4 warp patches of their
    maximum (what the card runs: a warp marches as long as its slowest
    ray). ``hits`` counts the rays that collide. Tiles and patches at the
    frame's edge take the pixels they have; the JAX package drops partial
    tiles, which 1920x1080 has none of."""
    device = torch.device(device)
    desc = compile_scene(get_scene(scene, device=device))
    _, steps, outcome = trace_cuda(desc, *_rays(width, height, device))
    s = steps.cpu().numpy().astype(np.float64)
    return {
        "mean_steps": float(s.mean()),
        "mean_tile_max_steps": float(_block_max(s, TILE).mean()),
        "max_steps": float(s.max()),
        "mean_warp_max_steps": float(_block_max(s, WARP).mean()),
        "hits": int((outcome == 0).sum().item()),
    }


def benchmark_refine(init_factor: int = 64, *,
                     device: str | torch.device = "cuda") -> dict[str, Any]:
    """Voxels/s of one refinement level of the reference object's initial
    field (``init_factor**3`` voxels); call ``i`` offsets the corners by
    ``1e-7 * i``, as the JAX package's calls do."""
    device = torch.device(device)
    desc = compile_scene(reference_object(device=device))
    field = create_voxel_field(MeshGenConfig(init_factor=init_factor), device)

    def many(k: int) -> float:
        acc = torch.zeros((), device=device)
        for i in range(k):
            out = refine_field(desc, VoxelField(field.lowers + 1e-7 * i, field.voxel_size))
            acc = acc + out.lowers.sum()
        _sync(device)
        return float(acc)

    per_call = _slope_time(many, k1=2, k2=10, iters=5)
    return {"voxels_per_s": field.count / per_call, "seconds": per_call,
            "input_voxels": field.count}


def benchmark_marching_cubes(init_factor: int = 64, levels: int = 2, *,
                             device: str | torch.device = "cuda") -> dict[str, Any]:
    """Voxels/s of the marching-cubes extraction (kernel K6 and the host
    work around it) of the reference object's field ``levels`` below
    ``init_factor``; every output is summed, so none is skipped."""
    device = torch.device(device)
    desc = compile_scene(reference_object(device=device))
    cfg = MeshGenConfig(init_factor=init_factor)
    field = create_voxel_field(cfg, device)
    for _ in range(levels):
        field = refine_field(desc, field)

    def many(k: int) -> float:
        acc = torch.zeros((), device=device)
        for i in range(k):
            soup = field_to_triangles(desc, VoxelField(field.lowers + 1e-7 * i, field.voxel_size),
                                      cfg)
            acc = acc + soup.valid.sum() + soup.positions.sum() + soup.normals.sum()
        _sync(device)
        return float(acc)

    per_call = _slope_time(many, k1=4, k2=16, iters=5)
    return {"voxels_per_s": field.count / per_call, "seconds": per_call,
            "voxel_count": field.count}


def mc_step_stats(init_factor: int = 64, levels: int = 2, *,
                  device: str | torch.device = "cuda") -> dict[str, Any]:
    """The Newton steps that kernel K6 runs on each crossing edge of
    :func:`benchmark_marching_cubes`' field, counted by its plain twin
    (``ops/cuda/mc_kernel.py::mc_fused_torch``, the same steps as the
    kernel's), with the keys of ``bsdmg_tpu/bench.py::mc_step_stats`` for
    ``utils/profiling.py::mc_roofline``. The JAX kernel pads the voxels
    into (8, 128) blocks of lanes, a lane a voxel with a budget of 12 edge
    planes, and runs each block in chunks of steps to its slowest lane;
    K6 runs one crossing edge a thread to its own convergence and writes
    a voxel's triangles once. So the port's counterparts keep a lane a
    voxel: ``padded_lanes`` the voxels (no padding), ``budget`` the crossing
    edges K6 projects per voxel (a float), ``mean_block_steps`` the mean of
    the steps each edge runs, ``mean_needed_steps`` the mean over voxels of
    their slowest edge's steps and ``max_steps`` the most any edge runs
    (the JAX keys' meanings). The roofline then charges each voxel's 107
    planes once, as K6's bound does, and each edge its own steps."""
    device = torch.device(device)
    desc = compile_scene(reference_object(device=device))
    cfg = MeshGenConfig(init_factor=init_factor)
    field = create_voxel_field(cfg, device)
    for _ in range(levels):
        field = refine_field(desc, field)
    args, kwargs = kernel_inputs(desc, field.lowers, field.voxel_size, cfg)
    stats: dict = {}
    mc_fused_torch(sdf_fns(desc), *args, stats=stats, **kwargs)
    steps = stats["newton_point_steps"].long()
    vox = edge_slots(args[3], kwargs["budget"])[0]
    slowest = torch.zeros(field.count, dtype=torch.long, device=steps.device)
    slowest.scatter_reduce_(0, vox, steps, "amax")
    return {
        "voxels": field.count,
        "padded_lanes": field.count,
        "budget": steps.numel() / max(field.count, 1),
        "mean_needed_steps": slowest.float().mean().item(),
        "mean_block_steps": steps.float().mean().item(),
        "max_steps": int(steps.max().item()) if steps.numel() else 0,
    }


def benchmark_render_grad(width: int = 512, height: int = 512, *,
                          device: str | torch.device = "cuda") -> dict[str, Any]:
    """Rays/s of the fused image loss and gradient (kernel K5) of the
    reference scene's shape parameters against a black target, bounds and
    the near/far split's near box inflated by 0.25 (the JAX package's
    training operating point); call ``i`` offsets the origins by ``1e-7 *
    i``."""
    device = torch.device(device)
    scene = reference_render_scene(device=device)
    origins, dirs, cone = _rays(width, height, device)
    target = torch.zeros((height, width, 3), dtype=torch.float32, device=device)
    lo, hi, slack = scene_bounds(scene)
    bb = (tuple(v - 0.25 for v in lo), tuple(v + 0.25 for v in hi), slack)
    far, (nlo, nhi, nslack) = compile_scene_split(scene)
    split = (far, (tuple(v - 0.25 for v in nlo), tuple(v + 0.25 for v in nhi), nslack))
    params = {k: v for k, v in scene.params.items()
              if k not in ("object_center", "object_rotation")}

    def many(k: int) -> float:
        acc = torch.zeros((), device=device)
        for i in range(k):
            loss, grads = render_loss_and_grad(scene.sdf, params, target, origins + 1e-7 * i,
                                               dirs, cone, csdf=scene.csdf, bb=bb, split=split)
            acc = acc + loss + sum(g.abs().sum() for g in grads.values())
        _sync(device)
        return float(acc)

    per_call = _slope_time(many, k1=2, k2=16, iters=5)
    return {"rays_per_s": width * height / per_call, "seconds_per_frame": per_call,
            "width": width, "height": height}


def _world_mean(seconds: float, mesh, device: torch.device) -> float:
    """The mean of every rank's ``seconds`` (one ``all_reduce``)."""
    total = all_reduce(torch.tensor([seconds], dtype=torch.float64, device=device))
    return float(total[0]) / mesh.size()


def _sync_time(fn: Callable[[], Any], device: torch.device, iters: int = 3, warmup: int = 2,
               agree: Callable[[float], float] = float) -> float:
    """The best of ``iters`` wall times of ``fn()`` after ``warmup`` calls,
    each ended by a sync, through ``agree``."""
    for _ in range(warmup):
        fn()
        _sync(device)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return agree(best)


def benchmark_scaling(width: int = 1920, height: int = 1080, iters: int = 3, *,
                      device: str | torch.device = "cuda") -> dict[str, Any]:
    """Rays/s of the sharded frame (``parallel/sharding.py::
    render_sharded_pallas``, K1 on every rank, with the near/far split as
    the JAX package's bench) of the reference scene over the world's mesh
    (``make_mesh``: a world of one without a process group), against one
    rank's unsharded frame: ``efficiency = (rays_per_s
    / N) / rays_per_s_single``, the JAX package's keys. A world of one
    reports N = 1 and efficiency 1.0. Every rank measures at once, so ranks
    that share a card also share its time."""
    device = local_device(device)
    mesh = make_mesh(device=device)
    n = mesh.size()
    scene = reference_render_scene(device=device)
    desc, split = compile_scene(scene), compile_scene_split(scene)
    origins, dirs, cone = _rays(width, height, device)

    def measure(render) -> float:
        def many(k: int) -> float:
            acc = torch.zeros((), device=device)
            for i in range(k):
                acc = acc + render(origins + 1e-6 * i).sum()
            _sync(device)
            return float(acc)

        agree = (lambda t: _world_mean(t, mesh, device)) if n > 1 else float
        return width * height / _slope_time(many, k2=4, iters=iters, agree=agree)

    full = measure(lambda o: render_sharded_pallas(desc, o, dirs, cone, mesh, split=split))
    if n == 1:
        return {"devices": 1, "rays_per_s": full, "efficiency": 1.0}
    single = measure(lambda o: render_image_cuda(desc, o, dirs, cone, split=split))
    return {"devices": n, "rays_per_s": full, "rays_per_s_single": single,
            "efficiency": (full / n) / single}


def benchmark_scaling_overhead(width: int = 256, height: int = 256, iters: int = 3, *,
                               device: str | torch.device = "cuda") -> dict[str, Any]:
    """What sharding adds, at a fixed global workload: ``overhead = t(sharded
    over the world) / t(unsharded)`` for the reference scene's frame
    (``render_sharded_pallas`` against ``render_image_cuda``) and for one
    SGD step of its shape parameters against a black target
    (``train_step`` on this rank's interleaved block against the same step
    on the whole frame without a collective), with ``projected_efficiency
    = 1 / overhead``: the JAX package's keys. Every rank measures at once;
    the sharded times are the ranks' mean."""
    device = local_device(device)
    mesh = make_mesh(device=device)
    scene = reference_render_scene(device=device)
    desc = compile_scene(scene)
    origins, dirs, cone = _rays(width, height, device)
    agree = lambda t: _world_mean(t, mesh, device)  # noqa: E731

    t_direct = _sync_time(lambda: render_image_cuda(desc, origins, dirs, cone).sum(), device,
                          iters, agree=agree)
    t_sharded = _sync_time(lambda: render_sharded_pallas(desc, origins, dirs, cone, mesh).sum(),
                           device, iters, agree=agree)

    params = {k: v for k, v in scene.params.items()
              if k not in ("object_center", "object_rotation")}
    target = torch.zeros((height, width, 3), dtype=torch.float32, device=device)
    o, d, c, _ = shard_rays(origins, dirs, cone, mesh)
    block = shard_image(target, mesh)

    def step(sharded: bool):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        opt = torch.optim.SGD(list(p.values()), lr=1e-3)
        if sharded:
            return train_step(scene.sdf, p, opt, block, o, d, c, mesh, csdf=scene.csdf)[1]
        img = render_image_diff(scene.sdf, p, origins, dirs, cone, csdf=scene.csdf)
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        opt.step()
        return loss

    t_train1 = _sync_time(lambda: step(False), device, iters, agree=agree)
    t_train_n = _sync_time(lambda: step(True), device, iters, agree=agree)
    return {
        "devices": mesh.size(),
        "render_overhead": t_sharded / t_direct,
        "render_projected_efficiency": t_direct / t_sharded,
        "train_overhead": t_train_n / t_train1,
        "train_projected_efficiency": t_train1 / t_train_n,
    }
