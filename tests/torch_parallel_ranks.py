"""What each rank of the port's multi-device tests runs.

``tests/test_torch_parallel.py`` and ``tests/test_torch_collectives.py``
spawn gloo worlds on the CPU (``bsdmg_tpu_torch/parallel/launch.py``) that
run :func:`parallel_rank` or :func:`collectives_rank`; every result comes
back as numpy. The module imports no JAX, so the ranks start quickly.

    python tests/torch_parallel_ranks.py   # one rank of the multi-host test

joins the world the ``BSDMG_*`` variables name and prints the sum of a
sharded frame.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bsdmg_tpu_torch.cam import generate_rays, look_at  # noqa: E402
from bsdmg_tpu_torch.config import MeshGenConfig  # noqa: E402
from bsdmg_tpu_torch.mesh.field import create_voxel_field  # noqa: E402
from bsdmg_tpu_torch.models import reference_object, reference_render_scene, sphere_scene  # noqa: E402
from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene  # noqa: E402
from bsdmg_tpu_torch.parallel import (  # noqa: E402
    collectives,
    distribute_field,
    extract_sharded,
    generate_mesh_sharded,
    make_mesh,
    refine_field_sharded,
    render_grid_sharded,
    render_sharded_pallas,
    shard_rays,
    train_step,
    train_step_fused,
)
from bsdmg_tpu_torch.parallel.mesh import gather_triangles  # noqa: E402
from bsdmg_tpu_torch.parallel.multihost import initialize, shard_voxels  # noqa: E402
from bsdmg_tpu_torch.parallel.sharding import shard_image  # noqa: E402
from bsdmg_tpu_torch.weights import grid_from_numpy, params_from_numpy  # noqa: E402

MODES = (False, True, "block")


def tensors(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def counted(fn, *args, **kwargs):
    """``(result, collectives)``: ``fn``'s result and the collectives it ran."""
    collectives.reset()
    out = fn(*args, **kwargs)
    return out, dict(collectives.COLLECTIVES)


def _numpy(params: dict) -> dict:
    return {k: v.detach().numpy() for k, v in params.items()}


def _grads(params: dict) -> dict:
    """The gradients the step's ``all_reduce`` summed."""
    return {k: v.grad.numpy() for k, v in params.items()}


def _steps(mesh, fit, full, scene_params, target, interleave):
    """The fused step (K5's twin) and the step through the differentiable
    render (K4's twin) with SGD(1e-2) on this rank's block."""
    device = "cpu"
    scene = reference_render_scene(device=device)
    o, d, c, _ = shard_rays(*full, mesh, interleave=interleave)
    block = shard_image(torch.from_numpy(target), mesh, interleave=interleave)
    out = {}
    p = {k: v.requires_grad_() for k, v in params_from_numpy(fit, device).items()}
    (_, loss), out["fused_collectives"] = counted(
        train_step_fused, scene.csdf, p, torch.optim.SGD(list(p.values()), lr=1e-2), block, o, d, c,
        mesh)
    out["fused"] = (float(loss), _numpy(p))
    out["fused_grad"] = _grads(p)
    p = {k: v.requires_grad_() for k, v in params_from_numpy(scene_params, device).items()}
    (_, loss), out["step_collectives"] = counted(
        train_step, scene.sdf, p, torch.optim.SGD(list(p.values()), lr=1e-2), block, o, d, c, mesh,
        csdf=scene.csdf)
    out["step"] = (float(loss), _numpy(p))
    out["step_grad"] = _grads(p)
    return out


def parallel_rank(device, shape, inputs: dict, with_bench: bool) -> dict:
    """Everything ``tests/test_torch_parallel.py`` holds against the
    single-device port and the JAX package, from one world; with
    ``with_bench`` also the scaling benches' results at 16x8."""
    torch.manual_seed(0)
    mesh = make_mesh(shape=shape, device=device)
    out = {"shape": tuple(mesh.shape), "names": mesh.mesh_dim_names,
           "coordinate": tuple(mesh.get_coordinate())}
    try:
        make_mesh(shape=(3, 2), device=device)
    except ValueError as e:
        out["bad_shape"] = str(e)

    out["voxel_block"] = shard_voxels(torch.from_numpy(inputs["voxels"]), mesh).numpy()
    noise = tensors(*inputs["noise"])
    out["blocks"] = {il: tuple(b.numpy() for b in shard_rays(*noise, mesh, interleave=il)[:3])
                     for il in (True, False)}

    rays = tensors(*inputs["rays"])
    desc = compile_scene(reference_render_scene(device=device))
    out["frames"] = {str(m): render_sharded_pallas(desc, *rays, mesh, two_phase=m).numpy()
                     for m in MODES}
    grid = grid_from_numpy(*inputs["grid"], device)
    out["grid_frame"] = render_grid_sharded(grid, *tensors(*inputs["grid_rays"]), mesh).numpy()

    out.update(_steps(mesh, inputs["fit"], tensors(*inputs["fit_rays"]), inputs["scene_params"],
                      inputs["target"], interleave=False))

    cfg = MeshGenConfig(init_factor=8)
    m = generate_mesh_sharded(compile_scene(reference_object(device=device)), mesh, 1, cfg,
                              device=device)
    out["mesh"] = (m.vertices, m.triangle_count, m.vertex_count)
    sphere = compile_scene(sphere_scene(1.0, device=device))
    sfield = distribute_field(create_voxel_field(MeshGenConfig(init_factor=8, bb_size=4.0), device),
                              mesh)
    refined = refine_field_sharded(sphere, sfield)
    out["refined_local"] = refined.lowers.numpy()
    out["refined_counts"] = refined.counts
    out["gathered"] = refined.gather().lowers.numpy()
    if with_bench:
        out.update(bench_rank(device))
    return out


def bench_rank(device) -> dict:
    """The scaling benches at 16x8, one timed pass."""
    from bsdmg_tpu_torch import bench

    return {"scaling": bench.benchmark_scaling(16, 8, iters=1, device=device),
            "scaling_proxy": bench.benchmark_scaling_overhead(16, 8, iters=1, device=device)}


def collectives_rank(device, shape) -> dict:
    """The collectives each multi-device path of the port runs, by kind."""
    mesh = make_mesh(shape=shape, device=device)
    cam = look_at((5.0, 2.0, -5.0), fov=np.pi / 4, device=device)
    rays = generate_rays(cam, (32, 16), (1920.0, 1080.0))
    scene = reference_render_scene(device=device)
    desc = compile_scene(scene)
    counts = {}
    for m in MODES:
        _, counts[f"frame two_phase={m}"] = counted(render_sharded_pallas, desc, *rays, mesh,
                                                    two_phase=m)
    _, counts["shard_rays"] = counted(shard_rays, *rays, mesh)
    x = np.linspace(-1.5, 1.5, 16, dtype=np.float32)
    gx, gy, gz = np.meshgrid(x, x, x, indexing="ij")
    grid = grid_from_numpy(np.sqrt(gx * gx + gy * gy + gz * gz) - 1.0, (-1.5,) * 3, (1.5,) * 3,
                           device)
    _, counts["grid frame"] = counted(render_grid_sharded, grid, *rays, mesh)

    target = np.zeros((16, 32, 3), np.float32)
    fit = {k: v.numpy() for k, v in scene.params.items()
           if k not in ("object_center", "object_rotation")}
    steps = _steps(mesh, fit, rays, _numpy(scene.params), target, interleave=True)
    counts["train_step_fused"] = steps["fused_collectives"]
    counts["train_step"] = steps["step_collectives"]

    obj = compile_scene(reference_object(device=device))
    cfg = MeshGenConfig(init_factor=8)
    sfield, counts["distribute_field"] = counted(distribute_field,
                                                 create_voxel_field(cfg, device), mesh)
    refined, counts["refine_field_sharded"] = counted(refine_field_sharded, obj, sfield)
    soup, counts["extract_sharded"] = counted(extract_sharded, obj, refined, cfg)
    _, counts["gather_triangles"] = counted(gather_triangles, soup, mesh)
    _, counts["ShardedField.gather"] = counted(refined.gather)
    _, counts["generate_mesh_sharded"] = counted(generate_mesh_sharded, obj, mesh, 1, cfg,
                                                 device=device)
    return counts


def failing_rank(device, directory: str) -> None:
    """Rank 0 writes its pid to ``directory`` and waits for rank 1 at a
    barrier, until it is stopped; rank 1 raises once the pid is there."""
    if torch.distributed.get_rank() == 1:
        for _ in range(600):
            if (Path(directory) / "rank0.pid").exists():
                break
            time.sleep(0.05)
        raise ValueError("a planted failure")
    hanging_rank(device, directory)


def hanging_rank(device, directory: str) -> None:
    """Writes this rank's pid to ``directory`` and waits for ever."""
    (Path(directory) / f"rank{torch.distributed.get_rank()}.pid").write_text(str(os.getpid()))
    torch.distributed.barrier()
    time.sleep(3600)


def main() -> int:
    """One rank of a multi-host world named by the ``BSDMG_*`` variables:
    prints ``MHRESULT <rank> <world> <frame sum>``."""
    torch.set_num_threads(1)
    initialize(device="cpu")
    mesh = make_mesh(device="cpu")
    cam = look_at((5.0, 2.0, -5.0), fov=np.pi / 4, device="cpu")
    rays = generate_rays(cam, (64, 32), (1920.0, 1080.0))
    frame = render_sharded_pallas(compile_scene(reference_render_scene(device="cpu")), *rays, mesh)
    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    print(f"MHRESULT {rank} {world} {float(frame.double().sum()):.9f}", flush=True)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
