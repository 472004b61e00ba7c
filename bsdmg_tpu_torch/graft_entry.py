"""Entry points of the port, after the JAX package's ``__graft_entry__.py``.

* :func:`entry`: the forward differentiable render of the reference scene
  at 256x144 (kernel K4's march on the card) and its arguments.
* :func:`dryrun_multichip`: ``n`` gloo ranks on the CPU, each running the
  full inverse-rendering step over a ``dp x sp`` mesh (``train_step``: K4's
  march, autograd, one gradient ``all_reduce``, an Adam update), one
  shard-local refine level, the fused step (``train_step_fused``: K5) and a
  sharded frame (``render_sharded_pallas``: K1), at tiny shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from bsdmg_tpu_torch.cam import generate_rays, look_at
from bsdmg_tpu_torch.config import MeshGenConfig
from bsdmg_tpu_torch.grad import render_image_diff
from bsdmg_tpu_torch.mesh.field import create_voxel_field
from bsdmg_tpu_torch.models import reference_object, reference_render_scene
from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene
from bsdmg_tpu_torch.parallel import (
    distribute_field,
    make_mesh,
    refine_field_sharded,
    render_sharded_pallas,
    shard_rays,
    train_step,
    train_step_fused,
)
from bsdmg_tpu_torch.parallel.launch import spawn
from bsdmg_tpu_torch.parallel.sharding import shard_image


def _flagship(width: int, height: int, device):
    scene = reference_render_scene(device=device)
    cam = look_at((5.0, 2.0, -5.0), fov=np.pi / 4, device=device)
    return (scene, *generate_rays(cam, (width, height), (1920.0, 1080.0)))


def entry(device: torch.device | str = "cuda"):
    """``(fn, args)``: ``fn(*args)`` is the differentiable render of the
    reference scene at 256x144, linear RGB ``(144, 256, 3)``."""
    scene, origins, dirs, cone = _flagship(256, 144, device)

    def forward(params, o, d, c):
        return render_image_diff(scene.sdf, params, o, d, c, csdf=scene.csdf)

    return forward, (scene.params, origins, dirs, cone)


def _dryrun_rank(device, n: int) -> dict:
    # 2-D mesh when possible: rows (dp) x cols (sp)
    n_sp = 2 if n % 2 == 0 and n > 2 else 1
    mesh = make_mesh(shape=(n // n_sp, n_sp), device=device)
    width, height = 8 * n_sp, 8 * (n // n_sp)
    scene, origins, dirs, cone = _flagship(width, height, device)
    o, d, c, _ = shard_rays(origins, dirs, cone, mesh, interleave=False)
    target = shard_image(torch.zeros((height, width, 3), device=device), mesh, interleave=False)

    params = {k: v.clone().requires_grad_() for k, v in scene.params.items()}
    _, loss = train_step(scene.sdf, params, torch.optim.Adam(list(params.values()), lr=1e-3),
                         target, o, d, c, mesh, csdf=scene.csdf)

    cfg = MeshGenConfig(init_factor=8)
    sfield = distribute_field(create_voxel_field(cfg, device), mesh)
    voxels = refine_field_sharded(compile_scene(reference_object(device=device)), sfield).count

    fit = {k: v.clone().requires_grad_() for k, v in scene.params.items()
           if k not in ("object_center", "object_rotation")}
    _, fused = train_step_fused(scene.csdf, fit, torch.optim.Adam(list(fit.values()), lr=1e-3),
                                target, o, d, c, mesh)
    frame = render_sharded_pallas(compile_scene(scene), origins, dirs, cone, mesh)
    return {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "loss": float(loss),
            "sharded_refine_voxels": voxels, "fused_loss": float(fused),
            "sharded_render_sum": float(frame.sum())}


def dryrun_multichip(n_devices: int) -> dict:
    """Spawn ``n_devices`` gloo ranks on the CPU, run one sharded training
    step, refine level, fused step and frame on each; check that every
    rank's numbers are finite and equal, print rank 0's and return them."""
    results = spawn(_dryrun_rank, n_devices, n_devices, device="cpu")
    first = results[0]
    for key in ("loss", "fused_loss", "sharded_render_sum"):
        if not np.isfinite(first[key]):
            raise RuntimeError(f"non-finite {key} {first[key]}")
    if first["sharded_refine_voxels"] <= 0:
        raise RuntimeError("sharded refine found no surface voxels")
    if any(r != first for r in results):
        raise RuntimeError(f"the ranks disagree: {results}")
    print(f"dryrun_multichip({n_devices}): mesh={first['mesh']} loss={first['loss']:.6f} "
          f"sharded_refine_voxels={first['sharded_refine_voxels']} "
          f"fused_loss={first['fused_loss']:.6f} "
          f"sharded_render_sum={first['sharded_render_sum']:.4f}")
    return first
