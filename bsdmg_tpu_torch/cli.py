"""Command-line interface of the PyTorch port: the ``render`` and ``mesh`` verbs.

    python -m bsdmg_tpu_torch.cli render -o out.png
    python -m bsdmg_tpu_torch.cli mesh -o out.obj
    python -m bsdmg_tpu_torch.cli mesh --interpolate-edges -o out.obj

``render`` draws the reference scene at 1920x1080 through CUDA kernel K1;
``mesh`` refines the reference object three levels from a 32^3 grid and
extracts its surface through kernel K6 (edge midpoints) or K7
(``--interpolate-edges``). Both keep the JAX CLI's flags and defaults
(``bsdmg_tpu/cli.py``). ``--device`` picks the torch device (default
``cuda``); ``--device cpu`` runs the kernels' plain PyTorch twins, for
tests. With no CUDA device and no ``--device cpu`` a command fails: it
never moves to the CPU on its own.
"""

from __future__ import annotations

import argparse
import logging
import math
import sys
import time

import numpy as np
import torch

from bsdmg_tpu_torch.cam import generate_rays, look_at
from bsdmg_tpu_torch.config import MeshGenConfig
from bsdmg_tpu_torch.mesh.export import load_field, save_field, save_obj, save_png, save_vtk
from bsdmg_tpu_torch.mesh.pipeline import generate_mesh
from bsdmg_tpu_torch.models import get_scene
from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene
from bsdmg_tpu_torch.ops.cuda.render_kernel import render_image_cuda
from bsdmg_tpu_torch.ops.shade import to_rgba8

log = logging.getLogger("bsdmg_tpu_torch")


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is False; "
            "pass --device cpu to run the plain PyTorch path"
        )
    return device


def _get_scene(name: str, device: torch.device):
    if name.startswith(("mesh:", "spec:")) or name.endswith(".json"):
        raise NotImplementedError(
            f"scene {name!r}: mesh-asset and composed scenes are not ported "
            "to bsdmg_tpu_torch yet"
        )
    return get_scene(name, device=device)


def cmd_render(args) -> None:
    device = _device(args.device)
    scene = _get_scene(args.scene, device)
    cam = look_at(tuple(args.camera), tuple(args.target), fov=args.fov, device=device)
    origins, dirs, cone = generate_rays(
        cam, (args.width, args.height), (args.screen_width, args.screen_height)
    )
    t0 = time.perf_counter()
    img = render_image_cuda(compile_scene(scene), origins, dirs, cone)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log.info(
        "rendered %dx%d on %s in %.3fs", args.width, args.height, device,
        time.perf_counter() - t0,
    )
    out = args.output or "render.png"
    if out.endswith(".npy"):
        np.save(out, img.cpu().numpy())
    else:
        save_png(to_rgba8(img).cpu().numpy(), out)
    log.info("wrote %s", out)


def cmd_mesh(args) -> None:
    device = _device(args.device)
    if args.sharded:
        raise NotImplementedError(
            "--sharded: multi-device mesh generation is not ported to bsdmg_tpu_torch yet"
        )
    # the render scene's wireframe is not part of the meshed object
    scene_name = "reference_object" if args.scene == "reference_render_scene" else args.scene
    desc = compile_scene(_get_scene(scene_name, device))
    cfg = MeshGenConfig(
        init_factor=args.init_factor,
        bb_size=args.bb_size,
        newton_iters=args.newton_iters,
        interpolate_edges=args.interpolate_edges,
    )

    def on_level(field):
        log.info("level %d: %d voxels of size %.5f", field.level, field.count, field.voxel_size)
        if args.checkpoint:
            save_field(field, f"{args.checkpoint}.L{field.level}.npz")

    t0 = time.perf_counter()
    field = None
    if args.resume:
        field = load_field(args.resume, device)
        log.info("resumed from %s: level %d, %d voxels", args.resume, field.level, field.count)
    mesh = generate_mesh(
        desc, refine_steps=args.refine, config=cfg, on_level=on_level, device=device,
        field=field,
    )
    log.info(
        "mesh: %d vertices, %d triangles on %s in %.3fs",
        mesh.vertex_count, mesh.triangle_count, device, time.perf_counter() - t0,
    )
    out = args.output or "generated_mesh.obj"
    if out.endswith(".vtk"):
        save_vtk(mesh, out)
    else:
        save_obj(mesh, out)
    log.info("wrote %s", out)


def _add_device(parser) -> None:
    parser.add_argument(
        "--device", default="cuda",
        help="torch device; 'cpu' runs the plain PyTorch versions (for tests)",
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bsdmg_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    r = sub.add_parser("render", help="sphere-trace a scene to PNG/NPY")
    r.add_argument(
        "--scene", default="reference_render_scene",
        help="scene name (bsdmg_tpu_torch.models.SCENES)",
    )
    r.add_argument("--camera", type=float, nargs=3, default=[5.0, 2.0, -5.0])
    r.add_argument("--target", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    r.add_argument("--fov", type=float, default=math.pi / 4, help="radians")
    r.add_argument("--width", type=int, default=1920)
    r.add_argument("--height", type=int, default=1080)
    r.add_argument("--screen-width", type=float, default=1920.0)
    r.add_argument("--screen-height", type=float, default=1080.0)
    r.add_argument("--output", "-o", default=None, help=".png (default render.png) or .npy")
    _add_device(r)
    r.set_defaults(fn=cmd_render)

    m = sub.add_parser("mesh", help="hierarchical refine + marching cubes -> OBJ/VTK")
    m.add_argument(
        "--scene", default="reference_render_scene",
        help="scene name; the render scene meshes its object, reference_object",
    )
    m.add_argument("--refine", type=int, default=3, help="refinement levels")
    m.add_argument("--init-factor", type=int, default=32)
    m.add_argument("--bb-size", type=float, default=5.0)
    m.add_argument("--newton-iters", type=int, default=24)
    m.add_argument("--interpolate-edges", action="store_true")
    m.add_argument(
        "--sharded", action="store_true",
        help="multi-device refine + extraction (not ported: raises)",
    )
    m.add_argument("--checkpoint", default=None, help="save field npz per level")
    m.add_argument(
        "--resume", default=None, help="resume from a field npz; --refine counts further levels"
    )
    m.add_argument("--output", "-o", default=None, help=".obj (default generated_mesh.obj) or .vtk")
    _add_device(m)
    m.set_defaults(fn=cmd_mesh)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    sys.exit(main())
