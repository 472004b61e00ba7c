"""Command-line interface of the PyTorch port: the ``render`` verb.

    python -m bsdmg_tpu_torch.cli render -o out.png

renders the reference scene at 1920x1080 through CUDA kernel K1, with the
JAX CLI's flags and defaults (``bsdmg_tpu/cli.py``). ``--device`` picks the
torch device (default ``cuda``); ``--device cpu`` runs the kernel's plain
PyTorch twin, for tests. With no CUDA device and no ``--device cpu`` the
command fails: it never moves to the CPU on its own.
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
from bsdmg_tpu_torch.mesh.export import save_png
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
    r.add_argument(
        "--device", default="cuda",
        help="torch device; 'cpu' runs the plain PyTorch version (for tests)",
    )
    r.set_defaults(fn=cmd_render)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    sys.exit(main())
