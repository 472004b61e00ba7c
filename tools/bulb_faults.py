#!/usr/bin/env python3
"""Plant a fault in a copy of the tree and show the mandelbulb's K4/K5 bars
fail, one copy per fault, on one CUDA card.

    python3 tools/bulb_faults.py            # from the repository root

The mandelbulb's K4 and K5 are held against their plain versions by
agreement bars (``chip_smoke.bulb_readings`` and ``bulb_failed``: outcomes,
the hits' depths, dfdt, K5's loss, and at 64x64 its gradient over the live
tiles of an 8x8 split of the frame, printed at 512x512), since libm and the
two ways of taking the normal's derivatives round differently. The sound
tree and a copy per fault below (in a temporary directory) each build
their kernels and print their readings and the bars they fail at the
start of ``cli fit --image --scene mandelbulb --camera 2 1 -2 --perturb
scale=1.1``, at 64x64 (the CLI's frame) and 512x512, one line each.
Nothing in the checkout changes.
"""

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FAULTS = {
    # K4: the scale of the SDF a little off: the depths and dfdt
    "scale_small": ("bsdmg_tpu_torch/csrc/param_forms.cuh", "prm(0) * 0.4f;", "prm(0) * 0.4004f;"),
    # K4: the scale far off: the outcomes
    "scale_large": ("bsdmg_tpu_torch/csrc/param_forms.cuh", "prm(0) * 0.4f;", "prm(0) * 0.42f;"),
    # K5: one atan2 tangent term of the duals of duals flipped: the normal,
    # so the loss
    "normal": ("bsdmg_tpu_torch/csrc/nested_dual.cuh",
               "r.t[i] = y.t[i] * wy + x.t[i] * wx;", "r.t[i] = y.t[i] * wy - x.t[i] * wx;"),
    # K5: the parameter tangents of the forms' tangent launch 1% off: the
    # gradient alone
    "gradient": ("bsdmg_tpu_torch/csrc/diff_kernel.cu",
                 "for (int m = 0; m < L; ++m) acc[m + 1] = loss.t[m];",
                 "for (int m = 0; m < L; ++m) acc[m + 1] = loss.t[m] * 1.01f;"),
}


def bars(root: Path) -> None:
    """Build ``root``'s kernels and print the mandelbulb's readings there."""
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from bsdmg_tpu_torch import cli
    from bsdmg_tpu_torch.grad import render_image_diff
    from bsdmg_tpu_torch.ops.cuda import build
    from bsdmg_tpu_torch.ops.cuda.csdf import scene_bounds

    build.build()
    device = torch.device("cuda", 0)
    scene = cli._get_scene("mandelbulb", device)
    true = dict(scene.params)
    start = cli._apply_perturb(true, cli._parse_perturb("scale=1.1"))
    bb = cs.inflated(scene_bounds(scene), 0.6)
    for size in (64, 512):
        o, d, c = cs.rays(size, size, device, cs.MANDELBULB_CAMERA)
        target = render_image_diff(scene.sdf, true, o, d, c, csdf=scene.csdf, bb=bb).detach()
        out = cs.bulb_readings(scene, start, o, d, c, target, bb)
        print(f"{size}x{size}: fails {cs.bulb_failed(out, tiles=size == 64)} {json.dumps(out)}")


def main(argv: list[str]) -> int:
    if argv:
        bars(Path(argv[0]))
        return 0
    out = subprocess.run([sys.executable, str(ROOT / "tools" / "bulb_faults.py"), str(ROOT)],
                         capture_output=True, text=True, timeout=900)
    print(f"sound: {out.stdout.strip()} {out.stderr.strip()[-800:]}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for name, (path, old, new) in FAULTS.items():
            copy = Path(tmp) / name
            copy.mkdir()
            shutil.copy2(ROOT / "chip_smoke.py", copy)
            shutil.copytree(ROOT / "bsdmg_tpu_torch", copy / "bsdmg_tpu_torch",
                            ignore=shutil.ignore_patterns("_build", "__pycache__"))
            source = (copy / path).read_text()
            if source.count(old) != 1:
                raise RuntimeError(f"fault {name}: {old!r} is not in {path} once")
            (copy / path).write_text(source.replace(old, new))
            out = subprocess.run([sys.executable, str(ROOT / "tools" / "bulb_faults.py"), str(copy)],
                                 capture_output=True, text=True, timeout=900)
            print(f"fault {name}: {out.stdout.strip()[-3000:]} {out.stderr.strip()[-800:]}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
