#!/usr/bin/env python3
"""Time composed programs that fit the kernels' small tier through both of
their tiers, on a machine with an H100 and nvcc.

    python3 tools/tier_compare.py

A node or parameter program within the small tier's caps (``csdf.py::
large_tier``) runs in the ``Composed`` instantiations (K1-K3, K6, K7) and
``ProgramForm`` (K4, K5), whose stacks live in registers and local memory;
one beyond them runs in ``ComposedLarge`` and ``ProgramLargeForm``, whose
stacks live in a slot-major scratch buffer and whose parameter values are
read from device memory. This script forces the large tier on the gadget
and the lattice (``chip_smoke.py``'s specs), which the small tier takes,
and times each kernel alone in both tiers (``chip_smoke.graph_ms``: CUDA
graphs of 20 launches from a prepared struct), in the order small, large,
small, large: K1 at 1920x1080 and K4 and K5 at the 512x512 fit point (the
``fit --image`` start against the render at the true parameters, bounds
inflated by 0.6, the edge term on). Each tier's outputs are compared too
(bit-equal, and the largest difference). Prints the card's name and power
limit and one JSON line per scene.
"""

import contextlib
import json
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

SCENES = {"gadget": "n3_radius=1.2", "lattice": "n2_minor_radius=1.2"}
FIT_SIZE = 512
ROUNDS = 2


@contextlib.contextmanager
def tier(large: bool):
    """Every composed program in the large tier (``large``) or as
    ``csdf.large_tier`` picks it."""
    from bsdmg_tpu_torch.ops.cuda import csdf
    from bsdmg_tpu_torch.ops.cuda import diff_kernel as dk

    pick = csdf.large_tier
    forced = (lambda prog, n_values=0, *, forward=False: True) if large else pick
    csdf.large_tier = dk.large_tier = forced
    try:
        yield
    finally:
        csdf.large_tier = dk.large_tier = pick


def readings(scene, start, true, device) -> dict:
    """Each kernel's time alone and its outputs in the tier in force."""
    from bsdmg_tpu_torch.config import MarchConfig
    from bsdmg_tpu_torch.grad import render_image_diff
    from bsdmg_tpu_torch.ops.cuda import diff_kernel as dk
    from bsdmg_tpu_torch.ops.cuda import render_kernel as rk
    from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene, scene_bounds

    cfg = MarchConfig()
    desc = compile_scene(scene)
    o, d, c = chip_smoke.rays(1920, 1080, device)
    desc_c = rk.scene_desc_c(desc, cfg, device, taped=False)
    rgb = torch.empty((*c.shape, 3), device=device)
    out = {"structure": desc_c.structure,
           "K1 ms": chip_smoke.graph_ms(lambda: rk._render_cuda(
               desc_c, o, d, c, rgb, None, cap=cfg.step_limit, cull=desc.bounds is not None)),
           "K1 planes": rk.render_image_cuda(desc, o, d, c, return_planes=True)}
    bounds = scene_bounds(scene)
    bb = None if bounds is None else chip_smoke.inflated(bounds, 0.6)
    o, d, c = chip_smoke.rays(FIT_SIZE, FIT_SIZE, device)
    target = render_image_diff(scene.sdf, true, o, d, c, csdf=scene.csdf, bb=bb).detach()
    scene_c, _ = dk.param_scene_c(scene.csdf, start, bb=bb, device=device)
    state = dk._target_state(target, None).contiguous()
    band = dk._band(cfg, None)
    out.update({
        "form": scene_c.form,
        "K4 ms": chip_smoke.graph_ms(lambda: dk._march_cuda(scene_c, o, d, c, False)),
        "K5 ms": chip_smoke.graph_ms(lambda: dk._loss_grad_cuda(
            scene_c, o, d, c, target, state, c.numel(), 1.0, band)),
        "K4 planes": dk.march_params_cuda(scene.csdf, start, o, d, c, bb=bb, track_min=True),
        "K5 out": dk.render_loss_grad_cuda(scene.csdf, start, target, o, d, c, bb=bb,
                                           edge_weight=1.0),
    })
    torch.cuda.synchronize()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("tier_compare: no CUDA device", file=sys.stderr)
        return 2
    from bsdmg_tpu_torch import cli
    from bsdmg_tpu_torch.ops.cuda import build

    build.build()
    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(card)
    with tempfile.TemporaryDirectory() as tmp:
        arguments = chip_smoke.scene_arguments(Path(tmp))
        for name, perturb in SCENES.items():
            scene = cli._get_scene(arguments[name], device)
            true = dict(scene.params)
            start = cli._apply_perturb(true, cli._parse_perturb(perturb))
            times = {"small": [], "large": []}
            outs = {}
            for _ in range(ROUNDS):
                for label in ("small", "large"):
                    with tier(label == "large"):
                        r = readings(scene, start, true, device)
                    times[label].append({k: r[k] for k in ("K1 ms", "K4 ms", "K5 ms")})
                    outs[label] = r
            small, large = outs["small"], outs["large"]
            pairs = {
                "K1": list(zip(small["K1 planes"], large["K1 planes"])),
                "K4": list(zip(small["K4 planes"], large["K4 planes"])),
                "K5": [(small["K5 out"][0], large["K5 out"][0])]
                + [(small["K5 out"][1][k], large["K5 out"][1][k]) for k in small["K5 out"][1]],
            }
            print(json.dumps({
                "scene": name, "card": card,
                "structures": {"small": small["structure"], "large": large["structure"]},
                "forms": {"small": small["form"], "large": large["form"]},
                "times": times,
                "bit_equal": {k: all(torch.equal(a, b) for a, b in v) for k, v in pairs.items()},
                "max_abs_diff": {k: max((a.float() - b.float()).abs().nan_to_num(0.0).max().item()
                                        for a, b in v) for k, v in pairs.items()},
            }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
