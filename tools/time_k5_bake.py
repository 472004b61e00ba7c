#!/usr/bin/env python3
"""Time K5 on composed scenes, the wrapped object and the mandelbulb, and
the mesh-asset bake, of one checkout alone, on one CUDA card.

    python3 tools/time_k5_bake.py CHECKOUT [--rounds N] [--readings N] [--scenes A,B,...]
                                           [--no-bake]

Builds CHECKOUT's kernels and prints one JSON line (``SWEEP {...}``):

* for each scene of ``--scenes`` (default: the gadget,
  ``chip_smoke.LATTICE_SPEC``, ``chip_smoke.DEEP_SPEC`` (the 40-sphere
  union, the large tier), the wrapped object and the mandelbulb, from
  ``chip_smoke.MANDELBULB_CAMERA``) at the ``cli fit --image`` start of
  ``chip_smoke.FIT_SCENES`` (edge weight 1, the target rendered at the
  true parameters), at 64x64, 128x128, 256x256 and 512x512 (a reverse
  launch takes 4 lanes a ray at the first two, the mandelbulb's
  directions at the first, 1 at the others): K5 alone (``chip_smoke.graph_ms``, a CUDA graph
  of 20 calls from a prepared struct), K4 alone (the same march without
  the loss), K5's launches one by one under ``torch.profiler`` (device
  time a launch, by kernel name: the tangent launch alone), and K5 held
  against its plain version (the loss's relative error, the gradient's
  excess over ``chip_smoke``'s bars, two calls the same bits);
* for each of those scenes but the union, the wall time of one ``cli fit
  --image`` step (``cli.fit_image``, Adam and the loss's sync included;
  the difference of 70 steps and 10 over 60, host clock after a sync;
  ``--readings`` readings, five by default: the host's clock varies) at
  64x64, the command's default size, and 512x512;
* unless ``--no-bake``, the bake of ``tools/make_torus.py``'s torus at
  128^3 and 256^3 through ``bake_cuda`` (the wrapper's preparation
  included; CUDA events, median) and its kernel alone
  (``torch.profiler``'s device time of ``bake_kernel`` in those calls);
* ptxas's registers, stack and spills of K5's launches of those forms and
  the bake.

Only entry points that every checkout since the bake's port has are
called, so one run per checkout in one call (parent, change, change,
parent) compares two trees on one card.
"""

import json
import sys
import tempfile
import time
from pathlib import Path


def kernel_profile(fn, calls: int = 5) -> dict:
    """Device ms a launch of each kernel ``fn`` launches, by kernel name:
    its device time over the launches the profiler recorded (each of K5's
    kernels and the bake launch once a call; a long kernel's record is
    sometimes lost)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
        if us:
            name = ev.key.split("(")[0].replace("void ", "")
            out[name] = us / 1e3 / max(ev.count, 1)
    return out


def fit_step_ms(fit, steps: tuple[int, int] = (10, 70), readings: int = 5) -> list[float]:
    """Wall ms of one step of ``fit(steps)``, ``readings`` times: the
    difference of its two step counts' wall times (each after a sync) over
    their difference, so the target's render and the set-up cancel."""
    import torch

    fit(2)
    out = []
    for _ in range(readings):
        wall = []
        for n in steps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit(n)
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
        out.append((wall[1] - wall[0]) / (steps[1] - steps[0]) * 1e3)
    return out


#: the scenes of K5's sweep by default
SCENES = ("gadget", "lattice", "deep", "wrapped_object", "mandelbulb")


def main(argv: list[str]) -> int:
    rounds, readings, scenes = 1, 5, SCENES
    if "--rounds" in argv:
        at = argv.index("--rounds")
        rounds = int(argv[at + 1])
        argv = argv[:at] + argv[at + 2:]
    if "--readings" in argv:
        at = argv.index("--readings")
        readings = int(argv[at + 1])
        argv = argv[:at] + argv[at + 2:]
    if "--scenes" in argv:
        at = argv.index("--scenes")
        scenes = tuple(argv[at + 1].split(","))
        argv = argv[:at] + argv[at + 2:]
    bake_too = "--no-bake" not in argv
    argv = [a for a in argv if a != "--no-bake"]
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    root = Path(argv[0]).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("time_k5_bake: no CUDA device", file=sys.stderr)
        return 2
    import importlib.util

    import chip_smoke as cs
    from bsdmg_tpu_torch import cli
    from bsdmg_tpu_torch.config import MarchConfig
    from bsdmg_tpu_torch.grad import render_image_diff
    from bsdmg_tpu_torch.models.mesh_sdf import _linspace, grid_box
    from bsdmg_tpu_torch.ops.cuda import bake_kernel as bk
    from bsdmg_tpu_torch.ops.cuda import build
    from bsdmg_tpu_torch.ops.cuda import diff_kernel as dk
    from bsdmg_tpu_torch.ops.cuda.csdf import scene_bounds

    build.build()
    device = torch.device("cuda", 0)
    out = {"checkout": str(root), "card": cs.card_line(), "k5": {}, "fit_step_ms": {},
           "bake": {}}
    with tempfile.TemporaryDirectory() as tmp:
        arguments = cs.scene_arguments(Path(tmp))
        for name in scenes:
            if name == "deep":
                continue
            perturb, camera = cs.FIT_SCENES[name][:2]
            scene = cli._get_scene(arguments.get(name, name), device)
            true = dict(scene.params)
            start = cli._apply_perturb(true, cli._parse_perturb(perturb))
            for size in (64, 512):
                o, d, c = cs.rays(size, size, device, camera)
                out["fit_step_ms"][f"{name} {size}"] = ms = fit_step_ms(
                    lambda n: cli.fit_image(scene, true, start, o, d, c, steps=n, lr=0.2),
                    readings=readings)
                print("fit step", name, size, sorted(ms), flush=True)
        for name in scenes:
            perturb, camera = cs.FIT_SCENES[name][:2]
            scene = cli._get_scene(arguments.get(name, name), device)
            true = dict(scene.params)
            start = cli._apply_perturb(true, cli._parse_perturb(perturb))
            bounds = scene_bounds(scene)
            bb = None if bounds is None else cs.inflated(bounds, 0.6)
            for size in (64, 128, 256, 512):
                o, d, c = cs.rays(size, size, device, camera)
                target = render_image_diff(scene.sdf, true, o, d, c, csdf=scene.csdf,
                                           bb=bb).detach()
                scene_c, _ = dk.param_scene_c(scene.csdf, start, bb=bb, device=device)
                state = dk._target_state(target, None).contiguous()
                band = dk._band(MarchConfig(), None)

                def k5():
                    return dk._loss_grad_cuda(scene_c, o, d, c, target, state, c.numel(), 1.0,
                                              band)

                k5_ms = [cs.graph_ms(k5) for _ in range(rounds)]
                k4_ms = [cs.graph_ms(lambda: dk._march_cuda(scene_c, o, d, c, True))
                         for _ in range(rounds)]
                got = dk.render_loss_grad_cuda(scene.csdf, start, target, o, d, c, bb=bb,
                                               edge_weight=1.0)
                again = dk.render_loss_grad_cuda(scene.csdf, start, target, o, d, c, bb=bb,
                                                 edge_weight=1.0)
                plain = dk.render_loss_grad_torch(scene.csdf, start, target, o, d, c, bb=bb,
                                                  edge_weight=1.0)
                out["k5"][f"{name} {size}"] = {
                    "k5_ms": k5_ms, "k4_ms": k4_ms, "kernels_ms": kernel_profile(k5),
                    "n_prm": scene_c.n_prm, "form": scene_c.form,
                    "loss_rel_err": abs(got[0].item() - plain[0].item())
                    / max(abs(plain[0].item()), 1e-30),
                    "excess_over_bars": cs.k5_excess(got[1], plain[1]),
                    "reproducible": bool(torch.equal(got[0], again[0]) and all(
                        torch.equal(got[1][k], again[1][k]) for k in got[1])),
                }
                print(name, size, json.dumps(out["k5"][f"{name} {size}"]), flush=True)
    spec = importlib.util.spec_from_file_location("make_torus", root / "tools" / "make_torus.py")
    torus = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(torus)
    vertices, faces = torus.torus()
    lo, hi = grid_box(vertices)
    for r in (128, 256) if bake_too else ():
        axes = [torch.from_numpy(_linspace(lo[a], hi[a], r)).to(device) for a in range(3)]

        def bake():
            return bk.bake_cuda(axes, vertices, faces)

        ms = [cs.median_ms(bake, runs=3, warmup=1) for _ in range(rounds)]
        kernel = kernel_profile(bake, calls=2).get("bake_kernel")
        out["bake"][r] = {"bake_cuda_ms": ms, "kernel_ms": kernel}
        print("bake", r, json.dumps(out["bake"][r]), flush=True)
    sources = [s for s in ("diff_kernel.cu", "diff_split.cu", "diff_reverse.cu", "diff_lanes.cu",
                           "bake_kernel.cu")
               if (root / "bsdmg_tpu_torch" / "csrc" / s).exists()]
    out["ptxas"] = [row for source in sources
                    for row in cs.kernel_resources(source, ("loss_tangent_form_kernel<",
                                                            "loss_reverse_kernel<",
                                                            "loss_march_kernel<Wrapped",
                                                            "loss_march_kernel<Mandelbulb",
                                                            "bake_kernel"))]
    print("SWEEP " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
