#!/usr/bin/env python3
"""Time the mesh, grid and differentiable-render kernels of one checkout
alone, on one CUDA card.

    python3 tools/time_kernels_alone.py CHECKOUT [TORUS_CACHE.pt] [--no-mesh]

Builds CHECKOUT's kernels and prints one JSON line (``SWEEP {...}``): K1, K2
and K3 (on K2's planes) at 1920x1080, K1 and K3 held against their plain
versions bit for bit; K6 at levels 3 and 5 and K7 at level 3 of the
reference object on the staged path's inputs (the listed crossing edges)
and on the JAX kernel's padded lanes (``chip_smoke.k7_inputs``), K6 (also
with fd4 projection normals and with the centroid winding) and K7 (both
layouts) held against their plain versions bit for bit (not with
``--no-mesh``); each launch of the contraction route (K9's two levels, K8's
finish) and P1's normals on the 1080p torus frame, and K8 fresh on the
gather route's 64^3 mip; K4 as the fit's target render at 64x64, 512x512
and 1920x1080 (and with the scene's 16 values at 512x512 and 1920x1080), K5 at the
64x64 and 512x512 fit points and the 512x512 bench point; each alone in a
CUDA graph (``chip_smoke.graph_ms`` from CHECKOUT's ``chip_smoke.py``),
with K6 at level 3, every grid launch and K4 at 512x512 held against their
plain versions bit for bit (K4's dfdt within ``chip_smoke.DFDT_ATOL``);
then ptxas's registers and spills of K6, the grid march kernels and K4's
and K5's march launches, and ``chip_smoke.stencil_probe``'s registers and
SASS counts of K1, K3, K6 and K7. Run it once per checkout in one call (variants of
a kernel unpacked side by side) to compare them on one card. With
TORUS_CACHE the baked 128^3 torus grid is read from that file, or written
there by the first run.
"""

import json
import sys
import time
from pathlib import Path


def main(argv: list[str]) -> int:
    mesh = "--no-mesh" not in argv
    argv = [a for a in argv if a != "--no-mesh"]
    if len(argv) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 2
    root = Path(argv[0]).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("time_kernels_alone: no CUDA device", file=sys.stderr)
        return 2
    import dataclasses

    import chip_smoke as cs
    from bsdmg_tpu_torch import cli
    from bsdmg_tpu_torch.cam import generate_rays, look_at
    from bsdmg_tpu_torch.config import MarchConfig, MeshGenConfig
    from bsdmg_tpu_torch.grad import render_image_diff
    from bsdmg_tpu_torch.models import reference_object, reference_render_scene
    from bsdmg_tpu_torch.models.mesh_sdf import SdfGrid, coarsen_grid_lower
    from bsdmg_tpu_torch.ops.cuda import build, mc_kernel, mesh_kernel
    from bsdmg_tpu_torch.ops.cuda import diff_kernel as dk
    from bsdmg_tpu_torch.ops.cuda import render_kernel as rk
    from bsdmg_tpu_torch.ops.cuda import grid_kernel as tg
    from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene, scene_bounds, sdf_fns
    from bsdmg_tpu_torch.ops.marching_cubes import kernel_inputs

    t0 = time.perf_counter()
    build.build()
    device = torch.device("cuda", 0)
    out = {"checkout": root.name, "card": cs.card_line(), "build_s": time.perf_counter() - t0}
    march = MarchConfig()
    scene = reference_render_scene(device=device)
    rdesc = compile_scene(scene)
    rdesc_c = rk.scene_desc_c(rdesc, march)
    o, d, c = cs.rays(1920, 1080, device)
    rgb = torch.empty((1080, 1920, 3), device=device)
    planes = tuple(torch.empty_like(c, dtype=dt) for dt in (torch.float32, torch.int32, torch.int32))
    out["K1 1920x1080"] = cs.graph_ms(lambda: rk._render_cuda(rdesc_c, o, d, c, rgb, None,
                                                              cap=march.step_limit))
    out["K2 1920x1080"] = cs.graph_ms(lambda: rk._trace_cuda(rdesc_c, o, d, c, None, planes,
                                                             cap=march.step_limit))
    traced = rk.trace_cuda(rdesc, o, d, c)
    out["K3 1920x1080"] = cs.graph_ms(lambda: rk._shade_cuda(rdesc_c, o, d, traced[0], traced[2],
                                                             rgb))
    out["K1 exact"] = cs.same(rk.render_image_cuda(rdesc, o, d, c, return_planes=True),
                              rk.render_image_planes_torch(rdesc, o, d, c))
    out["K3 exact"] = torch.equal(rk.shade_cuda(rdesc, o, d, traced[0], traced[2]),
                                  rk.shade_planes_torch(rdesc, o, d, traced[0], traced[2]))
    cfg = MeshGenConfig()
    desc = compile_scene(reference_object(device=device))
    fields = cs.mesh_fields(desc, cfg, device, 5 if mesh else 0)
    for level in (3, 5) if mesh else ():
        f = fields[level]
        args, kwargs = kernel_inputs(desc, f.lowers, f.voxel_size, cfg)
        if level == 3:
            for tag, change in (("", {}), (" fd4", dict(projection_normals="fd4")),
                                (" centroid", dict(winding_normals="centroid_fd4"))):
                a, kw = kernel_inputs(desc, f.lowers, f.voxel_size,
                                      dataclasses.replace(cfg, **change))
                kern = mc_kernel.mc_fused_cuda(desc, *a, **kw)
                plain = mc_kernel.mc_fused_torch(sdf_fns(desc), *a, **kw)
                out[f"K6 L3{tag} exact"] = all(torch.equal(x, y) for x, y in zip(kern, plain))
        out[f"K6 L{level}"] = cs.k6_alone_ms(desc, args, kwargs)
    if mesh:
        pipeline, padded, kwargs = cs.k7_inputs(desc, fields[3], cfg)
        for tag, args in (("", pipeline), (" padded", padded)):
            out[f"K7 L3{tag}"] = cs.k7_alone_ms(desc, args, kwargs)
            kern = mesh_kernel.project_edges_cuda(desc, *args, **kwargs)
            plain = mesh_kernel.project_edges_torch(sdf_fns(desc), *args[:3], args[3].bool(),
                                                    **kwargs)
            out[f"K7 L3{tag} exact"] = all(torch.equal(x, y) for x, y in zip(kern, plain))

    cache = Path(argv[1]) if len(argv) == 2 else None
    if cache is not None and cache.exists():
        saved = torch.load(cache)
        grid = SdfGrid(values=saved["values"].to(device), lo=tuple(saved["lo"]),
                       hi=tuple(saved["hi"]))
    else:
        grid = cs.torus_grid(device)
        if cache is not None:
            torch.save({"values": grid.values.cpu(), "lo": list(grid.lo), "hi": list(grid.hi)},
                       cache)
    frame = generate_rays(look_at(cs.TORUS_CAMERA, device=device), (1920, 1080), cs.SCREEN)
    _, launches, stencil, _ = cs.staged_contraction(grid, frame, march)
    mip = tg.interp_sampler(coarsen_grid_lower(grid, tg.MID_RESOLUTION))
    launches.append(("K8 64^3 mip fresh", mip, {},
                     tg.grid_march_cuda(mip, *frame, march, budget=march.step_limit)))
    for name, sampler, state, result in launches:
        kern = tg.grid_march_cuda(sampler, *frame, march, budget=march.step_limit, **state)
        plain = tg.grid_march_torch(sampler, *frame, march, budget=march.step_limit, **state)
        out[f"{name} exact"] = all(torch.equal(a, b) for a, b in zip(kern, plain))
        out[name] = cs.march_kernel_ms(sampler, frame, march, state)
    out["P1"] = cs.sample_kernel_ms(tg.interp_sampler(grid), stencil)

    bb6, bb25 = (cs.inflated(scene_bounds(scene), by) for by in (0.6, 0.25))
    true = cs.shape_params(scene)
    perturbed = cli._apply_perturb(true, cs.FIT_PERTURB)
    band = dk._band(march, None)
    for w, h in ((64, 64), (512, 512), (1920, 1080)):
        o, d, c = cs.rays(w, h, device)
        for params, tag in ((true, ""), (scene.params, " 16 values")):
            if tag and w != 1920 and w != 512:
                continue
            scene_c, _ = dk.param_scene_c(scene.csdf, params, bb=bb6)
            out[f"K4 {w}x{h}{tag}"] = cs.graph_ms(lambda: dk._march_cuda(scene_c, o, d, c, False))
            if w == 512:
                for track in (False, True):
                    kern = dk.march_params_cuda(scene.csdf, params, o, d, c, bb=bb6,
                                                track_min=track)
                    plain = dk.march_params_torch(scene.csdf, params, o, d, c, bb=bb6,
                                                  track_min=track)
                    out[f"K4 {w}x{h}{tag} track {track} exact"] = all(
                        torch.equal(a, b) for i, (a, b) in enumerate(zip(kern, plain)) if i != 3
                    ) and cs._max_err(kern[3], plain[3]) <= cs.DFDT_ATOL
        if w == 1920:
            continue
        points = [("fit", perturbed, bb6, 1.0)] + ([("bench", true, bb25, 0.0)] if w == 512 else [])
        for name, params, bb, edge in points:
            target = (render_image_diff(scene.sdf, true, o, d, c, csdf=scene.csdf, bb=bb6).detach()
                      if edge else torch.zeros((h, w, 3), device=device))
            state = dk._target_state(target, None).contiguous() if edge else None
            scene_c, _ = dk.param_scene_c(scene.csdf, params, bb=bb)
            out[f"K5 {w}x{h} {name}"] = cs.graph_ms(
                lambda: dk._loss_grad_cuda(scene_c, o, d, c, target, state, c.numel(), edge, band))
    print("SWEEP " + json.dumps(out), flush=True)
    for source, prefixes in (("mc_kernel.cu", ("mc_",)),
                             ("grid_kernel.cu", ("contraction_", "grid_march")),
                             ("diff_kernel.cu", ("march_params", "loss_march"))):
        for r in cs.kernel_resources(source, prefixes):
            print(f"  ptxas {root.name}: {json.dumps(r)}")
    cs.stencil_probe(root.name)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
