#!/usr/bin/env python3
"""Time the mesh and grid kernels of one checkout alone, on one CUDA card.

    python3 tools/time_kernels_alone.py CHECKOUT [TORUS_CACHE.pt]

Builds CHECKOUT's kernels and prints one JSON line (``SWEEP {...}``): K6 at
levels 3 and 5 and K7 at level 3 of the reference object, and each launch
of the contraction route (K9's two levels, K8's finish) and P1's normals on
the 1080p torus frame, each alone in a CUDA graph (``chip_smoke.graph_ms``
from CHECKOUT's ``chip_smoke.py``), with K6 at level 3 and every grid launch
held against its plain version bit for bit; then ptxas's registers and
spills of K6 and the grid march kernels. Run it once per checkout in one
call (variants of a kernel unpacked side by side) to compare them on one
card. With TORUS_CACHE the baked 128^3 torus grid is read from that file,
or written there by the first run.
"""

import json
import sys
import time
from pathlib import Path


def main(argv: list[str]) -> int:
    if len(argv) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 2
    root = Path(argv[0]).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("time_kernels_alone: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from bsdmg_tpu_torch.cam import generate_rays, look_at
    from bsdmg_tpu_torch.config import MarchConfig, MeshGenConfig
    from bsdmg_tpu_torch.models import reference_object
    from bsdmg_tpu_torch.models.mesh_sdf import SdfGrid
    from bsdmg_tpu_torch.ops.cuda import build, mc_kernel
    from bsdmg_tpu_torch.ops.cuda import grid_kernel as tg
    from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene, sdf_fns
    from bsdmg_tpu_torch.ops.marching_cubes import kernel_inputs

    t0 = time.perf_counter()
    build.build()
    device = torch.device("cuda", 0)
    out = {"checkout": root.name, "card": cs.card_line(), "build_s": time.perf_counter() - t0}
    cfg = MeshGenConfig()
    desc = compile_scene(reference_object(device=device))
    fields = cs.mesh_fields(desc, cfg, device, 5)
    for level in (3, 5):
        f = fields[level]
        args, kwargs = kernel_inputs(desc, f.lowers, f.voxel_size, cfg)
        if level == 3:
            kern = mc_kernel.mc_fused_cuda(desc, *args, **kwargs)
            plain = mc_kernel.mc_fused_torch(sdf_fns(desc), *args, **kwargs)
            out["K6 L3 exact"] = all(torch.equal(a, b) for a, b in zip(kern, plain))
        out[f"K6 L{level}"] = cs.k6_alone_ms(desc, args, kwargs)
    f = fields[3]
    args, kwargs = kernel_inputs(desc, f.lowers, f.voxel_size, MeshGenConfig(interpolate_edges=True))
    out["K7 L3"] = cs.k7_alone_ms(desc, args, kwargs)

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
    march = MarchConfig()
    frame = generate_rays(look_at(cs.TORUS_CAMERA, device=device), (1920, 1080), cs.SCREEN)
    _, launches, stencil, _ = cs.staged_contraction(grid, frame, march)
    for name, sampler, state, result in launches:
        plain = tg.grid_march_torch(sampler, *frame, march, budget=march.step_limit, **state)
        out[f"{name} exact"] = all(torch.equal(a, b) for a, b in zip(result, plain))
        out[name] = cs.march_kernel_ms(sampler, frame, march, state)
    out["P1"] = cs.sample_kernel_ms(tg.interp_sampler(grid), stencil)
    print("SWEEP " + json.dumps(out), flush=True)
    for source, prefixes in (("mc_kernel.cu", ("mc_",)),
                             ("grid_kernel.cu", ("contraction_", "grid_march"))):
        for r in cs.kernel_resources(source, prefixes):
            print(f"  ptxas {root.name}: {json.dumps(r)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
