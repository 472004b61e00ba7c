#!/usr/bin/env python3
"""Measure K1 of composed scenes (``render_kernel<Composed, …>`` and
``render_kernel<ComposedLarge, …>``), and the K2, K3, K6 and K7 of the same
scenes, of one checkout on one CUDA card.

    python3 tools/composed_probe.py CHECKOUT [--no-mesh] [--sass-dir DIR]

Builds CHECKOUT's kernels and prints one JSON line (``COMPOSED {...}``):

* ptxas's registers, stack and spill bytes of every Composed and
  ComposedLarge instantiation of K1, K2, K3, K6 and K7;
* the SASS of K1 FRESH of both tiers, culled and not: for the kernel and
  for each of its loops (``chip_smoke.loops_of``'s backward branches), the
  static instructions and the local (``LDL``, ``STL``), global (``LDG``),
  constant (``LDC``, ``ULDC``) and shared (``LDS``) loads and stores and the
  branches (``BRA``, ``BRX``);
* for each composed scene of ``chip_smoke.py`` (the reference render scene
  written as a spec, the three examples, the ground and the lattice, the
  40-sphere union and the ten nested transforms) and the fixed structure
  ``Box<true, false>``, at 1920x1080 from (5, 2, -5), each alone
  (``chip_smoke.graph_ms``, a CUDA graph of 20 launches from a prepared
  struct): K1, K2 (the march without the epilogue) and K3 on K2's planes
  (the epilogue's stencil and shading on full warps); K1 less K2, the
  epilogue's share of K1; the structure each kernel launches; the march's
  evaluations and hits; the longest ray's march step alone (K2 over a list
  of that one ray, a CUDA graph at a step budget of 1 and at the limit,
  the difference over the steps between) in microseconds and cycles at the
  card's maximum SM clock, and that over the program's instructions;
* without ``--no-mesh``, K6 and K7 alone at level 3 of each composed scene
  (``chip_smoke.k6_alone_ms``, ``k7_alone_ms``).

With ``--sass-dir DIR`` the SASS of each kernel counted is written there,
one file a kernel.

It calls entry points that every checkout since the large tier was added has,
so one run per checkout in one call (parent, change, change, parent)
compares two trees on one card.
"""

import inspect
import json
import re
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

FRAME = (1920, 1080)
SASS_KERNELS = ("render_kernel<Composed, true, false, 0>",
                "render_kernel<Composed, false, false, 0>",
                "render_kernel<ComposedLarge, true, false, 0>")
RESOURCE_PREFIXES = ("render_kernel<Composed", "trace_kernel<Composed", "shade_kernel<Composed",
                     "mc_kernel<Composed", "project_kernel<Composed")
SOURCES = ("render_kernel.cu", "render_split.cu", "mc_kernel.cu", "project_kernel.cu")
COUNTED = ("LDL", "STL", "LDG", "LDC", "ULDC", "LDS", "BRA", "BRX", "MUFU")


def counts(body: list[str]) -> dict:
    """Static instructions of ``body`` and those of each COUNTED opcode."""
    ops = Counter(x.split()[1 if x.startswith("@") else 0].split(".")[0] for x in body)
    return {"instructions": len(body), **{op.lower(): ops[op] for op in COUNTED}}


def sass_counts(code: list) -> dict:
    """The kernel's COUNTED opcodes and each loop's (a backward branch and
    its target), innermost first."""
    loops = []
    for addr, text in code:
        targets = re.findall(r"0x[0-9a-f]+", text) if re.search(r"\bBRA\b", text) else []
        if targets and int(targets[-1], 16) <= addr:
            start = int(targets[-1], 16)
            loops.append({"from": hex(start), "to": hex(addr),
                          **counts([x for a, x in code if start <= a <= addr])})
    loops.sort(key=lambda lp: lp["instructions"])
    return {"kernel": counts([x for _, x in code]), "loops": loops}


def lone_step(cs, rk, desc, desc_c, o, d, c, cfg, cull, device) -> dict:
    """The frame's longest ray marched alone by K2: microseconds a step."""
    import torch

    from bsdmg_tpu_torch.ops.trace import DEPTH_LIMIT

    _, steps, _ = rk.trace_cuda(desc, o, d, c, use_bb_skip=cull)
    i = int(torch.argmax(steps).item())
    n = int(steps.reshape(-1)[i].item())
    carried = (torch.zeros_like(c), torch.zeros_like(steps),
               torch.full_like(steps, DEPTH_LIMIT), torch.ones_like(steps))
    planes = tuple(torch.empty_like(p) for p in (c, steps, steps))
    listed = (torch.tensor([i], dtype=torch.int32, device=device),
              torch.ones(1, dtype=torch.int32, device=device))
    lone = {cap: cs.graph_ms(lambda cap=cap: rk._trace_cuda(desc_c, o, d, c, carried, planes,
                                                           cap=cap, rays=listed, cull=cull))
            for cap in (1, cfg.step_limit)}
    return {"steps": n, "us": (lone[cfg.step_limit] - lone[1]) * 1e3 / max(n - 1, 1)}


def main(argv: list[str]) -> int:
    sass_dir = None
    if "--sass-dir" in argv:
        k = argv.index("--sass-dir")
        sass_dir, argv = Path(argv[k + 1]), argv[:k] + argv[k + 2:]
    args = [a for a in argv if not a.startswith("--")]
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    root = Path(args[0]).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("composed_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from bsdmg_tpu_torch import cli
    from bsdmg_tpu_torch.config import MarchConfig, MeshGenConfig
    from bsdmg_tpu_torch.mesh.field import create_voxel_field, refine_field
    from bsdmg_tpu_torch.models import compose_scene, reference_render_scene
    from bsdmg_tpu_torch.ops.cuda import build
    from bsdmg_tpu_torch.ops.cuda import render_kernel as rk
    from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene
    from bsdmg_tpu_torch.ops.marching_cubes import kernel_inputs

    library = build.build()
    # K1's, K2's and K3's tier: the forward walk's, where the checkout has one
    forward = ({"taped": False} if "taped" in inspect.signature(rk.scene_desc_c).parameters
               else {})
    device = torch.device("cuda", 0)
    cfg, mesh_cfg = MarchConfig(), MeshGenConfig()
    clock = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                  "--format=csv,noheader,nounits"], capture_output=True,
                                 text=True, check=True, timeout=60).stdout.split()[0])
    out = {"checkout": str(root), "card": cs.card_line(), "max_sm_mhz": clock}
    out["ptxas"] = {r["kernel"]: [r["registers"], r["stack"], r["spill_stores"], r["spill_loads"]]
                    for source in SOURCES
                    for r in cs.kernel_resources(source, RESOURCE_PREFIXES)}
    functions = cs.sass_functions(library)
    out["sass"] = {name: sass_counts(functions[name]) for name in SASS_KERNELS}
    if sass_dir is not None:
        sass_dir.mkdir(parents=True, exist_ok=True)
        for k, name in enumerate(SASS_KERNELS):
            (sass_dir / f"k1_{k}.sass").write_text(
                name + "\n" + "\n".join(f"/*{a:04x}*/ {x}" for a, x in functions[name]))
    print(f"composed probe sass: {json.dumps(out['sass'])}", flush=True)
    o, d, c = cs.rays(*FRAME, device)
    rgb = torch.empty((*c.shape, 3), device=device)
    planes = (torch.empty_like(c), *(torch.empty_like(c, dtype=torch.int32) for _ in range(3)))
    with tempfile.TemporaryDirectory() as tmp:
        scenes = {"reference_as_spec": compose_scene(cs.REFERENCE_SPEC, device=device)}
        for name, arg in cs.scene_arguments(Path(tmp)).items():
            if arg.endswith(".json"):
                scenes[name] = cli._get_scene(arg, device)
        scenes["Box<true, false>"] = reference_render_scene(device=device)
        for name, scene in scenes.items():
            desc = compile_scene(scene)
            cull = desc.bounds is not None
            desc_c = rk.scene_desc_c(desc, cfg, device, **forward)
            entry = {"structure": int(desc_c.structure),
                     "instructions": None if desc.program is None else len(desc.program)}
            entry["K1 ms"] = cs.graph_ms(lambda: rk._render_cuda(desc_c, o, d, c, rgb, None,
                                                                cap=cfg.step_limit, cull=cull))
            entry["K2 ms"] = cs.graph_ms(lambda: rk._trace_cuda(desc_c, o, d, c, None, planes[:3],
                                                               cap=cfg.step_limit, cull=cull))
            traced = rk.trace_cuda(desc, o, d, c, use_bb_skip=cull)
            entry["K3 ms"] = cs.graph_ms(lambda: rk._shade_cuda(desc_c, o, d, traced[0],
                                                               traced[2], rgb))
            entry["epilogue share"] = (entry["K1 ms"] - entry["K2 ms"]) / entry["K1 ms"]
            _, depth, steps, outcome = rk.render_image_cuda(desc, o, d, c, return_planes=True)
            entry["evaluations"], _, entry["hits"] = cs.march_work(steps, outcome, depth)
            step = lone_step(cs, rk, desc, desc_c, o, d, c, cfg, cull, device)
            entry["lone step"] = {**step, "cycles": step["us"] * clock}
            if desc.program is not None:
                entry["lone step"]["cycles per instruction"] = (step["us"] * clock
                                                                / len(desc.program))
            if "--no-mesh" not in argv and desc.program is not None:
                field = create_voxel_field(mesh_cfg, device)
                for _ in range(3):
                    field = refine_field(desc, field)
                a6, k6 = kernel_inputs(desc, field.lowers, field.voxel_size, mesh_cfg)
                a7, _, k7 = cs.k7_inputs(desc, field, mesh_cfg)
                entry["K6 ms"] = cs.k6_alone_ms(desc, a6, k6)
                entry["K7 ms"] = cs.k7_alone_ms(desc, a7, k7)
            out[name] = entry
            print(f"composed probe {name}: {json.dumps(entry)}", flush=True)
    print("COMPOSED " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
