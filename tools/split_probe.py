#!/usr/bin/env python3
"""Measure the near/far split's K1 and K2 (render_split_kernel,
trace_split_kernel) of one checkout on one CUDA card.

    python3 tools/split_probe.py CHECKOUT

Builds CHECKOUT's kernels and prints one JSON line (``SPLIT {...}``) of the
reference render scene from (5, 2, -5), with ``compile_scene_split``'s
split:

* ptxas's registers, stack and spills of every split instantiation, and the
  SASS loops (static instructions, MUFU) of K1 · split FRESH, K2 · split
  fresh and the unsplit K1 FRESH at ``Box<true, false>``: each march step's
  instructions (``Far``'s loop has one MUFU.RSQ a step, the full scene's
  three), the rolled stencils' loops after them;
* at 1920x1080 and 2560x1440, each alone (``chip_smoke.graph_ms``, a CUDA
  graph of 20 launches from a prepared struct): K1 and K2 with and without
  the split; at 1920x1080 also K1 · split's phase A at 48 steps and its
  resume over the 16x8 blocks left (a copy, timed alone and taken off,
  restores the state before each launch), K2 · split's listed launch over
  the row tail after phase A at 16, 32 and 48 steps in row-major order
  (``compact_list``) and in 8x4-patch order (``tail_list``, the pipeline's
  list with the split) alone (:func:`listed_tail_ms`, the same restoring
  copy), and the row two-phase frame through ``render_image_cuda`` (CUDA
  events, 20 frames a reading);
* :func:`frame_stats` of K1 · split's planes and :func:`tail_stats` of each
  tail in both orders: what sets the kernels' warp work;
* whether K1 · split's image equals the row pipeline's (K2, K2, K3, which
  shades every hit with the full scene), pixel for pixel.

It calls entry points that every checkout since the patch-ordered tail
(``render_kernel.tail_list``) has, so one run per checkout in one call
(parent, change, change, parent) compares two such trees on one card.
``chip_smoke.split_phases`` prints :func:`frame_stats`, and
:func:`tail_stats` and :func:`listed_tail_ms` of its pipeline's tail, of
its own tree too.
"""

import json
import sys
from pathlib import Path

FRAMES = ((1920, 1080), (2560, 1440))
PHASE_A_STEPS = (16, 32, 48)
BENCH_PHASE_A = 48  # bench.benchmark_render's phase_a_steps


def listed_tail_ms(graph_ms, rk, split_c, rays, phase_a, listed, step_limit):
    """K2 · split's listed launch over the row tail ``listed`` alone, from
    phase A's planes ``phase_a`` (depth, steps, outcome, active): its time
    by ``graph_ms`` (chip_smoke's CUDA graph of 20 launches), each launch
    after a copy that restores phase A's state, less that copy timed alone,
    and the (depth, steps, outcome) planes it leaves."""
    import torch

    work = [torch.empty_like(x) for x in phase_a]

    def restore():
        for dst, src in zip(work, phase_a):
            dst.copy_(src)

    def tail():
        restore()
        rk._trace_cuda(split_c, *rays, work, work[:3], rays=listed, cap=step_limit)

    ms = graph_ms(tail) - graph_ms(restore)
    tail()
    torch.cuda.synchronize()
    return ms, [x.clone() for x in work[:3]]


def group_max_sum(values, groups) -> int:
    """The sum over ``groups`` (flat int64, >= 0) of each group's largest
    value: the warp-steps of a launch whose warps run until their slowest
    ray ends."""
    import torch

    top = torch.zeros(int(groups.max()) + 1, dtype=torch.long, device=values.device)
    return int(top.scatter_reduce(0, groups, values.long(), "amax").sum())


def frame_stats(rk, desc, split, o, d, c, planes, cfg) -> dict:
    """What sets K1 · split's and K2 · split's warp work on a fresh frame's
    ``(depth, steps, outcome)`` planes: the rays the slab cull keeps, the
    8x4 patches (warps) and their rays that march the far scene (the
    kernels' vote), the ray-steps and warp-steps (32 x each patch's
    largest step count) of the far and the near patches, the hits in each,
    the warps that hold a hit, the hits a warp with a hit holds, and the
    warps that shade when each 16x8 block lists its far and its near hits
    apart (ceil(hits / 32) each)."""
    import torch

    h, w = c.shape
    flat = rk._flat_rays(o, d, c)
    miss, _ = rk._slab_cull(desc.bounds, *flat, cfg)
    groups = rk.patch_groups(h, w, c.device)
    far = rk.far_rays(split, *flat, cfg, ~miss, groups)
    steps, hit = planes[1].reshape(-1).long(), planes[2].reshape(-1) == 0
    patches = int(groups.max()) + 1
    far_patch = torch.zeros(patches, dtype=torch.bool, device=c.device)
    far_patch[groups[far]] = True
    out = {"rays": h * w, "kept_rays": int((~miss).sum()), "patches": patches,
           "far_patches": int(far_patch.sum()), "far_rays": int(far.sum())}
    for name, rays in (("far", far), ("near", ~far)):
        g = groups[rays]
        out[f"{name}_ray_steps"] = int(steps[rays].sum())
        out[f"{name}_warp_steps"] = 32 * group_max_sum(steps[rays], g) if g.numel() else 0
        out[f"{name}_hits"] = int(hit[rays].sum())
        out[f"{name}_warps_with_a_hit"] = int(torch.unique(groups[rays & hit]).numel())
    warps_hit = out["far_warps_with_a_hit"] + out["near_warps_with_a_hit"]
    out["hits_per_warp_with_a_hit"] = (out["far_hits"] + out["near_hits"]) / max(warps_hit, 1)
    out["far_hit_share"] = out["far_hits"] / max(out["far_hits"] + out["near_hits"], 1)
    py, px = torch.arange(h, device=c.device)[:, None], torch.arange(w, device=c.device)[None, :]
    block = ((py // 8) * -(-w // 16) + px // 16).reshape(-1)
    listed = 0
    for rays in (far & hit, ~far & hit):
        per_block = torch.bincount(block[rays], minlength=int(block.max()) + 1)
        listed += int(((per_block + 31) // 32).sum())
    out["block_listed_shading_warps"] = listed
    return out


def tail_stats(rk, split, o, d, c, phase_a, final, index, cfg) -> dict:
    """K2 · split's listed launch over a row tail: the rays of ``index``
    (flat int64, in list order) that phase A's planes ``phase_a`` left
    active, taken 32 a warp. Its warps, ray-steps and warp-steps (the steps
    the launch takes, ``final`` less phase A's), the warps that march the
    far scene (no ray of theirs can reach the near box), and the rays
    that cannot reach it but march the full scene with a warp that holds
    one that can (mixed warps and their far-missing rays)."""
    import torch

    n = index.numel()
    flat = [p.reshape(-1)[index] for p in rk._flat_rays(o, d, c)]
    miss, _ = rk._slab_cull(split[1], *flat, cfg)
    warp = torch.arange(n, device=c.device) // 32
    near = torch.zeros(int(warp.max()) + 1 if n else 1, dtype=torch.int32, device=c.device)
    near.index_add_(0, warp, (~miss).to(torch.int32))
    full = near[warp] > 0
    taken = (final[1].reshape(-1)[index] - phase_a[1].reshape(-1)[index]).long()
    return {"rays": n, "warps": -(-n // 32), "ray_steps": int(taken.sum()),
            "warp_steps": 32 * group_max_sum(taken, warp) if n else 0,
            "far_warps": int((near == 0).sum()) if n else 0,
            "mixed_warps": int(torch.unique(warp[full & miss]).numel()),
            "far_missing_rays_in_full_warps": int((full & miss).sum())}


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    root = Path(argv[0]).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("split_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from bsdmg_tpu_torch.config import MarchConfig
    from bsdmg_tpu_torch.models import reference_render_scene
    from bsdmg_tpu_torch.ops.cuda import build
    from bsdmg_tpu_torch.ops.cuda import render_kernel as rk
    from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene, compile_scene_split

    library = build.build()
    device = torch.device("cuda", 0)
    cfg = MarchConfig()
    scene = reference_render_scene(device=device)
    desc, split = compile_scene(scene), compile_scene_split(scene)
    split_c = rk.scene_desc_c(desc, cfg, device, split)
    unsplit_c = rk.scene_desc_c(desc, cfg, device)
    out = {"checkout": str(root), "card": cs.card_line()}
    out["ptxas"] = {r["kernel"]: [r["registers"], r["stack"], r["spill_stores"], r["spill_loads"]]
                    for r in cs.kernel_resources("render_split.cu", ("render_split_kernel<",
                                                                     "trace_split_kernel<"))}
    functions = cs.sass_functions(library)
    out["sass_loops"] = {
        name: [{k: loop[k] for k in ("instructions", "mufu", "ldg")}
               for loop in cs.loops_of(functions[name])]
        for name in ("render_split_kernel<Box<true, false>, true, false, 0>",
                     "trace_split_kernel<Box<true, false>, true, false, false>",
                     "render_kernel<Box<true, false>, true, false, 0>")}
    for w, h in FRAMES:
        key = f"{w}x{h}"
        o, d, c = cs.rays(w, h, device)
        rgb = torch.empty((h, w, 3), device=device)
        planes = (torch.empty_like(c), *(torch.empty_like(c, dtype=torch.int32) for _ in range(3)))
        times = {}
        for label, desc_c in (("split", split_c), ("unsplit", unsplit_c)):
            times[f"K1 {label}"] = cs.graph_ms(lambda: rk._render_cuda(
                desc_c, o, d, c, rgb, None, cap=cfg.step_limit))
            times[f"K2 {label}"] = cs.graph_ms(lambda: rk._trace_cuda(
                desc_c, o, d, c, None, planes[:3], cap=cfg.step_limit))
        fused = rk.render_image_cuda(desc, o, d, c, return_planes=True, split=split)
        row = rk.render_image_cuda(desc, o, d, c, return_planes=True, split=split, two_phase=True,
                                   phase_a_steps=BENCH_PHASE_A)
        differ = (fused[0] != row[0]).any(dim=-1)
        entry = {"alone_ms": times, "frame": frame_stats(rk, desc, split, o, d, c, fused[1:], cfg),
                 "fused_vs_row": {"pixels_differing": int(differ.sum()),
                                  "max_abs": float((fused[0] - row[0]).abs().max()),
                                  "planes_equal": all(torch.equal(a, b)
                                                      for a, b in zip(fused[1:], row[1:]))}}
        if w == 1920:
            frame = rk._Frame(desc, o, d, c, cfg, True, 1.0, split)
            # K1 · split's phase A at 48 steps and its resume over the blocks
            times["K1 split phase A 48"] = cs.graph_ms(lambda: rk._render_cuda(
                split_c, o, d, c, rgb, planes[:3], mode=rk.PHASE_A, active=planes[3], cap=48))
            blocks = rk.compact_list(rk.block_flags(planes[3]))
            state = [x.clone() for x in (rgb, *planes)]
            work = [torch.empty_like(x) for x in state]

            def restore(state=state, work=work):
                for dst, src in zip(work, state):
                    dst.copy_(src)

            def resume():
                restore()
                rk._render_cuda(split_c, o, d, c, work[0], work[1:4], mode=rk.RESUME,
                                active=work[4], blocks=blocks, cap=cfg.step_limit)

            times["K1 split resume 48"] = cs.graph_ms(resume) - cs.graph_ms(restore)
            times["K1 split resume 48 blocks"] = int(blocks[1].item())
            tails = {}
            for n in PHASE_A_STEPS:
                phase_a = frame.trace(n)
                for name, listed in (("row", rk.compact_list(phase_a[3].reshape(-1))),
                                     ("patch", rk.tail_list(phase_a[3], split))):
                    ms, final = listed_tail_ms(cs.graph_ms, rk, split_c, (o, d, c), phase_a,
                                               listed, cfg.step_limit)
                    index = listed[0][:int(listed[1].item())].long()
                    tails[f"{name} after {n}"] = {
                        "ms": ms, **tail_stats(rk, split, o, d, c, phase_a, final, index, cfg)}
            entry["tails"] = tails
            times["row frame 48"] = cs.median_ms(lambda: rk.render_image_cuda(
                desc, o, d, c, two_phase=True, phase_a_steps=BENCH_PHASE_A, split=split), reps=20)
        out[key] = entry
        print(f"split probe {key}: {json.dumps(entry)}", flush=True)
    print("SPLIT " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
