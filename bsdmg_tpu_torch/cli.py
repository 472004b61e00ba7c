"""Command-line interface of the PyTorch port: the ``render``, ``mesh``, ``remesh``,
``session``, ``fit``, ``animate`` and ``bench`` verbs.

    python -m bsdmg_tpu_torch.cli render -o out.png
    python -m bsdmg_tpu_torch.cli render --scene examples/snowman.json -o out.png
    python -m bsdmg_tpu_torch.cli render --scene mandelbulb --camera 2 1 -2 -o out.png
    python -m bsdmg_tpu_torch.cli render --scene mesh:asset.obj[:RES] -o out.png
    python -m bsdmg_tpu_torch.cli render --sharded -o out.png
    torchrun --nproc-per-node=2 -m bsdmg_tpu_torch.cli render --sharded -o out.png
    python -m bsdmg_tpu_torch.cli mesh -o out.obj
    python -m bsdmg_tpu_torch.cli mesh --interpolate-edges -o out.obj
    python -m bsdmg_tpu_torch.cli mesh --sharded -o out.obj
    python -m bsdmg_tpu_torch.cli mesh --scene mesh:asset.obj[:RES] -o out.obj
    python -m bsdmg_tpu_torch.cli remesh -i asset.obj [--grid-resolution 128] -o out.obj
    python -m bsdmg_tpu_torch.cli session --keys vbbbvv -o out.obj
    python -m bsdmg_tpu_torch.cli fit
    python -m bsdmg_tpu_torch.cli fit --image
    python -m bsdmg_tpu_torch.cli animate --frames 8 [--rotate --motion spheric] -o frame
    python -m bsdmg_tpu_torch.cli bench --which render [--two-phase row|block] [--roofline]
    python -m bsdmg_tpu_torch.cli bench --which scaling|scaling-proxy

``render`` draws a built-in scene (``--scene``: the reference render scene
by default, ``sphere``, ``box``, ``mandelbulb``, ``wrapped_object``) or a
composed scene (``path.json`` or ``spec:path``, a JSON CSG spec,
``models/compose.py``, which the kernels run as a node program) at
1920x1080 through CUDA kernel K1, or a triangle-mesh asset (``mesh:``)
baked into a RES^3 grid SDF (default 128) by the bake kernel through
kernels K9 (the contraction ladder), K8 (the fine finish) and P1 (the hit
normals); ``mesh`` refines a scene (the reference object by default; a
mesh asset as its baked grid) three levels from a 32^3 grid and extracts
its surface through kernel K6 (edge midpoints) or K7
(``--interpolate-edges``); ``remesh`` bakes an OBJ and re-extracts its
surface through K6; ``session`` replays the reference's refine/advance
stage machine from a key script, each extraction through K6; ``fit``
perturbs scene parameters and recovers them by inverse rendering, from a
depth map (plain PyTorch and autograd) or, with ``--image``, from an image
through kernels K4 (the target's march) and K5 (each step's loss and
gradient), for every scene but the box (a mesh asset's grid, which reads no
parameter, in K4's and K5's grid form: its loss and gradient stay 0, as in
the JAX package); ``animate``
renders a camera orbit, or the object's motion, one K1 launch a frame (a
mesh asset's orbit through K9, K8 and P1);
``bench`` prints the JAX CLI's
operating-point numbers as JSON (the render of ``--scene`` through K1, or with
``--two-phase row`` through K2 and K3, with ``block`` through K1 twice;
refine; marching cubes through K6; the loss and gradient through K5; the
sharded frame's scaling and overhead). All keep the JAX CLI's flags and
defaults (``bsdmg_tpu/cli.py``). ``render --sharded`` and ``mesh
--sharded`` run the multi-device paths (``parallel/``) over every rank of
the world: one process a device, joined by ``torchrun`` or the
``BSDMG_*`` variables (``parallel/multihost.py``), or a world of one
without them; rank 0 logs the totals and writes the file. ``--device``
picks the torch device (default ``cuda``, under a launcher
``cuda:LOCAL_RANK``); ``--device cpu`` runs the kernels' plain PyTorch
twins, for tests. With no CUDA device and no ``--device cpu`` a command
fails: it never moves to the CPU on its own.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import math
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from bsdmg_tpu_torch import bench
from bsdmg_tpu_torch.cam import generate_rays, look_at
from bsdmg_tpu_torch.config import MeshGenConfig
from bsdmg_tpu_torch.grad import differentiable_hit, render_image_diff, render_loss_and_grad
from bsdmg_tpu_torch.mesh.export import (
    load_field,
    load_obj,
    save_field,
    save_gif,
    save_obj,
    save_png,
    save_vtk,
)
from bsdmg_tpu_torch.mesh.pipeline import generate_mesh, remesh
from bsdmg_tpu_torch.mesh.session import MeshGenSession
from bsdmg_tpu_torch.models import (
    get_scene,
    load_scene_spec,
    reference_object,
    reference_render_scene,
)
from bsdmg_tpu_torch.models.mesh_sdf import bake_mesh_grid, mesh_scene
from bsdmg_tpu_torch.models.motion import (
    AxisCyclicMotion,
    RotateAxisMotion,
    SphericCyclicMotion,
    motion_params,
)
from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene, compile_scene_split, scene_bounds
from bsdmg_tpu_torch.ops.cuda.grid_kernel import make_contraction_levels, render_image_grid
from bsdmg_tpu_torch.ops.cuda.render_kernel import render_image_cuda
from bsdmg_tpu_torch.ops.shade import to_rgba8
from bsdmg_tpu_torch.ops.trace import COLLISION
from bsdmg_tpu_torch.parallel import (
    generate_mesh_sharded,
    make_mesh,
    render_grid_sharded,
    render_sharded_pallas,
)
from bsdmg_tpu_torch.parallel.multihost import local_device
from bsdmg_tpu_torch.utils import profiling

log = logging.getLogger("bsdmg_tpu_torch")


def _device(name: str) -> torch.device:
    device = local_device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is False; "
            "pass --device cpu to run the plain PyTorch path"
        )
    return device


def _parse_mesh_spec(rest: str, default_resolution: int = 128):
    """Split ``path.obj[:RES]`` into (path, resolution). The suffix is only
    treated as a resolution when it parses as an integer: OBJ paths may
    contain colons."""
    resolution = default_resolution
    if ":" in rest:
        head, _, res_s = rest.rpartition(":")
        try:
            resolution = int(res_s)
            rest = head
        except ValueError:
            pass
    return rest, resolution


def _get_scene(name: str, device: torch.device):
    """A built-in scene by name, a composed scene from a JSON spec
    (``path.json`` or ``spec:path``), or a mesh asset (``mesh:path.obj[:RES]``)
    baked on ``device``."""
    if name.startswith("mesh:"):
        return _mesh_asset_scene(name, device)
    if name.startswith("spec:") or name.endswith(".json"):
        return load_scene_spec(name[len("spec:"):] if name.startswith("spec:") else name,
                               device=device)
    return get_scene(name, device=device)


def _mesh_asset_scene(spec: str, device: torch.device):
    """``mesh:path.obj[:RES]``: load a triangle-mesh asset and bake it into a
    grid SDF scene on ``device``."""
    path, resolution = _parse_mesh_spec(spec[len("mesh:"):])
    t0 = time.perf_counter()
    src = load_obj(path)
    t1 = time.perf_counter()
    scene, _ = mesh_scene(src.vertices, src.faces, resolution=resolution, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log.info(
        "loaded %s (%d vertices, %d triangles) in %.3fs; baked %d^3 grid in %.3fs",
        path, src.vertex_count, src.triangle_count, t1 - t0, resolution,
        time.perf_counter() - t1,
    )
    return scene


def _rank_zero() -> bool:
    """This process writes the files: the only one, or rank 0 of the world."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _sharded_renderer(scene, mesh):
    """:func:`_renderer` over the world's ``mesh`` (``parallel/sharding.py``):
    a mesh asset through ``render_grid_sharded``, else
    ``render_sharded_pallas`` (K1 on each rank's bands) with the scene's
    near/far split, as the JAX CLI passes it."""
    if scene.grid is None:
        desc, split = compile_scene(scene), compile_scene_split(scene)
        return lambda origins, dirs, cone: render_sharded_pallas(desc, origins, dirs, cone, mesh,
                                                                 split=split)
    levels = make_contraction_levels(scene.grid)
    return lambda origins, dirs, cone: render_grid_sharded(scene.grid, origins, dirs, cone, mesh,
                                                           levels=levels)


def _renderer(scene):
    """The scene's render, ``(origins, dirs, cone) -> rgb``: the grid route
    for a mesh asset (its contraction ladder built once, here), else kernel
    K1 on the compiled descriptor with the scene's near/far split
    (``compile_scene_split``), as the JAX CLI passes it."""
    if scene.grid is None:
        desc, split = compile_scene(scene), compile_scene_split(scene)
        return lambda origins, dirs, cone: render_image_cuda(desc, origins, dirs, cone,
                                                             split=split)
    t0 = time.perf_counter()
    levels = make_contraction_levels(scene.grid)
    log.info(
        "contraction levels %s in %.3fs",
        [f"{lv.r}^3 {lv.table.dtype}" for lv in levels], time.perf_counter() - t0,
    )
    return lambda origins, dirs, cone: render_image_grid(
        scene.grid, origins, dirs, cone, mode="contraction", levels=levels
    )


def cmd_render(args) -> None:
    device = _device(args.device)
    scene = _get_scene(args.scene, device)
    cam = look_at(tuple(args.camera), tuple(args.target), fov=args.fov, device=device)
    origins, dirs, cone = generate_rays(
        cam, (args.width, args.height), (args.screen_width, args.screen_height)
    )
    if args.sharded:
        mesh = make_mesh(device=device)
        render = _sharded_renderer(scene, mesh)
        log.info("sharded render over %d rank(s)", mesh.size())
    else:
        render = _renderer(scene)
    t0 = time.perf_counter()
    img = render(origins, dirs, cone)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log.info(
        "rendered %dx%d on %s in %.3fs", args.width, args.height, device,
        time.perf_counter() - t0,
    )
    if not _rank_zero():
        return
    out = args.output or "render.png"
    if out.endswith(".npy"):
        np.save(out, img.cpu().numpy())
    else:
        save_png(to_rgba8(img).cpu().numpy(), out)
    log.info("wrote %s", out)


def cmd_mesh(args) -> None:
    device = _device(args.device)
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
    if args.sharded:
        # shard-local refine and extraction over every rank (parallel/mesh.py);
        # as in the JAX CLI, no checkpoint or resume
        # (the levels are not logged: a rank knows only its own voxels)
        dev_mesh = make_mesh(device=device)
        if _rank_zero():
            log.info("sharded pipeline over %d rank(s)", dev_mesh.size())
        mesh = generate_mesh_sharded(desc, dev_mesh, refine_steps=args.refine, config=cfg,
                                     device=device)
        if not _rank_zero():
            return
    else:
        field = None
        if args.resume:
            field = load_field(args.resume, device)
            log.info("resumed from %s: level %d, %d voxels", args.resume, field.level,
                     field.count)
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


def cmd_session(args) -> None:
    """Drive the interactive stage machine with a scripted key sequence: B
    refines and V advances (src/input_handling.rs:37-42); ``--keys vbbbvv``
    (or ``--commands advance,refine,...``) replays the sequence headlessly.
    As the JAX CLI's, the scene is meshed as named: the render scene with
    its wireframe."""
    device = _device(args.device)
    if args.commands:
        steps = [c.strip() for c in args.commands.split(",") if c.strip()]
        bad = [s for s in steps if s not in ("refine", "advance")]
        if bad:
            build_parser().error(
                f"--commands accepts only 'refine'/'advance', got: {', '.join(bad)}"
            )
    else:
        names = {"b": "refine", "v": "advance"}
        steps = [names[k] for k in args.keys.lower() if k in names]
    desc = compile_scene(_get_scene(args.scene, device))
    cfg = MeshGenConfig(init_factor=args.init_factor, bb_size=args.bb_size)
    session = MeshGenSession(desc, cfg, output_path=args.output or "generated_mesh.obj",
                             device=device)
    for step in steps:
        log.info("session step: %s (stage=%s)", step, session.stage.value)
        getattr(session, step)()
    log.info("final stage: %s", session.stage.value)


def _motion_components(args):
    """Motion components from the CLI flags, the reference's optional
    per-entity components (src/example_scene.rs:63-101)."""
    axis_cyclic = spheric_cyclic = rotate_axis = None
    if args.motion == "axis":
        axis_cyclic = AxisCyclicMotion(cycle_duration=args.cycle_duration)
    elif args.motion == "spheric":
        spheric_cyclic = SphericCyclicMotion(cycle_durations=(args.cycle_duration,) * 3)
    if args.rotate:
        rotate_axis = RotateAxisMotion(cycle_duration=args.cycle_duration)
    return axis_cyclic, spheric_cyclic, rotate_axis


def _motion_keys(scene):
    """The params that take the object's rigid transform: the object's
    ``object_center``/``object_rotation``, or a composed scene's root
    ``transform`` node's ``n0_offset``/``n0_rotation``; None (with the JAX
    CLI's warning) for a scene that has none, whose motion is ignored."""
    if scene.csdf is None:
        log.warning("scene %s has no param-traced form; motion ignored", scene.name)
        return None
    if "object_center" in scene.params:
        return "object_center", "object_rotation"
    if scene.spec is not None and scene.spec["root"].get("op") == "transform":
        return "n0_offset", "n0_rotation"
    hint = (
        " (wrap the spec root in {'op': 'transform', 'child': ...} "
        "to animate it)" if scene.spec is not None else ""
    )
    log.warning(
        "scene %s does not consume object_center/object_rotation; "
        "motion ignored%s", scene.name, hint,
    )
    return None


def cmd_animate(args) -> None:
    """A camera orbit, or the object's motion seen from a still camera,
    one PNG a frame (and ``--gif``). Every frame is one launch of K1: the
    orbit's on the scene's descriptor, the motion's on a descriptor
    compiled at the frame's moved params (the object transform, or a
    composed scene's root transform node, is data in the descriptor). A
    mesh asset orbits through the grid route (its ladder built once); its
    table takes no motion, which is ignored with the JAX CLI's warning."""
    device = _device(args.device)
    scene = _get_scene(args.scene, device)
    axis_cyclic, spheric_cyclic, rotate_axis = _motion_components(args)
    moving = any(m is not None for m in (axis_cyclic, spheric_cyclic, rotate_axis))
    keys = _motion_keys(scene) if moving else None
    moving = keys is not None
    render = None if moving else _renderer(scene)

    radius = float(np.linalg.norm(args.camera))
    gif_frames = [] if args.gif else None
    for i in range(args.frames):
        t = args.seconds * i / max(args.frames, 1)
        if moving:
            # the camera holds still so the object's motion is what animates
            pos = tuple(args.camera)
        else:
            theta = 2 * math.pi * i / args.frames
            pos = (radius * math.cos(theta), args.camera[1], radius * math.sin(theta))
        cam = look_at(pos, tuple(args.target), fov=args.fov, device=device)
        origins, dirs, cone = generate_rays(
            cam, (args.width, args.height), (args.screen_width, args.screen_height)
        )
        if moving:
            view = {"object_center": scene.params[keys[0]],
                    "object_rotation": scene.params[keys[1]]}
            moved = motion_params(view, t, axis_cyclic=axis_cyclic, spheric_cyclic=spheric_cyclic,
                                  rotate_axis=rotate_axis, enable_movement=args.enable_movement,
                                  device=device)
            params = dict(scene.params)
            params[keys[0]], params[keys[1]] = moved["object_center"], moved["object_rotation"]
            img = render_image_cuda(compile_scene(scene, params), origins, dirs, cone)
        else:
            img = render(origins, dirs, cone)
        rgba8 = to_rgba8(img).cpu().numpy()
        path = f"{args.output or 'frame'}_{i:04d}.png"
        save_png(rgba8, path)
        if gif_frames is not None:
            gif_frames.append(rgba8)
        log.info("frame %d/%d (t=%.2fs) -> %s", i + 1, args.frames, t, path)
    if gif_frames is not None:
        fps = args.frames / args.seconds if args.seconds > 0 else 10.0
        save_gif(gif_frames, args.gif, fps=fps)
        log.info("wrote %s (%d frames, %.1f fps)", args.gif, args.frames, fps)


def cmd_remesh(args) -> None:
    """Load a mesh asset, bake a grid SDF, re-extract its surface at the
    target resolution (``bsdmg_tpu/cli.py`` cmd_remesh; ``mesh.pipeline.
    remesh``: K6 on the card)."""
    device = _device(args.device)
    src = load_obj(args.input)
    log.info("loaded %s: %d verts, %d tris", args.input, src.vertex_count, src.triangle_count)
    t0 = time.perf_counter()
    grid = bake_mesh_grid(src.vertices, src.faces, resolution=args.grid_resolution,
                          device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log.info("baked %d^3 SDF grid in %.2fs", args.grid_resolution, time.perf_counter() - t0)
    mesh = remesh(grid, init_factor=args.init_factor, refine=args.refine,
                  newton_iters=args.newton_iters, device=device)
    log.info("remeshed: %d verts, %d tris", mesh.vertex_count, mesh.triangle_count)
    out = args.output or "remeshed.obj"
    (save_vtk if out.endswith(".vtk") else save_obj)(mesh, out)
    log.info("wrote %s", out)


def _parse_perturb(spec: str) -> dict[str, tuple[str, float]]:
    """Parse ``key=factor,key=+delta`` into ``{key: (mode, value)}``.

    A plain number (or ``*number``) multiplies the true param; ``+number``
    adds to it, the way to perturb zero-valued params."""
    out: dict[str, tuple[str, float]] = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        key, _, val = item.partition("=")
        val = val.strip()
        mode = "mul"
        if val.startswith("+"):
            mode, val = "add", val[1:]
        elif val.startswith("*"):
            val = val[1:]
        try:
            out[key.strip()] = (mode, float(val))
        except ValueError:
            raise SystemExit(
                f"--perturb: expected key=factor or key=+delta, got {item!r}"
            ) from None
    if not out:
        raise SystemExit("--perturb: no key=factor pairs found")
    return out


def _apply_perturb(params: dict, perturb: dict) -> dict:
    """Perturb ``params`` per ``_parse_perturb``'s spec; refuses no-ops."""
    out = dict(params)
    for key, (mode, value) in perturb.items():
        out[key] = out[key] + value if mode == "add" else out[key] * value
        if np.allclose(out[key].cpu().numpy(), params[key].cpu().numpy()):
            raise SystemExit(
                f"--perturb: {key} is unchanged by the perturbation "
                f"({mode} {value}); for zero-valued params use key=+delta"
            )
    return out


def _fmt(params, watched) -> str:
    return " ".join(
        f"{k}={params[k].detach().cpu().numpy().ravel().round(4).tolist()}" for k in watched
    )


def _leaves(params: dict) -> dict:
    return {k: v.detach().clone().requires_grad_() for k, v in params.items()}


def cmd_fit(args) -> None:
    """Inverse rendering: recover SDF parameters from a target depth map
    (default) or from a target image with the fused loss and gradient
    (``--image``): the target is rendered at the scene's true params, the
    ``--perturb`` params are perturbed, and gradient descent recovers them."""
    device = _device(args.device)
    default_scene = args.scene == "reference_render_scene"
    scene = reference_object(device=device) if default_scene else _get_scene(args.scene, device)
    cam = look_at(tuple(args.camera), tuple(args.target), fov=args.fov, device=device)
    origins, dirs, cone = generate_rays(
        cam, (args.width, args.height), (args.screen_width, args.screen_height)
    )

    if args.perturb:
        perturb = _parse_perturb(args.perturb)
    elif default_scene:
        perturb = (
            {"sphere_radius": ("mul", 1.25), "smooth_k": ("mul", 0.7),
             "skeleton_line_width": ("mul", 1.3)}
            if args.image
            else {"sphere_radius": ("mul", 1.3), "smooth_k": ("mul", 0.6)}
        )
    else:
        raise SystemExit(
            f"pass --perturb key=factor[,key=+delta] to pick which of "
            f"{sorted(scene.params)} to perturb and recover"
        )
    unknown = set(perturb) - set(scene.params)
    if unknown:
        raise SystemExit(
            f"--perturb keys {sorted(unknown)} not in scene params {sorted(scene.params)}"
        )

    if args.image:
        if default_scene:
            scene = reference_render_scene(device=device)
            true_params = {
                k: v for k, v in scene.params.items()
                if k not in ("object_center", "object_rotation")
            }
        else:
            true_params = dict(scene.params)
        fit_image(
            scene, true_params, _apply_perturb(true_params, perturb), origins, dirs, cone,
            steps=args.steps, lr=args.lr, watched=sorted(perturb),
        )
        return

    watched = sorted(perturb)
    # synthesize a target from the true params, then perturb and recover
    t_target, hit_t = differentiable_hit(scene.sdf, scene.params, origins, dirs, cone)
    t_target = t_target.detach()
    stable0 = hit_t.outcome == COLLISION
    params = _leaves(_apply_perturb(scene.params, perturb))
    for i in range(args.steps):
        t, hit = differentiable_hit(scene.sdf, params, origins, dirs, cone)
        mask = stable0 & (hit.outcome == COLLISION)
        err = (t - t_target) * mask
        loss = torch.sum(err**2) / torch.clamp_min(torch.sum(mask), 1)
        # a mesh asset's SDF reads no param: its loss has no graph, its
        # gradient is zero, as JAX's is
        grads = (torch.autograd.grad(loss, list(params.values()), allow_unused=True)
                 if loss.requires_grad else [None] * len(params))
        with torch.no_grad():
            for p, g in zip(params.values(), grads):
                if g is not None:
                    p -= args.lr * g
        if i % 10 == 0 or i == args.steps - 1:
            log.info("step %d: loss=%.3e %s", i, loss.item(), _fmt(params, watched))
    log.info("recovered %s (true %s)", _fmt(params, watched), _fmt(scene.params, watched))


def fit_image(scene, true_params: dict, params: dict, origins, dirs, cone, *, steps: int,
              lr: float, watched=None):
    """Image-loss inverse rendering (``fit --image``): render a target at
    ``true_params``, then run ``steps`` Adam steps (learning rate ``lr *
    0.1``, as the JAX CLI's ``optax.adam``) from ``params`` on the L2 image
    loss plus the silhouette term (``edge_weight=1``). The target's march is
    kernel K4 and each step's loss and gradient kernel K5 on the card
    (their plain twins on CPU tensors). A scene without bounds (the wrapped
    object, a spec that reaches a plane or a wrap) is marched without the
    slab cull. The steps take the scene's near/far split, its near box
    inflated by the trust region as the bounds are, as the JAX CLI's do.
    Logs every tenth step and the recovered ``watched`` params; returns
    ``(params, losses)``."""
    if scene.csdf is None:
        raise SystemExit(
            f"fit --image needs a param-traced component SDF; scene {scene.name!r} has none"
        )
    # the bounds over the whole optimisation: a conservative trust region
    bounds = scene_bounds(scene)
    bb = None
    if bounds is not None:
        lo, hi, slack = bounds
        bb = (tuple(v - 0.6 for v in lo), tuple(v + 0.6 for v in hi), slack)
    split = compile_scene_split(scene)
    if split is not None:
        far, (nlo, nhi, nslack) = split
        split = (far, (tuple(v - 0.6 for v in nlo), tuple(v + 0.6 for v in nhi), nslack))
    target = render_image_diff(
        scene.sdf, true_params, origins, dirs, cone, csdf=scene.csdf, bb=bb
    ).detach()
    params = _leaves(params)
    watched = sorted(params) if watched is None else watched
    opt = torch.optim.Adam(list(params.values()), lr=lr * 0.1)
    losses = []
    for i in range(steps):
        opt.zero_grad()
        loss, _ = render_loss_and_grad(
            scene.sdf, params, target, origins, dirs, cone, csdf=scene.csdf, bb=bb,
            edge_weight=1.0, split=split,
        )
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if i % 10 == 0 or i == steps - 1:
            log.info("step %d: loss=%.3e %s", i, losses[-1], _fmt(params, watched))
    log.info("recovered %s (true %s)", _fmt(params, watched), _fmt(true_params, watched))
    return {k: v.detach() for k, v in params.items()}, losses


def _share(roof, seconds: float, device: torch.device):
    """Percent of the card's speed of light; a time taken on the CPU is no
    share of it (None)."""
    return 100.0 * roof.efficiency(seconds) if device.type == "cuda" else None


def cmd_bench(args) -> None:
    """The JAX CLI's operating-point benchmarks (``bsdmg_tpu/cli.py``
    cmd_bench) on the port: one JSON object with the same keys, and the
    device it ran on. The speed of light is the H100's (``utils/
    profiling.py``)."""
    if args.scene != "reference_render_scene" and args.which != "render":
        raise NotImplementedError(
            f"bench --scene {args.scene}: only --which render takes another scene"
        )
    device = _device(args.device)
    ctx = contextlib.nullcontext()
    if args.trace:
        ctx = profiling.trace(args.trace)
    results = {}
    with ctx:
        if args.which in ("all", "render"):
            two_phase = {"row": True, "block": "block"}.get(args.two_phase, False)
            r = bench.benchmark_render(args.width, args.height, two_phase=two_phase,
                                       unroll=args.unroll, device=device, scene=args.scene)
            results["render"] = {
                "rays_per_s": r["rays_per_s"],
                "ms_per_frame": r["seconds_per_frame"] * 1e3,
            }
            if args.roofline:
                stats = bench.render_step_stats(args.width, args.height, device=device,
                                                scene=args.scene)
                desc = compile_scene(_get_scene(args.scene, device))
                loops = {}
                if desc.kind == "mandelbulb":
                    rays = bench._rays(args.width, args.height, device)
                    loops = dict(zip(("march_loop", "stencil_loop"),
                                     profiling.mandelbulb_loops(desc, *rays)))
                roof = profiling.render_roofline(desc, args.width, args.height,
                                                 stats["mean_warp_max_steps"], stats["hits"],
                                                 **loops)
                results["roofline"] = {
                    **stats,
                    "bound_by": roof.bound,
                    "speed_of_light_ms": roof.seconds * 1e3,
                    "pct_of_roofline": _share(roof, r["seconds_per_frame"], device),
                }
        if args.which in ("all", "refine"):
            r = bench.benchmark_refine(device=device)
            results["refine"] = {"voxels_per_s": r["voxels_per_s"]}
            if args.roofline:
                ops = profiling.csdf_flops_per_eval(compile_scene(reference_object(device=device)))
                roof = profiling.refine_roofline(r["input_voxels"], ops_per_eval=ops)
                results["refine_roofline"] = {
                    "ops_per_eval": ops,
                    "evals_per_parent": 27,
                    "bound": roof.bound,
                    "speed_of_light_ms": roof.seconds * 1e3,
                    "pct_of_roofline": _share(roof, r["seconds"], device),
                }
        if args.which in ("all", "mc"):
            r = bench.benchmark_marching_cubes(device=device)
            results["marching_cubes"] = {"voxels_per_s": r["voxels_per_s"]}
            if args.roofline:
                stats = bench.mc_step_stats(device=device)
                ops = profiling.csdf_flops_per_eval(compile_scene(reference_object(device=device)))
                roof = profiling.mc_roofline(
                    stats["padded_lanes"], stats["budget"], stats["mean_block_steps"],
                    corner_evals_per_lane=8.0 * stats["voxels"] / stats["padded_lanes"],
                    ops_per_eval=ops,
                )
                results["mc_roofline"] = {
                    **stats,
                    "ops_per_eval": ops,
                    "bound": roof.bound,
                    "speed_of_light_ms": roof.seconds * 1e3,
                    "pct_of_roofline": _share(roof, r["seconds"], device),
                }
        if args.which in ("all", "grad"):
            r = bench.benchmark_render_grad(device=device)
            results["render_grad"] = {"rays_per_s": r["rays_per_s"]}
            if args.roofline:
                stats = bench.render_step_stats(r["width"], r["height"], device=device)
                roof = profiling.grad_roofline(r["width"], r["height"],
                                               stats["mean_warp_max_steps"], stats["hits"])
                results["grad_roofline"] = {
                    **stats,
                    "bound_by": roof.bound,
                    "speed_of_light_ms": roof.seconds * 1e3,
                    "pct_of_roofline": _share(roof, r["seconds_per_frame"], device),
                }
        if args.which == "scaling":
            results["scaling"] = bench.benchmark_scaling(args.width, args.height, device=device)
        if args.which == "scaling-proxy":
            results["scaling_proxy"] = bench.benchmark_scaling_overhead(device=device)
    if not _rank_zero():
        return
    if args.trace:
        results["trace_dir"] = args.trace
    results["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps(results, indent=2))


def _add_device(parser) -> None:
    parser.add_argument(
        "--device", default="cuda",
        help="torch device; 'cpu' runs the plain PyTorch versions (for tests)",
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bsdmg_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    def common_camera(sp, width: int, height: int) -> None:
        sp.add_argument("--camera", type=float, nargs=3, default=[5.0, 2.0, -5.0])
        sp.add_argument("--target", type=float, nargs=3, default=[0.0, 0.0, 0.0])
        sp.add_argument("--fov", type=float, default=math.pi / 4, help="radians")
        sp.add_argument("--width", type=int, default=width)
        sp.add_argument("--height", type=int, default=height)
        sp.add_argument("--screen-width", type=float, default=1920.0)
        sp.add_argument("--screen-height", type=float, default=1080.0)

    r = sub.add_parser("render", help="sphere-trace a scene to PNG/NPY")
    r.add_argument(
        "--scene", default="reference_render_scene",
        help="scene name (bsdmg_tpu_torch.models.SCENES), a .json CSG spec, or "
        "'mesh:path.obj[:RES]' for an OBJ asset baked into a RES^3 grid SDF (default 128)",
    )
    common_camera(r, 1920, 1080)
    r.add_argument("--output", "-o", default=None, help=".png (default render.png) or .npy")
    r.add_argument(
        "--sharded", action="store_true",
        help="render over every rank of the world (bands of 8 rows dealt round robin)",
    )
    _add_device(r)
    r.set_defaults(fn=cmd_render)

    m = sub.add_parser("mesh", help="hierarchical refine + marching cubes -> OBJ/VTK")
    m.add_argument(
        "--scene", default="reference_render_scene",
        help="scene name (bsdmg_tpu_torch.models.SCENES), a .json CSG spec or "
        "'mesh:path.obj[:RES]'; the render scene meshes its object, reference_object",
    )
    m.add_argument("--refine", type=int, default=3, help="refinement levels")
    m.add_argument("--init-factor", type=int, default=32)
    m.add_argument("--bb-size", type=float, default=5.0)
    m.add_argument("--newton-iters", type=int, default=24)
    m.add_argument("--interpolate-edges", action="store_true")
    m.add_argument(
        "--sharded", action="store_true",
        help="shard-local refine + extraction over every rank of the world",
    )
    m.add_argument("--checkpoint", default=None, help="save field npz per level")
    m.add_argument(
        "--resume", default=None, help="resume from a field npz; --refine counts further levels"
    )
    m.add_argument("--output", "-o", default=None, help=".obj (default generated_mesh.obj) or .vtk")
    _add_device(m)
    m.set_defaults(fn=cmd_mesh)

    rm = sub.add_parser("remesh", help="mesh asset -> grid SDF -> adaptive re-extraction")
    rm.add_argument("--input", "-i", required=True, help="source OBJ")
    rm.add_argument("--grid-resolution", type=int, default=128)
    rm.add_argument("--init-factor", type=int, default=32)
    rm.add_argument("--refine", type=int, default=2)
    rm.add_argument("--newton-iters", type=int, default=8)
    rm.add_argument("--output", "-o", default=None, help=".obj (default remeshed.obj) or .vtk")
    _add_device(rm)
    rm.set_defaults(fn=cmd_remesh)

    ft = sub.add_parser("fit", help="inverse rendering: recover SDF params from depth or image")
    ft.add_argument(
        "--scene", default="reference_render_scene",
        help="scene name, a .json CSG spec or 'mesh:path.obj[:RES]'; the depth fit of the "
        "render scene fits its object, reference_object; the image fit takes every scene with "
        "a component form (the box has none)",
    )
    common_camera(ft, 64, 64)
    ft.add_argument("--steps", type=int, default=60)
    ft.add_argument("--lr", type=float, default=0.2)
    ft.add_argument(
        "--image", action="store_true",
        help="fit an L2 image loss with the fused loss and gradient (kernel K5)",
    )
    ft.add_argument(
        "--perturb", default=None,
        help="key=factor[,key=+delta]: which params to perturb and recover "
        "(default for the reference scene: sphere_radius=1.3,smooth_k=0.6; "
        "with --image sphere_radius=1.25,smooth_k=0.7,skeleton_line_width=1.3)",
    )
    _add_device(ft)
    ft.set_defaults(fn=cmd_fit)

    a = sub.add_parser("animate", help="render a camera orbit or object motion")
    a.add_argument(
        "--scene", default="reference_render_scene",
        help="scene name (bsdmg_tpu_torch.models.SCENES), a .json CSG spec or "
        "'mesh:path.obj[:RES]'",
    )
    common_camera(a, 1920, 1080)
    a.add_argument("--frames", type=int, default=8)
    a.add_argument(
        "--motion", choices=["none", "axis", "spheric"], default="none",
        help="object translation motion (reference example_scene.rs:63-101)",
    )
    a.add_argument(
        "--rotate", action="store_true",
        help="compose a RotateAxisMotion about +Y (example_scene.rs:63-67)",
    )
    a.add_argument("--cycle-duration", type=float, default=5.0)
    a.add_argument("--seconds", type=float, default=5.0, help="animated time span")
    a.add_argument(
        "--enable-movement", action=argparse.BooleanOptionalAction, default=True,
        help="the reference's ExampleSceneSettings.enable_movement gate (M key)",
    )
    a.add_argument("--output", "-o", default=None, help="frame prefix (default frame)")
    a.add_argument(
        "--gif", default=None,
        help="also assemble the frames into a looping animated GIF at this path",
    )
    _add_device(a)
    a.set_defaults(fn=cmd_animate)

    se = sub.add_parser("session", help="scripted refine/advance stage machine")
    se.add_argument(
        "--scene", default="reference_render_scene",
        help="scene name (bsdmg_tpu_torch.models.SCENES), a .json CSG spec or "
        "'mesh:path.obj[:RES]', meshed as named",
    )
    se.add_argument("--keys", default="vbbbvv", help="key script: b=refine, v=advance")
    se.add_argument("--commands", default=None, help="comma list: refine,advance,...")
    se.add_argument("--init-factor", type=int, default=32)
    se.add_argument("--bb-size", type=float, default=5.0)
    se.add_argument("--output", "-o", default=None, help=".obj (default generated_mesh.obj)")
    _add_device(se)
    se.set_defaults(fn=cmd_session)

    b = sub.add_parser("bench", help="operating-point benchmarks")
    b.add_argument(
        "--which",
        choices=["all", "render", "refine", "mc", "grad", "scaling", "scaling-proxy"],
        default="all",
    )
    b.add_argument(
        "--scene", default="reference_render_scene",
        help="render: scene name (bsdmg_tpu_torch.models.SCENES)",
    )
    b.add_argument("--width", type=int, default=1920)
    b.add_argument("--height", type=int, default=1080)
    b.add_argument(
        "--trace", default=None, metavar="DIR",
        help="capture a torch.profiler trace of the benched region into DIR",
    )
    b.add_argument(
        "--roofline", action="store_true",
        help="with render or grad: print measured step stats + %% of speed-of-light",
    )
    b.add_argument(
        "--two-phase", default=None, choices=["row", "block"],
        help="render: ray-retirement mode (default single-phase)",
    )
    b.add_argument(
        "--unroll", type=int, default=1,
        help="render: frames per timed step",
    )
    _add_device(b)
    b.set_defaults(fn=cmd_bench)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    sys.exit(main())
