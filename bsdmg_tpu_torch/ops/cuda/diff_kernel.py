"""The differentiable render's kernels K4 and K5: wrappers and plain twins.

Counterpart of ``bsdmg_tpu/ops/pallas/diff_kernel.py``:

* :func:`march_params_cuda` (kernel K4, for ``march_params_pallas``): the
  stopped sphere-trace march under runtime parameters, with the slab cull
  against the caller's trust-region bounds ``bb``, ``dfdt`` (the SDF's
  derivative along the ray at the end point) and, with ``track_min``, the
  closest-approach record ``(min_m, t_min)``;
* :func:`render_loss_grad_cuda` (kernel K5, for ``render_loss_grad_pallas``):
  the whole image-fit step, the L2 image loss (plus the silhouette hinge
  with ``edge_weight``) and its gradient with respect to the parameters.

A CUDA tensor goes to the kernel (``csrc/diff_kernel.cu``), a CPU tensor to
the plain PyTorch twin (:func:`march_params_torch`,
:func:`render_loss_grad_torch`); nothing falls back from one to the other.
The scene is the component form of a scene the image fit takes, which the
kernels evaluate from the flat parameter vector (``weights.flatten_params``)
in one of their parameter forms (``csrc/param_forms.cuh``):
:class:`ReferenceCsdf` (the reference scenes), :class:`SphereCsdf`,
:class:`MandelbulbCsdf`, :class:`WrappedCsdf` (the other built-in scenes;
K5's tangent launch sweeps the wrapped object as a parameter program,
``csdf.py::wrapped_param_program``, and folds its private slots' adjoints
back), :class:`ComposedCsdf` (a composed scene, as a parameter program,
``csdf.py::param_program``) and :class:`GridCsdf` (a mesh asset's baked
grid, read as data: it reads no parameter, its gradient is zero and K5
takes no tangent). Any other component form raises
``NotImplementedError``. A composed scene beyond the small tier's caps
(``csdf.py::large_tier``: more than 64 values, or a program beyond the
interpreter's caps) runs in the kernels' large tier.

``split`` is the near/far split (``csdf.py::compile_scene_split``, its near
box inflated by the caller): an 8x4 patch of rays that all miss the near
box marches the reference scene's wireframe alone and takes dfdt of it; the
loss and gradient evaluate the full scene, as the JAX kernels do.
"""

from __future__ import annotations

import collections
import ctypes
import math

import torch

from bsdmg_tpu_torch.config import MarchConfig
from bsdmg_tpu_torch.models.compose import ComposedCsdf
from bsdmg_tpu_torch.models.mesh_sdf import GridCsdf
from bsdmg_tpu_torch.models.scenes import (
    FRAME_LINE_WIDTH,
    MandelbulbCsdf,
    ReferenceCsdf,
    SphereCsdf,
    WrappedCsdf,
)
from bsdmg_tpu_torch.ops.cuda.build import load_library
from bsdmg_tpu_torch.ops.cuda.csdf import (
    PARAM_CAP,
    f32,
    large_tier,
    param_program,
    param_program_words,
    program_depths,
    wrapped_param_program,
)
from bsdmg_tpu_torch.ops.cuda.grid_box import GridBoxC, grid_box_c
from bsdmg_tpu_torch.ops.cuda.render_kernel import (
    _check_inputs,
    _floats,
    _grid_table,
    _march,
    _slab_cull,
    bounds_c,
    far_rays,
    march_c,
    near_c,
    patch_groups,
    shading_c,
)
from bsdmg_tpu_torch.ops.trace import COLLISION
from bsdmg_tpu_torch.weights import flatten_params, param_offsets, unflatten_params

#: launches of K4 and of K5 in this process; each wrapper adds one per launch
MARCH_LAUNCHES = 0
LOSS_GRAD_LAUNCHES = 0
#: launches of the near/far split's instantiations, ``"K4"``
#: (march_params_split_kernel) and ``"K5"`` (loss_march_split_kernel and
#: the launches after it); each is counted in MARCH_LAUNCHES or
#: LOSS_GRAD_LAUNCHES too
SPLIT_LAUNCHES: collections.Counter = collections.Counter()
#: K5's tangent launches by instantiation (:func:`tangent_name`'s names,
#: e.g. ``"loss_reverse_kernel<ProgramForm, 4>"``), one a K5 launch, each
#: counted in LOSS_GRAD_LAUNCHES too
TANGENT_LAUNCHES: collections.Counter = collections.Counter()
#: K5's last launches by kernel, ``"loss_grad_sum"`` or
#: ``"loss_grad_sum_rays"`` (after the mandelbulb's 4 lanes a ray)
SUM_LAUNCHES: collections.Counter = collections.Counter()

#: the kernels' source, relative to the repository root
SOURCE = "bsdmg_tpu_torch/csrc/diff_kernel.cu"

#: values of ``ParamScene::prm`` (the small tier's cap; the large tier
#: reads its vector from device memory), and of the reference form's: the
#: 9 shape values and the object transform
MAX_PARAMS = PARAM_CAP
REFERENCE_PARAMS = 16

#: the parameter forms (csrc/param_sdf.cuh ParamForm)
(FORM_REFERENCE, FORM_SPHERE, FORM_MANDELBULB, FORM_WRAPPED, FORM_PROGRAM, FORM_MESH_GRID,
 FORM_PROGRAM_LARGE) = range(7)
#: each form's structure in csrc/param_forms.cuh
FORM_NAMES = ("ReferenceForm", "SphereForm", "MandelbulbForm", "WrappedForm", "ProgramForm",
              "MeshGridForm", "ProgramLargeForm")

#: the parameters the reference form reads, with their shapes, in
#: ``ParamScene``'s order; the transform's two are optional
PARAM_SHAPES = {
    "skeleton_center": (3,),
    "skeleton_size": (3,),
    "skeleton_line_width": (),
    "sphere_radius": (),
    "smooth_k": (),
    "object_center": (3,),
    "object_rotation": (4,),
}
OPTIONAL_PARAMS = ("object_center", "object_rotation")


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------


def _planes(origins, directions, cone):
    o = tuple(origins[..., a].reshape(-1) for a in range(3))
    d = tuple(directions[..., a].reshape(-1) for a in range(3))
    return o, d, cone.reshape(-1)


def _ray_derivative(f, o, d, t):
    """``f``'s derivative along ``d`` at ``o + t d`` (``jax.jvp`` of
    ``diff_kernel.py:113-118``), by autograd."""
    with torch.enable_grad():
        x = [(oa + t * da).detach().requires_grad_() for oa, da in zip(o, d)]
        g = torch.autograd.grad(f(*x).sum(), x)
    return (g[0] * d[0] + g[1] * d[1]) + g[2] * d[2]


CSDF = "ReferenceCsdf | SphereCsdf | MandelbulbCsdf | WrappedCsdf | ComposedCsdf | GridCsdf"


def _march_planes(cfn, params, o, d, cone, config: MarchConfig, bb, track_min: bool,
                  split=None, shape=None):
    """K4 on flat planes: ``(depth, steps, outcome, dfdt, min_m, t_min)``,
    the last two None without ``track_min``. With ``split``, the rays of
    an 8x4 patch of the ``(H, W)`` ``shape`` that all miss its near box
    march ``cfn``'s wireframe alone (``ReferenceCsdf.frame``) and take dfdt
    of it."""
    stopped = {k: v.detach() for k, v in params.items()}
    f = lambda x, y, z: cfn(stopped, x, y, z)
    depth = torch.zeros_like(cone)
    active = torch.ones_like(cone, dtype=torch.bool)
    limit = torch.full_like(cone, config.depth_limit)
    if bb is not None:
        miss, t_exit = _slab_cull(bb, *o, *d, cone, config)
        depth[miss] = config.depth_limit * 1.01
        active = ~miss
        limit = torch.clamp_max(t_exit, config.depth_limit)
    with torch.no_grad():
        if split is None:
            steps, outcome, min_m, t_min, _ = _march(f, config, *o, *d, cone, active, depth,
                                                     limit, track_min=track_min)
            return depth, steps, outcome, _ray_derivative(f, o, d, depth), min_m, t_min
        far = far_rays(split, *o, *d, cone, config, active, patch_groups(*shape, cone.device))
        steps, outcome, far_m, far_t, _ = _march(cfn.frame, config, *o, *d, cone, active & far,
                                                 depth, limit, track_min=track_min)
        steps, outcome, min_m, t_min, _ = _march(f, config, *o, *d, cone, active & ~far, depth,
                                                 limit, track_min=track_min, steps0=steps,
                                                 outcome0=outcome)
    if track_min:
        min_m, t_min = torch.where(far, far_m, min_m), torch.where(far, far_t, t_min)
    dfdt = torch.where(far, _ray_derivative(cfn.frame, o, d, depth), _ray_derivative(f, o, d, depth))
    return depth, steps, outcome, dfdt, min_m, t_min


def march_params_torch(
    cfn: CSDF,
    params,
    origins: torch.Tensor,
    directions: torch.Tensor,
    cone: torch.Tensor,
    config: MarchConfig = MarchConfig(),
    *,
    bb=None,
    track_min: bool = False,
    split=None,
):
    """Plain PyTorch version of kernel K4 on any device. Returns ``(depth,
    steps, outcome, dfdt)`` planes, and ``(min_m, t_min)`` after them with
    ``track_min``; ``split`` as :func:`march_params_cuda`'s."""
    h, w = cone.shape
    _check_split(cfn, split)
    o, d, c = _planes(origins, directions, cone)
    outs = _march_planes(cfn, params, o, d, c, config, bb, track_min, split, (h, w))
    return tuple(x.reshape(h, w) for x in outs[: 6 if track_min else 4])


def render_loss_grad_torch(
    cfn: CSDF,
    params,
    target: torch.Tensor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    cone: torch.Tensor,
    config: MarchConfig = MarchConfig(),
    *,
    bb=None,
    total_pixels: int | None = None,
    edge_weight: float = 0.0,
    edge_band: float | None = None,
    target_miss: torch.Tensor | None = None,
    split=None,
):
    """Plain PyTorch version of kernel K5 on any device: ``(loss, grads)``,
    ``grads`` a dict like ``params``. The stopped march is K4's twin (with
    ``split``, the far patches' march and dfdt of the wireframe); the
    re-attachment, normal and shading are the differentiable render's
    (``grad/diff_render.py``) of the full scene, differentiated by
    autograd."""
    # imported here: grad/diff_render.py imports this module
    from bsdmg_tpu_torch.grad.diff_render import shade_diff_planes
    from bsdmg_tpu_torch.grad.edge import edge_loss_planes

    _check_split(cfn, split)
    o, d, c = _planes(origins, directions, cone)
    n_pixels = total_pixels or c.numel()
    edge = float(edge_weight) != 0.0
    flat, layout = flatten_params(params)
    depth, _, outcome, dfdt, min_m, t_min = _march_planes(cfn, params, o, d, c, config, bb, edge,
                                                          split, cone.shape)
    with torch.enable_grad():
        prm = flat.detach().clone().requires_grad_()
        p = unflatten_params(prm, layout)
        rgb = shade_diff_planes(cfn, p, *o, *d, c, depth, dfdt, outcome, config)
        err = sum((v - target[..., a].reshape(-1)) ** 2 for a, v in enumerate(rgb))
        loss = err.sum() * (1.0 / (3.0 * n_pixels))
        if edge:
            state = _target_state(target, target_miss).reshape(-1)
            e = edge_loss_planes(
                lambda x, y, z: cfn(p, x, y, z), *o, *d, c, t_min, min_m,
                outcome == COLLISION, state, _band(config, edge_band),
            )
            loss = loss + float(edge_weight) * e.sum() * (1.0 / n_pixels)
        # a scene that reads no parameter (a mesh asset's grid) leaves the
        # loss without a graph: its gradient is zero, as JAX's
        grad = (torch.autograd.grad(loss, prm)[0] if loss.requires_grad
                else torch.zeros_like(prm))
    return loss.detach(), unflatten_params(grad, layout)


def render_loss_grad_sweep_torch(
    cfn: "ComposedCsdf | WrappedCsdf",
    params,
    target: torch.Tensor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    cone: torch.Tensor,
    config: MarchConfig = MarchConfig(),
    *,
    bb=None,
    total_pixels: int | None = None,
    edge_weight: float = 0.0,
    edge_band: float | None = None,
    target_miss: torch.Tensor | None = None,
):
    """K5 by its reverse sweep's route, in plain PyTorch, for a scene K5
    sweeps (a composed scene's program, the wrapped object's lowered one):
    ``(loss, grads)`` as :func:`render_loss_grad_torch`'s. The stopped march
    is K4's twin; each ray then takes what ``loss_reverse_kernel`` does
    (csrc/diff_kernel.cu ray_loss_reverse), the sweep by its CPU mirror
    (``csdf.param_program_adjoint_torch``): at a hit, the program at x0,
    ``t_diff`` and q, the program's value and gradient g at q, the loss and
    its derivative in g (autograd through the normal, the shading, ACES and
    the squared error), the sweep at q from ``(0, dL/dg)``, the sweep at x0
    from ``-(dL/dq . d) / denom``; a hinge ray's sweep at its
    closest-approach point. The wrapped object's private slots are folded
    back. For the tests: the card runs the kernel."""
    from bsdmg_tpu_torch.grad.edge import UNTRACKED
    from bsdmg_tpu_torch.ops.cuda.csdf import _tie_weight, param_program_adjoint_torch
    from bsdmg_tpu_torch.ops.shade import shade_planes

    o, d, c = _planes(origins, directions, cone)
    n_pixels = total_pixels or c.numel()
    edge = float(edge_weight) != 0.0
    flat, layout = flatten_params(params)
    depth, _, outcome, dfdt, min_m, t_min = _march_planes(cfn, params, o, d, c, config, bb, edge)
    offsets = param_offsets(layout)
    if isinstance(cfn, WrappedCsdf):
        wrapped = wrapped_param_program(offsets, flat.numel())
        prog, slots, fold = wrapped.prog, wrapped.extend(flat.detach()), wrapped.fold
    else:
        prog, slots, fold = param_program(cfn.spec, offsets), flat.detach(), lambda a: a
    sweep = lambda pts, seed, seed_grad=None: param_program_adjoint_torch(  # noqa: E731
        prog, slots, *pts, seed, seed_grad)
    at = lambda t, rows: tuple(oa[rows] + t * da[rows] for oa, da in zip(o, d))  # noqa: E731
    inv_elems, inv_pixels = f32(1.0 / (3.0 * n_pixels)), f32(1.0 / n_pixels)
    tgt = [target[..., a].reshape(-1) for a in range(3)]
    # the misses' colours, then the hits' loss and sweeps
    rgb = shade_planes(*(torch.zeros_like(c) for _ in range(3)), outcome)
    total = (sum((v - t) ** 2 for v, t in zip(rgb, tgt)) * inv_elems)[outcome != COLLISION].sum()
    adjoints = torch.zeros(slots.numel(), dtype=torch.float32)
    hit = outcome == COLLISION
    if hit.any():
        t0, ch = depth[hit], c[hit]
        x0 = at(t0, hit)
        denom = dfdt[hit] - ch
        denom = torch.where(denom.abs() < 1e-6, -1e-6, denom)
        zero = torch.zeros_like(t0)
        f0 = sweep(x0, zero)[0]
        t_diff = t0 - ((f0 - ch * t0) - config.collision_distance) / denom
        q = at(t_diff, hit)
        g = sweep(q, zero, (zero, zero, zero))[1]
        with torch.enable_grad():
            g = [v.detach().requires_grad_() for v in g]
            inv = 1.0 / torch.sqrt(torch.clamp_min((g[0] * g[0] + g[1] * g[1]) + g[2] * g[2],
                                                   1e-24))
            shaded = shade_planes(*(v * inv for v in g), outcome[hit])
            photo = sum((v - t[hit]) ** 2 for v, t in zip(shaded, tgt)) * inv_elems
            seed_grad = torch.autograd.grad(photo.sum(), g)
        total = total + photo.detach().sum()
        _, _, bar_q, q_bar = sweep(q, zero, seed_grad)
        dt = (q_bar[0] * d[0][hit] + q_bar[1] * d[1][hit]) + q_bar[2] * d[2][hit]
        adjoints = adjoints + bar_q.sum(0) + sweep(x0, -dt / denom)[2].sum(0)
    if edge:
        state = _target_state(target, target_miss).reshape(-1)
        valid, miss = state > -0.5, state > 0.5
        appear = valid & ~miss & ~hit & (min_m < UNTRACKED)
        vanish = valid & miss & hit
        hinge = appear | vanish
        if hinge.any():
            m = sweep(at(t_min[hinge], hinge), torch.zeros_like(c[hinge]))[0] - c[hinge] * t_min[hinge]
            arg = torch.where(appear[hinge], m, _band(config, edge_band) - m)
            h = torch.clamp_min(arg, 0.0)
            total = total + ((h * float(edge_weight)) * inv_pixels).sum()
            dm = torch.where(appear[hinge], 1.0, -1.0) * _tie_weight(arg, h, torch.zeros_like(h))
            seed = (dm * float(edge_weight)) * inv_pixels
            adjoints = adjoints + sweep(at(t_min[hinge], hinge), seed)[2].sum(0)
    return total, unflatten_params(fold(adjoints), layout)


def _check_split(cfn, split) -> None:
    """A split needs the reference form with its wireframe: K4 and K5 march
    ``ReferenceCsdf.frame`` as its far scene."""
    if split is None:
        return
    if len(split) != 2 or len(split[1]) not in (2, 3):
        raise ValueError("split must be (far, (lo, hi[, slack])) of csdf.py::compile_scene_split")
    if not isinstance(cfn, ReferenceCsdf) or cfn.frame_size is None:
        raise NotImplementedError(
            "the near/far split of K4 and K5 is built for the reference render scene's form "
            "(ReferenceCsdf with its wireframe), as compile_scene_split gives it"
        )


def _target_state(target, target_miss):
    """0 where the target shows the surface, 1 where it does not."""
    from bsdmg_tpu_torch.grad.edge import classify_target_miss

    miss = classify_target_miss(target) if target_miss is None else target_miss
    return miss.to(torch.float32)


def _band(config: MarchConfig, edge_band):
    return 4.0 * config.collision_distance if edge_band is None else float(edge_band)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


class _ParamSceneC(ctypes.Structure):
    """``ParamScene`` of csrc/param_sdf.cuh: the parameters at fixed places
    and where each one is in the flat vector, the scene's form, the bounds, the march limits and the
    shading constants, all as float32 values."""

    _fields_ = [
        ("shape_prm", _floats(9)),
        ("rigid_prm", _floats(7)),
        ("n_prm", ctypes.c_int),
        ("n_slots", ctypes.c_int),
        *((name, ctypes.c_int) for name in PARAM_SHAPES),
        ("reference_compat", ctypes.c_int),
        ("has_frame", ctypes.c_int),
        ("frame_size", ctypes.c_float),
        ("frame_line_width", ctypes.c_float),
        ("use_bounds", ctypes.c_int),
        ("lo", _floats(3)),
        ("hi", _floats(3)),
        ("cull_center", _floats(3)),
        ("cull_radius", ctypes.c_float),
        ("slack", ctypes.c_float),
        ("collision_distance", ctypes.c_float),
        ("depth_limit", ctypes.c_float),
        ("cull_depth", ctypes.c_float),
        ("step_limit", ctypes.c_int),
        ("light", _floats(3)),
        ("color_low", _floats(3)),
        ("color_delta", _floats(3)),
        ("aces_m1", _floats(9)),
        ("aces_m2", _floats(9)),
        ("aces_curve", _floats(5)),
        ("form", ctypes.c_int),
        ("prm", _floats(MAX_PARAMS)),
        ("cell", ctypes.c_int),
        ("program", ctypes.c_void_p),
        ("program_length", ctypes.c_int),
        ("grid_table", ctypes.c_void_p),
        ("grid", GridBoxC),
        ("prm_values", ctypes.c_void_p),
        ("scratch", ctypes.c_void_p),
        ("scratch_threads", ctypes.c_int),
        ("program_depth", ctypes.c_int),
        ("program_frames", ctypes.c_int),
        ("split", ctypes.c_int),
        ("near_lo", _floats(3)),
        ("near_hi", _floats(3)),
        ("near_center", _floats(3)),
        ("near_radius", ctypes.c_float),
        ("near_slack", ctypes.c_float),
    ]


def _check_layout(layout, shapes: dict, optional=()) -> None:
    """The parameters a form reads are there, with their shapes."""
    got = dict(layout)
    for name, want in shapes.items():
        if name in got and got[name] != want:
            raise ValueError(f"parameter {name!r} has shape {got[name]}, the kernels take {want}")
    missing = [n for n in shapes if n not in got and n not in optional]
    if missing:
        raise ValueError(f"parameters {missing} are missing")


def _reference_fields(offsets: dict, values: list, reference_compat: bool, frame_size) -> dict:
    """The reference form's fields: its parameters at fixed places and
    their slots, the wireframe."""

    def at(name, size, absent=()):
        return values[offsets[name]:offsets[name] + size] if name in offsets else list(absent)

    shape = (at("skeleton_center", 3) + at("skeleton_size", 3) + at("skeleton_line_width", 1)
             + at("sphere_radius", 1) + at("smooth_k", 1))
    rigid = at("object_center", 3, (0.0,) * 3) + at("object_rotation", 4, (1.0, 0.0, 0.0, 0.0))
    return dict(
        shape_prm=_floats(9)(*shape),
        rigid_prm=_floats(7)(*rigid),
        reference_compat=int(reference_compat),
        has_frame=int(frame_size is not None),
        frame_size=f32(frame_size or 0.0),
        frame_line_width=f32(FRAME_LINE_WIDTH),
        **{name: offsets.get(name, -1) for name in PARAM_SHAPES},
    )


def _program_words(cfn: "ComposedCsdf | WrappedCsdf", layout, device):
    """``(words, program)``: the scene's parameter program for ``layout`` (a
    composed scene's instructions, or the wrapped object's
    :class:`~bsdmg_tpu_torch.ops.cuda.csdf.WrappedProgram`), and its int32
    words on ``device`` (uploaded once per layout and device, kept on
    ``cfn``)."""
    cache = cfn.__dict__.setdefault("_param_words", {})
    key = (layout, torch.device(device))
    if key not in cache:
        offsets = param_offsets(layout)
        if isinstance(cfn, WrappedCsdf):
            prog = wrapped_param_program(offsets, sum(math.prod(s) for _, s in layout))
            instructions = prog.prog
        else:
            prog = instructions = param_program(cfn.spec, offsets)
        cache[key] = (torch.from_numpy(param_program_words(instructions)).to(device), prog)
    return cache[key]


def _program_fields(keep, prog) -> dict:
    """The ParamScene fields of a parameter program: its words (``keep``,
    on the device that reads them), length and depths."""
    depth, frames = program_depths(prog)
    return dict(program=keep.data_ptr(), program_length=keep.shape[0], program_depth=depth,
                program_frames=frames)


def param_scene_c(cfn: CSDF, params, config: MarchConfig = MarchConfig(), bb=None,
                  device="cuda", split=None):
    """``(ParamScene, layout)``: the scene and ``params`` as the kernels
    take them, and the flat vector's layout (``weights.flatten_params``).
    The form follows ``cfn``'s type; a composed scene's parameter program
    lives on ``device`` and the struct keeps it alive, and beyond the small
    tier's caps (``csdf.py::large_tier``) its form is the large tier's,
    which reads the flat vector from ``device`` too. A mesh asset's grid
    (:class:`GridCsdf`) is read from its table on ``device``, no parameter
    enters the struct (``n_prm`` 0) and ``layout`` is None. ``split`` turns
    on the near/far split (the reference form with its wireframe). The
    struct's ``fold`` maps K5's gradient by slot onto the flat vector: the
    wrapped object's program (:func:`csdf.wrapped_param_program`) reads
    private slots after it; None for the other forms."""
    forms = {ReferenceCsdf: FORM_REFERENCE, SphereCsdf: FORM_SPHERE,
             MandelbulbCsdf: FORM_MANDELBULB, WrappedCsdf: FORM_WRAPPED,
             ComposedCsdf: FORM_PROGRAM, GridCsdf: FORM_MESH_GRID}
    form = forms.get(type(cfn))
    if form is None:
        raise NotImplementedError(
            f"the kernels evaluate the component forms {sorted(t.__name__ for t in forms)}, "
            f"not {type(cfn).__name__}"
        )
    _check_split(cfn, split)
    fields = dict(
        form=form,
        use_bounds=int(bb is not None),
        **{name: -1 for name in PARAM_SHAPES},
        **march_c(config),
        **shading_c(),
        **(bounds_c(bb) if bb is not None else {}),
        **near_c(split),
    )
    if form == FORM_MESH_GRID:
        grid = cfn.grid
        table = grid.values if torch.device(device).type == "cpu" else _grid_table(grid, device)
        scene = _ParamSceneC(**fields, n_prm=0, n_slots=0, grid_table=table.data_ptr(),
                             grid=grid_box_c(grid.resolution, grid.lo, grid.hi))
        scene.grid_values, scene.fold = table, None  # the struct keeps the table alive
        return scene, None
    flat, layout = flatten_params(params)
    most = {FORM_REFERENCE: REFERENCE_PARAMS, FORM_PROGRAM: None}.get(form, MAX_PARAMS)
    if most is not None and flat.numel() > most:
        raise ValueError(f"{flat.numel()} parameter values; the kernels take at most {most}")
    offsets = param_offsets(layout)
    values = flat.detach().cpu().tolist()
    fields.update(prm=_floats(MAX_PARAMS)(*values[:MAX_PARAMS]), n_prm=len(values),
                  n_slots=len(values))
    keep = on_device = fold = None
    if form in (FORM_REFERENCE, FORM_WRAPPED):
        extra = {"cell": ()} if form == FORM_WRAPPED else {}
        _check_layout(layout, {**PARAM_SHAPES, **extra}, OPTIONAL_PARAMS)
        frame = cfn.frame_size if form == FORM_REFERENCE else None
        compat = cfn.reference_compat if form == FORM_REFERENCE else True
        fields.update(_reference_fields(offsets, values, compat, frame))
        if form == FORM_WRAPPED:
            # the march reads the flat vector's slots, K5's sweep the
            # lowered program's, the private ones after them
            keep, wrapped = _program_words(cfn, layout, device)
            slots = wrapped.extend(flat.detach().cpu().to(torch.float32)).tolist()
            if len(slots) > MAX_PARAMS:
                raise ValueError(f"{len(slots)} values with the wrapped object's private slots; "
                                 f"the kernels take at most {MAX_PARAMS}")
            fields.update(cell=offsets["cell"], prm=_floats(MAX_PARAMS)(*slots),
                          n_slots=len(slots), **_program_fields(keep, wrapped.prog))
            fold = wrapped.fold
    elif form in (FORM_SPHERE, FORM_MANDELBULB):
        name = "radius" if form == FORM_SPHERE else "scale"
        if layout != ((name, ()),):
            raise ValueError(f"the {type(cfn).__name__} form takes one parameter, {name!r}; "
                             f"got {[n for n, _ in layout]}")
    else:
        try:
            keep, prog = _program_words(cfn, layout, device)
        except KeyError as missing:
            raise ValueError(f"parameter {missing} of the scene's spec is missing") from None
        fields.update(_program_fields(keep, prog))
        if large_tier(prog, len(values)):
            on_device = flat.detach().to(device=device, dtype=torch.float32).contiguous()
            fields.update(form=FORM_PROGRAM_LARGE, prm_values=on_device.data_ptr())
    scene = _ParamSceneC(**fields)
    scene.program_words, scene.values_on_device = keep, on_device  # the struct keeps them alive
    scene.fold = fold
    return scene, layout


def library() -> ctypes.CDLL:
    """The kernel library with K4's and K5's entry points typed and the
    ``ParamScene`` layout checked against the source's."""
    lib = load_library()
    ptr, i32, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bsdmg_march_params_scratch.restype = ctypes.c_longlong
    lib.bsdmg_march_params_scratch.argtypes = [ptr, i32, i32]
    lib.bsdmg_march_params.restype = i32
    lib.bsdmg_march_params.argtypes = [ptr] * 11 + [i32, i32, ptr]
    lib.bsdmg_loss_grad_scratch.restype = ctypes.c_longlong
    lib.bsdmg_loss_grad_scratch.argtypes = [ptr, i32, i32]
    lib.bsdmg_loss_grad.restype = i32
    lib.bsdmg_loss_grad.argtypes = [ptr] * 8 + [i32, i32, f, f, f, f, ptr, ptr]
    lib.bsdmg_param_scene_size.restype = i32
    lib.bsdmg_param_scene_size.argtypes = []
    lib.bsdmg_error_string.restype = ctypes.c_char_p
    lib.bsdmg_error_string.argtypes = [i32]
    size = lib.bsdmg_param_scene_size()
    if size != ctypes.sizeof(_ParamSceneC):
        raise RuntimeError(
            f"ParamScene layout mismatch: {size} bytes in {SOURCE}, "
            f"{ctypes.sizeof(_ParamSceneC)} in {__name__}"
        )
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError {err} ({lib.bsdmg_error_string(err).decode()})")


def _march_cuda(scene_c, origins, directions, cone, track_min):
    global MARCH_LAUNCHES
    lib = library()
    h, w = cone.shape
    depth, dfdt = (torch.empty_like(cone) for _ in range(2))
    steps, outcome = (torch.empty((h, w), dtype=torch.int32, device=cone.device) for _ in range(2))
    min_m = t_min = None
    if track_min:
        min_m, t_min = (torch.empty_like(cone) for _ in range(2))
    scratch = torch.empty(lib.bsdmg_march_params_scratch(ctypes.byref(scene_c), h, w),
                          dtype=torch.float32, device=cone.device)
    with torch.cuda.device(cone.device):
        stream = torch.cuda.current_stream(cone.device).cuda_stream
        err = lib.bsdmg_march_params(
            ctypes.byref(scene_c), origins.data_ptr(), directions.data_ptr(), cone.data_ptr(),
            depth.data_ptr(), steps.data_ptr(), outcome.data_ptr(), dfdt.data_ptr(),
            0 if min_m is None else min_m.data_ptr(), 0 if t_min is None else t_min.data_ptr(),
            scratch.data_ptr() if scratch.numel() else 0, h, w, stream,
        )
    _raise_on(lib, err, "K4 (march_params) launch")
    MARCH_LAUNCHES += 1
    if scene_c.split:
        SPLIT_LAUNCHES["K4"] += 1
    return (depth, steps, outcome, dfdt) + ((min_m, t_min) if track_min else ())


#: K5's tangent kernels by the number csrc/diff_kernel.cu's bsdmg_loss_grad
#: reports for its launch
TANGENT_KERNELS = ("loss_tangent_kernel", "loss_tangent_form_kernel", "loss_reverse_kernel")


def tangent_name(code: int) -> str:
    """The instantiation of K5's tangent launch that ``bsdmg_loss_grad``
    reports it made (``(kernel * 8 + form) * 8 + lanes a ray``),
    ``"kernel<Form, lanes>"``, or ``"loss_tangent_kernel"`` for the
    reference form's launches."""
    kernel, form, lanes = code // 64, code // 8 % 8, code % 8
    if kernel == 0:
        return TANGENT_KERNELS[0]
    return f"{TANGENT_KERNELS[kernel]}<{FORM_NAMES[form]}, {lanes}>"


def _loss_grad_cuda(scene_c, origins, directions, cone, target, t_state, n_pixels,
                    edge_weight, band):
    """K5 from a prepared struct: the loss, then dL/dprm by slot (the
    struct's ``n_slots``, before its ``fold``)."""
    global LOSS_GRAD_LAUNCHES
    lib = library()
    h, w = cone.shape
    scratch = torch.empty(lib.bsdmg_loss_grad_scratch(ctypes.byref(scene_c), h, w),
                          dtype=torch.float32, device=cone.device)
    out = torch.empty(scene_c.n_slots + 1, dtype=torch.float32, device=cone.device)
    made = (ctypes.c_int * 2)(-1, 0)
    with torch.cuda.device(cone.device):
        stream = torch.cuda.current_stream(cone.device).cuda_stream
        err = lib.bsdmg_loss_grad(
            ctypes.byref(scene_c), origins.data_ptr(), directions.data_ptr(), cone.data_ptr(),
            target.data_ptr(), 0 if t_state is None else t_state.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), h, w,
            f32(1.0 / (3.0 * n_pixels)), f32(1.0 / n_pixels), f32(edge_weight), f32(band), stream,
            made,
        )
    _raise_on(lib, err, "K5 (loss_grad) launch")
    LOSS_GRAD_LAUNCHES += 1
    TANGENT_LAUNCHES[tangent_name(made[0])] += 1
    SUM_LAUNCHES[("loss_grad_sum", "loss_grad_sum_rays")[made[1]]] += 1
    if scene_c.split:
        SPLIT_LAUNCHES["K5"] += 1
    return out


def _check_params(params, device) -> None:
    for name, v in params.items():
        if not isinstance(v, torch.Tensor) or v.device != device:
            raise ValueError(f"parameter {name!r} must be a tensor on {device}")


def march_params_cuda(
    cfn: CSDF,
    params,
    origins: torch.Tensor,
    directions: torch.Tensor,
    cone: torch.Tensor,
    config: MarchConfig = MarchConfig(),
    *,
    bb=None,
    track_min: bool = False,
    split=None,
):
    """Sphere-trace an ``(H, W)`` ray image under the parameters ``params``
    (kernel K4). ``bb``, the bounds of the surface over every parameter
    value the caller will reach, turns on the slab cull; ``split`` the
    near/far split (module docstring). The march steps exactly whatever
    ``config.relaxation`` says, as the JAX kernel does. Returns ``(depth,
    steps, outcome, dfdt)``, and ``(min_m, t_min)`` after them with
    ``track_min`` (culled rays carry ``min_m = 1e9``). CUDA tensors go
    through K4, CPU tensors through :func:`march_params_torch`."""
    _check_inputs(origins, directions, cone)
    _check_params(params, cone.device)
    if cone.device.type == "cuda":
        scene_c, _ = param_scene_c(cfn, params, config, bb, cone.device, split)
        return _march_cuda(scene_c, origins, directions, cone, track_min)
    if cone.device.type == "cpu":
        return march_params_torch(cfn, params, origins, directions, cone, config, bb=bb,
                                  track_min=track_min, split=split)
    raise ValueError(f"unsupported device {cone.device}")


def render_loss_grad_cuda(
    cfn: CSDF,
    params,
    target: torch.Tensor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    cone: torch.Tensor,
    config: MarchConfig = MarchConfig(),
    *,
    bb=None,
    total_pixels: int | None = None,
    edge_weight: float = 0.0,
    edge_band: float | None = None,
    target_miss: torch.Tensor | None = None,
    split=None,
):
    """The image-fit step (kernel K5): ``(loss, grads)`` of the L2 loss of
    the render of ``params`` against ``target`` (``(H, W, 3)`` linear RGB),
    normalised by ``3 * total_pixels`` (default ``H * W``), plus
    ``edge_weight`` times the silhouette hinge (``grad/edge.py``) over
    ``total_pixels``. ``target_miss`` overrides the target's miss mask
    (default: classified from its colours); ``edge_band`` defaults to
    ``4 * collision_distance``; ``split`` is the near/far split (module
    docstring). The march steps exactly whatever ``config.relaxation``
    says. ``grads`` is a dict like ``params``. CUDA tensors go through K5,
    CPU tensors through :func:`render_loss_grad_torch`."""
    _check_inputs(origins, directions, cone)
    _check_params(params, cone.device)
    h, w = cone.shape
    if not isinstance(target, torch.Tensor) or target.dtype != torch.float32:
        raise TypeError("target must be a float32 tensor")
    if tuple(target.shape) != (h, w, 3) or not target.is_contiguous() or target.device != cone.device:
        raise ValueError(f"target must be a contiguous ({h}, {w}, 3) tensor on {cone.device}")
    if cone.device.type == "cpu":
        return render_loss_grad_torch(
            cfn, params, target, origins, directions, cone, config, bb=bb,
            total_pixels=total_pixels, edge_weight=edge_weight, edge_band=edge_band,
            target_miss=target_miss, split=split,
        )
    if cone.device.type != "cuda":
        raise ValueError(f"unsupported device {cone.device}")
    scene_c, layout = param_scene_c(cfn, params, config, bb, cone.device, split)
    edge = float(edge_weight) != 0.0
    t_state = _target_state(target, target_miss).contiguous() if edge else None
    out = _loss_grad_cuda(
        scene_c, origins, directions, cone, target, t_state, total_pixels or h * w,
        float(edge_weight), _band(config, edge_band),
    )
    if layout is None:  # the grid form: no parameter is read, the gradient is zero
        return out[0], {k: torch.zeros_like(v) for k, v in params.items()}
    grad = out[1:] if scene_c.fold is None else scene_c.fold(out[1:])
    return out[0], unflatten_params(grad, layout)
