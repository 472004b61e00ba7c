"""Composed JSON scenes through the port against the JAX package, on
numpy-seeded inputs.

The inputs: the three ``examples/*.json`` specs and two specs defined here
that between them use all 7 primitives and all 7 operators (``LATTICE``: a
``wrap`` root over a smooth union of a torus, a transformed cylinder and a
``reference_compat: false`` skeleton; ``GROUND``: a root union with a plane,
so unbounded, of a subtract of an intersect, a shell and a capsule). The
bars:

* the spec's validation, params, ids and bounds equal to JAX's;
* ``Scene.sdf`` and its autograd gradient against ``jax.grad`` of
  ``compose_scene(...).sdf``: within 1e-5 (float32 rounding of two
  operation orders that XLA contracts into FMAs);
* the node program's constants (the plane's rsqrt, the transform's
  rotation entries) equal to the ones JAX forms, bit for bit;
* the kernels' twins ``descriptor_csdf`` and
  ``descriptor_csdf_value_and_grad`` against JAX's baked
  ``composed_baked_csdf`` and its ``jax.vjp``: values within 2e-5,
  gradients within 1e-5, NaN at the same places (the box's inside, the
  cylinder's axis; the gadget's box makes 3% of its gradients NaN in both);
* the render twins of K1 and of K2 + K3 against JAX's XLA render and once
  against ``render_image_pallas(..., interpret=True)``: the bars of
  ``tests/test_torch_scenes.py``'s exact scenes (outcomes equal on every
  pixel, steps on >= 99.7%, depth within 1e-4 where the steps agree, 1e-5
  relative past depth 10, the image within the reference scene's bars);
* refine survivor sets equal, and level-2 meshes (grad and fd4
  projection, and interpolated edges) as triangle sets against
  ``generate_mesh(..., csdf=compile_scene_csdf(scene))``, the CLI's
  level-1 mesh as canonical face sets; where JAX's mesh has NaN vertices
  (the gadget's box under "grad"), the port's are as many;
* the CLI: ``render``, ``mesh`` and ``session`` of a ``.json`` scene and of
  ``spec:``; the depth ``fit`` against JAX's ``cmd_fit``; ``fit --image``
  of a spec raising with K4 and K5 named.
"""

import copy
import json
import logging
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from bsdmg_tpu import cli as jax_cli
from bsdmg_tpu.cam import generate_rays, look_at
from bsdmg_tpu.config import MeshGenConfig as JaxMeshGenConfig
from bsdmg_tpu.mesh import create_voxel_field as jax_create_field
from bsdmg_tpu.mesh import generate_mesh as jax_generate_mesh
from bsdmg_tpu.mesh import refine_field as jax_refine_field
from bsdmg_tpu.models import compose as jcompose
from bsdmg_tpu.models.scenes import _quat_inv_rotate_c
from bsdmg_tpu.ops import shade as jshade
from bsdmg_tpu.ops import trace as jtrace
from bsdmg_tpu.ops.pallas import compile_scene_csdf
from bsdmg_tpu.ops.pallas import csdf as jcsdf
from bsdmg_tpu.ops.pallas.render_kernel import render_image_pallas, trace_pallas
from bsdmg_tpu_torch import cli
from bsdmg_tpu_torch.config import MeshGenConfig
from bsdmg_tpu_torch.mesh.export import load_obj
from bsdmg_tpu_torch.mesh.field import create_voxel_field, refine_field
from bsdmg_tpu_torch.mesh.pipeline import generate_mesh
from bsdmg_tpu_torch.models import compose as tcompose
from bsdmg_tpu_torch.ops.cuda import csdf as tcsdf
from bsdmg_tpu_torch.ops.cuda.render_kernel import render_image_cuda, trace_cuda
from bsdmg_tpu_torch.utils import profiling
from bsdmg_tpu_torch.weights import params_from_numpy
from test_torch_mesh import LARGE_SPECS, _sorted_rows, assert_same_mesh
from test_torch_render_kernel import assert_image_bars

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("gadget", "mushroom", "snowman")
COLLISION = 0
STEP_SHARE = 0.997

#: every primitive and operator between the two: a wrap root (unbounded)
#: over a smooth union of a torus, a transformed cylinder and a correct
#: (reference_compat false) skeleton
LATTICE = {"name": "lattice", "root": {"op": "wrap", "cell": [3.0, 2.5, 3.0], "child": {
    "op": "smooth_union", "k": 0.3, "children": [
        {"prim": "torus", "center": [0.0, 0.0, 0.0], "major_radius": 0.7, "minor_radius": 0.18},
        {"op": "transform", "offset": [0.0, 0.2, 0.0], "rotation": [0.8660254, 0.5, 0.0, 0.0],
         "child": {"prim": "cylinder", "radius": 0.2, "height": 1.2}},
        {"prim": "box_skeleton", "size": [1.6, 1.2, 1.0], "line_width": 0.04,
         "reference_compat": False}]}}}
#: a root union with a plane (unbounded: no cull) of a subtract of an
#: intersect and a shell
GROUND = {"name": "ground", "root": {"op": "union", "children": [
    {"prim": "plane", "normal": [0.0, 1.0, 0.1], "offset": -1.0},
    {"op": "subtract", "children": [
        {"op": "intersect", "children": [
            {"prim": "box", "center": [0.0, 0.0, 0.0], "size": [1.6, 1.6, 1.6]},
            {"prim": "sphere", "radius": 1.0}]},
        {"prim": "capsule", "start": [-1.2, 0.0, 0.0], "end": [1.2, 0.0, 0.0], "radius": 0.35},
        {"prim": "cylinder", "radius": 0.4, "height": 3.0}]},
    {"op": "shell", "thickness": 0.03,
     "child": {"prim": "torus", "center": [0.0, 0.9, 0.0], "major_radius": 0.5,
               "minor_radius": 0.1}}]}}
SPECS = {**{n: json.loads((ROOT / "examples" / f"{n}.json").read_text()) for n in EXAMPLES},
         "lattice": LATTICE, "ground": GROUND}
NAMES = sorted(SPECS)


def _pair(name):
    """The JAX package's scene and the port's, from the same spec."""
    spec = {**SPECS, **LARGE_SPECS}[name]
    return (jcompose.compose_scene(copy.deepcopy(spec)),
            tcompose.compose_scene(copy.deepcopy(spec), device="cpu"))


def _desc(name):
    """The port's descriptor at the JAX scene's params, carried across."""
    ref, got = _pair(name)
    return tcsdf.compile_scene(got, params_from_numpy(
        {k: np.asarray(v) for k, v in ref.params.items()}, "cpu"))


def _points(seed, n=20_000, lim=2.2):
    p = np.random.default_rng(seed).uniform(-lim, lim, (n, 3)).astype(np.float32)
    p[:500] = np.round(p[:500] * 4.0) / 4.0  # lattice points: ties, the boxes' faces
    return p


def _rays(w, h):
    rays = generate_rays(look_at((5.0, 2.0, -5.0), fov=np.pi / 4), (w, h), (1920.0, 1080.0))
    arrays = tuple(np.array(a) for a in rays)
    return arrays, tuple(torch.from_numpy(a) for a in arrays)


# ---------------------------------------------------------------------------
# the spec: validation, params, ids, bounds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_params_ids_and_bounds_equal_jax(name):
    ref, got = _pair(name)
    assert got.name == ref.name and sorted(got.params) == sorted(ref.params)
    for k, v in ref.params.items():
        np.testing.assert_array_equal(got.params[k].numpy(), np.asarray(v))
    assert sorted(got.spec["ids"].values()) == sorted(ref.spec["ids"].values())
    bounds = jcompose.composed_bounds(ref)
    assert tcompose.composed_bounds(got) == bounds == tcsdf.scene_bounds(got)
    assert _desc(name).bounds == jcsdf.scene_bounds(ref)
    assert (bounds is None) == (name in ("lattice", "ground"))


BAD = {
    "not a dict": [1.0],
    "unknown primitive": {"prim": "cone"},
    "unknown operator": {"op": "xor", "children": [{"prim": "sphere"}]},
    "no child": {"op": "shell"},
    "short subtract": {"op": "subtract", "children": [{"prim": "sphere"}]},
    "no children": {"op": "union"},
    "neither": {"radius": 1.0},
    "unknown field": {"prim": "sphere", "colour": 1},
    "deep unknown field": {"op": "union", "children": [{"prim": "box", "radius": 1.0}]},
    "shape": {"prim": "sphere", "center": [0.0, 1.0]},
    "zero k": {"op": "smooth_union", "k": 0.0, "children": [{"prim": "sphere"}]},
    "zero cell": {"op": "wrap", "cell": [1.0, 0.0, 1.0], "child": {"prim": "sphere"}},
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_validation_errors_equal_jax(case):
    spec = {"root": BAD[case]}
    with pytest.raises(ValueError) as ref:
        jcompose.compose_scene(copy.deepcopy(spec))
    with pytest.raises(ValueError) as got:
        tcompose.compose_scene(copy.deepcopy(spec), device="cpu")
    assert str(got.value) == str(ref.value)


# ---------------------------------------------------------------------------
# the param-traced SDF and the node program's twins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_scene_sdf_and_its_gradient_match_jax(name):
    """``Scene.sdf`` on seeded points and the gradient of its sum with
    respect to every param (autograd against ``jax.grad``), within 1e-5
    relative to the gradient's scale, where JAX's is finite; a NaN of the
    port's only beside one of JAX's. JAX's gradient of a box's params is
    NaN (the box's ``sqrt`` at 0 inside it, times a zero cotangent);
    torch's ``maximum`` masks that cotangent, so the port's can be finite
    there."""
    ref, got = _pair(name)
    p = _points(1, 4096)
    np.testing.assert_allclose(got.sdf(got.params, torch.from_numpy(p)).numpy(),
                               np.asarray(ref.sdf(ref.params, jnp.asarray(p))), atol=1e-5, rtol=0)
    jgrad = jax.grad(lambda q: jnp.sum(ref.sdf(q, jnp.asarray(p))))(ref.params)
    leaves = {k: v.clone().requires_grad_() for k, v in got.params.items()}
    torch.sum(got.sdf(leaves, torch.from_numpy(p))).backward()
    for k, v in leaves.items():
        r, g = np.asarray(jgrad[k]), v.grad.numpy()
        assert not (np.isnan(g) & ~np.isnan(r)).any(), k
        g, r = g[~np.isnan(r)], r[~np.isnan(r)]
        np.testing.assert_allclose(g, r, atol=1e-5 * max(1.0, np.abs(r).max(initial=0.0)),
                                   rtol=0, err_msg=k)


def test_program_constants_equal_the_jax_values():
    """The plane's ``rsqrt`` of its float32 norm squared and the transform's
    ``r00 ... r22``, for every spec's nodes and a seeded batch of
    quaternions and normals, equal the values JAX forms bit for bit where
    it renders and meshes: under ``jit``, whose constant folding rounds
    ``rsqrt`` correctly. (XLA's op-by-op ``rsqrt`` on the CPU differs from
    it in the last bit on about one argument in eight; the compiler takes
    the folded value.)"""
    rng = np.random.default_rng(4)
    quats = [tuple(map(float, rng.normal(size=4).astype(np.float32))) for _ in range(64)]
    normals = [tuple(map(float, rng.normal(size=3).astype(np.float32))) for _ in range(64)]
    for name in NAMES:
        ref, got = _pair(name)
        root, get = jcompose._resolver(ref, ref.params)
        for node_id, node in ((ref.spec["ids"][id(n)], n) for n in _nodes(root)):
            if node.get("op") == "transform":
                quats.append(get(node, "rotation"))
            if node.get("prim") == "plane":
                normals.append(get(node, "normal"))
    one, zero = jnp.ones(1, jnp.float32), jnp.zeros(1, jnp.float32)
    sums = [n[0] * n[0] + n[1] * n[1] + n[2] * n[2] for n in normals]

    @jax.jit
    def folded():
        # unit x, y, z planes: the rows' entries r_a0, r_a1, r_a2
        rows = [[_quat_inv_rotate_c(q, *(one if a == b else zero for b in range(3)))
                 for a in range(3)] for q in quats]
        return rows, [jax.lax.rsqrt(jnp.maximum(v, 1e-24)) for v in sums]

    rows, inv = folded()
    for q, r in zip(quats, rows):
        ref = [float(np.asarray(r[a][b])[0]) for a in range(3) for b in range(3)]
        assert list(tcsdf._rotation_f32(q)) == ref, q
    for n, v, ref in zip(normals, sums, inv):
        assert tcsdf._rsqrt_f32(v) == float(ref), n


def _nodes(node):
    yield node
    for ch in jcompose._children(node):
        yield from _nodes(ch)


@pytest.mark.parametrize("name", NAMES)
def test_descriptor_value_and_grad_match_jax_vjp(name):
    """The twins of Composed's scene_sdf and scene_sdf_grad against JAX's
    baked SDF and ``jax.vjp`` of it: values within 2e-5, gradients within
    1e-5, NaN at the same places; the value of the gradient's twin equals
    the value's twin bit for bit."""
    ref, _ = _pair(name)
    desc = _desc(name)
    p = _points(2, lim=4.0 if name == "lattice" else 2.2)
    cols_t = [torch.from_numpy(p[:, a].copy()) for a in range(3)]
    cols_j = [jnp.asarray(p[:, a]) for a in range(3)]
    sd, vjp = jax.vjp(jcompose.composed_baked_csdf(ref, ref.params), *cols_j)
    want = [np.asarray(sd), *(np.asarray(g) for g in vjp(jnp.ones_like(sd)))]
    got = [t.numpy() for t in tcsdf.descriptor_csdf_value_and_grad(desc)(*cols_t)]
    np.testing.assert_array_equal(got[0], tcsdf.descriptor_csdf(desc)(*cols_t).numpy())
    np.testing.assert_allclose(got[0], want[0], atol=2e-5, rtol=0)
    for g, r in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
        np.testing.assert_allclose(g, r, atol=1e-5, rtol=0)
    if name == "gadget":
        assert np.isnan(got[1]).mean() > 0.01  # the box's inside, in both


def test_kernel_structure_program_and_caps():
    """Composed is index 8 (the header's case 8), the program's words carry
    the opcodes and the constants' bits, and a program beyond the small
    tier's caps runs in the large tier, ComposedLarge, index 12 (its render
    against JAX: test_render_beyond_the_small_tier_matches_jax)."""
    header = (Path(tcsdf.__file__).resolve().parents[2] / "csrc" / "scene_sdf.cuh").read_text()
    assert "case 8: f(Composed{}); return true;" in header
    assert "case 12: f(ComposedLarge{}); return true;" in header
    # the caps are in program.cuh, which composed.cuh includes
    caps = "".join((Path(tcsdf.__file__).resolve().parents[2] / "csrc" / name).read_text()
                   for name in ("composed.cuh", "program.cuh"))
    assert '#include "program.cuh"' in caps
    for macro, value in (("BSDMG_WORDS", tcsdf.PROGRAM_WORDS), ("BSDMG_PROGRAM", tcsdf.PROGRAM_CAP),
                         ("BSDMG_STACK", tcsdf.STACK_CAP), ("BSDMG_FRAMES", tcsdf.FRAME_CAP)):
        assert re.search(rf"#define {macro} {value}\b", caps), macro
    desc = _desc("gadget")
    assert tcsdf.kernel_structure(desc) == tcsdf.COMPOSED == 8
    ops = [ins.op for ins in desc.program.instructions]
    assert ops == [tcsdf.OP_BOX, tcsdf.OP_SPHERE, tcsdf.OP_SUB, tcsdf.OP_PUSH_TRANSFORM,
                   tcsdf.OP_BOX, tcsdf.OP_SHELL, tcsdf.OP_POP, tcsdf.OP_MIN, tcsdf.OP_SKELETON,
                   tcsdf.OP_MIN]
    words = desc.program.words
    assert words.shape == (10, 16) and words.dtype == np.int32
    np.testing.assert_array_equal(words[:, 0], ops)
    assert words[6, 1] == 3 and words[7, 1] == 2  # the pop's push, the fold's left operand
    assert words[1, 2:6].view(np.float32).tolist() == [1.0, 0.5, 0.0, float(np.float32(0.7))]
    assert not tcsdf.large_tier(desc.program.instructions)
    for name, (length, depth, frames) in (("deep", (79, 2, 0)), ("nested", (25, 2, 10)),
                                          ("right-nested", (35, 18, 0))):
        big = _desc(name)
        assert (len(big.program), *tcsdf.program_depths(big.program.instructions)) == (
            length, depth, frames)
        assert tcsdf.large_tier(big.program.instructions)
        assert tcsdf.kernel_structure(big) == tcsdf.COMPOSED_LARGE == 12


def test_operation_counts():
    """profiling counts a composed scene from its program: the forward per
    opcode, the gradient forward plus backward, the stencil with the terms
    that a shift leaves alone shared (every instruction in the root frame
    here: a sphere 75, the capsule along x 125, each smooth union 12 x 11)."""
    desc = _desc("snowman")  # two spheres, a smooth union, a capsule, a smooth union
    f = 2 * profiling.PROGRAM_FORWARD[tcsdf.OP_SPHERE] + profiling.PROGRAM_FORWARD[
        tcsdf.OP_CAPSULE] + 2 * profiling.PROGRAM_FORWARD[tcsdf.OP_SMOOTH]
    b = 2 * profiling.PROGRAM_BACKWARD[tcsdf.OP_SPHERE] + profiling.PROGRAM_BACKWARD[
        tcsdf.OP_CAPSULE] + 2 * profiling.PROGRAM_BACKWARD[tcsdf.OP_SMOOTH]
    assert profiling.program_ops(desc) == (f, b) == (2 * 10 + 24 + 2 * 11, 2 * 11 + 31 + 2 * 24)
    assert profiling.sdf_ops(desc) == f and profiling.grad_ops(desc) == f + b
    assert profiling.fd4_ops(desc) == profiling.STENCIL + 2 * 75 + 125 + 2 * 12 * 11
    assert profiling.render_ops(desc, 10, 9, 1, 4) == (
        10 * (f + 9) + 9 * 3 + profiling.fd4_ops(desc) + profiling.HIT_SHADING
        + 4 * profiling.RAY)
    assert set(profiling.PROGRAM_FORWARD) == set(profiling.PROGRAM_BACKWARD) == set(range(15))


def _stencil(root):
    stencil = profiling._Stencil()
    stencil.program(tcsdf.compile_scene(tcompose.compose_scene({"root": root},
                                                               device="cpu")).program.instructions)
    return stencil


@pytest.mark.parametrize("name", NAMES)
def test_stencil_count_follows_the_program(name):
    """The shared-term stencil's count (profiling.program_stencil_ops)
    walks the interpreter's forward: one evaluation is the program's
    forward count; under a rotation every value moves with every axis, so
    the stencil is 12 whole programs but for the operations that are
    constants (a product with a zero in a plane's normal, a capsule's axis
    or a rotation), and in any frame it is at most that. The rotation's own
    push, in the root frame, shares its terms: 3 subtracts of 5 and per row
    products of 5, sums of 9 and 12 (123)."""
    f = profiling.program_ops(_desc(name))[0]
    plain = _stencil(copy.deepcopy(SPECS[name]["root"]))
    rotated = _stencil({"op": "transform", "rotation": [0.9, 0.1, 0.2, 0.3],
                        "child": copy.deepcopy(SPECS[name]["root"])})
    assert plain.calls == pytest.approx(f) and rotated.calls == pytest.approx(f + 18)
    assert plain.ops == pytest.approx(profiling.program_stencil_ops(_desc(name)))
    assert plain.ops < rotated.ops <= 12 * (f + 18) + 1e-9
    assert rotated.ops == pytest.approx(123 + 12 * (f - rotated.constants))


def test_stencil_count_shares_as_the_fixed_structures():
    """A primitive in the root frame, or under a wrap or a translation,
    shares the terms of its own axes as the fixed structures' counts do: a
    sphere is SPHERE_STENCIL beside its centre's 3 subtracts, the reference
    frame's skeleton its capsule set's count; a wrap takes 15 wraps, as the
    wrapped object's; a translation shares and a rotation does not."""
    from bsdmg_tpu_torch.models.scenes import reference_render_scene

    sphere = {"prim": "sphere", "center": [0.2, 0.1, 0.0], "radius": 0.5}
    assert _stencil(sphere).ops == 3 * 5 + profiling.SPHERE_STENCIL
    frame = tcsdf.compile_scene(reference_render_scene(device="cpu")).frame
    skeleton = {"prim": "box_skeleton", "size": [5.0, 5.0, 5.0], "line_width": 0.05}
    assert _stencil(skeleton).ops == profiling._stencil_set_ops(frame)
    wrap = profiling.WRAP + profiling.LIBM["fmodf"]
    wrapped = _stencil({"op": "wrap", "cell": [3.0, 3.0, 3.0], "child": sphere})
    assert wrapped.ops == pytest.approx(15 * wrap + _stencil(sphere).ops)
    moved = _stencil({"op": "transform", "offset": [0.0, 1.0, 0.0], "child": sphere})
    turned = _stencil({"op": "transform", "rotation": [0.9238795, 0.0, 0.0, 0.3826834],
                       "child": sphere})
    # x - offset, then per row a product of 5, its zeros' sum, and the two
    # adds of 5 (z's first add, 0*x + 0*y, is a constant)
    assert moved.ops == 3 * 5 + (15 + 15 + 10) + _stencil(sphere).ops
    assert turned.ops > 12 * profiling.PROGRAM_FORWARD[tcsdf.OP_SPHERE]


# ---------------------------------------------------------------------------
# the render: K1, K2 + K3 (their plain twins)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_trace_and_render_match_jax_xla(name):
    """K2's twin without the cull, K1's with it (where the scene has
    bounds), and the row pipeline (K2, K2 resumed, K3) against the JAX
    package's XLA trace and render at 64x36."""
    _assert_trace_and_render(name)


@pytest.mark.parametrize("name", sorted(LARGE_SPECS))
def test_render_beyond_the_small_tier_matches_jax(name):
    """The specs beyond the small tier's caps (tests/test_torch_mesh.py
    LARGE_SPECS: 79 instructions, 10 nested frames, 18 stack values), which
    raised before, through the large tier's twins against the JAX package's
    XLA trace and render, by test_trace_and_render_match_jax_xla's bars."""
    assert tcsdf.kernel_structure(_desc(name)) == tcsdf.COMPOSED_LARGE
    _assert_trace_and_render(name)


def _assert_trace_and_render(name):
    (jo, jd, jc), rays = _rays(64, 36)
    jscene, _ = _pair(name)
    ref = jtrace.sphere_trace(jscene.bind(), jo, jd, jc)
    ref_outcome, ref_steps = np.asarray(ref.outcome), np.asarray(ref.steps)
    desc = _desc(name)
    depth, steps, outcome = (t.numpy() for t in trace_cuda(desc, *rays, use_bb_skip=False))
    np.testing.assert_array_equal(outcome, ref_outcome)
    assert np.mean(steps == ref_steps) >= STEP_SHARE
    hit = outcome == COLLISION
    assert hit.sum() > 50
    # depth within 1e-4 at the reference scene's depths (<= 10), 1e-5
    # relative beyond, where the ground's plane is hit at grazing angles
    same = hit & (steps == ref_steps)
    ref_depth = np.asarray(ref.depth)[same]
    assert (np.abs(depth[same] - ref_depth) <= 1e-5 * np.maximum(ref_depth, 10.0)).all()
    image = np.asarray(jshade.render_image(jscene.bind(), jo, jd, jc))
    for two_phase in (False, True):
        rgb, _, _, culled = (t.numpy() for t in render_image_cuda(desc, *rays, return_planes=True,
                                                                 two_phase=two_phase))
        np.testing.assert_array_equal(culled, ref_outcome)
        assert_image_bars(rgb, image)


def test_render_matches_render_image_pallas():
    """K1's twin against the JAX package's fused Pallas kernel in interpret
    mode on the gadget at 48x32, both culled by its bounds."""
    (jo, jd, jc), rays = _rays(48, 32)
    jscene, _ = _pair("gadget")
    csdf, bb = compile_scene_csdf(jscene), jcsdf.scene_bounds(jscene)
    image = np.asarray(render_image_pallas(csdf, jo, jd, jc, bb=bb, interpret=True))
    planes = [np.asarray(x) for x in trace_pallas(csdf, jo, jd, jc, bb=bb, use_bb_skip=True,
                                                  interpret=True)]
    rgb, depth, steps, outcome = (t.numpy() for t in render_image_cuda(_desc("gadget"), *rays,
                                                                       return_planes=True))
    np.testing.assert_array_equal(outcome, planes[2])
    both = outcome == COLLISION
    assert both.sum() > 20
    equal_steps = steps == planes[1]
    assert equal_steps.mean() >= STEP_SHARE
    assert np.abs(depth - planes[0])[both & equal_steps].max() <= 1e-4
    assert_image_bars(rgb, image)


# ---------------------------------------------------------------------------
# the mesh: refine, K6 and K7 (their plain twins)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", EXAMPLES)
def test_refine_survivor_sets_equal_jax(name):
    jscene, _ = _pair(name)
    csdf, cfg = compile_scene_csdf(jscene), JaxMeshGenConfig(init_factor=8)
    ref = jax_create_field(cfg)
    desc = _desc(name)
    got = create_voxel_field(MeshGenConfig(init_factor=8), "cpu")
    for _ in range(2):
        ref = jax_refine_field(jscene.bind(), ref, cfg, csdf=csdf)
        got = refine_field(desc, got)
        assert got.count == ref.count > 0 and got.voxel_size == ref.voxel_size
        np.testing.assert_array_equal(_sorted_rows(got.to_numpy()), _sorted_rows(ref.to_numpy()))


MESH_VARIANTS = {
    "grad": {},
    "fd4": dict(projection_normals="fd4"),
    "interpolate edges": dict(interpolate_edges=True),
}


@pytest.mark.parametrize("variant", sorted(MESH_VARIANTS))
@pytest.mark.parametrize("name", EXAMPLES)
def test_mesh_matches_jax_generate_mesh(name, variant):
    """Init factor 8, two refines (level 2): the JAX package's
    ``generate_mesh`` and the port's (K6's twin, K7's with interpolated
    edges) as sets of triangles: the same count, each triangle's corners
    within 2e-5 of one of JAX's, one to one, in the same winding. (Held as
    triangles, not welded vertices: at level 2 a few of the snowman's
    interpolated vertices fall one float32 step apart across the weld's
    1e-5 quantization, XLA contracting FMAs, so the welded counts may
    differ by a pair; ``test_cli_mesh_of_a_spec_matches_jax`` holds the
    welded mesh at level 1.) A box has a NaN gradient inside it in both
    packages (the mushroom's cylinder on its axis), and reverse mode
    carries it to points where the box is not the minimum: the gadget's
    "grad" meshes are mostly NaN vertices, in both; the triangles with a
    NaN corner are as many in both, and the rest are held as above."""
    options = MESH_VARIANTS[variant]
    jscene, _ = _pair(name)
    ref = jax_generate_mesh(jscene.bind(), 2, JaxMeshGenConfig(init_factor=8, **options),
                            csdf=compile_scene_csdf(jscene))
    got = generate_mesh(_desc(name), 2, MeshGenConfig(init_factor=8, **options), device="cpu")
    assert got.triangle_count == ref.triangle_count > 50
    corners = got.vertices[got.faces.astype(np.int64)]
    ref_corners = np.asarray(ref.vertices)[np.asarray(ref.faces).astype(np.int64)]
    nan, ref_nan = (np.isnan(c).any(axis=(1, 2)) for c in (corners, ref_corners))
    assert nan.sum() == ref_nan.sum()
    assert not ref_nan.any() or variant != "fd4"
    if name == "gadget" and variant == "grad":
        assert ref_nan.mean() > 0.5
    assert_same_triangles(corners[~nan], ref_corners[~ref_nan])


def assert_same_triangles(corners, ref_corners, atol=2e-5):
    """``(T, 3, 3)`` triangle corners: matched one to one by centroid, each
    pair's corners within ``atol`` under one of the three rotations (the
    same winding)."""
    assert corners.shape == ref_corners.shape
    dist, match = cKDTree(ref_corners.mean(axis=1)).query(corners.mean(axis=1))
    assert dist.max() <= atol, dist.max()
    assert len(set(match.tolist())) == len(corners)
    err = np.min([np.abs(corners - np.roll(ref_corners[match], r, axis=1)).max(axis=(1, 2))
                  for r in range(3)], axis=0)
    assert err.max() <= atol, err.max()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _spec_path(name):
    return str(ROOT / "examples" / f"{name}.json")


@pytest.mark.parametrize("scene", ["snowman", "spec:mushroom"])
def test_cli_render_of_a_spec(scene, tmp_path):
    name = scene.removeprefix("spec:")
    arg = f"spec:{_spec_path(name)}" if scene.startswith("spec:") else _spec_path(name)
    out = tmp_path / "frame.npy"
    assert cli.main(["render", "--device", "cpu", "--scene", arg, "--width", "32", "--height", "18",
                     "-o", str(out)]) == 0
    img = np.load(out)
    assert img.shape == (18, 32, 3) and np.isfinite(img).all()
    (jo, jd, jc), rays = _rays(32, 18)
    assert_image_bars(img, np.asarray(jshade.render_image(_pair(name)[0].bind(), jo, jd, jc)))


@pytest.mark.parametrize("name", ["deep", "nested"])
def test_cli_render_beyond_the_small_tier_matches_jax(name, tmp_path):
    """``cli render --device cpu`` of the 40-sphere union and of the ten
    nested transforms (tests/test_torch_mesh.py LARGE_SPECS), which raised
    before, against JAX's render of the spec."""
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(LARGE_SPECS[name]))
    out = tmp_path / "frame.npy"
    assert cli.main(["render", "--device", "cpu", "--scene", str(path), "--width", "64",
                     "--height", "36", "-o", str(out)]) == 0
    img = np.load(out)
    (jo, jd, jc), _ = _rays(64, 36)
    ref = np.asarray(jshade.render_image(_pair(name)[0].bind(), jo, jd, jc))
    assert (np.abs(ref - ref[0, 0]).max(-1) > 1e-3).sum() > 50  # the object is in the frame
    assert_image_bars(img, ref)


@pytest.mark.parametrize("interpolate", [False, True], ids=["midpoints", "interpolate-edges"])
def test_cli_mesh_of_a_spec_matches_jax(tmp_path, interpolate):
    out = tmp_path / "snowman.obj"
    extra = ["--interpolate-edges"] if interpolate else []
    assert cli.main(["mesh", "--device", "cpu", "--scene", _spec_path("snowman"), "--init-factor",
                     "8", "--refine", "1", "-o", str(out), *extra]) == 0
    jscene, _ = _pair("snowman")
    ref = jax_generate_mesh(jscene.bind(), 1,
                            JaxMeshGenConfig(init_factor=8, interpolate_edges=interpolate),
                            csdf=compile_scene_csdf(jscene))
    mesh = load_obj(out)
    assert out.read_text().startswith("# bsdmg_tpu generated mesh (native writer)\n")
    assert_same_mesh(mesh.vertices, mesh.faces.astype(np.int64), ref.vertices,
                     np.asarray(ref.faces).astype(np.int64), atol=1e-4)


def test_cli_session_of_a_spec(tmp_path, caplog):
    out = tmp_path / "session.obj"
    with caplog.at_level(logging.INFO, logger="bsdmg_tpu_torch"):
        assert cli.main(["session", "--device", "cpu", "--scene", f"spec:{_spec_path('snowman')}",
                         "--init-factor", "8", "--keys", "vbvv", "-o", str(out)]) == 0
    mesh = load_obj(out)
    assert mesh.triangle_count > 50 and np.isfinite(mesh.vertices).all()
    assert any(r.getMessage().startswith("final stage") for r in caplog.records)


def _log_lines(caplog, logger):
    return [r.getMessage() for r in caplog.records if r.name == logger]


def _fit_values(lines):
    """The recovered values and the last logged loss of a fit's log."""
    last = [m for m in lines if m.startswith("step ")][-1]
    loss = float(last.split("loss=")[1].split()[0])
    recovered = lines[-1].split("recovered ")[1].split(" (true")[0]
    values = [float(v) for v in re.findall(r"-?\d+\.\d+(?:e-?\d+)?", recovered)]
    return np.asarray(values), loss


FITS = {"snowman": ["--scene", _spec_path("snowman"), "--perturb", "n1_radius=1.2"]}


@pytest.mark.parametrize("name", sorted(FITS))
def test_cli_depth_fit_of_a_spec_matches_jax(name, caplog):
    """The depth fit at 32x32 and 11 steps against JAX's ``cmd_fit``: the
    recovered value within 1e-3 and the last loss within 10% relative (the
    mask of the rays both packages' marches hit, and their float32 sums,
    differ in rounding)."""
    argv = ["fit", *FITS[name], "--width", "32", "--height", "32", "--steps", "11"]
    with caplog.at_level(logging.INFO):
        assert cli.main([*argv, "--device", "cpu"]) == 0
        ours = _fit_values(_log_lines(caplog, "bsdmg_tpu_torch"))
        caplog.clear()
        jax_cli.main(argv)
        ref = _fit_values(_log_lines(caplog, "bsdmg"))
    np.testing.assert_allclose(ours[0], ref[0], atol=1e-3, rtol=0)
    assert abs(ours[1] - ref[1]) <= 0.1 * abs(ref[1])


def _first_loss(lines):
    return float([m for m in lines if m.startswith("step ")][0].split("loss=")[1].split()[0])


def assert_image_fit_matches_jax(argv, caplog, size=(32, 24), steps=6, diverges=False):
    """``fit --image`` of the port on the CPU (K4's and K5's twins) and
    JAX's ``cmd_fit`` on the same argv at ``size`` for ``steps`` steps: the
    recovered values within 1e-3 and the last loss within 10% relative,
    the bars of the depth fits. A fit that ``diverges`` in both packages
    (its loss rises) parts them in the loss faster than in the values, the
    two float32 gradients differing in rounding (XLA contracts
    multiply-adds): there the first step's loss is held to a relative 1e-4
    and the last losses must both have risen."""
    argv = ["fit", "--image", *argv, "--width", str(size[0]), "--height", str(size[1]),
            "--steps", str(steps)]
    with caplog.at_level(logging.INFO):
        assert cli.main([*argv, "--device", "cpu"]) == 0
        lines = _log_lines(caplog, "bsdmg_tpu_torch")
        ours = _fit_values(lines) + (_first_loss(lines),)
        caplog.clear()
        jax_cli.main(argv)
        lines = _log_lines(caplog, "bsdmg")
        ref = _fit_values(lines) + (_first_loss(lines),)
    assert np.isfinite(ref[0]).all() and np.isfinite(ref[1])
    np.testing.assert_allclose(ours[0], ref[0], atol=1e-3, rtol=0)
    if diverges:
        assert abs(ours[2] - ref[2]) <= 1e-4 * abs(ref[2])
        assert ours[1] > ours[2] and ref[1] > ref[2]
    else:
        assert abs(ours[1] - ref[1]) <= 0.1 * abs(ref[1])
    return ours, ref


def test_cli_fit_image_of_a_spec_raises(caplog):
    """The image fit of a spec, which raised before kernels K4 and K5 took
    a parameter program, against JAX's: the mushroom's (a plane, a sphere
    and a cylinder under a smooth union); the snowman's is
    tests/test_torch_slice.py's."""
    assert_image_fit_matches_jax(["--scene", _spec_path("mushroom"), "--perturb", "n3_radius=1.2"],
                                 caplog)
