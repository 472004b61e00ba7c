"""Kernels K4 and K5 on the scenes beside the reference ones: the sphere, the
mandelbulb, the wrapped object and composed specs
(bsdmg_tpu_torch/ops/cuda/diff_kernel.py, csrc/param_forms.cuh).

The kernels need nvcc and a card; chip_smoke.py holds them against their
plain versions there. Here the plain versions, on each scene's component
form, are held against the JAX package on the same rays (32x16 from the CLI
camera) and parameters:

* K4's twin against ``march_params_pallas`` in interpret mode, with
  ``track_min`` and the trust-region bounds where the scene has bounds:
  every outcome equal; steps equal on all rays but at most one (XLA's CPU
  compiler contracts multiply-adds, PyTorch does not); where they agree the
  depth (to 1e-5, or a relative 1e-6 for the wrapped object's far hits) and
  ``dfdt`` of the hits within 1e-5 (tests/test_torch_diff_kernel.py), and
  ``min_m`` and ``t_min`` on all those rays but at most one (the wrapped
  object's march runs to depth 50 and more);
* K5's twin against ``render_loss_grad_pallas`` in interpret mode, without
  the edge term against a seed-1 random target and with it (weight 1)
  against the render at the true parameters: the loss to a relative 1e-4,
  every gradient at rtol 1e-3, atol 1e-5 (tests/test_grad.py:268-301).
  TURNED puts a quaternion transform (as the gadget's) over a snowman, and
  its case perturbs the quaternion; the wrapped object's case perturbs its
  cell, so those gradients are held where they are not small. JAX's Pallas
  kernel gives a NaN loss on the wrapped object (interpret mode, every ray
  a hit), so the wrapped object's K5 is held against JAX's XLA
  ``render_loss_and_grad``, as is the mandelbulb's, whose libm calls round
  differently in the two packages: at 16x12 from (2, 1, -2) its K4 has
  every outcome equal and 99% of the depths within 1e-5, and its K5 the
  loss within a relative 1e-2 and the scale's gradient within a relative
  5e-2;
* the gadget, where the two packages part: a hit on its box minus sphere
  lies inside the box, whose outside distance is ``sqrt(0)``; JAX's JVP and
  VJP of the max above it multiply the infinite weight by 0, so JAX's
  ``dfdt`` there, and its image loss and gradient, are NaN (its ``cli fit
  --image`` of the gadget recovers NaN), where the port's twins (torch's
  max and where select in their backward) and kernels (csrc/nested_dual.cuh
  psqrt) stay finite. Its K4 is held where JAX's ``dfdt`` is finite;
* the parameter program (``csdf.py::param_program``) evaluated in plain
  PyTorch against the spec's component form on random points: bit for bit.
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsdmg_tpu.cam import generate_rays, look_at
from bsdmg_tpu.grad import render_loss_and_grad as jax_render_loss_and_grad
from bsdmg_tpu.models import get_scene as jax_get_scene
from bsdmg_tpu.models.compose import compose_scene as jax_compose_scene
from bsdmg_tpu.ops.pallas.csdf import scene_bounds as jax_scene_bounds
from bsdmg_tpu.ops.pallas.diff_kernel import march_params_pallas, render_loss_grad_pallas
from bsdmg_tpu_torch.models import get_scene
from bsdmg_tpu_torch.models.compose import compose_scene
from bsdmg_tpu_torch.ops.cuda import csdf as tcsdf
from bsdmg_tpu_torch.ops.cuda import diff_kernel as dk
from bsdmg_tpu_torch.ops.cuda.csdf import scene_bounds
from bsdmg_tpu_torch.sdf.primitives import mod
from bsdmg_tpu_torch.weights import flatten_params, param_offsets, params_from_numpy
from test_torch_compose import SPECS

# one intra-op thread, as tests/test_torch_diff_kernel.py
torch.set_num_threads(1)

SIZE = (32, 16)
BULB_SIZE = (16, 12)
BULB_CAMERA = (2.0, 1.0, -2.0)
GRAD_RTOL, GRAD_ATOL, LOSS_RTOL = 1e-3, 1e-5, 1e-4


#: a quaternion transform over a snowman-like smooth union
TURNED = {"name": "turned", "root": {
    "op": "transform", "offset": [0.1, 0.2, 0.0], "rotation": [0.9238795, 0.0, 0.2, 0.3826834],
    "child": {"op": "smooth_union", "k": 0.3, "children": [
        {"prim": "sphere", "radius": 0.8},
        {"prim": "sphere", "center": [0.0, 1.0, 0.0], "radius": 0.5},
        {"prim": "capsule", "start": [0.0, 1.0, 0.0], "end": [0.6, 1.2, 0.0], "radius": 0.1}]}}}


def _spec_scenes(name):
    spec = TURNED if name == "turned" else SPECS[name]
    return jax_compose_scene(copy.deepcopy(spec)), compose_scene(copy.deepcopy(spec), device="cpu")


def _scenes(name):
    """The JAX package's scene and the port's."""
    if name in ("sphere", "mandelbulb", "wrapped_object"):
        return jax_get_scene(name), get_scene(name, device="cpu")
    return _spec_scenes(name)


#: each case: the scene, and the factors on its parameters
CASES = {
    "sphere": ("sphere", {"radius": 1.15}),
    "wrapped_object": ("wrapped_object", {"sphere_radius": 1.15}),
    "wrapped_object cell": ("wrapped_object", {"cell": 1.05}),
    "gadget": ("gadget", {"n3_radius": 1.2}),
    "turned": ("turned", {"n0_rotation": (1.0, 1.0, 1.0, 1.3)}),
    "snowman": ("snowman", {"n1_radius": 1.2}),
    "lattice": ("lattice", {"n2_minor_radius": 1.2}),
    "lattice cell": ("lattice", {"n0_cell": 1.05, "n2_minor_radius": 1.2}),
    "ground": ("ground", {"n5_radius": 1.1, "n1_normal": (1.0, 1.0, 2.0), "n1_offset": 1.1}),
}
#: the ground's rows from this one on, where JAX's loss and gradient are
#: finite (row 4 of the frame makes them NaN)
GROUND_ROW = 5


def _rays(size, camera=(5.0, 2.0, -5.0)):
    o, d, c = generate_rays(look_at(camera, fov=math.pi / 4), size, (1920.0, 1080.0))
    return (o, d, c), tuple(torch.from_numpy(np.array(a)) for a in (o, d, c))


def _bounds(jscene, scene):
    b = jax_scene_bounds(jscene)
    if b is None:
        assert scene_bounds(scene) is None
        return None
    lo, hi, slack = b
    bb = (tuple(v - 0.6 for v in lo), tuple(v + 0.6 for v in hi), slack)
    ours = scene_bounds(scene)
    assert ours is not None
    np.testing.assert_allclose(np.asarray(ours[0]) - 0.6, bb[0], atol=1e-6)
    return bb


def _point(jscene, factors):
    return {k: jnp.asarray(np.asarray(v) * np.asarray(factors.get(k, 1.0), np.float32),
                           jnp.float32) for k, v in jscene.params.items()}


def _torch_params(jp):
    return params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")


def _target(scene, params, rays, bb):
    """The port's render at ``params`` (the twin), the edge cases' target."""
    from bsdmg_tpu_torch.grad import render_image_diff

    return render_image_diff(scene.sdf, params, *rays, csdf=scene.csdf, bb=bb).detach()


@pytest.mark.parametrize("case", ["sphere", "wrapped_object", "gadget", "lattice"])
def test_march_twin_matches_pallas(case):
    name, factors = CASES[case]
    jscene, scene = _scenes(name)
    bb = _bounds(jscene, scene)
    (o, d, c), rays = _rays(SIZE)
    jp = _point(jscene, factors)
    ref = [np.asarray(x) for x in march_params_pallas(
        jscene.csdf, jp, o, d, c, bb=bb, interpret=True, track_min=True)]
    got = [x.numpy() for x in dk.march_params_torch(scene.csdf, _torch_params(jp), *rays, bb=bb,
                                                    track_min=True)]
    np.testing.assert_array_equal(got[2], ref[2])
    same = got[1] == ref[1]
    assert (~same).sum() <= 1, f"{(~same).sum()} rays with other step counts"
    hit = same & (ref[2] == 0)
    assert hit.any() and np.isfinite(got[3]).all()
    np.testing.assert_allclose(got[0][hit], ref[0][hit], rtol=1e-6, atol=1e-5)
    finite = hit & np.isfinite(ref[3])
    assert finite.sum() >= (0.99 if name == "gadget" else 1.0) * hit.sum()
    np.testing.assert_allclose(got[3][finite], ref[3][finite], atol=1e-5)
    for i in (4, 5):  # min_m, t_min
        off = np.abs(got[i][same] - ref[i][same]) > 1e-5 + 1e-6 * np.abs(ref[i][same])
        assert off.sum() <= 1, f"{off.sum()} rays with other closest approaches"


def _assert_loss_grad(loss, grads, ref_loss, ref_grads):
    assert np.isfinite(float(ref_loss))
    assert float(loss) == pytest.approx(float(ref_loss), rel=LOSS_RTOL)
    assert sorted(grads) == sorted(ref_grads)
    for k in ref_grads:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(ref_grads[k]), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("edge", [0.0, 1.0], ids=["photometric", "edge"])
@pytest.mark.parametrize("case", ["sphere", "turned", "snowman"])
def test_loss_grad_twin_matches_pallas(case, edge):
    name, factors = CASES[case]
    jscene, scene = _scenes(name)
    bb = _bounds(jscene, scene)
    (o, d, c), rays = _rays(SIZE)
    jp = _point(jscene, factors)
    if edge:
        target = _target(scene, scene.params, rays, bb)
    else:
        target = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (16, 32, 3))
                                  .astype(np.float32))
    ref_loss, ref_g = render_loss_grad_pallas(jscene.csdf, jp, jnp.asarray(target.numpy()), o, d,
                                              c, bb=bb, interpret=True, edge_weight=edge)
    loss, g = dk.render_loss_grad_torch(scene.csdf, _torch_params(jp), target, *rays, bb=bb,
                                        edge_weight=edge)
    _assert_loss_grad(loss, g, ref_loss, ref_g)


def test_gadget_loss_grad_is_finite_where_jax_is_nan():
    """The gadget (module docstring): JAX's fused loss is NaN, the twin's
    loss and every gradient finite."""
    name, factors = CASES["gadget"]
    jscene, scene = _scenes(name)
    bb = _bounds(jscene, scene)
    (o, d, c), rays = _rays(SIZE)
    jp = _point(jscene, factors)
    target = _target(scene, scene.params, rays, bb)
    ref_loss, _ = render_loss_grad_pallas(jscene.csdf, jp, jnp.asarray(target.numpy()), o, d, c,
                                          bb=bb, interpret=True, edge_weight=1.0)
    loss, g = dk.render_loss_grad_torch(scene.csdf, _torch_params(jp), target, *rays, bb=bb,
                                        edge_weight=1.0)
    assert np.isnan(float(ref_loss))
    assert torch.isfinite(loss) and all(torch.isfinite(v).all() for v in g.values())
    assert float(g["n3_radius"]) != 0.0


def test_deep_spec_loss_grad_twin_matches_xla():
    """``fit --image`` of the 40-sphere union (tests/test_torch_mesh.py
    LARGE_SPECS["deep"]), 160 parameter values, which K4 and K5 took in no
    form before: the kernels' large tier (``param_scene_c`` picks it), its
    K5 twin against JAX's XLA loss and gradient, three radii and a centre
    perturbed, against a seed-1 random target."""
    from test_torch_mesh import LARGE_SPECS

    jscene = jax_compose_scene(copy.deepcopy(LARGE_SPECS["deep"]))
    scene = compose_scene(copy.deepcopy(LARGE_SPECS["deep"]), device="cpu")
    bb = _bounds(jscene, scene)
    (o, d, c), rays = _rays(SIZE)
    jp = _point(jscene, {"n3_radius": 1.2, "n17_radius": 0.8, "n30_radius": 1.1,
                         "n22_center": (1.05, 0.95, 1.0)})
    p = _torch_params(jp)
    scene_c, layout = dk.param_scene_c(scene.csdf, p, bb=bb, device="cpu")
    assert (scene_c.form, scene_c.n_prm) == (dk.FORM_PROGRAM_LARGE, 160)
    assert scene_c.program_length == 79
    target = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (16, 32, 3))
                              .astype(np.float32))
    ref_loss, ref_g = jax_render_loss_and_grad(jscene.sdf, jp, jnp.asarray(target.numpy()), o, d,
                                               c, csdf=jscene.csdf, bb=bb)
    loss, g = dk.render_loss_grad_torch(scene.csdf, p, target, *rays, bb=bb)
    _assert_loss_grad(loss, g, ref_loss, ref_g)
    flat, _ = flatten_params(g)
    assert (flat.abs() > 1e-4).sum() >= 40  # the gradient reaches many of the 160 values


@pytest.mark.parametrize("case", ["wrapped_object", "wrapped_object cell", "lattice cell"])
def test_wrapped_loss_grad_twin_matches_xla(case):
    """The K5 twin of a scene under a wrap (the wrapped object, the lattice
    spec), edge term on, against JAX's XLA render (the cell's gradient goes
    through jnp.mod: sdf/primitives.py mod). JAX's Pallas kernel gives
    another loss on both in interpret mode (NaN on the wrapped object)."""
    name, factors = CASES[case]
    jscene, scene = _scenes(name)
    (o, d, c), rays = _rays(SIZE)
    jp = _point(jscene, factors)
    target = _target(scene, scene.params, rays, None)
    ref_loss, ref_g = jax_render_loss_and_grad(jscene.sdf, jp, jnp.asarray(target.numpy()), o, d,
                                               c, csdf=jscene.csdf, edge_weight=1.0)
    loss, g = dk.render_loss_grad_torch(scene.csdf, _torch_params(jp), target, *rays,
                                        edge_weight=1.0)
    _assert_loss_grad(loss, g, ref_loss, ref_g)
    cell = "cell" if name == "wrapped_object" else "n0_cell"
    assert g[cell].abs().max() > 1e-4


@pytest.mark.parametrize("edge", [0.0, 1.0], ids=["photometric", "edge"])
def test_ground_loss_grad_twin_matches_xla(edge):
    """The ground spec (a root union with a plane, no cull), its sphere's
    radius and its plane's normal and offset perturbed: the K5 twin against
    JAX's XLA render on the frame's rows from GROUND_ROW on, where JAX's is
    finite; the plane's normal carries a gradient."""
    name, factors = CASES["ground"]
    jscene, scene = _scenes(name)
    (o, d, c), rays = _rays(SIZE)
    jp = _point(jscene, factors)
    if edge:
        target = _target(scene, scene.params, rays, None)
    else:
        target = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (16, 32, 3))
                                  .astype(np.float32))
    rows = slice(GROUND_ROW, None)
    ref_loss, ref_g = jax_render_loss_and_grad(
        jscene.sdf, jp, jnp.asarray(target.numpy()[rows]), o[rows], d[rows], c[rows],
        csdf=jscene.csdf, edge_weight=edge)
    loss, g = dk.render_loss_grad_torch(scene.csdf, _torch_params(jp), target[rows],
                                        *(r[rows] for r in rays), edge_weight=edge)
    _assert_loss_grad(loss, g, ref_loss, ref_g)
    assert g["n1_normal"].abs().max() > 1e-3


def test_mandelbulb_twins_match_jax():
    """The mandelbulb by its bars (module docstring): K4's twin against
    ``march_params_pallas``, K5's against JAX's XLA render."""
    jscene, scene = _scenes("mandelbulb")
    jp = _point(jscene, {"scale": 1.1})
    (o, d, c), rays = _rays(BULB_SIZE, BULB_CAMERA)
    bb = _bounds(jscene, scene)
    ref = [np.asarray(x) for x in march_params_pallas(jscene.csdf, jp, o, d, c, bb=bb,
                                                      interpret=True)]
    got = [x.numpy() for x in dk.march_params_torch(scene.csdf, _torch_params(jp), *rays, bb=bb)]
    np.testing.assert_array_equal(got[2], ref[2])
    hit = ref[2] == 0
    assert hit.sum() > 20
    assert (np.abs(got[0][hit] - ref[0][hit]) <= 1e-5).mean() >= 0.99
    target = _target(scene, scene.params, rays, bb)
    ref_loss, ref_g = jax_render_loss_and_grad(jscene.sdf, jp, jnp.asarray(target.numpy()), o, d,
                                               c, csdf=jscene.csdf, bb=bb, edge_weight=1.0)
    loss, g = dk.render_loss_grad_torch(scene.csdf, _torch_params(jp), target, *rays, bb=bb,
                                        edge_weight=1.0)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-2)
    assert float(g["scale"]) == pytest.approx(float(ref_g["scale"]), rel=5e-2)


@pytest.mark.parametrize("name", ["gadget", "mushroom", "snowman", "ground", "lattice"])
def test_param_program_matches_component_form(name):
    """The parameter program evaluated as the kernels' interpreter runs it
    equals the spec's component form (models/compose.py _eval) bit for bit,
    NaN where it is NaN."""
    _, scene = _spec_scenes(name)
    flat, layout = flatten_params(scene.params)
    prog = tcsdf.param_program(scene.spec, param_offsets(layout))
    assert [ins.op for ins in prog] == [ins.op for ins in tcsdf.node_program(scene, scene.params)]
    x, y, z = (torch.from_numpy(v) for v in
               np.random.default_rng(7).uniform(-3, 3, (3, 4096)).astype(np.float32))
    got = tcsdf.param_program_csdf(prog)(flat, x, y, z)
    want = scene.csdf(scene.params, x, y, z)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got[~torch.isnan(want)], want[~torch.isnan(want)])


def test_param_program_words_name_each_field_slot():
    _, scene = _spec_scenes("snowman")
    flat, layout = flatten_params(scene.params)
    prog = tcsdf.param_program(scene.spec, param_offsets(layout))
    words = tcsdf.param_program_words(prog)
    assert words.shape == (len(prog), tcsdf.PARAM_WORDS) and words.dtype == np.int32
    names = [n for n, _ in layout]
    offsets = np.cumsum([0] + [int(np.prod(s)) if s else 1 for _, s in layout])
    # the snowman: smooth_union(n0) of spheres n1, n2 and capsule n3
    first = {n: int(offsets[i]) for i, n in enumerate(names)}
    assert words[0, 0] == tcsdf.OP_SPHERE and list(words[0, 2:4]) == [first["n1_center"],
                                                                       first["n1_radius"]]
    assert words[3, 0] == tcsdf.OP_CAPSULE and list(words[3, 2:5]) == [
        first["n3_start"], first["n3_end"], first["n3_radius"]]
    assert words[2, 0] == tcsdf.OP_SMOOTH and words[2, 1] == 0 and words[2, 2] == first["n0_k"]


def test_param_scene_forms():
    """param_scene_c picks each scene's form and fills the flat vector;
    another component form, a form's missing parameter, or more values
    than a fixed form takes raise; a composed scene beyond 64 values takes
    the large tier."""
    forms = {"sphere": dk.FORM_SPHERE, "mandelbulb": dk.FORM_MANDELBULB,
             "wrapped_object": dk.FORM_WRAPPED, "reference_render_scene": dk.FORM_REFERENCE}
    for name, form in forms.items():
        scene = get_scene(name, device="cpu")
        sc, layout = dk.param_scene_c(scene.csdf, scene.params, device="cpu")
        flat, _ = flatten_params(scene.params)
        assert sc.form == form and sc.n_prm == flat.numel()
        assert list(sc.prm)[:sc.n_prm] == flat.tolist()
    wrapped = get_scene("wrapped_object", device="cpu")
    sc, layout = dk.param_scene_c(wrapped.csdf, wrapped.params, device="cpu")
    assert sc.cell == [n for n, _ in layout].index("cell") and sc.has_frame == 0
    _, gadget = _spec_scenes("gadget")
    sc, _ = dk.param_scene_c(gadget.csdf, gadget.params, device="cpu")
    assert sc.form == dk.FORM_PROGRAM and sc.program_length == 10 and sc.program
    with pytest.raises(NotImplementedError):
        dk.param_scene_c(gadget.sdf, gadget.params, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        dk.param_scene_c(gadget.csdf, {k: v for k, v in gadget.params.items() if k != "n3_radius"},
                         device="cpu")
    sphere = get_scene("sphere", device="cpu")
    with pytest.raises(ValueError, match="radius"):
        dk.param_scene_c(sphere.csdf, {"r": sphere.params["radius"]}, device="cpu")
    many = {f"p{i:02d}": torch.zeros(3) for i in range(22)}
    with pytest.raises(ValueError, match="at most 64"):
        dk.param_scene_c(wrapped.csdf, {**wrapped.params, **many}, device="cpu")
    sc, _ = dk.param_scene_c(gadget.csdf, {**gadget.params, **many}, device="cpu")
    assert sc.form == dk.FORM_PROGRAM_LARGE and sc.n_prm > 64 and sc.prm_values


@pytest.mark.parametrize("x", [7.5, -7.5, 23.999998, -16.000002, 4.0, 0.0])
def test_mod_follows_jax(x):
    """sdf/primitives.py mod: jnp.mod's value and JAX's derivatives, also
    where the quotient rounds onto an integer."""
    y = 8.0
    want = jax.grad(lambda a, b: jnp.mod(a, b), argnums=(0, 1))(jnp.float32(x), jnp.float32(y))
    a = torch.tensor(x, requires_grad=True)
    b = torch.tensor(y, requires_grad=True)
    out = mod(a, b)
    assert out.item() == float(jnp.mod(jnp.float32(x), jnp.float32(y)))
    ga, gb = torch.autograd.grad(out, (a, b))
    assert ga.item() == float(want[0]) and gb.item() == float(want[1])
