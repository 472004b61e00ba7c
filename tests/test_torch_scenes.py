"""The four other built-in scenes (sphere, box, mandelbulb, wrapped_object)
through the port against the JAX package, on numpy-seeded inputs.

* sphere, box and wrapped_object: the plain twins of K1, K2 + K3, K6 and
  K7 against the JAX package's XLA path (and, at one small size, its Pallas
  kernel in interpret mode): outcomes equal on every pixel, steps on
  >= 99.7% of rays (XLA contracts multiply-adds into FMAs, PyTorch does
  not), hit depth within 1e-4 where the steps agree (1e-5 relative past
  depth 10, which only the wrapped object's far copies reach) and the
  image within the reference scene's bars; refine survivor sets equal as sorted rows; meshes equal as
  canonical face sets. The box's analytic gradient is NaN inside it, in
  both packages, so its mesh under ``projection_normals="grad"`` has NaN
  vertices in both, at the same places; its fd4 mesh is compared whole.
* mandelbulb: libm's acos, atan2 and pow round differently in XLA and in
  PyTorch in the last bits, and the distance estimator amplifies them near
  the escape boundary, so it is held by agreement fractions: the DE within
  1e-5 on >= 99.9% of 200,000 points in [-1.3, 1.3]^3 and its sign on
  >= 99.99%; the render's outcomes on >= 99.5% of pixels and depth within
  1e-4 on >= 99% of common hits; the mesh's triangle count within 1%. Far
  from the set the estimator overshoots (0.5 log(r) r / dr with dr = 1
  before the first step), so from the JAX bench's camera every ray misses,
  in both packages; these tests look from (2, 1, -2).
"""

import dataclasses
import json
import logging
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsdmg_tpu import cli as jax_cli
from bsdmg_tpu.cam import generate_rays, look_at
from bsdmg_tpu.config import MeshGenConfig as JaxMeshGenConfig
from bsdmg_tpu.mesh import create_voxel_field as jax_create_field
from bsdmg_tpu.mesh import generate_mesh as jax_generate_mesh
from bsdmg_tpu.mesh import refine_field as jax_refine_field
from bsdmg_tpu.models import get_scene as jax_get_scene
from bsdmg_tpu.ops import shade as jshade
from bsdmg_tpu.ops import trace as jtrace
from bsdmg_tpu.ops.pallas import compile_scene_csdf
from bsdmg_tpu.ops.pallas import csdf as jcsdf
from bsdmg_tpu.ops.pallas.render_kernel import render_image_pallas, trace_pallas
from bsdmg_tpu.sdf import primitives as jprim
from bsdmg_tpu_torch import cli
from bsdmg_tpu_torch.config import MeshGenConfig
from bsdmg_tpu_torch.mesh.export import load_obj
from bsdmg_tpu_torch.mesh.field import create_voxel_field, refine_field
from bsdmg_tpu_torch.mesh.pipeline import generate_mesh
from bsdmg_tpu_torch.models import get_scene
from bsdmg_tpu_torch.ops.cuda import csdf as tcsdf
from bsdmg_tpu_torch.ops.cuda import render_kernel
from bsdmg_tpu_torch.ops.cuda.render_kernel import render_image_cuda, trace_cuda
from bsdmg_tpu_torch.sdf import primitives as tprim
from bsdmg_tpu_torch.utils import profiling
from test_torch_compose import _fit_values, _log_lines, assert_image_fit_matches_jax
from test_torch_mesh import _sorted_rows, assert_same_mesh
from test_torch_render_kernel import assert_image_bars

torch.set_num_threads(1)

EXACT = ["box", "sphere", "wrapped_object"]
ALL = EXACT + ["mandelbulb"]
COLLISION = 0
STEP_SHARE = 0.997
HEADER = Path(tcsdf.__file__).resolve().parents[2] / "csrc" / "scene_sdf.cuh"


def _camera(name):
    return (2.0, 1.0, -2.0) if name == "mandelbulb" else (5.0, 2.0, -5.0)


def _rays(name, w, h):
    """JAX rays as numpy arrays, and the same as torch tensors."""
    rays = generate_rays(look_at(_camera(name), fov=np.pi / 4), (w, h), (1920.0, 1080.0))
    arrays = tuple(np.array(a) for a in rays)
    return arrays, tuple(torch.from_numpy(a) for a in arrays)


def _desc(name):
    return tcsdf.compile_scene(get_scene(name, device="cpu"))


def _points(seed, n, lim):
    return np.random.default_rng(seed).uniform(-lim, lim, (n, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# the scenes and their SDFs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ALL)
def test_scene_params_and_sdfs_match_jax(name):
    """The registry's scene: the JAX parameters, its point form and (but
    the box's, which the JAX package lacks too) its component form."""
    ref, got = jax_get_scene(name), get_scene(name, device="cpu")
    assert got.name == name and sorted(got.params) == sorted(ref.params)
    for k, v in ref.params.items():
        np.testing.assert_array_equal(got.params[k].numpy(), np.asarray(v))
    assert (got.csdf is None) == (ref.csdf is None) == (name == "box")
    p = _points(1, 4096, 10.0 if name == "wrapped_object" else 1.3)
    forms = [(got.sdf(got.params, torch.from_numpy(p)).numpy(), np.asarray(ref.sdf(ref.params, jnp.asarray(p))))]
    if ref.csdf is not None:
        cols = [p[:, a] for a in range(3)]
        forms.append((got.csdf(got.params, *map(torch.from_numpy, cols)).numpy(),
                       np.asarray(ref.csdf(ref.params, *map(jnp.asarray, cols)))))
    for ours, theirs in forms:
        close = np.abs(ours - theirs) <= 1e-5
        assert close.mean() >= (0.999 if name == "mandelbulb" else 1.0), close.mean()


def test_mandelbulb_distance_estimator_bars():
    """The scene's DE (scale 1: the points divided by 0.4, the distance
    multiplied) against JAX's ``sd_mandelbulb_c`` with exact trig, on
    200,000 points in [-1.3, 1.3]^3: |delta| <= 1e-5 on >= 99.9%, the sign
    on >= 99.99%; the primitive itself on the divided points, and the
    scene's descriptor, the kernels' twin, both within the same bars."""
    p = _points(1, 200_000, 1.3)
    s = float(jax_get_scene("mandelbulb").params["scale"]) * 0.4
    cols_t = [torch.from_numpy(p[:, a].copy()) for a in range(3)]
    cols_j = [jnp.asarray(p[:, a]) for a in range(3)]
    ref_de = np.asarray(jprim.sd_mandelbulb_c(*(c / s for c in cols_j)))
    got_de = tprim.sd_mandelbulb_c(*(c / s for c in cols_t)).numpy()
    ref = np.asarray(jprim.sd_mandelbulb_c(*(c / s for c in cols_j)) * s)
    got_scene = get_scene("mandelbulb", device="cpu")
    for ours, theirs in ((got_de * np.float32(s), ref_de * np.float32(s)),
                         (got_scene.csdf(got_scene.params, *cols_t).numpy(), ref),
                         (tcsdf.descriptor_csdf(_desc("mandelbulb"))(*cols_t).numpy(), ref)):
        assert np.mean(np.abs(ours - theirs) <= 1e-5) >= 0.999
        assert np.mean(np.sign(ours) == np.sign(theirs)) >= 0.9999


@pytest.mark.parametrize("name", ALL)
def test_scene_bounds_match_jax(name):
    ref = jcsdf.scene_bounds(jax_get_scene(name))
    assert tcsdf.scene_bounds(get_scene(name, device="cpu")) == ref
    assert _desc(name).bounds == ref
    assert (ref is None) == (name == "wrapped_object")


@pytest.mark.parametrize("name", ALL)
def test_descriptor_value_and_grad_match_jax_vjp(name):
    """The twins of the kernels' scene_sdf and scene_sdf_grad against the
    JAX compiler's SDF and ``jax.vjp`` of it (the mandelbulb's with exact
    trig): the values within 2e-5 (fractions for the mandelbulb), the
    sphere's, box's and wrapped object's gradients within 1e-5 with the
    same NaN (inside the box)."""
    p = _points(2, 20_000, 10.0 if name == "wrapped_object" else 1.3)
    p[:500] = np.round(p[:500] * 4.0) / 4.0  # lattice points: ties, the box's faces
    cols_t = [torch.from_numpy(p[:, a].copy()) for a in range(3)]
    cols_j = [jnp.asarray(p[:, a]) for a in range(3)]
    if name == "mandelbulb":
        s = float(jax_get_scene("mandelbulb").params["scale"]) * 0.4

        def jf(x, y, z):
            return jprim.sd_mandelbulb_c(x / s, y / s, z / s) * s
    else:
        jf = compile_scene_csdf(jax_get_scene(name))
    sd, vjp = jax.vjp(jf, *cols_j)
    ref = [np.asarray(sd), *(np.asarray(g) for g in vjp(jnp.ones_like(sd)))]
    desc = _desc(name)
    got = [t.numpy() for t in tcsdf.descriptor_csdf_value_and_grad(desc)(*cols_t)]
    np.testing.assert_array_equal(got[0], tcsdf.descriptor_csdf(desc)(*cols_t).numpy())
    if name == "mandelbulb":
        assert np.mean(np.abs(got[0] - ref[0]) <= 1e-5) >= 0.999
        for g, r in zip(got[1:], ref[1:]):
            assert np.mean(np.isclose(g, r, rtol=1e-3, atol=1e-4)) >= 0.99
        return
    np.testing.assert_allclose(got[0], ref[0], atol=2e-5, rtol=0)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
        np.testing.assert_allclose(g, r, atol=1e-5, rtol=0)
    if name == "box":
        assert np.isnan(got[1]).mean() > 0.01  # every point inside the box


def test_kernel_structures():
    """kernel_structure's indices for the new scenes, the header's
    with_structure cases (and with_mesh_structure's, a mesh asset's grid in
    its two forms) that name the same structures, and the fields of the
    descriptor the kernels read; the wrapped object moved by its object
    transform takes Wrapped<Box<false, true>>, a wrapped wireframe (which no
    scene builds) raises."""
    assert {n: tcsdf.kernel_structure(_desc(n)) for n in ALL} == {
        "sphere": tcsdf.SPHERE, "box": tcsdf.SOLID_BOX, "mandelbulb": tcsdf.MANDELBULB,
        "wrapped_object": tcsdf.WRAPPED}
    cases = dict(re.findall(r"case (\d+): f\((\w+(?:<[^{]*>)?)\{\}\)", HEADER.read_text()))
    assert {int(k): v for k, v in cases.items() if int(k) >= 4} == {
        tcsdf.SPHERE: "Sphere", tcsdf.SOLID_BOX: "SolidBox", tcsdf.MANDELBULB: "Mandelbulb",
        tcsdf.WRAPPED: "Wrapped<Box<false, false>>", tcsdf.COMPOSED: "Composed",
        tcsdf.WRAPPED_MOVED: "Wrapped<Box<false, true>>", tcsdf.COMPOSED_LARGE: "ComposedLarge",
        tcsdf.GRID_FORMS["lerp"]: "GridScene<GRID_LERP>",
        tcsdf.GRID_FORMS["weights"]: "GridScene<GRID_WEIGHTS>"}
    box = render_kernel.scene_desc_c(_desc("box"))
    assert list(box.box_half) == [0.5, 0.5, 0.5] and box.structure == tcsdf.SOLID_BOX
    bulb = render_kernel.scene_desc_c(_desc("mandelbulb"))
    assert bulb.scale == np.float32(0.4)
    wrapped = render_kernel.scene_desc_c(_desc("wrapped_object"))
    assert (wrapped.cell, wrapped.half_cell) == (8.0, 4.0) and wrapped.cull_radius == 0.0
    scene = get_scene("wrapped_object", device="cpu")
    moved = tcsdf.compile_scene(scene, dict(scene.params,
                                            object_center=torch.tensor([0.5, 0.0, 0.0])))
    assert tcsdf.kernel_structure(moved) == tcsdf.WRAPPED_MOVED == 11
    assert render_kernel.scene_desc_c(moved, device="cpu").structure == 11
    framed = dataclasses.replace(
        moved, frame=tcsdf.compile_scene(get_scene("reference_render_scene", device="cpu")).frame)
    with pytest.raises(NotImplementedError, match="Wrapped"):
        tcsdf.kernel_structure(framed)


# ---------------------------------------------------------------------------
# the render: K1, K2 + K3 (their plain twins)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", EXACT)
def test_trace_and_render_match_jax_xla(name):
    """K2's twin without the cull, and K1's with it, against the JAX
    package's XLA trace and render at 96x64."""
    (jo, jd, jc), rays = _rays(name, 96, 64)
    jscene = jax_get_scene(name)
    ref = jtrace.sphere_trace(jscene.bind(), jo, jd, jc)
    ref_outcome, ref_steps = np.asarray(ref.outcome), np.asarray(ref.steps)
    desc = _desc(name)
    depth, steps, outcome = (t.numpy() for t in trace_cuda(desc, *rays, use_bb_skip=False))
    np.testing.assert_array_equal(outcome, ref_outcome)
    assert np.mean(steps == ref_steps) >= STEP_SHARE
    hit = outcome == COLLISION
    assert hit.sum() > 100
    # a ray one step apart ends up to a step apart: depth on the same steps,
    # within the reference scene's 1e-4 at its depths (<= 10), and the same
    # 1e-5 relative beyond, where the wrapped object's far copies are hit
    # after up to ~100 steps (depth up to ~240)
    same = hit & (steps == ref_steps)
    ref_depth = np.asarray(ref.depth)[same]
    assert (np.abs(depth[same] - ref_depth) <= 1e-5 * np.maximum(ref_depth, 10.0)).all()
    rgb, _, _, culled = (t.numpy() for t in render_image_cuda(desc, *rays, return_planes=True))
    np.testing.assert_array_equal(culled, ref_outcome)
    assert_image_bars(rgb, np.asarray(jshade.render_image(jscene.bind(), jo, jd, jc)))


@pytest.mark.parametrize("name", ALL)
def test_render_matches_render_image_pallas(name):
    """K1's twin against the JAX package's fused Pallas kernel in interpret
    mode at 48x32, each with its scene's bounds (none for the wrapped
    object): the bars above, or the mandelbulb's (the Pallas kernel's
    polynomial inverse trig stands in for acos and atan2)."""
    (jo, jd, jc), rays = _rays(name, 48, 32)
    jscene = jax_get_scene(name)
    csdf, bb = compile_scene_csdf(jscene), jcsdf.scene_bounds(jscene)
    image = np.asarray(render_image_pallas(csdf, jo, jd, jc, bb=bb, interpret=True))
    planes = [np.asarray(x) for x in trace_pallas(csdf, jo, jd, jc, bb=bb,
                                                  use_bb_skip=bb is not None, interpret=True)]
    rgb, depth, steps, outcome = (t.numpy() for t in render_image_cuda(_desc(name), *rays,
                                                                       return_planes=True))
    same = outcome == planes[2]
    both = same & (outcome == COLLISION)
    assert both.sum() > 20
    err = np.abs(depth - planes[0])[both]
    if name == "mandelbulb":
        assert same.mean() >= 0.995
        assert np.mean(err <= 1e-4) >= 0.99
        return
    assert same.all()
    equal_steps = steps == planes[1]
    assert equal_steps.mean() >= STEP_SHARE
    assert np.abs(depth - planes[0])[both & equal_steps].max() <= 1e-4
    assert_image_bars(rgb, image)


def test_mandelbulb_render_bars():
    """K1's twin against the JAX package's XLA trace with exact trig at
    64x48: outcomes on >= 99.5% of pixels, depth within 1e-4 on >= 99% of
    the hits both have; the image within the reference scene's bars on the
    pixels whose outcomes agree."""
    (jo, jd, jc), rays = _rays("mandelbulb", 64, 48)
    jscene = jax_get_scene("mandelbulb")
    ref = jtrace.sphere_trace(jscene.bind(), jo, jd, jc)
    rgb, depth, _, outcome = (t.numpy() for t in render_image_cuda(_desc("mandelbulb"), *rays,
                                                                   return_planes=True))
    same = outcome == np.asarray(ref.outcome)
    both = same & (outcome == COLLISION)
    assert same.mean() >= 0.995 and both.sum() > 100
    assert np.mean(np.abs(depth - np.asarray(ref.depth))[both] <= 1e-4) >= 0.99
    image = np.asarray(jshade.render_image(jscene.bind(), jo, jd, jc))
    assert np.mean(np.abs(rgb - image).max(axis=-1)[same] < 2e-2) >= 0.99


# ---------------------------------------------------------------------------
# the mesh: refine, K6 and K7 (their plain twins)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", EXACT)
def test_refine_survivor_sets_equal_jax(name):
    jscene = jax_get_scene(name)
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
@pytest.mark.parametrize("name", EXACT)
def test_mesh_matches_jax_generate_mesh(name, variant):
    """Init factor 8, one refine: the JAX package's ``generate_mesh`` (its
    native weld) and the port's, K6's twin (K7's with interpolated edges),
    as canonical faces. The box's gradient is NaN inside it in both: under
    "grad" its Newton steps end at NaN, at the same vertices, and the
    native weld keeps each NaN vertex apart."""
    options = MESH_VARIANTS[variant]
    jscene = jax_get_scene(name)
    ref = jax_generate_mesh(jscene.bind(), 1, JaxMeshGenConfig(init_factor=8, **options),
                            csdf=compile_scene_csdf(jscene))
    got = generate_mesh(_desc(name), 1, MeshGenConfig(init_factor=8, **options), device="cpu")
    assert got.triangle_count == ref.triangle_count > 50
    nan = np.isnan(ref.vertices).any(axis=1)
    if name == "box" and variant != "fd4":
        assert nan.all() and got.vertex_count == ref.vertex_count == 3 * ref.triangle_count
        np.testing.assert_array_equal(np.isnan(got.vertices), np.isnan(ref.vertices))
        np.testing.assert_array_equal(got.faces, np.asarray(ref.faces))
        return
    assert not nan.any()
    assert_same_mesh(got.vertices, got.faces.astype(np.int64), ref.vertices,
                     np.asarray(ref.faces).astype(np.int64))


def test_mandelbulb_mesh_bars():
    """Init factor 8, one refine: the triangle count within 1% of the JAX
    package's (whose compiled SDF uses the polynomial inverse trig)."""
    jscene = jax_get_scene("mandelbulb")
    ref = jax_generate_mesh(jscene.bind(), 1, JaxMeshGenConfig(init_factor=8),
                            csdf=compile_scene_csdf(jscene))
    got = generate_mesh(_desc("mandelbulb"), 1, MeshGenConfig(init_factor=8), device="cpu")
    assert ref.triangle_count > 10
    assert abs(got.triangle_count - ref.triangle_count) <= 0.01 * ref.triangle_count


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_mesh_mandelbulb_writes_its_obj(tmp_path):
    out = tmp_path / "bulb.obj"
    assert cli.main(["mesh", "--device", "cpu", "--scene", "mandelbulb", "--init-factor", "8",
                     "--refine", "1", "-o", str(out)]) == 0
    mesh = load_obj(out)
    assert out.read_text().startswith("# bsdmg_tpu generated mesh (native writer)\n")
    assert mesh.triangle_count > 10 and mesh.vertex_count > 10


@pytest.mark.parametrize("name", ALL)
def test_cli_render_each_scene(name, tmp_path):
    out = tmp_path / "frame.npy"
    assert cli.main(["render", "--device", "cpu", "--scene", name, "--width", "32",
                     "--height", "18", "--camera", *map(str, _camera(name)), "-o", str(out)]) == 0
    img = np.load(out)
    assert img.shape == (18, 32, 3) and np.isfinite(img).all() and img.max() > 0.2


#: the depth fits held against JAX's cmd_fit; the wrapped object's diverges
#: in both packages
DEPTH_FITS = {"sphere": "radius=1.2", "box": "size=1.2"}


#: the image fits held against JAX's cmd_fit (the box has no component form)
IMAGE_FITS = {"sphere": "radius=1.2", "wrapped_object": "sphere_radius=1.2"}


@pytest.mark.parametrize("name", ["box", "sphere", "wrapped_object"])
def test_cli_fit_of_a_new_scene_raises(name, caplog):
    """``fit --image`` of the box exits as JAX's ``cmd_fit`` does (it has no
    component form); the sphere's and the wrapped object's run through K4's
    and K5's twins and match JAX's at 32x24 and 6 steps (the wrapped
    object's loss rises in both packages). The depth fit is plain PyTorch
    and runs as JAX's ``cmd_fit``: without ``--perturb`` it exits asking for
    one, and the sphere's and the box's at 32x32 and 11 steps recover the
    value within 1e-3 and the last loss within 10% relative of JAX's. (The
    mandelbulb's: tests/test_torch_slice.py.)"""
    if name == "box":
        argv = ["fit", "--image", "--scene", name, "--perturb", "size=1.2"]
        with pytest.raises(SystemExit, match="param-traced component SDF"):
            cli.main([*argv, "--device", "cpu"])
        with pytest.raises(SystemExit, match="param-traced component SDF"):
            jax_cli.main(argv)
    else:
        assert_image_fit_matches_jax(["--scene", name, "--perturb", IMAGE_FITS[name]], caplog,
                                     diverges=name == "wrapped_object")
    with pytest.raises(SystemExit, match="pass --perturb"):
        cli.main(["fit", "--device", "cpu", "--scene", name])
    if name not in DEPTH_FITS:
        return
    argv = ["fit", "--scene", name, "--perturb", DEPTH_FITS[name], "--width", "32", "--height",
            "32", "--steps", "11"]
    with caplog.at_level(logging.INFO):
        assert cli.main([*argv, "--device", "cpu"]) == 0
        ours = _fit_values(_log_lines(caplog, "bsdmg_tpu_torch"))
        caplog.clear()
        jax_cli.main(argv)
        ref = _fit_values(_log_lines(caplog, "bsdmg"))
    np.testing.assert_allclose(ours[0], ref[0], atol=1e-3, rtol=0)
    assert abs(ours[1] - ref[1]) <= 0.1 * abs(ref[1])


def test_cli_bench_renders_a_new_scene(capsys):
    assert cli.main(["bench", "--which", "render", "--device", "cpu", "--scene", "sphere",
                     "--width", "32", "--height", "16", "--roofline"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["render"]["rays_per_s"] > 0 and out["roofline"]["hits"] > 0
    assert out["roofline"]["speed_of_light_ms"] > 0 and out["roofline"]["pct_of_roofline"] is None
    with pytest.raises(NotImplementedError, match="--which render"):
        cli.main(["bench", "--which", "refine", "--device", "cpu", "--scene", "sphere"])


# ---------------------------------------------------------------------------
# the bounds' operation counts
# ---------------------------------------------------------------------------


def test_operation_counts():
    """profiling counts each new structure as scene_sdf.cuh computes it;
    the mandelbulb's by its data (LoopWork), the wrapped object without the
    slab cull."""
    sphere, box, bulb, wrapped = (_desc(n) for n in ("sphere", "box", "mandelbulb",
                                                       "wrapped_object"))
    obj = tcsdf.compile_scene(get_scene("reference_object", device="cpu"))
    assert profiling.sdf_ops(sphere) == 7 and profiling.sdf_ops(box) == 19
    assert profiling.grad_ops(sphere) == 14 and profiling.grad_ops(box) == 63
    wrap = profiling.WRAP + profiling.LIBM["fmodf"]
    assert profiling.sdf_ops(wrapped) == profiling.sdf_ops(obj) + 3 * wrap
    assert profiling.fd4_ops(wrapped) == profiling.fd4_ops(obj) + 15 * wrap
    assert profiling.fd4_ops(sphere) == 28 + 60 and profiling.fd4_ops(box) == 28 + 138
    for f in (profiling.sdf_ops, profiling.fd4_ops, profiling.grad_ops):
        with pytest.raises(ValueError):
            f(bulb)
    loop = profiling.LoopWork(evaluations=10, trips=40, full=35)
    assert loop.ops() == (10 * profiling.MANDELBULB_EVAL + 40 * 7
                          + 35 * profiling.MANDELBULB_ITERATION)
    assert profiling.render_ops(bulb, 10, 9, 1, 4, march_loop=loop, stencil_loop=loop) == (
        loop.ops() + 10 * 9 + 9 * 3 + loop.per_evaluation(12) + 28 + 29 + 4 * profiling.RAY)
    assert profiling.render_ops(wrapped, 10, 9, 1, 4) == (
        10 * (profiling.sdf_ops(wrapped) + 9) + 9 * 3 + profiling.shade_ops(wrapped)
        + 4 * profiling.ACES)


def test_mandelbulb_loops_count_the_twin_s_work():
    """mandelbulb_loops replays K1's march on the twin: one evaluation per
    step, and one more per ray that ended by a hit or the depth limit; each
    takes at least one trip, at most 25, and a full iteration each trip but
    the escaping one."""
    _, rays = _rays("mandelbulb", 24, 16)
    desc = _desc("mandelbulb")
    march, stencil = profiling.mandelbulb_loops(desc, *rays)
    depth, steps, outcome = trace_cuda(desc, *rays)
    evals, _, hits = profiling.march_work(steps, outcome, depth)
    assert march.evaluations == evals and stencil.evaluations == 12 * hits > 0
    for work in (march, stencil):
        assert work.evaluations <= work.trips <= 25 * work.evaluations
        assert work.trips - work.evaluations <= work.full <= work.trips


def test_libm_arguments_follow_the_loops(monkeypatch):
    """With every ray sampled, mandelbulb_loops gathers one logf argument
    per evaluation and one argument of each other call per full iteration
    (sincosf two), with the loops' counts unchanged; acosf's argument is
    clamped and powf's radius within the escape radius."""
    _, rays = _rays("mandelbulb", 24, 16)
    desc = _desc("mandelbulb")
    plain = profiling.mandelbulb_loops(desc, *rays)
    monkeypatch.setattr(profiling, "ARGUMENT_STRIDE", 1)
    arguments = {}
    march, stencil = profiling.mandelbulb_loops(desc, *rays, arguments)
    assert (march, stencil) == plain
    n = {k: sum(len(a) for a in v) for k, v in arguments.items()}
    full = march.full + stencil.full
    assert n["logf"] == march.evaluations + stencil.evaluations
    assert n["acosf"] == n["atan2f"] == n["powf7"] == n["powf6"] == full > 0
    assert n["sincosf"] == 2 * full
    assert torch.cat(arguments["acosf"]).abs().max() <= 1.0
    assert 0.0 < torch.cat(arguments["powf7"]).max() <= 2.0


def test_mandelbulb_escape_counts_each_point_s_trips():
    """The counting copy of the escape loop: a point outside the escape
    radius takes one trip and no iteration; each point at least one trip,
    at most 25, and an iteration each trip but its escaping one."""
    rng = np.random.default_rng(3)
    pts = torch.from_numpy(rng.uniform(-1.3, 1.3, (3, 4000)).astype(np.float32))
    trips, full = profiling.mandelbulb_escape(*pts)
    assert pts.shape[1] <= trips <= 25 * pts.shape[1]
    assert trips - pts.shape[1] <= full < trips
    far = torch.full((5,), 3.0)
    assert profiling.mandelbulb_escape(far, far, far) == (5, 0)


def test_wrap_arguments_follow_the_march(monkeypatch):
    """With every ray sampled, wrap_arguments gathers three fmodf calls per
    march evaluation and fifteen per hit (its centre's three, one at each
    fd4 point), each with the cell as its divisor."""
    _, rays = _rays("wrapped_object", 16, 8)
    desc = _desc("wrapped_object")
    monkeypatch.setattr(profiling, "ARGUMENT_STRIDE", 1)
    (pairs,) = profiling.wrap_arguments(desc, *rays)["fmodf"]
    depth, steps, outcome = trace_cuda(desc, *rays)
    evals, _, hits = profiling.march_work(steps, outcome, depth)
    assert pairs.shape == (3 * evals + 15 * hits, 2) and hits > 0
    assert bool((pairs[:, 1] == desc.cell).all())


PTX = """.version 8.7
.target sm_90a
.address_size 64

.global .align 4 .b8 table[4] = {1, 2, 3, 4};

.visible .entry probe(
\t.param .u64 probe_param_0
)
{
\t.reg .pred \t%p<3>;
\t.reg .f32 \t%f<8>;

\tsetp.ge.s32 \t%p1, %r1, %r2;
\t@%p1 bra \t$L__BB0_2;
\tabs.f32 \t%f2, %f1;
\tfma.rn.f32 \t%f3, %f2, 0fBF000000, 0f3F000000;
\t@%p2 bra \t$L__BB0_3;
\tmul.rn.f32 \t%f4, %f2, %f2;
\tselp.f32 \t%f5, %f4, %f3, %p2;
\t{ // callseq 0, 0
\t.param .b32 param0;
\tst.param.f32 \t[param0+0], %f5;
\t} // callseq 0
$L__BB0_3:
\tsqrt.rn.f32 \t%f7, %f3;
$L__BB0_2:
\tret;

}
"""


def test_instrument_ptx_counts_each_basic_block():
    """instrument_ptx puts a counter at the entry, after each branch and
    at each label, past the declarations and outside a call's scope's
    declarations, and gives each block its FP32 operations."""
    text, ops = profiling.instrument_ptx(PTX)
    assert ops == [0, 1 + 2, 1, 1, 0]
    lines = [line.strip() for line in text.splitlines()]
    assert ".global .align 8 .u64 block_count[5];" in lines
    heads = [i for i, line in enumerate(lines) if line.startswith("red.global.add.u64")]
    assert [lines[i] for i in heads] == [f"red.global.add.u64 \t[block_count+{8 * k}], 1;"
                                         for k in range(5)]
    assert [lines[i + 1].split()[0] for i in heads] == ["setp.ge.s32", "abs.f32", "mul.rn.f32",
                                                        "sqrt.rn.f32", "ret;"]
    assert lines[heads[0] - 2].startswith(".reg")
    assert [line for line in lines if not line.startswith(("red.", ".global .align 8"))] == [
        line.strip() for line in PTX.splitlines()]


@pytest.mark.parametrize("line, ops", [
    ("add.rn.f32 %f1, %f2, %f3;", 1), ("fma.rn.f32 %f1, %f2, %f3, %f4;", 2),
    ("@%p1 max.NaN.f32 %f1, %f2, %f3;", 1), ("setp.lt.f32 %p1, %f1, %f2;", 1),
    ("cvt.rzi.s32.f32 %r1, %f1;", 1), ("ex2.approx.ftz.f32 %f1, %f2;", 1),
    ("selp.f32 %f1, %f2, %f3, %p1;", 0), ("neg.f32 %f1, %f2;", 0),
    ("mov.b32 %f1, %r1;", 0), ("add.s32 %r1, %r2, %r3;", 0), ("fma.rn.f64 %fd1, %fd2, %fd3, %fd4;", 0),
    ("@%p1 bra $L__BB0_2;", 0)])
def test_ptx_fp32_ops(line, ops):
    """An instruction's FP32 operations: an FMA two, a min, max, compare,
    conversion or special function one, a select, negation or move none."""
    assert profiling.ptx_fp32_ops(line) == ops
