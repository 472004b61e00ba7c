"""Mesh-asset scenes through every verb of the PyTorch port against the JAX
package, on the CPU: the grid as a scene of the mesh kernels (the plain
twins of K6 and K7 over ``ops/cuda/csdf.py::grid_descriptor``), the bake's
wrapper, and ``cli mesh``, ``remesh``, ``session``, ``animate`` and the
depth ``fit`` of a ``mesh:`` scene. The asset is ``tools/make_torus.py``'s
torus with 768 triangles, baked at 16^3 (8^3 for the fit). Bars:

* the grid's value and gradient in both forms (``grid_sdf``'s lerps,
  ``grid_csdf``'s weights), with and without an offset, against
  ``jax.vjp`` of the JAX functions at points inside and outside the box, on
  lattice nodes and on its faces: within 1e-6 absolute plus 1e-6 relative
  (XLA's CPU square root and reduction round otherwise than PyTorch's
  outside the box; inside it the two agree bit for bit but on a few
  points); the value bit-equal to the port's ``grid_sdf`` and ``grid_csdf``;
* ``cli mesh`` (the fused path, K6's twin; JAX runs its staged XLA path)
  and ``cli remesh``: the JAX CLI's triangle and vertex counts, the same
  faces, vertices within 2e-5 (``tests/test_torch_mesh.py``'s bars);
  ``--interpolate-edges``: the same triangle count and each package's
  vertices within 2e-5 of the other's, the vertex counts within 1%: the
  staged path projects an edge from its start point in each of its
  voxels, whose corners round apart, so an edge may give two vertices 1e-7
  apart, and whether the weld's 1e-5 cells join them is rounding in either
  package (281 vertices here against JAX's 280 from the same 293 distinct
  soup vertices);
* ``cli session``: the counts and faces as ``cli mesh``'s; ``cli animate``
  frames: each channel within 2 of 255 and the mean under 0.05 of a level
  (``tests/test_torch_animate.py``'s bars; JAX renders through its XLA
  march, the port through the grid route's twins), its motion ignored with
  the JAX CLI's warning;
* the depth fit: the recovered table within 1e-3 (the SDF reads no
  parameter: nothing moves in either package) and the loss within 1e-9
  (0 here, JAX's ~1e-13, its target and its jitted march rounding apart);
* the image fit (``fit --image``, K4's and K5's grid form, their twins
  here): loss 0 at each logged step and the recovered table equal to
  JAX's within 1e-6, as the SDF reads no parameter; the twins of K4 and
  K5 over the grid (``GridCsdf``) against the JAX package's XLA march and
  ``render_loss_and_grad``: outcomes and steps on 99.9% of rays (XLA
  contracts FMAs, PyTorch does not), the hits' depths within 1e-5, the
  loss within 1e-4 relative, the gradient zero in both.
"""

import importlib.util
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
from bsdmg_tpu.models import mesh_sdf as jm
from bsdmg_tpu_torch import cli
from bsdmg_tpu_torch.mesh.export import load_obj, save_obj
from bsdmg_tpu_torch.mesh.pipeline import Mesh
from bsdmg_tpu_torch.models import mesh_sdf as tm
from bsdmg_tpu_torch.ops.cuda import bake_kernel, mc_kernel, mesh_kernel
from bsdmg_tpu_torch.ops.cuda import csdf as tcsdf
from bsdmg_tpu_torch.ops.cuda.render_kernel import render_image_cuda, scene_desc_c
from bsdmg_tpu_torch.utils import profiling
from bsdmg_tpu_torch.weights import grid_from_numpy

from test_torch_mesh import _canonical_faces, assert_same_mesh

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RES = 16


@pytest.fixture(scope="module")
def torus():
    spec = importlib.util.spec_from_file_location("make_torus", ROOT / "tools" / "make_torus.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.torus(nu=24, nv=16)


@pytest.fixture(scope="module")
def torus_obj(torus, tmp_path_factory):
    verts, faces = torus
    path = tmp_path_factory.mktemp("asset") / "torus.obj"
    save_obj(Mesh(vertices=verts, normals=np.zeros_like(verts), faces=faces), path)
    return path


# ---------------------------------------------------------------------------
# the grid as a scene of K6 and K7
# ---------------------------------------------------------------------------

R, LO, HI = 12, (-1.3, -1.1, -0.9), (1.2, 1.0, 1.4)


@pytest.fixture(scope="module")
def table():
    return np.random.default_rng(0).normal(size=(R, R, R)).astype(np.float32)


def _points():
    """Points inside and outside the box, on lattice nodes (where ``floor``
    ties) and on the box's faces (where the outside's maxima tie)."""
    rng = np.random.default_rng(1)
    lo, hi = np.float32(LO), np.float32(HI)
    nodes = lo + rng.integers(0, R, (500, 3)) * ((hi - lo) / np.float32(R - 1))
    faces = rng.uniform(-1.0, 1.0, (300, 3)).astype(np.float32)
    faces[:150, 0], faces[150:, 1] = lo[0], hi[1]
    return np.concatenate([rng.uniform(-2.2, 2.2, (4000, 3)).astype(np.float32),
                           nodes.astype(np.float32), faces])


def _jax_form(grid, form, offset):
    if form == "lerp":
        sdf = jm.grid_sdf(grid)
        shift = 0.0 if offset is None else jnp.asarray(offset)
        return lambda x, y, z: sdf(jnp.stack([x, y, z], axis=-1) + shift)
    csdf = jm.grid_csdf(grid)
    if offset is None:
        return csdf
    c = jnp.asarray(offset)
    return lambda x, y, z: csdf(x + c[0], y + c[1], z + c[2])


@pytest.mark.parametrize("offset", [False, True], ids=["no offset", "offset"])
@pytest.mark.parametrize("form", ["lerp", "weights"])
def test_grid_value_and_grad_match_jax_vjp(table, form, offset):
    center = np.asarray([(a + b) / 2 for a, b in zip(LO, HI)], np.float32) if offset else None
    p = _points()
    cols = [jnp.asarray(p[:, k]) for k in range(3)]
    d, vjp = jax.vjp(_jax_form(jm.SdfGrid(values=table, lo=LO, hi=HI), form, center), *cols)
    ref = [np.asarray(d), *(np.asarray(g) for g in vjp(jnp.ones_like(d)))]
    desc = tcsdf.grid_descriptor(grid_from_numpy(table, LO, HI, "cpu"), form, center)
    planes = [torch.from_numpy(p[:, k].copy()) for k in range(3)]
    got = tcsdf.descriptor_csdf_value_and_grad(desc)(*planes)
    assert torch.equal(got[0], tcsdf.descriptor_csdf(desc)(*planes))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, atol=1e-6, rtol=1e-6)
    assert all(np.abs(r).max() > 1.0 for r in ref[1:])


def test_grid_value_equals_the_port_s_grid_sdf_and_csdf(table):
    """The lerp form's value is ``grid_sdf``'s, the weights form's
    ``grid_csdf``'s (the samplers K8 and P1 take), bit for bit."""
    grid = grid_from_numpy(table, LO, HI, "cpu")
    p = torch.from_numpy(_points())
    planes = [p[:, k].contiguous() for k in range(3)]
    lerp = tcsdf.descriptor_csdf(tcsdf.grid_descriptor(grid, "lerp"))(*planes)
    weights = tcsdf.descriptor_csdf(tcsdf.grid_descriptor(grid, "weights"))(*planes)
    assert torch.equal(lerp, tm.grid_sdf(grid)(p))
    assert torch.equal(weights, tm.grid_csdf(grid)(*planes))
    assert not torch.equal(lerp, weights)


def test_grid_descriptor_and_its_structure(table):
    grid = grid_from_numpy(table, LO, HI, "cpu")
    scene, _ = tm.mesh_scene(*_sphere_mesh(), resolution=8, device="cpu")
    desc = tcsdf.compile_scene(scene)
    assert (desc.kind, desc.grid_form, desc.offset, desc.bounds) == ("grid", "lerp", None, None)
    assert tcsdf.scene_bounds(scene) is None
    assert tcsdf.kernel_structure(desc) == tcsdf.GRID_FORMS["lerp"] == 9
    weights = tcsdf.grid_descriptor(grid, "weights", (0.1, 0.2, 1 / 3))
    assert tcsdf.kernel_structure(weights) == 10
    assert weights.offset == (np.float32(0.1), np.float32(0.2), np.float32(1 / 3))
    with pytest.raises(ValueError, match="grid form"):
        tcsdf.grid_descriptor(grid, "cubic")
    o = torch.zeros((2, 3, 3))
    with pytest.raises(NotImplementedError, match="render_image_grid"):
        render_image_cuda(desc, o, o, torch.zeros((2, 3)))
    with pytest.raises(ValueError, match="the launch on cuda:0"):
        scene_desc_c(weights, device="cuda:0")


def test_grid_operation_counts(table):
    grid = grid_from_numpy(table, LO, HI, "cpu")
    lerp, weights = (tcsdf.grid_descriptor(grid, f) for f in ("lerp", "weights"))
    assert profiling.sdf_ops(lerp) == 63 and profiling.sdf_ops(weights) == 64
    assert profiling.grad_ops(lerp) == 164 and profiling.grad_ops(weights) == 173
    # the shared-term stencil: an axis's 11 terms (12 on x for "weights") at
    # the centre and the 4 points of that axis, the other 30 at all 12 points
    assert profiling.fd4_ops(lerp) == profiling.STENCIL + 5 * 33 + 12 * 30
    assert profiling.fd4_ops(weights) == profiling.STENCIL + 5 * 34 + 12 * 30
    assert profiling.BAKE_PAIR == 213
    assert profiling.bake_ops(10, 3) == 10 * 3 * 213 + 10 * 3 + 3 * 36
    assert profiling.bake_bytes(4, 2) == 48 + 72 + 256


def _sphere_mesh():
    """An octahedron: 6 vertices, 8 triangles, outward."""
    v = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                 np.float32)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4], [2, 0, 5], [1, 2, 5], [3, 1, 5],
                  [0, 3, 5]], np.int32)
    return v, f


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def test_bake_wrapper_sends_cpu_tensors_to_the_twin(torus):
    verts, faces = torus
    lo, hi = tm.grid_box(verts)
    axes = [torch.from_numpy(tm._linspace(lo[a], hi[a], 6)) for a in range(3)]
    launches = bake_kernel.LAUNCHES
    got = bake_kernel.bake(axes, verts, faces)
    assert bake_kernel.LAUNCHES == launches
    ref = tm.mesh_signed_distance(bake_kernel.lattice(axes), verts, faces)
    assert torch.equal(got, ref) and (got < 0).any() and (got > 0).any()
    grid = tm.bake_mesh_grid(verts, faces, resolution=6, device="cpu")
    assert torch.equal(grid.values.reshape(-1), got)


class _OnCard:
    """Stands in for a CUDA tensor where only the wrappers' dispatch reads
    it."""

    device = torch.device("cuda", 0)


def test_wrappers_send_the_card_s_grid_to_the_kernels_only(table, monkeypatch):
    """On a CUDA tensor the mesh kernels' and the bake's wrappers call the
    kernels with a grid descriptor and never a twin."""
    calls = []

    def refuse(*args, **kwargs):
        raise AssertionError("a twin ran for a CUDA tensor")

    monkeypatch.setattr(mc_kernel, "mc_fused_torch", refuse)
    monkeypatch.setattr(mesh_kernel, "project_edges_torch", refuse)
    monkeypatch.setattr(bake_kernel, "bake_torch", refuse)
    monkeypatch.setattr(mc_kernel, "mc_fused_cuda", lambda desc, *a, **k: calls.append(("K6", desc)))
    monkeypatch.setattr(mesh_kernel, "project_edges_cuda",
                        lambda desc, *a, **k: calls.append(("K7", desc)))
    monkeypatch.setattr(bake_kernel, "bake_cuda", lambda *a, **k: calls.append(("bake", None)))
    desc = tcsdf.grid_descriptor(grid_from_numpy(table, LO, HI, "cpu"), "weights", (0.0,) * 3)
    t = _OnCard()
    mc_kernel.mc_fused(desc, t, t, t, t, t, t, 0.1, budget=6, iters=8, tol=1e-6, eps=1e-3)
    mesh_kernel.project_edges(desc, t, t, t, t, iters=8, tol=1e-6, eps=1e-3)
    bake_kernel.bake([t, t, t], *_sphere_mesh())
    assert calls == [("K6", desc), ("K7", desc), ("bake", None)]


# ---------------------------------------------------------------------------
# the CLI against the JAX CLI
# ---------------------------------------------------------------------------


def _both(argv, tmp_path, suffix=".obj"):
    ours, ref = tmp_path / f"ours{suffix}", tmp_path / f"ref{suffix}"
    assert cli.main([*argv, "--device", "cpu", "-o", str(ours)]) == 0
    jax_cli.main([*argv, "-o", str(ref)])
    return load_obj(ours), load_obj(ref)


@pytest.mark.parametrize("interpolate", [False, True], ids=["midpoints", "interpolate-edges"])
def test_cli_mesh_of_a_mesh_asset_matches_jax(torus_obj, tmp_path, interpolate):
    extra = ["--interpolate-edges"] if interpolate else []
    ours, ref = _both(["mesh", "--scene", f"mesh:{torus_obj}:{RES}", "--init-factor", "8",
                       "--refine", "1", *extra], tmp_path)
    assert ref.triangle_count > 500
    if not interpolate:
        assert_same_mesh(ours.vertices, ours.faces.astype(np.int64), ref.vertices,
                         ref.faces.astype(np.int64))
        return
    assert ours.triangle_count == ref.triangle_count
    assert abs(ours.vertex_count - ref.vertex_count) <= 0.01 * ref.vertex_count
    for a, b in ((ours.vertices, ref.vertices), (ref.vertices, ours.vertices)):
        assert cKDTree(b).query(a)[0].max() <= 2e-5


def test_cli_remesh_matches_jax(torus_obj, tmp_path):
    ours, ref = _both(["remesh", "-i", str(torus_obj), "--grid-resolution", str(RES),
                       "--init-factor", "8", "--refine", "1"], tmp_path)
    assert ref.triangle_count > 500
    assert_same_mesh(ours.vertices, ours.faces.astype(np.int64), ref.vertices,
                     ref.faces.astype(np.int64))
    assert (tmp_path / "ours.obj").read_text().startswith(
        "# bsdmg_tpu generated mesh (native writer)\n")


def test_cli_remesh_writes_vtk(torus_obj, tmp_path):
    out = tmp_path / "r.vtk"
    assert cli.main(["remesh", "--device", "cpu", "-i", str(torus_obj), "--grid-resolution", "8",
                     "--init-factor", "4", "--refine", "1", "-o", str(out)]) == 0
    assert out.read_text().startswith("# vtk DataFile")


def test_cli_session_of_a_mesh_asset_matches_jax(torus_obj, tmp_path, caplog):
    argv = ["session", "--scene", f"mesh:{torus_obj}:{RES}", "--init-factor", "8", "--keys", "vbvv"]
    with caplog.at_level(logging.INFO):
        ours, ref = _both(argv, tmp_path)
    assert_same_mesh(ours.vertices, ours.faces.astype(np.int64), ref.vertices,
                     ref.faces.astype(np.int64))
    assert _canonical_faces(ours.faces.astype(np.int64)) and ref.triangle_count > 500


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path)).astype(np.int32)


def test_cli_animate_of_a_mesh_asset_matches_jax(torus_obj, tmp_path):
    argv = ["animate", "--scene", f"mesh:{torus_obj}:{RES}", "--width", "32", "--height", "18",
            "--frames", "2", "--rotate", "--camera", "3", "1.5", "-3"]
    assert cli.main([*argv, "--device", "cpu", "-o", str(tmp_path / "ours")]) == 0
    jax_cli.main([*argv, "-o", str(tmp_path / "ref")])
    for i in range(2):
        ours, ref = _png(tmp_path / f"ours_{i:04d}.png"), _png(tmp_path / f"ref_{i:04d}.png")
        assert ours.shape == ref.shape == (18, 32, 4)
        diff = np.abs(ours - ref)
        assert diff.max() <= 2 and diff.mean() < 0.05, (i, diff.max(), diff.mean())
        assert (ours[..., :3].sum(axis=-1) > 0).sum() > 50
    assert np.abs(_png(tmp_path / "ours_0000.png") - _png(tmp_path / "ours_0001.png")).max() > 0


def test_cli_animate_motion_of_a_mesh_asset_is_ignored(torus_obj, tmp_path, caplog):
    argv = ["animate", "--scene", f"mesh:{torus_obj}:8", "--width", "8", "--height", "6",
            "--frames", "1", "--motion", "spheric"]
    with caplog.at_level(logging.WARNING):
        assert cli.main([*argv, "--device", "cpu", "-o", str(tmp_path / "ours")]) == 0
        ours = [r.getMessage() for r in caplog.records if r.name == "bsdmg_tpu_torch"]
        caplog.clear()
        jax_cli.main([*argv, "-o", str(tmp_path / "ref")])
        ref = [r.getMessage() for r in caplog.records if r.name == "bsdmg"]
    assert ours == ref and len(ref) == 1 and "motion ignored" in ref[0]


def _fit_values(lines):
    last = [m for m in lines if m.startswith("step ")][-1]
    loss = float(last.split("loss=")[1].split()[0])
    recovered = lines[-1].split("recovered ")[1].split(" (true")[0]
    return np.asarray([float(v) for v in re.findall(r"-?\d+\.\d+(?:e-?\d+)?", recovered)]), loss


def test_cli_depth_fit_of_a_mesh_asset_matches_jax(torus_obj, caplog):
    argv = ["fit", "--scene", f"mesh:{torus_obj}:8", "--perturb", "grid=1.1", "--width", "16",
            "--height", "12", "--steps", "3"]
    with caplog.at_level(logging.INFO):
        assert cli.main([*argv, "--device", "cpu"]) == 0
        ours = _fit_values([r.getMessage() for r in caplog.records if r.name == "bsdmg_tpu_torch"])
        caplog.clear()
        jax_cli.main(argv)
        ref = _fit_values([r.getMessage() for r in caplog.records if r.name == "bsdmg"])
    assert ours[0].size == ref[0].size == 8**3
    np.testing.assert_allclose(ours[0], ref[0], atol=1e-3, rtol=0)
    assert abs(ours[1] - ref[1]) <= 1e-9


def test_cli_fit_image_of_a_mesh_asset_matches_jax(torus_obj, caplog):
    """``fit --image`` of a mesh asset runs through K4's and K5's grid form
    (their twins here): the loss is 0 at every logged step and the table
    stays where the perturbation put it, as in the JAX package."""
    argv = ["fit", "--image", "--scene", f"mesh:{torus_obj}:8", "--perturb", "grid=1.1",
            "--width", "16", "--height", "12", "--steps", "3"]
    with caplog.at_level(logging.INFO):
        assert cli.main([*argv, "--device", "cpu"]) == 0
        lines = [r.getMessage() for r in caplog.records if r.name == "bsdmg_tpu_torch"]
        ours = _fit_values(lines)
        caplog.clear()
        jax_cli.main(argv)
        ref = _fit_values([r.getMessage() for r in caplog.records if r.name == "bsdmg"])
    losses = [float(m.split("loss=")[1].split()[0]) for m in lines if m.startswith("step ")]
    assert len(losses) == 2 and losses == [0.0, 0.0] and ref[1] == 0.0
    assert ours[0].size == ref[0].size == 8**3
    np.testing.assert_allclose(ours[0], ref[0], atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def grid_fit(torus):
    """The torus baked at RES in both packages (the same table), a 24x16
    frame from (3, 1.5, -3) and a target of another frame: the scene's
    parameters, both scenes and the rays."""
    from bsdmg_tpu.models.scenes import Scene as JaxScene
    from bsdmg_tpu_torch.cam import generate_rays, look_at

    verts, faces = torus
    scene, grid = tm.mesh_scene(verts, faces, resolution=RES, device="cpu")
    jgrid = jm.SdfGrid(values=grid.values.numpy(), lo=grid.lo, hi=grid.hi)
    jcsdf = jm.grid_csdf(jgrid)
    jscene = JaxScene("mesh", lambda q, p: None, {"grid": jnp.asarray(jgrid.values)},
                      lambda q, x, y, z: jcsdf(x, y, z), grid=jgrid)
    o, d, c = (a.numpy() for a in generate_rays(
        look_at((3.0, 1.5, -3.0), fov=np.pi / 4, device="cpu"), (24, 16), (1920.0, 1080.0)))
    target = np.random.default_rng(5).uniform(0.0, 1.0, (16, 24, 3)).astype(np.float32)
    target[:8] = 0.0  # rows the surface misses on: some hinges of both kinds
    return scene, jscene, (o, d, c), target


def test_grid_form_march_twin_matches_jax_march(grid_fit):
    """K4's twin over the grid (the form ``param_scene_c`` gives the
    kernel) against the JAX package's component-form march and its jvp
    along the ray."""
    from bsdmg_tpu.config import MarchConfig as JaxMarchConfig
    from bsdmg_tpu.ops.pallas.render_kernel import _march as jax_march
    from bsdmg_tpu_torch.ops.cuda import diff_kernel as dk

    scene, jscene, (o, d, c), _ = grid_fit
    assert dk.param_scene_c(scene.csdf, scene.params, device="cpu")[0].form == dk.FORM_MESH_GRID
    depth, steps, outcome, dfdt = (x.numpy() for x in dk.march_params_torch(
        scene.csdf, scene.params, *(torch.from_numpy(a) for a in (o, d, c))))
    f = lambda x, y, z: jscene.csdf(jscene.params, x, y, z)  # noqa: E731

    @jax.jit  # one compile, not one an operation
    def reference(planes, c):
        jd, js, jo = jax_march(
            f, JaxMarchConfig(), tuple(planes[:3]), tuple(planes[3:]), c, jnp.ones(c.shape, bool),
            jnp.zeros(c.shape, jnp.float32), jnp.zeros(c.shape, jnp.int32),
            JaxMarchConfig().step_limit)[:3]
        px = [planes[k] + jd * planes[3 + k] for k in range(3)]
        return jd, js, jo, jax.jvp(f, tuple(px), tuple(planes[3:]))[1]

    planes = [jnp.asarray(a[..., k]) for a in (o, d) for k in range(3)]
    jd, js, jo, jdfdt = (np.asarray(a) for a in reference(planes, jnp.asarray(c)))
    same = (outcome == jo) & (steps == js)
    assert same.mean() >= 0.999 and (outcome == 0).sum() > 50
    hit = same & (outcome == 0)
    np.testing.assert_allclose(depth[hit], jd[hit], atol=1e-5, rtol=0)
    np.testing.assert_allclose(dfdt[hit], np.asarray(jdfdt)[hit], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("edge", [0.0, 1.0])
def test_grid_form_loss_grad_twin_matches_jax(grid_fit, edge):
    """K5's twin over the grid against the JAX package's
    ``render_loss_and_grad`` (its XLA path, edge term on or off): the loss
    within 1e-4 relative, the gradient zero in both: the SDF reads no
    parameter."""
    from bsdmg_tpu.grad import render_loss_and_grad as jax_loss_grad
    from bsdmg_tpu_torch.ops.cuda import diff_kernel as dk

    scene, jscene, rays, target = grid_fit
    loss, grads = dk.render_loss_grad_torch(scene.csdf, scene.params, torch.from_numpy(target),
                                            *(torch.from_numpy(a) for a in rays),
                                            edge_weight=edge)
    jloss, jgrads = jax.jit(lambda q, *r: jax_loss_grad(None, q, *r, csdf=jscene.csdf,
                                                         edge_weight=edge))(
        jscene.params, jnp.asarray(target), *(jnp.asarray(a) for a in rays))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    assert loss.item() > 1e-3
    assert set(grads) == set(jgrads) == {"grid"}
    assert torch.equal(grads["grid"], torch.zeros_like(scene.params["grid"]))
    assert not np.asarray(jgrads["grid"]).any()
