"""The mesh-asset SDF of the PyTorch port (bsdmg_tpu_torch/models/mesh_sdf.py,
the OBJ reader of mesh/export.py, weights.grid_from_numpy) against the JAX
package's bsdmg_tpu/models/mesh_sdf.py and mesh/export.py on the same
numpy-seeded inputs. Bars:

* ``load_obj`` and ``coarsen_grid_lower``: equal arrays;
* point-triangle distances, winding numbers, signed distances and baked
  grids: within 1e-5 (XLA's CPU compiler contracts multiply-adds into FMAs
  and sums the length-3 and per-triangle reductions in its own order;
  PyTorch does neither), with equal signs at every grid node farther than
  1e-3 from the surface and equal box corners. The bake's lattice follows
  ``jnp.linspace``'s formula, which XLA contracts too, so nodes may differ by
  two float32 steps of the box's size;
* ``grid_sdf`` and ``grid_csdf``: within 1e-6.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsdmg_tpu.mesh.export import load_obj as jax_load_obj
from bsdmg_tpu.models import mesh_sdf as jm
from bsdmg_tpu_torch.mesh.export import load_obj
from bsdmg_tpu_torch.models import mesh_sdf as tm
from bsdmg_tpu_torch.weights import grid_from_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _make_torus():
    spec = importlib.util.spec_from_file_location("make_torus", ROOT / "tools" / "make_torus.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def small_torus():
    """A watertight torus of 384 vertices and 768 triangles."""
    return _make_torus().torus(nu=24, nv=16)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def sdf_field():
    """The non-spherical field of tests/test_mesh_sdf.py's mip test, 96^3."""
    r, lo, hi = 96, -1.5, 1.5
    ax = np.linspace(lo, hi, r, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    vals = np.minimum(
        np.sqrt(x * x + y * y + z * z) - 1.0,
        np.maximum.reduce([np.abs(x - 0.4), np.abs(y + 0.3), np.abs(z)]) - 0.5,
    ).astype(np.float32)
    return jm.SdfGrid(values=vals, lo=(lo,) * 3, hi=(hi,) * 3)


def test_load_obj_torus_equals_jax(tmp_path):
    path = tmp_path / "torus.obj"
    verts, faces = _make_torus().torus()
    with open(path, "w") as f:
        f.writelines(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n" for v in verts)
        f.writelines(f"f {a} {b} {c}\n" for a, b, c in faces + 1)
    got, ref = load_obj(path), jax_load_obj(path, use_native=False)
    assert got.vertex_count == 6144 and got.triangle_count == 12288
    for name in ("vertices", "normals", "faces"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
        assert getattr(got, name).dtype == getattr(ref, name).dtype


def test_load_obj_quads_and_negative_indices_equal_jax(tmp_path):
    """A cube of quads, one pentagon fan, ``v/vt/vn`` forms, relative
    indices and one normal per vertex."""
    lines = [f"v {x} {y} {z}" for x in (0, 1) for y in (0, 1) for z in (0, 1)]
    lines += [f"vn {x} {y} {z}" for x in (0, 1) for y in (0, 1) for z in (1, 0)]
    lines += ["", "f 1 2 4 3", "f 5/1 7/2 8/3 6/4", "f -8//1 -4//2 -3//3 -7//4",
              "f 3 4 8 7 -1", "f -2 -1 -5 -6", "# comment", "vt 0 0"]
    path = tmp_path / "quads.obj"
    path.write_text("\n".join(lines) + "\n")
    got, ref = load_obj(path), jax_load_obj(path, use_native=False)
    assert got.triangle_count == 11
    for name in ("vertices", "normals", "faces"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))


def _triangles(verts, faces):
    va, vb, vc = (verts[faces[:, k]] for k in range(3))
    return va, vb, vc


def test_point_triangle_and_winding_equal_jax(small_torus):
    verts, faces = small_torus
    rng = np.random.default_rng(0)
    p = rng.uniform(-1.8, 1.8, (256, 1, 3)).astype(np.float32)
    va, vb, vc = _triangles(verts, faces)
    ab, ac = vb - va, vc - va
    ref = np.asarray(jm._point_triangle_dist_sq(jnp.asarray(p), va, ab, ac))
    got = tm._point_triangle_dist_sq(_t(p), _t(va), _t(ab), _t(ac)).numpy()
    assert got.shape == (256, 768)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    ref = np.asarray(jm._winding_number(jnp.asarray(p), va, vb, vc))
    got = tm._winding_number(_t(p), _t(va), _t(vb), _t(vc)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert (np.abs(got) < 0.01).any() and (np.abs(got - 1) < 0.01).any()


def test_mesh_signed_distance_equals_jax(small_torus):
    verts, faces = small_torus
    pts = np.random.default_rng(1).uniform(-1.8, 1.8, (1000, 3)).astype(np.float32)
    ref = np.asarray(jm.mesh_signed_distance(pts, verts, faces, chunk=256))
    got = tm.mesh_signed_distance(_t(pts), verts, faces, chunk=300).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert (got < 0).any() and (got > 0).any()
    np.testing.assert_array_equal(tm.mesh_signed_distance(_t(pts), verts, faces).numpy(), got)


@pytest.mark.parametrize("resolution", [16, 20])
def test_bake_mesh_grid_equals_jax(small_torus, resolution):
    verts, faces = small_torus
    ref = jm.bake_mesh_grid(verts, faces, resolution=resolution)
    got = tm.bake_mesh_grid(verts, faces, resolution=resolution, device="cpu")
    assert got.resolution == resolution and got.values.dtype == torch.float32
    assert got.lo == ref.lo and got.hi == ref.hi
    a, b = got.values.numpy(), np.asarray(ref.values)
    np.testing.assert_allclose(a, b, atol=1e-5)
    far = np.abs(b) > 1e-3
    np.testing.assert_array_equal(np.sign(a[far]), np.sign(b[far]))
    assert (b < 0).any()


def test_lattice_follows_jnp_linspace():
    for lo, hi, r in ((-1.7, 1.7, 24), (-2.6, 2.6, 128), (0.1, 9.7, 33)):
        lo, hi = np.float32(lo), np.float32(hi)
        got, ref = tm._linspace(lo, hi, r), np.asarray(jnp.linspace(lo, hi, r))
        assert got.dtype == np.float32 and got[0] == lo and got[-1] == hi
        np.testing.assert_allclose(got, ref, rtol=0, atol=2 * np.spacing(max(-lo, hi)))


def test_coarsen_grid_lower_equals_jax(sdf_field):
    ref = jm.coarsen_grid_lower(sdf_field, 32)
    got = tm.coarsen_grid_lower(grid_from_numpy(sdf_field.values, sdf_field.lo, sdf_field.hi, "cpu"), 32)
    assert got.lo == ref.lo and got.hi == ref.hi
    np.testing.assert_array_equal(got.values.numpy(), ref.values)


def test_grid_sdf_and_csdf_equal_jax(sdf_field):
    ours = grid_from_numpy(sdf_field.values, sdf_field.lo, sdf_field.hi, "cpu")
    p = np.random.default_rng(2).uniform(-2.2, 2.2, (4096, 3)).astype(np.float32)
    ref = np.asarray(jm.grid_sdf(sdf_field)(jnp.asarray(p)))
    np.testing.assert_allclose(tm.grid_sdf(ours)(_t(p)).numpy(), ref, atol=1e-6)
    ref = np.asarray(jm.grid_csdf(sdf_field)(*map(jnp.asarray, p.T)))
    got = tm.grid_csdf(ours)(*(_t(c) for c in p.T)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    outside = (np.abs(p) > 1.5).any(axis=1)
    assert outside.any() and (got[outside] > 0).all()


def test_mesh_scene_bakes_and_samples(small_torus):
    verts, faces = small_torus
    scene, grid = tm.mesh_scene(verts, faces, resolution=16, device="cpu")
    assert scene.grid is grid and scene.name == "mesh" and scene.params["grid"] is grid.values
    p = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, 0.0], [3.0, 3.0, 3.0]])
    d = scene.sdf(scene.params, p)
    assert d[0] < 0 < d[1] < d[2]
    np.testing.assert_array_equal(scene.csdf(scene.params, p[:, 0], p[:, 1], p[:, 2]).numpy(),
                                  tm.grid_csdf(grid)(p[:, 0], p[:, 1], p[:, 2]).numpy())


def test_grid_from_numpy():
    vals = np.random.default_rng(3).standard_normal((5, 5, 5)).astype(np.float32)
    grid = grid_from_numpy(vals, np.float32([-1, -2, -3]), (1.5, 2, 3), "cpu")
    assert grid.values.dtype == torch.float32 and grid.resolution == 5
    np.testing.assert_array_equal(grid.values.numpy(), vals)
    assert grid.lo == (-1.0, -2.0, -3.0) and grid.hi == (1.5, 2.0, 3.0)
    assert all(type(v) is float for v in grid.lo + grid.hi)
