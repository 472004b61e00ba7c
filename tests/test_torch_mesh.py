"""The port's mesh-generation slice against the JAX package.

* refinement: the survivor sets of ``refine_field`` equal the JAX package's
  as sorted sets, level by level (the order differs: the JAX package
  compacts by sorting, the port by ``torch.nonzero``);
* marching cubes: ``field_to_triangles`` on the same voxels as the JAX
  package's XLA path, for each projection, winding, budget and vertex
  placement option: validity exactly, positions within 2e-5, normals within
  2e-4 (tests/test_mesh.py:314-320);
* the whole slice: ``cli mesh --device cpu`` against JAX ``generate_mesh``
  with the same triangle and vertex counts, vertex sets within 2e-5 and the
  same faces (as triples of matched vertices, winding included);
* checkpoints and mesh files pass between the packages.
"""

import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from bsdmg_tpu.config import MeshGenConfig as JaxMeshGenConfig
from bsdmg_tpu.mesh import create_voxel_field as jax_create_field
from bsdmg_tpu.mesh import generate_mesh as jax_generate_mesh
from bsdmg_tpu.mesh import refine_field as jax_refine_field
from bsdmg_tpu.mesh.export import load_field as jax_load_field
from bsdmg_tpu.mesh.export import save_field as jax_save_field
from bsdmg_tpu.mesh.export import save_obj as jax_save_obj
from bsdmg_tpu.mesh.export import save_vtk as jax_save_vtk
from bsdmg_tpu.mesh.pipeline import field_to_triangles as jax_field_to_triangles
from bsdmg_tpu.models import reference_object as jax_object
from bsdmg_tpu.ops.compact import compact as jax_compact
from bsdmg_tpu.ops.pallas import compile_scene_csdf
from bsdmg_tpu.ops.refine import child_lowers as jax_child_lowers
from bsdmg_tpu.ops.refine import refine_masks as jax_refine_masks
from bsdmg_tpu_torch import cli
from bsdmg_tpu_torch.config import MeshGenConfig
from bsdmg_tpu_torch.mesh import export
from bsdmg_tpu_torch.mesh.field import create_voxel_field, refine_field
from bsdmg_tpu_torch.mesh.pipeline import Mesh, field_to_triangles
from bsdmg_tpu_torch.models import reference_object
from bsdmg_tpu_torch.ops.compact import compact
from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene, descriptor_csdf
from bsdmg_tpu_torch.ops.refine import child_lowers, refine_masks
from bsdmg_tpu_torch.weights import field_from_numpy

# one intra-op thread: PyTorch's spinning OpenMP pool would otherwise take
# every core from the timing-sensitive tests that run beside these
torch.set_num_threads(1)

INIT = 16
LEVELS = 2


def _sorted_rows(a: np.ndarray) -> np.ndarray:
    return a[np.lexsort(a.T[::-1])]


@pytest.fixture(scope="module")
def jax_fields():
    scene = jax_object()
    csdf = compile_scene_csdf(scene)
    cfg = JaxMeshGenConfig(init_factor=INIT)
    fields = [jax_create_field(cfg)]
    for _ in range(LEVELS):
        fields.append(jax_refine_field(scene.bind(), fields[-1], cfg, csdf=csdf))
    return fields


@pytest.fixture(scope="module")
def port_fields():
    desc = compile_scene(reference_object(device="cpu"))
    cfg = MeshGenConfig(init_factor=INIT)
    fields = [create_voxel_field(cfg, "cpu")]
    for _ in range(LEVELS):
        fields.append(refine_field(desc, fields[-1]))
    return fields


@pytest.mark.parametrize("level", range(LEVELS + 1))
def test_refine_survivor_sets_equal_jax(jax_fields, port_fields, level):
    ref, got = jax_fields[level], port_fields[level]
    assert got.count == ref.count > 0
    assert (got.voxel_size, got.level) == (ref.voxel_size, ref.level)
    np.testing.assert_array_equal(_sorted_rows(got.to_numpy()), _sorted_rows(ref.to_numpy()))


def test_children_and_masks_match_jax(jax_fields):
    field = jax_fields[1]
    lowers = np.array(field.to_numpy())
    np.testing.assert_array_equal(
        child_lowers(torch.from_numpy(lowers), field.voxel_size).numpy(),
        np.asarray(jax_child_lowers(jnp.asarray(lowers), field.voxel_size)),
    )
    csdf = descriptor_csdf(compile_scene(reference_object(device="cpu")))
    got = refine_masks(csdf, torch.from_numpy(lowers), field.voxel_size)
    scene = jax_object()
    ref = jax_refine_masks(
        scene.bind(), jnp.asarray(lowers), field.voxel_size, jnp.ones(len(lowers), bool),
        csdf=compile_scene_csdf(scene),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.any() and not got.all()


def test_compact_keeps_order_like_jax():
    rng = np.random.default_rng(1)
    data = rng.normal(size=(300, 3)).astype(np.float32)
    mask = rng.random(300) < 0.3
    got, count = compact(torch.from_numpy(data), torch.from_numpy(mask))
    ref, ref_count = jax_compact(jnp.asarray(data), jnp.asarray(mask))
    assert count == int(ref_count)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref)[:count])


EXTRACT_VARIANTS = {
    "default": {},
    "fd4 projection": dict(projection_normals="fd4"),
    "centroid winding": dict(winding_normals="centroid_fd4"),
    "budget 12": dict(edge_budget=12),
    "interpolate edges": dict(interpolate_edges=True),
}


@pytest.mark.parametrize("variant", sorted(EXTRACT_VARIANTS))
def test_field_to_triangles_matches_jax(jax_fields, variant):
    """K6's twin (or K7's, with interpolated edges) on the JAX package's own
    level-1 voxels, against its XLA path."""
    options = EXTRACT_VARIANTS[variant]
    field = jax_fields[1]
    scene = jax_object()
    ref = jax_field_to_triangles(
        scene.bind(), field, JaxMeshGenConfig(init_factor=INIT, **options),
        csdf=compile_scene_csdf(scene),
    )
    port_field = field_from_numpy(field.to_numpy(), field.voxel_size, field.level, "cpu")
    got = field_to_triangles(
        compile_scene(reference_object(device="cpu")), port_field, MeshGenConfig(init_factor=INIT, **options)
    )
    n = field.count
    assert got.edge_overflow == int(ref.edge_overflow) == 0
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid)[:n])
    assert int(got.valid.sum()) > 0
    np.testing.assert_allclose(got.positions.numpy(), np.asarray(ref.positions)[:n], atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.normals.numpy(), np.asarray(ref.normals)[:n], atol=2e-4, rtol=0)


def _read_obj(path):
    v, vn, f = [], [], []
    for line in open(path):
        parts = line.split()
        if parts and parts[0] in ("v", "vn"):
            (v if parts[0] == "v" else vn).append([float(x) for x in parts[1:]])
        elif parts and parts[0] == "f":
            f.append([int(p.split("//")[0]) - 1 for p in parts[1:]])
    return np.asarray(v, np.float32), np.asarray(vn, np.float32), np.asarray(f, np.int64)


def _canonical_faces(faces: np.ndarray) -> set:
    """Faces as vertex triples rotated to start at their smallest index:
    the same set means the same triangles with the same winding."""
    out = set()
    for tri in faces.tolist():
        k = tri.index(min(tri))
        out.add(tuple(tri[k:] + tri[:k]))
    return out


def assert_same_mesh(vertices, faces, ref_vertices, ref_faces, atol=2e-5):
    assert len(vertices) == len(ref_vertices) and len(faces) == len(ref_faces)
    dist, match = cKDTree(ref_vertices).query(vertices)
    assert dist.max() <= atol, dist.max()
    assert len(set(match.tolist())) == len(vertices)
    assert _canonical_faces(match[faces]) == _canonical_faces(ref_faces)


@pytest.mark.parametrize("interpolate", [False, True], ids=["midpoints", "interpolate-edges"])
def test_cli_mesh_matches_jax_generate_mesh(tmp_path, interpolate):
    out = tmp_path / "mesh.obj"
    argv = ["mesh", "--device", "cpu", "--init-factor", str(INIT), "--refine", "1", "-o", str(out)]
    assert cli.main(argv + (["--interpolate-edges"] if interpolate else [])) == 0
    v, vn, f = _read_obj(out)
    scene = jax_object()
    cfg = JaxMeshGenConfig(init_factor=INIT, interpolate_edges=interpolate)
    ref = jax_generate_mesh(scene.bind(), 1, cfg, csdf=compile_scene_csdf(scene))
    assert ref.triangle_count > 1000
    assert_same_mesh(v, f, ref.vertices, ref.faces.astype(np.int64))
    assert vn.shape == v.shape
    np.testing.assert_allclose(np.linalg.norm(vn, axis=1), 1.0, atol=1e-5)


def test_resume_from_jax_checkpoint(tmp_path, jax_fields):
    """A JAX ``save_field`` checkpoint resumed by the port gives the mesh of
    an uninterrupted port run; the port's own checkpoint loads in the JAX
    package."""
    ckpt = tmp_path / "jax.L1.npz"
    jax_save_field(jax_fields[1], ckpt)
    resumed, whole = tmp_path / "resumed.obj", tmp_path / "whole.obj"
    common = ["mesh", "--device", "cpu", "--init-factor", str(INIT)]
    assert cli.main(common + ["--resume", str(ckpt), "--refine", "1", "-o", str(resumed),
                              "--checkpoint", str(tmp_path / "port")]) == 0
    assert cli.main(common + ["--refine", "2", "-o", str(whole)]) == 0
    v, _, f = _read_obj(resumed)
    rv, _, rf = _read_obj(whole)
    assert_same_mesh(v, f, rv, rf, atol=0.0)

    back = jax_load_field(tmp_path / "port.L2.npz")
    assert back.level == 2 and back.voxel_size == jax_fields[2].voxel_size
    np.testing.assert_array_equal(_sorted_rows(back.to_numpy()), _sorted_rows(jax_fields[2].to_numpy()))


def test_mesh_files_match_jax_writers(tmp_path):
    scene = jax_object()
    ref = jax_generate_mesh(scene.bind(), 0, JaxMeshGenConfig(init_factor=8), csdf=compile_scene_csdf(scene))
    mesh = Mesh(ref.vertices, ref.normals, ref.faces)
    for ours, theirs, name in ((export.save_obj, jax_save_obj, "m.obj"), (export.save_vtk, jax_save_vtk, "m.vtk")):
        if theirs is jax_save_obj:
            # the Python writers; the native ones are held in tests/test_torch_native.py
            ours(mesh, tmp_path / f"port_{name}", use_native=False)
            theirs(ref, tmp_path / f"jax_{name}", use_native=False)
        else:
            ours(mesh, tmp_path / f"port_{name}")
            theirs(ref, tmp_path / f"jax_{name}")
        assert (tmp_path / f"port_{name}").read_bytes() == (tmp_path / f"jax_{name}").read_bytes()


def test_cli_mesh_logs_levels_and_writes_vtk(tmp_path, caplog):
    out = tmp_path / "mesh.vtk"
    with caplog.at_level(logging.INFO, logger="bsdmg_tpu_torch"):
        assert cli.main(["mesh", "--device", "cpu", "--init-factor", "8", "--refine", "1", "-o", str(out)]) == 0
    levels = [r.getMessage() for r in caplog.records if r.getMessage().startswith("level ")]
    assert levels[0] == "level 0: 512 voxels of size 0.62500" and len(levels) == 2
    assert out.read_text().startswith("# vtk DataFile Version 3.0\nbsdmg_tpu mesh\n")


def test_cli_mesh_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["mesh", "--init-factor", "8", "--refine", "0", "-o", str(tmp_path / "m.obj")])


#: composed specs beyond the small tier of the kernels' interpreters
#: (ops/cuda/csdf.py::large_tier): a union of 40 spheres, 79 instructions
#: where the small tier takes 64; ten nested transforms, 10 frames where it
#: takes 8; a right-nested union of 18 spheres, 18 values on the stack where
#: it takes 16
DEEP = {"name": "deep", "root": {"op": "union", "children": [
    {"prim": "sphere", "center": [-1.6 + 0.8 * (i % 5), -1.4 + 0.4 * (i // 5),
                                  0.3 * ((i * 7) % 3) - 0.3],
     "radius": 0.22 + 0.01 * (i % 4)} for i in range(40)]}}
NESTED = {"op": "union", "children": [
    {"prim": "torus", "major_radius": 0.8, "minor_radius": 0.3},
    {"prim": "capsule", "start": [-0.6, 0.0, 0.0], "end": [0.6, 0.7, 0.0], "radius": 0.3},
    {"prim": "sphere", "center": [0.7, 0.5, 0.0], "radius": 0.45}]}
for _ in range(10):
    NESTED = {"op": "transform", "offset": [0.06, -0.03, 0.02],
              "rotation": [0.9950042, 0.0, 0.0998334, 0.0], "child": NESTED}
NESTED = {"name": "nested", "root": NESTED}
RIGHT_NESTED = {"prim": "sphere", "center": [1.5, 0.0, 0.0], "radius": 0.3}
for _i in range(17):
    RIGHT_NESTED = {"op": "union", "children": [
        {"prim": "sphere", "center": [-1.5 + 0.17 * _i, 0.4 * float(np.sin(_i)), 0.0],
         "radius": 0.25}, RIGHT_NESTED]}
RIGHT_NESTED = {"name": "right-nested", "root": RIGHT_NESTED}
LARGE_SPECS = {"deep": DEEP, "nested": NESTED, "right-nested": RIGHT_NESTED}


@pytest.mark.parametrize(
    "argv, spec", [(["--sharded"], "deep"), ([], "nested"), ([], "deep")],
    ids=["sharded", "unported scene", "composed scene"],
)
def test_cli_mesh_unported_options_raise(tmp_path, argv, spec, own_world):
    """Composed specs beyond the small tier, which raised here before, mesh
    in the kernels' large tier: ``cli mesh --device cpu`` of the 40-sphere
    union and of the ten nested transforms, and ``--sharded`` of the union
    (a world of one), against JAX's ``generate_mesh``: triangle counts
    equal, vertices within 1e-4 and the same faces (tests/
    test_torch_compose.py's bars for a spec's CLI mesh)."""
    from bsdmg_tpu.models.compose import compose_scene as jax_compose_scene
    from bsdmg_tpu_torch.mesh.export import load_obj

    path = tmp_path / f"{spec}.json"
    path.write_text(json.dumps(LARGE_SPECS[spec]))
    out = tmp_path / "m.obj"
    assert cli.main(["mesh", "--device", "cpu", "--scene", str(path), "--init-factor", "8",
                     "--refine", "1", "-o", str(out), *argv]) == 0
    jscene = jax_compose_scene(json.loads(path.read_text()))
    ref = jax_generate_mesh(jscene.bind(), 1, JaxMeshGenConfig(init_factor=8),
                            csdf=compile_scene_csdf(jscene))
    assert ref.triangle_count > 100
    mesh = load_obj(out)
    assert_same_mesh(mesh.vertices, mesh.faces.astype(np.int64), ref.vertices,
                     np.asarray(ref.faces).astype(np.int64), atol=1e-4)


@pytest.fixture
def own_world():
    """A test that forms a world of one in this process leaves none behind."""
    import torch.distributed as dist

    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_field_from_numpy_round_trip(jax_fields):
    field = jax_fields[2]
    got = field_from_numpy(field.to_numpy(), np.float32(field.voxel_size), np.int32(2), "cpu")
    assert got.lowers.dtype == torch.float32 and got.count == field.count
    assert (got.voxel_size, got.level) == (field.voxel_size, 2)
    np.testing.assert_array_equal(got.to_numpy(), field.to_numpy())

