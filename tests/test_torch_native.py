"""The port's native host runtime (bsdmg_tpu_torch/runtime/native.py) against
its NumPy and Python twins and the JAX package's.

* the weld: face for face equal to the port's NumPy weld and to the JAX
  package's (both paths), on a soup whose coordinates repeat and sit on
  exact .5 quantization ties;
* the OBJ writer: line for line the Python writer's, but the header;
* the OBJ reader: equal to ``load_obj(use_native=False)``, with negative
  indices, the ``a/b/c`` forms and polygon fans;
* the build: g++ at first use into the build directory, again when the
  source is newer, safely from several threads at once, and a failed build
  raises (no fallback);
* ``csrc/host/bsdmg_native.cpp`` is a byte-for-byte copy of the JAX
  package's ``native/bsdmg_native.cpp``.
"""

import os
import threading
from pathlib import Path

import numpy as np
import pytest

from bsdmg_tpu.mesh.export import load_obj as jax_load_obj
from bsdmg_tpu.mesh.weld import weld_vertices as jax_weld
from bsdmg_tpu_torch import cli
from bsdmg_tpu_torch.mesh import export
from bsdmg_tpu_torch.mesh.pipeline import Mesh
from bsdmg_tpu_torch.mesh.weld import weld_vertices
from bsdmg_tpu_torch.runtime import native

ROOT = Path(__file__).resolve().parents[1]
HEADER = "# bsdmg_tpu generated mesh (native writer)"


def test_source_is_a_copy_of_the_jax_package_s():
    assert native.SOURCE.read_bytes() == (ROOT / "native" / "bsdmg_native.cpp").read_bytes()
    assert native.SOURCE == ROOT / "bsdmg_tpu_torch" / "csrc" / "host" / "bsdmg_native.cpp"


def _tie_soup(seed=5, pool_size=40, triangles=200):
    """test_torch_guards.py::test_weld_equals_jax's soup: repeated vertices,
    four of them on the .5 tie of the float32 product."""
    rng = np.random.default_rng(seed)
    pool = np.round(rng.uniform(-2, 2, (pool_size, 3)), 5).astype(np.float32)
    pool[:4] = np.float32(0.125e-5)
    positions = pool[rng.integers(0, pool_size, (triangles, 3))]
    normals = rng.normal(size=(triangles, 3, 3)).astype(np.float32)
    return positions, normals


@pytest.mark.parametrize("reference", ["port numpy", "jax numpy", "jax native"])
def test_native_weld_equals(reference):
    positions, normals = _tie_soup()
    got = native.weld_vertices_native(positions, normals, 1e5)
    if reference == "port numpy":
        ref = weld_vertices(positions, normals, 1e5, use_native=False)
    else:
        ref = jax_weld(positions, normals, 1e5, use_native=reference == "jax native")
    assert len(got[0]) < len(positions.reshape(-1, 3))  # the soup welds
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_weld_defaults_to_native_and_welds_empty_soups():
    positions, normals = _tie_soup(seed=2)
    for a, b in zip(weld_vertices(positions, normals), native.weld_vertices_native(positions, normals)):
        np.testing.assert_array_equal(a, b)
    empty = np.zeros((0, 3, 3), np.float32)
    v, n, f = weld_vertices(empty, empty)
    assert v.shape == n.shape == f.shape == (0, 3) and f.dtype == np.int32


def _mesh(seed=3):
    rng = np.random.default_rng(seed)
    positions, normals = _tie_soup(seed=seed)
    positions[0, 0] = (-0.0, -1e-9, 123.4567895)  # signed zero, a negative that prints as -0
    v, n, f = weld_vertices(positions, normals, use_native=False)
    return Mesh(vertices=v, normals=n * rng.uniform(0.5, 2.0, (len(n), 1)).astype(np.float32),
                faces=f)


def test_writer_matches_python_writer_line_for_line(tmp_path):
    mesh = _mesh()
    export.save_obj(mesh, tmp_path / "native.obj")
    export.save_obj(mesh, tmp_path / "python.obj", use_native=False)
    ours = (tmp_path / "native.obj").read_text().splitlines()
    theirs = (tmp_path / "python.obj").read_text().splitlines()
    assert ours[0] == HEADER and theirs[0] == "# bsdmg_tpu generated mesh"
    assert ours[1:] == theirs[1:]
    assert len(ours) == 1 + 2 * mesh.vertex_count + mesh.triangle_count


def test_writer_raises_on_a_path_it_cannot_write(tmp_path):
    with pytest.raises(OSError):
        export.save_obj(_mesh(), tmp_path / "no_such_dir" / "m.obj")


OBJ_CASES = {
    "fans and forms": [
        "# comment", "v 0 0 0", "v 1 0 0", "v 1 1 0", "v 0 1 0", "v 0 0 1",
        "vn 0 0 1", "vn 0 0 1", "vn 0 0 1", "vn 0 0 1", "vn 0 0 1",
        "f 1 2 3 4", "f 1//1 2//2 5//5", "f 1/1/1 3/2/3 4/3/4 5/4/5 2/5/2",
        "f -5/-5/-5 -4/-4/-4 -1/-1/-1", "usemtl whatever", "vt 0.5 0.5",
    ],
    "negative indices, no normals": [
        "v 0.1 0.2 0.3", "v -1.5 2.25 1e-3", "v 3.0000005 -0.0 7", "f -3 -2 -1",
        "v 1 1 1", "f 1/7 -1/8 2/9", "f -4 -3 -2 -1",
    ],
    "normals not one per vertex": [
        "v 0 0 0", "v 1 0 0", "v 0 1 0", "vn 0 0 1", "f 1//1 2//1 3//1",
    ],
}


@pytest.mark.parametrize("case", sorted(OBJ_CASES))
def test_reader_matches_python_reader(case, tmp_path):
    path = tmp_path / "case.obj"
    path.write_text("\n".join(OBJ_CASES[case]) + "\n")
    got = export.load_obj(path)
    ref = export.load_obj(path, use_native=False)
    jax_ref = jax_load_obj(path, use_native=False)
    assert got.triangle_count > 0
    for name in ("vertices", "normals", "faces"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
        np.testing.assert_array_equal(getattr(ref, name), getattr(jax_ref, name))
        assert getattr(got, name).dtype == getattr(ref, name).dtype


def test_reader_reads_what_the_writer_wrote(tmp_path):
    mesh = _mesh(seed=4)
    export.save_obj(mesh, tmp_path / "m.obj")
    back = export.load_obj(tmp_path / "m.obj")
    np.testing.assert_array_equal(back.faces, mesh.faces)
    np.testing.assert_allclose(back.vertices, mesh.vertices, atol=5e-7)
    np.testing.assert_allclose(back.normals, mesh.normals, atol=5e-7)
    with pytest.raises(OSError):
        export.load_obj(tmp_path / "missing.obj")


def test_cli_mesh_writes_the_native_obj(tmp_path):
    out = tmp_path / "m.obj"
    assert cli.main(["mesh", "--device", "cpu", "--init-factor", "8", "--refine", "1",
                     "-o", str(out)]) == 0
    lines = out.read_text().splitlines()
    assert lines[0] == HEADER and sum(line.startswith("f ") for line in lines) > 0


def _private_build(monkeypatch, tmp_path):
    """Point the build at an empty directory and forget the loaded library."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "libbsdmg_native.so")
    native.library.cache_clear()


def test_failed_build_raises(monkeypatch, tmp_path):
    _private_build(monkeypatch, tmp_path)
    monkeypatch.setenv("CXX", "false")
    try:
        with pytest.raises(RuntimeError, match="exit code 1"):
            native.weld_vertices_native(*_tie_soup())
        assert not native.LIBRARY.exists() and not list(tmp_path.glob("*.partial"))
        monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
        with pytest.raises(RuntimeError, match="not found"):
            native.build()
    finally:
        native.library.cache_clear()


def test_build_at_first_use_from_several_threads_and_again_when_stale(monkeypatch, tmp_path):
    _private_build(monkeypatch, tmp_path)
    assert native.FLAGS == ("-O3", "-ffp-contract=off", "-shared", "-fPIC")
    errors = []

    def build():
        try:
            native.build()
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and native.LIBRARY.exists()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["libbsdmg_native.so"]
    try:
        positions, normals = _tie_soup()
        for a, b in zip(native.weld_vertices_native(positions, normals),
                        weld_vertices(positions, normals, use_native=False)):
            np.testing.assert_array_equal(a, b)
    finally:
        native.library.cache_clear()
    built = native.LIBRARY.stat().st_mtime
    assert native.build() == native.LIBRARY and native.LIBRARY.stat().st_mtime == built
    os.utime(native.LIBRARY, (built - 3600, native.SOURCE.stat().st_mtime - 1))
    native.build()
    assert native.LIBRARY.stat().st_mtime > native.SOURCE.stat().st_mtime
