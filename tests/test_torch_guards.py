"""Guards on the PyTorch port's boundaries: no JAX inside it, the same
configuration defaults as the JAX package, and a kernel build that targets
Hopper from sources in the repository."""

import ast
import dataclasses
import tomllib
from pathlib import Path

import pytest

import numpy as np

import bsdmg_tpu.config as jax_config
import bsdmg_tpu.ops.tables as jax_tables
import bsdmg_tpu_torch.config as torch_config
import bsdmg_tpu_torch.ops.tables as torch_tables
from bsdmg_tpu.mesh.weld import weld_vertices as jax_weld
from bsdmg_tpu_torch.mesh.weld import weld_vertices
from bsdmg_tpu_torch.ops.cuda import build, diff_kernel

ROOT = Path(__file__).resolve().parents[1]


def _port_sources():
    return sorted((ROOT / "bsdmg_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "bsdmg_tpu")


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    """The port and chip_smoke.py run where JAX is not installed. The check
    reads the source: the test process itself has JAX loaded."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and _forbidden(node.module or ""):
            bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_import_scan_covers_the_mesh_asset_slice():
    """The scan above globs the package: the mesh-asset modules are in it."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {
        "bsdmg_tpu_torch/models/mesh_sdf.py",
        "bsdmg_tpu_torch/ops/cuda/grid_kernel.py",
        "bsdmg_tpu_torch/mesh/export.py",
        "chip_smoke.py",
    } <= scanned


def test_import_scan_covers_the_bench_slice():
    """The bench verb's modules and K2/K3's wrapper are in the scan."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {
        "bsdmg_tpu_torch/bench.py",
        "bsdmg_tpu_torch/utils/profiling.py",
        "bsdmg_tpu_torch/ops/cuda/render_kernel.py",
        "bsdmg_tpu_torch/cli.py",
    } <= scanned


@pytest.mark.parametrize("name", ["MarchConfig", "MeshGenConfig", "RenderConfig"])
def test_config_defaults_equal(name):
    ours, ref = getattr(torch_config, name), getattr(jax_config, name)
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(ours()) == dataclasses.asdict(ref())
    assert ours.__dataclass_params__.frozen


def _table_names():
    return sorted(n for n in vars(jax_tables) if n.isupper())


@pytest.mark.parametrize("name", _table_names())
def test_tables_equal_jax(name):
    """ops/tables.py is a copy: every table equal, value and dtype."""
    ref, got = getattr(jax_tables, name), getattr(torch_tables, name)
    if isinstance(ref, np.ndarray):
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == ref.dtype
    else:
        assert got == ref
    assert sorted(n for n in vars(torch_tables) if n.isupper()) == _table_names()


@pytest.mark.parametrize("use_native", [False, True], ids=["numpy", "native"])
def test_weld_equals_jax(use_native):
    """mesh/weld.py is a copy of the JAX NumPy path; the JAX native weld
    (where built) gives the same mesh too. The soup repeats vertices, and
    some coordinates sit on exact .5 quantization ties."""
    rng = np.random.default_rng(5)
    pool = np.round(rng.uniform(-2, 2, (40, 3)), 5).astype(np.float32)
    pool[:4] = np.float32(0.125e-5)  # x * 1e5 = 0.125: rounding on the f32 product
    positions = pool[rng.integers(0, 40, (200, 3))]
    normals = rng.normal(size=(200, 3, 3)).astype(np.float32)
    got = weld_vertices(positions, normals, 1e5)
    ref = jax_weld(positions, normals, 1e5, use_native=use_native)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_build_command_targets_hopper():
    """One nvcc per source, each for sm_90a without FMA contraction or fast
    math, linked into one library; every kernel of the port is built."""
    names = [src.name for src in build.sources()]
    assert {"render_kernel.cu", "mc_kernel.cu", "project_kernel.cu", "diff_kernel.cu",
            "grid_kernel.cu"} <= set(names)
    for src in build.sources():
        cmd = build.compile_command(src, Path("x.o"))
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "-fmad=false" in cmd and "--use_fast_math" not in cmd
        assert cmd[-1].endswith(src.name) and "-c" in cmd
    link = build.link_command([Path("a.o"), Path("b.o")], Path("lib.so"))
    assert "-shared" in link and "arch=compute_90a,code=sm_90a" in link
    assert build.BUILD_DIR == ROOT / "bsdmg_tpu_torch" / "_build"


def test_gitignore_lists_build_dir():
    lines = (ROOT / ".gitignore").read_text().splitlines()
    assert "bsdmg_tpu_torch/_build/" in lines


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "LIBRARY", tmp_path / "lib.so")
    monkeypatch.setattr(build, "nvcc_path", lambda: str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


def test_packaging_ships_kernel_sources():
    project = tomllib.loads((ROOT / "pyproject.toml").read_text())
    data = project["tool"]["setuptools"]["package-data"]["bsdmg_tpu_torch"]
    assert "csrc/*.cu" in data and "csrc/*.cuh" in data
    assert "torch" in " ".join(project["project"]["optional-dependencies"]["torch"])


class _FakeFunction:
    def __init__(self, result=0):
        self.result = result

    def __call__(self, *args):
        return self.result


class _FakeLibrary:
    """Stands in for the built library: every entry point returns 0, the
    ParamScene size is ``size``."""

    def __init__(self, size):
        self.size = size

    def __getattr__(self, name):
        fn = _FakeFunction(self.size if name == "bsdmg_param_scene_size" else 0)
        setattr(self, name, fn)
        return fn


def test_diff_kernel_library_checks_param_scene_size(monkeypatch):
    """K4/K5's wrapper refuses a library whose ParamScene is not the ctypes
    mirror's size, as render_kernel.library() does for SceneDesc."""
    import ctypes

    good = ctypes.sizeof(diff_kernel._ParamSceneC)
    monkeypatch.setattr(diff_kernel, "load_library", lambda: _FakeLibrary(good))
    assert diff_kernel.library().bsdmg_param_scene_size() == good
    monkeypatch.setattr(diff_kernel, "load_library", lambda: _FakeLibrary(good + 4))
    with pytest.raises(RuntimeError, match="ParamScene layout mismatch"):
        diff_kernel.library()
