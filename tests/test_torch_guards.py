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
    # the ranks of the multi-device tests run without JAX too
    return sorted((ROOT / "bsdmg_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "torch_parallel_ranks.py"]


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


def test_import_scan_covers_the_composed_slice():
    """The composed scenes' modules, the node program's compiler and the
    animate verb's motion are in the scan."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {
        "bsdmg_tpu_torch/models/compose.py",
        "bsdmg_tpu_torch/models/motion.py",
        "bsdmg_tpu_torch/ops/cuda/csdf.py",
        "bsdmg_tpu_torch/mesh/export.py",
    } <= scanned


def test_import_scan_covers_the_parallel_slice():
    """The multi-device package, the graft entry and the tests' rank
    functions are in the scan."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {
        "bsdmg_tpu_torch/parallel/__init__.py",
        "bsdmg_tpu_torch/parallel/collectives.py",
        "bsdmg_tpu_torch/parallel/launch.py",
        "bsdmg_tpu_torch/parallel/mesh.py",
        "bsdmg_tpu_torch/parallel/multihost.py",
        "bsdmg_tpu_torch/parallel/sharding.py",
        "bsdmg_tpu_torch/graft_entry.py",
        "tests/torch_parallel_ranks.py",
    } <= scanned


@pytest.mark.parametrize("verb", ["render", "mesh", "session", "fit", "animate", "bench", "remesh"])
def test_cli_verbs_default_to_the_card(verb):
    from bsdmg_tpu_torch import cli

    required = {"remesh": ["-i", "asset.obj"]}.get(verb, [])
    assert cli.build_parser().parse_args([verb, *required]).device == "cuda"


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


def test_build_compiles_only_the_sources_a_change_reaches(tmp_path, monkeypatch):
    """A rebuild compiles again only the sources that include a changed
    file, directly or through a header, and links every kept object."""
    import os
    import stat
    import time

    csrc, out = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    (csrc / "deep.cuh").write_text("// a header\n")
    (csrc / "x.cuh").write_text('#include "deep.cuh"\n')
    (csrc / "a.cu").write_text('#include <cuda_runtime.h>\n#include "x.cuh"\n')
    (csrc / "b.cu").write_text("// no include\n")
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!/bin/sh\necho \"$@\" >> {log}\n"
                    'while [ "$1" != "-o" ]; do shift; done; echo built > "$2"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    monkeypatch.setattr(build, "LIBRARY", out / "lib.so")
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    assert {p.name for p in build.includes(csrc / "a.cu")} == {"a.cu", "x.cuh", "deep.cuh"}

    def compiled():
        lines = log.read_text().splitlines() if log.exists() else []
        log.unlink(missing_ok=True)
        return sorted(Path(line.split()[-1]).name for line in lines if " -c " in line)

    build.build()
    assert compiled() == ["a.cu", "b.cu"]
    assert build.build() == out / "lib.so" and compiled() == []
    later = time.time() + 5
    os.utime(csrc / "deep.cuh", (later, later))
    build.build()
    assert compiled() == ["a.cu"]
    assert sorted(p.name for p in out.glob("*.o")) == ["a.o", "b.o"]


def test_packaging_ships_kernel_sources():
    project = tomllib.loads((ROOT / "pyproject.toml").read_text())
    data = project["tool"]["setuptools"]["package-data"]["bsdmg_tpu_torch"]
    assert "csrc/*.cu" in data and "csrc/*.cuh" in data and "csrc/host/*.cpp" in data
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


def _port_modules():
    import importlib
    import pkgutil

    import bsdmg_tpu_torch

    names = [m.name for m in pkgutil.walk_packages(bsdmg_tpu_torch.__path__, "bsdmg_tpu_torch.")]
    return [importlib.import_module(name) for name in sorted(names)]


def test_entry_points_default_to_the_card():
    """Every public function, method and class of the port that takes a
    ``device`` runs on the card unless the caller names another device: its
    default, where it has one, is "cuda"."""
    import inspect

    checked, wrong = [], []
    for module in _port_modules():
        for name, obj in vars(module).items():
            if name.startswith("_") or getattr(obj, "__module__", None) != module.__name__:
                continue
            members = [(name, obj)]
            if inspect.isclass(obj):
                members += [(f"{name}.{k}", v) for k, v in vars(obj).items()
                            if inspect.isfunction(v) and not k.startswith("_")]
            for qual, fn in members:
                if not callable(fn):
                    continue
                try:
                    params = inspect.signature(fn).parameters
                except (TypeError, ValueError):
                    continue
                if "device" not in params:
                    continue
                checked.append(f"{module.__name__}.{qual}")
                default = params["device"].default
                if default is not inspect.Parameter.empty and default != "cuda":
                    wrong.append(f"{module.__name__}.{qual}: device={default!r}")
    assert not wrong, wrong
    for required in ("cam.camera.look_at", "models.scenes.default_object_params",
                     "models.scenes.reference_object", "models.scenes.reference_render_scene",
                     "models.scenes.get_scene", "models.scenes.sphere_scene",
                     "models.scenes.box_scene", "models.scenes.mandelbulb_scene",
                     "models.scenes.wrapped_object_scene", "mesh.session.MeshGenSession",
                     "models.compose.compose_scene", "models.compose.load_scene_spec",
                     "models.motion.quat_from_axis_angle", "models.motion.motion_params",
                     "models.motion.RotateAxisMotion.rotation_at",
                     "models.motion.AxisCyclicMotion.translation_at",
                     "models.motion.SphericCyclicMotion.translation_at",
                     "mesh.pipeline.remesh", "models.mesh_sdf.bake_mesh_grid",
                     "parallel.sharding.make_mesh", "parallel.mesh.generate_mesh_sharded",
                     "parallel.multihost.initialize", "parallel.multihost.local_device",
                     "parallel.multihost.default_backend", "parallel.launch.spawn",
                     "bench.benchmark_scaling", "bench.benchmark_scaling_overhead",
                     "graft_entry.entry"):
        assert f"bsdmg_tpu_torch.{required}" in checked, required
