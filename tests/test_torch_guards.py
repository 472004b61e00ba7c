"""Guards on the PyTorch port's boundaries: no JAX inside it, the same
configuration defaults as the JAX package, and a kernel build that targets
Hopper from sources in the repository."""

import ast
import dataclasses
import tomllib
from pathlib import Path

import pytest

import bsdmg_tpu.config as jax_config
import bsdmg_tpu_torch.config as torch_config
from bsdmg_tpu_torch.ops.cuda import build

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


@pytest.mark.parametrize("name", ["MarchConfig", "RenderConfig"])
def test_config_defaults_equal(name):
    ours, ref = getattr(torch_config, name), getattr(jax_config, name)
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(ours()) == dataclasses.asdict(ref())
    assert ours.__dataclass_params__.frozen


def test_build_command_targets_hopper():
    cmd = build.build_command(Path("lib.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-fmad=false" in cmd and "--use_fast_math" not in cmd
    assert any(s.endswith("render_kernel.cu") for s in cmd)
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
