"""The port's public surface against the JAX package's: every name in a
JAX subpackage's ``__all__`` has a counterpart in the same subpackage of
``bsdmg_tpu_torch``, and every module of the JAX package has a counterpart
module. ``ops.pallas`` maps to ``ops.cuda`` (its ``mc_fused`` module to
``mc_kernel``, its ``compile_scene_csdf`` and ``sphere_trace_pallas`` to
``compile_scene`` and ``sphere_trace_cuda``); the one module left out is
``ops/pallas/mathx.py``, polynomial ``acos``/``atan``/``atan2`` for Mosaic,
which has none (libdevice and PyTorch have them).
"""

import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

SUBPACKAGES = ["", "cam", "grad", "mesh", "models", "ops", "ops.pallas", "parallel", "runtime",
               "sdf", "utils"]
#: the JAX subpackage's counterpart, where its name differs
PACKAGE_OF = {"ops.pallas": "ops.cuda"}
#: the counterpart of a JAX name, where its name differs
NAME_OF = {("ops.pallas", "compile_scene_csdf"): "compile_scene",
           ("ops.pallas", "sphere_trace_pallas"): "sphere_trace_cuda"}
#: the counterpart of a JAX module file, where its path differs
MODULE_OF = {"ops/pallas/mc_fused.py": "ops/cuda/mc_kernel.py"}
#: the JAX modules with no counterpart, and why
LEFT_OUT = {"ops/pallas/mathx.py": "polynomial inverse trig for Mosaic; libdevice has it"}


def _module(package: str, sub: str):
    return importlib.import_module(package + (f".{sub}" if sub else ""))


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_public_name_has_a_counterpart(sub):
    jax_names = _module("bsdmg_tpu", sub).__all__
    port_sub = PACKAGE_OF.get(sub, sub)
    port = _module("bsdmg_tpu_torch", port_sub)
    missing = [n for n in jax_names if not hasattr(port, NAME_OF.get((sub, n), n))]
    assert not missing, f"bsdmg_tpu_torch.{port_sub} lacks {missing}"
    exported = getattr(port, "__all__", None)
    assert exported is not None, f"bsdmg_tpu_torch.{port_sub} has no __all__"
    assert {NAME_OF.get((sub, n), n) for n in jax_names} <= set(exported)
    assert all(hasattr(port, n) for n in exported)


JAX_MODULES = sorted(str(p.relative_to(ROOT / "bsdmg_tpu"))
                     for p in (ROOT / "bsdmg_tpu").rglob("*.py"))


@pytest.mark.parametrize("path", JAX_MODULES)
def test_every_module_has_a_counterpart(path):
    if path in LEFT_OUT:
        assert not (ROOT / "bsdmg_tpu_torch" / path.replace("pallas", "cuda")).exists()
        return
    ours = MODULE_OF.get(path, path.replace("ops/pallas/", "ops/cuda/"))
    assert (ROOT / "bsdmg_tpu_torch" / ours).is_file(), f"no bsdmg_tpu_torch/{ours}"
    importlib.import_module("bsdmg_tpu_torch." + ours.removesuffix(".py").replace("/", ".")
                            .removesuffix(".__init__"))
