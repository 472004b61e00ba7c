"""The port's session verb and stage machine (mesh/session.py) against the
JAX CLI's ``session`` (bsdmg_tpu/cli.py:691-725), at init factor 8 on the
CPU: the same stage sequence and log of voxel counts, message for message,
and the same mesh as canonical faces. As the JAX CLI's, the session meshes
the scene it is named: the render scene with its wireframe."""

import logging

import numpy as np
import pytest

from bsdmg_tpu import cli as jax_cli
from bsdmg_tpu_torch import cli
from bsdmg_tpu_torch.config import MeshGenConfig
from bsdmg_tpu_torch.mesh import export
from bsdmg_tpu_torch.mesh.session import MeshGenSession, Stage
from bsdmg_tpu_torch.models import reference_object
from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene
from test_torch_mesh import assert_same_mesh

SCRIPTS = {
    "keys vbbbvv": ["--keys", "vbbbvv"],
    "commands": ["--commands", "refine,advance,refine,refine,advance,refine,advance"],
}


def _messages(caplog, logger: str, path) -> list[str]:
    return [r.getMessage().replace(str(path), "OUT") for r in caplog.records if r.name == logger]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX CLI's session per script: its log messages and mesh."""
    out = {}
    for name, argv in SCRIPTS.items():
        path = tmp_path_factory.mktemp("jax") / "session.obj"
        handler = _Capture()
        logger = logging.getLogger("bsdmg")
        logger.addHandler(handler)
        level = logger.level
        logger.setLevel(logging.INFO)
        try:
            jax_cli.main(["session", "--init-factor", "8", *argv, "-o", str(path)])
        finally:
            logger.removeHandler(handler)
            logger.setLevel(level)
        out[name] = ([m.replace(str(path), "OUT") for m in handler.messages],
                     export.load_obj(path, use_native=False))
    return out


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_session_matches_jax_cli(script, jax_runs, tmp_path, caplog):
    path = tmp_path / "session.obj"
    with caplog.at_level(logging.INFO, logger="bsdmg_tpu_torch"):
        assert cli.main(["session", "--device", "cpu", "--init-factor", "8", *SCRIPTS[script],
                         "-o", str(path)]) == 0
    messages = _messages(caplog, "bsdmg_tpu_torch", path)
    ref_messages, ref_mesh = jax_runs[script]
    assert messages == ref_messages
    assert any(m.startswith("refined field: ") for m in messages)
    assert messages[-2:] == ["saved OUT; session reset", "final stage: empty"]
    mesh = export.load_obj(path)
    assert mesh.triangle_count > 1000
    assert_same_mesh(mesh.vertices, mesh.faces.astype(np.int64), ref_mesh.vertices,
                     ref_mesh.faces.astype(np.int64))


def test_refine_outside_a_voxel_field_warns_and_does_nothing(tmp_path, caplog):
    session = MeshGenSession(compile_scene(reference_object(device="cpu")),
                             MeshGenConfig(init_factor=8), output_path=str(tmp_path / "m.obj"),
                             device="cpu")
    with caplog.at_level(logging.INFO, logger="bsdmg_tpu_torch"):
        session.refine()
    assert session.stage is Stage.EMPTY and session.field is None
    assert [(r.levelname, r.getMessage()) for r in caplog.records] == [
        ("WARNING", "refine ignored: no voxel field present (stage=empty)")]
    session.advance()
    assert session.stage is Stage.VOXEL_FIELD and session.preview.triangle_count > 0
    session.advance()
    assert session.stage is Stage.MESH
    session.refine()  # ignored in MESH too
    assert session.stage is Stage.MESH and session.field.level == 0
    session.advance()
    assert session.stage is Stage.EMPTY and (tmp_path / "m.obj").is_file()


def test_session_rejects_unknown_commands(tmp_path):
    with pytest.raises(SystemExit):
        cli.main(["session", "--device", "cpu", "--commands", "refine,explode",
                  "-o", str(tmp_path / "m.obj")])
