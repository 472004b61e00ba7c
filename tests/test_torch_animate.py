"""``cli animate``, ``models/motion.py`` and ``save_gif`` against the JAX
package, on the CPU.

* The motion components, ``set_center``, ``apply_motion`` and
  ``motion_params`` at seeded times: within 1e-6 (``sin`` and ``cos`` of
  XLA and of PyTorch may differ in the last bit).
* The frames of ``cli animate`` at 32x18, 3 frames: a camera orbit (the
  gadget, a composed scene), the reference object's motion (``--rotate
  --motion spheric`` and ``--motion axis`` on the default scene, a
  descriptor per frame with the object transform) and a composed scene's
  (the gadget under a root ``transform``), against the JAX CLI's frames
  (its orbit through the XLA render, its motion through the param-traced
  ``render_image_c``), and the wrapped object's ``--motion axis`` (a
  descriptor per frame whose object transform selects the kernels'
  ``Wrapped<Box<false, true>>``): each channel of each pixel within 2 of
  255, and the mean difference under 0.05 of a level (the renders' bars of
  ``tests/test_torch_render_kernel.py``, after rounding to 8 bits).
* The warnings of a motion the scene cannot take, as the JAX CLI's.
* ``save_gif``: a GIF that Pillow reads back with the frames and their
  count; without Pillow, the JAX package's ``RuntimeError``.
"""

import builtins
import json
import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsdmg_tpu import cli as jax_cli
from bsdmg_tpu.models import motion as jmotion
from bsdmg_tpu_torch import cli
from bsdmg_tpu_torch.mesh.export import save_gif
from bsdmg_tpu_torch.models import motion as tmotion

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TIMES = np.random.default_rng(7).uniform(0.0, 12.0, 6).astype(np.float32)


def _close(got, ref, atol=1e-6):
    np.testing.assert_allclose(got.cpu().numpy(), np.asarray(ref), atol=atol, rtol=0)


@pytest.mark.parametrize("t", TIMES.tolist())
def test_motions_match_jax(t):
    _close(tmotion.quat_from_axis_angle((0.3, -1.0, 0.5), t, device="cpu"),
           jmotion.quat_from_axis_angle((0.3, -1.0, 0.5), t))
    rot = dict(axis=(1.0, 2.0, -0.5), cycle_duration=3.5)
    _close(tmotion.RotateAxisMotion(**rot).rotation_at(t, device="cpu"),
           jmotion.RotateAxisMotion(**rot).rotation_at(t))
    sph = dict(center=(0.5, -1.0, 2.0), distances=(1.0, 0.5, 2.0), cycle_durations=(5.0, 3.0, 7.0))
    _close(tmotion.SphericCyclicMotion(**sph).translation_at(t, device="cpu"),
           jmotion.SphericCyclicMotion(**sph).translation_at(t))
    axis = dict(direction=(0.0, 1.0, 1.0), cycle_duration=4.0)
    _close(tmotion.AxisCyclicMotion(**axis).translation_at(t, device="cpu"),
           jmotion.AxisCyclicMotion(**axis).translation_at(t))
    base = dict(object_center=[0.2, 0.1, -0.3], object_rotation=[0.9, 0.1, 0.3, 0.2], k=[1.0])
    for kw in (dict(rotate_axis=True), dict(axis_cyclic=True, spheric_cyclic=True),
               dict(spheric_cyclic=True, rotate_axis=True, enable_movement=False)):
        parts = {"axis_cyclic": "AxisCyclicMotion", "spheric_cyclic": "SphericCyclicMotion",
                 "rotate_axis": "RotateAxisMotion"}
        tk = {k: getattr(tmotion, v)() for k, v in parts.items() if kw.get(k)}
        jk = {k: getattr(jmotion, v)() for k, v in parts.items() if kw.get(k)}
        gate = kw.get("enable_movement", True)
        got = tmotion.motion_params({k: torch.tensor(v) for k, v in base.items()}, t,
                                    enable_movement=gate, device="cpu", **tk)
        ref = jmotion.motion_params({k: jnp.asarray(v) for k, v in base.items()}, t,
                                    enable_movement=gate, **jk)
        assert sorted(got) == sorted(ref)
        for k in got:
            _close(got[k], ref[k])


def test_moved_wrapped_object_takes_its_own_structure():
    """The frames of ``animate --motion axis --scene wrapped_object`` after
    the first compile to the wrapped object with an object transform: the
    kernels' structure 11, ``Wrapped<Box<false, true>>`` (the lattice point
    wrapped first, then the transform, as the JAX package's ``_sd_obj_c``
    takes them); its twin equals the JAX scene's SDF within 1e-5."""
    from bsdmg_tpu.models import get_scene as jax_get_scene
    from bsdmg_tpu_torch.models import get_scene
    from bsdmg_tpu_torch.ops.cuda import csdf as tcsdf
    from bsdmg_tpu_torch.ops.cuda import render_kernel

    scene = get_scene("wrapped_object", device="cpu")
    view = {k: scene.params[k] for k in ("object_center", "object_rotation")}
    moved = tmotion.motion_params(view, 1.3, axis_cyclic=tmotion.AxisCyclicMotion(),
                                  rotate_axis=tmotion.RotateAxisMotion(), device="cpu")
    params = dict(scene.params, **moved)
    desc = tcsdf.compile_scene(scene, params)
    assert tcsdf.kernel_structure(desc) == tcsdf.WRAPPED_MOVED == 11
    assert render_kernel.scene_desc_c(desc, device="cpu").structure == 11
    assert tcsdf.kernel_structure(tcsdf.compile_scene(scene)) == tcsdf.WRAPPED
    pts = np.random.default_rng(11).uniform(-12.0, 12.0, (4096, 3)).astype(np.float32)
    ours = tcsdf.descriptor_csdf(desc)(*(torch.from_numpy(pts[:, a]) for a in range(3)))
    jscene = jax_get_scene("wrapped_object")
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    ref = jax.jit(lambda q, p: jscene.csdf(q, *p.T))(jparams, jnp.asarray(pts))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_set_center_and_identity_match_jax():
    moved = tmotion.Transform.from_translation([1.0, 2.0, 3.0], device="cpu")
    ref = jmotion.set_center(jmotion.AxisCyclicMotion(),
                             jmotion.Transform.from_translation([1.0, 2.0, 3.0]))
    got = tmotion.set_center(tmotion.AxisCyclicMotion(), moved)
    assert got.center == ref.center == (1.0, 2.0, 3.0)
    assert tmotion.set_center(tmotion.RotateAxisMotion(), moved) == tmotion.RotateAxisMotion()
    ident = tmotion.Transform.identity(device="cpu")
    _close(ident.translation, jmotion.Transform.identity().translation)
    _close(ident.rotation, jmotion.Transform.identity().rotation)


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path)).astype(np.int32)


def _moving_spec(tmp_path):
    gadget = json.loads((ROOT / "examples" / "gadget.json").read_text())
    path = tmp_path / "gadget_moving.json"
    path.write_text(json.dumps({"name": "gadget_moving",
                                "root": {"op": "transform", "child": gadget["root"]}}))
    return str(path)


ANIMATIONS = {
    "orbit": (lambda tmp: str(ROOT / "examples" / "gadget.json"), []),
    "reference object": (lambda tmp: "reference_render_scene", ["--rotate", "--motion", "spheric"]),
    "reference axis": (lambda tmp: "reference_render_scene", ["--motion", "axis"]),
    "composed motion": (_moving_spec, ["--rotate", "--motion", "spheric"]),
    "wrapped motion": (lambda tmp: "wrapped_object", ["--motion", "axis"]),
}


@pytest.mark.parametrize("case", sorted(ANIMATIONS))
def test_animate_frames_match_jax(case, tmp_path, caplog):
    scene, extra = ANIMATIONS[case]
    argv = ["animate", "--scene", scene(tmp_path), "--width", "32", "--height", "18",
            "--frames", "3", *extra]
    with caplog.at_level(logging.WARNING):
        assert cli.main([*argv, "--device", "cpu", "-o", str(tmp_path / "ours")]) == 0
        jax_cli.main([*argv, "-o", str(tmp_path / "ref")])
    assert not [r for r in caplog.records if "motion ignored" in r.getMessage()]
    for i in range(3):
        ours, ref = _png(tmp_path / f"ours_{i:04d}.png"), _png(tmp_path / f"ref_{i:04d}.png")
        assert ours.shape == ref.shape == (18, 32, 4)
        diff = np.abs(ours - ref)
        assert diff.max() <= 2 and diff.mean() < 0.05, (i, diff.max(), diff.mean())
    if case == "orbit":  # the camera moves: the frames differ
        assert np.abs(_png(tmp_path / "ours_0000.png") - _png(tmp_path / "ours_0001.png")).max() > 0


@pytest.mark.parametrize("scene", ["sphere", "gadget"])
def test_animate_warns_as_jax_where_motion_is_ignored(scene, tmp_path, caplog):
    """A scene with no object transform params (the sphere) or a composed
    scene whose root is not a transform (the gadget, with the JAX CLI's
    hint) ignores the motion, with the JAX CLI's warning, and orbits."""
    name = str(ROOT / "examples" / "gadget.json") if scene == "gadget" else scene
    argv = ["animate", "--scene", name, "--width", "8", "--height", "6", "--frames", "1",
            "--rotate"]
    with caplog.at_level(logging.WARNING):
        assert cli.main([*argv, "--device", "cpu", "-o", str(tmp_path / "ours")]) == 0
        ours = [r.getMessage() for r in caplog.records if r.name == "bsdmg_tpu_torch"]
        caplog.clear()
        jax_cli.main([*argv, "-o", str(tmp_path / "ref")])
        ref = [r.getMessage() for r in caplog.records if r.name == "bsdmg"]
    assert ours == ref and len(ref) == 1 and "motion ignored" in ref[0]
    assert ("wrap the spec root" in ref[0]) == (scene == "gadget")


def test_cli_animate_gif(tmp_path):
    gif = tmp_path / "orbit.gif"
    assert cli.main(["animate", "--device", "cpu", "--scene", str(ROOT / "examples" / "snowman.json"),
                     "--width", "16", "--height", "12", "--frames", "3", "--gif", str(gif),
                     "-o", str(tmp_path / "f")]) == 0
    from PIL import Image

    with Image.open(gif) as im:
        assert im.n_frames == 3 and im.size == (16, 12)


def test_save_gif_reads_back_and_needs_pillow(tmp_path, monkeypatch):
    from PIL import Image

    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, (10, 14, 4)).astype(np.uint8) for _ in range(4)]
    frames.append(rng.uniform(0.0, 1.0, (10, 14, 3)).astype(np.float32))
    path = tmp_path / "x.gif"
    save_gif(frames, path, fps=12.5)
    with Image.open(path) as im:
        assert im.n_frames == 5 and im.size == (14, 10)
        assert im.info["duration"] == 80 and im.info["loop"] == 0
    with pytest.raises(ValueError, match="at least one frame"):
        save_gif([], path)
    real = builtins.__import__

    def no_pillow(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pillow)
    with pytest.raises(RuntimeError, match="needs Pillow"):
        save_gif(frames, path)
