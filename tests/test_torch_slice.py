"""The port's main path end to end: ``bsdmg_tpu_torch.cli render``.

On the CPU the CLI runs K1's plain version (``--device cpu``). The 256x144
frame is held against the committed oracle golden with the bar of
tests/test_render.py:178-181 (>= 99.5% of pixels under 2e-2, mean < 1e-3)
and against the JAX package's fused Pallas render in interpret mode with the
kernel bars (>= 99.9% under 2e-2, mean < 1e-4).
"""

import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from bsdmg_tpu.cam import generate_rays, look_at
from bsdmg_tpu.models import reference_render_scene as jax_scene
from bsdmg_tpu.ops.pallas import compile_scene_csdf
from bsdmg_tpu.ops.pallas.csdf import scene_bounds
from bsdmg_tpu.ops.pallas.render_kernel import render_image_pallas
from bsdmg_tpu_torch import cli
from bsdmg_tpu_torch.weights import params_from_numpy
from test_torch_compose import assert_image_fit_matches_jax

# one intra-op thread: PyTorch's spinning OpenMP pool would otherwise take
# every core from the timing-sensitive tests that run beside these
torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "golden" / "render_256x144.npz"


@pytest.fixture(scope="module")
def cli_frame(tmp_path_factory):
    out = tmp_path_factory.mktemp("slice") / "frame.npy"
    assert cli.main(["render", "--device", "cpu", "--width", "256", "--height", "144", "-o", str(out)]) == 0
    return np.load(out)


def test_cli_render_matches_golden(cli_frame):
    golden = np.load(GOLDEN)["image"]
    assert cli_frame.shape == golden.shape == (144, 256, 3)
    assert cli_frame.dtype == np.float32 and np.isfinite(cli_frame).all()
    diff = np.abs(cli_frame - golden).max(axis=-1)
    assert np.mean(diff < 2e-2) > 0.995, f"mismatched: {(diff >= 2e-2).sum()}"
    assert diff.mean() < 1e-3


def test_cli_render_matches_jax_pallas(cli_frame):
    scene = jax_scene()
    o, d, c = generate_rays(look_at((5.0, 2.0, -5.0), fov=np.pi / 4), (256, 144), (1920.0, 1080.0))
    ref = np.asarray(render_image_pallas(
        compile_scene_csdf(scene), o, d, c, bb=scene_bounds(scene), interpret=True,
    ))
    diff = np.abs(cli_frame - ref).max(axis=-1)
    assert np.mean(diff < 2e-2) >= 0.999, f"mismatched: {(diff >= 2e-2).sum()}"
    assert diff.mean() < 1e-4


def test_cli_writes_png(tmp_path):
    out = tmp_path / "frame.png"
    cli.main(["render", "--device", "cpu", "--width", "40", "--height", "24", "-o", str(out)])
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    width, height, depth, color_type = struct.unpack(">IIBB", data[16:26])
    assert (width, height, depth, color_type) == (40, 24, 8, 6)


@pytest.mark.parametrize("channels", [3, 4])
def test_save_png_matches_jax(channels, tmp_path):
    from bsdmg_tpu.mesh.export import save_png as jax_save_png
    from bsdmg_tpu_torch.mesh.export import save_png

    image = np.random.default_rng(channels).integers(0, 256, (9, 13, channels)).astype(np.uint8)
    save_png(image, tmp_path / "ours.png")
    jax_save_png(image, tmp_path / "ref.png")
    assert (tmp_path / "ours.png").read_bytes() == (tmp_path / "ref.png").read_bytes()


def test_cli_without_cuda_raises(tmp_path):
    """The default device is cuda; the CLI never moves to the CPU itself."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "frame.png"
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["render", "--width", "16", "--height", "8", "-o", str(out)])
    assert not out.exists()


#: the image fits of the scenes K4 and K5 did not take before their
#: parameter forms, against JAX's cmd_fit: argv, size and steps
IMAGE_FITS = {
    "mandelbulb": (["--scene", "mandelbulb", "--camera", "2", "1", "-2", "--perturb", "scale=1.1"],
                   (16, 12), 3),
    "examples/snowman.json": (["--scene", "examples/snowman.json", "--perturb", "n1_radius=1.2"],
                              (32, 24), 6),
}


@pytest.mark.parametrize("scene", ["mandelbulb", "examples/snowman.json", "mesh:bunny.obj"])
def test_cli_unported_scene_raises(scene, tmp_path, caplog):
    # mesh assets render, mesh and fit depth and image
    # (tests/test_torch_grid_kernel.py, test_torch_mesh_assets.py, which holds
    # the image fit against JAX's through K4's and K5's grid form). The
    # mandelbulb and composed scenes render, mesh and fit depth
    # (tests/test_torch_scenes.py, test_torch_compose.py), and their image fit
    # runs through K4's and K5's twins and matches JAX's cmd_fit. Without
    # --perturb each exits asking for one, as the JAX CLI's does (a mesh
    # asset once it has loaded and baked the OBJ, here a small torus)
    if scene.startswith("mesh:"):
        import importlib.util

        from bsdmg_tpu_torch.mesh.export import save_obj
        from bsdmg_tpu_torch.mesh.pipeline import Mesh

        path = Path(__file__).resolve().parents[1] / "tools" / "make_torus.py"
        spec = importlib.util.spec_from_file_location("make_torus", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        verts, faces = module.torus(nu=12, nv=8)
        asset = tmp_path / scene.removeprefix("mesh:")
        save_obj(Mesh(vertices=verts, normals=np.zeros_like(verts), faces=faces), asset)
        with pytest.raises(SystemExit, match="pass --perturb"):
            cli.main(["fit", "--image", "--device", "cpu", "--scene", f"mesh:{asset}:8"])
        return
    with pytest.raises(SystemExit, match="pass --perturb"):
        cli.main(["fit", "--image", "--device", "cpu", "--scene", scene])
    argv, size, steps = IMAGE_FITS[scene]
    assert_image_fit_matches_jax(argv, caplog, size, steps)
    if scene == "mandelbulb":
        with pytest.raises(SystemExit, match="pass --perturb"):
            cli.main(["fit", "--device", "cpu", "--scene", scene])


def test_params_from_numpy():
    params = {k: np.asarray(v) for k, v in jax_scene().params.items()}
    got = params_from_numpy(params, "cpu")
    assert set(got) == set(params)
    for k, v in got.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), params[k])
