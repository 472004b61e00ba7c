"""``fit`` on the port: five ``fit --image`` steps against the JAX package's,
and the CLI verb in both modes, on the CPU.

The five steps run at 32x24 through the port's library functions (the
target through ``render_image_diff``, each step ``render_loss_and_grad``
with the silhouette term and ``torch.optim.Adam``) and through the JAX
package's (``optax.adam``), from the CLI's default perturbation: the
parameters agree at rtol 1e-3 after the five steps.
"""

import logging

import jax
import numpy as np
import optax
import pytest
import torch

from bsdmg_tpu.cam import generate_rays, look_at
from bsdmg_tpu.grad import render_image_diff as jax_render_image_diff
from bsdmg_tpu.grad import render_loss_and_grad as jax_render_loss_and_grad
from bsdmg_tpu.models import reference_render_scene as jax_render_scene
from bsdmg_tpu.ops.pallas.csdf import scene_bounds as jax_scene_bounds
from bsdmg_tpu_torch import cli
from bsdmg_tpu_torch.models import reference_render_scene
from bsdmg_tpu_torch.weights import params_from_numpy

# one intra-op thread: PyTorch's spinning OpenMP pool would otherwise take
# every core from the timing-sensitive tests that run beside these
torch.set_num_threads(1)

W, H, STEPS, LR = 32, 24, 5, 0.2
PERTURB = {"sphere_radius": 1.25, "smooth_k": 0.7, "skeleton_line_width": 1.3}


def _jax_fit():
    scene = jax_render_scene()
    o, d, c = generate_rays(look_at((5.0, 2.0, -5.0), fov=np.pi / 4), (W, H), (1920.0, 1080.0))
    true = {k: v for k, v in scene.params.items() if k not in ("object_center", "object_rotation")}
    lo, hi, slack = jax_scene_bounds(scene)
    bb = (tuple(v - 0.6 for v in lo), tuple(v + 0.6 for v in hi), slack)
    target = jax.lax.stop_gradient(jax_render_image_diff(scene.sdf, true, o, d, c, csdf=scene.csdf, bb=bb))
    params = {k: v * PERTURB.get(k, 1.0) for k, v in true.items()}
    opt = optax.adam(LR * 0.1)
    state = opt.init(params)
    history = []
    for _ in range(STEPS):
        _, g = jax_render_loss_and_grad(
            scene.sdf, params, target, o, d, c, csdf=scene.csdf, bb=bb, edge_weight=1.0
        )
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
        history.append({k: np.asarray(v) for k, v in params.items()})
    return (o, d, c), true, history


def test_five_adam_steps_match_optax():
    rays, true, history = _jax_fit()
    scene = reference_render_scene(device="cpu")
    to, td, tc = (torch.from_numpy(np.array(a)) for a in rays)
    tp = params_from_numpy({k: np.asarray(v) for k, v in true.items()}, "cpu")
    start = {k: v * PERTURB.get(k, 1.0) for k, v in tp.items()}
    params, losses = cli.fit_image(scene, tp, start, to, td, tc, steps=STEPS, lr=LR)
    assert len(losses) == STEPS and np.isfinite(losses).all()
    want = history[-1]
    assert sorted(params) == sorted(want)
    for k in want:
        np.testing.assert_allclose(params[k].numpy(), want[k], rtol=1e-3, err_msg=k)
        # the fit moved the perturbed parameters
        if k in PERTURB:
            assert not np.allclose(want[k], np.asarray(true[k]) * PERTURB[k]), k


@pytest.fixture
def cli_log():
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger("bsdmg_tpu_torch")
    handler, level = Keep(logging.INFO), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    yield records
    logger.removeHandler(handler)
    logger.setLevel(level)


@pytest.mark.parametrize("mode", [[], ["--image"]], ids=["depth", "image"])
def test_cli_fit_runs_on_cpu(cli_log, mode):
    argv = ["fit", *mode, "--device", "cpu", "--width", "32", "--height", "24", "--steps", "12"]
    assert cli.main(argv) == 0
    steps = [m for m in cli_log if m.startswith("step ")]
    assert [m.split(":")[0] for m in steps] == ["step 0", "step 10", "step 11"]
    losses = [float(m.split("loss=")[1].split()[0]) for m in steps]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert cli_log[-1].startswith("recovered sphere_radius=") or cli_log[-1].startswith("recovered ")
    assert "(true " in cli_log[-1] and "sphere_radius" in cli_log[-1]


def test_cli_fit_perturb_and_scene_errors():
    with pytest.raises(SystemExit, match="not in scene params"):
        cli.main(["fit", "--device", "cpu", "--perturb", "nope=2"])
    with pytest.raises(SystemExit, match="unchanged"):
        cli.main(["fit", "--device", "cpu", "--perturb", "skeleton_center=2"])
    with pytest.raises(FileNotFoundError):  # a missing spec, as in the JAX CLI
        cli.main(["fit", "--device", "cpu", "--scene", "x.json", "--perturb", "r=2"])
    assert cli._parse_perturb("a=2, b=+0.5,c=*3") == {"a": ("mul", 2.0), "b": ("add", 0.5), "c": ("mul", 3.0)}


def test_cli_fit_needs_a_card_without_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["fit", "--image", "--steps", "1"])
