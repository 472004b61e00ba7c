"""K5's twin with the silhouette term (grad/edge.py) against the JAX package.

At 96x54 with the target rendered at the true parameters, the radius at
1.25x and the trust-region bounds (+0.6), ``render_loss_grad_torch`` with
``edge_weight=1`` against ``render_loss_grad_pallas`` in interpret mode:
loss to a relative 1e-4, gradients at rtol 1e-3, atol 1e-6
(tests/test_grad.py:357-378), once as the JAX tests call it and once with
the near/far split on in both packages, as their CLIs call it.
Then the port alone: ``edge_weight=0`` is bit-identical to the photometric
loss, and the radius gradient points back to the truth across 0.5x-1.5x
(tests/test_grad.py:340-355).
"""

import jax
import numpy as np
import pytest
import torch

from bsdmg_tpu.cam import generate_rays, look_at
from bsdmg_tpu.grad import render_image_diff as jax_render_image_diff
from bsdmg_tpu.models import reference_render_scene as jax_render_scene
from bsdmg_tpu.ops.pallas.csdf import compile_scene_split
from bsdmg_tpu.ops.pallas.csdf import scene_bounds as jax_scene_bounds
from bsdmg_tpu.ops.pallas.diff_kernel import render_loss_grad_pallas
from bsdmg_tpu_torch.grad import render_image_diff, render_loss_and_grad
from bsdmg_tpu_torch.grad.edge import UNTRACKED, classify_target_miss, edge_loss_planes
from bsdmg_tpu_torch.models import reference_render_scene
from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene_split as torch_scene_split
from bsdmg_tpu_torch.ops.cuda.csdf import scene_bounds
from bsdmg_tpu_torch.ops.cuda.diff_kernel import render_loss_grad_torch
from bsdmg_tpu_torch.weights import params_from_numpy

# one intra-op thread: PyTorch's spinning OpenMP pool would otherwise take
# every core from the timing-sensitive tests that run beside these
torch.set_num_threads(1)

W, H = 96, 54
TRANSFORM = ("object_center", "object_rotation")


def _inflated(bounds, by=0.6):
    lo, hi, slack = bounds
    return (tuple(v - by for v in lo), tuple(v + by for v in hi), slack)


@pytest.fixture(scope="module")
def jax_setup():
    scene = jax_render_scene()
    o, d, c = generate_rays(look_at((5.0, 2.0, -5.0), fov=np.pi / 4), (W, H), (1920.0, 1080.0))
    true = {k: v for k, v in scene.params.items() if k not in TRANSFORM}
    bb = _inflated(jax_scene_bounds(scene))
    target = jax.lax.stop_gradient(
        jax_render_image_diff(scene.sdf, true, o, d, c, csdf=scene.csdf, bb=bb)
    )
    return scene, (o, d, c), true, bb, target


@pytest.fixture(scope="module")
def torch_setup(jax_setup):
    _, rays, true, bb, target = jax_setup
    scene = reference_render_scene(device="cpu")
    assert _inflated(scene_bounds(scene)) == bb
    to, td, tc = (torch.from_numpy(np.array(a)) for a in rays)
    tp = params_from_numpy({k: np.asarray(v) for k, v in true.items()}, "cpu")
    ttarget = render_image_diff(scene.sdf, tp, to, td, tc, csdf=scene.csdf, bb=bb).detach()
    np.testing.assert_allclose(ttarget.numpy(), np.asarray(target), atol=1e-5)
    return scene, (to, td, tc), tp, bb, ttarget


@pytest.mark.parametrize("split", [False, True], ids=["as-tested", "with-split"])
def test_edge_loss_grad_twin_matches_pallas(jax_setup, torch_setup, split):
    jscene, (o, d, c), true, bb, target = jax_setup
    scene, rays, tp, _, ttarget = torch_setup
    jp = dict(true)
    jp["sphere_radius"] = jp["sphere_radius"] * 1.25
    jax_split = torch_split = None
    if split:
        far, near = compile_scene_split(jscene)
        jax_split = (far, _inflated(near))
        far, near = torch_scene_split(scene)
        torch_split = (far, _inflated(near))
    ref_loss, ref_g = render_loss_grad_pallas(
        jscene.csdf, jp, target, o, d, c, bb=bb, split=jax_split, edge_weight=1.0, interpret=True
    )
    p = dict(tp)
    p["sphere_radius"] = p["sphere_radius"] * 1.25
    # the JAX target, so both sides fit the same image
    loss, g = render_loss_grad_torch(
        scene.csdf, p, torch.from_numpy(np.array(target)), *rays, bb=bb, edge_weight=1.0,
        split=torch_split,
    )
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-4)
    for k in ref_g:
        np.testing.assert_allclose(g[k].numpy(), np.asarray(ref_g[k]), rtol=1e-3, atol=1e-6, err_msg=k)


def test_target_miss_overrides_the_classification(torch_setup):
    """``target_miss`` replaces the mask classified from the target's
    colours: the classified mask itself gives the same loss, its inverse
    another."""
    scene, rays, tp, bb, target = torch_setup
    p = dict(tp, sphere_radius=tp["sphere_radius"] * 1.25)
    miss = classify_target_miss(target)
    runs = [render_loss_grad_torch(scene.csdf, p, target, *rays, bb=bb, edge_weight=1.0, target_miss=m)
            for m in (None, miss, ~miss)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert float(runs[2][0]) != float(runs[0][0])


def test_edge_weight_zero_is_photometric_loss(torch_setup):
    scene, rays, tp, bb, target = torch_setup
    p = dict(tp)
    p["sphere_radius"] = p["sphere_radius"] * 1.1
    l0, g0 = render_loss_and_grad(scene.sdf, p, target, *rays, csdf=scene.csdf, bb=bb)
    l1, g1 = render_loss_and_grad(scene.sdf, p, target, *rays, csdf=scene.csdf, bb=bb, edge_weight=0.0)
    assert float(l0) == float(l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


@pytest.mark.parametrize("factor", [0.5, 0.75, 1.25, 1.5])
def test_gradient_sign_across_extended_basin(torch_setup, factor):
    scene, rays, tp, bb, target = torch_setup
    p = dict(tp)
    p["sphere_radius"] = p["sphere_radius"] * factor
    _, g = render_loss_and_grad(scene.sdf, p, target, *rays, csdf=scene.csdf, bb=bb, edge_weight=1.0)
    gr = float(g["sphere_radius"])
    assert (gr > 0) if factor > 1.0 else (gr < 0), (factor, gr)


def test_loss_backward_fills_param_grads(torch_setup):
    """The loss of render_loss_and_grad is differentiable: backward puts
    the returned gradients into the parameters' .grad."""
    scene, rays, tp, bb, target = torch_setup
    p = {k: v.clone().requires_grad_() for k, v in tp.items()}
    with torch.no_grad():
        p["smooth_k"] *= 0.8
    loss, g = render_loss_and_grad(scene.sdf, p, target, *rays, csdf=scene.csdf, bb=bb, edge_weight=1.0)
    assert loss.requires_grad
    (2.0 * loss).backward()
    for k in p:
        assert torch.equal(p[k].grad, 2.0 * g[k]), k


def test_edge_terms_on_planes():
    """classify_target_miss and the two hinges on hand-made planes."""
    target = torch.tensor([[[0.0, 0.0, 0.0], [0.62, 0.62, 0.62], [0.1, 0.05, 0.4]]])
    assert classify_target_miss(target).tolist() == [[True, True, False]]
    f = lambda x, y, z: x  # the SDF is the x coordinate
    zero = torch.zeros(4)
    min_m = torch.tensor([0.3, 0.3, UNTRACKED, 0.3])
    collided = torch.tensor([False, True, False, False])
    state = torch.tensor([0.0, 1.0, 0.0, -1.0])
    x = torch.tensor([0.3, 0.002, 0.5, 0.3], requires_grad=True)
    e = edge_loss_planes(f, x, zero, zero, zero, zero, zero, zero, zero, min_m, collided, state, 0.004)
    # appear: max(m, 0); vanish: max(band - m, 0); untracked and ignored: 0
    np.testing.assert_allclose(e.detach().numpy(), [0.3, 0.002, 0.0, 0.0], atol=1e-7)
    e.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [1.0, -1.0, 0.0, 0.0])
