"""The port's differentiable render against the JAX package's, on the CPU.

* ``Scene.csdf`` (models/scenes.py, the component form K4 and K5 mirror)
  against JAX ``scene.csdf`` on 4096 seeded points, at the default and at a
  perturbed parameter point: values to 1e-6, spatial and parameter
  gradients (autograd against ``jax.grad``) to 1e-5;
* ``weights.flatten_params`` against ``jax.tree_util.tree_flatten``;
* ``render_image_diff`` with a ``csdf`` against JAX
  ``_render_image_diff_c(use_pallas=False)``: image to 1e-5, gradients of
  ``sum(img)`` at rtol 1e-4, atol 1e-5 (tests/test_grad.py:238-265), the
  quaternion's at 1e-4 of its largest component;
* the depth path, ``differentiable_hit``: the gradient of the mean hit depth
  with respect to ``sphere_radius`` and ``smooth_k`` (tests/test_grad.py:41-61).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsdmg_tpu.cam import generate_rays, look_at
from bsdmg_tpu.grad import differentiable_hit as jax_differentiable_hit
from bsdmg_tpu.grad.diff_render import _render_image_diff_c as jax_render_c
from bsdmg_tpu.models import reference_object as jax_object
from bsdmg_tpu.models import reference_render_scene as jax_render_scene
from bsdmg_tpu_torch.grad import differentiable_hit, render_image_diff
from bsdmg_tpu_torch.models import reference_object, reference_render_scene
from bsdmg_tpu_torch.weights import flatten_params, params_from_numpy, unflatten_params

# one intra-op thread: PyTorch's spinning OpenMP pool would otherwise take
# every core from the timing-sensitive tests that run beside these
torch.set_num_threads(1)

SCENES = {
    "reference_object": (reference_object, jax_object),
    "reference_render_scene": (reference_render_scene, jax_render_scene),
}
TRANSFORM = ("object_center", "object_rotation")


def _jax_params(jax_scene, point: str):
    p = dict(jax_scene.params)
    if point == "perturbed":
        p["sphere_radius"] = p["sphere_radius"] * 1.25
        p["smooth_k"] = p["smooth_k"] * 0.7
        p["skeleton_line_width"] = p["skeleton_line_width"] * 1.3
        p["skeleton_center"] = p["skeleton_center"] + jnp.asarray([0.05, -0.02, 0.01])
        p["object_center"] = jnp.asarray([0.1, -0.05, 0.02], jnp.float32)
        p["object_rotation"] = jnp.asarray([0.98, 0.1, -0.15, 0.05], jnp.float32)
    return p


def _numpy(params):
    return {k: np.asarray(v) for k, v in params.items()}


def _points(n=4096):
    rng = np.random.default_rng(7)
    return rng.uniform(-3.0, 3.0, (3, n)).astype(np.float32)


@pytest.mark.parametrize("point", ["default", "perturbed"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_csdf_value_and_gradients_match_jax(name, point):
    make, make_jax = SCENES[name]
    jscene = make_jax()
    jp = _jax_params(jscene, point)
    xyz = _points()

    def jax_mean(p, x, y, z):
        return jnp.mean(jscene.csdf(p, x, y, z))

    ref = np.asarray(jscene.csdf(jp, *xyz))
    ref_gp = jax.grad(jax_mean)(jp, *xyz)
    ref_gxyz = jax.grad(jax_mean, argnums=(1, 2, 3))(jp, *xyz)

    scene = make(device="cpu")
    tp = {k: v.requires_grad_() for k, v in params_from_numpy(_numpy(jp), "cpu").items()}
    coords = [torch.from_numpy(c.copy()).requires_grad_() for c in xyz]
    d = scene.csdf(tp, *coords)
    np.testing.assert_allclose(d.detach().numpy(), ref, atol=1e-6)
    n = xyz.shape[1]
    grads = torch.autograd.grad(d.mean(), [*coords, *(tp[k] for k in sorted(tp))])
    for a in range(3):
        # per-point spatial gradients (the mean scales each by 1/n)
        np.testing.assert_allclose(grads[a].numpy() * n, np.asarray(ref_gxyz[a]) * n, atol=1e-5)
    for k, g in zip(sorted(tp), grads[3:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref_gp[k]), rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("transform", [True, False], ids=["with-transform", "shape-only"])
def test_flatten_params_matches_tree_flatten(transform):
    jp = _jax_params(jax_render_scene(), "perturbed")
    if not transform:
        jp = {k: v for k, v in jp.items() if k not in TRANSFORM}
    leaves, _ = jax.tree_util.tree_flatten(jp)
    ref = np.concatenate([np.asarray(v, np.float32).reshape(-1) for v in leaves])
    tp = params_from_numpy(_numpy(jp), "cpu")
    flat, layout = flatten_params(tp)
    np.testing.assert_array_equal(flat.numpy(), ref)
    assert flat.numel() == (16 if transform else 9)
    back = unflatten_params(flat, layout)
    assert list(back) == sorted(jp)
    for k in jp:
        assert torch.equal(back[k], tp[k]), k


def test_flatten_params_keeps_autograd_history():
    tp = {k: v.requires_grad_() for k, v in reference_render_scene(device="cpu").params.items()}
    flat, layout = flatten_params(tp)
    (flat * torch.arange(flat.numel(), dtype=torch.float32)).sum().backward()
    i = 0
    for name, shape in layout:
        n = int(np.prod(shape)) if shape else 1
        np.testing.assert_array_equal(tp[name].grad.reshape(-1).numpy(), np.arange(i, i + n))
        i += n
    with pytest.raises(ValueError, match="layout"):
        unflatten_params(flat[:-1], layout)


def _rays(w, h):
    o, d, c = generate_rays(look_at((5.0, 2.0, -5.0), fov=np.pi / 4), (w, h), (1920.0, 1080.0))
    return (o, d, c), tuple(torch.from_numpy(np.array(a)) for a in (o, d, c))


@pytest.mark.parametrize("with_bb", [False, True], ids=["no-bounds", "bounds"])
def test_render_image_diff_matches_jax(with_bb):
    """Image and gradients of sum(img) at radius 1.2 (test_grad.py:238-265);
    with bounds, the port's stopped march culls rays against the inflated
    box, as the JAX kernel does, while the JAX XLA reference marches every
    ray: the image and gradients do not depend on a miss ray's depth."""
    jscene = jax_render_scene()
    jp = dict(jscene.params)
    jp["sphere_radius"] = jnp.float32(1.2)
    (o, d, c), (to, td, tc) = _rays(64, 32)

    def img_fn(p):
        return jax_render_c(jscene.csdf, p, o, d, c, use_pallas=False)

    ref = np.asarray(img_fn(jp))
    ref_g = jax.grad(lambda p: jnp.sum(img_fn(p)))(jp)

    scene = reference_render_scene(device="cpu")
    bb = None
    if with_bb:
        from bsdmg_tpu_torch.ops.cuda.csdf import scene_bounds

        lo, hi, slack = scene_bounds(scene)
        bb = (tuple(v - 0.6 for v in lo), tuple(v + 0.6 for v in hi), slack)
    tp = {k: v.requires_grad_() for k, v in params_from_numpy(_numpy(jp), "cpu").items()}
    img = render_image_diff(scene.sdf, tp, to, td, tc, csdf=scene.csdf, bb=bb)
    np.testing.assert_allclose(img.detach().numpy(), ref, atol=1e-5)
    img.sum().backward()
    for k in ref_g:
        want = np.asarray(ref_g[k])
        # the quaternion's components cancel terms of ~70 down to ~6: held
        # at 1e-4 of the vector's largest component (measured 3.4e-4
        # relative on one component, 2.8e-5 of the largest)
        atol = 1e-4 * np.abs(want).max() if k == "object_rotation" else 1e-5
        np.testing.assert_allclose(tp[k].grad.numpy(), want, rtol=1e-4, atol=atol, err_msg=k)


def test_differentiable_hit_depth_gradient_matches_jax():
    """Gradient of the mean hit depth on the points path (test_grad.py:41-61)
    against the JAX package's, and against central differences."""
    jscene = jax_object()
    (o, d, c), (to, td, tc) = _rays(24, 16)

    def jax_mean_depth(p):
        t, hit = jax_differentiable_hit(jscene.sdf, p, o, d, c)
        mask = (hit.outcome == 0).astype(jnp.float32)
        return jnp.sum(t * mask) / jnp.sum(mask)

    ref = jax.grad(jax_mean_depth)(jscene.params)

    scene = reference_object(device="cpu")
    tp = {k: v.requires_grad_() for k, v in params_from_numpy(_numpy(jscene.params), "cpu").items()}

    def mean_depth(p):
        t, hit = differentiable_hit(scene.sdf, p, to, td, tc)
        mask = (hit.outcome == 0).to(torch.float32)
        return torch.sum(t * mask) / torch.sum(mask)

    mean_depth(tp).backward()
    eps = 1e-3
    for key in ("sphere_radius", "smooth_k"):
        got = float(tp[key].grad)
        assert got == pytest.approx(float(ref[key]), rel=1e-4, abs=1e-6), key
        with torch.no_grad():
            plus = {k: v.detach() + (eps if k == key else 0.0) for k, v in tp.items()}
            minus = {k: v.detach() - (eps if k == key else 0.0) for k, v in tp.items()}
            fd = (float(mean_depth(plus)) - float(mean_depth(minus))) / (2 * eps)
        assert abs(got - fd) < 5e-2 * max(1.0, abs(fd)), (key, got, fd)
