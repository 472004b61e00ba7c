"""The module of CUDA kernels K4 and K5 (bsdmg_tpu_torch/ops/cuda/diff_kernel.py).

The kernels need nvcc and a card; chip_smoke.py holds them against their
plain versions there. Here the plain versions are held against the JAX
package's Pallas kernels run in interpret mode, on the same rays and
parameters:

* K4's twin against ``march_params_pallas`` at 64x32 with the trust-region
  bounds (+0.6), ``track_min`` off and on, at the default parameters (with
  the object transform) and at the fit's perturbed point: every outcome
  equal; steps equal on >= 99.9% of rays (one ray at each point takes one
  step more: XLA's CPU compiler contracts multiply-adds into FMAs, PyTorch
  does not, and a hit test can fall the other way by one rounding); where
  the steps agree, depth and ``dfdt`` of collided rays, ``min_m`` and
  ``t_min`` of every ray within 1e-5, and the depth of the other rays
  (marched out to the box's exit) within a relative 1e-4;
* K5's twin against ``render_loss_grad_pallas`` at 64x32, a seed-1 random
  target and radius 1.15: loss to a relative 1e-4, gradients at rtol 1e-3,
  atol 1e-5 (tests/test_grad.py:268-301).
"""

import ctypes
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsdmg_tpu.cam import generate_rays, look_at
from bsdmg_tpu.config import MarchConfig as JaxMarchConfig
from bsdmg_tpu.models import reference_render_scene as jax_render_scene
from bsdmg_tpu.ops.pallas.csdf import scene_bounds as jax_scene_bounds
from bsdmg_tpu.ops.pallas.diff_kernel import march_params_pallas, render_loss_grad_pallas
from bsdmg_tpu_torch.config import MarchConfig
from bsdmg_tpu_torch.models import reference_render_scene
from bsdmg_tpu_torch.ops.cuda import diff_kernel
from bsdmg_tpu_torch.ops.cuda.csdf import scene_bounds
from bsdmg_tpu_torch.ops.cuda.grid_box import GridBoxC
from bsdmg_tpu_torch.ops.cuda.diff_kernel import (
    march_params_cuda,
    march_params_torch,
    param_scene_c,
    render_loss_grad_cuda,
    render_loss_grad_torch,
)
from bsdmg_tpu_torch.weights import params_from_numpy
from test_torch_render_kernel import _c_struct_fields

# one intra-op thread: PyTorch's spinning OpenMP pool would otherwise take
# every core from the timing-sensitive tests that run beside these
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TRANSFORM = ("object_center", "object_rotation")


def _rays(w, h):
    o, d, c = generate_rays(look_at((5.0, 2.0, -5.0), fov=np.pi / 4), (w, h), (1920.0, 1080.0))
    return (o, d, c), tuple(torch.from_numpy(np.array(a)) for a in (o, d, c))


def _inflated(bounds, by):
    lo, hi, slack = bounds
    return (tuple(v - by for v in lo), tuple(v + by for v in hi), slack)


def _point(name):
    p = dict(jax_render_scene().params)
    if name == "fit":
        p = {k: v for k, v in p.items() if k not in TRANSFORM}
        p["sphere_radius"] = p["sphere_radius"] * 1.25
        p["smooth_k"] = p["smooth_k"] * 0.7
        p["skeleton_line_width"] = p["skeleton_line_width"] * 1.3
    return p


def _torch_params(jp):
    return params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")


@pytest.mark.parametrize("track_min", [False, True], ids=["plain", "track_min"])
@pytest.mark.parametrize("point", ["default", "fit"])
def test_march_twin_matches_pallas(point, track_min):
    jscene, scene = jax_render_scene(), reference_render_scene(device="cpu")
    bb = _inflated(jax_scene_bounds(jscene), 0.6)
    assert _inflated(scene_bounds(scene), 0.6) == bb
    (o, d, c), (to, td, tc) = _rays(64, 32)
    jp = _point(point)
    ref = [np.asarray(x) for x in march_params_pallas(
        jscene.csdf, jp, o, d, c, bb=bb, interpret=True, track_min=track_min)]
    got = [x.numpy() for x in march_params_torch(
        scene.csdf, _torch_params(jp), to, td, tc, bb=bb, track_min=track_min)]
    assert len(got) == len(ref) == (6 if track_min else 4)
    assert got[1].dtype == got[2].dtype == np.int32
    np.testing.assert_array_equal(got[2], ref[2])
    same = got[1] == ref[1]
    assert same.mean() >= 0.999, f"{(~same).sum()} rays with other step counts"
    hit = same & (ref[2] == 0)
    for i in (0, 3):  # depth, dfdt
        np.testing.assert_allclose(got[i][hit], ref[i][hit], atol=1e-5)
    np.testing.assert_allclose(got[0][same], ref[0][same], rtol=1e-4)
    for i in range(4, len(ref)):  # min_m, t_min
        np.testing.assert_allclose(got[i][same], ref[i][same], atol=1e-5)
    if track_min:
        culled = ref[0] == np.float32(505.0)
        assert culled.any() and (got[4][culled] == 1e9).all() and (got[5][culled] == 0).all()


def test_loss_grad_twin_matches_pallas():
    jscene, scene = jax_render_scene(), reference_render_scene(device="cpu")
    jp = {k: v for k, v in jscene.params.items() if k not in TRANSFORM}
    jp["sphere_radius"] = jnp.float32(1.15)
    (o, d, c), (to, td, tc) = _rays(64, 32)
    target = np.random.default_rng(1).uniform(0, 1, (32, 64, 3)).astype(np.float32)
    ref_loss, ref_g = render_loss_grad_pallas(
        jscene.csdf, jp, jnp.asarray(target), o, d, c, interpret=True
    )
    loss, g = render_loss_grad_torch(scene.csdf, _torch_params(jp), torch.from_numpy(target), to, td, tc)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-4)
    assert sorted(g) == sorted(ref_g)
    for k in ref_g:
        np.testing.assert_allclose(g[k].numpy(), np.asarray(ref_g[k]), rtol=1e-3, atol=1e-5, err_msg=k)


def test_wrappers_take_the_twins_on_cpu():
    """On CPU tensors the wrappers are their twins, and launch nothing."""
    scene = reference_render_scene(device="cpu")
    _, (o, d, c) = _rays(16, 8)
    before = (diff_kernel.MARCH_LAUNCHES, diff_kernel.LOSS_GRAD_LAUNCHES)
    a = march_params_cuda(scene.csdf, scene.params, o, d, c, track_min=True)
    b = march_params_torch(scene.csdf, scene.params, o, d, c, track_min=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    target = torch.zeros((8, 16, 3))
    la, ga = render_loss_grad_cuda(scene.csdf, scene.params, target, o, d, c, edge_weight=1.0)
    lb, gb = render_loss_grad_torch(scene.csdf, scene.params, target, o, d, c, edge_weight=1.0)
    assert torch.equal(la, lb) and all(torch.equal(ga[k], gb[k]) for k in ga)
    assert (diff_kernel.MARCH_LAUNCHES, diff_kernel.LOSS_GRAD_LAUNCHES) == before


def _bad_inputs():
    scene = reference_render_scene(device="cpu")
    _, (o, d, c) = _rays(16, 8)
    p = scene.params
    t = torch.zeros((8, 16, 3))
    return {
        "float64 cone": (lambda: march_params_cuda(scene.csdf, p, o, d, c.double()), TypeError),
        "param on meta": (lambda: march_params_cuda(
            scene.csdf, {**p, "smooth_k": p["smooth_k"].to("meta")}, o, d, c), ValueError),
        "target shape": (lambda: render_loss_grad_cuda(scene.csdf, p, t[:4], o, d, c), ValueError),
        "target dtype": (lambda: render_loss_grad_cuda(scene.csdf, p, t.double(), o, d, c), TypeError),
        "points scene": (lambda: param_scene_c(scene.sdf, p), NotImplementedError),
        "param shape": (lambda: param_scene_c(scene.csdf, {**p, "skeleton_size": torch.ones(())}),
                        ValueError),
        "missing param": (lambda: param_scene_c(
            scene.csdf, {k: v for k, v in p.items() if k != "smooth_k"}), ValueError),
    }


@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_relaxation_steps_exactly_as_jax(kernel):
    """K4 and K5 step exactly whatever ``config.relaxation`` says, as the
    JAX kernels, which never read it (their wrappers raised on it before):
    at relaxation 1.5 the twins (through the wrappers, on CPU tensors)
    equal their own results at 1.0 bit for bit, and JAX's
    ``march_params_pallas`` and ``render_loss_grad_pallas`` at 1.5 (interpret
    mode, 16x8) within test_march_twin_matches_pallas's and
    test_loss_grad_twin_matches_pallas's bars."""
    jscene, scene = jax_render_scene(), reference_render_scene(device="cpu")
    bb = _inflated(jax_scene_bounds(jscene), 0.6)
    (o, d, c), rays = _rays(16, 8)
    jp = _point("fit")
    p = _torch_params(jp)
    relaxed, exact = MarchConfig(relaxation=1.5), MarchConfig()
    if kernel == "K4":
        got = march_params_cuda(scene.csdf, p, *rays, relaxed, bb=bb, track_min=True)
        same = march_params_cuda(scene.csdf, p, *rays, exact, bb=bb, track_min=True)
        assert all(torch.equal(a, b) for a, b in zip(got, same))
        ref = [np.asarray(x) for x in march_params_pallas(
            jscene.csdf, jp, o, d, c, JaxMarchConfig(relaxation=1.5), bb=bb, interpret=True,
            track_min=True)]
        got = [x.numpy() for x in got]
        np.testing.assert_array_equal(got[2], ref[2])
        steps = got[1] == ref[1]
        assert (~steps).sum() <= 1, f"{(~steps).sum()} rays with other step counts"
        hit = steps & (ref[2] == 0)
        assert hit.any()
        for i in (0, 3):  # depth, dfdt
            np.testing.assert_allclose(got[i][hit], ref[i][hit], atol=1e-5)
        return
    target = np.random.default_rng(1).uniform(0, 1, (8, 16, 3)).astype(np.float32)
    loss, g = render_loss_grad_cuda(scene.csdf, p, torch.from_numpy(target), *rays, relaxed, bb=bb)
    loss1, g1 = render_loss_grad_cuda(scene.csdf, p, torch.from_numpy(target), *rays, exact, bb=bb)
    assert torch.equal(loss, loss1) and all(torch.equal(g[k], g1[k]) for k in g)
    ref_loss, ref_g = render_loss_grad_pallas(
        jscene.csdf, jp, jnp.asarray(target), o, d, c, JaxMarchConfig(relaxation=1.5), bb=bb,
        interpret=True)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-4)
    for k in ref_g:
        np.testing.assert_allclose(g[k].numpy(), np.asarray(ref_g[k]), rtol=1e-3, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrappers_reject_bad_inputs(case):
    call, error = _bad_inputs()[case]
    with pytest.raises(error):
        call()


def test_param_scene_indexes_follow_flat_order():
    scene = reference_render_scene(device="cpu")
    full, _ = param_scene_c(scene.csdf, scene.params, bb=((-1, -1, -1), (1, 1, 1), 0.2))
    assert full.n_prm == 16 and full.use_bounds == 1 and full.has_frame == 1
    assert (full.object_center, full.object_rotation, full.skeleton_center) == (0, 3, 7)
    assert (full.skeleton_line_width, full.skeleton_size, full.smooth_k, full.sphere_radius) == (
        10, 11, 14, 15)
    assert list(full.rigid_prm)[3:7] == [1.0, 0.0, 0.0, 0.0]
    shape = {k: v for k, v in scene.params.items() if k not in TRANSFORM}
    part, _ = param_scene_c(scene.csdf, shape)
    assert part.n_prm == 9 and part.use_bounds == 0
    assert (part.object_center, part.object_rotation, part.skeleton_center, part.sphere_radius) == (
        -1, -1, 0, 8)


def test_param_scene_layout_matches_cuda_source():
    """The ctypes mirror lists ``ParamScene``'s fields in order, with the
    same types and array lengths (the library also checks sizeof at load)."""
    header = (ROOT / "bsdmg_tpu_torch" / "csrc" / "param_sdf.cuh").read_text()
    assert '#include "param_sdf.cuh"' in (ROOT / diff_kernel.SOURCE).read_text()
    assert f"#define BSDMG_MAX_PARAMS {diff_kernel.MAX_PARAMS} " in header
    types = {"int": ctypes.c_int, "float": ctypes.c_float,
             "int*": ctypes.c_void_p,  # a composed scene's parameter program in device memory
             "float*": ctypes.c_void_p,  # a mesh asset's grid table in device memory
             "GridBox": GridBoxC}
    fields = _c_struct_fields(header, "ParamScene")
    py = diff_kernel._ParamSceneC._fields_
    assert [f[1] for f in fields] == [f[0] for f in py]
    for (c_type, _, length), (_, py_type) in zip(fields, py):
        if length is None:
            assert py_type is types[c_type]
        else:
            assert py_type._type_ is types[c_type]
            want = diff_kernel.MAX_PARAMS if length == "BSDMG_MAX_PARAMS" else int(length)
            assert py_type._length_ == want
