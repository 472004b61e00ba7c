"""The near/far scene split (``ops/cuda/csdf.py::compile_scene_split``)
through the port's render and differentiable render, against the JAX
package's (``bsdmg_tpu/ops/pallas/csdf.py::compile_scene_split``).

The kernels need nvcc and a card; chip_smoke.py holds them against their
plain versions there, bit for bit. Here the plain versions, which group the
rays as the kernels do (a warp's 8x4 patch, or 32 rays of K2's listed
tail), are held against the JAX package:

* ``compile_scene_split`` against JAX's: None for every scene but the
  reference render scene; for it the same near box and a far scene whose
  value and gradient equal JAX's far SDF within 1e-6;
* the render with the split against the render without it, at 256x64 from
  (5, 2, -5), in each of ``render_image_cuda``'s four pipelines, and
  against JAX's ``render_image_pallas(..., split=...)`` in interpret mode,
  under the JAX package's own bars (tests/test_pallas.py:293-323): max
  |drgb| > 1e-3 on fewer than 0.1% of the pixels, and a mean below 1e-5;
* K4's twin with the split against it without: every outcome equal, the
  depth of a hit within the collision distance (a far patch marches the
  wireframe alone and ends elsewhere in the hit window); K5's twin with the
  split against JAX's ``render_loss_grad_pallas(..., split=...)``: the
  loss to a relative 1e-4, gradients at rtol 1e-3, atol 1e-6
  (tests/test_torch_diff_edge.py's bars, whose with-split case holds the
  edge term);
* the CLI, ``render --sharded`` and the bench pass the split where the
  JAX package's do, with its inflation.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsdmg_tpu.cam import generate_rays, look_at
from bsdmg_tpu.models import get_scene as jax_get_scene
from bsdmg_tpu.models.compose import compose_scene as jax_compose_scene
from bsdmg_tpu.ops.pallas import compile_scene_csdf
from bsdmg_tpu.ops.pallas.csdf import compile_scene_split as jax_scene_split
from bsdmg_tpu.ops.pallas.csdf import scene_bounds as jax_scene_bounds
from bsdmg_tpu.ops.pallas.diff_kernel import render_loss_grad_pallas
from bsdmg_tpu.ops.pallas.render_kernel import render_image_pallas
from bsdmg_tpu_torch import bench, cli
from bsdmg_tpu_torch.config import MarchConfig
from bsdmg_tpu_torch.models import get_scene, reference_render_scene
from bsdmg_tpu_torch.models.compose import compose_scene
from bsdmg_tpu_torch.ops.cuda import render_kernel as rk
from bsdmg_tpu_torch.ops.cuda.csdf import (
    compile_scene,
    compile_scene_split,
    descriptor_csdf,
    scene_bounds,
)
from bsdmg_tpu_torch.ops.cuda.diff_kernel import (
    march_params_cuda,
    render_loss_grad_cuda,
    render_loss_grad_torch,
)
from bsdmg_tpu_torch.weights import params_from_numpy
from test_torch_compose import SPECS

# one intra-op thread, as the other port tests
torch.set_num_threads(1)

COLLISION = 0
TRANSFORM = ("object_center", "object_rotation")


def _rays(w, h):
    rays = generate_rays(look_at((5.0, 2.0, -5.0), fov=np.pi / 4), (w, h), (1920.0, 1080.0))
    arrays = tuple(np.array(a) for a in rays)
    return arrays, tuple(torch.from_numpy(a) for a in arrays)


def _inflated(bounds, by):
    lo, hi, slack = bounds
    return (tuple(v - by for v in lo), tuple(v + by for v in hi), slack)


def assert_split_bars(a, b):
    """The JAX package's bars for a split render against another render of
    the same frame (tests/test_pallas.py:320-323)."""
    diff = np.abs(np.asarray(a) - np.asarray(b)).max(-1)
    assert (diff > 1e-3).mean() < 1e-3, f"{(diff > 1e-3).sum()} pixels over 1e-3"
    assert diff.mean() < 1e-5


# ---------------------------------------------------------------------------
# compile_scene_split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["reference_render_scene", "reference_object", "sphere", "box",
                                  "mandelbulb", "wrapped_object", "snowman"])
def test_compile_scene_split_equals_jax(name):
    if name in SPECS:
        jscene = jax_compose_scene(copy.deepcopy(SPECS[name]))
        scene = compose_scene(copy.deepcopy(SPECS[name]), device="cpu")
    else:
        jscene, scene = jax_get_scene(name), get_scene(name, device="cpu")
    ref, got = jax_scene_split(jscene), compile_scene_split(scene)
    if ref is None:
        assert got is None
        return
    far, (lo, hi, slack) = got
    _, (rlo, rhi, rslack) = ref
    np.testing.assert_allclose(lo, rlo, rtol=0, atol=1e-6)
    np.testing.assert_allclose(hi, rhi, rtol=0, atol=1e-6)
    assert slack == rslack
    assert far.kind == "wireframe" and far.object is None


def test_far_scene_equals_jax_far_sdf():
    """The far scene's value (the Far structure's twin) against JAX's far
    SDF on random points, 1e-6."""
    (jfar, _), (far, _) = (jax_scene_split(jax_get_scene("reference_render_scene")),
                           compile_scene_split(reference_render_scene(device="cpu")))
    p = np.random.default_rng(0).uniform(-3.2, 3.2, (4000, 3)).astype(np.float32)
    x, y, z = (torch.from_numpy(p[:, a].copy()) for a in range(3))
    jx, jy, jz = (jnp.asarray(p[:, a]) for a in range(3))
    ref = np.asarray(jfar(jx, jy, jz))
    np.testing.assert_allclose(descriptor_csdf(far)(x, y, z).numpy(), ref, atol=1e-6)


# ---------------------------------------------------------------------------
# the render (K1, K2, K3: their plain twins)
# ---------------------------------------------------------------------------

PIPELINES = {"fused": {}, "block": dict(two_phase="block"), "row": dict(two_phase=True),
             "unfused": dict(swizzle=False)}


@pytest.fixture(scope="module")
def frame():
    scene = reference_render_scene(device="cpu")
    arrays, rays = _rays(256, 64)
    return scene, compile_scene(scene), compile_scene_split(scene), arrays, rays


@pytest.mark.parametrize("pipeline", sorted(PIPELINES))
def test_split_render_meets_jax_bars_against_unsplit(frame, pipeline):
    """Every pipeline of ``render_image_cuda`` with the split against the
    same pipeline without it: the JAX package's bars, every outcome equal,
    and the split's far patches take fewer steps in all."""
    _, desc, split, _, rays = frame
    kw = PIPELINES[pipeline]
    a = rk.render_image_cuda(desc, *rays, return_planes=True, **kw)
    b = rk.render_image_cuda(desc, *rays, return_planes=True, split=split, **kw)
    assert_split_bars(a[0].numpy(), b[0].numpy())
    assert torch.equal(a[3], b[3])
    assert int(b[2].sum()) < int(a[2].sum())


def test_split_render_meets_jax_bars_against_jax_split(frame):
    """The fused render with the split against JAX's
    ``render_image_pallas(..., split=...)`` in interpret mode."""
    _, desc, split, (o, d, c), rays = frame
    jscene = jax_get_scene("reference_render_scene")
    ref = render_image_pallas(compile_scene_csdf(jscene), o, d, c, bb=jax_scene_bounds(jscene),
                              split=jax_scene_split(jscene), interpret=True)
    assert_split_bars(rk.render_image_cuda(desc, *rays, split=split).numpy(), ref)


def test_split_twin_groups_rays_as_the_kernels(frame):
    """The twin's vote: a far decision is one per 8x4 patch (K1, K2), or per
    32 listed rays of the row tail's list, which ``tail_list`` keeps in
    8x4-patch order (K2's listed tail); some patches go far and some not."""
    _, desc, split, _, (o, d, c) = frame
    h, w = c.shape
    planes = rk._flat_rays(o, d, c)
    active = torch.ones(h * w, dtype=torch.bool)
    far = rk.far_rays(split, *planes, MarchConfig(), active, rk.patch_groups(h, w, "cpu"))
    by_patch = far.reshape(h // 4, 4, w // 8, 8)
    assert (by_patch.all(dim=(1, 3)) | ~by_patch.any(dim=(1, 3))).all()
    assert far.any() and not far.all()
    flags = torch.zeros(h * w, dtype=torch.int32)
    flags[::3] = 1
    index, count = rk.tail_list(flags.reshape(h, w), split)
    groups = rk.listed_groups(index, count, h * w)
    order = rk.patch_order(h, w, "cpu").long()
    in_order = order[flags[order] != 0]
    assert (groups[in_order] == torch.arange(int(count)) // 32).all()
    assert (groups[1::3] == -1).all()
    listed = rk.far_rays(split, *planes, MarchConfig(), flags != 0, groups)
    for g in range(int(groups.max()) + 1):
        members = listed[groups == g]
        assert members.all() or not members.any()


@pytest.mark.parametrize("what", ["render", "march"])
def test_split_rejected_where_it_is_not_built(what):
    """The split is built for the reference render scene (K1, K2: Box<true,
    *>; K4, K5: its form with the wireframe), as compile_scene_split gives
    it; another scene raises."""
    split = compile_scene_split(reference_render_scene(device="cpu"))
    _, rays = _rays(16, 8)
    sphere = get_scene("sphere", device="cpu")
    with pytest.raises(NotImplementedError, match="split"):
        if what == "render":
            rk.render_image_cuda(compile_scene(sphere), *rays, split=split)
        else:
            march_params_cuda(sphere.csdf, sphere.params, *rays, split=split)


# ---------------------------------------------------------------------------
# the differentiable render (K4, K5: their plain twins)
# ---------------------------------------------------------------------------


def test_split_march_params_against_unsplit():
    """K4's twin with the split (near box +0.6, as the CLI's fit) against it
    without: outcomes equal, the depth of every hit within the collision
    distance, steps fewer in all."""
    scene = reference_render_scene(device="cpu")
    _, rays = _rays(64, 32)
    bb = _inflated(scene_bounds(scene), 0.6)
    far, near = compile_scene_split(scene)
    split = (far, _inflated(near, 0.6))
    a = march_params_cuda(scene.csdf, scene.params, *rays, bb=bb, track_min=True)
    b = march_params_cuda(scene.csdf, scene.params, *rays, bb=bb, track_min=True, split=split)
    assert torch.equal(a[2], b[2])
    hit = a[2] == COLLISION
    assert hit.sum() > 100
    assert (a[0] - b[0]).abs()[hit].max() <= MarchConfig().collision_distance
    assert int(b[1].sum()) < int(a[1].sum())
    assert torch.isfinite(b[3]).all() and torch.isfinite(b[4]).all()


def test_split_loss_grad_matches_pallas():
    """K5's twin with the split against JAX's with its split, both near
    boxes inflated by 0.25 (the bench's grad point), a seed-1 random target
    and the sphere's radius at 1.15."""
    jscene, scene = jax_get_scene("reference_render_scene"), reference_render_scene(device="cpu")
    jp = {k: v for k, v in jscene.params.items() if k not in TRANSFORM}
    jp["sphere_radius"] = jnp.float32(1.15)
    p = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    (o, d, c), rays = _rays(64, 32)
    bb = _inflated(jax_scene_bounds(jscene), 0.25)
    jfar, jnear = jax_scene_split(jscene)
    far, near = compile_scene_split(scene)
    target = np.random.default_rng(1).uniform(0, 1, (32, 64, 3)).astype(np.float32)
    ref_loss, ref_g = render_loss_grad_pallas(jscene.csdf, jp, jnp.asarray(target), o, d, c,
                                              bb=bb, split=(jfar, _inflated(jnear, 0.25)),
                                              interpret=True)
    loss, g = render_loss_grad_cuda(scene.csdf, p, torch.from_numpy(target), *rays, bb=bb,
                                    split=(far, _inflated(near, 0.25)))
    same, _ = render_loss_grad_torch(scene.csdf, p, torch.from_numpy(target), *rays, bb=bb,
                                     split=(far, _inflated(near, 0.25)))
    assert torch.equal(loss, same)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-4)
    for k in ref_g:
        np.testing.assert_allclose(g[k].numpy(), np.asarray(ref_g[k]), rtol=1e-3, atol=1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the callers
# ---------------------------------------------------------------------------


def _spy(monkeypatch, module, name):
    """Records the ``split`` of each call of ``module.name``."""
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(kwargs.get("split"))
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("scene", ["reference_render_scene", "sphere"])
def test_cli_render_passes_the_split(monkeypatch, tmp_path, scene):
    """``cli render`` passes compile_scene_split's split, as the JAX CLI's
    _renderer does: the reference render scene's, None for another."""
    calls = _spy(monkeypatch, cli, "render_image_cuda")
    assert cli.main(["render", "--device", "cpu", "--scene", scene, "--width", "32", "--height",
                     "16", "-o", str(tmp_path / "r.npy")]) == 0
    (split,) = calls
    ref = compile_scene_split(get_scene(scene, device="cpu"))
    assert (split is None) == (ref is None)
    if ref is not None:
        assert split[1] == ref[1] and split[0].frame == ref[0].frame


def test_cli_render_sharded_with_the_split_equals_render(monkeypatch, tmp_path):
    """``cli render --sharded`` (a world of one) passes the split to
    render_sharded_pallas, and its frame equals ``cli render``'s."""
    import torch.distributed as dist

    from bsdmg_tpu_torch.parallel import sharding

    calls = _spy(monkeypatch, sharding, "render_image_cuda")
    try:
        size = ["--device", "cpu", "--width", "48", "--height", "20"]
        cli.main(["render", *size, "-o", str(tmp_path / "u.npy")])
        cli.main(["render", "--sharded", *size, "-o", str(tmp_path / "s.npy")])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert len(calls) == 1 and calls[0] is not None
    np.testing.assert_array_equal(np.load(tmp_path / "s.npy"), np.load(tmp_path / "u.npy"))


def test_cli_fit_image_passes_the_inflated_split(monkeypatch, caplog):
    """``cli fit --image`` passes the split with its near box inflated by
    0.6 to every step, as the JAX CLI's fit does."""
    calls = _spy(monkeypatch, cli, "render_loss_and_grad")
    assert cli.main(["fit", "--image", "--device", "cpu", "--width", "16", "--height", "12",
                     "--steps", "2"]) == 0
    assert len(calls) == 2
    far, near = compile_scene_split(reference_render_scene(device="cpu"))
    for split in calls:
        assert split[1] == _inflated(near, 0.6) and split[0].frame == far.frame


@pytest.mark.parametrize("cell", ["render", "grad"])
def test_bench_passes_the_split(monkeypatch, cell):
    """bench's render cell passes the split as compile_scene_split gives it,
    its grad cell with the near box inflated by 0.25, as the JAX package's
    bench does."""
    monkeypatch.setattr(bench, "_slope_time", lambda many, **kw: many(1) * 0.0 + 1.0)
    far, near = compile_scene_split(reference_render_scene(device="cpu"))
    if cell == "render":
        calls = _spy(monkeypatch, bench, "render_image_cuda")
        bench.benchmark_render(32, 16, device="cpu")
        want = near
    else:
        calls = _spy(monkeypatch, bench, "render_loss_and_grad")
        bench.benchmark_render_grad(16, 16, device="cpu")
        want = _inflated(near, 0.25)
    assert calls and all(split[1] == want and split[0].frame == far.frame for split in calls)
