"""The port's library beside the kernels against the JAX package, on the CPU:
``sdf/primitives.py``'s helpers, ``sdf/normals.py``, ``ops/shade.py::
render_image_c``, ``utils/`` (logging, timing, debug, containers),
``models/motion.py::SceneSettings`` and ``cam/sampling.py``; the
counterpart of ``tests/test_sdf.py`` and ``tests/test_components.py``.

The same seeded numpy inputs go through each JAX function and its port.
Bars: the primitives within 1e-6 (XLA fuses and PyTorch does not, so a
sum may round apart in the last bit), their gradients within 1e-5; exact
where both compute in integers or compare (the AABB tests, the
containers, the texel fetches); the analytic normals within 1e-5; the
fd4 normals within 1e-3, as ``tests/test_torch_sdf.py`` holds
``normal_fd4`` (the stencil divides rounding by ``eps`` = 1e-3: a value 1
ulp apart moves a component 1e-4), and so the Newton projections with fd4
normals (their points within 1e-3, both packages' on the surface within
the tolerance), with analytic ones within 1e-5; the
component-form render within the renders' PNG bars of
``tests/test_torch_render_kernel.py`` (each channel within 2 of 255 after
rounding to 8 bits, the mean under 0.05 of a level: JAX contracts FMAs in
the march).
"""

import logging
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsdmg_tpu import sdf as jsdf
from bsdmg_tpu.cam import sampling as jsampling
from bsdmg_tpu.models import motion as jmotion
from bsdmg_tpu.ops import shade as jshade
from bsdmg_tpu.sdf import normals as jnormals
from bsdmg_tpu.sdf import primitives as jprim
from bsdmg_tpu.utils import containers as jcontainers
from bsdmg_tpu_torch import sdf as tsdf
from bsdmg_tpu_torch.cam import generate_rays, look_at
from bsdmg_tpu_torch.cam import sampling as tsampling
from bsdmg_tpu_torch.models import motion as tmotion
from bsdmg_tpu_torch.ops import shade as tshade
from bsdmg_tpu_torch.sdf import normals as tnormals
from bsdmg_tpu_torch.sdf import primitives as tprim
from bsdmg_tpu_torch.utils import (
    BitSet,
    BoundedArray,
    Timer,
    assert_finite,
    block_and_time,
    checked_sdf,
    debug_mode,
    get_logger,
    vec_maximum,
    vec_minimum,
)

torch.set_num_threads(1)

RNG = np.random.default_rng(2024)
POINTS = RNG.uniform(-2.5, 2.5, (512, 3)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rays(eye, size):
    """A frame's rays as numpy arrays, from the port's camera (held
    against the JAX package's in ``tests/test_torch_camera.py``)."""
    rays = generate_rays(look_at(eye, fov=np.pi / 4, device="cpu"), size, (1920.0, 1080.0))
    return tuple(a.numpy() for a in rays)


def _close(got, ref, atol=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# sdf/primitives.py
# ---------------------------------------------------------------------------

#: each helper with its arguments beside the points
PRIMITIVES = {
    "sd_unit_sphere": (),
    "sd_unit_cube": (),
    "sd_simple_box": ((0.2, -0.1, 0.3), (1.5, 1.0, 2.0)),
    "sd_bounding_box": ((-1.0, -0.5, -0.8), (1.2, 0.7, 0.9)),
    "sd_ray": ((0.1, 0.2, -0.3), (0.6, 0.0, 0.8)),
    "sd_unit_mandelbulb": (),
}


@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_primitive_matches_jax(name):
    args = PRIMITIVES[name]
    ours = getattr(tsdf, name)(_t(POINTS), *args)
    jf = lambda q: getattr(jsdf, name)(q, *(jnp.asarray(a) for a in args))  # noqa: E731
    ref = jax.jit(jf)(jnp.asarray(POINTS))
    _close(ours, ref, atol=1e-5 if name == "sd_unit_mandelbulb" else 1e-6)
    if name != "sd_unit_mandelbulb":
        p = _t(POINTS).requires_grad_()
        (g,) = torch.autograd.grad(getattr(tsdf, name)(p, *args).sum(), p)
        _close(g, jax.jit(jax.grad(lambda q: jnp.sum(jf(q))))(jnp.asarray(POINTS)), atol=1e-5)


def test_smooth_max_matches_jax():
    a, b = RNG.normal(size=(2, 256)).astype(np.float32)
    for k in (0.1, 0.5, 2.0):
        _close(tsdf.smooth_max(_t(a), _t(b), k), jprim.smooth_max(jnp.asarray(a), jnp.asarray(b), k))
    assert tsdf.smooth_max(_t(a), _t(b), 0.5).ge(torch.maximum(_t(a), _t(b))).all()


def test_aabb_helpers_match_jax():
    lo, hi = (-1.0, -0.5, -0.8), (1.2, 0.7, 0.9)
    assert torch.equal(tsdf.inside_aabb(_t(POINTS), lo, hi),
                       torch.from_numpy(np.array(jsdf.inside_aabb(jnp.asarray(POINTS), lo, hi))))
    d = RNG.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:20, 0] = 0.0  # rays parallel to a slab, inside and outside it
    ours = tsdf.ray_distance_to_bb(_t(POINTS), _t(d), lo, hi)
    ref = np.asarray(jsdf.ray_distance_to_bb(jnp.asarray(POINTS), jnp.asarray(d), lo, hi))
    miss = ref == np.float32(3.40282347e38)
    assert miss.any() and (ref == 0.0).any() and (~miss & (ref > 0)).any()
    np.testing.assert_array_equal(ours.numpy() == np.float32(3.40282347e38), miss)
    np.testing.assert_allclose(ours.numpy()[~miss], ref[~miss], atol=1e-5, rtol=1e-6)


# ---------------------------------------------------------------------------
# sdf/normals.py
# ---------------------------------------------------------------------------


def _scenes():
    """A small scene in both packages, from the libraries' own primitives
    (a sphere smoothly joined to a box): its points and component SDFs."""

    def scene(lib, stack):
        def f(p):
            return lib.smooth_min(lib.sd_sphere(p, (0.3, -0.2, 0.1), 0.9),
                                  lib.sd_box(p, (-0.4, 0.2, 0.0), (1.2, 0.8, 1.5)), 0.3)

        return f, lambda x, y, z: f(stack([x, y, z], -1))

    ours = scene(tsdf, lambda v, a: torch.stack(v, dim=a))
    ref = scene(jsdf, lambda v, a: jnp.stack(v, axis=a))
    return (*ours, *ref)


def test_normals_match_jax():
    """(The JAX functions jitted: one compile each, not one an operation.)"""
    tf, tc, jf, jc = _scenes()
    p, jp = _t(POINTS), jnp.asarray(POINTS)
    _close(tnormals.normal_grad(tf, p), jax.jit(lambda q: jnormals.normal_grad(jf, q))(jp),
           atol=1e-5)
    for ours, ref in zip(tnormals.normal_plane(tf, p),
                         jax.jit(lambda q: jnormals.normal_plane(jf, q))(jp)):
        _close(ours, ref, atol=1e-3)
    planes = [p[:, a] for a in range(3)]
    for ours, ref in zip(tnormals.normal_fd4_c(tc, *planes),
                         jax.jit(lambda q: jnormals.normal_fd4_c(jc, *q.T))(jp)):
        _close(ours, ref, atol=1e-3)
    for ours, ref in zip(tnormals.normal_jvp_c(tc, *planes),
                         jax.jit(lambda q: jnormals.normal_jvp_c(jc, *q.T))(jp)):
        _close(ours, ref, atol=1e-5)
    jplanes = [jp[:, a] for a in range(3)]
    # as_component: the points SDF on planes
    _close(tnormals.as_component(tf)(*planes), jax.jit(jnormals.as_component(jf))(*jplanes),
           atol=1e-6)


@pytest.mark.parametrize("use_grad_normal", [False, True])
def test_closest_surface_point_matches_jax(use_grad_normal):
    tf, tc, jf, jc = _scenes()
    start = POINTS[:128] * 0.6
    mask = RNG.random(128) < 0.8
    ours = tnormals.closest_surface_point(tf, _t(start), use_grad_normal=use_grad_normal,
                                          mask=_t(mask))
    ref = jax.jit(lambda q, m: jnormals.closest_surface_point(
        jf, q, use_grad_normal=use_grad_normal, mask=m))(jnp.asarray(start), jnp.asarray(mask))
    _close(ours, ref, atol=1e-5 if use_grad_normal else 1e-3)
    np.testing.assert_array_equal(ours.numpy()[~mask], start[~mask])
    assert np.abs(tf(ours).numpy()[mask]).max() <= 1e-5
    if not use_grad_normal:
        got = tnormals.closest_surface_point_c(tc, *(_t(start[:, a]) for a in range(3)),
                                               mask=_t(mask))
        want = jax.jit(lambda q, m: jnormals.closest_surface_point_c(jc, *q.T, mask=m))(
            jnp.asarray(start), jnp.asarray(mask))
        for g, w in zip(got, want):
            _close(g, w, atol=1e-3)
        assert np.abs(tc(*got).numpy()[mask]).max() <= 1e-5


# ---------------------------------------------------------------------------
# ops/shade.py: render_image_c, use_grad_normal
# ---------------------------------------------------------------------------


def _rgb8(img):
    return np.floor(np.clip(np.asarray(img), 0.0, 1.0) * 255.0).astype(np.int32)


def _csdf_p(lib):
    """A param-traced component SDF in either package: a sphere of centre
    ``q["c"]`` and radius ``q["r"]`` smoothly joined to a box."""

    def f(q, x, y, z):
        return lib.smooth_min(lib.sd_sphere_c(x, y, z, q["c"], q["r"]),
                              lib.sd_box_c(x, y, z, (-0.4, 0.2, 0.0), (1.2, 0.8, 1.5)), 0.3)

    return f


@pytest.mark.parametrize("use_grad_normal", [False, True])
def test_render_image_c_matches_jax(use_grad_normal):
    """The param-traced component-form render at run-time parameters
    against JAX's."""
    o, d, c = _rays((4.0, 2.0, -4.0), (48, 32))
    params = {"c": np.asarray([0.3, -0.2, 0.1], np.float32), "r": np.float32(0.9)}
    ours = tshade.render_image_c(_csdf_p(tprim), {k: _t(v) for k, v in params.items()},
                                 *(_t(a) for a in (o, d, c)), use_grad_normal=use_grad_normal)
    ref = jax.jit(lambda q, *r: jshade.render_image_c(_csdf_p(jprim), q, *r,
                                                      use_grad_normal=use_grad_normal))(
        {k: jnp.asarray(v) for k, v in params.items()}, o, d, c)
    assert ours.shape == (32, 48, 3)
    diff = np.abs(_rgb8(ours.numpy()) - _rgb8(ref))
    assert diff.max() <= 2 and diff.mean() < 0.05, (diff.max(), diff.mean())
    assert (_rgb8(ours.numpy()).sum(axis=-1) > 0).sum() > 100


def test_render_image_with_grad_normals_matches_jax():
    o, d, c = _rays((5.0, 2.0, -5.0), (24, 16))
    tf, _, jf, _ = _scenes()
    ours = tshade.render_image(tf, *(_t(a) for a in (o, d, c)), use_grad_normal=True)
    ref = jax.jit(lambda *r: jshade.render_image(jf, *r, use_grad_normal=True))(o, d, c)
    diff = np.abs(_rgb8(ours.numpy()) - _rgb8(ref))
    assert diff.max() <= 2 and diff.mean() < 0.05, (diff.max(), diff.mean())


# ---------------------------------------------------------------------------
# utils: containers, timing, logging, debug
# ---------------------------------------------------------------------------


def test_vec_reductions_match_jax():
    v = RNG.normal(size=(64, 3)).astype(np.float32)
    _close(vec_minimum(_t(v)), jcontainers.vec_minimum(jnp.asarray(v)))
    _close(vec_maximum(_t(v)), jcontainers.vec_maximum(jnp.asarray(v)))


@pytest.mark.parametrize("n", [1, 31, 100, 129])
def test_bitset_matches_jax(n):
    mask = RNG.random(n) < 0.4
    ours = BitSet.from_mask(_t(mask))
    ref = jcontainers.BitSet.from_mask(jnp.asarray(mask))
    np.testing.assert_array_equal(ours.words.numpy(), np.asarray(ref.words).astype(np.int64))
    assert int(ours.count()) == int(ref.count()) == int(mask.sum())
    assert ours.capacity == ref.capacity
    np.testing.assert_array_equal(ours.to_mask(n).numpy(), mask)
    bs = BitSet.zeros(n, device="cpu").set(0).set(n - 1)
    jbs = jcontainers.BitSet.zeros(n).set(0).set(n - 1)
    np.testing.assert_array_equal(bs.words.numpy(), np.asarray(jbs.words).astype(np.int64))
    if n > 1:
        cleared = bs.set(n - 1, False)
        assert bool(cleared.get(0)) and not bool(cleared.get(n - 1)) and int(cleared.count()) == 1
    full = BitSet.from_mask(torch.ones(64, dtype=torch.bool))
    assert int(full.count()) == 64 and int(full.words.max()) == 0xFFFFFFFF


def test_bounded_array_matches_jax():
    ours = BoundedArray.empty(3, (2,), device="cpu")
    ref = jcontainers.BoundedArray.empty(3, (2,))
    for v in ([1.0, 2.0], [3.0, 4.0], [5.0, 6.0], [7.0, 8.0]):  # the 4th drops
        ours, ref = ours.push(v), ref.push(jnp.asarray(v))
    assert int(ours.count) == int(ref.count) == 3 and ours.capacity == 3
    np.testing.assert_array_equal(ours.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(ours.live_mask().numpy(), np.asarray(ref.live_mask()))
    np.testing.assert_array_equal(ours.get(1).numpy(), [3.0, 4.0])
    part = BoundedArray.empty(4, device="cpu").push(2.5)
    np.testing.assert_array_equal(part.live_mask().numpy(), [True, False, False, False])


def test_timer_and_block_and_time():
    timer = Timer()
    with timer.phase("a"):
        torch.ones(8).sum()
    with timer.phase("a"):
        pass
    assert set(timer.phases) == {"a"} and timer.phases["a"] > 0
    assert timer.report().startswith("a=") and timer.report().endswith("ms")
    calls = []

    def work(x, scale=1.0):
        calls.append(1)
        return {"y": (x * scale, [x + 1])}

    out, best = block_and_time(work, torch.ones(4), scale=2.0, iters=3, warmup=2)
    assert len(calls) == 5 and best > 0
    assert torch.equal(out["y"][0], torch.full((4,), 2.0))


def test_get_logger_as_jax(caplog):
    from bsdmg_tpu.utils import get_logger as jax_get_logger

    assert get_logger().name == jax_get_logger().name == "bsdmg"
    log = get_logger("bsdmg_test_library")
    assert log.level == logging.INFO and len(log.handlers) == 1
    assert get_logger("bsdmg_test_library") is log and len(log.handlers) == 1


def test_checked_sdf_and_assert_finite():
    err, d = checked_sdf(lambda p: torch.linalg.vector_norm(p, dim=-1) - 1.0)(torch.ones(4, 3))
    err.throw()
    assert err.get() is None and d.shape == (4,)
    err, _ = checked_sdf(lambda p: p[..., 0] / 0.0, name="bad")(torch.ones(4, 3))
    assert err.get() == "bad: non-finite distance detected"
    with pytest.raises(FloatingPointError, match="bad: non-finite"):
        err.throw()
    assert_finite(torch.ones(3))
    with pytest.raises(FloatingPointError, match="x: 1 non-finite"):
        assert_finite(torch.tensor([1.0, float("nan")]), "x")


def test_debug_mode_traps_nans_and_restores():
    x = torch.tensor([0.0], requires_grad=True)
    with debug_mode(), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # anomaly mode's traceback of the forward call
        assert torch.is_anomaly_enabled()
        y = torch.sqrt(x) * 0.0  # d sqrt at 0 is inf, times 0: NaN in the backward
        with pytest.raises(RuntimeError, match="nan"):
            y.sum().backward()
    assert not torch.is_anomaly_enabled()
    with debug_mode(nan_checks=False, x64=True):
        assert torch.ones(1).dtype == torch.float64
    assert torch.get_default_dtype() == torch.float32


# ---------------------------------------------------------------------------
# models/motion.py SceneSettings, cam/sampling.py
# ---------------------------------------------------------------------------


def test_scene_settings_as_jax():
    assert tmotion.SceneSettings() == tmotion.SceneSettings(enable_movement=False)
    assert tmotion.SceneSettings().enable_movement == jmotion.SceneSettings().enable_movement
    with pytest.raises(AttributeError):
        tmotion.SceneSettings().enable_movement = True  # frozen, as JAX's


def test_texel_fetches_match_jax():
    size = (4, 3)
    pts = np.asarray([[2, 1], [-5, 1], [9, 9], [0, 0], [3, 2], [-1, 5]])
    np.testing.assert_array_equal(tsampling.index_2d(_t(pts), size).numpy(),
                                  np.asarray(jsampling.index_2d(jnp.asarray(pts), size)))
    img = RNG.normal(size=(3, 4, 2)).astype(np.float32)
    for texture, sz in ((img, None), (img.reshape(12, 2), size)):
        np.testing.assert_array_equal(
            tsampling.fetch_2d(_t(pts), _t(texture), sz).numpy(),
            np.asarray(jsampling.fetch_2d(jnp.asarray(pts), jnp.asarray(texture), sz)))
    with pytest.raises(ValueError, match="explicit size"):
        tsampling.fetch_2d(_t(pts), _t(img.reshape(-1)))


def test_bicubic_sampling_matches_jax():
    img = RNG.normal(size=(9, 13)).astype(np.float32)
    p = RNG.uniform(-0.1, 1.1, (200, 2)).astype(np.float32)
    for texture, size in ((img, None), (img.reshape(-1), (13, 9))):
        ours = tsampling.ndc_to_interpolated_value(_t(p), _t(texture), size)
        ref = jax.jit(lambda q, t: jsampling.ndc_to_interpolated_value(q, t, size))(
            jnp.asarray(p), jnp.asarray(texture))
        _close(ours, ref, atol=1e-5)
    y = (1.0, 2.0, 5.0, 3.0)
    assert float(tsampling.cubic_interpolate(*y, 0.0)) == 2.0
    assert float(tsampling.cubic_interpolate(*y, 1.0)) == 5.0
