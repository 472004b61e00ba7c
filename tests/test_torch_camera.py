"""The port's camera (bsdmg_tpu_torch.cam) against the JAX package's.

Tolerance: directions and cone radii to 1e-6, the bar tests/test_render.py
sets against the NumPy oracle. The two differ by a few float32 ulps because
XLA's CPU compiler contracts multiply-adds into FMAs and PyTorch does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsdmg_tpu.cam import camera as jcam
from bsdmg_tpu_torch.cam import camera as tcam
from bsdmg_tpu_torch.weights import camera_from_numpy

# one intra-op thread: PyTorch's spinning OpenMP pool would otherwise take
# every core from the timing-sensitive tests that run beside these
torch.set_num_threads(1)

ATOL = 1e-6
POSITIONS = [(5.0, 2.0, -5.0), (-3.0, 1.5, 4.0), (0.5, -2.0, 6.0)]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("position", POSITIONS)
def test_look_at_matches_jax(position):
    ref = jcam.look_at(position, fov=np.pi / 4)
    cam = tcam.look_at(position, fov=np.pi / 4, device="cpu")
    for field in tcam.Camera._fields:
        np.testing.assert_allclose(_np(getattr(cam, field)), _np(getattr(ref, field)), atol=ATOL)
        assert getattr(cam, field).dtype == torch.float32


@pytest.mark.parametrize("size", [(64, 36), (100, 37)])
def test_generate_rays_matches_jax(size):
    w, h = size
    ref = jcam.generate_rays(jcam.look_at((5.0, 2.0, -5.0), fov=np.pi / 4), size, (1920.0, 1080.0))
    cam = tcam.look_at((5.0, 2.0, -5.0), fov=np.pi / 4, device="cpu")
    origins, dirs, cone = tcam.generate_rays(cam, size, (1920.0, 1080.0))
    assert origins.shape == dirs.shape == (h, w, 3) and cone.shape == (h, w)
    for t in (origins, dirs, cone):
        assert t.dtype == torch.float32 and t.is_contiguous()
    np.testing.assert_array_equal(origins.numpy(), _np(ref[0]))
    np.testing.assert_allclose(dirs.numpy(), _np(ref[1]), atol=ATOL)
    np.testing.assert_allclose(cone.numpy(), _np(ref[2]), atol=ATOL)


def test_generate_rays_from_jax_camera():
    """A JAX camera carried across with camera_from_numpy gives the same rays."""
    jax_cam = jcam.look_at((-3.0, 1.5, 4.0), fov=0.9)
    ref = jcam.generate_rays(jax_cam, (48, 20), (48.0, 20.0))
    got = tcam.generate_rays(camera_from_numpy(jax_cam, "cpu"), (48, 20), (48.0, 20.0))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=ATOL)


def test_cone_operating_point_2560x1440():
    """The reference's own target, 2560x1440: a 64x36 tile at the image
    centre, computed from full-resolution pixel coordinates (the operating
    point of tests/test_render.py:196-208)."""
    w, h, tw, th = 2560, 1440, 64, 36
    x0, y0 = (w - tw) // 2, (h - th) // 2
    xs, ys = np.meshgrid(np.arange(x0, x0 + tw), np.arange(y0, y0 + th), indexing="xy")
    pix = np.stack([xs, ys], axis=-1).astype(np.float32)

    jax_cam = jcam.look_at((5.0, 2.0, -5.0), fov=np.pi / 4)
    cam = tcam.look_at((5.0, 2.0, -5.0), fov=np.pi / 4, device="cpu")
    ref_cone = _np(jcam.pixel_cone_radius(jnp.asarray(pix), jax_cam, (w, h), (w, h)))
    cone = tcam.pixel_cone_radius(torch.from_numpy(pix), cam, (w, h), (w, h)).numpy()
    assert 5.0e-4 < cone.max() < 6.5e-4
    np.testing.assert_allclose(cone, ref_cone, atol=ATOL)

    ref_dirs = _np(jcam._pixel_to_dir(jnp.asarray(pix), jax_cam, (w, h), (w, h)))
    dirs = tcam._pixel_to_dir(torch.from_numpy(pix), cam, (w, h), (w, h)).numpy()
    np.testing.assert_allclose(dirs, ref_dirs, atol=ATOL)


def test_texture_and_ndc_transforms_match_jax():
    rng = np.random.default_rng(3)
    p = rng.uniform(0, 200, (17, 2)).astype(np.float32)
    ndc = tcam.texture_to_ndc(torch.from_numpy(p), (200, 120))
    np.testing.assert_allclose(ndc.numpy(), _np(jcam.texture_to_ndc(jnp.asarray(p), (200, 120))), atol=ATOL)
    cam_plane = tcam.ndc_to_camera(ndc, (200, 120))
    ref = jcam.ndc_to_camera(jnp.asarray(ndc.numpy()), (200, 120))
    np.testing.assert_allclose(cam_plane.numpy(), _np(ref), atol=ATOL)
