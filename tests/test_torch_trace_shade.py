"""The port's plain tracer and shading (ops/trace.py, ops/shade.py) against
the JAX package's.

The oracle tracer on the point-form scene SDF must give the same outcomes
and step counts as JAX's on every ray; depth and colours agree to float32
rounding (XLA contracts multiply-adds into FMAs, PyTorch does not).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsdmg_tpu.cam import generate_rays, look_at
from bsdmg_tpu.models import reference_render_scene as jax_scene
from bsdmg_tpu.ops import shade as jshade
from bsdmg_tpu.ops import trace as jtrace
from bsdmg_tpu_torch.models import reference_render_scene
from bsdmg_tpu_torch.ops import shade as tshade
from bsdmg_tpu_torch.ops import trace as ttrace

# one intra-op thread: PyTorch's spinning OpenMP pool would otherwise take
# every core from the timing-sensitive tests that run beside these
torch.set_num_threads(1)


def _rays(w=64, h=36):
    o, d, c = generate_rays(look_at((5.0, 2.0, -5.0), fov=np.pi / 4), (w, h), (1920.0, 1080.0))
    return (o, d, c), tuple(torch.from_numpy(np.array(x)) for x in (o, d, c))


def test_outcome_codes_match_jax():
    assert (ttrace.COLLISION, ttrace.STEP_LIMIT, ttrace.DEPTH_LIMIT) == (
        jtrace.COLLISION, jtrace.STEP_LIMIT, jtrace.DEPTH_LIMIT,
    )


def test_sphere_trace_matches_jax():
    (jo, jd, jc), (o, d, c) = _rays()
    ref = jtrace.sphere_trace(jax_scene().bind(), jo, jd, jc)
    hit = ttrace.sphere_trace(reference_render_scene(device="cpu").bind(), o, d, c)
    np.testing.assert_array_equal(hit.outcome.numpy(), np.asarray(ref.outcome))
    np.testing.assert_array_equal(hit.steps.numpy(), np.asarray(ref.steps))
    coll = hit.outcome.numpy() == ttrace.COLLISION
    assert coll.sum() > 100
    assert np.abs(hit.depth.numpy() - np.asarray(ref.depth))[coll].max() < 1e-4
    np.testing.assert_allclose(hit.position.numpy()[coll], np.asarray(ref.position)[coll], atol=1e-4)


def test_render_image_matches_jax():
    (jo, jd, jc), (o, d, c) = _rays()
    ref = np.asarray(jshade.render_image(jax_scene().bind(), jo, jd, jc))
    img = tshade.render_image(reference_render_scene(device="cpu").bind(), o, d, c).numpy()
    diff = np.abs(img - ref).max(axis=-1)
    assert np.mean(diff < 2e-2) >= 0.999
    assert diff.mean() < 1e-4


def test_aces_tonemap_matches_jax():
    rng = np.random.default_rng(1)
    rgb = rng.uniform(0, 1.5, (256, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tshade.aces_tonemap(torch.from_numpy(rgb)).numpy(),
        np.asarray(jshade.aces_tonemap(jnp.asarray(rgb))), atol=1e-6,
    )


def test_shade_planes_matches_jax():
    rng = np.random.default_rng(2)
    n = rng.standard_normal((3, 512)).astype(np.float32)
    n /= np.linalg.norm(n, axis=0)
    outcome = rng.integers(0, 3, 512).astype(np.int32)
    ref = jshade.shade_planes(*(jnp.asarray(x) for x in n), jnp.asarray(outcome))
    got = tshade.shade_planes(*(torch.from_numpy(x) for x in n), torch.from_numpy(outcome))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("rgb", [[[0.0, 0.5, 1.0], [-1.0, 2.0, 0.999]], [[0.25, 0.75, 0.1], [1.0, 0.0, 0.3]]])
def test_to_rgba8_matches_jax(rgb):
    rgb = np.asarray(rgb, np.float32)
    got = tshade.to_rgba8(torch.from_numpy(rgb)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jshade.to_rgba8(jnp.asarray(rgb))))
    assert got.dtype == np.uint8
