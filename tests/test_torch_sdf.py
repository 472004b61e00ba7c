"""The port's SDF primitives, scenes and scene compiler against the JAX package.

The scene SDF is held to 2e-5 (tests/test_pallas.py:287); box-skeleton
edges and scene bounds are computed the same way on both sides and must be
equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsdmg_tpu.models import scenes as jscenes
from bsdmg_tpu.ops.pallas import csdf as jcsdf
from bsdmg_tpu.sdf import normals as jnormals
from bsdmg_tpu.sdf import primitives as jprim
from bsdmg_tpu_torch.models import scenes as tscenes
from bsdmg_tpu_torch.ops.cuda import csdf as tcsdf
from bsdmg_tpu_torch.sdf import normals as tnormals
from bsdmg_tpu_torch.sdf import primitives as tprim
from bsdmg_tpu_torch.weights import params_from_numpy

# one intra-op thread: PyTorch's spinning OpenMP pool would otherwise take
# every core from the timing-sensitive tests that run beside these
torch.set_num_threads(1)

ATOL = 2e-5
SCENE_NAMES = ["reference_render_scene", "reference_object"]


def _points(seed=0, shape=(8, 128)):
    rng = np.random.default_rng(seed)
    return rng.uniform(-4, 4, shape + (3,)).astype(np.float32)


def _transformed_params():
    """Default params with one non-identity rigid object transform."""
    p = {k: np.asarray(v) for k, v in jscenes.default_object_params().items()}
    p["object_center"] = np.asarray([0.3, -0.2, 0.5], np.float32)
    q = np.asarray([0.9, 0.2, -0.3, 0.25], np.float32)
    p["object_rotation"] = q / np.linalg.norm(q)
    return p


def _scenes(name):
    return jscenes.get_scene(name), tscenes.get_scene(name, device="cpu")


@pytest.mark.parametrize("compat", [True, False])
def test_box_skeleton_edges_equal(compat):
    for center, size in (((0.0, 0.0, 0.0), (3.0, 1.0, 0.5)), ((0.2, -0.1, 0.3), (1.0, 2.0, 0.7))):
        ref = jprim._box_skeleton_edges(center, size, compat)
        got = tprim._box_skeleton_edges(center, size, compat)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("transformed", [False, True])
@pytest.mark.parametrize("name", SCENE_NAMES)
def test_scene_sdf_matches_jax(name, transformed):
    """Both the point-form scene SDF and the compiled descriptor's plane SDF
    against scene.bind() and compile_scene_csdf on 8x128 points in [-4, 4]^3."""
    jscene, tscene = _scenes(name)
    jparams = _transformed_params() if transformed else {k: np.asarray(v) for k, v in jscene.params.items()}
    tparams = params_from_numpy(jparams, "cpu")
    p = _points(seed=1 + transformed)

    ref_point = np.asarray(jscene.bind({k: jnp.asarray(v) for k, v in jparams.items()})(jnp.asarray(p)))
    got_point = tscene.bind(tparams)(torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got_point, ref_point, atol=ATOL)

    jf = jcsdf.compile_scene_csdf(jscene, jparams)
    ref_planes = np.asarray(jf(*(jnp.asarray(p[..., a]) for a in range(3))))
    f = tcsdf.descriptor_csdf(tcsdf.compile_scene(tscene, tparams))
    got_planes = f(*(torch.from_numpy(np.ascontiguousarray(p[..., a])) for a in range(3))).numpy()
    np.testing.assert_allclose(got_planes, ref_planes, atol=ATOL)
    np.testing.assert_allclose(got_planes, ref_point, atol=ATOL)


@pytest.mark.parametrize("transformed", [False, True])
@pytest.mark.parametrize("name", SCENE_NAMES)
def test_scene_bounds_equal(name, transformed):
    jscene, tscene = _scenes(name)
    jparams = _transformed_params() if transformed else None
    tparams = None if jparams is None else params_from_numpy(jparams, "cpu")
    ref = jcsdf.scene_bounds(jscene, jparams)
    got = tcsdf.scene_bounds(tscene, tparams)
    assert got == ref
    assert len(got) == 3 and got[2] > 0  # the smooth-min slack stays in


def test_descriptor_matches_jax_constants():
    """The compiled descriptor holds the capsule groups of the JAX compiler:
    12 axis-aligned segments per skeleton, the frame at line width 0.05."""
    desc = tcsdf.compile_scene(tscenes.reference_render_scene(device="cpu"))
    groups = jcsdf._axis_aligned_groups(*jprim._box_skeleton_edges((0, 0, 0), (3.0, 1.0, 0.5), True))
    for cs in (desc.object, desc.frame):
        assert sum(len(g.v1) * len(g.v2) for g in cs.groups) == 12
        assert sorted(g.axis for g in cs.groups) == [0, 1, 2]
    keys = {(g.axis, round(g.a0, 6), round(g.length, 6)) for g in desc.object.groups}
    assert keys == {(a, round(a0, 6), round(n, 6)) for a, a0, n in groups}
    assert desc.frame.radius == np.float32(0.05)
    assert desc.inv_rotation is None and desc.translation is None
    assert desc.bounds == jcsdf.scene_bounds(jscenes.reference_render_scene())


def test_unsupported_scene_raises():
    """A scene outside the compiler's registry (a composed scene's name
    here) raises; an unknown name raises KeyError."""
    dummy = tscenes.Scene("snowman", lambda q, p: p[..., 0], {})
    with pytest.raises(NotImplementedError, match="snowman"):
        tcsdf.compile_scene(dummy)
    with pytest.raises(NotImplementedError):
        tcsdf.scene_bounds(dummy)
    with pytest.raises(KeyError):
        tscenes.get_scene("no_such_scene", device="cpu")


def test_primitives_match_jax():
    rng = np.random.default_rng(5)
    p = rng.uniform(-2, 2, (64, 3)).astype(np.float32)
    a = rng.uniform(-1, 1, 64).astype(np.float32)
    b = rng.uniform(-1, 1, 64).astype(np.float32)
    tp = torch.from_numpy(p)
    np.testing.assert_allclose(
        tprim.smooth_min(torch.from_numpy(a), torch.from_numpy(b), 0.5).numpy(),
        np.asarray(jprim.smooth_min(jnp.asarray(a), jnp.asarray(b), 0.5)), atol=1e-6,
    )
    np.testing.assert_allclose(
        tprim.sd_sphere(tp, (0.1, 0.2, -0.3), 0.7).numpy(),
        np.asarray(jprim.sd_sphere(jnp.asarray(p), jnp.asarray([0.1, 0.2, -0.3]), 0.7)), atol=1e-6,
    )
    np.testing.assert_allclose(
        tprim.sd_line(tp, (0.0, -1.0, 0.5), (1.0, 1.0, -0.5)).numpy(),
        np.asarray(jprim.sd_line(jnp.asarray(p), (0.0, -1.0, 0.5), (1.0, 1.0, -0.5))), atol=1e-6,
    )
    for compat in (True, False):
        np.testing.assert_allclose(
            tprim.sd_box_skeleton(tp, (0.0, 0.0, 0.0), (3.0, 1.0, 0.5), 0.1, reference_compat=compat).numpy(),
            np.asarray(jprim.sd_box_skeleton(jnp.asarray(p), (0.0, 0.0, 0.0), (3.0, 1.0, 0.5), 0.1,
                                             reference_compat=compat)),
            atol=1e-6,
        )


def test_normal_fd4_matches_jax():
    jscene, tscene = _scenes("reference_render_scene")
    p = _points(seed=7, shape=(256,)) * 0.5
    ref = np.asarray(jnormals.normal_fd4(jscene.bind(), jnp.asarray(p)))
    got = tnormals.normal_fd4(tscene.bind(), torch.from_numpy(p)).numpy()
    # fd4 divides SDF rounding noise by eps = 1e-3
    np.testing.assert_allclose(got, ref, atol=1e-3)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
