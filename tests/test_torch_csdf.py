"""The scene SDF the kernels are compiled for, and the compile-time
structure they are built for.

The kernels take the scene's structure (csrc/scene_sdf.cuh,
``Box<Frame, Transform>``) as a template parameter: every capsule set a
box skeleton of 3 groups along x, y and z with 2 x 2 perpendicular
coordinates, the wireframe and the object transform there or not.
``descriptor_csdf`` is their plain twin, which they equal bit for bit on
the card; here it is held against the JAX compiler's SDF on points where
groups tie exactly, where the fixed group order and the minima matter.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsdmg_tpu.ops.pallas import csdf as jcsdf
from bsdmg_tpu_torch.models import scenes as tscenes
from bsdmg_tpu_torch.ops.cuda import csdf as tcsdf
from bsdmg_tpu_torch.ops.cuda import render_kernel
from bsdmg_tpu_torch.weights import params_from_numpy

torch.set_num_threads(1)

SCENE_HEADER = Path(tcsdf.__file__).resolve().parents[2] / "csrc" / "scene_sdf.cuh"
SCENE_NAMES = ["reference_render_scene", "reference_object"]
# tests/test_pallas.py:287, the JAX compiler's bar
ATOL = 2e-5


def _params(transformed: bool) -> dict:
    p = {k: v.numpy() for k, v in tscenes.default_object_params(device="cpu").items()}
    if transformed:
        p["object_center"] = np.asarray([0.3, -0.2, 0.5], np.float32)
        q = np.asarray([0.9, 0.2, -0.3, 0.25], np.float32)
        p["object_rotation"] = (q / np.linalg.norm(q)).astype(np.float32)
    return p


def _descriptor(name: str, transformed: bool):
    scene = tscenes.get_scene(name, device="cpu")
    return tcsdf.compile_scene(scene, params_from_numpy(_params(transformed), "cpu"))


def _points(seed: int) -> np.ndarray:
    """100,000 uniform points in [-4, 4]^3, the 0.25 lattice over [-3, 3]^3
    (the skeletons' and the wireframe's symmetry planes, where groups tie)
    and 2,001 points on each of the four cube diagonals (where the
    wireframe's three groups tie exactly)."""
    rng = np.random.default_rng(seed)
    uniform = rng.uniform(-4, 4, (100_000, 3))
    axis = np.arange(-3.0, 3.0 + 1e-9, 0.25)
    lattice = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)
    t = np.linspace(-4.0, 4.0, 2001)[:, None]
    diagonals = [t * np.asarray(s) for s in ((1, 1, 1), (1, -1, 1), (-1, 1, 1), (1, 1, -1))]
    return np.concatenate([uniform, lattice, *diagonals]).astype(np.float32)


def _planes(p: np.ndarray):
    return [torch.from_numpy(np.ascontiguousarray(p[:, a])) for a in range(3)]


def _group_ties(cs, coords) -> int:
    """Points where the set's minimum squared distance is attained by two
    or more of its groups."""
    d2 = torch.stack([tcsdf._group_d2(g, coords) for g in cs.groups])
    return int(((d2 == d2.min(0).values).sum(0) >= 2).sum())


@pytest.mark.parametrize("transformed", [False, True])
@pytest.mark.parametrize("name", SCENE_NAMES)
def test_sdf_at_group_ties_matches_jax(name, transformed):
    desc = _descriptor(name, transformed)
    p = _points(seed=11 + transformed)
    x, y, z = _planes(p)
    ours = tcsdf.descriptor_csdf(desc)(x, y, z)
    assert torch.isfinite(ours).all()

    # the points include exact ties between groups: the object's (in object
    # coordinates) on the lattice, the wireframe's on the diagonals
    ox, oy, oz = tcsdf._object_coords(desc, x, y, z)
    assert _group_ties(desc.object, (ox, oy, oz)) >= 100
    if desc.frame is not None:
        assert _group_ties(desc.frame, (x, y, z)) >= 2000

    jf = jcsdf.compile_scene_csdf(tscenes.get_scene(name, device="cpu"), _params(transformed))
    ref = np.asarray(jf(*(jnp.asarray(p[:, a]) for a in range(3))))
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("transformed", [False, True])
@pytest.mark.parametrize("name", SCENE_NAMES)
def test_kernel_structure_of_every_scene_that_compiles(name, transformed):
    """2 * frame + transform, for the default parameters, the fit's
    perturbed ones and other skeleton sizes; the same index reaches the
    kernels through the descriptor struct."""
    scene = tscenes.get_scene(name, device="cpu")
    want = 2 * (name == "reference_render_scene") + transformed
    base = _params(transformed)
    variants = [
        base,
        dict(base, sphere_radius=base["sphere_radius"] * np.float32(1.25),
             smooth_k=base["smooth_k"] * np.float32(0.7),
             skeleton_line_width=base["skeleton_line_width"] * np.float32(1.3)),
        dict(base, skeleton_size=np.asarray([1.0, 2.0, 0.7], np.float32),
             skeleton_center=np.asarray([0.2, -0.1, 0.3], np.float32)),
    ]
    for params in variants:
        desc = tcsdf.compile_scene(scene, params_from_numpy(params, "cpu"))
        assert tcsdf.kernel_structure(desc) == want
        assert render_kernel.scene_desc_c(desc).structure == want


def test_structure_indices_match_the_kernels_dispatch():
    """csrc/scene_sdf.cuh::with_structure maps index 2 * frame + transform
    to Box<frame, transform>, for all four, and names no other index."""
    cases = re.findall(r"case (\d+): f\(Box<(true|false), (true|false)>\{\}\)",
                       SCENE_HEADER.read_text())
    assert {int(i): (f == "true", t == "true") for i, f, t in cases} == {
        2 * f + t: (bool(f), bool(t)) for f in (0, 1) for t in (0, 1)
    }


def test_structure_that_matches_none_raises():
    """A descriptor outside the compiled structures raises before any
    launch: groups out of axis order, or a group with one perpendicular
    coordinate."""
    desc = _descriptor("reference_render_scene", False)
    g = desc.object.groups
    reordered = dataclasses.replace(
        desc, object=dataclasses.replace(desc.object, groups=(g[1], g[0], g[2])))
    narrow = dataclasses.replace(
        desc, frame=dataclasses.replace(desc.frame, groups=(
            dataclasses.replace(desc.frame.groups[0], v1=desc.frame.groups[0].v1[:1]),
            *desc.frame.groups[1:])))
    for bad in (reordered, narrow):
        with pytest.raises(NotImplementedError, match="capsule groups"):
            tcsdf.kernel_structure(bad)
        with pytest.raises(NotImplementedError, match="capsule groups"):
            render_kernel.scene_desc_c(bad)
