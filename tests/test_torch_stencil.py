"""The shared-term fd4 stencil that utils/profiling.py counts, on the CPU.

The bounds of K1, K3, K6 and K7 count a hit's or a vertex's fd4 gradient
as the shared-term stencil (``profiling.fd4_ops``): a shift along one axis
moves one of the three terms of each capsule group (``group_d2``: the
axial term, the lower and the higher slot term) and one of the sphere's
three squares, so each term that the shifts leave alone is computed once,
at the centre. The kernels run the 12 SDFs whole (csrc/project.cuh
``fd4_grad``: K3, K6 and K7 unrolled, where nvcc finds the shared terms
itself; K1 rolled), and chip_smoke.py holds them against the plain twins
on the card, bit for bit. This file holds the count's premise: that the
stencil with the fewer operations computes the same function. Here
:func:`_shared_fd4` computes each term at the centre once and at each of
the 12 points only the moved one, in plain PyTorch float32 in the
kernels' order of operations, and must equal the twins' 12-SDF stencil
(``mesh_kernel.fd4_grad`` over ``descriptor_csdf``, and
``render_kernel._fd_normal``) bit for bit, for all four ``Box<Frame,
Transform>`` structures, on seeded points, on the symmetry planes and at
exact ties between groups.
"""

import numpy as np
import pytest
import torch

from bsdmg_tpu_torch.config import MarchConfig, MeshGenConfig
from bsdmg_tpu_torch.models import scenes as tscenes
from bsdmg_tpu_torch.ops.cuda import csdf as tcsdf
from bsdmg_tpu_torch.ops.cuda import mesh_kernel, render_kernel
from bsdmg_tpu_torch.utils import profiling
from bsdmg_tpu_torch.weights import params_from_numpy

torch.set_num_threads(1)

EPS = sorted({MeshGenConfig().normal_epsilon, MarchConfig().normal_epsilon, 0.05})


def _descriptor(name: str, transformed: bool):
    p = {k: v.numpy() for k, v in tscenes.default_object_params(device="cpu").items()}
    if transformed:
        p["object_center"] = np.asarray([0.3, -0.2, 0.5], np.float32)
        q = np.asarray([0.9, 0.2, -0.3, 0.25], np.float32)
        p["object_rotation"] = (q / np.linalg.norm(q)).astype(np.float32)
    return tcsdf.compile_scene(tscenes.get_scene(name, device="cpu"), params_from_numpy(p, "cpu"))


# ---------------------------------------------------------------------------
# the shared-term stencil, operation by operation
# ---------------------------------------------------------------------------


def _axial(g, a):
    """group_d2's axial term: e*e."""
    r = a - g.a0
    e = r - torch.clamp_max(torch.clamp_min(r, 0.0), g.length)
    return e * e


def _slot(values, c):
    """group_d2's slot term: the nearer of two values, squared."""
    d0, d1 = c - values[0], c - values[1]
    return torch.minimum(d0 * d0, d1 * d1)


def _term(g, k, c):
    return _axial(g, c) if k == 0 else _slot(g.v1 if k == 1 else g.v2, c)


def _set_terms(cs, coords):
    """Each group's three terms."""
    out = []
    for g in cs.groups:
        lower, higher = (a for a in range(3) if a != g.axis)
        out.append([_term(g, 0, coords[g.axis]), _term(g, 1, coords[lower]),
                    _term(g, 2, coords[higher])])
    return out


def _set_d2_along(cs, terms, x: int, v):
    """capsule_set_d2 with coordinate ``x`` at ``v``, the other terms given."""
    best = None
    for g, t in zip(cs.groups, terms):
        k = profiling._term_of(g.axis, x)
        t = [_term(g, k, v) if j == k else t[j] for j in range(3)]
        d2 = (t[0] + t[1]) + t[2]
        best = d2 if best is None else torch.minimum(best, d2)
    return best


def _object_value(desc, skel_d2, sph_d2):
    """scene_sdf's smooth union of the skeleton and the sphere."""
    skel = torch.sqrt(skel_d2) - desc.object.radius
    sph = torch.sqrt(sph_d2) - desc.sphere_radius
    h = torch.clamp_min(desc.smooth_k - torch.abs(skel - sph), 0.0) * desc.inv_k
    return torch.minimum(skel, sph) - h * h * h * desc.k_6


def _capsule_set_d2(cs, coords):
    return _set_d2_along(cs, _set_terms(cs, coords), 0, coords[0])


def _shared_fd4(desc, x, y, z, eps: float):
    """The fd4 gradient from the centre's terms, computed once, and each
    point's moved terms."""
    centre = (x, y, z)
    transform = desc.translation is not None
    obj = None if transform else _set_terms(desc.object, centre)
    sq = [c * c for c in centre]
    frame = None if desc.frame is None else _set_terms(desc.frame, centre)

    def along(axis: int, v):
        if transform:
            moved = [v if a == axis else centre[a] for a in range(3)]
            o = tcsdf._object_coords(desc, *moved)
            d = _object_value(desc, _capsule_set_d2(desc.object, o),
                              (o[0] * o[0] + o[1] * o[1]) + o[2] * o[2])
        else:
            s = [v * v if a == axis else sq[a] for a in range(3)]
            d = _object_value(desc, _set_d2_along(desc.object, obj, axis, v), (s[0] + s[1]) + s[2])
        if frame is not None:
            d = torch.minimum(d, torch.sqrt(_set_d2_along(desc.frame, frame, axis, v))
                              - desc.frame.radius)
        return d

    grad = []
    for axis, p in enumerate(centre):
        fp2, fp1 = along(axis, p + 2 * eps), along(axis, p + eps)
        fm1, fm2 = along(axis, p - eps), along(axis, p - 2 * eps)
        grad.append(((-fp2 + 8.0 * fp1) - 8.0 * fm1) + fm2)
    return grad


# ---------------------------------------------------------------------------
# the points
# ---------------------------------------------------------------------------


def _points(kind: str) -> np.ndarray:
    """(3, M) float32 points. 'seeded': 20,000 uniform in [-3, 3]^3;
    'x=0', 'y=0', 'z=0': the same on a symmetry plane; 'ties': the 0.25
    lattice over [-3, 3]^3 (where the skeletons' groups tie), 2,001 points
    on each of the four cube diagonals (the wireframe's three groups) and
    tests/test_torch_mc_kernel.py's points along the skeleton's x edges on
    y = 0 (the x-parallel group equidistant from its two edges)."""
    rng = np.random.default_rng(19)
    if kind != "ties":
        pts = rng.uniform(-3.0, 3.0, (3, 20_000))
        if kind != "seeded":
            pts["xyz".index(kind[0])] = 0.0
        return pts.astype(np.float32)
    axis = np.arange(-3.0, 3.0 + 1e-9, 0.25)
    lattice = np.stack(np.meshgrid(axis, axis, axis, indexing="ij")).reshape(3, -1)
    t = np.linspace(-4.0, 4.0, 2001)
    diagonals = [np.asarray(s)[:, None] * t for s in ((1, 1, 1), (1, -1, 1), (-1, 1, 1), (1, 1, -1))]
    edges = np.stack([np.random.default_rng(3).uniform(-1.4, 1.4, 4096), np.zeros(4096),
                      np.random.default_rng(4).uniform(-0.2, 0.2, 4096)])
    return np.concatenate([lattice, *diagonals, edges], axis=1).astype(np.float32)


STRUCTURES = [(name, transformed) for name in ("reference_object", "reference_render_scene")
              for transformed in (False, True)]


@pytest.mark.parametrize("kind", ["seeded", "x=0", "y=0", "z=0", "ties"])
@pytest.mark.parametrize("name,transformed", STRUCTURES)
def test_shared_stencil_equals_the_twins_bitwise(name, transformed, kind):
    desc = _descriptor(name, transformed)
    assert tcsdf.kernel_structure(desc) == 2 * (name == "reference_render_scene") + transformed
    x, y, z = (torch.from_numpy(p) for p in _points(kind))
    csdf = tcsdf.descriptor_csdf(desc)
    for eps in EPS:
        ours = _shared_fd4(desc, x, y, z, eps)
        twin = mesh_kernel.fd4_grad(csdf, x, y, z, eps)
        for a, b in zip(ours, twin):
            assert torch.equal(a, b), (eps, int((a != b).sum()))
    # K1's and K3's shading normal: the same gradient, rsqrt-normalised
    gx, gy, gz = ours
    inv = torch.rsqrt(torch.clamp_min(gx * gx + gy * gy + gz * gz, 1e-24))
    normal = render_kernel._fd_normal(csdf, x, y, z, EPS[-1])
    assert all(torch.equal(a, b) for a, b in zip((gx * inv, gy * inv, gz * inv), normal))


def test_tie_points_tie():
    """The 'ties' points hold exact ties between the object's groups and
    between the wireframe's, so the stencil's minima meet equal values."""
    desc = _descriptor("reference_render_scene", False)
    coords = tuple(torch.from_numpy(p) for p in _points("ties"))
    for cs, least in ((desc.object, 100), (desc.frame, 2000)):
        d2 = torch.stack([tcsdf._group_d2(g, coords) for g in cs.groups])
        assert int(((d2 == d2.min(0).values).sum(0) >= 2).sum()) >= least


@pytest.mark.parametrize("name", ["reference_object", "reference_render_scene"])
def test_a_shift_moves_one_term_of_each_group(name):
    """The premise of the sharing, and of utils/profiling.py's count of it:
    each group's three terms sum to the twin's ``group_d2`` bit for bit, a
    shift along axis ``x`` moves only the term ``profiling._term_of``
    names (the axial one of the group along ``x``, a slot term of the
    others), and each of a group's three terms reads a different axis."""
    desc = _descriptor(name, False)
    centre = [torch.from_numpy(p) for p in _points("seeded")]
    for cs in (desc.object, desc.frame) if desc.frame is not None else (desc.object,):
        at_centre = _set_terms(cs, centre)
        for g, t in zip(cs.groups, at_centre):
            assert torch.equal((t[0] + t[1]) + t[2], tcsdf._group_d2(g, centre))
        for x in range(3):
            moved = [c + 0.125 if a == x else c for a, c in enumerate(centre)]
            for g, t, u in zip(cs.groups, at_centre, _set_terms(cs, moved)):
                k = profiling._term_of(g.axis, x)
                assert k == 0 if g.axis == x else k in (1, 2)
                assert [torch.equal(a, b) for a, b in zip(t, u)] == [j != k for j in range(3)]
    for axis in range(3):
        assert sorted(profiling._term_of(axis, x) for x in range(3)) == [0, 1, 2]
