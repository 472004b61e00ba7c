"""The mesh-asset bake's distance cull (csrc/bake_kernel.cu) in plain
PyTorch: ``ops/cuda/bake_kernel.py::bake_cull_torch``, the kernel's
decision brick by brick (its bricks, the clusters of Morton-ordered
triangles and their boxes, the bound with its margin, the seed and the
worst best after each tile), on the CPU.

* The least squared distance over the clusters a brick keeps equals the
  twin's (``bake_torch``, every triangle) bit for bit, its square root the
  twin's distance, on a small torus (``tools/make_torus.py``, 768
  triangles), the torus with a band of faces removed (open), the torus
  with degenerate triangles added (a repeated vertex, three collinear
  ones), and a lattice whose box is the mesh's own, so that nodes lie on
  its faces; the pairs it counts are each kept cluster's triangles once a
  node (the seed once), fewer than all at 16^3.
* The margin's bound never exceeds a pair's float squared distance: a
  hypothesis test over triangles (degenerate ones too) and boxes of points,
  the bound of the triangle's box against the points' box (``cluster_bounds``)
  against the twin's squared distance of each point
  (``models/mesh_sdf.py::_point_triangle_dist_sq``, bit-equal to the
  kernel's evaluation).
* Set negative, the margin skips a cluster that holds a node's nearest
  triangle on chip_smoke.py's node set (``margin_axes``: points above the
  midpoint of an edge of the full torus's top ring), which the bake's
  magnitude bar then sees.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from bsdmg_tpu_torch.models.mesh_sdf import _linspace, _point_triangle_dist_sq, grid_box
from bsdmg_tpu_torch.ops.cuda import bake_kernel as bk

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _torus(**kw):
    spec = importlib.util.spec_from_file_location("make_torus", ROOT / "tools" / "make_torus.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.torus(**kw)


def _meshes():
    v, f = _torus(nu=24, nv=16)
    out = {"torus": (v, f)}
    # a band of faces around the tube removed: an open mesh
    keep = np.ones(len(f), bool)
    keep[: 2 * 16 * 3] = False
    out["open torus"] = (v, f[keep])
    # degenerate triangles: a repeated vertex, three collinear vertices
    mid = ((v[f[0, 0]] + v[f[0, 1]]) * np.float32(0.5))[None]
    v2 = np.concatenate([v, mid]).astype(np.float32)
    extra = np.array([[f[0, 0], f[0, 0], f[0, 1]], [f[0, 0], f[0, 1], len(v)],
                      [f[5, 2], f[5, 2], f[5, 2]]], np.int32)
    out["degenerate triangles"] = (v2, np.concatenate([f, extra]))
    return out


def _axes(v, r, exact_box=False):
    if exact_box:
        lo, hi = v.min(axis=0), v.max(axis=0)
    else:
        lo, hi = grid_box(v)
    return [torch.from_numpy(_linspace(np.float32(lo[a]), np.float32(hi[a]), r)) for a in range(3)]


CASES = [(name, 12, False) for name in ("torus", "open torus", "degenerate triangles")] + [
    ("torus", 16, True)]


@pytest.mark.parametrize("name, r, exact_box", CASES,
                         ids=[f"{n} {r}^3{' box faces' if e else ''}" for n, r, e in CASES])
def test_kept_clusters_give_the_twins_distance(name, r, exact_box):
    v, f = _meshes()[name]
    axes = _axes(v, r, exact_box)
    least, kept, pairs = bk.bake_cull_torch(axes, v, f)
    twin = bk.bake_torch(axes, v, f)
    assert torch.equal(least.sqrt(), twin.abs())
    assert kept.any(dim=1).all()
    # each kept cluster's triangles once a live node: the seed, which the
    # tiles skip, counted once
    _, live = bk._bricks(r)
    sizes = torch.clamp(len(f) - torch.arange(kept.shape[1]) * bk.CLUSTER, max=bk.CLUSTER)
    assert pairs == int((torch.where(kept, sizes, 0).sum(dim=1) * live.sum(dim=1)).sum())
    if r == 16:
        assert pairs < r**3 * len(f)


_coord = st.floats(-3.0, 3.0, width=32)
_vertex = st.tuples(_coord, _coord, _coord)


@settings(max_examples=200, deadline=None)
@given(tri=st.tuples(_vertex, _vertex, _vertex), corner=_vertex,
       size=st.tuples(*[st.floats(0.0, 0.5, width=32)] * 3),
       degenerate=st.sampled_from(["none", "repeated", "collinear"]),
       seed=st.integers(0, 2**31 - 1))
def test_margin_bound_never_exceeds_a_float_distance(tri, corner, size, degenerate, seed):
    tri = np.asarray(tri, np.float32)
    if degenerate == "repeated":
        tri[2] = tri[0]
    elif degenerate == "collinear":
        tri[2] = tri[0] + (tri[1] - tri[0]) * np.float32(0.25)
    rng = np.random.default_rng(seed)
    lo = np.asarray(corner, np.float32)
    hi = (lo + np.asarray(size, np.float32)).astype(np.float32)
    points = (lo + rng.uniform(0.0, 1.0, (16, 3)).astype(np.float32) * (hi - lo)).astype(np.float32)
    points = np.clip(points, lo, hi)
    points[:2] = [lo, hi]  # the box's corners
    extent = max(np.abs(tri).max(), np.abs(points).max(), np.abs(hi).max())
    eta = float(np.float32(bk.MARGIN) * np.float32(extent))
    box = torch.from_numpy(np.concatenate([tri.min(axis=0), tri.max(axis=0)])[None])
    bound = bk.cluster_bounds(box, torch.from_numpy(points.min(axis=0))[None],
                              torch.from_numpy(points.max(axis=0))[None], eta)
    t = torch.from_numpy(tri)
    d2 = _point_triangle_dist_sq(torch.from_numpy(points)[:, None, :], t[:1], t[1:2] - t[:1],
                                 t[2:3] - t[:1])
    assert float(bound) <= float(d2.min())


def test_negative_margin_skips_a_nearest_triangle():
    """chip_smoke.py's node set for the planted fault: with the margin
    negative the cull's least differs from the twin's at some nodes, with
    the margin as it is at none."""
    import chip_smoke

    v, f = _torus()
    axes = chip_smoke.margin_axes(v, "cpu")[0]
    axes = [a[:8] for a in axes]  # one brick deep: the first two heights
    twin = bk.bake_torch(axes, v, f).abs()
    prep = bk.bake_order(axes, bk.triangles(v, f, "cpu"))
    sound, _, _ = bk.bake_cull_torch(axes, v, f)
    faulted, _, _ = bk.bake_cull_torch(axes, v, f, eta=-prep.eta)
    assert torch.equal(sound.sqrt(), twin)
    assert (faulted.sqrt() != twin).any()
