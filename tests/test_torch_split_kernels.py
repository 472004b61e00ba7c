"""The near/far split's K1 and K2 as the kernels run them since their
redesign (csrc/render_kernel.cu render_split_block, trace_split_ray), on
their plain twins, against the JAX package.

The kernels need nvcc and a card; chip_smoke.py holds them against these
twins there, bit for bit, at 1920x1080 and 2560x1440. Here:

* K1 · split's fused epilogue shades a far patch's hits with the far scene
  and a near patch's with the full scene (JAX's fused epilogue,
  render_kernel.py:380-384), and its frame meets the JAX package's bars
  (tests/test_pallas.py:320-323) against ``render_image_pallas(...,
  split=...)`` in interpret mode, at 256x64 and at a ragged 250x62 (a
  frame of partial 8x4 patches and 16x8 blocks);
* the row and unfused pipelines, whose K3 shades every hit with the full
  scene, give the fused pixel bit for bit wherever their march ends where
  K1's does: at a far patch's hit the object's term exceeds the
  wireframe's at every stencil point;
* the row tail's list (``tail_list``) holds exactly the flagged rays, with
  the split in 8x4-patch order, each of its warps making one far/near
  decision, and without it in row-major order;
* the bound by which the split kernels' near scene (csrc/scene_sdf.cuh
  NearScene) leaves the wireframe's term out: its plain version
  (``frame_beyond_torch``) holds, its margin included, under the twin's
  float32 wireframe distance on 10^6 seeded points, on and near the frame
  box's faces, edges and corners and around the object, and leaving the
  term out where it proves gives ``descriptor_csdf``'s bits.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bsdmg_tpu.models import get_scene as jax_get_scene
from bsdmg_tpu.ops.pallas import compile_scene_csdf
from bsdmg_tpu.ops.pallas.csdf import compile_scene_split as jax_scene_split
from bsdmg_tpu.ops.pallas.csdf import scene_bounds as jax_scene_bounds
from bsdmg_tpu.ops.pallas.render_kernel import render_image_pallas
from bsdmg_tpu_torch.config import MarchConfig
from bsdmg_tpu_torch.models import reference_render_scene
from bsdmg_tpu_torch.ops.cuda import render_kernel as rk
from bsdmg_tpu_torch.ops.cuda.csdf import (
    CapsuleGroup,
    compile_scene,
    compile_scene_split,
    descriptor_csdf,
    f32,
)
from test_torch_split import _rays, assert_split_bars

# one intra-op thread, as the other port tests
torch.set_num_threads(1)

COLLISION = 0
#: a frame of whole 8x4 patches and one of partial patches and blocks
FRAMES = [(256, 64), (250, 62)]


@pytest.fixture(scope="module")
def scene():
    built = reference_render_scene(device="cpu")
    return compile_scene(built), compile_scene_split(built)


@pytest.fixture(scope="module", params=FRAMES, ids=lambda f: f"{f[0]}x{f[1]}")
def frame(request, scene):
    desc, split = scene
    arrays, rays = _rays(*request.param)
    fused = rk.render_image_cuda(desc, *rays, split=split, return_planes=True)
    far = rk.trace_far_planes_torch(desc, *rays, split=split)[4]
    return desc, split, arrays, rays, fused, far


def test_fused_twin_shades_far_hits_with_the_far_scene(frame):
    """K1's fused twin: a hit of a far patch takes its colour from the far
    scene, any other pixel from the full scene; both kinds of hit occur."""
    desc, split, _, rays, (rgb, depth, _, outcome), far = frame
    hit = outcome == COLLISION
    assert (hit & far).sum() > 100 and (hit & ~far).sum() > 100
    from_far = rk.shade_planes_torch(split[0], *rays[:2], depth, outcome)
    from_full = rk.shade_planes_torch(desc, *rays[:2], depth, outcome)
    assert torch.equal(rgb[hit & far], from_far[hit & far])
    assert torch.equal(rgb[~(hit & far)], from_full[~(hit & far)])


def test_fused_twin_meets_jax_bars_against_jax_split(frame):
    """The fused render with the split against JAX's
    ``render_image_pallas(..., split=...)`` in interpret mode, whose fused
    epilogue shades its far tiles with the far scene."""
    _, _, (o, d, c), _, (rgb, *_), _ = frame
    jscene = jax_get_scene("reference_render_scene")
    ref = render_image_pallas(compile_scene_csdf(jscene), o, d, c, bb=jax_scene_bounds(jscene),
                              split=jax_scene_split(jscene), interpret=True)
    assert_split_bars(rgb.numpy(), ref)


@pytest.mark.parametrize("pipeline", ["block", "row", "unfused"])
def test_pipelines_shade_far_hits_as_the_fused_image(frame, pipeline):
    """Block retirement (K1 twice, each launch shading its own far hits
    from the far scene), the row pipeline and the unfused one (K3: every
    hit from the full scene) against the fused image: wherever a
    pipeline's march ends where the fused one's does, far hits included,
    its pixel equals the fused pixel bit for bit. The unfused pipeline
    marches as K1 does (one vote a patch), so its planes equal everywhere."""
    desc, split, _, rays, fused, far = frame
    kw = {"block": dict(two_phase="block"), "row": dict(two_phase=True),
          "unfused": dict(swizzle=False)}[pipeline]
    other = rk.render_image_cuda(desc, *rays, split=split, return_planes=True, **kw)
    same = (fused[1] == other[1]) & (fused[3] == other[3])
    if pipeline == "unfused":
        assert bool(same.all()) and torch.equal(fused[2], other[2])
    assert (same & far & (fused[3] == COLLISION)).sum() > 100
    assert torch.equal(fused[0][same], other[0][same])


def test_tail_list_is_the_flagged_rays_in_patch_order(frame):
    """``tail_list`` over phase A's unresolved rays: exactly the flagged
    rays, each once, in 8x4-patch order (patches in ``patch_groups``'
    order, lanes row-major inside a patch), with the count on the device."""
    desc, split, _, rays, _, _ = frame
    h, w = rays[2].shape
    active = rk.trace_planes_torch(desc, *rays, budget=16, split=split)[3]
    index, count = rk.tail_list(active, split)
    assert count.shape == (1,) and count.dtype == torch.int32
    listed = index[: int(count)].long()
    flagged = active.reshape(-1).nonzero().squeeze(1)
    assert 32 < listed.numel() < h * w
    assert torch.equal(torch.sort(listed).values, flagged)
    py, px = listed // w, listed % w
    key = rk.patch_groups(h, w, "cpu")[listed] * 32 + (py % 4) * 8 + px % 8
    assert bool((key[1:] > key[:-1]).all())


def test_unsplit_tail_list_stays_row_major(frame):
    """Without the split the row tail's list is ``compact_list``'s, in
    row-major order, as the unsplit K2 has always taken it."""
    desc, _, _, rays, _, _ = frame
    active = rk.trace_planes_torch(desc, *rays, budget=16)[3]
    index, count = rk.tail_list(active, None)
    row, row_count = rk.compact_list(active.reshape(-1))
    assert torch.equal(count, row_count) and int(count) > 32
    assert torch.equal(index[: int(count)], row[: int(count)])
    assert torch.equal(index[: int(count)].long(), active.reshape(-1).nonzero().squeeze(1))


def test_each_listed_warp_makes_one_decision(frame):
    """K2's listed launch takes the tail 32 rays a warp in list order
    (``listed_groups``); each warp's rays march one scene, and the tail
    holds warps of both kinds."""
    desc, split, _, rays, _, _ = frame
    n = rays[2].numel()
    active = rk.trace_planes_torch(desc, *rays, budget=16, split=split)[3]
    index, count = rk.tail_list(active, split)
    groups = rk.listed_groups(index, count, n)
    listed = groups >= 0
    far = rk.far_rays(split, *rk._flat_rays(*rays), MarchConfig(), listed, groups)[listed]
    g = groups[listed]
    per_warp = torch.zeros(int(g.max()) + 1, dtype=torch.long).index_add_(0, g, far.long())
    size = torch.bincount(g)
    assert bool(((per_warp == 0) | (per_warp == size)).all())
    assert (per_warp == 0).any() and (per_warp == size).any()


# ---------------------------------------------------------------------------
# the near scene's wireframe bound (csrc/scene_sdf.cuh frame_beyond)
# ---------------------------------------------------------------------------


def _near_planes(rng, n, planes, lo, hi):
    """n points in [lo, hi]^3 of which ``planes`` coordinates sit on or
    next to the frame box's planes (+-2.5): exactly on them, a few float32
    steps away, or off by 10^-7..10^-1."""
    p = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    for k in range(planes):
        axis = (np.arange(n) + k) % 3 if planes < 3 else np.full(n, k)
        plane = np.where(rng.random(n) < 0.5, -2.5, 2.5).astype(np.float32)
        ulps = rng.integers(-4, 5, n)
        stepped = plane.copy()
        for _ in range(4):
            stepped = np.where(ulps > 0, np.nextafter(stepped, np.float32(np.inf)), stepped)
            stepped = np.where(ulps < 0, np.nextafter(stepped, np.float32(-np.inf)), stepped)
            ulps = ulps - np.sign(ulps)
        off = (rng.choice([-1.0, 1.0], n) * 10.0 ** rng.uniform(-7, -1, n)).astype(np.float32)
        value = np.where(rng.random(n) < 0.5, stepped, plane + off).astype(np.float32)
        p[np.arange(n), axis] = value
    return p


@pytest.fixture(scope="module")
def bound_points(scene):
    """10^6 seeded points: the space around the frame box, its faces, edges
    and corners, and the object's near box; with the object's value (the
    scene without its wireframe), the wireframe's and the scene's."""
    desc, split = scene
    rng = np.random.default_rng(19)
    (nlo, nhi, _) = split[1]
    around = np.stack([rng.uniform(nlo[a] - 0.1, nhi[a] + 0.1, 100_000) for a in range(3)], 1)
    p = np.concatenate([rng.uniform(-3.5, 3.5, (400_000, 3)),
                        _near_planes(rng, 200_000, 1, -3.0, 3.0),
                        _near_planes(rng, 200_000, 2, -3.0, 3.0),
                        _near_planes(rng, 100_000, 3, -3.0, 3.0),
                        around]).astype(np.float32)
    x, y, z = (torch.from_numpy(p[:, a].copy()) for a in range(3))
    d = descriptor_csdf(dataclasses.replace(desc, frame=None))(x, y, z)
    frame = descriptor_csdf(split[0])(x, y, z)
    return desc, (x, y, z), d, frame, descriptor_csdf(desc)(x, y, z)


def test_frame_bound_holds_under_the_wireframe_distance(bound_points):
    """The bound itself, fl(fl(m (1 - 2^-20)) - radius) for m the median of
    the per-axis distances to the box's planes, never exceeds the twin's
    float32 wireframe distance, and on the box's faces it is within 10^-5
    of it."""
    desc, (x, y, z), _, frame, _ = bound_points
    lo, hi = rk.frame_planes(desc.frame)
    a = [torch.minimum((c - lo[k]).abs(), (c - hi[k]).abs()) for k, c in enumerate((x, y, z))]
    m = torch.maximum(torch.minimum(a[0], a[1]), torch.minimum(torch.maximum(a[0], a[1]), a[2]))
    bound = m * f32(1.0 - 2.0**-20) - f32(desc.frame.radius)
    proves = m > f32(1e-6)  # the bound's own domain: not on an edge or a corner
    assert proves.sum() > 800_000
    assert bool((bound[proves] <= frame[proves]).all())
    # on a face of the box (one coordinate on its plane) the nearest edge is
    # the median's distance away, and the bound all but tight
    on_face = (a[0].minimum(a[1]).minimum(a[2]) == 0) & (x.abs() <= 2.5) & (y.abs() <= 2.5) \
        & (z.abs() <= 2.5) & proves
    assert on_face.sum() > 10_000
    assert float((frame - bound)[on_face].max()) < 1e-5


def test_skipping_the_wireframe_where_the_bound_proves_gives_the_twins_bits(bound_points):
    """Where ``frame_beyond_torch`` proves the wireframe's term larger than
    the object's value, the scene's value is the object's bit for bit, so
    the near scene's value, the object's there and the minimum elsewhere,
    equals ``descriptor_csdf``'s everywhere; the bound proves it at a good
    share of the points, and at most of those around the object."""
    desc, (x, y, z), d, frame, full = bound_points
    beyond = rk.frame_beyond_torch(desc.frame, x, y, z, d)
    assert 0.2 < beyond.float().mean() < 1.0
    assert beyond[-100_000:].float().mean() > 0.5
    assert bool((frame[beyond] > d[beyond]).all())
    assert torch.equal(torch.where(beyond, d, torch.minimum(d, frame)), full)


def test_frame_planes_refuse_a_wireframe_that_is_not_a_box(scene):
    """The bound needs every group's perpendicular values on the box's two
    planes an axis; ``frame_planes`` raises for a wireframe with a third."""
    desc, _ = scene
    assert rk.frame_planes(desc.frame) == ((-2.5,) * 3, (2.5,) * 3)
    g = desc.frame.groups[0]
    bent = dataclasses.replace(desc.frame, groups=(
        CapsuleGroup(axis=g.axis, a0=g.a0, length=g.length, v1=(g.v1[0], 2.0), v2=g.v2),
        *desc.frame.groups[1:]))
    with pytest.raises(ValueError, match="box"):
        rk.frame_planes(bent)
