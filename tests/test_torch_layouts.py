"""The host-side layouts of the redesigned kernels K6 and K9, on the CPU.

The kernels need nvcc and a card; chip_smoke.py holds them against their
plain versions there, bit for bit. Here the pieces that decide where each
kernel reads and writes are held against what they mirror:

* K9's cell-packed table (``grid_kernel.cell_table``) holds each cell's
  eight corners of the raw table in the order ``csrc/grid_sdf.cuh::
  hat_sample`` sums them, bit for bit, for float32 and bf16 levels and the
  last cell on each axis; the sampler reading cells
  (``make_contraction_csdf(cells=True)``, the CPU form of ``HatCells``)
  equals the raw table's twin bit for bit, on P1's probe points and on
  points inside and outside the box, and both are within the JAX package's
  bars of its ``make_contraction_csdf``;
* K9's tile order (``grid_kernel.tile_order``, the CPU form of
  ``tile_ray``) is a permutation of the frame's rays and walks K1's 8x4
  warp patches of 16x8 tiles;
* K8's lists (``grid_kernel.tile_lists``) hold each 16x8 tile's active
  rays in thread order, as a CPU run of the kernel's ballot and warp
  counts lists them, and as a permutation of the active set;
* K6's edge lists (``mc_kernel.edge_slots``) list exactly the crossing
  edges of rank < budget that the staged path (``_staged_inputs``) lists,
  each block's slots once each, voxel by voxel in rank order;
* the staged path's soup over those listed edges (what it hands K7) equals
  the soup over the JAX kernel's padded lanes (``padded_inputs``, empty
  lanes inactive and zeroed), bit for bit, and the listed points are the
  padded lanes' active ones;
* ``make_contraction_levels`` gives each of K9's levels its cell-packed
  copy, which K9 reads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsdmg_tpu.config import MeshGenConfig as JaxMeshGenConfig
from bsdmg_tpu.mesh import create_voxel_field as jax_create_field
from bsdmg_tpu.mesh import refine_field as jax_refine_field
from bsdmg_tpu.models import reference_object as jax_object
from bsdmg_tpu.ops.pallas import compile_scene_csdf
from bsdmg_tpu.ops.pallas import grid_kernel as jg
from bsdmg_tpu_torch.config import MeshGenConfig
from bsdmg_tpu_torch.models import reference_object
from bsdmg_tpu_torch.models.mesh_sdf import SdfGrid, _outside_distance, _outside_step, box_f32
from bsdmg_tpu_torch.ops.cuda import grid_kernel as tg
from bsdmg_tpu_torch.ops.cuda import mc_kernel
from bsdmg_tpu_torch.ops.cuda.csdf import SdfFns, compile_scene, sdf_fns
from bsdmg_tpu_torch.ops.cuda.mesh_kernel import project_edges
from bsdmg_tpu_torch.ops.marching_cubes import (
    _classify,
    _staged_inputs,
    _staged_soup,
    extract_triangles,
    kernel_inputs,
    padded_inputs,
)
from bsdmg_tpu_torch.weights import field_from_numpy

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# K9: the cell-packed table and its sampler
# ---------------------------------------------------------------------------


def _table(r: int, bf16: bool, seed: int = 0) -> torch.Tensor:
    values = np.random.default_rng(seed).standard_normal(r**3).astype(np.float32)
    table = torch.from_numpy(values)
    return table.to(torch.bfloat16) if bf16 else table


@pytest.mark.parametrize("r", [2, 17, 32])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cell_table_holds_the_corners_in_hat_order(r, bf16):
    table = _table(r, bf16)
    cells = tg.cell_table(table, r)
    m = r - 1
    assert cells.dtype == table.dtype and cells.shape == (8 * m**3,)
    t3 = table.reshape(r, r, r)
    got = cells.reshape(m, m, m, 8)
    for k, (dx, dy, dz) in enumerate(tg.CELL_CORNERS):
        assert torch.equal(got[..., k], t3[dx:dx + m, dy:dy + m, dz:dz + m])
    # the last cell on each axis reaches the table's last plane
    for x0, y0, z0 in ((m - 1, 0, 0), (0, m - 1, 0), (0, 0, m - 1), (m - 1, m - 1, m - 1)):
        want = [t3[x0 + dx, y0 + dy, z0 + dz] for dx, dy, dz in tg.CELL_CORNERS]
        assert torch.equal(got[x0, y0, z0], torch.stack(want))
    # the order is hat_sample's: (x0, y0), (x0, y0 + 1), (x0 + 1, y0),
    # (x0 + 1, y0 + 1) at z0, then at z0 + 1
    assert tg.CELL_CORNERS == tuple((dx, dy, dz) for dz in (0, 1) for dx in (0, 1)
                                    for dy in (0, 1))


def _interp_gather_csdf(s):
    """CPU form of csrc/grid_sdf.cuh::InterpGather, K8's sampler: the grid
    coordinates, their floors and fractions, the eight corners at fixed
    offsets from one base index (no min(x0 + 1, R - 1)), the lerps and the
    outside step."""
    lo, hi, scale, clip_hi = box_f32(s.r, s.lo, s.hi)
    r = s.r

    def csdf(x, y, z):
        c = [torch.clamp((v - lo[a]) * scale[a], 0.0, clip_hi) for a, v in enumerate((x, y, z))]
        a0 = [torch.floor(v) for v in c]
        fx, fy, fz = (v - a for v, a in zip(c, a0))
        x0, y0, z0 = (a.to(torch.int64) for a in a0)
        base = (x0 * r + y0) * r + z0
        at = [s.table[base + dx * r * r + dy * r + dz]
              for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
        gx = 1 - fx
        c00, c10 = at[0] * gx + at[1] * fx, at[2] * gx + at[3] * fx
        c01, c11 = at[4] * gx + at[5] * fx, at[6] * gx + at[7] * fx
        c0, c1 = c00 + (c10 - c00) * fy, c01 + (c11 - c01) * fy
        return _outside_step(c0 + (c1 - c0) * fz, _outside_distance(x, y, z, lo, hi))

    return csdf


@pytest.mark.parametrize("r", [2, 17, 32, 64])
def test_gather_sampler_equals_the_interp_twin(r):
    """K8's sampler, the eight corners at fixed offsets from one base index,
    equals interp_sampler's twin (make_grid_interp_csdf, with its min(x0 +
    1, R - 1)) bit for bit, on P1's probe points, inside and outside the box
    and at the clamp's top, where the last cell on each axis is read."""
    grid = SdfGrid(values=_table(r, False, seed=r).reshape(r, r, r), lo=(-1.0, -1.2, -0.9),
                   hi=(1.1, 1.0, 1.3))
    s = tg.interp_sampler(grid)
    twin = tg.sampler_csdf(s)
    lo, hi = box_f32(r, s.lo, s.hi)[:2]
    scale = [(h - l) / (r - 1) for l, h in zip(lo, hi)]
    probe = [c * scale[a] + lo[a] for a, c in enumerate(_probe_points(r))]
    for points in (probe, _box_points(lo, hi, seed=r)):
        assert torch.equal(_interp_gather_csdf(s)(*points), twin(*points))


@pytest.mark.parametrize("r, marches", [(2049, True), (2050, False), (4096, False)])
def test_k8_takes_grids_whose_clamp_stays_below_the_last_corner(r, marches):
    """K8 reads x0 + 1 without a min, so march_table takes an INTERP_F32
    grid only where the float32 clamp R - 1 - 1e-4 rounds below R - 1."""
    s = tg.Sampler(tg.INTERP_F32, torch.zeros(8), r, (0.0,) * 3, (1.0,) * 3)
    if marches:
        assert tg.march_table(s) is s.table
    else:
        with pytest.raises(ValueError):
            tg.march_table(s)


def test_cell_table_rejects_a_one_point_grid():
    with pytest.raises(ValueError):
        tg.cell_table(torch.zeros(1), 1)


def _probe_points(r):
    """P1's probe (chip_smoke.py, tools/probe_mxu.py): 512 grid coordinates
    in [0, r - 1.001) on the box [0, r - 1]^3."""
    coords = np.random.default_rng(0).uniform(0.0, r - 1.001, (3, 512)).astype(np.float32)
    return [torch.from_numpy(c) for c in coords]


def _box_points(lo, hi, seed=1, n=4096):
    """Points over the box and up to half its size beyond it, with the box's
    corners, faces and the clamp's top."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    pad = (hi - lo) / 2
    pts = rng.uniform(lo - pad, hi + pad, (n, 3)).astype(np.float32)
    pts = np.concatenate([pts, np.stack([lo, hi, (lo + hi) / 2]), np.stack([hi - 1e-6] * 2)])
    return [torch.from_numpy(np.ascontiguousarray(pts[:, a])) for a in range(3)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("r", [17, 32, 64])
def test_cell_sampler_equals_the_hat_twin(bf16, r):
    lo, hi = (-1.0, -1.2, -0.9), (1.1, 1.0, 1.3)
    table = _table(r, bf16, seed=r)
    margin = float(np.float32(tg._BF16_MARGIN * float(table.float().abs().max()))) if bf16 else 0.0
    raw = tg.make_contraction_csdf(table, r, lo, hi, bf16=bf16, margin=margin)
    cells = tg.make_contraction_csdf(tg.cell_table(table, r), r, lo, hi, bf16=bf16,
                                     margin=margin, cells=True)
    points = _box_points(lo, hi)
    assert torch.equal(cells(*points), raw(*points))
    # and P1's probe points on the probe's own table and box
    t3 = torch.arange(r**3, dtype=torch.float32) % 97
    t3 = t3.to(torch.bfloat16) if bf16 else t3
    box = ((0.0,) * 3, (r - 1.0,) * 3)
    raw = tg.make_contraction_csdf(t3, r, *box, bf16=bf16, margin=0.0)
    cells = tg.make_contraction_csdf(tg.cell_table(t3, r), r, *box, bf16=bf16, margin=0.0,
                                     cells=True)
    probe = _probe_points(r)
    assert torch.equal(cells(*probe), raw(*probe))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cell_sampler_matches_jax(bf16):
    """Against the JAX package's sampler at its own bars (its XLA dot sums
    the four exact corners in another order: 2e-6)."""
    r, lo, hi = 17, (-1.0, -1.2, -0.9), (1.1, 1.0, 1.3)
    values = np.random.default_rng(2).standard_normal((r, r, r)).astype(np.float32)
    margin = jg._BF16_MARGIN * float(np.abs(values).max()) if bf16 else 0.0
    t2 = jg._table2(values)
    ref = jax.jit(jg.make_contraction_csdf(t2.astype(jnp.bfloat16) if bf16 else t2, r, lo, hi,
                                           bf16=bf16, margin=margin))
    table = torch.from_numpy(values.reshape(-1))
    table = table.to(torch.bfloat16) if bf16 else table
    got = tg.make_contraction_csdf(tg.cell_table(table, r), r, lo, hi, bf16=bf16,
                                   margin=float(np.float32(margin)), cells=True)
    points = _box_points(lo, hi, seed=3)
    want = np.asarray(ref(*(jnp.asarray(p.numpy())[None] for p in points))).reshape(-1)
    np.testing.assert_allclose(got(*points).numpy(), want, atol=1e-6 if bf16 else 2e-6)


def test_contraction_levels_carry_their_cells():
    r = 72
    values = torch.from_numpy(np.random.default_rng(4).standard_normal((r, r, r)).astype(np.float32))
    levels = tg.make_contraction_levels(SdfGrid(values=values, lo=(-1.0,) * 3, hi=(1.0,) * 3))
    assert [(s.kind, s.r) for s in levels] == [(tg.HAT_BF16, 32), (tg.HAT_BF16, 64)]
    for level in levels:
        assert torch.equal(level.cells, tg.cell_table(level.table, level.r))
        assert tg.march_table(level) is level.cells
    # an exact level (R <= 64) too
    small = SdfGrid(values=values[:40, :40, :40].contiguous(), lo=(-1.0,) * 3, hi=(1.0,) * 3)
    exact = tg.make_contraction_levels(small)[-1]
    assert exact.kind == tg.HAT_F32 and torch.equal(exact.cells, tg.cell_table(exact.table, 40))
    # K8 marches the raw table; a hat sampler without cells gets them made
    fine = tg.interp_sampler(small)
    assert tg.march_table(fine) is fine.table
    assert torch.equal(tg.march_table(exact._replace(cells=None)), exact.cells)


def test_sampler_checks_its_cells():
    table = _table(5, False)
    good = tg.Sampler(tg.HAT_F32, table, 5, (0.0,) * 3, (1.0,) * 3, cells=tg.cell_table(table, 5))
    tg._check_sampler(good, table.device)
    for bad in (good._replace(cells=good.cells[:-8]),
                good._replace(cells=good.cells.to(torch.bfloat16)),
                good._replace(kind=tg.INTERP_F32)):
        with pytest.raises((TypeError, ValueError)):
            tg._check_sampler(bad, table.device)


# ---------------------------------------------------------------------------
# K9: the tile order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1080, 1920), (37, 100), (1, 4099)],
                         ids=["1920x1080", "100x37", "1-D"])
def test_tile_order_is_a_permutation(shape):
    h, w = shape
    order = tg.tile_order(h, w)
    assert torch.equal(torch.sort(order).values, torch.arange(h * w))


def test_tile_order_walks_k1_warp_patches():
    order = tg.tile_order(16, 32).reshape(-1, 32)  # one warp a row
    frame = torch.arange(16 * 32).reshape(16, 32)
    for warp, (ty, tx, q) in enumerate((ty, tx, q) for ty in range(2) for tx in range(2)
                                       for q in range(4)):
        y, x = ty * 8 + (q >> 1) * 4, tx * 16 + (q & 1) * 8
        assert torch.equal(order[warp], frame[y:y + 4, x:x + 8].reshape(-1))


# ---------------------------------------------------------------------------
# K8: each tile's active rays, listed in thread order
# ---------------------------------------------------------------------------


def _block_lists(active, h, w):
    """A CPU run of K8's listing, block by block and thread by thread: each
    warp's ballot of its active rays, the slot a rank in the ballot plus the
    counts of the warps before it (csrc/grid_kernel.cu::grid_march_kernel)."""
    tiles_x, flags = -(-w // 16), active.reshape(-1).tolist()
    lists = []
    for block in range(-(-h // 8) * tiles_x):
        rays = []
        for thread in range(128):
            warp, lane = thread >> 5, thread & 31
            px = (block % tiles_x) * 16 + (warp & 1) * 8 + (lane & 7)
            py = (block // tiles_x) * 8 + (warp >> 1) * 4 + (lane >> 3)
            rays.append(py * w + px if px < w and py < h else -1)
        ballots = [[r >= 0 and flags[r] != 0 for r in rays[32 * k:32 * k + 32]] for k in range(4)]
        listed = [0] * 128
        for thread, ray in enumerate(rays):
            warp, lane = thread >> 5, thread & 31
            if ballots[warp][lane]:
                slot = sum(ballots[warp][:lane]) + sum(sum(b) for b in ballots[:warp])
                listed[slot] = ray
        lists.append(listed[:sum(sum(b) for b in ballots)])
    return lists


@pytest.mark.parametrize("shape", [(1080, 1920), (37, 100), (1, 4099)],
                         ids=["1920x1080", "100x37", "1-D"])
def test_tile_lists_hold_each_tiles_active_rays_in_thread_order(shape):
    h, w = shape
    active = torch.from_numpy((np.random.default_rng(8).random(h * w) < 0.21).astype(np.int32))
    listed, counts = tg.tile_lists(active, h, w)
    # a permutation of the active set, split by tile
    assert torch.equal(torch.sort(listed).values, active.nonzero().squeeze(1))
    assert counts.numel() == -(-h // 8) * -(-w // 16) and int(counts.sum()) == listed.numel()
    # tile by tile, each tile's rays in thread order: ascending (tile, patch, lane)
    py, px = listed // w, listed % w
    key = (((py // 8) * -(-w // 16) + px // 16) * 4 + ((py % 8) // 4) * 2 + (px % 16) // 8) * 32 \
        + (py % 4) * 8 + px % 8
    assert bool((key[1:] > key[:-1]).all())
    if h * w < 10_000:  # the listing itself, thread by thread
        expect = _block_lists(active, h, w)
        assert counts.tolist() == [len(x) for x in expect]
        assert listed.tolist() == [ray for x in expect for ray in x]


@pytest.mark.parametrize("share", [0.0, 1.0], ids=["none active", "all active"])
def test_tile_lists_of_no_and_of_every_ray(share):
    h, w = 37, 100
    listed, counts = tg.tile_lists(torch.full((h * w,), int(share), dtype=torch.int32), h, w)
    if share:
        assert torch.equal(listed, tg.tile_order(h, w))
    else:
        assert listed.numel() == 0 and int(counts.sum()) == 0


# ---------------------------------------------------------------------------
# K6: the edge lists
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def field_8():
    """The reference object's field at init_factor 8 after one refinement,
    from the JAX package, moved to the port."""
    scene = jax_object()
    cfg = JaxMeshGenConfig(init_factor=8)
    field = jax_refine_field(scene.bind(), jax_create_field(cfg), cfg, csdf=compile_scene_csdf(scene))
    return field_from_numpy(field.to_numpy(), field.voxel_size, field.level, "cpu")


def _checker(x, y, z):
    return torch.sin(np.pi * (x + 0.5)) * torch.sin(np.pi * (y + 0.5)) * torch.sin(np.pi * (z + 0.5))


def _checker_value_and_grad(x, y, z):
    with torch.enable_grad():
        p = [t.detach().requires_grad_() for t in (x, y, z)]
        d = _checker(*p)
        g = torch.autograd.grad(d.sum(), p)
    return (d.detach(), *g)


def _mesh_field(name: str, field_8):
    """``(fns, lowers, voxel size)``: the reference object's field, or a 4^3
    block of unit voxels whose corners alternate in sign (all 12 edges
    cross)."""
    if name == "reference":
        return sdf_fns(compile_scene(reference_object(device="cpu"))), field_8.lowers, field_8.voxel_size
    grid = torch.stack(torch.meshgrid(*[torch.arange(4.0)] * 3, indexing="ij"), dim=-1)
    return SdfFns(_checker, _checker_value_and_grad), grid.reshape(-1, 3), 1.0


@pytest.mark.parametrize("budget", [2, 6, 12])
@pytest.mark.parametrize("field", ["reference", "checkerboard"])
def test_edge_slots_list_the_staged_edges(field_8, budget, field):
    cfg = MeshGenConfig(init_factor=8, edge_budget=budget)
    fns, lowers, vs = _mesh_field(field, field_8)
    v = _classify(fns, lowers, vs, cfg)
    _, kwargs = kernel_inputs(fns, lowers, vs, cfg)
    _, _, _, rank, nact = _staged_inputs(v, cfg)
    cross_bits = (v.crossing.long() << torch.arange(12)).sum(dim=1).int()
    voxel, edge, r, slot = mc_kernel.edge_slots(cross_bits, kwargs["budget"])

    # the staged path's packed edges: crossing, rank < budget
    want_v, want_e = (v.crossing & (rank < budget)).nonzero(as_tuple=True)
    assert torch.equal(voxel, want_v) and torch.equal(edge, want_e)
    assert torch.equal(r, rank[want_v, want_e])
    if field == "checkerboard":
        assert bool((nact == 12).all()) and voxel.numel() == lowers.shape[0] * budget

    # each block's slots: 0 .. its edges - 1, once each, voxel by voxel in
    # rank order, every voxel's from the scan of min(popc, budget)
    size = mc_kernel.BLOCK_VOXELS
    block = voxel // size
    listed = torch.clamp_max(nact, budget)
    for b in torch.unique(block):
        mine = block == b
        assert torch.equal(slot[mine], torch.arange(int(mine.sum())))
        first = torch.cumsum(listed[b * size:(b + 1) * size], 0) - listed[b * size:(b + 1) * size]
        assert torch.equal(slot[mine] - r[mine], first[voxel[mine] - b * size])
    assert int(slot.max()) < 12 * size


@pytest.mark.parametrize("budget", [2, 6, 12])
@pytest.mark.parametrize("field", ["reference", "checkerboard"])
def test_staged_soup_over_listed_edges_equals_padded_lanes(field_8, budget, field):
    cfg = MeshGenConfig(init_factor=8, edge_budget=budget, interpolate_edges=True)
    fns, lowers, vs = _mesh_field(field, field_8)
    n = lowers.shape[0]
    soup = extract_triangles(fns, lowers, vs, cfg)

    # the padded-lane path: K7's twin over every lane, the empty ones zeroed
    args, kwargs = padded_inputs(fns, lowers, vs, cfg)
    active = args[3] > 0
    v = _classify(fns, lowers, vs, cfg)
    _, _, _, rank, nact = _staged_inputs(v, cfg)
    assert args[0].numel() == n * budget
    assert int(active.sum()) == int(torch.clamp_max(nact, budget).sum())
    if field == "reference" and budget > 2:
        assert not active.all()  # lanes the JAX layout pads
    if budget == 12 or (field == "reference" and budget > 2):
        assert int(soup.valid.sum()) > 0
    planes = torch.stack([torch.where(active, p, 0.0).reshape(n, budget)
                          for p in project_edges(fns, *args, **kwargs)], dim=-1)
    padded = _staged_soup(fns, v, planes, rank, nact, cfg)
    for a, b in zip(soup[:3], padded[:3]):
        assert torch.equal(a, b)
    assert soup.edge_overflow == padded.edge_overflow == int(torch.clamp_min(nact - budget, 0).sum())

    # what the staged path hands K7: the padded lanes' active points, in order
    listed, listed_kwargs = kernel_inputs(fns, lowers, vs, cfg)
    assert listed_kwargs == kwargs
    assert all(torch.equal(a, p[active]) for a, p in zip(listed[:3], args[:3]))
    assert bool((listed[3] == 1).all()) and listed[3].dtype == torch.int32
