"""The mesh-asset render of the PyTorch port (bsdmg_tpu_torch/ops/cuda/
grid_kernel.py: the plain twins of CUDA kernels K8, K9 and P1, and the
routes around them) against the JAX package's bsdmg_tpu/ops/pallas/
grid_kernel.py, its Pallas kernels run in interpret mode, on the same
numpy-seeded inputs and the same baked tables. The kernels need nvcc and a
card; chip_smoke.py holds each against its twin there, bit for bit.

Bars:

* samplers: within 1e-6 of their JAX forms (2e-6 for the exact hat sampler,
  whose XLA dot sums the four corners in its own order, as the JAX
  package's own test allows); P1 within 1e-4 of the probe's trilinear
  oracle;
* K8 and each K9 level: outcomes and steps equal on >= 99.9% of rays, depth
  within 1e-5 where both collide with the same steps; at a bf16 level on
  >= 99.5% of those rays, and all within 1e-3: there a ray creeps along the
  margin stall in steps of ~1e-3 and its last one may end elsewhere (2 of
  702 hits on the 16^3 mip of the icosphere);
* the gather route end to end: the same; the contraction route end to end:
  outcomes on >= 99.9% of rays, steps on >= 99.7%, depth within 1e-5 where
  both collide. Bit equality is out of reach because XLA's CPU compiler
  contracts the march's ``o + t*d`` and ``t + f - c*t`` into FMAs, and near
  a bf16 level's margin stall a ray creeps in steps of ~1e-3, so one
  rounding moves its step count at that level; the fine finish then
  converges to the same depth. On the 96^3 sphere at 64x64 the two ladder
  levels differ on 3 and 4 rays of 4,096 and the route on 9; a twin march
  that emulates the FMAs leaves 1 of the first level's 3;
* images: >= 99% of pixels within 1e-3 (tests/test_mesh_sdf.py:475-476).
"""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsdmg_tpu.cam import generate_rays, look_at
from bsdmg_tpu.cli import _get_scene as jax_get_scene
from bsdmg_tpu.config import MarchConfig as JaxMarchConfig
from bsdmg_tpu.config import MeshGenConfig
from bsdmg_tpu.mesh import generate_mesh
from bsdmg_tpu.models import sphere_scene
from bsdmg_tpu.models.mesh_sdf import SdfGrid, bake_mesh_grid, coarsen_grid_lower, grid_csdf
from bsdmg_tpu.ops.pallas import grid_kernel as jg
from bsdmg_tpu.ops.pallas.render_kernel import _march as jax_march
from bsdmg_tpu.ops.pallas.render_kernel import _unswizzle, swizzled_ray_planes
from bsdmg_tpu_torch import cli
from bsdmg_tpu_torch.config import MarchConfig
from bsdmg_tpu_torch.mesh.export import save_obj
from bsdmg_tpu_torch.mesh.pipeline import Mesh
from bsdmg_tpu_torch.models import mesh_sdf as tm
from bsdmg_tpu_torch.ops.cuda import grid_box
from bsdmg_tpu_torch.ops.cuda import grid_kernel as tg
from bsdmg_tpu_torch.ops.cuda.render_kernel import _march
from bsdmg_tpu_torch.weights import grid_from_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
COLLISION, STEP_LIMIT, DEPTH_LIMIT = 0, 1, 2
CFG = JaxMarchConfig()


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_grid(grid):
    return grid_from_numpy(np.asarray(grid.values), grid.lo, grid.hi, "cpu")


def assert_march_bars(got, ref, steps_share=0.999, same_steps_only=True, creep=False):
    """``got``/``ref``: ``(depth, steps, outcome)`` numpy arrays; ``creep``:
    the bars of a bf16 level's depths."""
    (dg, sg, og), (dr, sr, orf) = got, ref
    same = og == orf
    assert same.mean() >= 0.999, f"outcomes differ on {(~same).sum()} rays"
    steps_same = same & (sg == sr)
    assert steps_same.mean() >= steps_share, f"steps differ on {(~steps_same).sum()} rays"
    both = (steps_same if same_steps_only else same) & (og == COLLISION)
    assert both.sum() > 100
    err = np.abs(dg - dr)[both]
    if creep:
        assert (err <= 1e-5).mean() >= 0.995 and err.max() <= 1e-3, np.sort(err)[-5:]
    else:
        assert err.max() <= 1e-5


def assert_image_bars(img, ref):
    assert img.shape == ref.shape and img.dtype == np.float32
    diff = np.abs(img - ref).max(axis=-1)
    assert (diff < 1e-3).mean() >= 0.99, f"pixels over 1e-3: {(diff >= 1e-3).sum()}"
    assert img.std() > 0.01


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ico():
    """tests/test_mesh_sdf.py's icosphere baked at 32^3 by the JAX package,
    and 32x128 rays from (3, 1, -3) (tests/test_mesh_sdf.py:214-254)."""
    mesh = generate_mesh(sphere_scene(1.0).bind(), refine_steps=1,
                         config=MeshGenConfig(init_factor=16, bb_size=4.0))
    grid = bake_mesh_grid(mesh.vertices, mesh.faces, resolution=32)
    grid = SdfGrid(values=np.asarray(grid.values), lo=grid.lo, hi=grid.hi)
    cam = look_at((3.0, 1.0, -3.0), (0.0, 0.0, 0.0))
    o, d, c = generate_rays(cam, (128, 32), (128.0, 32.0))
    return grid, tuple(np.asarray(a) for a in (o, d, c))


def _sphere96():
    r, lo, hi = 96, -1.5, 1.5
    ax = np.linspace(lo, hi, r, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return SdfGrid(values=np.sqrt(x * x + y * y + z * z) - 1.0, lo=(lo,) * 3, hi=(hi,) * 3)


@pytest.fixture(scope="module")
def sphere96_render():
    """JAX render_image_grid in both modes on the 96^3 sphere at 64x64, with
    the trace each mode ran (its swizzled rays and planes) captured."""
    grid = _sphere96()
    cam = look_at((2.5, 1.0, -2.5), (0.0, 0.0, 0.0), fov=np.pi / 4)
    o, d, c = generate_rays(cam, (64, 64), (64.0, 64.0))
    out = {"grid": grid, "rays": tuple(np.asarray(a) for a in (o, d, c))}
    for mode, name in (("contraction", "grid_trace_contraction"), ("gather", "grid_trace_hybrid")):
        traced = []
        fn = getattr(jg, name)

        def spy(grid, o_s, d_s, cone_s, *args, _fn=fn, **kwargs):
            planes = _fn(grid, o_s, d_s, cone_s, *args, **kwargs)
            traced.append(((o_s, d_s, cone_s), planes))
            return planes

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jg, name, spy)
            image = jg.render_image_grid(grid, o, d, c, interpret=True, mode=mode)
        (rays, planes), = traced
        out[mode] = (np.asarray(image), tuple(np.asarray(a) for a in rays),
                     tuple(np.asarray(a) for a in planes))
    return out


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------


def _random_grid(r=17, seed=0):
    vals = np.random.default_rng(seed).standard_normal((r, r, r)).astype(np.float32)
    return SdfGrid(values=vals, lo=(-1.0, -1.2, -0.9), hi=(1.1, 1.0, 1.3))


def _points(seed, shape=(8, 512)):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1.5, 1.5, shape).astype(np.float32) for _ in range(3)]


def test_interp_sampler_equals_grid_csdf():
    grid = _random_grid()
    x, y, z = _points(1)
    ref = np.asarray(grid_csdf(grid)(*map(jnp.asarray, (x, y, z))))
    sampler = tg.interp_sampler(_port_grid(grid))
    got = tg.grid_sample(sampler, *(_t(a.reshape(-1)) for a in (x, y, z))).numpy()
    np.testing.assert_allclose(got, ref.reshape(-1), atol=1e-6)
    # the sampler's twin is models/mesh_sdf.py's grid_csdf, value for value
    same = tm.grid_csdf(_port_grid(grid))(*(_t(a.reshape(-1)) for a in (x, y, z)))
    np.testing.assert_array_equal(got, same.numpy())


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_hat_sampler_equals_make_contraction_csdf(bf16):
    grid = _random_grid(seed=2)
    r = grid.resolution
    maxv = float(np.abs(grid.values).max())
    margin = jg._BF16_MARGIN * maxv if bf16 else 0.0
    t2 = jg._table2(grid.values)
    ref_fn = jg.make_contraction_csdf(t2.astype(jnp.bfloat16) if bf16 else t2, r, grid.lo, grid.hi,
                                      bf16=bf16, margin=margin)
    x, y, z = _points(3)
    ref = np.asarray(jax.jit(ref_fn)(*map(jnp.asarray, (x, y, z)))).reshape(-1)
    table = _t(grid.values.reshape(-1))
    level = tg.Sampler(tg.HAT_BF16 if bf16 else tg.HAT_F32,
                       table.to(torch.bfloat16) if bf16 else table, r, grid.lo, grid.hi,
                       float(np.float32(margin)))
    got = tg.grid_sample(level, *(_t(a.reshape(-1)) for a in (x, y, z))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6 if bf16 else 2e-6)
    if bf16:  # a sound lower bound of the exact interpolant
        exact = np.asarray(grid_csdf(grid)(*map(jnp.asarray, (x, y, z)))).reshape(-1)
        assert (got <= exact + 1e-6).all()


def _probe_oracle(t3, cx, cy, cz):
    """tools/probe_mxu.py's numpy trilinear oracle."""
    r = t3.shape[0]

    def tri(q):
        x0 = np.floor(q).astype(int)
        return x0, np.minimum(x0 + 1, r - 1), q - x0

    (x0, x1, fx), (y0, y1, fy), (z0, z1, fz) = tri(cx), tri(cy), tri(cz)
    exp = np.zeros(cx.shape)
    for dx, wxv in ((x0, 1 - fx), (x1, fx)):
        for dy, wyv in ((y0, 1 - fy), (y1, fy)):
            for dz, wzv in ((z0, 1 - fz), (z1, fz)):
                exp += wxv * wyv * wzv * t3[dx, dy, dz]
    return exp


def test_p1_matches_probe_oracle():
    """P1's inputs: T3 = arange(32^3) % 97, 512 seeded coordinates in
    [0, 30.999); the hat sampler on the box [0, 31]^3 samples grid
    coordinates as they are."""
    r = 32
    t3 = (np.arange(r**3, dtype=np.float32) % 97).reshape(r, r, r)
    cx, cy, cz = np.random.default_rng(0).uniform(0.0, r - 1.001, (3, 512)).astype(np.float32)
    ref = _probe_oracle(t3, cx, cy, cz)
    sampler = tg.Sampler(tg.HAT_F32, _t(t3.reshape(-1)), r, (0.0,) * 3, (r - 1.0,) * 3)
    got = tg.grid_sample(sampler, _t(cx), _t(cy), _t(cz)).numpy()
    assert np.abs(got - ref).max() <= 1e-4
    t2 = _t(t3.reshape(r * r, r).T)
    probe = tg.probe_contraction_torch(t2, *(_t(c[None]) for c in (cx, cy, cz))).numpy()
    assert probe.shape == (1, 512) and np.abs(probe[0] - ref).max() <= 1e-4


# ---------------------------------------------------------------------------
# K8 and K9 levels
# ---------------------------------------------------------------------------


def test_k8_twin_equals_grid_trace_pallas(ico):
    grid, (o, d, c) = ico
    o_s, d_s, cone_s, _ = swizzled_ray_planes(o, d, c, 32, 128)
    ref = jg.grid_trace_pallas(grid.values.reshape(-1), grid.resolution, grid.lo, grid.hi,
                               o_s, d_s, cone_s, CFG, interpret=True)
    got = tg.grid_march(tg.interp_sampler(_port_grid(grid)), _t(o_s), _t(d_s), _t(cone_s))
    assert_march_bars([x.numpy() for x in got], [np.asarray(x).reshape(-1) for x in ref])


@pytest.fixture(scope="module")
def ico_levels(ico):
    """A bf16 lower-bound level (the 16^3 mip) marched from depth 0, then the
    exact 32^3 level resumed from its state, by the JAX kernel; the inputs
    of each level and its outputs."""
    grid, (o, d, c) = ico
    coarse = coarsen_grid_lower(grid, 16)
    margin = jg._BF16_MARGIN * float(np.abs(coarse.values).max())
    jax_levels = [
        (jg._table2(coarse.values).astype(jnp.bfloat16), 16, coarse.lo, coarse.hi, True, margin),
        (jg._table2(grid.values), 32, grid.lo, grid.hi, False, 0.0),
    ]
    ports = [
        tg.Sampler(tg.HAT_BF16, _t(coarse.values.reshape(-1)).to(torch.bfloat16), 16, coarse.lo,
                   coarse.hi, float(np.float32(margin))),
        tg.Sampler(tg.HAT_F32, _t(grid.values.reshape(-1)), 32, grid.lo, grid.hi),
    ]
    planes = [jnp.asarray(a).reshape(8, 512) for a in (*np.moveaxis(o, -1, 0),
                                                         *np.moveaxis(d, -1, 0), c)]
    state = (jnp.ones((8, 512), jnp.int32), jnp.zeros((8, 512), jnp.float32),
             jnp.zeros((8, 512), jnp.int32), jnp.full((8, 512), DEPTH_LIMIT, jnp.int32))
    out = []
    for (t2, r, lo, hi, bf16, m), port in zip(jax_levels, ports):
        planes_out = jg.grid_trace_contraction_pallas(
            t2, r, tuple(lo), tuple(hi), *planes, *state, config=CFG, budget=CFG.step_limit,
            bf16=bf16, margin=m, interpret=True,
        )
        out.append((port, [np.asarray(a).reshape(-1) for a in state],
                    [np.asarray(a).reshape(-1) for a in planes_out]))
        depth, steps, outcome = planes_out
        resume = (outcome == COLLISION) | (outcome == STEP_LIMIT)
        state = (resume.astype(jnp.int32), depth, jnp.where(outcome == STEP_LIMIT, 0, steps),
                 outcome)
    return out


@pytest.mark.parametrize("level", [0, 1], ids=["bf16 mip from depth 0", "exact resumed"])
def test_k9_level_twin_equals_grid_trace_contraction_pallas(ico, ico_levels, level):
    _, (o, d, c) = ico
    port, state, ref = ico_levels[level]
    active, depth0, steps0, outcome0 = (_t(a) for a in state)
    resume = {} if level == 0 else dict(active=active, depth0=depth0, steps0=steps0,
                                        outcome0=outcome0)
    got = tg.grid_march(port, _t(o), _t(d), _t(c), budget=256, **resume)
    assert_march_bars([x.numpy() for x in got], ref, creep=port.kind == tg.HAT_BF16)
    if level == 1:
        assert active.sum() > 100 and (active == 0).any()  # resumed and finished rays both


def test_make_contraction_levels_equal_jax():
    for r in (24, 48, 96):
        ax = np.linspace(-1.5, 1.5, r, dtype=np.float32)
        x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
        grid = SdfGrid(values=np.sqrt(x * x + y * y + z * z) - 1.0, lo=(-1.5,) * 3, hi=(1.5,) * 3)
        ref = jg.make_contraction_levels(grid)
        got = tg.make_contraction_levels(_port_grid(grid))
        assert len(got) == len(ref)
        for (t2, rr, lo, hi, bf16, margin, exact), level in zip(ref, got):
            assert (level.r, level.lo, level.hi) == (rr, lo, hi)
            assert level.kind == (tg.HAT_BF16 if bf16 else tg.HAT_F32) and exact == (not bf16)
            assert level.margin == float(np.float32(margin))
            table = level.table.float().numpy().reshape(rr * rr, rr).T
            np.testing.assert_array_equal(table, np.asarray(t2).astype(np.float32))
            assert level.table.dtype == (torch.bfloat16 if bf16 else torch.float32)


# ---------------------------------------------------------------------------
# the routes end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["contraction", "gather"])
def test_grid_trace_route_equals_jax(sphere96_render, mode):
    """grid_trace_contraction (two bf16 levels and the fine finish) and
    grid_trace_hybrid (K8 on the 64^3 mip and the fine finish) on the rays
    and planes of the JAX route, the image's own pixels compared."""
    grid = _port_grid(sphere96_render["grid"])
    _, (o_s, d_s, cone_s), ref = sphere96_render[mode]
    trace = tg.grid_trace_contraction if mode == "contraction" else tg.grid_trace_hybrid
    got = trace(grid, _t(o_s), _t(d_s), _t(cone_s))
    assert got[0].shape == cone_s.shape

    def pixels(plane):
        m = 2 * 4 * 8  # live swizzled rows of a 64x128 padded frame
        return np.asarray(_unswizzle(jnp.asarray(plane)[:m], 64, 128))[:64, :64].reshape(-1)

    bars = dict(steps_share=0.997, same_steps_only=False) if mode == "contraction" else {}
    assert_march_bars([pixels(x.numpy()) for x in got], [pixels(x) for x in ref], **bars)


@pytest.mark.parametrize("mode", ["contraction", "gather"])
def test_render_image_grid_equals_jax(sphere96_render, mode):
    grid = _port_grid(sphere96_render["grid"])
    o, d, c = (_t(a) for a in sphere96_render["rays"])
    launches = dict(tg.LAUNCHES)
    img = tg.render_image_grid(grid, o, d, c, mode=mode).numpy()
    assert tg.LAUNCHES == launches  # CPU tensors: the twins, no kernel
    assert_image_bars(img, sphere96_render[mode][0])


def test_render_image_grid_rejects_unknown_mode():
    grid = tm.SdfGrid(values=torch.zeros((4, 4, 4)), lo=(-1.0,) * 3, hi=(1.0,) * 3)
    o, d, c = torch.zeros((2, 2, 3)), torch.ones((2, 2, 3)), torch.zeros((2, 2))
    with pytest.raises(ValueError, match="mode"):
        tg.render_image_grid(grid, o, d, c, mode="texture")


def _sphere16():
    r, lo, hi = 16, -1.5, 1.5
    ax = np.linspace(lo, hi, r, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return SdfGrid(values=np.sqrt(x * x + y * y + z * z) - 1.0, lo=(lo,) * 3, hi=(hi,) * 3)


@pytest.mark.parametrize("mode", ["contraction", "gather"])
def test_render_image_grid_steps_exactly_as_jax(mode):
    """The grid march (K8, K9) steps exactly whatever ``config.relaxation``
    says, as JAX's grid kernels, which never read it (``grid_march`` and
    ``render_image_grid`` raised on it before): on a 16^3 sphere grid at
    16x8, ``render_image_grid`` at relaxation 1.5 equals its image at 1.0 bit
    for bit and JAX's ``render_image_grid`` at 1.5 (interpret mode) by the
    image bars; ``grid_march`` at 1.5 equals its march at 1.0."""
    jgrid = _sphere16()
    grid = _port_grid(jgrid)
    cam = look_at((2.5, 1.0, -2.5), (0.0, 0.0, 0.0), fov=np.pi / 4)
    o, d, c = generate_rays(cam, (16, 8), (16.0, 8.0))
    rays = tuple(_t(a) for a in (o, d, c))
    img = tg.render_image_grid(grid, *rays, MarchConfig(relaxation=1.5), mode=mode)
    assert torch.equal(img, tg.render_image_grid(grid, *rays, MarchConfig(), mode=mode))
    ref = np.asarray(jg.render_image_grid(jgrid, o, d, c, JaxMarchConfig(relaxation=1.5),
                                          interpret=True, mode=mode))
    assert_image_bars(img.numpy(), ref)
    sampler = tg.interp_sampler(grid)
    relaxed = tg.grid_march(sampler, *rays, MarchConfig(relaxation=1.5))
    assert all(torch.equal(a, b) for a, b in zip(relaxed, tg.grid_march(sampler, *rays)))


# ---------------------------------------------------------------------------
# the resumable march twin
# ---------------------------------------------------------------------------


def _march_before_resume(csdf, config, ox, oy, oz, dx, dy, dz, cone, active, depth, limit):
    """ops/cuda/render_kernel.py::_march as it was before it took resume
    arguments (without its track_min record)."""
    eps = config.collision_distance
    steps = torch.zeros_like(depth, dtype=torch.int32)
    outcome = torch.full_like(steps, DEPTH_LIMIT)
    outcome[active] = STEP_LIMIT
    live = active.nonzero().squeeze(1)
    while live.numel():
        t = depth[live]
        cd = cone[live] * t
        dist = csdf(ox[live] + t * dx[live], oy[live] + t * dy[live], oz[live] + t * dz[live])
        hit = dist <= cd + eps
        outcome[live[hit]] = COLLISION
        advance = ~hit
        t = t + dist - cd
        over = advance & (t > limit[live])
        depth[live[advance]] = t[advance]
        outcome[live[over]] = DEPTH_LIMIT
        survived = advance & ~over
        s = steps[live] + survived.to(torch.int32)
        steps[live] = s
        live = live[survived & (s < config.step_limit)]
    return steps, outcome


def _flat(o, d, c):
    return (*(_t(o[..., a].reshape(-1)) for a in range(3)),
            *(_t(d[..., a].reshape(-1)) for a in range(3)), _t(c.reshape(-1)))


def test_march_defaults_equal_the_twin_before_resume(ico):
    grid, (o, d, c) = ico
    csdf = tm.grid_csdf(_port_grid(grid))
    rays = _flat(o, d, c)
    n = rays[-1].numel()
    active = torch.arange(n) % 5 != 0
    limit = torch.full((n,), 500.0)
    depth_a, depth_b = torch.zeros(n), torch.zeros(n)
    steps, outcome, min_m, t_min, unresolved = _march(csdf, MarchConfig(), *rays, active, depth_a, limit)
    ref_steps, ref_outcome = _march_before_resume(csdf, MarchConfig(), *rays, active, depth_b, limit)
    assert torch.equal(steps, ref_steps) and torch.equal(outcome, ref_outcome)
    assert torch.equal(depth_a, depth_b)
    assert min_m is None and t_min is None and not unresolved.any()
    assert (outcome == COLLISION).sum() > 100


def test_march_resume_equals_jax_march(ico):
    """A march with budget 12 from depth 0, then every ray it left
    unresolved, plus a few finished ones, resumed with budget 40 (some with
    steps past it already, which still take their first step); the others
    keep their outcome."""
    grid, (o, d, c) = ico
    jcsdf = grid_csdf(grid)
    cfg = MarchConfig()
    jplanes = [jnp.asarray(a).reshape(32, 128) for a in (*np.moveaxis(o, -1, 0),
                                                          *np.moveaxis(d, -1, 0), c)]
    ones = jnp.ones((32, 128), bool)
    d1, s1, o1, u1 = jax_march(jcsdf, CFG, jplanes[0:3], jplanes[3:6], jplanes[6], ones,
                               jnp.zeros((32, 128)), jnp.zeros((32, 128), jnp.int32), 12)
    i = jnp.arange(32 * 128).reshape(32, 128)
    active = u1 | (i % 97 == 0)
    steps0 = jnp.where(i % 11 == 0, 45, s1)
    ref = jax_march(jcsdf, CFG, jplanes[0:3], jplanes[3:6], jplanes[6], active, d1, steps0, 40,
                    outcome0=o1)
    ref = [np.asarray(a).reshape(-1) for a in ref]

    csdf = tm.grid_csdf(_port_grid(grid))
    rays = _flat(o, d, c)
    n = rays[-1].numel()
    depth = _t(d1).reshape(-1)
    steps, outcome, _, _, unresolved = _march(
        csdf, cfg, *rays, _t(active).reshape(-1), depth, torch.full((n,), 500.0),
        steps0=_t(steps0).reshape(-1), outcome0=_t(o1).reshape(-1), budget=40,
    )
    assert_march_bars([depth.numpy(), steps.numpy(), outcome.numpy()], ref[:3])
    assert (unresolved.numpy() == ref[3]).mean() >= 0.999 and ref[3].any()
    assert np.asarray(u1).sum() > 100 and (np.asarray(steps0)[np.asarray(active)] >= 40).any()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def torus_obj(tmp_path_factory):
    """A 768-triangle torus OBJ (tools/make_torus.py's shape, fewer facets)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("make_torus", ROOT / "tools" / "make_torus.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    verts, faces = module.torus(nu=24, nv=16)
    path = tmp_path_factory.mktemp("mesh") / "torus.obj"
    save_obj(Mesh(vertices=verts, normals=np.zeros_like(verts), faces=faces), path)
    return path


def test_cli_render_mesh_scene_matches_jax(torus_obj, tmp_path, caplog):
    out = tmp_path / "torus.npy"
    spec = f"mesh:{torus_obj}:24"
    argv = ["render", "--device", "cpu", "--scene", spec, "--width", "64", "--height", "48",
            "--camera", "3", "1", "-3", "-o", str(out)]
    launches = dict(tg.LAUNCHES)
    with caplog.at_level("INFO", logger="bsdmg_tpu_torch"):
        assert cli.main(argv) == 0
    assert tg.LAUNCHES == launches
    assert any("baked 24^3 grid" in m for m in caplog.messages)
    img = np.load(out)
    scene = jax_get_scene(spec)
    cam = look_at((3.0, 1.0, -3.0), (0.0, 0.0, 0.0))
    o, d, c = generate_rays(cam, (64, 48), (1920.0, 1080.0))
    ref = np.asarray(jg.render_image_grid(scene.grid, o, d, c, mode="contraction", interpret=True))
    assert_image_bars(img, ref)


def test_cli_render_mesh_scene_needs_a_card(torus_obj, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["render", "--scene", f"mesh:{torus_obj}:24", "--width", "16", "--height", "8",
                  "-o", str(tmp_path / "x.png")])


@pytest.mark.parametrize("spec", ["a.obj", "a.obj:64", "dir:x/a.obj", "dir:x/a.obj:32", "a:b"])
def test_parse_mesh_spec_equals_jax(spec):
    from bsdmg_tpu.cli import _parse_mesh_spec as jax_parse

    assert cli._parse_mesh_spec(spec) == jax_parse(spec)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def test_wrappers_send_cpu_tensors_to_the_twins(ico):
    grid, (o, d, c) = ico
    sampler = tg.interp_sampler(_port_grid(grid))
    launches = dict(tg.LAUNCHES)
    got = tg.grid_march(sampler, _t(o), _t(d), _t(c))
    ref = tg.grid_march_torch(sampler, _t(o), _t(d), _t(c))
    x = _t(o[..., 0].reshape(-1))
    values = tg.grid_sample(sampler, x, x, x)
    assert tg.LAUNCHES == launches
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert torch.equal(values, tg.grid_sample_torch(sampler, x, x, x))


def _finish_state(ico):
    """The contraction route's state before its fine finish on ``ico``'s 32^3
    table marched as a 16^3 mip (the JAX package's finish state)."""
    grid, (o, d, c) = ico
    port = _port_grid(grid)
    coarse = tg.interp_sampler(tm.coarsen_grid_lower(port, 16))
    depth, steps, outcome = tg.grid_march(coarse, _t(o), _t(d), _t(c))
    active, steps = tg.resume_state(steps, outcome)
    return port, (_t(o), _t(d), _t(c)), dict(active=active, depth0=depth, steps0=steps,
                                              outcome0=outcome)


def test_grid_march_into_writes_only_the_active_rays(ico):
    """K8's in-place resumed march on the CPU: the active rays end as the
    public wrapper's resumed march ends them, the others keep their planes'
    values, and the caller's state passed to the public wrapper is left as
    it was."""
    port, rays, state = _finish_state(ico)
    sampler = tg.interp_sampler(port)
    copies = {k: v.clone() for k, v in state.items()}
    ref = tg.grid_march(sampler, *rays, budget=256, **state)
    assert all(torch.equal(state[k], copies[k]) for k in state)
    planes = [state[k].clone() for k in ("depth0", "steps0", "outcome0")]
    launches = dict(tg.LAUNCHES)
    tg.grid_march_into(sampler, *rays, active=state["active"], depth=planes[0], steps=planes[1],
                       outcome=planes[2], budget=256)
    assert tg.LAUNCHES == launches
    assert all(torch.equal(a, b) for a, b in zip(planes, ref))
    idle = state["active"] == 0
    assert all(torch.equal(a[idle], copies[k][idle])
               for a, k in zip(planes, ("depth0", "steps0", "outcome0")))
    assert int(state["active"].sum()) > 100 and int(idle.sum()) > 100


def test_grid_march_into_takes_only_k8(ico):
    port, rays, state = _finish_state(ico)
    level = tg.make_contraction_levels(port)[0]
    planes = dict(depth=state["depth0"], steps=state["steps0"], outcome=state["outcome0"])
    with pytest.raises(ValueError):
        tg.grid_march_into(level, *rays, active=state["active"], **planes)


def _bad_march_inputs():
    grid = tm.SdfGrid(values=torch.zeros((4, 4, 4)), lo=(-1.0,) * 3, hi=(1.0,) * 3)
    s = tg.interp_sampler(grid)
    o, d, c = torch.zeros((2, 3, 3)), torch.ones((2, 3, 3)), torch.zeros((2, 3))
    i = torch.zeros(6, dtype=torch.int32)
    meta = torch.empty((2, 3), device="meta")
    return {
        "float64 rays": ((s, o.double(), d, c), {}, TypeError),
        "ray shape": ((s, o[:1].contiguous(), d, c), {}, ValueError),
        "non-contiguous rays": ((s, o.transpose(0, 1).contiguous().transpose(0, 1), d, c), {},
                                ValueError),
        "device mismatch": ((s, o, d, meta), {}, ValueError),
        "part of a resume state": ((s, o, d, c), dict(active=i), ValueError),
        "resume state dtype": ((s, o, d, c), dict(active=i.float(), depth0=c, steps0=i,
                                                  outcome0=i), TypeError),
        "table size": ((s._replace(r=5), o, d, c), {}, ValueError),
        "table dtype": ((s._replace(kind=tg.HAT_BF16), o, d, c), {}, TypeError),
        "sampler kind": ((s._replace(kind=7), o, d, c), {}, ValueError),
        "unsupported device": ((s._replace(table=s.table.to("meta")), o.to("meta"), d.to("meta"),
                                meta), {}, ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_march_inputs()))
def test_grid_march_rejects_bad_inputs(case):
    args, kwargs, error = _bad_march_inputs()[case]
    with pytest.raises(error):
        tg.grid_march(*args, **kwargs)


def _c_struct_fields(source: str, name: str):
    body = re.search(r"struct %s \{(.*?)\n\};" % name, source, re.S).group(1)
    return [re.match(r"\s*(\w+)\s+(\w+)(?:\[(\w+)\])?;", line).groups()
            for line in body.splitlines() if re.match(r"\s*\w+\s+\w+(\[\w+\])?;", line)]


@pytest.mark.parametrize("header,c_name,py_struct", [
    ("grid_sdf.cuh", "GridBox", grid_box.GridBoxC),
    ("grid_kernel.cu", "GridMarch", tg._GridMarchC),
])
def test_struct_layout_matches_cuda_source(header, c_name, py_struct):
    """The ctypes mirrors list the C structs' fields in order, with the same
    types and lengths (the library also checks their sizes at load)."""
    source = (ROOT / "bsdmg_tpu_torch" / "csrc" / header).read_text()
    types = {"int": ctypes.c_int, "float": ctypes.c_float}
    c_fields = _c_struct_fields(source, c_name)
    assert [f[1] for f in c_fields] == [f[0] for f in py_struct._fields_]
    for (c_type, _, length), (_, py_type) in zip(c_fields, py_struct._fields_):
        if length is None:
            assert py_type is types[c_type]
        else:
            assert py_type._type_ is types[c_type] and py_type._length_ == int(length)
