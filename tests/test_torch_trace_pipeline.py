"""The trace-only and shade-only render paths of the port: kernel K2's and
K3's plain twins and the pipelines around them
(bsdmg_tpu_torch/ops/cuda/render_kernel.py).

K2 and K3 themselves need nvcc and a card; chip_smoke.py holds them against
their twins there, bit for bit. Here the twins, on the descriptor from
ops/cuda/csdf.py, are held against the JAX package's Pallas kernels run in
interpret mode on the same rays (the reference scene from (5, 2, -5), 256x64
unless noted), with the bars of tests/test_torch_render_kernel.py:

* trace planes: outcome identical on >= 99.9% of rays, steps identical
  wherever the outcome is, depth within 1e-4 where both collide;
* images: max-channel difference < 2e-2 on >= 99.9% of pixels, mean < 1e-4;
* K3 on the JAX package's own planes: equal off the hits; on the hits
  within 1e-4. The fd4 stencil (eps 1e-3) divides float32 rounding of
  the SDF by 12 eps: at 256x64 the port and the JAX package each lie up to
  4.7e-5 and 3.9e-5 from the same stencil in float64, and 4.5e-5 from each
  other, so a 1e-5 bar would test float32 rounding, not the port.

The JAX package caps its row tail (``tail_cap``) and finishes an overflow in
a phase C; the port lists the tail on the device and has no cap. The capped
runs and the port's must still be one march: that is what the caps were
tested for. Every port path must also equal the port's single-phase result
exactly: the same march, the same epilogue.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bsdmg_tpu.cam import generate_rays, look_at
from bsdmg_tpu.config import MarchConfig as JaxMarchConfig
from bsdmg_tpu.models import reference_render_scene as jax_scene
from bsdmg_tpu.ops.pallas import compile_scene_csdf, sphere_trace_pallas
from bsdmg_tpu.ops.pallas.csdf import scene_bounds
from bsdmg_tpu.ops.pallas.render_kernel import (
    _march as jax_march,
    _shade_call,
    render_image_pallas,
    trace_pallas,
)
from bsdmg_tpu_torch.config import MarchConfig
from bsdmg_tpu_torch.models import reference_render_scene
from bsdmg_tpu_torch.ops.cuda import render_kernel
from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene, descriptor_csdf
from bsdmg_tpu_torch.ops.cuda.render_kernel import (
    _march,
    block_flags,
    compact_list,
    render_image_cuda,
    shade_cuda,
    shade_planes_torch,
    sphere_trace_cuda,
    trace_cuda,
    trace_planes_torch,
)
from test_torch_render_kernel import assert_image_bars

# one intra-op thread: PyTorch's spinning OpenMP pool would otherwise take
# every core from the timing-sensitive tests that run beside these
torch.set_num_threads(1)

COLLISION = 0
W, H = 256, 64
TRACE_CASES = [(False, None), (True, None), (True, 1024), (True, 512)]
RENDER_CASES = {
    "row": dict(two_phase=True, phase_a_steps=8),
    "block": dict(two_phase="block", phase_a_steps=8),
    "unswizzled": dict(swizzle=False),
}
#: the march options on the render paths: no cull, alone and under block
#: retirement; relaxed block retirement; relaxed and uncull'd row two-phase
OPTION_CASES = {
    "uncull'd": dict(use_bb_skip=False),
    "uncull'd block": dict(two_phase="block", phase_a_steps=8, use_bb_skip=False),
    "relaxed block": dict(two_phase="block", phase_a_steps=8, omega=1.5),
    "relaxed uncull'd row": dict(two_phase=True, phase_a_steps=8, use_bb_skip=False, omega=1.5),
}


def _jax_rays(w=W, h=H):
    return generate_rays(look_at((5.0, 2.0, -5.0), fov=np.pi / 4), (w, h), (1920.0, 1080.0))


def _torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's planes and images at 256x64 (interpret mode)."""
    scene = jax_scene()
    csdf, bb = compile_scene_csdf(scene), scene_bounds(scene)
    o, d, c = _jax_rays()

    def planes(*args, **kwargs):
        return [np.asarray(x) for x in trace_pallas(csdf, o, d, c, *args, bb=bb, interpret=True,
                                                    **kwargs)]

    ref = {
        "trace": {case: planes(two_phase=case[0], tail_cap=case[1]) for case in TRACE_CASES},
        "relaxed": planes(omega=1.5),
        "relaxed two-phase": planes(two_phase=True, omega=1.5),
        "render": {name: np.asarray(render_image_pallas(csdf, o, d, c, bb=bb, interpret=True, **kw))
                   for name, kw in RENDER_CASES.items()},
        "options": {name: np.asarray(render_image_pallas(csdf, o, d, c, bb=bb, interpret=True, **kw))
                    for name, kw in OPTION_CASES.items()},
        "block, capped": np.asarray(render_image_pallas(
            csdf, o, d, c, bb=bb, two_phase="block", phase_a_steps=8, tail_cap=4, interpret=True)),
    }
    hit = sphere_trace_pallas(csdf, o, d, c, interpret=True)
    ref["sphere"] = [np.asarray(x) for x in (hit.depth, hit.steps, hit.outcome, hit.position)]
    depth, _, outcome = ref["trace"][(False, None)]
    r, g, b = _shade_call(csdf, o, d, jnp.asarray(depth), jnp.asarray(outcome), JaxMarchConfig(),
                          True)
    ref["shade"] = np.stack([np.asarray(x) for x in (r, g, b)], axis=-1)
    return ref


@pytest.fixture(scope="module")
def port():
    desc = compile_scene(reference_render_scene(device="cpu"))
    rays = _torch(*_jax_rays())
    return desc, rays, render_image_cuda(desc, *rays, return_planes=True)


def assert_trace_bars(ours, ref):
    depth, steps, outcome = (np.asarray(x) for x in ours)
    depth_ref, steps_ref, outcome_ref = ref[:3]
    same = outcome == outcome_ref
    assert same.mean() >= 0.999, f"outcomes differ on {(~same).sum()} rays"
    np.testing.assert_array_equal(steps[same], steps_ref[same])
    both = same & (outcome == COLLISION)
    assert both.sum() > 1000  # the frame shows the object and the wireframe
    assert np.abs(depth - depth_ref)[both].max() <= 1e-4
    assert steps.dtype == outcome.dtype == np.int32 and depth.dtype == np.float32


@pytest.mark.parametrize("two_phase,tail_cap", TRACE_CASES)
def test_trace_matches_trace_pallas(jax_ref, port, two_phase, tail_cap):
    """K2's twin, single-phase and row two-phase, against ``trace_pallas``
    with the JAX package's tail caps (tests/test_pallas.py:84-100)."""
    desc, rays, (_, *single) = port
    ours = trace_cuda(desc, *rays, two_phase=two_phase)
    assert_trace_bars(ours, jax_ref["trace"][(two_phase, tail_cap)])
    for a, b in zip(ours, single):
        assert torch.equal(a, b)


def test_sphere_trace_matches_sphere_trace_pallas(jax_ref, port):
    """The uncull'd march and its positions."""
    desc, rays, _ = port
    hit = sphere_trace_cuda(desc, *rays)
    depth, steps, outcome, position = jax_ref["sphere"]
    assert_trace_bars((hit.depth, hit.steps, hit.outcome), (depth, steps, outcome))
    both = (hit.outcome.numpy() == outcome) & (outcome == COLLISION)
    assert np.abs(hit.position.numpy() - position)[both].max() <= 1e-4
    assert torch.equal(hit.position, rays[0] + hit.depth[..., None] * rays[1])
    # without the cull, no ray gets the cull's depth
    assert not (hit.depth == np.float32(500.0 * 1.01)).any()


def test_relaxed_trace_matches_trace_pallas(jax_ref, port):
    """The over-relaxed march (omega 1.5) against the JAX package's, and,
    as tests/test_pallas.py:196-215 asks of it, close to the exact one."""
    desc, rays, (_, *exact) = port
    ours = trace_cuda(desc, *rays, omega=1.5)
    assert_trace_bars(ours, jax_ref["relaxed"])
    exact_outcome, relaxed_outcome = exact[2].numpy(), ours[2].numpy()
    assert (exact_outcome == relaxed_outcome).mean() > 0.995
    both = (exact_outcome == COLLISION) & (relaxed_outcome == COLLISION)
    np.testing.assert_allclose(ours[0].numpy()[both], exact[0].numpy()[both], atol=5e-3)
    # MarchConfig.relaxation routes into the march when omega is None
    config = trace_cuda(desc, *rays, MarchConfig(relaxation=1.5))
    for a, b in zip(config, ours):
        assert torch.equal(a, b)


def test_relaxed_two_phase_restarts_its_state(jax_ref, port):
    """The relaxed state (prev_r, step_len, omega) restarts at each launch,
    as in the JAX package: the row two-phase relaxed march is the JAX
    package's two-phase one, not its single relaxed march."""
    desc, rays, _ = port
    ours = trace_cuda(desc, *rays, omega=1.5, two_phase=True)
    assert_trace_bars(ours, jax_ref["relaxed two-phase"])
    single = trace_cuda(desc, *rays, omega=1.5)
    assert not all(torch.equal(a, b) for a, b in zip(ours, single))


def test_shade_matches_shade_call(jax_ref, port):
    """K3's twin on the JAX package's own depth and outcome planes."""
    desc, rays, _ = port
    depth, _, outcome = jax_ref["trace"][(False, None)]
    planes = _torch(depth, outcome)
    ours = shade_cuda(desc, rays[0], rays[1], *planes)
    assert ours.shape == (H, W, 3) and ours.dtype == torch.float32
    hit = outcome == COLLISION
    np.testing.assert_array_equal(ours.numpy()[~hit], jax_ref["shade"][~hit])
    np.testing.assert_allclose(ours.numpy()[hit], jax_ref["shade"][hit], atol=1e-4)
    # the gap is float32 rounding of the stencil: the same twin in float64
    wide = shade_planes_torch(desc, rays[0].double(), rays[1].double(), planes[0].double(),
                              planes[1])
    np.testing.assert_allclose(ours.numpy(), wide.numpy(), atol=1e-4)


@pytest.mark.parametrize("name", list(RENDER_CASES))
def test_render_paths_match_render_image_pallas(jax_ref, port, name):
    """Row two-phase and block retirement with an 8-step phase A, and the
    unfused K2 + K3 path: each against ``render_image_pallas`` with the same
    arguments, and equal to the port's single-phase render."""
    desc, rays, single = port
    ours = render_image_cuda(desc, *rays, return_planes=True, **RENDER_CASES[name])
    assert_image_bars(ours[0].numpy(), jax_ref["render"][name])
    for a, b in zip(ours, single):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", list(OPTION_CASES))
def test_render_options_match_render_image_pallas(jax_ref, port, name):
    """The uncull'd and the relaxed march through the single-phase, block
    and row paths, against ``render_image_pallas`` with the same
    arguments. Exact block retirement equals its single-phase render; a
    relaxed two-phase render restarts its relaxed state with its second
    launch, as the JAX package's does."""
    desc, rays, _ = port
    kw = OPTION_CASES[name]
    ours = render_image_cuda(desc, *rays, return_planes=True, **kw)
    assert_image_bars(ours[0].numpy(), jax_ref["options"][name])
    if "omega" not in kw:
        single = render_image_cuda(desc, *rays, return_planes=True, use_bb_skip=False)
        for a, b in zip(ours, single):
            assert torch.equal(a, b)
    if not kw.get("use_bb_skip", True):
        # without the cull, no ray gets the cull's depth
        assert not (ours[1] == np.float32(500.0 * 1.01)).any()


@pytest.mark.parametrize("phase_a_steps", [1, 8, 24])
def test_block_retirement_changes_no_pixel(jax_ref, port, phase_a_steps):
    """The retirement granule is K1's 16x8 block, not the JAX package's
    32x32 one, and no phase-A budget changes a pixel; the JAX package's run
    whose 4-block cap overflows into phase C gives the same image."""
    desc, rays, (rgb, *_) = port
    ours = render_image_cuda(desc, *rays, two_phase="block", phase_a_steps=phase_a_steps)
    assert torch.equal(ours, rgb)
    assert_image_bars(ours.numpy(), jax_ref["block, capped"])


def test_tail_lists_cover_the_unresolved_rays(port):
    """The row tail's ray list and block retirement's block list, built on
    the device with no host sync, hold exactly the unresolved rays and the
    16x8 blocks that hold one."""
    desc, rays, _ = port
    _, _, _, active = trace_planes_torch(desc, *rays, budget=8)
    flat = active.reshape(-1)
    assert 0 < int(flat.sum()) < flat.numel()
    index, count = compact_list(flat)
    assert count.shape == (1,) and count.dtype == torch.int32
    assert torch.equal(index[: int(count)].long(), flat.nonzero().squeeze(1))
    blocks = block_flags(active).numpy()
    expect = active.numpy().reshape(H // 8, 8, W // 16, 16).max(axis=(1, 3)).reshape(-1)
    np.testing.assert_array_equal(blocks, expect)
    # a frame that is not a whole number of blocks: the edge blocks take
    # the pixels they have
    padded = np.pad(active[:61, :250].numpy(), ((0, 3), (0, 6)))
    expect = padded.reshape(H // 8, 8, W // 16, 16).max(axis=(1, 3)).reshape(-1)
    np.testing.assert_array_equal(block_flags(active[:61, :250].contiguous()).numpy(), expect)


def test_resumed_march_matches_jax_march(port):
    """The resumable interface against the JAX package's ``_march`` on
    planes: a resumed ray takes its first iteration even at ``steps0 >=
    budget``, rays that are not active keep their outcome, and
    ``unresolved`` holds the rays stopped at the budget short of the step
    limit."""
    desc, rays, _ = port
    depth0, steps0, outcome0, active0 = trace_planes_torch(desc, *rays, budget=8, use_bb_skip=False)
    config = MarchConfig()
    flat = [x.reshape(-1) for x in (*(rays[0][..., a] for a in range(3)),
                                    *(rays[1][..., a] for a in range(3)), rays[2])]
    depth = depth0.reshape(-1).clone()
    steps, outcome, _, _, unresolved = _march(
        descriptor_csdf(desc), config, *flat, active0.reshape(-1) > 0, depth,
        torch.full_like(depth, config.depth_limit), steps0=steps0.reshape(-1),
        outcome0=outcome0.reshape(-1), budget=4,
    )
    csdf = compile_scene_csdf(jax_scene())
    p = [jnp.asarray(x.numpy().reshape(H, W)) for x in flat]
    ref = jax_march(csdf, JaxMarchConfig(), p[:3], p[3:6], p[6], jnp.asarray(active0.numpy() > 0),
                    jnp.asarray(depth0.numpy()), jnp.asarray(steps0.numpy()), 4,
                    outcome0=jnp.asarray(outcome0.numpy()))
    resumed = active0.reshape(-1) > 0
    np.testing.assert_array_equal(steps.numpy().reshape(H, W), np.asarray(ref[1]))
    np.testing.assert_array_equal(outcome.numpy().reshape(H, W), np.asarray(ref[2]))
    np.testing.assert_array_equal(unresolved.numpy().reshape(H, W), np.asarray(ref[3]))
    # one more step each, past the budget of 4 that their 8 steps exceed
    took = steps[resumed] - steps0.reshape(-1)[resumed]
    assert bool((took <= 1).all()) and bool((took == 1).any())
    assert torch.equal(outcome[~resumed], outcome0.reshape(-1)[~resumed])


def test_track_min_needs_exact_stepping():
    x = torch.zeros(4)
    with pytest.raises(NotImplementedError, match="exact stepping"):
        _march(lambda *p: p[0], MarchConfig(), x, x, x, x, x, x, x, x > -1, x.clone(),
               x + 1, track_min=True, omega=1.5)


def test_cpu_tensors_launch_no_kernel(port):
    desc, rays, _ = port
    before = (render_kernel.LAUNCHES, render_kernel.TRACE_LAUNCHES, render_kernel.SHADE_LAUNCHES)
    small = tuple(x[:8, :16].contiguous() for x in rays)
    render_image_cuda(desc, *small, two_phase=True)
    render_image_cuda(desc, *small, two_phase="block")
    depth, _, outcome = trace_cuda(desc, *small)
    shade_cuda(desc, small[0], small[1], depth, outcome)
    after = (render_kernel.LAUNCHES, render_kernel.TRACE_LAUNCHES, render_kernel.SHADE_LAUNCHES)
    assert after == before
    assert torch.equal(shade_cuda(desc, small[0], small[1], depth, outcome),
                       shade_planes_torch(desc, small[0], small[1], depth, outcome))


@pytest.mark.parametrize("case", ["two_phase", "block unswizzled", "depth dtype", "outcome shape"])
def test_wrappers_reject_bad_arguments(port, case):
    desc, rays, (_, depth, _, outcome) = port
    if case == "two_phase":
        with pytest.raises(ValueError, match="two_phase"):
            render_image_cuda(desc, *rays, two_phase="rows")
    elif case == "block unswizzled":
        with pytest.raises(ValueError, match="swizzled"):
            render_image_cuda(desc, *rays, two_phase="block", swizzle=False)
    elif case == "depth dtype":
        with pytest.raises(TypeError):
            shade_cuda(desc, rays[0], rays[1], depth.double(), outcome)
    else:
        with pytest.raises(ValueError):
            shade_cuda(desc, rays[0], rays[1], depth, outcome[:, :8].contiguous())
