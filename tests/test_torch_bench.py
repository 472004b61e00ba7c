"""The port's bench verb (bsdmg_tpu_torch/bench.py, ``cli bench``) and its
profiling module (bsdmg_tpu_torch/utils/profiling.py).

On the CPU the bench times the kernels' plain twins: the tests check what
it reports and counts, never a speed. The step statistics are held against
the same reduction in numpy over the JAX package's ``trace_pallas`` steps
plane (interpret mode): the port's steps equal the JAX package's wherever
their outcomes do, and outcomes agree on >= 99.9% of rays
(tests/test_torch_render_kernel.py), so the statistics agree within 1e-3
relative.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bsdmg_tpu.cam import generate_rays, look_at
from bsdmg_tpu.models import reference_render_scene as jax_scene
from bsdmg_tpu.ops.pallas import compile_scene_csdf
from bsdmg_tpu.ops.pallas.csdf import scene_bounds
from bsdmg_tpu.ops.pallas.render_kernel import trace_pallas
from bsdmg_tpu_torch import bench, cli
from bsdmg_tpu_torch.models import reference_render_scene
from bsdmg_tpu_torch.ops.cuda import render_kernel
from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene
from bsdmg_tpu_torch.utils import profiling

# one intra-op thread: PyTorch's spinning OpenMP pool would otherwise take
# every core from the timing-sensitive tests that run beside these
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
#: the keys the JAX CLI's `bench --which render [--roofline]` prints
RENDER_KEYS = {"rays_per_s", "ms_per_frame"}
ROOFLINE_KEYS = {"mean_steps", "mean_tile_max_steps", "max_steps", "speed_of_light_ms",
                 "pct_of_roofline"}


def _tile_stats(steps: np.ndarray, tile) -> float:
    """Mean over ``tile``-sized blocks of their maximum, a block at the
    edge taking the pixels it has."""
    h, w = steps.shape
    th, tw = tile
    maxima = [steps[y:y + th, x:x + tw].max() for y in range(0, h, th) for x in range(0, w, tw)]
    return float(np.mean(maxima))


@pytest.mark.parametrize("size", [(256, 64), (200, 52)])
def test_render_step_stats_match_trace_pallas(size):
    w, h = size
    scene = jax_scene()
    o, d, c = generate_rays(look_at((5.0, 2.0, -5.0), fov=np.pi / 4), (w, h), (1920.0, 1080.0))
    _, steps, _ = trace_pallas(compile_scene_csdf(scene), o, d, c, bb=scene_bounds(scene),
                               interpret=True)
    s = np.asarray(steps, np.float64)
    ours = bench.render_step_stats(w, h, device="cpu")
    want = {
        "mean_steps": s.mean(),
        "mean_tile_max_steps": _tile_stats(s, (8, 128)),
        "max_steps": s.max(),
        "mean_warp_max_steps": _tile_stats(s, (4, 8)),
    }
    for key, value in want.items():
        np.testing.assert_allclose(ours[key], value, rtol=1e-3, err_msg=key)
    if w % 128 == 0 and h % 8 == 0:
        # whole tiles: the JAX package's own formula (bsdmg_tpu/bench.py:264-266)
        tiles = s.reshape(h // 8, 8, w // 128, 128).max(axis=(1, 3))
        np.testing.assert_allclose(ours["mean_tile_max_steps"], tiles.mean(), rtol=1e-3)
    # a warp's patch holds fewer rays than a tile, so its maximum is lower
    assert ours["mean_steps"] <= ours["mean_warp_max_steps"] <= ours["mean_tile_max_steps"]
    assert ours["hits"] > 0


#: ``cli bench --device cpu --which render`` at 64x32: plain, row two-phase
#: with the roofline, block retirement
BENCH_RUNS = {
    "plain": [],
    "row": ["--two-phase", "row", "--roofline"],
    "block": ["--two-phase", "block"],
}


@pytest.mark.parametrize("name", list(BENCH_RUNS))
def test_cli_bench_render_prints_jax_keys(name, capsys):
    """Each run prints the JAX CLI's keys; on CPU tensors it launches no
    kernel (the twins run)."""
    before = (render_kernel.LAUNCHES, render_kernel.TRACE_LAUNCHES, render_kernel.SHADE_LAUNCHES)
    argv = ["bench", "--device", "cpu", "--which", "render", "--width", "64", "--height", "32",
            *BENCH_RUNS[name]]
    assert cli.main(argv) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out["render"]) == RENDER_KEYS
    assert out["render"]["rays_per_s"] > 0 and out["render"]["ms_per_frame"] > 0
    assert out["device"] == "cpu"
    if name == "row":
        assert ROOFLINE_KEYS <= set(out["roofline"])
        assert "mean_warp_max_steps" in out["roofline"]
        assert out["roofline"]["speed_of_light_ms"] > 0
        # a CPU time is no share of the card's speed of light
        assert out["roofline"]["pct_of_roofline"] is None
    else:
        assert "roofline" not in out
    after = (render_kernel.LAUNCHES, render_kernel.TRACE_LAUNCHES, render_kernel.SHADE_LAUNCHES)
    assert after == before


def test_cli_bench_without_cuda_raises():
    """The default device is cuda; the bench never moves to the CPU itself."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["bench", "--which", "render", "--width", "16", "--height", "8"])


def test_cli_bench_flags_are_the_jax_clis():
    """``--which``, sizes, ``--roofline``, ``--two-phase``, ``--unroll`` and
    ``--trace`` with the JAX CLI's defaults; left out: the multi-device
    choices and ``--phase-a-rows``."""
    from bsdmg_tpu.cli import build_parser as jax_parser

    def bench_actions(parser):
        sub = next(a for a in parser._actions if a.dest == "command")
        return {a.dest: a for a in sub.choices["bench"]._actions}

    ours, ref = bench_actions(cli.build_parser()), bench_actions(jax_parser())
    assert set(ref) - set(ours) == {"phase_a_rows"}
    assert set(ours) - set(ref) == {"device"}
    for dest in ("width", "height", "roofline", "two_phase", "unroll", "trace"):
        assert ours[dest].default == ref[dest].default, dest
        assert ours[dest].choices == ref[dest].choices, dest
    assert set(ref["which"].choices) - set(ours["which"].choices) == {"scaling", "scaling-proxy"}
    assert ours["device"].default == "cuda"


def test_slope_time_recovers_the_per_call_time(monkeypatch):
    """Theil-Sen over k calls removes a fixed cost per timed call: on a
    clock that the work advances by 7 + 3 k, the slope is 3."""
    clock = [0.0]
    monkeypatch.setattr(bench.time, "perf_counter", lambda: clock[0])

    def many(k):
        clock[0] += 7.0 + 3.0 * k
        return 0.0

    assert bench._slope_time(many, k1=2, k2=8) == pytest.approx(3.0)


def test_roofline_and_bounds():
    roof = profiling.Roofline(ops=67e9, nbytes=3.35e9)
    assert roof.compute_seconds == pytest.approx(1e-3)
    assert roof.memory_seconds == pytest.approx(1e-3)
    assert profiling.bound(6.7e9, 67e9) == (pytest.approx(2.0), "bytes")
    assert profiling.bound(0, 67e9) == (pytest.approx(1.0), "operations")
    desc = compile_scene(reference_render_scene())
    sdf = profiling.sdf_ops(desc)
    # K1's count, as chip_smoke.py has always printed it
    evals, advances, hits, pixels = 1000, 900, 30, 100
    assert profiling.render_ops(desc, evals, advances, hits, pixels) == (
        evals * (sdf + 9) + advances * 3 + hits * (6 + 1 + 12 * (sdf + 1) + 15 + 7 + 10 + 6)
        + pixels * 124)
    render = profiling.render_roofline(desc, 64, 32, avg_steps=10.0, hits=30)
    assert render.nbytes == 64 * 32 * 40
    assert render.ops == profiling.render_ops(desc, 64 * 32 * 10, 64 * 32 * 10, 30, 64 * 32)
    grad = profiling.grad_roofline(64, 32, avg_steps=10.0, hits=30)
    assert grad.ops > render.ops and grad.nbytes == 64 * 32 * 40


def test_kernel_byte_counts():
    """The bytes each render kernel must move: K1 and K2 read a ray (28 B)
    and write RGB or planes (12 B), phase A also ``active``; K3 reads an
    outcome per pixel and, only at a hit, its depth and ray; a listed tail
    ray reads its index, ray and state and writes its planes."""
    assert profiling.render_bytes(100) == 100 * 40
    assert profiling.trace_bytes(100) == 100 * 40
    assert profiling.trace_bytes(100, active=True) == 100 * 44
    assert profiling.shade_bytes(100, 30) == 100 * 16 + 30 * 28
    desc = compile_scene(reference_render_scene())
    zeros = torch.zeros(2, 2, dtype=torch.int32)
    carried = (torch.zeros(2, 2), zeros, zeros + 1, torch.tensor([[1, 0], [1, 0]], dtype=torch.int32))
    # the two listed rays take 5 and 7 more steps: one hits, one passes the depth limit
    final = (torch.zeros(2, 2), torch.tensor([[5, 0], [7, 0]], dtype=torch.int32),
             torch.tensor([[0, 1], [2, 1]], dtype=torch.int32))
    ops, nbytes = profiling.resumed_work(desc, carried, final, 2)
    assert nbytes == 2 * 60
    assert ops == profiling.march_ops(desc, 12 + 2, 12 + 1, 2)


def test_chip_smoke_counts_with_the_profiling_module():
    """One count for the smoke run and the bench: chip_smoke.py imports the
    counters and defines none of them."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    imported = {a.name for node in tree.body if isinstance(node, ast.ImportFrom)
                and node.module == "bsdmg_tpu_torch.utils.profiling" for a in node.names}
    assert {"bound", "render_ops", "march_ops", "march_work", "k4_ops", "k5_ops", "render_bytes",
            "trace_bytes", "shade_bytes", "resumed_work"} <= imported
    defined = {node.name for node in tree.body if isinstance(node, ast.FunctionDef)}
    defined |= {t.id for node in tree.body if isinstance(node, ast.Assign) for t in node.targets
                if isinstance(t, ast.Name)}
    counters = {n for n in vars(profiling) if not n.startswith("_")}
    assert not (defined & counters), defined & counters


def test_profiling_trace_writes_a_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert "Name" in (tmp_path / "trace" / "kernels.txt").read_text()
