#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bsdmg_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper card, nvcc
and PyTorch built for CUDA. Phases, each reported on its own line:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build kernel K1 from bsdmg_tpu_torch/csrc with nvcc;
3. the main path: ``cli render -o <tmp>.png`` at the default 1920x1080,
   which must launch K1;
4. K1 against its plain PyTorch version at 1920x1080 (outcome, steps, depth
   and image bars), and at 256x144 against the committed golden render;
5. K1 and plain times from CUDA events (median of 7 runs after warm-up) at
   1920x1080 and 2560x1440.

Then one JSON line describing each kernel, the card's line, and as the last
line ``{"ok": true, "device": {...}}``. Any failed phase raises and the
script exits non-zero; without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "render_256x144.npz"
SCREEN = (1920.0, 1080.0)
# bars of tests/test_torch_render_kernel.py and tests/test_pallas.py:117-119
OUTCOME_AGREEMENT = 0.999
DEPTH_ATOL = 1e-4
PIXEL_ATOL = 2e-2
PIXEL_SHARE = 0.999
MEAN_ATOL = 1e-4
# golden bars of tests/test_render.py:178-181
GOLDEN_SHARE = 0.995
GOLDEN_MEAN = 1e-3


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def rays(width: int, height: int, device):
    from bsdmg_tpu_torch.cam import generate_rays, look_at

    cam = look_at((5.0, 2.0, -5.0), fov=np.pi / 4, device=device)
    return generate_rays(cam, (width, height), SCREEN)


def compare(kernel, plain) -> dict:
    """Agreement of K1's ``(rgb, depth, steps, outcome)`` with the plain
    version's, checked against the bars."""
    rgb_k, depth_k, steps_k, out_k = kernel
    rgb_p, depth_p, steps_p, out_p = plain
    same = out_k == out_p
    both_hit = same & (out_k == 0)
    diff = (rgb_k - rgb_p).abs().amax(dim=-1)
    stats = {
        "outcome_agreement": same.float().mean().item(),
        "steps_mismatch": int((same & (steps_k != steps_p)).sum().item()),
        "depth_max_err": (depth_k - depth_p).abs()[both_hit].max().item() if both_hit.any() else 0.0,
        "pixel_share": (diff < PIXEL_ATOL).float().mean().item(),
        "mean_err": diff.mean().item(),
        "max_abs_err": diff.max().item(),
        "exact": bool(torch.equal(rgb_k, rgb_p) and torch.equal(depth_k, depth_p)
                      and torch.equal(steps_k, steps_p) and torch.equal(out_k, out_p)),
    }
    check(stats["outcome_agreement"] >= OUTCOME_AGREEMENT, f"outcome agreement {stats}")
    check(stats["steps_mismatch"] == 0, f"steps differ where outcomes agree {stats}")
    check(stats["depth_max_err"] <= DEPTH_ATOL, f"collision depth {stats}")
    check(stats["pixel_share"] >= PIXEL_SHARE, f"pixel share {stats}")
    check(stats["mean_err"] < MEAN_ATOL, f"mean image error {stats}")
    # built with -fmad=false, K1 runs the plain version's float32 operations
    # in the same order: anything but bit equality is a regression
    check(stats["exact"], f"K1 and its plain version are not bit-equal {stats}")
    return stats


def median_ms(fn, runs: int = 7, reps: int = 1, warmup: int = 2) -> float:
    """Median over ``runs`` of the CUDA-event time of ``reps`` calls of
    ``fn``, per call, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2

    from bsdmg_tpu_torch import cli
    from bsdmg_tpu_torch.models import reference_render_scene
    from bsdmg_tpu_torch.ops.cuda import build, render_kernel
    from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene
    from bsdmg_tpu_torch.ops.cuda.render_kernel import (
        render_image_cuda,
        render_image_planes_torch,
    )

    device = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    library = build.build()
    print(f"build: {library.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")

    # phase 3: the main path, as a user runs it
    with tempfile.TemporaryDirectory() as tmp:
        png = Path(tmp) / "render.png"
        render_kernel.LAUNCHES = 0
        t0 = time.perf_counter()
        cli.main(["render", "-o", str(png)])
        seconds = time.perf_counter() - t0
        launches = render_kernel.LAUNCHES
        check(launches > 0, "cli render did not launch K1")
        check(png.is_file() and png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", "no PNG written")
        print(f"main path: cli render 1920x1080 -> {png.stat().st_size} B PNG in {seconds:.2f} s, "
              f"K1 launches {launches}")

    # phase 4: K1 against its plain version
    desc = compile_scene(reference_render_scene(device=device))
    o, d, c = rays(1920, 1080, device)
    kernel = render_image_cuda(desc, o, d, c, return_planes=True)
    plain = render_image_planes_torch(desc, o, d, c)
    torch.cuda.synchronize()
    stats = compare(kernel, plain)
    counts = torch.bincount(kernel[3].reshape(-1), minlength=3).tolist()
    print(f"parity 1920x1080: {json.dumps(stats)} outcomes(collision, step, depth)={counts}")

    golden = torch.from_numpy(np.load(GOLDEN)["image"]).to(device)
    img = render_image_cuda(desc, *rays(256, 144, device))
    diff = (img - golden).abs().amax(dim=-1)
    share, mean = (diff < PIXEL_ATOL).float().mean().item(), diff.mean().item()
    check(bool(torch.isfinite(img).all()) and img.shape == (144, 256, 3), "256x144 image")
    check(share > GOLDEN_SHARE and mean < GOLDEN_MEAN, f"golden: share {share} mean {mean}")
    print(f"golden 256x144: share under {PIXEL_ATOL} = {share:.6f}, mean {mean:.3e}")

    # phase 5: times
    timings = {}
    for w, h in ((1920, 1080), (2560, 1440)):
        o, d, c = rays(w, h, device)
        k_ms = median_ms(lambda: render_image_cuda(desc, o, d, c), reps=5)
        p_ms = median_ms(lambda: render_image_planes_torch(desc, o, d, c), warmup=1)
        timings[(w, h)] = (k_ms, p_ms)
        n = w * h
        print(f"time {w}x{h} on {card}: K1 {k_ms:.3f} ms ({n / k_ms * 1e3:.4g} rays/s), "
              f"plain {p_ms:.3f} ms ({n / p_ms * 1e3:.4g} rays/s)")

    k_ms, p_ms = timings[(1920, 1080)]
    print(json.dumps({"kernels": [{
        "name": "K1 render_kernel (fused trace+shade)",
        "route": "cuda",
        "source": render_kernel.SOURCE,
        "replaces": "bsdmg_tpu/ops/pallas/render_kernel.py:336",
        "launches": launches,
        "max_abs_err": stats["max_abs_err"],
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
