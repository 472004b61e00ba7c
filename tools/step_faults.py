#!/usr/bin/env python3
"""Plant a fault in the sharded steps' gradient in a copy of the tree and
show ``chip_smoke.step_bars`` fail, one copy per fault, on one CUDA card.

    python3 tools/step_faults.py            # from the repository root

``chip_smoke.parallel_phases`` holds ``train_step_fused`` (K5) and
``train_step`` (K4) on two gloo ranks sharing the card against the
unsharded step: the JAX package's bars on the loss and on the parameters
after one SGD step, and the all-reduced gradient within
``STEP_GRAD_REL`` of the unsharded gradient's norm. The sound tree and a
copy per fault below (in a temporary directory; the faults change Python
only, so the copies keep the sound tree's built kernels) each print both
steps' readings: ``jax_bars`` (the loss and parameter bars alone),
``grad_rel`` and ``ok``. Nothing in the checkout changes.
"""

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_SUM = "for name, g in unflatten_params(buf[1:], layout).items():"
FAULTS = {
    # the summed gradient off by a uniform factor on every rank, the loss right
    "halved": ("bsdmg_tpu_torch/parallel/sharding.py", _SUM,
               "for name, g in unflatten_params(buf[1:] * 0.5, layout).items():"),
    "zeroed": ("bsdmg_tpu_torch/parallel/sharding.py", _SUM,
               "for name, g in unflatten_params(buf[1:] * 0.0, layout).items():"),
}


def _rank(device) -> dict:
    """Both steps on this rank against the unsharded steps: their bars."""
    import chip_smoke as cs
    from bsdmg_tpu_torch.models import reference_render_scene
    from bsdmg_tpu_torch.parallel import make_mesh

    mesh = make_mesh(device=device, backend="gloo")
    scene = reference_render_scene(device=device)
    out = {}
    for name, fused, size in (("train_step_fused", True, cs.FUSED_STEP_SIZE),
                              ("train_step", False, cs.DIFF_STEP_SIZE)):
        bars = cs.step_bars(cs.sharded_step(scene, mesh, fused, size, device),
                            cs.unsharded_step(scene, fused, size, device))
        out[f"{name} {size}x{size}"] = bars
    return out


def bars(root: Path) -> None:
    """Build ``root``'s kernels and print both steps' bars on two ranks."""
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from bsdmg_tpu_torch.ops.cuda import build
    from bsdmg_tpu_torch.parallel.launch import spawn

    build.build()
    results = spawn(_rank, cs.PARALLEL_RANKS, backend="gloo", device="cuda:0",
                    timeout=cs.SPAWN_SECONDS)
    for rank, result in enumerate(results):
        print(f"rank {rank}: {json.dumps(result)}")


def main(argv: list[str]) -> int:
    if argv:
        bars(Path(argv[0]))
        return 0
    out = subprocess.run([sys.executable, str(ROOT / "tools" / "step_faults.py"), str(ROOT)],
                         capture_output=True, text=True, timeout=600)
    print(f"sound: {out.stdout.strip()} {out.stderr.strip()[-800:]}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for name, (path, old, new) in FAULTS.items():
            copy = Path(tmp) / name
            copy.mkdir()
            shutil.copy2(ROOT / "chip_smoke.py", copy)
            shutil.copytree(ROOT / "bsdmg_tpu_torch", copy / "bsdmg_tpu_torch",
                            ignore=shutil.ignore_patterns("__pycache__"))
            source = (copy / path).read_text()
            if source.count(old) != 1:
                raise RuntimeError(f"fault {name}: {old!r} is not in {path} once")
            (copy / path).write_text(source.replace(old, new))
            out = subprocess.run([sys.executable, str(ROOT / "tools" / "step_faults.py"), str(copy)],
                                 capture_output=True, text=True, timeout=600)
            print(f"fault {name}: {out.stdout.strip()[-3000:]} {out.stderr.strip()[-800:]}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
