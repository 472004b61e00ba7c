#!/usr/bin/env python3
"""Read the occupancy of the composed scenes' kernels of one checkout on one
CUDA card: how many blocks of each ``Composed`` and ``ComposedLarge``
instantiation of K1, K2, K3, K6 and K7 an SM holds at once.

    python3 tools/occupancy_probe.py CHECKOUT [--walk-bytes N]

Builds CHECKOUT's kernels (its own ``ops/cuda/build.py build``, which
keeps each source's object and ptxas report), takes the cubin of
``render_kernel.cu``, ``render_split.cu``, ``mc_kernel.cu`` and
``project_kernel.cu`` (``cuobjdump -xelf``), loads it through the CUDA
driver (``cuModuleLoad``) and reads, for each kernel, its registers and
local bytes a thread (``cuFuncGetAttribute``) and
``cuOccupancyMaxActiveBlocksPerMultiprocessor`` at the block size its
launch uses (128 threads; K6 256) and, for the small tier's, ``--walk-bytes``
of dynamic shared memory (default 0; a Composed launch stages its
program's forward walk there, a few hundred bytes). Prints one JSON line (``OCCUPANCY {...}``):
``{kernel: [registers, local bytes, blocks an SM, warps an SM]}``.

Run it for two checkouts in one call to compare their occupancy on one card.
"""

import ctypes
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

SOURCES = ("render_kernel.cu", "render_split.cu", "mc_kernel.cu", "project_kernel.cu")
PREFIXES = ("render_kernel<Composed", "trace_kernel<Composed", "shade_kernel<Composed",
            "mc_kernel<Composed", "project_kernel<Composed")
#: the block size of each kernel's launch (csrc/*.cu)
THREADS = {"mc_kernel<": 256}
#: CUfunction_attribute
LOCAL_SIZE_BYTES, NUM_REGS = 3, 4


def main(argv: list[str]) -> int:
    walk_bytes = 0
    if "--walk-bytes" in argv:
        k = argv.index("--walk-bytes")
        walk_bytes, argv = int(argv[k + 1]), argv[:k] + argv[k + 2:]
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    root = Path(argv[0]).resolve()
    here = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(here))
    import torch

    if not torch.cuda.is_available():
        print("occupancy_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    spec = importlib.util.spec_from_file_location(
        "checkout_build", root / "bsdmg_tpu_torch" / "ops" / "cuda" / "build.py")
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)

    torch.zeros(1, device="cuda")  # the primary context, current on this thread
    cuda = ctypes.CDLL("libcuda.so.1")

    def ok(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what}: CUresult {rc}")

    out = {"checkout": str(root), "card": cs.card_line(), "walk_bytes": walk_bytes}
    build.build()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        objects = [build.BUILD_DIR / f"{Path(s).stem}.o" for s in SOURCES]
        for s, obj in zip(SOURCES, objects):
            names = [k["kernel"] for k in build.kernel_resources(s)]
            short = cs.demangled(names)
            wanted = [n for n in names if short[n].startswith(PREFIXES)]
            if not wanted:
                continue
            cubins = tmp / obj.stem
            cubins.mkdir()
            subprocess.run([cs.toolkit_tool("cuobjdump"), "-xelf", "all", str(obj)], cwd=cubins,
                           check=True, capture_output=True, timeout=300)
            (cubin,) = sorted(cubins.glob("*.cubin"))
            module = ctypes.c_void_p()
            ok(cuda.cuModuleLoad(ctypes.byref(module), str(cubin).encode()), f"load {cubin}")
            for name in wanted:
                fn = ctypes.c_void_p()
                ok(cuda.cuModuleGetFunction(ctypes.byref(fn), module, name.encode()), name)
                regs, local, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
                ok(cuda.cuFuncGetAttribute(ctypes.byref(regs), NUM_REGS, fn), name)
                ok(cuda.cuFuncGetAttribute(ctypes.byref(local), LOCAL_SIZE_BYTES, fn), name)
                threads = next((t for p, t in THREADS.items() if short[name].startswith(p)), 128)
                small = "<Composed," in short[name] or "<Composed>" in short[name]
                smem = walk_bytes if small else 0
                ok(cuda.cuOccupancyMaxActiveBlocksPerMultiprocessor(
                    ctypes.byref(blocks), fn, threads, ctypes.c_size_t(smem)), name)
                out[short[name]] = [regs.value, local.value, blocks.value,
                                    blocks.value * threads // 32]
            cuda.cuModuleUnload(module)
    print("OCCUPANCY " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
