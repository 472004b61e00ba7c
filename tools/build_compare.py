#!/usr/bin/env python3
"""Build the CUDA kernels of two checkouts one after the other, on a
machine with nvcc, and compare them.

    python3 tools/build_compare.py PARENT [CHANGE]

For each checkout (CHANGE defaults to this one) every ``csrc/*.cu`` is
compiled as ``bsdmg_tpu_torch/ops/cuda/build.py`` compiles it, one nvcc
process per source, all started together, and each source's seconds to
finish are printed (the build's wall time is the longest). Then ptxas's
registers, stack and spill bytes of every kernel the two have in common are
compared (names demangled by ``chip_smoke.demangled``): each kernel whose
resources differ is printed with both, then the count of those that match;
``--new`` also lists the kernels only CHANGE has. Run it from the root of
CHANGE, with PARENT unpacked beside it (``git archive``).
"""

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path


def build_kernels(root: Path) -> dict:
    """Compiles ``root``'s sources (objects into a directory of their own,
    ptxas's reports where ``build.build()`` keeps them): ``{"seconds":
    {source: s}, "kernels": {mangled name: resources}}``."""
    # this checkout's build.py, apart from any other's already imported
    spec = importlib.util.spec_from_file_location(
        f"build_of_{abs(hash(root))}", root / "bsdmg_tpu_torch" / "ops" / "cuda" / "build.py")
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    out_dir = root / "bsdmg_tpu_torch" / "_build" / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = sorted((root / "bsdmg_tpu_torch" / "csrc").glob("*.cu"))
    t0 = time.perf_counter()
    procs = [(src, subprocess.Popen(build.compile_command(src, out_dir / f"{src.stem}.o"),
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
             for src in sources]
    result = {"seconds": {}, "kernels": {}}
    for src, proc in procs:
        _, report = proc.communicate()
        result["seconds"][src.name] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{report[-3000:]}")
        # where build.build() keeps each source's report, which
        # build.kernel_resources parses
        (build.BUILD_DIR / f"{src.stem}.ptxas.txt").write_text(report)
        for k in build.kernel_resources(src.name):
            result["kernels"][k.pop("kernel")] = k
    return result


def main(argv: list[str]) -> int:
    args = [a for a in argv if not a.startswith("--")]
    if not 1 <= len(args) <= 2:
        print(__doc__, file=sys.stderr)
        return 2
    parent = Path(args[0]).resolve()
    change = Path(args[1] if len(args) > 1 else ".").resolve()
    builds = {}
    for label, root in (("parent", parent), ("change", change)):
        builds[label] = build_kernels(root)
        seconds = builds[label]["seconds"]
        print(f"{label} ({root}): {json.dumps({k: round(v, 1) for k, v in seconds.items()})}, "
              f"build {max(seconds.values()):.1f} s")

    sys.path.insert(0, str(change))
    import chip_smoke

    a, b = builds["parent"]["kernels"], builds["change"]["kernels"]
    names = chip_smoke.demangled(sorted(set(a) | set(b)))
    same = 0
    for k in sorted(set(a) & set(b), key=names.get):
        if a[k] == b[k]:
            same += 1
        else:
            print(f"differs: {names[k]}: parent {a[k]}, change {b[k]}")
    for k in sorted(set(a) - set(b), key=names.get):
        print(f"only in the parent: {names[k]}: {a[k]}")
    if "--new" in argv:
        for k in sorted(set(b) - set(a), key=names.get):
            print(f"only in the change: {names[k]}: {b[k]}")
    print(f"{same} of {len(set(a) & set(b))} common kernels with the parent's registers, stack "
          f"and spills; {len(set(b) - set(a))} kernels new")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
