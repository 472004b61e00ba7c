"""Build and load the package's CUDA kernels.

``nvcc`` compiles each ``csrc/*.cu`` to an object, one process per source,
all started together, and links the objects into one shared library with a
plain C interface, which the kernel wrappers load with ``ctypes``. The build
runs at first use, in ``bsdmg_tpu_torch/_build/``, and again only when a
source or header is newer than the library; then only the sources that
include a changed file (``#include "..."``, followed through the headers)
are compiled again, the others' objects kept from the last build. No header
of PyTorch is included, so a build takes seconds, not minutes.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIBRARY = BUILD_DIR / "libbsdmg_kernels.so"

#: Hopper only: the ``a`` keeps sm_90a-only instructions available
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

#: No FMA contraction: every ``a*b + c`` rounds twice, as the plain PyTorch
#: versions do. Measured on an H100 (700 W) at 1920x1080: K1 then equals its
#: plain version bit for bit and takes 0.61 ms; contracted, it took 0.55 ms
#: and 38 rays ended with another step count.
NUMERIC_FLAGS = ("-fmad=false",)


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _dependencies() -> list[Path]:
    return sources() + sorted(CSRC_DIR.glob("*.cuh"))


def includes(path: Path, seen: set | None = None) -> set:
    """``path`` and every file of ``csrc/`` it includes, directly or through
    another (``#include "name"``)."""
    seen = set() if seen is None else seen
    seen.add(path)
    for line in path.read_text().splitlines():
        words = line.split()
        if len(words) >= 2 and words[0] == "#include" and words[1].startswith('"'):
            dep = CSRC_DIR / words[1].strip('"')
            if dep.exists() and dep not in seen:
                includes(dep, seen)
    return seen


def _object(source: Path) -> Path:
    return BUILD_DIR / f"{source.stem}.o"


def _stale(source: Path) -> bool:
    """Whether ``source``'s kept object is missing or older than a file it
    includes."""
    obj = _object(source)
    if not obj.exists():
        return True
    built = obj.stat().st_mtime
    return any(dep.stat().st_mtime >= built for dep in includes(source))


def nvcc_path() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


def compile_command(source: Path, output: Path) -> list[str]:
    """nvcc command that compiles one source to a position-independent
    object; ptxas reports each kernel's registers, stack and spills."""
    return [
        nvcc_path(), *ARCH_FLAGS, *NUMERIC_FLAGS, "-std=c++17", "-O3", "-c",
        "-Xptxas", "-v", "-Xcompiler", "-fPIC", "-o", str(output), str(source),
    ]


def resource_report(source_name: str) -> str:
    """ptxas's report (registers, stack, spill bytes per kernel) from the
    last build of ``csrc/<source_name>``."""
    return (BUILD_DIR / f"{Path(source_name).stem}.ptxas.txt").read_text()


def kernel_resources(source_name: str) -> list[dict]:
    """Each kernel of ``csrc/<source_name>`` in the last build's ptxas
    report: ``{"kernel": mangled name, "registers", "stack", "spill_stores",
    "spill_loads"}`` (bytes per thread)."""
    kernels: list[dict] = []
    for line in resource_report(source_name).splitlines():
        if "Compiling entry function" in line:
            kernels.append({"kernel": line.split("'")[1]})
        elif "bytes stack frame" in line and kernels:
            words = line.replace(",", "").split()
            kernels[-1].update(stack=int(words[0]), spill_stores=int(words[4]),
                               spill_loads=int(words[8]))
        elif "Used " in line and kernels:
            kernels[-1]["registers"] = int(line.split("Used ")[1].split()[0])
    return kernels


def link_command(objects: list[Path], output: Path) -> list[str]:
    return [nvcc_path(), *ARCH_FLAGS, "-shared", "-o", str(output), *map(str, objects)]


def _run_all(commands: list[list[str]]) -> list[str]:
    """Run the commands in parallel; return their stderr, or raise with each
    failure's."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for cmd in commands
    ]
    failures, outputs = [], []
    for cmd, proc in zip(commands, procs):
        _, err = proc.communicate()
        outputs.append(err)
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\nexit code {proc.returncode}:\n{err}")
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return outputs


def build() -> Path:
    """Compile the kernels unless the library is newer than every source;
    returns the library's path. Raises with nvcc's stderr on failure."""
    if LIBRARY.exists():
        built = LIBRARY.stat().st_mtime
        if all(dep.stat().st_mtime < built for dep in _dependencies()):
            return LIBRARY
    nvcc = nvcc_path()
    if not Path(nvcc).exists():
        raise RuntimeError(
            f"nvcc not found (looked on PATH and at {nvcc}); the CUDA kernels "
            "are built from bsdmg_tpu_torch/csrc at first use and need the "
            "CUDA toolkit"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under private names, then rename: a concurrent loader never
    # sees a half-written library or object
    tag = f"{os.getpid()}.partial"
    stale = [src for src in sources() if _stale(src)]
    fresh = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in stale]
    partial = BUILD_DIR / f"{LIBRARY.name}.{tag}"
    try:
        reports = _run_all([compile_command(src, obj) for src, obj in zip(stale, fresh)])
        for src, obj, report in zip(stale, fresh, reports):
            (BUILD_DIR / f"{src.stem}.ptxas.txt").write_text(report)
            os.replace(obj, _object(src))
        _run_all([link_command([_object(src) for src in sources()], partial)])
        os.replace(partial, LIBRARY)
    finally:
        partial.unlink(missing_ok=True)
        for obj in fresh:
            obj.unlink(missing_ok=True)
    return LIBRARY


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, then load the kernel library (once per process)."""
    return ctypes.CDLL(str(build()))
