"""Build and load the package's CUDA kernels.

``nvcc`` compiles each ``csrc/*.cu`` to an object, one process per source,
all started together, and links the objects into one shared library with a
plain C interface, which the kernel wrappers load with ``ctypes``. The build
runs at first use, in ``bsdmg_tpu_torch/_build/``, and again only when a
source or header is newer than the library. No header of PyTorch is
included, so a build takes seconds, not minutes.
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
    # sees a half-written library
    tag = f"{os.getpid()}.partial"
    objects = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
    partial = BUILD_DIR / f"{LIBRARY.name}.{tag}"
    try:
        reports = _run_all([compile_command(src, obj) for src, obj in zip(sources(), objects)])
        for src, report in zip(sources(), reports):
            (BUILD_DIR / f"{src.stem}.ptxas.txt").write_text(report)
        _run_all([link_command(objects, partial)])
        os.replace(partial, LIBRARY)
    finally:
        partial.unlink(missing_ok=True)
        for obj in objects:
            obj.unlink(missing_ok=True)
    return LIBRARY


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, then load the kernel library (once per process)."""
    return ctypes.CDLL(str(build()))
