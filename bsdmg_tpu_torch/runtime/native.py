"""ctypes bindings of the native host runtime: vertex welding, the OBJ
writer and the OBJ reader.

The port's copy of ``bsdmg_tpu/runtime/native.py``'s bindings, over
``csrc/host/bsdmg_native.cpp``, a byte-for-byte copy of the JAX package's
``native/bsdmg_native.cpp`` (the reference's Rust host runtime in C++:
welding src/cuda/mod.rs:268-296, OBJ export src/renderer/mod.rs:204).

g++ builds the library at first use into ``bsdmg_tpu_torch/_build/``, and
again when the source is newer than it, under a private name that is then
renamed into place, so processes that build at once (test workers) never
load a half-written library. ``-ffp-contract=off`` keeps the weld's keys
rounding as the NumPy twin's (``mesh/weld.py``) on every host. There is no
fallback: a failed build raises with g++'s output, and the NumPy and
Python twins run only when a caller asks for them (``use_native=False``).
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "csrc" / "host" / "bsdmg_native.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
LIBRARY = BUILD_DIR / "libbsdmg_native.so"

#: g++'s flags: no FMA contraction, so each product rounds as NumPy's does
FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")


def compiler() -> str:
    """``$CXX``, else ``g++``."""
    return os.environ.get("CXX", "g++")


def compile_command(output: Path) -> list[str]:
    return [compiler(), *FLAGS, "-o", str(output), str(SOURCE)]


def build() -> Path:
    """Compile the library unless it is newer than its source; returns its
    path. Raises with g++'s output on failure."""
    library = LIBRARY
    if library.exists() and SOURCE.stat().st_mtime < library.stat().st_mtime:
        return library
    if shutil.which(compiler()) is None:
        raise RuntimeError(
            f"C++ compiler {compiler()!r} not found; the native host runtime is built "
            f"from {SOURCE} at first use"
        )
    library.parent.mkdir(parents=True, exist_ok=True)
    partial = library.parent / f"{library.name}.{os.getpid()}.{threading.get_ident()}.partial"
    try:
        proc = subprocess.run(compile_command(partial), capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{' '.join(compile_command(partial))}\nexit code {proc.returncode}:\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(partial, library)
    finally:
        partial.unlink(missing_ok=True)
    return library


@functools.cache
def library() -> ctypes.CDLL:
    """Build if needed, load the library (once per process) and type its
    entry points."""
    lib = ctypes.CDLL(str(build()))
    f32p, i32p, i64 = (ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                       ctypes.c_int64)
    lib.bsdmg_weld.restype = i64
    lib.bsdmg_weld.argtypes = [f32p, f32p, i64, ctypes.c_double, f32p, f32p, i32p]
    lib.bsdmg_write_obj.restype = ctypes.c_int32
    lib.bsdmg_write_obj.argtypes = [ctypes.c_char_p, f32p, f32p, i64, i32p, i64]
    lib.bsdmg_obj_count.restype = ctypes.c_int32
    lib.bsdmg_obj_count.argtypes = [ctypes.c_char_p, *[ctypes.POINTER(i64)] * 3]
    lib.bsdmg_obj_read.restype = ctypes.c_int32
    lib.bsdmg_obj_read.argtypes = [ctypes.c_char_p, f32p, i64, f32p, i64, i32p, i64]
    return lib


def native_available() -> bool:
    """Whether the native library builds and loads here (g++ and the
    source present); the weld and the OBJ files need it unless the caller
    picks the NumPy/Python twins."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def weld_vertices_native(positions: np.ndarray, normals: np.ndarray, quantization: float = 1e5):
    """The native weld (``bsdmg_weld``), the contract of
    ``mesh.weld.weld_vertices``: ``(vertices (V, 3), vertex_normals (V, 3),
    faces (T, 3) int32)``, vertices in first-encounter order."""
    lib = library()
    positions = np.ascontiguousarray(positions, np.float32).reshape(-1, 3)
    normals = np.ascontiguousarray(normals, np.float32).reshape(-1, 3)
    n = positions.shape[0]
    out_v = np.empty((n, 3), np.float32)
    out_n = np.empty((n, 3), np.float32)
    out_idx = np.empty(n, np.int32)
    unique = lib.bsdmg_weld(_fptr(positions), _fptr(normals), n, quantization, _fptr(out_v),
                            _fptr(out_n), _iptr(out_idx))
    if unique < 0:
        raise RuntimeError(f"bsdmg_weld failed ({unique})")
    return out_v[:unique].copy(), out_n[:unique].copy(), out_idx.reshape(-1, 3)


def write_obj_native(path, vertices: np.ndarray, normals: np.ndarray, faces: np.ndarray) -> None:
    """Write an OBJ with the native buffered writer (``bsdmg_write_obj``):
    the Python writer's lines, but the header ``# bsdmg_tpu generated mesh
    (native writer)``. Raises ``OSError`` when the file cannot be written."""
    vertices = np.ascontiguousarray(vertices, np.float32)
    normals = np.ascontiguousarray(normals, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    rc = library().bsdmg_write_obj(str(path).encode(), _fptr(vertices), _fptr(normals),
                                   vertices.shape[0], _iptr(faces), faces.shape[0])
    if rc != 0:
        raise OSError(f"bsdmg_write_obj could not write {path} ({rc})")


def read_obj_native(path) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse an OBJ with the native reader (``bsdmg_obj_count`` then
    ``bsdmg_obj_read``): ``(vertices, normals, faces)`` float32, float32,
    int32, with ``v``/``vn``/``f`` rows, faces of any arity fan-triangulated,
    negative indices relative, the ``a``, ``a/b``, ``a//c`` and ``a/b/c``
    forms. Normals are zeros unless there is one per vertex (the Python
    reader's rule). Raises ``OSError`` when the file cannot be read."""
    lib = library()
    counts = [ctypes.c_int64() for _ in range(3)]
    name = str(path).encode()
    rc = lib.bsdmg_obj_count(name, *map(ctypes.byref, counts))
    if rc != 0:
        raise OSError(f"bsdmg_obj_count could not read {path} ({rc})")
    nv, nn, nf = (c.value for c in counts)
    vertices = np.empty((nv, 3), np.float32)
    normals = np.empty((max(nn, 1), 3), np.float32)
    faces = np.empty((nf, 3), np.int32)
    rc = lib.bsdmg_obj_read(name, _fptr(vertices), nv, _fptr(normals), nn, _iptr(faces), nf)
    if rc != 0:
        raise OSError(f"bsdmg_obj_read could not read {path} ({rc})")
    normals = normals[:nv] if nn == nv else np.zeros_like(vertices)
    return vertices, normals, faces
