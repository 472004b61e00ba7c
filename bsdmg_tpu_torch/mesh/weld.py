"""Vertex welding: quantize -> dedup -> index.

Port of the JAX package's ``bsdmg_tpu/mesh/weld.py`` (reference:
src/cuda/mod.rs:268-296 — quantize each coordinate with ``round(x * 1e5)
as i64``, dedup through a hash map in first-encounter order, and keep the
first-seen normal per welded vertex). By default the native C++ weld runs
(``runtime/native.py``); the NumPy path, a copy of the JAX package's, is
its twin (``use_native=False``). ``tests/test_torch_guards.py`` and
``tests/test_torch_native.py`` hold both equal to the JAX package's.
"""

from __future__ import annotations

import numpy as np

from bsdmg_tpu_torch.runtime.native import weld_vertices_native


def weld_vertices(positions: np.ndarray, normals: np.ndarray, quantization: float = 1e5, *,
                  use_native: bool = True):
    """Weld a triangle soup into an indexed mesh.

    Args:
      positions: ``(T, 3, 3)`` triangle vertex positions.
      normals: ``(T, 3, 3)`` matching vertex normals.
      quantization: coordinates are keyed by ``round(x * quantization)``.

    Returns:
      ``(vertices (V, 3), vertex_normals (V, 3), faces (T, 3) int32)`` with
      vertices in first-encounter order (matching the reference's hash-map
      insertion order, src/cuda/mod.rs:276-286).
    """
    positions = np.asarray(positions, np.float32).reshape(-1, 3)
    normals = np.asarray(normals, np.float32).reshape(-1, 3)
    if use_native:
        return weld_vertices_native(positions, normals, quantization)

    # half-AWAY-from-zero, matching the reference's Rust round()
    # (src/cuda/mod.rs:270): the double product narrowed to f32, then exact
    # half-away rounding of that f32 value emulated in f64
    scaled = (positions.astype(np.float64) * quantization).astype(np.float32)
    s64 = scaled.astype(np.float64)
    keys = (np.sign(s64) * np.floor(np.abs(s64) + 0.5)).astype(np.int64)
    # lexicographic unique with first-encounter order
    _, first_idx, inverse = np.unique(keys, axis=0, return_index=True, return_inverse=True)
    # np.unique returns sorted order; remap to first-encounter order
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    faces = rank[inverse.reshape(-1)].reshape(-1, 3).astype(np.int32)
    sources = first_idx[order]

    vertices = positions[sources]
    vertex_normals = normals[sources]
    return vertices, vertex_normals, faces
