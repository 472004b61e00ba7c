"""A baked grid's box as the CUDA kernels take it: ``GridBox`` of
``csrc/grid_sdf.cuh`` (the corners, the scale and the clamp in float32, as
``models/mesh_sdf.py::box_f32`` computes them) and the largest grid they
index. The grid samplers (``grid_kernel.py``), the grid scene structures of
K6 and K7 (``render_kernel.py``) and the bake (``bake_kernel.py``) share it.
"""

from __future__ import annotations

import ctypes

from bsdmg_tpu_torch.models.mesh_sdf import box_f32

#: the largest grid whose R^3 nodes a 32-bit index reaches: the grid
#: structures' (csrc/grid_sdf.cuh) and the bake's (csrc/bake_kernel.cu)
MAX_GRID_RESOLUTION = 1290


def _floats(n):
    return ctypes.c_float * n


class GridBoxC(ctypes.Structure):
    """``GridBox`` of csrc/grid_sdf.cuh."""

    _fields_ = [
        ("lo", _floats(3)),
        ("hi", _floats(3)),
        ("scale", _floats(3)),
        ("clip_hi", ctypes.c_float),
        ("r", ctypes.c_int),
    ]


def grid_box_c(r: int, lo, hi) -> GridBoxC:
    """The ``GridBox`` of an ``r``^3 table over ``[lo, hi]`` (``box_f32``)."""
    lo, hi, scale, clip_hi = box_f32(r, lo, hi)
    return GridBoxC(_floats(3)(*lo), _floats(3)(*hi), _floats(3)(*scale), clip_hi, r)
