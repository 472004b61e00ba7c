"""Utilities of the port: ``profiling`` (torch.profiler traces, FP32
operation counts of the kernels, speed-of-light estimates on an H100),
``timing``, ``logging``, ``containers`` and ``debug``."""

from bsdmg_tpu_torch.utils.containers import BitSet, BoundedArray, vec_maximum, vec_minimum
from bsdmg_tpu_torch.utils.debug import assert_finite, checked_sdf, debug_mode
from bsdmg_tpu_torch.utils.logging import get_logger
from bsdmg_tpu_torch.utils.timing import Timer, block_and_time

__all__ = [
    "Timer",
    "block_and_time",
    "get_logger",
    "BitSet",
    "BoundedArray",
    "vec_maximum",
    "vec_minimum",
    "assert_finite",
    "checked_sdf",
    "debug_mode",
]
