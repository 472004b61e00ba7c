"""Timing helpers for benchmarks and phase metrics.

Port of ``bsdmg_tpu/utils/timing.py``: host wall time around the points
where the device has finished, with ``torch.profiler`` traces beside it
(``utils/profiling.py``). PyTorch returns before the card finishes, so
:func:`block_and_time` synchronises each CUDA device its result lies on
before it reads the clock, as the JAX package blocks on its result.
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch


@dataclass
class Timer:
    """Accumulates named phase durations (seconds)."""

    phases: dict = field(default_factory=dict)

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        return "; ".join(f"{k}={v * 1e3:.2f}ms" for k, v in self.phases.items())


def _cuda_devices(result, found: set) -> set:
    """The CUDA devices of every tensor in ``result`` (tensors, sequences,
    dicts and dataclasses of them)."""
    if isinstance(result, torch.Tensor):
        if result.device.type == "cuda":
            found.add(result.device)
    elif isinstance(result, (list, tuple)):
        for item in result:
            _cuda_devices(item, found)
    elif isinstance(result, dict):
        for item in result.values():
            _cuda_devices(item, found)
    elif dataclasses.is_dataclass(result) and not isinstance(result, type):
        for f in dataclasses.fields(result):
            _cuda_devices(getattr(result, f.name), found)
    return found


def _block(result):
    """``result``, once every CUDA device it lies on has finished."""
    for device in _cuda_devices(result, set()):
        torch.cuda.synchronize(device)
    return result


def block_and_time(fn, *args, iters: int = 1, warmup: int = 1, **kwargs):
    """Run ``fn`` with device-synchronised timing; returns ``(result,
    best_seconds)``. The devices are synchronised at the measurement's
    boundaries only: the work inside a call stays asynchronous."""
    result = None
    for _ in range(max(warmup, 0)):
        result = _block(fn(*args, **kwargs))
    best = float("inf")
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        result = _block(fn(*args, **kwargs))
        best = min(best, time.perf_counter() - t0)
    return result, best
