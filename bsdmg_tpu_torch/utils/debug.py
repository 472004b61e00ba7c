"""Debug-mode checks: NaN trapping and checked SDF evaluation.

Port of ``bsdmg_tpu/utils/debug.py``. The reference's only sanitizer is a
compile-time ``-Xptxas -warn-double-usage`` (build.rs:116,120) and it has
no runtime asserts; two opt-in mechanisms stand in for them:

* :func:`debug_mode`: a context that turns on autograd's anomaly detection
  (a backward pass that produces NaN raises, naming the forward operation:
  the counterpart of ``jax_debug_nans``) and, with ``x64``, float64 as the
  default dtype (JAX's ``jax_enable_x64``); slow, debug only;
* :func:`checked_sdf`: wraps an SDF so each batched evaluation returns an
  error value beside its distances, which callers raise on the host with
  ``err.throw()``: catches NaN/Inf distances (un-normalised directions, bad
  params).
"""

from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch


@contextlib.contextmanager
def debug_mode(nan_checks: bool = True, x64: bool = False):
    """Enable heavyweight runtime checking within the context."""
    old_nan = torch.is_anomaly_enabled()
    old_dtype = torch.get_default_dtype()
    try:
        torch.set_anomaly_enabled(nan_checks)
        torch.set_default_dtype(torch.float64 if x64 else torch.float32)
        yield
    finally:
        torch.set_anomaly_enabled(old_nan)
        torch.set_default_dtype(old_dtype)


class CheckError:
    """The outcome of a checked evaluation: ``get()`` is the failure's
    message or None, ``throw()`` raises it (``FloatingPointError``); the
    counterpart of ``checkify``'s error value."""

    def __init__(self, failed: torch.Tensor, message: str):
        self._failed = failed
        self._message = message

    def get(self) -> str | None:
        return self._message if bool(self._failed) else None

    def throw(self) -> None:
        message = self.get()
        if message is not None:
            raise FloatingPointError(message)


def checked_sdf(sdf: Callable, name: str = "sdf") -> Callable:
    """Return ``f(p) -> (err, d)`` checking that every distance is finite;
    ``err.throw()`` raises on the host where one is not. The check stays on
    the device until ``err`` is read."""

    def checked(p):
        d = sdf(p)
        failed = ~torch.isfinite(d).all()
        return CheckError(failed, f"{name}: non-finite distance detected"), d

    return checked


def assert_finite(x, name: str = "array") -> None:
    """Host-side finite check for eager/test code paths."""
    arr = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if not np.all(np.isfinite(arr)):
        bad = int((~np.isfinite(arr)).sum())
        raise FloatingPointError(f"{name}: {bad} non-finite values")
