"""Scene animation: the reference's motion components as pure functions.

Port of ``bsdmg_tpu/models/motion.py`` (the reference's Bevy motion system,
src/example_scene.rs:63-160): three motion components,
:class:`RotateAxisMotion`, :class:`SphericCyclicMotion` and
:class:`AxisCyclicMotion`, and :func:`apply_motion`, which advances a
transform to time ``t``, gated as the reference's :class:`SceneSettings`
gates it; :func:`motion_params` writes the advanced transform into a
scene's ``object_center``/``object_rotation`` params.
Every value is a float32 tensor on the device the caller names (the card
unless it names another), computed in the JAX package's operation order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

TWO_PI = 2.0 * math.pi


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class Transform:
    """Translation + quaternion rotation (w, x, y, z)."""

    translation: torch.Tensor
    rotation: torch.Tensor

    @staticmethod
    def identity(device: torch.device | str = "cuda") -> "Transform":
        return Transform(torch.zeros(3, dtype=torch.float32, device=device),
                         _f32([1.0, 0.0, 0.0, 0.0], device))

    @staticmethod
    def from_translation(v, device: torch.device | str = "cuda") -> "Transform":
        return Transform(_f32(v, device), _f32([1.0, 0.0, 0.0, 0.0], device))


def quat_from_axis_angle(axis, angle, device: torch.device | str = "cuda") -> torch.Tensor:
    """The unit quaternion (w, x, y, z) of a rotation by ``angle`` about
    ``axis`` (normalised, its norm floored at 1e-12)."""
    axis = _f32(axis, device)
    axis = axis / torch.clamp_min(torch.linalg.norm(axis), 1e-12)
    half = _f32(angle, device) * 0.5
    return torch.cat([torch.cos(half)[None], torch.sin(half) * axis])


@dataclasses.dataclass(frozen=True)
class RotateAxisMotion:
    """Continuous rotation about ``axis``, one turn per ``cycle_duration``
    (src/example_scene.rs:63-67, rotation arm :145-150)."""

    axis: Sequence[float] = (0.0, 1.0, 0.0)
    cycle_duration: float = 5.0

    def rotation_at(self, t, device: torch.device | str = "cuda") -> torch.Tensor:
        angle = TWO_PI * (_f32(t, device) / _f32(self.cycle_duration, device))
        return quat_from_axis_angle(self.axis, angle, device)


@dataclasses.dataclass(frozen=True)
class SphericCyclicMotion:
    """Per-axis sinusoidal offsets with independent periods
    (src/example_scene.rs:69-84, arm :136-141)."""

    center: Optional[Sequence[float]] = None  # None: captured by set_center
    distances: Sequence[float] = (1.0, 1.0, 1.0)
    cycle_durations: Sequence[float] = (5.0, 5.0, 5.0)

    def translation_at(self, t, device: torch.device | str = "cuda") -> torch.Tensor:
        c = torch.zeros(3, dtype=torch.float32, device=device) if self.center is None else \
            _f32(self.center, device)
        d = TWO_PI * _f32(t, device) / _f32(self.cycle_durations, device)
        return c + _f32(self.distances, device) * torch.sin(d)


@dataclasses.dataclass(frozen=True)
class AxisCyclicMotion:
    """Sinusoidal oscillation along ``direction``
    (src/example_scene.rs:86-101, arm :129-135)."""

    center: Optional[Sequence[float]] = None
    direction: Sequence[float] = (0.0, 1.0, 0.0)
    cycle_duration: float = 5.0

    def translation_at(self, t, device: torch.device | str = "cuda") -> torch.Tensor:
        c = torch.zeros(3, dtype=torch.float32, device=device) if self.center is None else \
            _f32(self.center, device)
        phase = TWO_PI * _f32(t, device) / _f32(self.cycle_duration, device)
        return c + _f32(self.direction, device) * torch.sin(phase)


def set_center(motion, transform: Transform):
    """Fill a cyclic motion's ``center`` from the entity's initial transform
    if unset: the reference's ``Added<...>`` startup system
    (src/example_scene.rs:103-118)."""
    if isinstance(motion, (SphericCyclicMotion, AxisCyclicMotion)):
        if motion.center is None:
            return dataclasses.replace(
                motion, center=tuple(float(v) for v in transform.translation.tolist())
            )
    return motion


def apply_motion(
    transform: Transform,
    t,
    *,
    axis_cyclic: Optional[AxisCyclicMotion] = None,
    spheric_cyclic: Optional[SphericCyclicMotion] = None,
    rotate_axis: Optional[RotateAxisMotion] = None,
    enable_movement: bool = True,
) -> Transform:
    """Advance one entity's transform to time ``t``, on the transform's
    device, with the reference's precedence (src/example_scene.rs:120-154):
    axis-cyclic wins over spheric-cyclic for the translation; the rotation
    composes independently; ``enable_movement`` gates everything
    (src/example_scene.rs:156-160)."""
    if not enable_movement:
        return transform
    device = transform.translation.device
    translation = transform.translation
    rotation = transform.rotation
    if axis_cyclic is not None:
        translation = axis_cyclic.translation_at(t, device)
    elif spheric_cyclic is not None:
        translation = spheric_cyclic.translation_at(t, device)
    if rotate_axis is not None:
        rotation = rotate_axis.rotation_at(t, device)
    return Transform(translation, rotation)


@dataclasses.dataclass(frozen=True)
class SceneSettings:
    """The reference's ``ExampleSceneSettings`` (src/example_scene.rs:156-160)."""

    enable_movement: bool = False


def motion_params(
    params: dict,
    t,
    *,
    axis_cyclic: Optional[AxisCyclicMotion] = None,
    spheric_cyclic: Optional[SphericCyclicMotion] = None,
    rotate_axis: Optional[RotateAxisMotion] = None,
    enable_movement: bool = True,
    device: torch.device | str = "cuda",
) -> dict:
    """Scene params at time ``t`` with the object's rigid transform driven
    by the motion components: the advanced transform lands in the
    ``object_center``/``object_rotation`` params (the identity where
    ``params`` has none), as float32 tensors on ``device``."""
    base = Transform(
        _f32(params["object_center"], device) if "object_center" in params
        else torch.zeros(3, dtype=torch.float32, device=device),
        _f32(params["object_rotation"], device) if "object_rotation" in params
        else _f32([1.0, 0.0, 0.0, 0.0], device),
    )
    moved = apply_motion(
        base,
        t,
        axis_cyclic=axis_cyclic,
        spheric_cyclic=spheric_cyclic,
        rotate_axis=rotate_axis,
        enable_movement=enable_movement,
    )
    out = dict(params)
    out["object_center"] = moved.translation
    out["object_rotation"] = moved.rotation
    return out
