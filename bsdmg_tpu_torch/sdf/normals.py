"""Surface normals and isosurface projection.

Port of ``bsdmg_tpu/sdf/normals.py``. Two normal paths:

* :func:`normal_grad`: the analytic gradient of the SDF, by ``torch.func``;
* :func:`normal_fd4`: the reference's 4th-order central difference with
  ``eps=1e-3`` (cuda/includes/signed_distance.cu:179-202), the golden
  images' normal.

Plus :func:`closest_surface_point`, the Newton projection the reference
runs per marching-cubes vertex (signed_distance.cu:227-240), bounded to a
fixed iteration count with a convergence mask, and the component-form
variants on coordinate planes (``..._c``, :func:`as_component`). The mesh
kernels K6 and K7 run their own Newton loop (``ops/cuda/mesh_kernel.py``);
these are the library's.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.func

_SAFE_EPS = 1e-12

SdfFn = Callable[[torch.Tensor], torch.Tensor]
"""A scene SDF: points (..., 3) -> distances (...,)."""


def _normalize(v: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt(torch.clamp_min((v * v).sum(dim=-1, keepdim=True), _SAFE_EPS))
    return v / n


def normal_grad(sdf: SdfFn, p: torch.Tensor) -> torch.Tensor:
    """Unit normal from the analytic SDF gradient (``torch.func.grad``; the
    points are independent, so the gradient of the sum is each point's)."""
    flat = p.reshape(-1, 3)
    g = torch.func.grad(lambda q: sdf(q).sum())(flat)
    return _normalize(g).reshape(p.shape)


def normal_fd4(sdf: SdfFn, p: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Unit normal from ``-f(p+2e) + 8 f(p+e) - 8 f(p-e) + f(p-2e)`` per
    axis, 12 SDF evaluations per point in one batched call (the 1/(12 eps)
    factor cancels under normalisation, as in the reference)."""
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    taps = torch.tensor([2.0, 1.0, -1.0, -2.0], dtype=p.dtype, device=p.device)
    offsets = (taps[:, None, None] * eye[None, :, :]).reshape(12, 3) * eps
    samples = sdf(p[..., None, :] + offsets)  # (..., 12)
    weights = torch.tensor([-1.0, 8.0, -8.0, 1.0], dtype=p.dtype, device=p.device)
    grads = (samples.reshape(*samples.shape[:-1], 4, 3) * weights[:, None]).sum(dim=-2)
    return _normalize(grads)


def normal_plane(sdf: SdfFn, p: torch.Tensor, eps: float = 1e-3):
    """Tangent frame ``(up, forward, right)`` at ``p``
    (signed_distance.cu:210-225): ``up`` is the fd4 normal, ``right = up x
    ref`` with ref +Z unless the normal is nearly parallel to it (then +Y),
    ``forward = up x right``."""
    up = normal_fd4(sdf, p, eps)
    z = torch.tensor([0.0, 0.0, 1.0], dtype=p.dtype, device=p.device)
    y = torch.tensor([0.0, 1.0, 0.0], dtype=p.dtype, device=p.device)
    use_z = torch.abs((up * z).sum(dim=-1, keepdim=True)) < 0.5
    ref = torch.where(use_z, z, y)
    right = torch.linalg.cross(up, ref.expand_as(up))
    forward = torch.linalg.cross(up, right)
    return up, forward, right


def closest_surface_point(
    sdf: SdfFn,
    p: torch.Tensor,
    *,
    iters: int = 24,
    tolerance: float = 1e-5,
    eps: float = 1e-3,
    use_grad_normal: bool = False,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Project points onto the zero isosurface, ``g <- g - sd(g) * n(g)``
    (signed_distance.cu:227-240): at most ``iters`` steps, a point stopping
    once ``|sd| <= tolerance``; the loop ends when every live point has
    (``mask`` False marks a point as done from the start)."""
    def normal_fn(q):
        return normal_grad(sdf, q) if use_grad_normal else normal_fd4(sdf, q, eps)

    g = p
    done = (torch.zeros(p.shape[:-1], dtype=torch.bool, device=p.device) if mask is None
            else ~mask.bool())
    for _ in range(iters):
        if bool(done.all()):
            break
        sd = sdf(g)
        g_next = g - sd[..., None] * normal_fn(g)
        g = torch.where(done[..., None], g, g_next)
        done = done | (torch.abs(sd) <= tolerance)
    return g


# ---------------------------------------------------------------------------
# component form: coordinate planes x, y, z of any equal shape
# ---------------------------------------------------------------------------


def as_component(sdf: SdfFn):
    """A points-API SDF with the component signature ``csdf(x, y, z)``."""

    def csdf(x, y, z):
        return sdf(torch.stack([x, y, z], dim=-1))

    return csdf


def _unit(gx, gy, gz):
    inv = torch.rsqrt(torch.clamp_min(gx * gx + gy * gy + gz * gz, _SAFE_EPS))
    return gx * inv, gy * inv, gz * inv


def normal_fd4_c(csdf, x, y, z, eps: float = 1e-3):
    """4th-order central-difference unit normal on planes, ``(nx, ny, nz)``:
    :func:`normal_fd4`'s stencil (signed_distance.cu:181-202)."""

    def deriv(fp2, fp1, fm1, fm2):
        return -fp2 + 8.0 * fp1 - 8.0 * fm1 + fm2

    gx = deriv(csdf(x + 2 * eps, y, z), csdf(x + eps, y, z),
               csdf(x - eps, y, z), csdf(x - 2 * eps, y, z))
    gy = deriv(csdf(x, y + 2 * eps, z), csdf(x, y + eps, z),
               csdf(x, y - eps, z), csdf(x, y - 2 * eps, z))
    gz = deriv(csdf(x, y, z + 2 * eps), csdf(x, y, z + eps),
               csdf(x, y, z - eps), csdf(x, y, z - 2 * eps))
    return _unit(gx, gy, gz)


def closest_surface_point_c(
    csdf,
    x: torch.Tensor,
    y: torch.Tensor,
    z: torch.Tensor,
    *,
    iters: int = 24,
    tolerance: float = 1e-5,
    eps: float = 1e-3,
    mask: torch.Tensor | None = None,
):
    """Newton projection on coordinate planes (signed_distance.cu:227-240),
    :func:`closest_surface_point`'s loop with fd4 normals; returns the
    projected ``(x, y, z)``."""
    gx, gy, gz = x, y, z
    done = torch.zeros(x.shape, dtype=torch.bool, device=x.device) if mask is None else ~mask.bool()
    for _ in range(iters):
        if bool(done.all()):
            break
        sd = csdf(gx, gy, gz)
        nx, ny, nz = normal_fd4_c(csdf, gx, gy, gz, eps)
        gx = torch.where(done, gx, gx - sd * nx)
        gy = torch.where(done, gy, gy - sd * ny)
        gz = torch.where(done, gz, gz - sd * nz)
        done = done | (torch.abs(sd) <= tolerance)
    return gx, gy, gz


def normal_jvp_c(csdf, x, y, z):
    """Analytic unit normal on planes by three forward-mode products
    (``torch.func.jvp``), the component-form counterpart of
    :func:`normal_grad`."""
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    _, gx = torch.func.jvp(csdf, (x, y, z), (one, zero, zero))
    _, gy = torch.func.jvp(csdf, (x, y, z), (zero, one, zero))
    _, gz = torch.func.jvp(csdf, (x, y, z), (zero, zero, one))
    return _unit(gx, gy, gz)
