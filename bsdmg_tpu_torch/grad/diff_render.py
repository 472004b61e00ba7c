"""Differentiable sphere-traced rendering with respect to SDF parameters.

Port of ``bsdmg_tpu/grad/diff_render.py``. The march runs without gradients
and the hit is re-attached by the implicit function theorem: the accepted
hit satisfies ``f(o + t d, theta) - cone*t - eps = 0`` to first order, so
one Newton correction around the stopped ``t``,

    t* = t - (f(o + t d, theta) - cone*t - eps) / stop(grad_f . d - cone),

has the exact Jacobian ``dt/dtheta``. The shading (normal from autograd of
the SDF, Lambert mix, ACES) is then an ordinary differentiable program.
Miss pixels keep constant colours; the silhouette is a step that
``grad/edge.py`` handles.

On CUDA tensors the stopped march of the component-form render is kernel
K4, and the fused loss and gradient (:func:`render_loss_and_grad` with a
``csdf``) kernel K5 (``ops/cuda/diff_kernel.py``); on CPU tensors their
plain twins. The points path (no ``csdf``) marches with
``ops/trace.py::sphere_trace`` and differentiates with autograd, as the JAX
package leaves it to XLA.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from bsdmg_tpu_torch.config import MarchConfig
from bsdmg_tpu_torch.ops.cuda.diff_kernel import march_params_cuda, render_loss_grad_cuda
from bsdmg_tpu_torch.ops.shade import COLOR_HIGH, COLOR_LOW, LIGHT_DIR, aces_tonemap, shade_planes
from bsdmg_tpu_torch.ops.trace import COLLISION, STEP_LIMIT, RayMarchHit, sphere_trace

SceneFn = Callable[[Any, torch.Tensor], torch.Tensor]


def _stopped(params):
    return {k: v.detach() for k, v in params.items()}


def _cone(cone_radius, shape, device) -> torch.Tensor:
    return torch.as_tensor(cone_radius, dtype=torch.float32, device=device).broadcast_to(shape)


def _guard(denom: torch.Tensor) -> torch.Tensor:
    """Rays approach the surface from outside (df/dt - cone < 0 at a hit);
    a zero denominator becomes -1e-6."""
    return torch.where(torch.abs(denom) < 1e-6, -1e-6, denom).detach()


def differentiable_hit(
    scene: SceneFn,
    params,
    origins: torch.Tensor,
    directions: torch.Tensor,
    cone_radius,
    config: MarchConfig = MarchConfig(),
) -> tuple[torch.Tensor, RayMarchHit]:
    """Trace and return ``(t_diff, hit)``; ``t_diff`` carries the implicit
    gradients with respect to ``params`` for collision rays."""
    stopped = _stopped(params)
    with torch.no_grad():
        hit = sphere_trace(lambda p: scene(stopped, p), origins, directions, cone_radius, config)
    t0 = hit.depth
    x0 = origins + t0[..., None] * directions
    cone = _cone(cone_radius, t0.shape, t0.device)

    # df/dt along the ray, parameters stopped: the IFT denominator
    with torch.enable_grad():
        t = t0.clone().requires_grad_()
        (dfdt,) = torch.autograd.grad(
            scene(stopped, origins + t[..., None] * directions).sum(), t
        )
    denom = _guard(dfdt - cone)
    residual = scene(params, x0) - cone * t0 - config.collision_distance
    t_diff = t0 - residual / denom
    return torch.where(hit.outcome == COLLISION, t_diff, t0), hit


def _shade_diff(scene: SceneFn, params, positions: torch.Tensor, outcome: torch.Tensor):
    """Shading of the points path, normals by autograd of the SDF."""
    graph = positions.requires_grad
    with torch.enable_grad():
        q = positions if graph else positions.detach().requires_grad_()
        (g,) = torch.autograd.grad(scene(params, q).sum(), q, create_graph=graph)
    normals = g / torch.clamp_min(torch.linalg.vector_norm(g, dim=-1, keepdim=True), 1e-12)
    light = torch.tensor(LIGHT_DIR, dtype=torch.float32, device=positions.device)
    light = light / torch.linalg.vector_norm(light)
    t = ((normals * light).sum(dim=-1) + 1.0) / 2.0
    low = torch.tensor(COLOR_LOW, dtype=torch.float32, device=positions.device)
    high = torch.tensor(COLOR_HIGH, dtype=torch.float32, device=positions.device)
    color = low + t[..., None] * (high - low)
    o = outcome[..., None]
    color = torch.where(o == COLLISION, color, 0.0)
    color = torch.where(o == STEP_LIMIT, 1.0, color)
    return aces_tonemap(color)


def shade_diff_planes(csdf, params, ox, oy, oz, dx, dy, dz, cone, t0, dfdt, outcome,
                      config: MarchConfig = MarchConfig()):
    """The differentiable part of the component-form render on planes: the
    IFT re-attachment of the stopped hit ``t0`` (``dfdt`` the march's
    derivative along the ray), the normal ``grad_x csdf`` at the re-attached
    point, normalised by ``1/sqrt(max(|g|^2, 1e-24))``, and the shading.
    Returns ``(r, g, b)`` planes, differentiable with respect to
    ``params``."""
    denom = _guard(dfdt - cone)
    residual = (
        csdf(params, ox + t0 * dx, oy + t0 * dy, oz + t0 * dz)
        - cone * t0 - config.collision_distance
    )
    collided = outcome == COLLISION
    t_diff = torch.where(collided, t0 - residual / denom, t0)
    q = (ox + t_diff * dx, oy + t_diff * dy, oz + t_diff * dz)
    # one reverse pass gives every pixel's spatial gradient (the pixels are
    # independent); create_graph keeps it differentiable in the parameters
    graph = t_diff.requires_grad
    with torch.enable_grad():
        if not graph:
            q = tuple(v.detach().requires_grad_() for v in q)
        gx, gy, gz = torch.autograd.grad(csdf(params, *q).sum(), q, create_graph=graph)
    inv = 1.0 / torch.sqrt(torch.clamp_min(gx * gx + gy * gy + gz * gz, 1e-24))
    return shade_planes(gx * inv, gy * inv, gz * inv, outcome)


def render_image_diff(
    scene: SceneFn,
    params,
    origins: torch.Tensor,
    directions: torch.Tensor,
    cone_radius,
    config: MarchConfig = MarchConfig(),
    csdf=None,
    bb: tuple | None = None,
    split=None,
) -> torch.Tensor:
    """Differentiable render: linear RGB ``(..., 3)`` with gradients flowing
    to ``params`` through the hit depth and the shading normals.

    ``csdf`` (``Scene.csdf``) switches to the component form on an
    ``(H, W)`` ray image, whose stopped march is K4 on the card; ``bb``
    (component form) turns on its slab cull and must bound the surface over
    every parameter value the caller reaches; ``split`` (component form)
    the near/far split of K4's march (``ops/cuda/diff_kernel.py``)."""
    if csdf is not None:
        return _render_image_diff_c(csdf, params, origins, directions, cone_radius, config, bb=bb,
                                    split=split)
    t_diff, hit = differentiable_hit(scene, params, origins, directions, cone_radius, config)
    positions = origins + t_diff[..., None] * directions
    return _shade_diff(scene, params, positions, hit.outcome)


def _render_image_diff_c(
    csdf,
    params,
    origins: torch.Tensor,
    directions: torch.Tensor,
    cone_radius,
    config: MarchConfig = MarchConfig(),
    bb: tuple | None = None,
    split=None,
):
    """Component-form differentiable render of an ``(H, W)`` ray image."""
    h, w = origins.shape[:2]
    cone = _cone(cone_radius, (h, w), origins.device).contiguous()
    depth, _, outcome, dfdt = (
        x.reshape(-1)
        for x in march_params_cuda(csdf, _stopped(params), origins, directions, cone, config,
                                   bb=bb, split=split)
    )
    planes = [origins[..., a].reshape(-1) for a in range(3)]
    planes += [directions[..., a].reshape(-1) for a in range(3)]
    rgb = shade_diff_planes(csdf, params, *planes, cone.reshape(-1), depth, dfdt, outcome, config)
    return torch.stack(rgb, dim=-1).reshape(h, w, 3)


class _LossWithGrads(torch.autograd.Function):
    """A loss whose gradient was computed with it: the forward returns the
    loss of ``run()``, the backward ``grad_out`` times its saved gradients,
    so ``loss.backward()`` fills the parameters' ``.grad``."""

    @staticmethod
    def forward(ctx, run, *values):
        loss, grads = run()
        ctx.save_for_backward(*grads)
        return loss

    @staticmethod
    def backward(ctx, grad_out):
        return (None, *(grad_out * g for g in ctx.saved_tensors))


def render_loss_and_grad(
    scene: SceneFn,
    params,
    target: torch.Tensor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    cone_radius,
    config: MarchConfig = MarchConfig(),
    csdf=None,
    bb: tuple | None = None,
    edge_weight: float = 0.0,
    edge_band: float | None = None,
    target_miss: torch.Tensor | None = None,
    split=None,
):
    """L2 image loss against ``target`` and its gradient with respect to
    ``params``: ``(loss, grads)``, ``grads`` a dict like ``params``. The
    loss is differentiable: ``loss.backward()`` fills the ``.grad`` of the
    parameters that require it with the same gradient.

    With a component-form ``csdf`` this is the fused step, kernel K5 on the
    card (its plain twin on the CPU);
    ``edge_weight > 0`` adds the silhouette-aware closest-approach loss
    (``grad/edge.py``), which needs a ``csdf``; ``split`` is K5's near/far
    split. Without a ``csdf`` it is autograd of the points-path render."""
    edge_weight = float(edge_weight)
    if edge_weight and csdf is None:
        raise ValueError(
            "edge_weight > 0 requires a component-form csdf (the closest-"
            "approach record lives on the component-form march)"
        )
    names = sorted(params)
    grads_out = {}

    def run():
        if csdf is not None:
            loss, grads = render_loss_grad_cuda(
                csdf, params, target, origins, directions,
                _cone(cone_radius, origins.shape[:-1], origins.device).contiguous(), config,
                bb=bb, edge_weight=edge_weight, edge_band=edge_band, target_miss=target_miss,
                split=split,
            )
        else:
            p = {k: v.detach().requires_grad_() for k, v in params.items()}
            with torch.enable_grad():
                img = render_image_diff(scene, p, origins, directions, cone_radius, config)
                loss = torch.mean((img - target) ** 2)
                found = torch.autograd.grad(loss, [p[k] for k in names], allow_unused=True)
            grads = {k: torch.zeros_like(p[k]) if g is None else g for k, g in zip(names, found)}
            loss = loss.detach()
        grads_out.update(grads)
        return loss, [grads[k] for k in names]

    loss = _LossWithGrads.apply(run, *(params[k] for k in names))
    return loss, grads_out
