"""Texture fetch and bicubic (Catmull-Rom) sampling.

Port of ``bsdmg_tpu/cam/sampling.py``, the reference's texture helpers
(cuda/modules/common.cu:23-66): ``fetch_2d``/``index_2d`` (clamp-to-edge
texel access) and ``cubic_interpolate``/``ndc_to_interpolated_value``
(separable Catmull-Rom resampling of an NDC-addressed texture). The
reference compiles them into its modules but no kernel calls them; here
they resample render targets (e.g. upscaling a half-resolution render).

Conventions are the reference's: texel (x, y) lives at flat index ``x + y *
width``; NDC coordinates map ``p * size - 0.5`` onto the texel grid;
out-of-range fetches clamp to the edge.
"""

from __future__ import annotations

import torch


def index_2d(p: torch.Tensor, size) -> torch.Tensor:
    """Flat index of integer texel coordinates ``p = (..., 2)``,
    clamp-to-edge (common.cu:33-35)."""
    p = torch.as_tensor(p)
    x = torch.clamp(p[..., 0], 0, size[0] - 1)
    y = torch.clamp(p[..., 1], 0, size[1] - 1)
    return x + y * size[0]


def fetch_2d(p: torch.Tensor, texture: torch.Tensor, size=None) -> torch.Tensor:
    """Clamp-to-edge texel fetch (common.cu:23-30). ``texture`` is flat
    ``(W*H, ...)`` with ``size=(W, H)`` (the reference's layout) or a 2-D
    ``(H, W, ...)`` tensor (size inferred)."""
    p = torch.as_tensor(p, device=texture.device).long()
    if texture.ndim >= 2 and size is None:
        h, w = texture.shape[:2]
        x = torch.clamp(p[..., 0], 0, w - 1)
        y = torch.clamp(p[..., 1], 0, h - 1)
        return texture[y, x]
    if size is None:
        raise ValueError("flat texture requires an explicit size=(W, H)")
    return texture[index_2d(p, size)]


def cubic_interpolate(y0, y1, y2, y3, rx1):
    """Catmull-Rom cubic through 4 samples at parameter ``rx1`` in [0, 1],
    in the reference's Horner form (common.cu:38-44)."""
    return y1 + 0.5 * rx1 * (
        y2 - y0
        + rx1 * (2.0 * y0 - 5.0 * y1 + 4.0 * y2 - y3 + rx1 * (3.0 * (y1 - y2) + y3 - y0))
    )


def ndc_to_interpolated_value(p: torch.Tensor, texture: torch.Tensor, size=None) -> torch.Tensor:
    """Bicubic sample of a texture at NDC coordinates ``p = (..., 2)`` in
    [0, 1]: separable Catmull-Rom over a 4x4 texel neighbourhood with
    clamp-to-edge (common.cu:47-66). Flat ``(W*H,)`` textures take
    ``size=(W, H)``, 2-D ``(H, W)`` ones their own."""
    p = torch.as_tensor(p, dtype=torch.float32, device=texture.device)
    fetch_size = size  # None routes fetch_2d to the 2-D path
    if size is None:
        if texture.ndim < 2:
            raise ValueError("flat texture requires an explicit size=(W, H)")
        size = (texture.shape[1], texture.shape[0])
    t = p * torch.tensor([float(size[0]), float(size[1])], device=p.device) - 0.5
    tc = torch.floor(t).to(torch.int32)
    fx = t[..., 0] - tc[..., 0].to(torch.float32)
    fy = t[..., 1] - tc[..., 1].to(torch.float32)

    def row(i):
        def tap(j):
            q = torch.stack([tc[..., 0] + (j - 1), tc[..., 1] + (i - 1)], dim=-1)
            return fetch_2d(q, texture, fetch_size)

        return cubic_interpolate(tap(0), tap(1), tap(2), tap(3), fx)

    return cubic_interpolate(row(0), row(1), row(2), row(3), fy)
