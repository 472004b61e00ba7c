"""The mesh-asset bake: the wrapper of the CUDA bake kernel and its plain twin.

The signed distance of a triangle mesh at every node of a lattice: Eberly's
exact point-triangle distance, negative where the generalized winding
number exceeds 1/2 (``models/mesh_sdf.py``). The JAX package bakes in XLA
(``bsdmg_tpu/models/mesh_sdf.py::mesh_signed_distance``), no Pallas kernel;
on the card the port bakes in ``csrc/bake_kernel.cu``, a brick of nodes a
block, the triangles in the Morton order of their centroids
(:func:`bake_order`), in clusters whose distance a brick evaluates only
where their bound says a triangle of theirs could be a node's nearest
(:func:`bake_cull_torch` is that decision in plain PyTorch).

:func:`bake` sends CUDA tensors to the kernel and CPU tensors to
:func:`bake_torch`, the twin (``mesh_signed_distance`` over the lattice's
nodes, brute force); nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from bsdmg_tpu_torch.models.mesh_sdf import _point_triangle_dist_sq, mesh_signed_distance
from bsdmg_tpu_torch.ops.cuda.build import load_library
from bsdmg_tpu_torch.ops.cuda.grid_box import MAX_GRID_RESOLUTION
from bsdmg_tpu_torch.ops.cuda.mesh_kernel import check_planes

#: launches of the CUDA kernel in this process; the wrapper adds one per launch
LAUNCHES = 0

#: the kernel's source, relative to the repository root
SOURCE = "bsdmg_tpu_torch/csrc/bake_kernel.cu"

#: triangles a cluster, nodes a brick along x, y and z, and a tile's
#: triangles (csrc/bake_kernel.cu kCluster, kBrickI/J/K, kThreads)
CLUSTER = 32
BRICK = (4, 4, 8)
TILE = 128
#: bits of a Morton code's axis
MORTON_BITS = 10
#: the bound's margin, eta = MARGIN * S, and its factor (csrc/bake_kernel.cu)
MARGIN = 2.0**-17
SHRINK = 1.0 - 2.0**-20


def lattice(axes) -> torch.Tensor:
    """The ``(R^3, 3)`` nodes of the lattice on ``axes`` (three ``(R,)``
    float32 tensors), C order, as ``bake_mesh_grid`` lays them out."""
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, 3)


def triangles(vertices, faces, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each triangle's vertices ``(va, vb, vc)``, ``(T, 3)`` float32 on
    ``device``."""
    vertices = torch.as_tensor(vertices, dtype=torch.float32, device=device)
    faces = torch.as_tensor(faces, dtype=torch.int64, device=device)
    return tuple(vertices[faces[:, k]].contiguous() for k in range(3))


class BakeInput(NamedTuple):
    """The kernel's triangles: ``va, vb, vc`` ``(T, 3)`` in the clusters'
    order, ``boxes`` ``(ceil(T / CLUSTER), 6)`` each cluster's least and
    greatest coordinates, ``eta`` the bound's margin, a float32 scalar
    tensor on their device (the kernel reads it there: no sync)."""

    va: torch.Tensor
    vb: torch.Tensor
    vc: torch.Tensor
    boxes: torch.Tensor
    eta: torch.Tensor


def _spread(v: torch.Tensor) -> torch.Tensor:
    """The 10 bits of ``v`` at every third bit."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def bake_order(axes, tris) -> BakeInput:
    """The triangles ``tris = (va, vb, vc)`` as the kernel walks them, on
    their device: sorted (stably) by the Morton code of their centroids,
    quantised to MORTON_BITS an axis on the lattice's box, in clusters of
    CLUSTER with their boxes, and the margin ``eta = MARGIN * S``, S the
    greatest magnitude of a vertex or a node coordinate. Nothing here waits
    for the device."""
    va, vb, vc = tris
    lo = torch.stack([a.min() for a in axes])
    hi = torch.stack([a.max() for a in axes])
    cells = float(1 << MORTON_BITS)
    scale = cells / torch.clamp_min(hi - lo, 1e-30)
    centroid = ((va + vb) + vc) * (1.0 / 3.0)
    q = torch.clamp(torch.floor((centroid - lo) * scale), 0.0, cells - 1.0).to(torch.int64)
    code = (_spread(q[:, 0]) << 2) | (_spread(q[:, 1]) << 1) | _spread(q[:, 2])
    order = torch.sort(code, stable=True).indices
    va, vb, vc = (v[order].contiguous() for v in (va, vb, vc))
    n = va.shape[0]
    clusters = (n + CLUSTER - 1) // CLUSTER
    corners = torch.stack([va, vb, vc], dim=1)  # (T, 3 vertices, 3)
    pad = clusters * CLUSTER - n
    low = torch.nn.functional.pad(corners.amin(dim=1), (0, 0, 0, pad), value=float("inf"))
    high = torch.nn.functional.pad(corners.amax(dim=1), (0, 0, 0, pad), value=float("-inf"))
    boxes = torch.cat([low.reshape(clusters, CLUSTER, 3).amin(dim=1),
                       high.reshape(clusters, CLUSTER, 3).amax(dim=1)], dim=1).contiguous()
    extent = torch.maximum(corners.abs().max(), torch.stack([a.abs().max() for a in axes]).max())
    return BakeInput(va, vb, vc, boxes, extent.float() * MARGIN)


def _bricks(r: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each brick's nodes, ``(B, TILE)`` indices into the ``(r^3,)``
    lattice (C order) as the kernel's threads take them, and whether each
    is a node (a brick past the lattice's edge has fewer)."""
    bi, bj, bk = BRICK
    t = torch.arange(TILE)
    ti, tj, tk = t // (bj * bk), (t // bk) % bj, t % bk
    gi, gj, gk = ((r + n - 1) // n for n in BRICK)
    b = torch.arange(gi * gj * gk)
    i = (b // (gj * gk))[:, None] * bi + ti
    j = ((b // gk) % gj)[:, None] * bj + tj
    k = (b % gk)[:, None] * bk + tk
    live = (i < r) & (j < r) & (k < r)
    node = (torch.clamp_max(i, r - 1) * r + torch.clamp_max(j, r - 1)) * r + torch.clamp_max(k, r - 1)
    return node, live


def cluster_bounds(boxes, bmin, bmax, eta) -> torch.Tensor:
    """The kernel's cluster_bound of every cluster (``boxes (C, 6)``)
    against every brick's box (``bmin, bmax (B, 3)``), ``(B, C)``: float32
    operations in the kernel's order; ``eta`` a float or a float32 scalar
    tensor."""
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=boxes.device)  # noqa: E731
    gap = torch.maximum(torch.maximum(boxes[None, :, :3] - bmax[:, None, :],
                                      bmin[:, None, :] - boxes[None, :, 3:]), f32(0.0))
    g = torch.maximum(gap - f32(eta), f32(0.0))
    return ((g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) + g[..., 2] * g[..., 2]) * f32(SHRINK)


def bake_cull_torch(axes, vertices, faces, eta=None):
    """Plain PyTorch version of the kernel's distance cull on the axes'
    device: ``(least, kept, pairs)``, the least squared distance at each of
    the ``(r^3,)`` nodes over the triangles of the clusters a brick kept,
    ``kept (B, C)`` the clusters each brick evaluated (its seed, the least
    bound, then each tile's other clusters whose bound is not above its
    worst best, the greatest of its nodes' least, as it stands after the
    tile before), and the pairs evaluated, as the kernel counts them (each
    kept cluster's triangles once a live node). Each pair's
    squared distance is the twin's (``_point_triangle_dist_sq``), so
    ``least.sqrt()`` equals the twin's distance bit for bit wherever no
    cluster of a node's nearest triangle was skipped. ``eta``, a float or a
    scalar tensor, replaces the margin (a planted fault)."""
    device = axes[0].device
    prep = bake_order(axes, triangles(vertices, faces, device))
    eta = prep.eta if eta is None else eta
    r = axes[0].numel()
    node, live = _bricks(r)
    node, live = node.to(device), live.to(device)
    points = lattice(axes)
    p = points[node]  # (B, TILE, 3)
    big = torch.tensor(float("inf"), device=device)
    bmin = torch.where(live[..., None], p, big).amin(dim=1)
    bmax = torch.where(live[..., None], p, -big).amax(dim=1)
    bounds = cluster_bounds(prep.boxes, bmin, bmax, eta)
    clusters = bounds.shape[1]
    n = prep.va.shape[0]
    d2 = _point_triangle_dist_sq(points[:, None, :], prep.va, prep.vb - prep.va,
                                 prep.vc - prep.va)[node]  # (B, TILE, T)
    by_cluster = torch.nn.functional.pad(d2, (0, clusters * CLUSTER - n), value=float("inf"))
    by_cluster = by_cluster.reshape(*node.shape, clusters, CLUSTER).amin(dim=-1)  # (B, TILE, C)
    seed = torch.argmin(bounds, dim=1)  # the first least
    rows = torch.arange(node.shape[0], device=device)
    needed = torch.zeros_like(bounds, dtype=torch.bool)
    best = by_cluster[rows, :, seed]
    worst = torch.where(live, best, -big).amax(dim=1)
    index = torch.arange(clusters, device=device)
    for first in range(0, clusters, TILE // CLUSTER):
        tile = slice(first, min(clusters, first + TILE // CLUSTER))
        need = (bounds[:, tile] <= worst[:, None]) & (index[tile] != seed[:, None])
        needed[:, tile] = need
        picked = torch.where(need[:, None, :], by_cluster[:, :, tile], big).amin(dim=-1)
        best = torch.minimum(best, picked)
        worst = torch.where(live, best, -big).amax(dim=1)
    sizes = torch.clamp(n - index * CLUSTER, max=CLUSTER)
    evaluated = (sizes[seed] + torch.where(needed, sizes, 0).sum(dim=1)) * live.sum(dim=1)
    kept = needed.clone()
    kept[rows, seed] = True
    least = torch.full((r**3,), float("inf"), device=device)
    least[node[live]] = best[live]
    return least, kept, int(evaluated.sum())


def bake_torch(axes, vertices, faces, chunk: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel on the axes' device: the lattice's
    ``(R^3,)`` signed distances (``mesh_signed_distance`` in chunks of
    ``chunk`` nodes)."""
    return mesh_signed_distance(lattice(axes), vertices, faces, chunk=chunk)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library()
    lib.bsdmg_bake.restype = ctypes.c_int
    lib.bsdmg_bake.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                               + [ctypes.c_int] + [ctypes.c_void_p] * 5)
    lib.bsdmg_error_string.restype = ctypes.c_char_p
    lib.bsdmg_error_string.argtypes = [ctypes.c_int]
    return lib


def brick_count(r: int) -> int:
    """The kernel's blocks, a brick each, for an ``r^3`` lattice."""
    return ((r + BRICK[0] - 1) // BRICK[0]) * ((r + BRICK[1] - 1) // BRICK[1]) * (
        (r + BRICK[2] - 1) // BRICK[2])


def _bake_cuda(axes, prep: BakeInput, out, pairs=None) -> None:
    """One launch from prepared inputs: ``axes`` three ``(R,)`` planes,
    ``prep`` :func:`bake_order`'s, into ``out`` ``(R^3,)``; ``pairs``, None or
    ``(brick_count(R),)`` int32, the distance pairs each brick evaluated."""
    global LAUNCHES
    lib = _library()
    device = out.device
    with torch.cuda.device(device):
        err = lib.bsdmg_bake(*(a.data_ptr() for a in axes), axes[0].numel(),
                             prep.va.data_ptr(), prep.vb.data_ptr(), prep.vc.data_ptr(),
                             prep.va.shape[0], prep.boxes.data_ptr(), prep.eta.data_ptr(),
                             out.data_ptr(),
                             None if pairs is None else pairs.data_ptr(),
                             torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bake kernel launch failed: cudaError {err} "
                           f"({lib.bsdmg_error_string(err).decode()})")
    LAUNCHES += 1


def _check(axes, tris) -> None:
    ax = axes[0]
    check_planes(lx=(ax, torch.float32), ly=(axes[1], torch.float32), lz=(axes[2], torch.float32))
    if not 1 <= ax.numel() <= MAX_GRID_RESOLUTION:
        raise ValueError(f"the bake takes 1 <= R <= {MAX_GRID_RESOLUTION}, not {ax.numel()}")
    if tris[0].shape[0] == 0:
        raise ValueError("a mesh without triangles has no signed distance")
    for t in tris:
        if t.dtype != torch.float32 or t.shape != tris[0].shape or t.shape[1:] != (3,):
            raise ValueError(f"triangle vertices must be (T, 3) float32, got {tuple(t.shape)}")
        if not t.is_contiguous() or t.device != ax.device:
            raise ValueError("triangle vertices must be contiguous and on the axes' device")


def prepare(axes, vertices, faces) -> BakeInput:
    """The kernel's inputs for the mesh on the axes' device, checked."""
    tris = triangles(vertices, faces, axes[0].device)
    _check(axes, tris)
    return bake_order(axes, tris)


def bake_cuda(axes, vertices, faces) -> torch.Tensor:
    """The kernel on the CUDA axes' device; raises if the launch fails."""
    prep = prepare(axes, vertices, faces)
    r = axes[0].numel()
    out = torch.empty(r**3, dtype=torch.float32, device=axes[0].device)
    _bake_cuda(axes, prep, out)
    return out


def bake(axes, vertices, faces, chunk: int | None = None) -> torch.Tensor:
    """The signed distances of the mesh ``(vertices, faces)`` at the nodes of
    the lattice on ``axes`` (three ``(R,)`` float32 tensors on one device),
    ``(R^3,)`` in C order. CUDA tensors go through the kernel, CPU tensors
    through :func:`bake_torch` (in chunks of ``chunk`` nodes)."""
    if axes[0].device.type == "cuda":
        return bake_cuda(axes, vertices, faces)
    if axes[0].device.type == "cpu":
        return bake_torch(axes, vertices, faces, chunk)
    raise ValueError(f"unsupported device {axes[0].device}")
