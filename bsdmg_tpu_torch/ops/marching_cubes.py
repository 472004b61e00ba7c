"""Table-driven marching cubes over a sparse voxel set.

Port of ``bsdmg_tpu/ops/marching_cubes.py`` (reference kernel:
cuda/modules/compute_mesh_generation.cu:64-120). Per voxel: sample the SDF
at the 8 corners, classify into the canonical 256-case table, emit up to 5
triangles whose vertices start on the sign-crossing edges, Newton-project
each vertex onto the isosurface, take fd4 normals there and fix the winding.

Two paths, as in the JAX package:

* **fused** (edge midpoints, the reference's placement and the default):
  classification and the table lookup here, the rest in kernel K6
  (``ops/cuda/mc_kernel.py``), then the rare-path centroid re-resolve of
  ambiguous windings;
* **staged** (``config.interpolate_edges``): start points interpolated along
  each edge; the crossing edges of rank < ``edge_budget``, listed, projected
  by kernel K7 (``ops/cuda/mesh_kernel.py``) and put back in each voxel's
  ``edge_budget`` lanes; the slot pick and winding here. The JAX package
  hands its kernel the lanes themselves, the empty ones padded; the soup is
  the same bit for bit.

The case lookup is a plain index ``TRI15[case]``; the JAX package's one-hot
bf16 product was a matrix-unit device of the TPU. On a CUDA device the two
kernels run; on the CPU, their plain twins.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bsdmg_tpu_torch.config import MeshGenConfig
from bsdmg_tpu_torch.ops.cuda.csdf import SceneDescriptor, SdfFns, sdf_fns
from bsdmg_tpu_torch.ops.cuda.mc_kernel import div3, mc_fused, winding
from bsdmg_tpu_torch.ops.cuda.mesh_kernel import fd4_grad, project_edges
from bsdmg_tpu_torch.ops.tables import (
    MC_CORNER_OFFSETS,
    MC_EDGE_TABLE,
    MC_TRIANGLE_CASES,
)

#: (256, 15) triangle-slot edge ids, 15 for an empty slot
TRI15 = np.where(MC_TRIANGLE_CASES < 0, 15, MC_TRIANGLE_CASES).reshape(256, 15)


class TriangleSoup(NamedTuple):
    """Fixed-budget triangle emission: ``(N, 5)`` slots with a validity mask.

    ``edge_overflow`` counts crossing edges beyond ``config.edge_budget``;
    the triangles of such voxels are invalid, and the pipeline re-extracts
    with ``edge_budget=12`` (mesh/pipeline.py). Invalid slots are zero."""

    positions: torch.Tensor  # (N, 5, 3 verts, 3) float32
    normals: torch.Tensor  # (N, 5, 3 verts, 3) float32
    valid: torch.Tensor  # (N, 5) bool
    edge_overflow: int = 0


def corner_points(lowers: torch.Tensor, voxel_size) -> torch.Tensor:
    """The 8 cube corners per voxel, ``(N, 8, 3)``, reference corner order."""
    offsets = torch.tensor(MC_CORNER_OFFSETS, dtype=torch.float32, device=lowers.device)
    return lowers[:, None, :] + (offsets * float(voxel_size))[None]


def classify(values: torch.Tensor) -> torch.Tensor:
    """256-way case index: bit i set iff corner i is inside (values <= 0)."""
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], device=values.device)
    return ((values <= 0.0).long() * weights).sum(dim=-1)


def _int32(words: torch.Tensor) -> torch.Tensor:
    """An int64 holding 32 bits -> the int32 with the same bits."""
    return (((words + 2**31) % 2**32) - 2**31).to(torch.int32)


def _resolve_ambiguous(fns: SdfFns, pos, nrm, dot, amb, meta, eps: float) -> None:
    """Re-resolve in place the windings K6 marked ambiguous, with the
    reference's centroid stencil (the JAX wrapper's rare path,
    marching_cubes.py:195-243): undo the kernel's swap, then swap again
    where the fd4 normal at the centroid opposes the geometric normal."""
    valid = ((meta[:, None] >> torch.arange(5, device=meta.device)) & 1) > 0
    vi, ti = ((amb > 0) & valid).nonzero(as_tuple=True)
    if not vi.numel():
        return
    v = pos.view(-1, 5, 3, 3)[vi, ti]  # swapped by the kernel
    nn = nrm.view(-1, 5, 3, 3)[vi, ti]
    m = div3((v[:, 0] + v[:, 1]) + v[:, 2])
    ax, ay, az = fd4_grad(fns.value, m[:, 0], m[:, 1], m[:, 2], eps)
    kflip = (dot[vi, ti] <= 0.0)[:, None, None]
    u = torch.where(kflip, v.flip(1), v)
    un = torch.where(kflip, nn.flip(1), nn)
    e1 = u[:, 1] - u[:, 0]
    e2 = u[:, 2] - u[:, 0]
    gx = e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1]
    gy = e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2]
    gz = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    oflip = (((gx * ax + gy * ay) + gz * az) <= 0.0)[:, None, None]
    pos.view(-1, 5, 3, 3)[vi, ti] = torch.where(oflip, u.flip(1), u)
    nrm.view(-1, 5, 3, 3)[vi, ti] = torch.where(oflip, un.flip(1), un)


class _Voxels(NamedTuple):
    """A field's voxels, classified: corner planes and values ``(N, 8)``,
    case index, crossing edges ``(N, 12)`` and the lane budget."""

    lowers: torch.Tensor
    vs: float
    corners: tuple
    values: torch.Tensor
    case: torch.Tensor
    crossing: torch.Tensor
    budget: int


def _classify(fns: SdfFns, lowers, voxel_size, config) -> _Voxels:
    n = lowers.shape[0]
    vs = float(np.float32(voxel_size))
    corners = corner_points(lowers, vs).unbind(dim=-1)  # (N, 8) each
    values = fns.value(*(c.reshape(-1) for c in corners)).reshape(n, 8)
    inside = values <= 0.0
    crossing = inside[:, MC_EDGE_TABLE[:, 0]] != inside[:, MC_EDGE_TABLE[:, 1]]
    budget = min(max(int(config.edge_budget), 1), 12)
    return _Voxels(lowers, vs, corners, values, classify(values), crossing, budget)


def _fused_inputs(v: _Voxels, config):
    """K6's arguments: the lower-corner planes, the crossing bits and the
    slot edge ids packed 4 bits each (slots 0-7 in ``t0``, 8-14 in ``t1``)."""
    device = v.lowers.device
    nib = torch.tensor(TRI15, dtype=torch.int64, device=device)[v.case]  # (N, 15)
    t0 = _int32(sum(nib[:, s] << (4 * s) for s in range(8)))
    t1 = _int32(sum(nib[:, s] << (4 * (s - 8)) for s in range(8, 15)))
    cross_bits = (v.crossing.long() << torch.arange(12, device=device)).sum(dim=1).int()
    args = (*(v.lowers[:, a].contiguous() for a in range(3)), cross_bits, t0, t1, v.vs)
    kwargs = dict(
        budget=v.budget, iters=config.newton_iters, tol=config.newton_tolerance,
        eps=config.normal_epsilon, use_grad=config.projection_normals == "grad",
        winding_normals=config.winding_normals,
    )
    return args, kwargs


def _staged_inputs(v: _Voxels, config):
    """K7's arguments: the crossing edges of rank < budget, voxel by voxel in
    rank order, their start points interpolated along the edge, and an
    ``active`` mask of ones; plus each listed edge's ``(voxel, lane)`` (its
    rank), the ranks ``(N, 12)`` and the crossing counts ``(N,)``."""
    ec0 = torch.as_tensor(MC_EDGE_TABLE[:, 0], device=v.lowers.device)
    ec1 = torch.as_tensor(MC_EDGE_TABLE[:, 1], device=v.lowers.device)
    acti = v.crossing.long()
    rank = torch.cumsum(acti, dim=1) - acti
    nact = acti.sum(dim=1)
    vox, edge = (v.crossing & (rank < v.budget)).nonzero(as_tuple=True)
    c0, c1 = ec0[edge], ec1[edge]
    v0, v1 = v.values[vox, c0], v.values[vox, c1]
    t = v0 / torch.where(torch.abs(v0 - v1) < 1e-12, 1.0, v0 - v1)
    t = torch.clamp(t, 0.0, 1.0)
    starts = [c[vox, c0] + (c[vox, c1] - c[vox, c0]) * t for c in v.corners]
    args = (*starts, torch.ones_like(vox, dtype=torch.int32))
    kwargs = dict(
        iters=config.newton_iters, tol=config.newton_tolerance, eps=config.normal_epsilon,
        use_grad=config.projection_normals == "grad",
    )
    return args, kwargs, (vox, rank[vox, edge]), rank, nact


def _finish_fused(scene, fns, v: _Voxels, config) -> TriangleSoup:
    """Fused tail: K6 (or its twin), then the ambiguous windings."""
    n = v.lowers.shape[0]
    args, kwargs = _fused_inputs(v, config)
    pos, nrm, dot, amb, meta = mc_fused(scene, *args, **kwargs)
    if config.winding_normals == "vertex_mean":
        _resolve_ambiguous(fns, pos, nrm, dot, amb, meta, config.normal_epsilon)
    valid = ((meta[:, None] >> torch.arange(5, device=meta.device)) & 1) > 0
    return TriangleSoup(
        pos.view(n, 5, 3, 3), nrm.view(n, 5, 3, 3), valid, int((meta >> 5).sum())
    )


def _finish_staged(scene, fns, v: _Voxels, config) -> TriangleSoup:
    """Staged tail: K7 (or its twin) on the listed crossing edges, its
    results in each voxel's ``budget`` lanes (zero where a voxel has fewer
    edges), then the slot pick through the rank and the winding fix."""
    n, budget = v.lowers.shape[0], v.budget
    device = v.lowers.device
    args, kwargs, (vox, lane), rank, nact = _staged_inputs(v, config)
    planes = torch.zeros((n, budget, 6), dtype=torch.float32, device=device)
    planes[vox, lane] = torch.stack(project_edges(scene, *args, **kwargs), dim=1)
    return _staged_soup(fns, v, planes, rank, nact, config)


def _staged_soup(fns, v: _Voxels, planes, rank, nact, config) -> TriangleSoup:
    """The staged path's triangles from each voxel's projected lanes
    ``planes`` ``(N, budget, 6)`` (point and normal, zero in an empty lane):
    the slot pick through the rank and the winding fix."""
    n, budget = v.lowers.shape[0], v.budget
    device = v.lowers.device
    tri_edges = torch.tensor(MC_TRIANGLE_CASES, device=device)[v.case]  # (N, 5, 3)
    slot = rank.gather(1, torch.clamp_min(tri_edges.reshape(n, 15), 0).long())
    over = (slot >= budget).reshape(n, 5, 3).any(dim=-1)
    tri_valid = (tri_edges[..., 0] >= 0) & ~over
    picked = planes.gather(1, slot.clamp(max=budget - 1)[..., None].expand(-1, -1, 6))
    picked = picked.reshape(n, 5, 3, 6)
    verts, normals = picked[..., :3], picked[..., 3:]

    vi, ti = tri_valid.nonzero(as_tuple=True)
    flip = torch.zeros((n, 5), dtype=torch.bool, device=device)
    if vi.numel():
        tv, tn = verts[vi, ti], normals[vi, ti]
        centroid = config.winding_normals == "centroid_fd4"
        dot, ambiguous = winding(fns, tv, tn, config.normal_epsilon, centroid)
        if not centroid and bool(ambiguous.any()):
            k = ambiguous.nonzero().squeeze(1)
            dot[k] = winding(fns, tv[k], tn[k], config.normal_epsilon, True)[0]
        flip[vi, ti] = dot <= 0.0
    keep = tri_valid[..., None, None]
    flip = flip[..., None, None]
    verts = torch.where(keep, torch.where(flip, verts.flip(2), verts), 0.0)
    normals = torch.where(keep, torch.where(flip, normals.flip(2), normals), 0.0)
    edge_overflow = int(torch.clamp_min(nact - budget, 0).sum())
    return TriangleSoup(verts, normals, tri_valid, edge_overflow)


def _check(config: MeshGenConfig) -> None:
    if config.projection_normals not in ("grad", "fd4"):
        raise ValueError(
            f"projection_normals must be 'grad' or 'fd4', got {config.projection_normals!r}"
        )


def kernel_inputs(
    scene: SceneDescriptor | SdfFns,
    lowers: torch.Tensor,
    voxel_size: float,
    config: MeshGenConfig = MeshGenConfig(),
):
    """``(args, kwargs)`` that :func:`extract_triangles` hands kernel K6
    (``mc_fused(scene, *args, **kwargs)``) or, with
    ``config.interpolate_edges``, kernel K7
    (``project_edges(scene, *args, **kwargs)``: the listed crossing edges,
    every one active), for measuring a kernel on the inputs the pipeline
    gives it."""
    _check(config)
    v = _classify(sdf_fns(scene), lowers, voxel_size, config)
    return _staged_inputs(v, config)[:2] if config.interpolate_edges else _fused_inputs(v, config)


def padded_inputs(
    scene: SceneDescriptor | SdfFns,
    lowers: torch.Tensor,
    voxel_size: float,
    config: MeshGenConfig = MeshGenConfig(),
):
    """K7's ``(args, kwargs)`` in the JAX kernel's layout
    (``project_edges_pallas`` as ``bsdmg_tpu/ops/marching_cubes.py:392-411``
    packs it): each voxel's crossing edges of rank < budget in
    ``config.edge_budget`` lanes, 1e6 in an empty lane, and the ``active``
    mask. The staged path hands K7 the listed edges instead
    (:func:`kernel_inputs`); its soup is the same bit for bit."""
    _check(config)
    v = _classify(sdf_fns(scene), lowers, voxel_size, config)
    args, kwargs, (vox, lane), _, _ = _staged_inputs(v, config)

    def lanes(values, fill):
        out = torch.full((lowers.shape[0], v.budget), fill, dtype=values.dtype,
                         device=values.device)
        out[vox, lane] = values
        return out.reshape(-1)

    return (*(lanes(a, 1e6) for a in args[:3]), lanes(args[3], 0)), kwargs


def extract_triangles(
    scene: SceneDescriptor | SdfFns,
    lowers: torch.Tensor,
    voxel_size: float,
    config: MeshGenConfig = MeshGenConfig(),
) -> TriangleSoup:
    """Marching cubes + Newton vertex projection + winding fix over the
    voxels with lower corners ``lowers`` ``(N, 3)`` float32 and edge
    ``voxel_size``. ``scene`` is a :class:`SceneDescriptor`; on the CPU it
    may also be :class:`SdfFns`. ``config.interpolate_edges`` picks the
    staged K7 path, else the fused K6 path runs. Returns a
    :class:`TriangleSoup` with the reference's 5-triangle budget per voxel
    (src/cuda/mod.rs:205)."""
    _check(config)
    fns = sdf_fns(scene)
    v = _classify(fns, lowers, voxel_size, config)
    finish = _finish_staged if config.interpolate_edges else _finish_fused
    return finish(scene, fns, v, config)
