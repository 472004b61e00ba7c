"""Fused marching-cubes finish: the wrapper of CUDA kernel K6 and its plain twin.

Counterpart of ``bsdmg_tpu/ops/pallas/mc_fused.py::mc_fused_pallas``, the
kernel of the JAX package's default mesh path. Per voxel: unpack the
crossing bits and take each edge's exclusive rank; Newton-project the
crossing edges of rank < ``budget`` from their midpoints; fd4 unit normals
at the projected points; each of the 15 triangle slots takes its edge's
result through the rank (an edge of rank >= ``budget`` invalidates the
slot); the winding test and the a <-> c swap; the meta word (bits 0-4
triangle validity, bits 5+ the crossing edges beyond the budget).

Outputs, the Pallas kernel's planes laid out per voxel: ``pos`` and ``nrm``
``(N, 45)`` (= ``(N, 5, 3, 3)``: triangle, vertex, coordinate), ``dot``
``(N, 5)`` float32 (0 for an invalid triangle), ``amb`` ``(N, 5)`` int32 and
``meta`` ``(N,)`` int32.

:func:`mc_fused` sends CUDA tensors to the kernel (``csrc/mc_kernel.cu``)
and CPU tensors to :func:`mc_fused_torch`, its plain PyTorch twin; nothing
falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from bsdmg_tpu_torch.ops.cuda.csdf import SceneDescriptor, SdfFns, sdf_fns
from bsdmg_tpu_torch.ops.cuda.mesh_kernel import check_planes, fd4_grad, newton, unit_normal_fd4
from bsdmg_tpu_torch.ops.cuda.render_kernel import attach_scratch, library, scene_desc_c
from bsdmg_tpu_torch.ops.tables import MC_EDGE_MIDPOINTS

#: launches of the CUDA kernel in this process; the wrapper adds one per launch
LAUNCHES = 0

#: the kernel's source, relative to the repository root
SOURCE = "bsdmg_tpu_torch/csrc/mc_kernel.cu"

WINDINGS = ("vertex_mean", "centroid_fd4")


# ---------------------------------------------------------------------------
# plain PyTorch twin
# ---------------------------------------------------------------------------


def div3(t: torch.Tensor) -> torch.Tensor:
    """``t / 3`` by true division: PyTorch on the card turns a division by a
    Python scalar into a multiplication by its reciprocal, the kernel does
    not."""
    return t / torch.full_like(t, 3.0)


def winding(fns: SdfFns, v, nn, eps: float, centroid: bool):
    """The winding test of triangles ``v`` with vertex normals ``nn``, both
    ``(..., 3 vertices, 3)``: ``(dot, ambiguous)``. ``dot <= 0`` flips a
    triangle; ``ambiguous`` marks vertex normals that nearly cancel, where
    the sign of the vertex-mean ``dot`` is float noise."""
    e1 = v[..., 1, :] - v[..., 0, :]
    e2 = v[..., 2, :] - v[..., 0, :]
    gx = e1[..., 1] * e2[..., 2] - e1[..., 2] * e2[..., 1]
    gy = e1[..., 2] * e2[..., 0] - e1[..., 0] * e2[..., 2]
    gz = e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]
    if centroid:
        m = div3((v[..., 0, :] + v[..., 1, :]) + v[..., 2, :])
        ax, ay, az = fd4_grad(fns.value, m[..., 0], m[..., 1], m[..., 2], eps)
        return (gx * ax + gy * ay) + gz * az, torch.zeros_like(gx, dtype=torch.bool)
    a = (nn[..., 0, :] + nn[..., 1, :]) + nn[..., 2, :]
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    dot = (gx * ax + gy * ay) + gz * az
    g2 = (gx * gx + gy * gy) + gz * gz
    a2 = (ax * ax + ay * ay) + az * az
    return dot, dot * dot <= 1e-4 * g2 * a2


def _slot_nibbles(t0, t1):
    """``(N, 15)`` triangle-slot edge ids from the packed words (15 = none)."""
    lo = torch.stack([(t0 >> (4 * s)) & 15 for s in range(8)], dim=1)
    hi = torch.stack([(t1 >> (4 * s)) & 15 for s in range(7)], dim=1)
    return torch.cat([lo, hi], dim=1).long()


def mc_fused_torch(fns: SdfFns, lx, ly, lz, cross_bits, t0, t1, voxel_size: float, *,
                   budget: int, iters: int, tol: float, eps: float, use_grad: bool = True,
                   winding_normals: str = "vertex_mean", stats: dict | None = None):
    """Plain PyTorch version of kernel K6 on any device; returns ``(pos,
    nrm, dot, amb, meta)`` as the kernel does."""
    n = lx.shape[0]
    device = lx.device
    vs = float(voxel_size)
    bits = cross_bits & 0xFFF
    act = (bits[:, None] >> torch.arange(12, device=device)) & 1  # (N, 12)
    rank = torch.cumsum(act, dim=1) - act
    run = act.sum(dim=1)

    # project the crossing edges of rank < budget from their midpoints
    vox, edge = (act.bool() & (rank < budget)).nonzero(as_tuple=True)
    mid = torch.tensor(MC_EDGE_MIDPOINTS, device=device)[edge]
    sx, sy, sz = (l[vox] + vs * mid[:, a] for a, l in enumerate((lx, ly, lz)))
    px, py, pz = newton(
        fns, sx, sy, sz, torch.ones_like(vox), iters=iters, tol=tol, eps=eps,
        use_grad=use_grad, stats=stats,
    )
    qx, qy, qz = unit_normal_fd4(fns.value, px, py, pz, eps)
    lanes = rank[vox, edge]
    projected = torch.zeros((n, budget, 3), dtype=torch.float32, device=device)
    normals = torch.zeros_like(projected)
    projected[vox, lanes] = torch.stack([px, py, pz], dim=1)
    normals[vox, lanes] = torch.stack([qx, qy, qz], dim=1)

    # the 15 slots pick their edge's lane through its rank
    nib = _slot_nibbles(t0, t1)
    slot_rank = torch.where(nib < 12, rank.gather(1, nib.clamp(max=11)), budget)
    ok = slot_rank < budget
    lane = torch.where(ok, slot_rank, 0)[..., None].expand(-1, -1, 3)
    v = torch.where(ok[..., None], projected.gather(1, lane), 0.0).reshape(n, 5, 3, 3)
    nn = torch.where(ok[..., None], normals.gather(1, lane), 0.0).reshape(n, 5, 3, 3)
    tri_ok = ok.reshape(n, 5, 3).all(dim=-1)

    dot = torch.zeros((n, 5), dtype=torch.float32, device=device)
    amb = torch.zeros((n, 5), dtype=torch.bool, device=device)
    vi, ti = tri_ok.nonzero(as_tuple=True)
    if vi.numel():
        d, a = winding(fns, v[vi, ti], nn[vi, ti], eps, winding_normals == "centroid_fd4")
        dot[vi, ti] = d
        amb[vi, ti] = a
    flip = (tri_ok & (dot <= 0.0))[..., None, None]
    keep = tri_ok[..., None, None]
    pos = torch.where(keep, torch.where(flip, v.flip(2), v), 0.0)
    nrm = torch.where(keep, torch.where(flip, nn.flip(2), nn), 0.0)
    meta = torch.clamp_min(run - budget, 0) << 5
    meta = meta | (tri_ok.int() << torch.arange(5, device=device)).sum(dim=1)
    return (
        pos.reshape(n, 45), nrm.reshape(n, 45), dot, amb.int(), meta.int(),
    )


#: voxels a block of K6 lists the edges of, and its threads
#: (csrc/mc_kernel.cu kVoxels, kThreads)
BLOCK_VOXELS = 60
BLOCK_THREADS = 256


def edge_slots(cross_bits, budget: int):
    """K6's edge lists (``csrc/mc_kernel.cu``): a block of
    :data:`BLOCK_VOXELS` voxels lists its voxels' crossing edges of rank <
    ``budget``, each voxel's from the exclusive scan of ``min(popc(bits),
    budget)`` over the block, in rank order. Returns flat ``(voxel, edge,
    rank, slot)``, one entry per listed edge in the order of the blocks and
    their slots; a block's threads take its slots in turn."""
    n = cross_bits.shape[0]
    device = cross_bits.device
    act = ((cross_bits & 0xFFF)[:, None] >> torch.arange(12, device=device)) & 1
    rank = torch.cumsum(act, dim=1) - act
    listed = torch.clamp_max(act.sum(dim=1), budget)
    pad = -n % BLOCK_VOXELS
    per_block = torch.nn.functional.pad(listed, (0, pad)).reshape(-1, BLOCK_VOXELS)
    first = (torch.cumsum(per_block, dim=1) - per_block).reshape(-1)[:n]
    voxel, edge = (act.bool() & (rank < budget)).nonzero(as_tuple=True)
    r = rank[voxel, edge]
    return voxel, edge, r, first[voxel] + r


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


def _library() -> ctypes.CDLL:
    lib = library()
    lib.bsdmg_mc_fused.restype = ctypes.c_int
    lib.bsdmg_mc_fused.argtypes = (
        [ctypes.c_void_p] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
           ctypes.c_float, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 6
    )
    return lib


def _mc_cuda(desc_c, planes, voxel_size: float, params, out) -> None:
    """K6 from a prepared ``SceneDesc`` struct into preallocated outputs:
    ``planes`` = ``(lx, ly, lz, cross_bits, t0, t1)``, ``params`` =
    ``(budget, iters, tol, eps, use_grad, centroid_winding)``, ``out`` =
    ``(pos, nrm, dot, amb, meta)``."""
    global LAUNCHES
    lib = _library()
    device = planes[0].device
    budget, iters, tol, eps, use_grad, centroid = params
    threads = -(-planes[0].numel() // BLOCK_VOXELS) * BLOCK_THREADS
    keep = attach_scratch(desc_c, threads, device, grad=True)  # held until enqueued
    with torch.cuda.device(device):
        err = lib.bsdmg_mc_fused(
            ctypes.addressof(desc_c), *(p.data_ptr() for p in planes), float(voxel_size),
            planes[0].numel(), int(budget), int(iters), float(tol), float(eps), int(use_grad),
            int(centroid), *(o.data_ptr() for o in out),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"marching-cubes kernel launch failed: cudaError {err} "
            f"({lib.bsdmg_error_string(err).decode()})"
        )
    LAUNCHES += 1


def mc_params(budget: int, iters: int, tol: float, eps: float, use_grad: bool = True,
              winding_normals: str = "vertex_mean") -> tuple:
    """The ``params`` of :func:`_mc_cuda` from :func:`mc_fused`'s keywords."""
    return (budget, iters, tol, eps, use_grad, winding_normals == "centroid_fd4")


def mc_outputs(n: int, device) -> tuple:
    """Uninitialised ``(pos, nrm, dot, amb, meta)`` for ``n`` voxels."""
    return (torch.empty((n, 45), dtype=torch.float32, device=device),
            torch.empty((n, 45), dtype=torch.float32, device=device),
            torch.empty((n, 5), dtype=torch.float32, device=device),
            torch.empty((n, 5), dtype=torch.int32, device=device),
            torch.empty((n,), dtype=torch.int32, device=device))


def mc_fused_cuda(desc: SceneDescriptor, lx, ly, lz, cross_bits, t0, t1, voxel_size: float, *,
                  budget: int, iters: int, tol: float, eps: float, use_grad: bool = True,
                  winding_normals: str = "vertex_mean"):
    """Kernel K6 on CUDA tensors; raises if the launch fails."""
    _check_inputs(lx, ly, lz, cross_bits, t0, t1)
    out = mc_outputs(lx.shape[0], lx.device)
    if lx.shape[0]:
        _mc_cuda(scene_desc_c(desc, device=lx.device), (lx, ly, lz, cross_bits, t0, t1), voxel_size,
                 mc_params(budget, iters, tol, eps, use_grad, winding_normals), out)
    return out


def _check_inputs(lx, ly, lz, cross_bits, t0, t1) -> None:
    f32, i32 = torch.float32, torch.int32
    check_planes(lx=(lx, f32), ly=(ly, f32), lz=(lz, f32), cross_bits=(cross_bits, i32),
                 t0=(t0, i32), t1=(t1, i32))


def mc_fused(scene, lx, ly, lz, cross_bits, t0, t1, voxel_size: float, *, budget: int,
             iters: int, tol: float, eps: float, use_grad: bool = True,
             winding_normals: str = "vertex_mean"):
    """Finish marching cubes on flat per-voxel planes of ``scene`` (a
    :class:`SceneDescriptor`, or :class:`SdfFns` on the CPU): voxel lower
    corners ``lx, ly, lz`` (float32), crossing bits and packed slot edge ids
    ``t0`` (slots 0-7) and ``t1`` (slots 8-14), 4 bits each, 15 for an empty
    slot (int32). CUDA tensors go through kernel K6, CPU tensors through
    :func:`mc_fused_torch`. Returns ``(pos, nrm, dot, amb, meta)``."""
    if winding_normals not in WINDINGS:
        raise ValueError(f"winding_normals must be one of {WINDINGS}, got {winding_normals!r}")
    if not 1 <= budget <= 12:
        raise ValueError(f"budget must lie in 1..12, got {budget}")
    kwargs = dict(budget=budget, iters=iters, tol=tol, eps=eps, use_grad=use_grad,
                  winding_normals=winding_normals)
    if lx.device.type == "cuda":
        if not isinstance(scene, SceneDescriptor):
            raise NotImplementedError("kernel K6 evaluates scene descriptors only")
        return mc_fused_cuda(scene, lx, ly, lz, cross_bits, t0, t1, voxel_size, **kwargs)
    _check_inputs(lx, ly, lz, cross_bits, t0, t1)
    if lx.device.type == "cpu":
        return mc_fused_torch(
            sdf_fns(scene), lx, ly, lz, cross_bits, t0, t1, voxel_size, **kwargs
        )
    raise ValueError(f"unsupported device {lx.device}")
