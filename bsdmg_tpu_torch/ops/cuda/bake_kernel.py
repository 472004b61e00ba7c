"""The mesh-asset bake: the wrapper of the CUDA bake kernel and its plain twin.

The signed distance of a triangle mesh at every node of a lattice: Eberly's
exact point-triangle distance, negative where the generalized winding
number exceeds 1/2 (``models/mesh_sdf.py``). The JAX package bakes in XLA
(``bsdmg_tpu/models/mesh_sdf.py::mesh_signed_distance``), no Pallas kernel;
on the card the port bakes in ``csrc/bake_kernel.cu``, one thread per node,
the triangles staged through shared memory.

:func:`bake` sends CUDA tensors to the kernel and CPU tensors to
:func:`bake_torch`, the twin (``mesh_signed_distance`` over the lattice's
nodes); nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bsdmg_tpu_torch.models.mesh_sdf import mesh_signed_distance
from bsdmg_tpu_torch.ops.cuda.build import load_library
from bsdmg_tpu_torch.ops.cuda.grid_box import MAX_GRID_RESOLUTION
from bsdmg_tpu_torch.ops.cuda.mesh_kernel import check_planes

#: launches of the CUDA kernel in this process; the wrapper adds one per launch
LAUNCHES = 0

#: the kernel's source, relative to the repository root
SOURCE = "bsdmg_tpu_torch/csrc/bake_kernel.cu"


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
                               + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    lib.bsdmg_error_string.restype = ctypes.c_char_p
    lib.bsdmg_error_string.argtypes = [ctypes.c_int]
    return lib


def _bake_cuda(axes, tris, out) -> None:
    """One launch from prepared inputs: ``axes`` three ``(R,)`` planes,
    ``tris`` ``(va, vb, vc)``, into ``out`` ``(R^3,)``."""
    global LAUNCHES
    lib = _library()
    device = out.device
    with torch.cuda.device(device):
        err = lib.bsdmg_bake(*(a.data_ptr() for a in axes), axes[0].numel(),
                             *(t.data_ptr() for t in tris), tris[0].shape[0], out.data_ptr(),
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


def bake_cuda(axes, vertices, faces) -> torch.Tensor:
    """The kernel on the CUDA axes' device; raises if the launch fails."""
    tris = triangles(vertices, faces, axes[0].device)
    _check(axes, tris)
    r = axes[0].numel()
    out = torch.empty(r**3, dtype=torch.float32, device=axes[0].device)
    _bake_cuda(axes, tris, out)
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
