"""Newton edge projection: the wrapper of CUDA kernel K7 and its plain twin.

Counterpart of ``bsdmg_tpu/ops/pallas/mesh_kernel.py::project_edges_pallas``,
which the staged marching-cubes path runs (``mesh --interpolate-edges``).
Per point: at most ``iters`` Newton steps ``p <- p - sd * g / |g|``, ``g`` the
analytic gradient (``use_grad``) or the fd4 one, a point stopping after the
step at which ``|sd| <= tol`` (inactive points do not move); then the fd4
unit normal at the final point, for every point.

:func:`project_edges` sends CUDA tensors to the kernel
(``csrc/project_kernel.cu``) and CPU tensors to :func:`project_edges_torch`,
its plain PyTorch twin; nothing falls back from one to the other. The
Newton and normal helpers here are also the twins of the device functions
that K6 shares (``csrc/project.cuh``).
"""

from __future__ import annotations

import ctypes

import torch

from bsdmg_tpu_torch.ops.cuda.csdf import SceneDescriptor, SdfFns, sdf_fns
from bsdmg_tpu_torch.ops.cuda.render_kernel import attach_scratch, library, scene_desc_c

#: launches of the CUDA kernel in this process; the wrapper adds one per launch
LAUNCHES = 0

#: the kernel's source, relative to the repository root
SOURCE = "bsdmg_tpu_torch/csrc/project_kernel.cu"


# ---------------------------------------------------------------------------
# plain PyTorch twin
# ---------------------------------------------------------------------------


def fd4_grad(csdf, x, y, z, eps: float):
    """4th-order central-difference gradient, unnormalised, 12 evaluations
    (mesh_kernel.py::_grad_fd4)."""

    def deriv(fp2, fp1, fm1, fm2):
        return -fp2 + 8.0 * fp1 - 8.0 * fm1 + fm2

    gx = deriv(
        csdf(x + 2 * eps, y, z), csdf(x + eps, y, z),
        csdf(x - eps, y, z), csdf(x - 2 * eps, y, z),
    )
    gy = deriv(
        csdf(x, y + 2 * eps, z), csdf(x, y + eps, z),
        csdf(x, y - eps, z), csdf(x, y - 2 * eps, z),
    )
    gz = deriv(
        csdf(x, y, z + 2 * eps), csdf(x, y, z + eps),
        csdf(x, y, z - eps), csdf(x, y, z - 2 * eps),
    )
    return gx, gy, gz


def inv_norm(gx, gy, gz):
    """``1/|g|`` with the 1e-24 floor of the JAX kernels, by a correctly
    rounded sqrt and division (the kernels do not use ``rsqrtf``)."""
    return 1.0 / torch.sqrt(torch.clamp_min(gx * gx + gy * gy + gz * gz, 1e-24))


def unit_normal_fd4(csdf, x, y, z, eps: float):
    gx, gy, gz = fd4_grad(csdf, x, y, z, eps)
    inv = inv_norm(gx, gy, gz)
    return gx * inv, gy * inv, gz * inv


def newton(fns: SdfFns, x, y, z, active, *, iters: int, tol: float, eps: float,
           use_grad: bool, stats: dict | None = None):
    """Newton projection of the ``active`` points of flat planes; returns
    new ``(x, y, z)``. The points still moving are gathered each step, so
    the cost follows them; every per-point operation is the kernels'
    (``newton_project`` in csrc/project.cuh). ``stats``, if given, gets
    ``"newton_steps"``, the steps taken over all points (added to what it
    holds), and ``"newton_point_steps"``, each point's steps (int32)."""
    x, y, z = x.clone(), y.clone(), z.clone()
    live = active.nonzero().squeeze(1)
    steps = 0
    taken = torch.zeros(x.shape, dtype=torch.int32, device=x.device) if stats is not None else None
    for _ in range(iters):
        if not live.numel():
            break
        px, py, pz = x[live], y[live], z[live]
        if use_grad:
            sd, gx, gy, gz = fns.value_and_grad(px, py, pz)
        else:
            sd = fns.value(px, py, pz)
            gx, gy, gz = fd4_grad(fns.value, px, py, pz, eps)
        inv = inv_norm(gx, gy, gz)
        x[live] = px - sd * gx * inv
        y[live] = py - sd * gy * inv
        z[live] = pz - sd * gz * inv
        steps += live.numel()
        if taken is not None:
            taken[live] += 1
        live = live[torch.abs(sd) > tol]
    if stats is not None:
        stats["newton_steps"] = stats.get("newton_steps", 0) + steps
        stats["newton_point_steps"] = taken
    return x, y, z


def project_edges_torch(fns: SdfFns, x, y, z, active, *, iters: int, tol: float,
                        eps: float, use_grad: bool = True, stats: dict | None = None):
    """Plain PyTorch version of kernel K7 on any device: ``(px, py, pz, nx,
    ny, nz)`` flat planes."""
    px, py, pz = newton(
        fns, x, y, z, active, iters=iters, tol=tol, eps=eps, use_grad=use_grad, stats=stats
    )
    return (px, py, pz, *unit_normal_fd4(fns.value, px, py, pz, eps))


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


def _library() -> ctypes.CDLL:
    lib = library()
    lib.bsdmg_project_edges.restype = ctypes.c_int
    lib.bsdmg_project_edges.argtypes = (
        [ctypes.c_void_p] * 5
        + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int]
        + [ctypes.c_void_p] * 7
    )
    return lib


def _project_cuda(desc_c, planes, params, out) -> None:
    """K7 from a prepared ``SceneDesc`` struct into preallocated outputs:
    ``planes`` = ``(x, y, z, active)``, ``params`` = ``(iters, tol, eps,
    use_grad)``, ``out`` = ``(px, py, pz, nx, ny, nz)``."""
    global LAUNCHES
    lib = _library()
    device = planes[0].device
    iters, tol, eps, use_grad = params
    threads = -(-planes[0].numel() // 128) * 128
    keep = attach_scratch(desc_c, threads, device, grad=True)  # held until enqueued
    with torch.cuda.device(device):
        err = lib.bsdmg_project_edges(
            ctypes.addressof(desc_c), *(p.data_ptr() for p in planes), planes[0].numel(),
            int(iters), float(tol), float(eps), int(use_grad), *(o.data_ptr() for o in out),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"projection kernel launch failed: cudaError {err} "
            f"({lib.bsdmg_error_string(err).decode()})"
        )
    LAUNCHES += 1


def project_edges_cuda(desc: SceneDescriptor, x, y, z, active, *, iters: int, tol: float,
                       eps: float, use_grad: bool = True):
    """Kernel K7 on CUDA tensors; raises if the launch fails."""
    check_planes(x=(x, torch.float32), y=(y, torch.float32), z=(z, torch.float32),
                 active=(active, torch.int32))
    outs = tuple(torch.empty_like(x) for _ in range(6))
    if x.shape[0]:
        _project_cuda(scene_desc_c(desc, device=x.device), (x, y, z, active), (iters, tol, eps, use_grad), outs)
    return outs


def check_planes(**planes) -> None:
    """Each ``name=(tensor, dtype)`` must be a contiguous 1-D tensor of that
    dtype, all of one length and on one device; raises otherwise."""
    first, (ref, _) = next(iter(planes.items()))
    for name, (t, dtype) in planes.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != 1 or t.shape != ref.shape:
            raise ValueError(f"{name} must have shape {tuple(ref.shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, {first} on {ref.device}")


def project_edges(scene, x, y, z, active, *, iters: int, tol: float, eps: float,
                  use_grad: bool = True):
    """Newton-project flat ``(M,)`` float32 planes onto the isosurface of
    ``scene`` (a :class:`SceneDescriptor`, or :class:`SdfFns` on the CPU);
    ``active`` is int32. CUDA tensors go through kernel K7, CPU tensors
    through :func:`project_edges_torch`. Returns ``(px, py, pz, nx, ny,
    nz)``: projected points and fd4 unit normals there."""
    kwargs = dict(iters=iters, tol=tol, eps=eps, use_grad=use_grad)
    if x.device.type == "cuda":
        if not isinstance(scene, SceneDescriptor):
            raise NotImplementedError("kernel K7 evaluates scene descriptors only")
        return project_edges_cuda(scene, x, y, z, active, **kwargs)
    check_planes(x=(x, torch.float32), y=(y, torch.float32), z=(z, torch.float32),
                 active=(active, torch.int32))
    if x.device.type == "cpu":
        return project_edges_torch(sdf_fns(scene), x, y, z, active.bool(), **kwargs)
    raise ValueError(f"unsupported device {x.device}")
