"""Mesh-asset (grid SDF) render: the wrappers of CUDA kernels K8, K9 and P1,
their plain twins, and the host functions of the JAX package's
``bsdmg_tpu/ops/pallas/grid_kernel.py``.

* **K8** (``grid_kernel.py::_grid_trace_kernel``): a sphere trace over a
  grid SDF sampled by eight gathers (:data:`INTERP_F32`); here also the fine
  finish of the contraction route, resumed.
* **K9** (``_contraction_kernel``): one resumable level of the contraction
  ladder, sampled by hat weights against an exact (:data:`HAT_F32`) or a
  bf16 lower-bound table (:data:`HAT_BF16`).
* **P1** (``tools/probe_mxu.py::kernel``): the sampler applied to points;
  the render evaluates the twelve fd4 stencil points of every hit with it.

Both are in ``csrc/grid_kernel.cu`` over the samplers of
``csrc/grid_sdf.cuh``. :func:`grid_march` and :func:`grid_sample` send CUDA
tensors to the kernels and CPU tensors to their plain twins,
:func:`grid_march_torch` and :func:`grid_sample_torch`; nothing falls back
from one to the other.

The routes are the JAX package's: ``render_image_grid(mode="contraction")``
(the CLI's) marches a 32^3 bf16 lower-bound mip, then the exact table when
R <= 64 or a 64^3 bf16 mip and the fine finish; ``mode="gather"`` marches
the whole table when R <= 64 and R^3 % 128 == 0, else a 64^3 mip and the
fine finish. Ray data is flat, one element per pixel: the TPU's (M, 128)
swizzle and (m4, 512) regrouping are layout and are not carried over. K8
and K9 take the rays in 16x8 tiles of the frame (:func:`tile_order`; the
last axis of ``cone`` is a row) and write each at its flat index; resumed,
K8 marches each tile's active rays only (:func:`tile_lists`). K9 reads a
level from its :func:`cell_table`, which :func:`make_contraction_levels`
builds once. Two differences are deliberate: the fine finish is one
resumed launch, in place on the route's state (:func:`grid_march_into`),
where the JAX package compacts the resumed rays into three rounds of
shrinking cap (their results are the same wherever that cap does not
overflow); and there is no backend probe, since on the card the kernels
always run.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from bsdmg_tpu_torch.config import MarchConfig
from bsdmg_tpu_torch.models.mesh_sdf import (
    SdfGrid,
    _outside_distance,
    _outside_step,
    box_f32,
    coarsen_grid_lower,
    make_grid_interp_csdf,
)
from bsdmg_tpu_torch.ops.cuda.build import load_library
from bsdmg_tpu_torch.ops.cuda.grid_box import GridBoxC, grid_box_c
from bsdmg_tpu_torch.ops.cuda.mesh_kernel import check_planes
from bsdmg_tpu_torch.ops.cuda.render_kernel import _march
from bsdmg_tpu_torch.ops.shade import shade_planes
from bsdmg_tpu_torch.ops.trace import COLLISION, STEP_LIMIT

#: launches of each kernel in this process; the wrappers add one per launch
LAUNCHES = {"K8": 0, "K9": 0, "P1": 0}

#: the kernels' source, relative to the repository root
SOURCE = "bsdmg_tpu_torch/csrc/grid_kernel.cu"

#: sampler kinds (csrc/grid_kernel.cu)
INTERP_F32, HAT_F32, HAT_BF16 = 0, 1, 2

#: resolution of the ladder's second lower-bound mip and of the gather
#: route's mip, and the largest table either marches whole
#: (grid_kernel.py::MAX_VMEM_RESOLUTION)
MID_RESOLUTION = 64

#: bf16 rounding bound of the lower-bound mip levels (grid_kernel.py
#: _BF16_MARGIN): the table and the weights each round by 2^-9 relative
_BF16_MARGIN = 3.0 * 2.0**-9


class Sampler(NamedTuple):
    """A grid SDF as a kernel samples it: the sampler ``kind``, the flat
    ``(R^3,)`` table (float32, or bfloat16 for :data:`HAT_BF16`) on its
    device, the box, the float32 ``margin`` subtracted from a hat sample,
    and for a level of K9, the table's :func:`cell_table`, which K9 reads
    (made at each launch when it is missing)."""

    kind: int
    table: torch.Tensor
    r: int
    lo: tuple
    hi: tuple
    margin: float = 0.0
    cells: torch.Tensor | None = None


def interp_sampler(grid: SdfGrid) -> Sampler:
    """The grid's eight-gather trilinear sampler (K8's, P1's in the render);
    K9's are the levels of :func:`make_contraction_levels`."""
    return Sampler(INTERP_F32, grid.values.reshape(-1), grid.resolution, grid.lo, grid.hi)


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------


def _hat(c, a):
    """Tent weight ``max(0, 1 - |c - a|)`` of coordinates ``c`` at index ``a``."""
    return torch.clamp_min(1.0 - torch.abs(c - a), 0.0)


#: a cell's eight corners, in the order ``csrc/grid_sdf.cuh::hat_sample``
#: sums them: ``(dx, dy, dz)`` offsets from the cell's lower corner
CELL_CORNERS = ((0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0), (0, 0, 1), (0, 1, 1), (1, 0, 1),
                (1, 1, 1))


def cell_table(table, r: int):
    """K9's cell-packed copy of a flat ``(R^3,)`` table: for each cell
    ``(x0, y0, z0)`` with coordinates up to ``R - 2`` (a hat sample's clamp
    to ``R - 1 - 1e-4`` keeps ``x0 + 1`` in the table), its eight corners in
    :data:`CELL_CORNERS` order, at ``((x0 * (R - 1) + y0) * (R - 1) + z0) *
    8``; flat, in the table's dtype (16 B a cell in bf16, 32 B in float32)."""
    if r < 2:
        raise ValueError(f"a cell-packed table needs R >= 2, got {r}")
    t, m = table.reshape(r, r, r), r - 1
    return torch.stack([t[dx:dx + m, dy:dy + m, dz:dz + m] for dx, dy, dz in CELL_CORNERS],
                       dim=-1).reshape(-1).contiguous()


def make_contraction_csdf(table, r: int, lo, hi, *, bf16: bool, margin: float,
                          cells: bool = False):
    """Component-form hat-weight trilinear csdf (grid_kernel.py::
    make_contraction_csdf) over the flat ``(R^3,)`` table, in the order of
    ``csrc/grid_sdf.cuh::hat_sample``: the two non-zero weights of each
    axis, the four (x, y) corners summed in ascending ``x*R + y`` order
    (weights rounded to bf16 with a bf16 table, products in float32), then
    the two z planes, the outside step and ``- margin``. With ``cells`` the
    table is its :func:`cell_table` and each corner is read from its cell,
    as K9 reads it."""
    lo, hi, scale, clip_hi = box_f32(r, lo, hi)
    m = r - 1

    def weights(v, a):
        c = torch.clamp((v - lo[a]) * scale[a], 0.0, clip_hi)
        c0 = torch.floor(c)
        return c0.to(torch.int64), _hat(c, c0), _hat(c, c0 + 1.0)

    def xy_weight(w):
        return w.to(torch.bfloat16).float() if bf16 else w

    def csdf(x, y, z):
        x0, wx0, wx1 = weights(x, 0)
        y0, wy0, wy1 = weights(y, 1)
        z0, wz0, wz1 = weights(z, 2)
        w00, w01 = xy_weight(wx0 * wy0), xy_weight(wx0 * wy1)
        w10, w11 = xy_weight(wx1 * wy0), xy_weight(wx1 * wy1)

        def corner(k):
            if cells:
                return table[((x0 * m + y0) * m + z0) * 8 + k].float()
            dx, dy, dz = CELL_CORNERS[k]
            return table[((x0 + dx) * r + y0 + dy) * r + z0 + dz].float()

        def v(k):
            return ((corner(k) * w00 + corner(k + 1) * w01) + corner(k + 2) * w10) \
                + corner(k + 3) * w11

        interior = v(0) * wz0 + v(4) * wz1
        return _outside_step(interior, _outside_distance(x, y, z, lo, hi)) - margin

    return csdf


def tile_order(height: int, width: int) -> torch.Tensor:
    """The flat ray index K9's threads take, in launch order
    (``csrc/grid_kernel.cu::tile_ray``): the frame in 16x8 tiles, row by
    row, each tile in four 8x4 warp patches (left top, right top, left
    bottom, right bottom), each patch row by row; slots past the frame are
    left out."""
    ty, tx, q, lane = torch.meshgrid(torch.arange(-(-height // 8)), torch.arange(-(-width // 16)),
                                     torch.arange(4), torch.arange(32), indexing="ij")
    px = tx * 16 + (q & 1) * 8 + (lane & 7)
    py = ty * 8 + (q >> 1) * 4 + (lane >> 3)
    inside = (px < width) & (py < height)
    return (py * width + px)[inside]


def tile_lists(active, height: int, width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The rays a resumed K8 launch marches, in the order its threads take
    them (``csrc/grid_kernel.cu::grid_march_kernel``): each 16x8 tile's
    active rays in :func:`tile_order`'s thread order, listed from thread 0
    of the tile's block up. Returns the flat ray indices, tile by tile, and
    each tile's count."""
    order = tile_order(height, width).to(active.device)
    listed = order[active.reshape(-1)[order] != 0]
    tiles = (listed // width // 8) * (-(-width // 16)) + (listed % width) // 16
    return listed, torch.bincount(tiles, minlength=-(-height // 8) * -(-width // 16))


def sampler_csdf(s: Sampler):
    """The plain PyTorch version of a kernel's sampler."""
    if s.kind == INTERP_F32:
        return make_grid_interp_csdf(lambda ix, iy, iz: s.table[(ix * s.r + iy) * s.r + iz],
                                     s.r, s.lo, s.hi)
    return make_contraction_csdf(s.table, s.r, s.lo, s.hi, bf16=s.kind == HAT_BF16,
                                 margin=s.margin)


def probe_contraction_torch(t2, cx, cy, cz):
    """P1's body (probe_mxu.py:19-26) in plain PyTorch: hat weights of
    ``(1, G)`` grid coordinates against a ``(R, R^2)`` table ``t2[z, x*R +
    y]``, the ``(R, R^2) @ (R^2, G)`` contraction, then the sum over z."""
    r = t2.shape[0]
    a = torch.arange(r, dtype=torch.float32, device=t2.device)[:, None]
    wx, wy, wz = _hat(cx, a), _hat(cy, a), _hat(cz, a)
    wxy = wx.repeat_interleave(r, dim=0) * wy.repeat(r, 1)
    return torch.sum((t2 @ wxy) * wz, dim=0, keepdim=True)


def _flat_rays(origins, directions, cone):
    return (
        *(origins[..., a].reshape(-1) for a in range(3)),
        *(directions[..., a].reshape(-1) for a in range(3)),
        cone.reshape(-1),
    )


def grid_march_torch(sampler: Sampler, origins, directions, cone,
                     config: MarchConfig = MarchConfig(), *, active=None, depth0=None,
                     steps0=None, outcome0=None, budget: int | None = None):
    """Plain PyTorch version of K8 and K9: the resumable ``_march`` over the
    sampler's twin. Returns flat ``(depth, steps, outcome)``."""
    ox, oy, oz, dx, dy, dz, c = _flat_rays(origins, directions, cone)
    n = c.numel()
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=c.device)
        depth = torch.zeros_like(c)
    else:
        active, depth = active.bool(), depth0.clone()
    limit = torch.full_like(c, config.depth_limit)
    steps, outcome, *_ = _march(
        sampler_csdf(sampler), config, ox, oy, oz, dx, dy, dz, c, active, depth, limit,
        steps0=steps0, outcome0=outcome0, budget=budget,
    )
    return depth, steps, outcome


def grid_sample_torch(sampler: Sampler, x, y, z):
    """Plain PyTorch version of P1: the sampler's twin on flat planes."""
    return sampler_csdf(sampler)(x, y, z)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


class _GridMarchC(ctypes.Structure):
    """``GridMarch`` of csrc/grid_kernel.cu."""

    _fields_ = [
        ("collision_distance", ctypes.c_float),
        ("depth_limit", ctypes.c_float),
        ("step_cap", ctypes.c_int),
    ]


def grid_march_c(config: MarchConfig, budget: int | None) -> _GridMarchC:
    cap = config.step_limit if budget is None else min(int(budget), config.step_limit)
    return _GridMarchC(float(np.float32(config.collision_distance)),
                       float(np.float32(config.depth_limit)), cap)


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel library with K8/K9/P1's entry points typed and the
    structures' layouts checked against the source's (once per process)."""
    lib = load_library()
    lib.bsdmg_grid_march.restype = ctypes.c_int
    lib.bsdmg_grid_march.argtypes = (
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float]
        + [ctypes.c_void_p] * 11 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    lib.bsdmg_grid_sample.restype = ctypes.c_int
    lib.bsdmg_grid_sample.argtypes = (
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float]
        + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    )
    lib.bsdmg_error_string.restype = ctypes.c_char_p
    lib.bsdmg_error_string.argtypes = [ctypes.c_int]
    for name, struct in (("bsdmg_grid_box_size", GridBoxC),
                         ("bsdmg_grid_march_size", _GridMarchC)):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int, []
        if fn() != ctypes.sizeof(struct):
            raise RuntimeError(
                f"{struct.__doc__.split()[0]} layout mismatch: {fn()} bytes in {SOURCE}, "
                f"{ctypes.sizeof(struct)} in {__name__}"
            )
    return lib


def _check_sampler(s: Sampler, device) -> None:
    if s.kind not in (INTERP_F32, HAT_F32, HAT_BF16):
        raise ValueError(f"unknown sampler kind {s.kind}")
    dtype = torch.bfloat16 if s.kind == HAT_BF16 else torch.float32
    check_planes(table=(s.table, dtype))
    if s.table.numel() != s.r**3:
        raise ValueError(f"table has {s.table.numel()} values, not {s.r}^3")
    if s.table.device != device:
        raise ValueError(f"table is on {s.table.device}, the rays on {device}")
    if s.cells is not None:
        check_planes(cells=(s.cells, dtype))
        if s.kind == INTERP_F32 or s.cells.numel() != 8 * (s.r - 1) ** 3:
            raise ValueError(f"cells must be a hat table's cell_table, {8 * (s.r - 1) ** 3} "
                             f"values, got {s.cells.numel()}")
        if s.cells.device != device:
            raise ValueError(f"cells are on {s.cells.device}, the rays on {device}")


def march_table(s: Sampler) -> torch.Tensor:
    """The table a grid march launch reads: K8 the raw table, K9 the
    level's cells (made here when the sampler has none)."""
    if s.kind == INTERP_F32:
        # K8 takes x0 + 1 <= R - 1 from the clamp (csrc/grid_sdf.cuh::InterpGather)
        if not box_f32(s.r, s.lo, s.hi)[3] < s.r - 1:
            raise ValueError(f"R = {s.r}: the clamp R - 1 - 1e-4 rounds to R - 1 in float32")
        return s.table
    table = cell_table(s.table, s.r) if s.cells is None else s.cells
    if table.data_ptr() % 16:
        raise ValueError("K9 reads its cells 16 bytes at a time: they must be 16-byte aligned")
    return table


def _check_rays(origins, directions, cone, active, depth0, steps0, outcome0) -> int:
    """Checks the rays and the resume state; returns the ray count."""
    if not isinstance(cone, torch.Tensor):
        raise TypeError(f"cone must be a torch.Tensor, got {type(cone).__name__}")
    state = dict(active=(active, torch.int32), depth0=(depth0, torch.float32),
                 steps0=(steps0, torch.int32), outcome0=(outcome0, torch.int32))
    given = [k for k, (v, _) in state.items() if v is not None]
    if given and len(given) != len(state):
        raise ValueError(f"a resumed march needs all of {list(state)}, got only {given}")
    planes = dict(origins=(origins, torch.float32, (*cone.shape, 3)),
                  directions=(directions, torch.float32, (*cone.shape, 3)),
                  cone=(cone, torch.float32, cone.shape))
    if given:
        # the state may come flat from an earlier march, or shaped like cone
        for k, (v, dt) in state.items():
            flat = torch.is_tensor(v) and v.numel() == cone.numel()
            planes[k] = (v, dt, v.shape if flat else cone.shape)
    for name, (t, dtype, shape) in planes.items():
        if not isinstance(t, torch.Tensor) or t.dtype != dtype:
            raise TypeError(f"{name} must be a {dtype} tensor")
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {tuple(shape)} tensor, "
                             f"got {tuple(t.shape)}")
        if t.device != cone.device:
            raise ValueError(f"{name} is on {t.device}, cone on {cone.device}")
    return cone.numel()


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: cudaError {err} ({lib.bsdmg_error_string(err).decode()})"
        )


def _march_cuda(sampler: Sampler, box, march, origins, directions, cone, state, out) -> None:
    """K8 or K9 from prepared ``GridBox``/``GridMarch`` structs into the flat
    ``(depth, steps, outcome)`` planes ``out``; ``state`` is ``()`` (a fresh
    march) or the flat ``(active, depth0, steps0, outcome0)`` planes. The
    frame is ``cone``'s shape: its last axis is a row. Resumed, K8 writes
    only the active rays' outputs, so ``out`` may be ``(depth0, steps0,
    outcome0)`` themselves (:func:`grid_march_into`); K9 writes every ray's."""
    lib = library()
    table = march_table(sampler)
    ptrs = [t.data_ptr() for t in state] if state else [None] * 4
    width = cone.shape[-1] if cone.dim() else 1
    with torch.cuda.device(cone.device):
        err = lib.bsdmg_grid_march(
            sampler.kind, ctypes.addressof(box), table.data_ptr(), sampler.margin,
            ctypes.addressof(march), origins.data_ptr(), directions.data_ptr(), cone.data_ptr(),
            *ptrs, *(t.data_ptr() for t in out), cone.numel(), width,
            torch.cuda.current_stream(cone.device).cuda_stream,
        )
    _raise_on(err, lib, "grid march")
    LAUNCHES["K8" if sampler.kind == INTERP_F32 else "K9"] += 1


def grid_march_cuda(sampler: Sampler, origins, directions, cone,
                    config: MarchConfig = MarchConfig(), *, active=None, depth0=None,
                    steps0=None, outcome0=None, budget: int | None = None):
    """Kernel K8 (an :data:`INTERP_F32` sampler) or K9 (a hat sampler) on
    CUDA tensors; raises if the launch fails. ``active`` (int32),
    ``depth0``, ``steps0`` and ``outcome0`` are all None (a fresh march from
    depth 0) or all flat planes. Returns flat ``(depth, steps, outcome)``."""
    n = _check_rays(origins, directions, cone, active, depth0, steps0, outcome0)
    _check_sampler(sampler, cone.device)
    device = cone.device
    if active is not None and sampler.kind == INTERP_F32:
        # K8 writes only the active rays: the others keep copies of their state
        out = tuple(t.reshape(-1).clone() for t in (depth0, steps0, outcome0))
    else:
        out = (torch.empty(n, dtype=torch.float32, device=device),
               torch.empty(n, dtype=torch.int32, device=device),
               torch.empty(n, dtype=torch.int32, device=device))
    if n:
        state = () if active is None else (active, depth0, steps0, outcome0)
        box = grid_box_c(sampler.r, sampler.lo, sampler.hi)
        _march_cuda(sampler, box, grid_march_c(config, budget), origins, directions, cone, state,
                    out)
    return out


def grid_march_into(sampler: Sampler, origins, directions, cone,
                    config: MarchConfig = MarchConfig(), *, active, depth, steps, outcome,
                    budget: int | None = None) -> None:
    """The resumed march of an :data:`INTERP_F32` sampler (K8) in place: the
    active rays (``active``, int32) march from ``depth``/``steps`` and their
    depth, steps and outcome are written back into those planes; the other
    rays' are neither read nor written. The planes are flat or shaped like
    ``cone`` and belong to the caller, as a route's state does. CUDA tensors
    go through K8, CPU tensors through :func:`grid_march_torch`."""
    if sampler.kind != INTERP_F32:
        raise ValueError("only K8 (an INTERP_F32 sampler) marches in place")
    _check_rays(origins, directions, cone, active, depth, steps, outcome)
    _check_sampler(sampler, cone.device)
    planes = tuple(t.reshape(-1) for t in (depth, steps, outcome))
    if cone.device.type == "cuda":
        if cone.numel():
            box = grid_box_c(sampler.r, sampler.lo, sampler.hi)
            _march_cuda(sampler, box, grid_march_c(config, budget), origins, directions, cone,
                        (active.reshape(-1), *planes), planes)
        return
    if cone.device.type != "cpu":
        raise ValueError(f"unsupported device {cone.device}")
    result = grid_march_torch(sampler, origins, directions, cone, config, active=active,
                              depth0=depth, steps0=steps, outcome0=outcome, budget=budget)
    for plane, value in zip(planes, result):
        plane.copy_(value)


def _sample_cuda(sampler: Sampler, box, x, y, z, out) -> None:
    """P1 from a prepared ``GridBox`` struct into the flat plane ``out``."""
    lib = library()
    with torch.cuda.device(x.device):
        err = lib.bsdmg_grid_sample(
            sampler.kind, ctypes.addressof(box), sampler.table.data_ptr(), sampler.margin,
            x.data_ptr(), y.data_ptr(), z.data_ptr(), out.data_ptr(), x.numel(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on(err, lib, "grid sample")
    LAUNCHES["P1"] += 1


def grid_sample_cuda(sampler: Sampler, x, y, z):
    """Kernel P1 on CUDA tensors: the sampler at flat float32 planes."""
    check_planes(x=(x, torch.float32), y=(y, torch.float32), z=(z, torch.float32))
    _check_sampler(sampler, x.device)
    out = torch.empty_like(x)
    if x.numel():
        _sample_cuda(sampler, grid_box_c(sampler.r, sampler.lo, sampler.hi), x, y, z, out)
    return out


def grid_march(sampler: Sampler, origins, directions, cone,
               config: MarchConfig = MarchConfig(), *, active=None, depth0=None, steps0=None,
               outcome0=None, budget: int | None = None):
    """Sphere-trace rays (``origins``/``directions`` ``(..., 3)``, ``cone``
    ``(...)``, float32, contiguous) through a grid sampler, resumable as the
    JAX package's ``_march``: with ``active`` (int32) the march resumes from
    ``depth0``/``steps0``, rays not active keep their ``outcome0``, and each
    ray's steps stop at ``min(budget, step_limit)``, a resumed ray taking
    its first step in any case. CUDA tensors go through K8 or K9, CPU
    tensors through :func:`grid_march_torch`. Returns flat ``(depth, steps,
    outcome)``."""
    kwargs = dict(active=active, depth0=depth0, steps0=steps0, outcome0=outcome0, budget=budget)
    if cone.device.type == "cuda":
        return grid_march_cuda(sampler, origins, directions, cone, config, **kwargs)
    _check_rays(origins, directions, cone, active, depth0, steps0, outcome0)
    _check_sampler(sampler, cone.device)
    if cone.device.type == "cpu":
        return grid_march_torch(sampler, origins, directions, cone, config, **kwargs)
    raise ValueError(f"unsupported device {cone.device}")


def grid_sample(sampler: Sampler, x, y, z):
    """The sampler at flat float32 planes: P1 on CUDA tensors,
    :func:`grid_sample_torch` on CPU tensors."""
    if x.device.type == "cuda":
        return grid_sample_cuda(sampler, x, y, z)
    check_planes(x=(x, torch.float32), y=(y, torch.float32), z=(z, torch.float32))
    _check_sampler(sampler, x.device)
    if x.device.type == "cpu":
        return grid_sample_torch(sampler, x, y, z)
    raise ValueError(f"unsupported device {x.device}")


# ---------------------------------------------------------------------------
# the routes
# ---------------------------------------------------------------------------


def make_contraction_levels(grid: SdfGrid) -> list[Sampler]:
    """The contraction ladder of ``grid``, coarse to fine, as K9's samplers
    (the JAX package's ``(t2, r, lo, hi, bf16, margin, exact)`` levels): a
    32^3 lower-bound mip in bf16 (when R > 32) with the sound rounding
    margin, then the exact table (:data:`HAT_F32`) when R <= 64, else a
    64^3 bf16 mip, after which the fine finish runs; each level carries
    its :func:`cell_table`. Build it once per grid."""
    r = grid.resolution
    levels = []

    def bf16_level(g: SdfGrid) -> Sampler:
        margin = float(np.float32(_BF16_MARGIN * float(g.values.abs().max())))
        return Sampler(HAT_BF16, g.values.reshape(-1).to(torch.bfloat16), g.resolution,
                       g.lo, g.hi, margin)

    if r > 32:
        levels.append(bf16_level(coarsen_grid_lower(grid, 32)))
    if r <= MID_RESOLUTION:
        levels.append(Sampler(HAT_F32, grid.values.reshape(-1), r, grid.lo, grid.hi))
    else:
        levels.append(bf16_level(coarsen_grid_lower(grid, MID_RESOLUTION)))
    return [s._replace(cells=cell_table(s.table, s.r)) for s in levels]


def resume_state(steps, outcome):
    """``(active, steps)`` for the next level: COLLISION stalled a sound
    margin short of the finer surface and resumes with its steps;
    STEP_LIMIT may still collide under finer steps and resumes with a fresh
    budget (grid_kernel.py:479-485)."""
    active = ((outcome == COLLISION) | (outcome == STEP_LIMIT)).to(torch.int32)
    return active, torch.where(outcome == STEP_LIMIT, 0, steps)


def _shaped(cone, *planes):
    return tuple(p.reshape(cone.shape) for p in planes)


def grid_trace_contraction(grid: SdfGrid, origins, directions, cone,
                           config: MarchConfig = MarchConfig(), levels=None):
    """Sphere-trace rays against a baked grid SDF with the contraction
    ladder (any resolution; ``levels`` from :func:`make_contraction_levels`,
    built here when not given): one K9 launch per level, then, when the
    last level is a mip, the fine finish on the full table (one resumed K8
    launch, in place on the route's own planes). Returns ``(depth, steps,
    outcome)`` shaped like ``cone``."""
    if levels is None:
        levels = make_contraction_levels(grid)
    state = {}
    for level in levels:
        depth, steps, outcome = grid_march(level, origins, directions, cone, config,
                                           budget=config.step_limit, **state)
        active, steps = resume_state(steps, outcome)
        state = dict(active=active, depth0=depth, steps0=steps, outcome0=outcome)
    if levels[-1].kind != HAT_F32:  # the last level a mip: finish on the table, in place
        grid_march_into(interp_sampler(grid), origins, directions, cone, config, active=active,
                        depth=depth, steps=steps, outcome=outcome, budget=config.step_limit)
    return _shaped(cone, depth, steps, outcome)


def grid_trace_hybrid(grid: SdfGrid, origins, directions, cone,
                      config: MarchConfig = MarchConfig()):
    """The gather route: one K8 launch over the whole table when R <= 64
    and R^3 % 128 == 0; otherwise K8 over the 64^3 lower-bound mip, then
    the resumed fine finish. Returns ``(depth, steps, outcome)`` shaped like
    ``cone``."""
    r = grid.resolution
    if r <= MID_RESOLUTION and (r * r * r) % 128 == 0:
        return _shaped(cone, *grid_march(interp_sampler(grid), origins, directions, cone, config))
    coarse = coarsen_grid_lower(grid, MID_RESOLUTION)
    depth, steps, outcome = grid_march(interp_sampler(coarse), origins, directions, cone, config)
    active, steps = resume_state(steps, outcome)
    grid_march_into(interp_sampler(grid), origins, directions, cone, config, active=active,
                    depth=depth, steps=steps, outcome=outcome, budget=config.step_limit)
    return _shaped(cone, depth, steps, outcome)


def fd4_stencil(px, py, pz, eps: float):
    """The twelve fd4 stencil points of flat points, concatenated in
    render_kernel.py::_fd_normal's order: ``(xs, ys, zs)`` of ``12 * n``."""
    stencil = []
    for axis in range(3):
        for off in (2 * eps, eps, -eps, -2 * eps):
            stencil.append(tuple(p + off if a == axis else p for a, p in enumerate((px, py, pz))))
    return tuple(torch.cat([p[a] for p in stencil]) for a in range(3))


def fd4_normal(sampler: Sampler, px, py, pz, eps: float):
    """4th-order central-difference unit normals at flat points
    (render_kernel.py::_fd_normal): the twelve stencil points of every point
    go through one :func:`grid_sample` call (one P1 launch on the card)."""
    f = grid_sample(sampler, *fd4_stencil(px, py, pz, eps)).split(px.numel())

    def deriv(fp2, fp1, fm1, fm2):
        return -fp2 + 8.0 * fp1 - 8.0 * fm1 + fm2

    gx, gy, gz = deriv(*f[0:4]), deriv(*f[4:8]), deriv(*f[8:12])
    inv = torch.rsqrt(torch.clamp_min(gx * gx + gy * gy + gz * gz, 1e-24))
    return gx * inv, gy * inv, gz * inv


def hit_points(origins, directions, depth, outcome):
    """``(index, px, py, pz)``: the flat indices of the COLLISION rays and
    their hit points ``o + depth * d``."""
    ox, oy, oz, dx, dy, dz, _ = _flat_rays(origins, directions, depth)
    depth = depth.reshape(-1)
    hit = (outcome.reshape(-1) == COLLISION).nonzero().squeeze(1)
    t = depth[hit]
    return hit, ox[hit] + t * dx[hit], oy[hit] + t * dy[hit], oz[hit] + t * dz[hit]


def shade_grid_hits(grid: SdfGrid, origins, directions, depth, outcome,
                    config: MarchConfig = MarchConfig()):
    """fd4 normals of the COLLISION rays on the fine table (one P1 launch),
    then the reference shade. Returns flat ``(r, g, b)`` planes."""
    hit, px, py, pz = hit_points(origins, directions, depth, outcome)
    normals = [torch.zeros(depth.numel(), dtype=torch.float32, device=depth.device)
               for _ in range(3)]
    if hit.numel():
        values = fd4_normal(interp_sampler(grid), px, py, pz, config.normal_epsilon)
        for plane, value in zip(normals, values):
            plane[hit] = value
    return shade_planes(*normals, outcome.reshape(-1))


def shade_grid_planes_contraction(grid: SdfGrid, origins, directions, cone,
                                  config: MarchConfig = MarchConfig(), levels=None):
    """Mesh-asset shading on the contraction route: the ladder and the fine
    finish, fd4 normals of the hits, the reference shade. Returns ``(r, g,
    b)`` shaped like ``cone``."""
    depth, _, outcome = grid_trace_contraction(grid, origins, directions, cone, config, levels)
    return _shaped(cone, *shade_grid_hits(grid, origins, directions, depth, outcome, config))


def render_image_grid(grid: SdfGrid, origins, directions, cone,
                      config: MarchConfig = MarchConfig(), mode: str = "gather", levels=None):
    """Full render of a grid-SDF (mesh-asset) scene from ``(H, W, 3)`` rays:
    ``mode="contraction"`` (the CLI's route) or ``mode="gather"``, then fd4
    normals and the reference shade. Returns linear RGB ``(H, W, 3)``."""
    if mode == "contraction":
        rgb = shade_grid_planes_contraction(grid, origins, directions, cone, config, levels)
    elif mode == "gather":
        depth, _, outcome = grid_trace_hybrid(grid, origins, directions, cone, config)
        rgb = _shaped(cone, *shade_grid_hits(grid, origins, directions, depth, outcome, config))
    else:
        raise ValueError(f"mode must be 'contraction' or 'gather', got {mode!r}")
    return torch.stack(rgb, dim=-1)
