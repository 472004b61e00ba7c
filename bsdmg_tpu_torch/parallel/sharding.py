"""Multi-device render and fit steps: rays over a mesh of ranks.

Port of ``bsdmg_tpu/parallel/sharding.py``. JAX drives every device from
one process through a ``Mesh`` and ``shard_map``; here each device has a
process of its own in a ``torch.distributed`` group, and the mesh is a
:class:`~torch.distributed.device_mesh.DeviceMesh` over that world with
the JAX package's axes: image rows over ``"dp"``, columns over ``"sp"``.

* **Frames** (:func:`render_sharded_pallas`, :func:`render_sharded`,
  :func:`render_grid_sharded`) take and return the whole ``(H, W)``
  frame. Its rows are dealt in bands of 8, K1's block height, round robin
  over every rank (both axes flattened), so each rank gets a mix of sky and
  object; each rank renders its bands as one ``(H/N, W)`` image through the
  single-device kernels, and one ``all_gather`` assembles the frame. A
  ray's colour depends on that ray alone, so the frame is bit-equal to the
  single-device render. (JAX deals 32x32 swizzled blocks, a TPU layout.)
* **Steps** (:func:`train_step_fused`, :func:`train_step`) take this
  rank's block of rays and target (:func:`shard_rays`), compute the loss
  and gradient of the block over the global pixel count, sum them over the
  world in one ``all_reduce`` of one buffer, and step the caller's
  optimizer on every rank; the parameters stay bit-equal across ranks.

Every collective goes through ``parallel/collectives.py``, which counts it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from bsdmg_tpu_torch.config import MarchConfig
from bsdmg_tpu_torch.grad import render_image_diff
from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene
from bsdmg_tpu_torch.ops.cuda.diff_kernel import render_loss_grad_cuda
from bsdmg_tpu_torch.ops.cuda.grid_kernel import make_contraction_levels, render_image_grid
from bsdmg_tpu_torch.ops.cuda.render_kernel import BLOCK_H, render_image_cuda
from bsdmg_tpu_torch.parallel.collectives import all_gather, all_reduce
from bsdmg_tpu_torch.parallel.launch import GROUP_TIMEOUT
from bsdmg_tpu_torch.parallel.multihost import default_backend, initialize, local_device
from bsdmg_tpu_torch.weights import flatten_params, unflatten_params

AXES = ("dp", "sp")


def make_mesh(devices=None, shape: tuple[int, int] | None = None, axis_names=AXES, *,
              device: torch.device | str = "cuda", backend: str | None = None) -> DeviceMesh:
    """A 2-D mesh over the world's ranks: rows x columns of the image.

    The mesh holds every rank of the world in rank order: ``devices`` is
    ``None`` or that list (JAX's subsets and orders of devices have no
    counterpart; anything else raises ``ValueError``), so a rank's place
    in the mesh, both axes flattened, is its rank. ``shape=None`` puts
    every rank on ``"dp"``; a shape whose product is not their number
    raises ``ValueError``. Without a process group the
    call first joins the one the environment names
    (:func:`~bsdmg_tpu_torch.parallel.multihost.initialize`), else forms a
    world of one rank, so a plain process runs the same code at N = 1.
    ``backend`` defaults to NCCL for a CUDA ``device`` and gloo otherwise;
    two ranks that share one card need gloo."""
    device = local_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    initialize(backend=backend, device=device)
    if not dist.is_initialized():
        dist.init_process_group(backend or default_backend(device), store=dist.HashStore(),
                                world_size=1, rank=0, timeout=GROUP_TIMEOUT)
    elif backend is not None and dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, not {backend}")
    ranks = list(range(dist.get_world_size()))
    if devices is not None and [int(r) for r in devices] != ranks:
        raise ValueError(f"the mesh takes the world's ranks {ranks} in order, not {list(devices)}")
    n = len(ranks)
    if shape is None:
        shape = (n, 1)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    # the mesh's device type names the backend's devices: gloo's are host
    # buffers, also where the ranks compute on a card
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, torch.tensor(ranks).reshape(shape), mesh_dim_names=axis_names)


def interleave_rows(h: int, n_shards: int) -> np.ndarray:
    """Permutation striping rows round-robin across shards (load balance)."""
    return np.argsort(np.arange(h) % n_shards, kind="stable")


def shard_image(image: torch.Tensor, mesh: DeviceMesh, *, interleave: bool = True) -> torch.Tensor:
    """This rank's block of an ``(H, W, ...)`` image: rows over ``"dp"``,
    columns over ``"sp"``, each split into equal contiguous blocks; with
    ``interleave`` the rows are striped first (:func:`interleave_rows`)."""
    n_dp, n_sp = mesh.size(0), mesh.size(1)
    h, w = image.shape[:2]
    if h % n_dp or w % n_sp:
        raise ValueError(f"a {h}x{w} image does not split into {n_dp}x{n_sp} equal blocks")
    if interleave and n_dp > 1:
        image = image[torch.from_numpy(interleave_rows(h, n_dp)).to(image.device)]
    dp, sp = mesh.get_local_rank("dp"), mesh.get_local_rank("sp")
    return image.chunk(n_dp, 0)[dp].chunk(n_sp, 1)[sp].contiguous()


def shard_rays(origins, directions, cone, mesh: DeviceMesh, *, interleave: bool = True):
    """This rank's block of an ``(H, W, ...)`` ray bundle (:func:`shard_image`).
    Returns ``(origins, dirs, cone, unpermute)``; ``unpermute`` restores
    scanline order to a whole image whose rows were striped."""
    h = origins.shape[0]
    blocks = tuple(shard_image(x, mesh, interleave=interleave) for x in (origins, directions, cone))
    if interleave and mesh.size(0) > 1:
        inverse = torch.from_numpy(np.argsort(interleave_rows(h, mesh.size(0))))
        return (*blocks, lambda img: img[inverse.to(img.device)])
    return (*blocks, lambda img: img)


def band_rows(h: int, n: int, index: int, device) -> torch.Tensor:
    """The rows of shard ``index`` of ``n``: bands of ``BLOCK_H`` rows dealt
    round robin, ``H`` padded to a multiple of ``BLOCK_H * n`` with copies
    of the last row."""
    granule = BLOCK_H * n
    hp = -(-h // granule) * granule
    rows = torch.arange(hp, device=device).clamp_max(h - 1)
    return rows.reshape(hp // granule, n, BLOCK_H)[:, index].reshape(-1)


def _sharded_frame(render, origins, directions, cone, mesh: DeviceMesh) -> torch.Tensor:
    """``render`` of this rank's bands, then one ``all_gather`` of their RGB
    into the ``(H, W, 3)`` frame."""
    h, w = cone.shape
    n = mesh.size()
    rows = band_rows(h, n, dist.get_rank(), cone.device)
    local = render(origins[rows], directions[rows], cone[rows])
    parts = torch.stack(all_gather(local))
    frame = parts.reshape(n, -1, BLOCK_H, w, 3).transpose(0, 1).reshape(-1, w, 3)
    return frame[:h]


def render_sharded_pallas(
    desc,
    origins: torch.Tensor,
    directions: torch.Tensor,
    cone: torch.Tensor,
    mesh: DeviceMesh,
    config: MarchConfig = MarchConfig(),
    *,
    use_bb_skip: bool = True,
    two_phase: bool | str = False,
    phase_a_steps: int = 48,
    split=None,
) -> torch.Tensor:
    """The frame of a compiled scene descriptor over the mesh, through
    kernel K1 on each rank (``two_phase=True``: K2 and K3; ``"block"``:
    block retirement, K1 twice, each rank over its own blocks), with the
    near/far ``split`` where given; the name is the JAX package's. Takes
    the whole ``(H, W)`` ray image and returns linear RGB ``(H, W, 3)``,
    bit-equal to ``render_image_cuda`` in the same mode (a band of 8 rows
    holds whole 8x4 patches, so each patch votes on the rays it votes on in
    the whole frame; the row pipeline's listed tail, whose warps are
    another rank's list, is within the split's bars of it); do not
    pre-permute with :func:`shard_rays`."""
    return _sharded_frame(
        lambda o, d, c: render_image_cuda(desc, o, d, c, config, use_bb_skip=use_bb_skip,
                                          two_phase=two_phase, phase_a_steps=phase_a_steps,
                                          split=split),
        origins, directions, cone, mesh,
    )


def render_sharded(scene, params, origins, directions, cone, mesh: DeviceMesh,
                   config: MarchConfig = MarchConfig()) -> torch.Tensor:
    """The frame of ``scene`` at ``params`` over the mesh: the scene
    compiled with ``params`` (``ops/cuda/csdf.py::compile_scene``), then
    :func:`render_sharded_pallas`."""
    return render_sharded_pallas(compile_scene(scene, params), origins, directions, cone, mesh,
                                 config)


def render_grid_sharded(grid, origins, directions, cone, mesh: DeviceMesh,
                        config: MarchConfig = MarchConfig(), *, levels=None) -> torch.Tensor:
    """The frame of a mesh asset's baked ``grid`` over the mesh, in
    :func:`render_sharded_pallas`'s bands: each rank runs the contraction
    route (K9 a level, K8's finish, P1's normals) on its bands, the tables
    replicated; one ``all_gather``. ``levels`` from
    ``make_contraction_levels`` (built here when not given)."""
    if levels is None:
        levels = make_contraction_levels(grid)
    return _sharded_frame(
        lambda o, d, c: render_image_grid(grid, o, d, c, config, mode="contraction", levels=levels),
        origins, directions, cone, mesh,
    )


def _sum_and_step(params: dict, optimizer, loss: torch.Tensor, grads: dict):
    """One ``all_reduce`` of the loss and every gradient in one buffer, the
    sums as the parameters' ``.grad``, one step of ``optimizer``."""
    flat, layout = flatten_params({k: grads[k] for k in params})
    buf = all_reduce(torch.cat([loss.detach().reshape(1), flat.detach()]))
    for name, g in unflatten_params(buf[1:], layout).items():
        params[name].grad = g
    optimizer.step()
    return params, buf[0]


def train_step_fused(cfn, params: dict, optimizer, target, origins, directions, cone,
                     mesh: DeviceMesh, config: MarchConfig = MarchConfig(), *, bb=None,
                     split=None):
    """One inverse-rendering step through the fused loss and gradient
    (kernel K5) on this rank's block of rays and ``target``
    (:func:`shard_rays`; the same block of the target), normalised by the
    global pixel count; the loss and gradients summed over the world in one
    ``all_reduce``; then ``optimizer`` (over ``params.values()``) steps on
    every rank. ``split`` is K5's near/far split. Returns ``(params,
    loss)``."""
    h, w = cone.shape
    detached = {k: v.detach() for k, v in params.items()}
    loss, grads = render_loss_grad_cuda(cfn, detached, target, origins, directions, cone, config,
                                        bb=bb, total_pixels=h * w * mesh.size(), split=split)
    return _sum_and_step(params, optimizer, loss, grads)


def train_step(scene, params: dict, optimizer, target, origins, directions, cone,
               mesh: DeviceMesh, config: MarchConfig = MarchConfig(), csdf=None, bb=None):
    """One inverse-rendering step through the differentiable render
    (``grad/diff_render.py::render_image_diff``: kernel K4's march with a
    ``csdf``) and autograd on this rank's block of rays and ``target``: the
    L2 loss summed over the block and divided by the global ``3 * H * W``,
    the loss and gradients summed over the world in one ``all_reduce``,
    then ``optimizer`` steps on every rank. ``scene`` is the SDF
    ``(params, points) -> distance``. Returns ``(params, loss)``."""
    h, w = cone.shape
    names = list(params)
    img = render_image_diff(scene, params, origins, directions, cone, config, csdf=csdf, bb=bb)
    loss = torch.sum((img - target) ** 2) / (3 * h * w * mesh.size())
    found = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
    grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in zip(names, found)}
    return _sum_and_step(params, optimizer, loss, grads)
