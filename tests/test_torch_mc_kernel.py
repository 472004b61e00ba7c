"""The modules of CUDA kernels K6 and K7 (bsdmg_tpu_torch/ops/cuda/mc_kernel.py,
mesh_kernel.py) and the analytic gradient they share (ops/cuda/csdf.py).

The kernels need nvcc and a card; chip_smoke.py holds them against their
plain versions there. Here the plain versions are held against the JAX
package on the same inputs:

* ``descriptor_csdf_value_and_grad`` against ``jax.vjp`` of the JAX
  compiler's SDF to 1e-6, on seeded points and on the x=0, y=0 and z=0
  planes, where the factorised capsule groups tie and JAX splits the
  cotangent;
* ``mc_fused_torch`` against ``mc_fused_pallas`` on the packed inputs the
  port's pipeline builds, and ``project_edges_torch`` against
  ``project_edges_pallas`` on the JAX kernel's padded lanes
  (``padded_inputs``), both in interpret mode: validity/meta bits exactly,
  positions within 2e-5, normals within 2e-4 (tests/test_mesh.py:314-320);
* the checkerboard overflow case of tests/test_mesh.py:430-489.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsdmg_tpu.config import MeshGenConfig as JaxMeshGenConfig
from bsdmg_tpu.mesh import create_voxel_field as jax_create_field
from bsdmg_tpu.mesh import refine_field as jax_refine_field
from bsdmg_tpu.models import reference_object as jax_object
from bsdmg_tpu.models import reference_render_scene as jax_render_scene
from bsdmg_tpu.ops.marching_cubes import extract_triangles as jax_extract
from bsdmg_tpu.ops.pallas import compile_scene_csdf
from bsdmg_tpu.ops.pallas.mc_fused import mc_fused_pallas
from bsdmg_tpu.ops.pallas.mesh_kernel import project_edges_pallas
from bsdmg_tpu_torch.config import MeshGenConfig
from bsdmg_tpu_torch.mesh.field import VoxelField
from bsdmg_tpu_torch.mesh.pipeline import field_to_triangles
from bsdmg_tpu_torch.models import reference_object, reference_render_scene
from bsdmg_tpu_torch.ops.cuda import mc_kernel, mesh_kernel
from bsdmg_tpu_torch.ops.cuda.csdf import (
    SdfFns,
    _capsule_set_value_grad,
    compile_scene,
    descriptor_csdf,
    descriptor_csdf_value_and_grad,
    sdf_fns,
)
from bsdmg_tpu_torch.ops.marching_cubes import extract_triangles, kernel_inputs, padded_inputs
from bsdmg_tpu_torch.ops.tables import MC_EDGE_MIDPOINTS
from bsdmg_tpu_torch.weights import field_from_numpy

# one intra-op thread: PyTorch's spinning OpenMP pool would otherwise take
# every core from the timing-sensitive tests that run beside these
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SCENES = {"reference_object": (jax_object, reference_object),
          "reference_render_scene": (jax_render_scene, reference_render_scene)}


def _points(kind: str) -> np.ndarray:
    """(3, 4096) seeded points in the mesh box; on one coordinate plane for
    'x=0', 'y=0', 'z=0'."""
    pts = np.random.default_rng(7).uniform(-2.7, 2.7, (3, 4096)).astype(np.float32)
    if kind != "seeded":
        pts["xyz".index(kind[0])] = 0.0
    return pts


@pytest.mark.parametrize("kind", ["seeded", "x=0", "y=0", "z=0"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_value_and_grad_matches_jax_vjp(name, kind):
    jax_scene, torch_scene = SCENES[name]
    pts = _points(kind)
    csdf = compile_scene_csdf(jax_scene())
    sd, vjp = jax.vjp(csdf, *(jnp.asarray(p) for p in pts))
    ref = (sd, *vjp(jnp.ones_like(sd)))
    got = descriptor_csdf_value_and_grad(compile_scene(torch_scene(device="cpu")))(
        *(torch.from_numpy(p) for p in pts)
    )
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6, rtol=0)


def test_gradient_splits_ties_on_symmetry_planes():
    """On y=0 the skeleton's x-parallel group sits equidistant from its two
    edges (y = +-0.5): JAX's min splits the cotangent and the y-gradient is
    0 exactly; a one-sided argmin would push the point off the plane."""
    pts = _points("y=0")
    pts[0] = np.random.default_rng(3).uniform(-1.4, 1.4, pts.shape[1])  # along the x edges
    pts[2] = np.random.default_rng(4).uniform(-0.2, 0.2, pts.shape[1])
    desc = compile_scene(reference_object(device="cpu"))
    d, gx, gy, gz = descriptor_csdf_value_and_grad(desc)(*(torch.from_numpy(p) for p in pts))
    assert torch.all(gy == 0.0)
    csdf = compile_scene_csdf(jax_object())
    sd, vjp = jax.vjp(csdf, *(jnp.asarray(p) for p in pts))
    assert np.all(np.asarray(vjp(jnp.ones_like(sd))[1]) == 0.0)


def _per_segment(cs, x, y, z):
    """A capsule set's SDF as the minimum over its segments of
    ``(axial + o1^2) + o2^2``, then one sqrt: the form the groups factorise."""
    coords = (x, y, z)
    best = None
    for g in cs.groups:
        lower, higher = (a for a in range(3) if a != g.axis)
        r = coords[g.axis] - g.a0
        e = r - torch.clamp_max(torch.clamp_min(r, 0.0), g.length)
        for v1 in g.v1:
            for v2 in g.v2:
                o1, o2 = coords[lower] - v1, coords[higher] - v2
                d2 = (e * e + o1 * o1) + o2 * o2
                best = d2 if best is None else torch.minimum(best, d2)
    return torch.sqrt(best) - cs.radius


@pytest.mark.parametrize("name", sorted(SCENES))
def test_value_equals_descriptor_csdf_bitwise(name):
    """The factorised capsule groups give the per-segment value bit for bit
    (monotonic rounding), and the value of descriptor_csdf_value_and_grad
    equals descriptor_csdf's, so K1 and the mesh kernels share one SDF."""
    desc = compile_scene(SCENES[name][1](device="cpu"))
    pts = [torch.from_numpy(p) for p in _points("seeded")]
    for cs in filter(None, (desc.object, desc.frame)):
        assert sum(len(g.v1) * len(g.v2) for g in cs.groups) == 12
        assert torch.equal(_capsule_set_value_grad(cs)(*pts)[0], _per_segment(cs, *pts))
    assert torch.equal(descriptor_csdf_value_and_grad(desc)(*pts)[0],
                       descriptor_csdf(desc)(*pts))


@pytest.fixture(scope="module")
def field_8():
    """The reference object's field at init_factor 8 after one refinement,
    from the JAX package (as tests/test_mesh.py builds it), moved to the port."""
    scene = jax_object()
    cfg = JaxMeshGenConfig(init_factor=8)
    field = jax_refine_field(scene.bind(), jax_create_field(cfg), cfg, csdf=compile_scene_csdf(scene))
    return field_from_numpy(field.to_numpy(), field.voxel_size, field.level, "cpu")


def test_mc_fused_torch_matches_pallas(field_8):
    """The default configuration; the other projection, winding and budget
    options are held against the JAX package's XLA path in
    tests/test_torch_mesh.py (interpret mode costs ~15 s per variant)."""
    cfg = MeshGenConfig(init_factor=8)
    desc = compile_scene(reference_object(device="cpu"))
    args, kwargs = kernel_inputs(desc, field_8.lowers, field_8.voxel_size, cfg)
    pos, nrm, dot, amb, meta = mc_kernel.mc_fused_torch(sdf_fns(desc), *args, **kwargs)

    jargs = [jnp.asarray(a.numpy()) for a in args[:6]]
    ref = mc_fused_pallas(
        compile_scene_csdf(jax_object()), *jargs, jnp.float32(args[6]),
        budget=kwargs["budget"], iters=kwargs["iters"], tol=kwargs["tol"], eps=kwargs["eps"],
        use_grad=kwargs["use_grad"], winding=kwargs["winding_normals"], interpret=True,
    )
    rpos, rnrm, rdot, ramb, rmeta = (np.asarray(r) for r in ref)
    np.testing.assert_array_equal(meta.numpy(), rmeta)
    assert (meta.numpy() & 31).any()
    np.testing.assert_allclose(pos.numpy(), rpos.T, atol=2e-5, rtol=0)
    np.testing.assert_allclose(nrm.numpy(), rnrm.T, atol=2e-4, rtol=0)
    valid = ((meta.numpy()[:, None] >> np.arange(5)) & 1) > 0
    np.testing.assert_array_equal(amb.numpy()[valid], ramb.T[valid])
    np.testing.assert_allclose(dot.numpy()[valid], rdot.T[valid], atol=1e-6, rtol=1e-3)


def test_project_edges_torch_matches_pallas(field_8):
    """On the JAX kernel's layout: padded lanes, some inactive."""
    cfg = MeshGenConfig(init_factor=8, interpolate_edges=True)
    desc = compile_scene(reference_object(device="cpu"))
    args, kwargs = padded_inputs(desc, field_8.lowers, field_8.voxel_size, cfg)
    got = mesh_kernel.project_edges_torch(sdf_fns(desc), *args[:3], args[3].bool(), **kwargs)
    ref = project_edges_pallas(
        compile_scene_csdf(jax_object()), *(jnp.asarray(a.numpy()) for a in args), interpret=True,
        **kwargs,
    )
    active = args[3].numpy() > 0
    assert active.any() and not active.all()
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5 if i < 3 else 2e-4, rtol=0)


def _checker_jax(x, y, z):
    return 0.2 * (jnp.sin(np.pi * (x + 0.5)) * jnp.sin(np.pi * (y + 0.5)) * jnp.sin(np.pi * (z + 0.5)))


def _checker_torch(x, y, z):
    return 0.2 * (torch.sin(np.pi * (x + 0.5)) * torch.sin(np.pi * (y + 0.5)) * torch.sin(np.pi * (z + 0.5)))


def _checker_value_and_grad(x, y, z):
    with torch.enable_grad():
        p = [t.detach().requires_grad_() for t in (x, y, z)]
        d = _checker_torch(*p)
        g = torch.autograd.grad(d.sum(), p)
    return (d.detach(), *g)


CHECKER = SdfFns(_checker_torch, _checker_value_and_grad)
CHECKER_LOWERS = np.asarray([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)


def test_checkerboard_overflow_matches_jax():
    """Every corner alternates sign, so all 12 edges cross: with budget 6 the
    triangles overflow and are dropped, with the JAX count; the pipeline's
    retry with budget 12 restores the JAX package's full set."""
    cfg = MeshGenConfig(newton_iters=4)
    jcfg = JaxMeshGenConfig(newton_iters=4)
    lowers = torch.from_numpy(CHECKER_LOWERS)
    jlowers = jnp.asarray(np.concatenate([CHECKER_LOWERS, np.full((1, 3), 1e6, np.float32)]))

    def checker_points(p):
        return _checker_jax(p[..., 0], p[..., 1], p[..., 2])

    import dataclasses

    ref = jax_extract(checker_points, jlowers, jnp.float32(1.0), jnp.int32(3), jcfg, _checker_jax)
    for interpolate in (False, True):  # the K6 path, then the staged K7 path
        soup = extract_triangles(CHECKER, lowers, 1.0,
                                 dataclasses.replace(cfg, interpolate_edges=interpolate))
        assert soup.edge_overflow == int(ref.edge_overflow) > 0
        np.testing.assert_array_equal(soup.valid.numpy(), np.asarray(ref.valid)[:3])
    full = jax_extract(
        checker_points, jlowers, jnp.float32(1.0), jnp.int32(3),
        dataclasses.replace(jcfg, edge_budget=12), _checker_jax,
    )
    retried = field_to_triangles(CHECKER, VoxelField(lowers, 1.0), cfg)
    np.testing.assert_array_equal(retried.valid.numpy(), np.asarray(full.valid)[:3])
    assert int(retried.valid.sum()) > int(soup.valid.sum())
    np.testing.assert_allclose(retried.positions.numpy(), np.asarray(full.positions)[:3], atol=2e-5)


def test_wrappers_send_cpu_tensors_to_twins(field_8):
    desc = compile_scene(reference_object(device="cpu"))
    cfg = MeshGenConfig(init_factor=8)
    args, kwargs = kernel_inputs(desc, field_8.lowers, field_8.voxel_size, cfg)
    k6, k7 = mc_kernel.LAUNCHES, mesh_kernel.LAUNCHES
    got = mc_kernel.mc_fused(desc, *args, **kwargs)
    ref = mc_kernel.mc_fused_torch(sdf_fns(desc), *args, **kwargs)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    staged = MeshGenConfig(init_factor=8, interpolate_edges=True)
    sargs, skw = kernel_inputs(desc, field_8.lowers, field_8.voxel_size, staged)
    got = mesh_kernel.project_edges(desc, *sargs, **skw)
    ref = mesh_kernel.project_edges_torch(sdf_fns(desc), *sargs, **skw)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert (mc_kernel.LAUNCHES, mesh_kernel.LAUNCHES) == (k6, k7)


@pytest.mark.parametrize("case", ["float64", "shape", "int64 bits", "not a tensor"])
def test_mc_fused_rejects_bad_inputs(field_8, case):
    desc = compile_scene(reference_object(device="cpu"))
    args, kwargs = kernel_inputs(desc, field_8.lowers, field_8.voxel_size, MeshGenConfig())
    args = list(args)
    if case == "float64":
        args[0] = args[0].double()
    elif case == "shape":
        args[1] = args[1][:-1].contiguous()
    elif case == "int64 bits":
        args[3] = args[3].long()
    else:
        args[4] = args[4].numpy()
    with pytest.raises((TypeError, ValueError)):
        mc_kernel.mc_fused(desc, *args, **kwargs)


def test_kernel_source_midpoints_match_tables():
    source = (ROOT / mc_kernel.SOURCE).read_text()
    body = re.search(r"kEdgeMid\[12\]\[3\] = \{(.*?)\};", source, re.S).group(1)
    values = [float(v) for v in re.findall(r"(-?\d+\.\d+)f", body)]
    np.testing.assert_array_equal(np.asarray(values, np.float32).reshape(12, 3), MC_EDGE_MIDPOINTS)


@pytest.mark.parametrize(
    "module,tpu_kernel",
    [(mc_kernel, "mc_fused.py::_mc_kernel"), (mesh_kernel, "mesh_kernel.py::_project_kernel")],
)
def test_kernel_source_names_the_tpu_kernel(module, tpu_kernel):
    source = (ROOT / module.SOURCE).read_text()
    assert tpu_kernel in source and '#include "project.cuh"' in source
    assert 'extern "C"' in source and "cudaGetLastError" in source
