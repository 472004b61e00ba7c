"""The wrapped object's K5 route on the card: its function lowered to a
parameter program (``ops/cuda/csdf.py::wrapped_param_program``,
wrap(transform(smooth_union(box_skeleton, sphere)))) whose reverse sweep
``loss_reverse_kernel`` runs (csrc/diff_kernel.cu, csrc/param_program.cuh),
the cell's three copies and the pinned constants in private slots after the
flat vector, folded back on the host. In plain PyTorch, on numpy-seeded
points and adjoints:

* (a) the lowered program's value, as the kernels' interpreter runs it
  (``param_program_csdf``), equals ``WrappedCsdf``'s bit for bit, NaN
  nowhere, with and without the object transform (and with one of its
  parts absent, which a private constant stands in for), at random points
  and on the cells' boundaries and their float32 neighbours;
* (b) the folded sweep (``param_program_adjoint_torch`` on the lowered
  program, ``WrappedProgram.fold``) against autograd's backward (the value)
  and double backward (the value and its spatial gradient) of
  ``WrappedCsdf``: each adjoint within 1e-5 of the largest magnitude of
  autograd's (float32 sums in other orders), NaN nowhere;
* (c) K5 by the sweep's route (``diff_kernel.render_loss_grad_sweep_torch``:
  K4's twin, then each ray as the reverse launch takes it) against JAX's
  XLA ``render_loss_and_grad``, edge term on, at
  ``test_torch_fit_scenes.py``'s bars (the loss to a relative 1e-4, each
  gradient at rtol 1e-3, atol 1e-5), as
  ``test_wrapped_loss_grad_twin_matches_xla`` holds the autograd twin; the
  lattice spec (a composed scene's own program) the same way;
* the struct K4 and K5 take: the flat vector, then the private slots, and
  the program.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bsdmg_tpu.grad import render_loss_and_grad as jax_render_loss_and_grad
from bsdmg_tpu_torch.models import get_scene
from bsdmg_tpu_torch.ops.cuda import csdf as tcsdf
from bsdmg_tpu_torch.ops.cuda import diff_kernel as dk
from bsdmg_tpu_torch.weights import flatten_params, param_offsets, unflatten_params
from test_torch_fit_scenes import (
    CASES,
    SIZE,
    _assert_loss_grad,
    _point,
    _rays,
    _scenes,
    _target,
    _torch_params,
)

torch.set_num_threads(1)

RTOL = 1e-5
POINTS = 64
CELL = 8.0

_CENTER = [0.3, -0.2, 0.1]
_TURN = [0.9238795, 0.0, 0.2, 0.3826834]
#: the object transform's parts: both at their defaults (the identity),
#: both turned, none, and each alone
TRANSFORMS = {
    "identity": {},
    "turned": {"object_center": _CENTER, "object_rotation": _TURN},
    "none": {"object_center": None, "object_rotation": None},
    "translation only": {"object_center": _CENTER, "object_rotation": None},
    "rotation only": {"object_center": None, "object_rotation": _TURN},
}


def _params(transform: str) -> dict:
    """The wrapped object's parameters with TRANSFORMS[transform] applied, its
    shape moved off the defaults so that no two values tie."""
    p = dict(get_scene("wrapped_object", device="cpu").params)
    p["sphere_radius"] = torch.tensor(1.1)
    p["skeleton_center"] = torch.tensor([0.05, -0.1, 0.02])
    for name, value in TRANSFORMS[transform].items():
        if value is None:
            del p[name]
        else:
            p[name] = torch.tensor(value, dtype=torch.float32)
    return p


def _lowered(p: dict):
    flat, layout = flatten_params(p)
    wrapped = tcsdf.wrapped_param_program(param_offsets(layout), flat.numel())
    return flat, layout, wrapped


def _boundary_points(rng) -> np.ndarray:
    """(3, n) float32 points whose coordinates lie on the cells' boundaries
    (-cell/2 + k cell), on their float32 neighbours, or at random."""
    edges = np.array([-CELL / 2 + k * CELL for k in range(-2, 3)], np.float32)
    on = np.concatenate([edges, np.nextafter(edges, np.float32(np.inf)),
                         np.nextafter(edges, np.float32(-np.inf))])
    pts = rng.uniform(-14.0, 14.0, (3, 3 * on.size)).astype(np.float32)
    for a in range(3):
        pts[a, a * on.size:(a + 1) * on.size] = on
    return pts


def _points(seed: int, n: int) -> np.ndarray:
    """Random points near the object in some cell and anywhere, then the
    boundary points."""
    rng = np.random.default_rng(seed)
    near = rng.uniform(-2.2, 2.2, (3, n)).astype(np.float32)
    near += CELL * rng.integers(-2, 3, (3, n)).astype(np.float32)
    far = rng.uniform(-14.0, 14.0, (3, n)).astype(np.float32)
    return np.concatenate([near, far, _boundary_points(rng)], axis=1)


@pytest.mark.parametrize("transform", list(TRANSFORMS))
def test_lowered_program_value_is_wrapped_csdf_bit_for_bit(transform):
    """(a) The lowered program's value equals WrappedCsdf's, bit for bit."""
    p = _params(transform)
    flat, _, wrapped = _lowered(p)
    x, y, z = (torch.from_numpy(v) for v in _points(11, 4096))
    got = tcsdf.param_program_csdf(wrapped.prog)(wrapped.extend(flat), x, y, z)
    want = get_scene("wrapped_object", device="cpu").csdf(p, x, y, z)
    assert not torch.isnan(want).any()
    assert torch.equal(got, want)


def _close(got, want) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    scale = max(np.abs(want).max(initial=0.0), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


@pytest.mark.parametrize("grad", [False, True], ids=["value", "value and gradient"])
@pytest.mark.parametrize("transform", list(TRANSFORMS))
def test_folded_sweep_matches_autograd(transform, grad):
    """(b) The sweep of the lowered program, its private slots folded back,
    against autograd of WrappedCsdf: the backward of the value, or the
    double backward of the value and its gradient under numpy-seeded
    adjoints."""
    p = _params(transform)
    flat, layout, wrapped = _lowered(p)
    pts = _points(13, POINTS)
    rng = np.random.default_rng(17)
    sv = torch.from_numpy(rng.normal(size=pts.shape[1]).astype(np.float32))
    sg = tuple(torch.from_numpy(g) for g in rng.normal(size=pts.shape).astype(np.float32))
    x, y, z = (torch.from_numpy(v) for v in pts)
    value, g, slot_bar, x_bar = tcsdf.param_program_adjoint_torch(
        wrapped.prog, wrapped.extend(flat), x, y, z, sv, sg if grad else None)
    assert slot_bar.shape[-1] == flat.numel() + 3 + len(wrapped.constants)
    flat_bar = wrapped.fold(slot_bar).sum(0)

    fl = flat.clone().requires_grad_(True)
    xs = [v.clone().requires_grad_(True) for v in (x, y, z)]
    ref = get_scene("wrapped_object", device="cpu").csdf(unflatten_params(fl, layout), *xs)
    assert torch.equal(value, ref.detach())
    psi = (sv * ref).sum()
    if grad:
        ref_g = torch.autograd.grad(ref.sum(), xs, create_graph=True)
        for a, b in zip(g, ref_g):
            assert torch.allclose(a, b.detach(), rtol=1e-6, atol=1e-6)
        psi = psi + sum((s * v).sum() for s, v in zip(sg, ref_g))
    want = torch.autograd.grad(psi, [fl, *xs])
    _close(flat_bar, want[0])
    assert abs(float(want[0][param_offsets(layout)["cell"]])) > 0.0
    for a, b in zip(x_bar, want[1:]):
        _close(a, b)


@pytest.mark.parametrize("case", ["wrapped_object", "wrapped_object cell", "lattice cell"])
def test_sweep_route_matches_xla(case):
    """(c) K5 by the reverse sweep's route against JAX's XLA render, edge
    term on; the cell's gradient not small."""
    name, factors = CASES[case]
    jscene, scene = _scenes(name)
    (o, d, c), rays = _rays(SIZE)
    jp = _point(jscene, factors)
    target = _target(scene, scene.params, rays, None)
    ref_loss, ref_g = jax_render_loss_and_grad(jscene.sdf, jp, jnp.asarray(target.numpy()), o, d,
                                               c, csdf=jscene.csdf, edge_weight=1.0)
    loss, g = dk.render_loss_grad_sweep_torch(scene.csdf, _torch_params(jp), target, *rays,
                                              edge_weight=1.0)
    _assert_loss_grad(loss, g, ref_loss, ref_g)
    cell = "cell" if name == "wrapped_object" else "n0_cell"
    assert g[cell].abs().max() > 1e-4


@pytest.mark.parametrize("transform", list(TRANSFORMS))
def test_wrapped_struct_carries_the_lowered_program(transform):
    """param_scene_c of the wrapped object: the flat vector, then the
    private slots (the cell three times, the sphere's centre, a present
    transform's absent part), K5's gradient that wide, the program's words
    and the fold."""
    p = _params(transform)
    flat, layout, wrapped = _lowered(p)
    sc, got_layout = dk.param_scene_c(get_scene("wrapped_object", device="cpu").csdf, p,
                                      device="cpu")
    assert got_layout == layout and sc.form == dk.FORM_WRAPPED
    private = {"identity": 6, "turned": 6, "none": 6, "translation only": 10,
               "rotation only": 9}[transform]
    assert (sc.n_prm, sc.n_slots) == (flat.numel(), flat.numel() + private)
    assert list(sc.prm)[:sc.n_slots] == wrapped.extend(flat).tolist()
    assert sc.cell == param_offsets(layout)["cell"]
    assert [ins.op for ins in wrapped.prog][0] == tcsdf.OP_PUSH_WRAP
    moved = transform != "none"
    assert sc.program_length == (7 if moved else 5) and sc.program
    assert (sc.program_depth, sc.program_frames) == (2, 2 if moved else 1)
    words = sc.program_words.numpy()
    assert (words == tcsdf.param_program_words(wrapped.prog)).all()
    folded = sc.fold(torch.arange(sc.n_slots, dtype=torch.float32))
    n, cell = flat.numel(), sc.cell
    want = torch.arange(n, dtype=torch.float32)
    want[cell] += (n + (n + 1)) + (n + 2)
    assert torch.equal(folded, want)
