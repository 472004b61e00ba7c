"""The reverse sweep of K5's composed scenes (csrc/param_program.cuh
program_record and program_reverse, kernel ``loss_reverse_kernel`` in
csrc/diff_kernel.cu) in plain PyTorch: ``ops/cuda/csdf.py::
param_program_adjoint_torch``, the kernels' adjoint rules op by op in their
order, on numpy-seeded points and adjoints.

A sweep takes the adjoint of the program's value and, in the form K5 runs
at a hit, of its spatial gradient too, and gives the adjoints of the flat
parameter vector and of the point. It is held:

* against torch autograd: the backward, and the double backward of the
  gradient, of ``param_program_csdf`` (the twin, bit-equal to the spec's
  component form);
* against ``jax.vjp`` of the JAX package's composed scene's value and
  ``jax.grad`` (``bsdmg_tpu/models/compose.py`` ``_eval``), where JAX's are
  finite: a box's inside and a cylinder's axis meet ``sqrt(0)``, whose
  infinite weight JAX's reverse mode multiplies by 0 (NaN) where the
  kernels' forward rules (``nested_dual.cuh psqrt``) and torch's selects
  keep 0 (tests/test_torch_fit_scenes.py, the gadget).

Cases: each of the 15 opcodes (csrc/program.cuh Op) in a spec of its own,
ties of min and max (identical operands) and a smooth union whose blend is
zero at most points and a tie at some; the gadget, mushroom, snowman,
ground and lattice (tests/test_torch_compose.py), the 40-sphere union and
ten nested transforms (tests/test_torch_mesh.py LARGE_SPECS). Tolerance:
each adjoint within 1e-5 of the largest magnitude of the reference's (float32
sums in other orders), NaN at the same places as autograd's, and the value
and gradient of the forward pass equal to the twin's.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsdmg_tpu.models.compose import compose_scene as jax_compose_scene
from bsdmg_tpu_torch.models.compose import compose_scene
from bsdmg_tpu_torch.ops.cuda import csdf as tcsdf
from bsdmg_tpu_torch.weights import flatten_params, param_offsets
from test_torch_compose import SPECS
from test_torch_mesh import LARGE_SPECS

torch.set_num_threads(1)

RTOL = 1e-5
POINTS = 24

_S = {"prim": "sphere", "center": [0.1, 0.2, -0.1], "radius": 0.8}
_B = {"prim": "box", "center": [0.1, 0.0, 0.2], "size": [1.0, 0.8, 1.2]}
#: one spec an opcode (the 7 primitives, the 4 folds, shell, push transform,
#: push wrap and pop), ties and zero blends among them
OPCODES = {
    "sphere": _S,
    "box": _B,
    "capsule": {"prim": "capsule", "start": [-0.5, 0.1, 0.0], "end": [0.6, 0.3, 0.2],
                "radius": 0.3},
    "box_skeleton": {"prim": "box_skeleton", "center": [0.0, 0.1, 0.0], "size": [1.6, 1.2, 1.0],
                     "line_width": 0.04},
    "torus": {"prim": "torus", "center": [0.0, 0.1, 0.0], "major_radius": 0.7,
              "minor_radius": 0.2},
    "cylinder": {"prim": "cylinder", "center": [0.0, 0.1, 0.0], "radius": 0.4, "height": 1.2},
    "plane": {"prim": "plane", "normal": [0.1, 1.0, 0.2], "offset": -0.5},
    "union (a tie everywhere)": {"op": "union", "children": [_S, copy.deepcopy(_S)]},
    "intersect (a tie everywhere)": {"op": "intersect", "children": [_B, copy.deepcopy(_B)]},
    "subtract": {"op": "subtract", "children": [_B, _S]},
    "smooth_union (zero blends, ties)": {"op": "smooth_union", "k": 0.3, "children": [
        _S, {"prim": "sphere", "center": [0.1, 0.2, -0.1], "radius": 0.8}]},
    "smooth_union": {"op": "smooth_union", "k": 0.5, "children": [
        _S, {"prim": "sphere", "center": [0.5, 0.3, 0.0], "radius": 0.6}]},
    "shell": {"op": "shell", "thickness": 0.1, "child": _B},
    "transform": {"op": "transform", "offset": [0.1, 0.2, 0.0],
                  "rotation": [0.9238795, 0.0, 0.2, 0.3826834], "child": _B},
    "wrap": {"op": "wrap", "cell": [1.5, 2.0, 1.7], "child": {
        "prim": "torus", "major_radius": 0.5, "minor_radius": 0.15}},
    "pop": {"op": "union", "children": [
        {"op": "transform", "offset": [0.3, 0.0, 0.0], "rotation": [0.8, 0.6, 0.0, 0.0],
         "child": _S}, _B]},
}
NAMED = {**{n: SPECS[n] for n in ("gadget", "mushroom", "snowman", "ground", "lattice")},
         "40-sphere union": LARGE_SPECS["deep"], "ten nested transforms": LARGE_SPECS["nested"]}
CASES = {**{k: {"name": "case", "root": v} for k, v in OPCODES.items()}, **NAMED}


def _setup(spec, seed: int):
    scene = compose_scene(copy.deepcopy(spec), device="cpu")
    flat, layout = flatten_params(scene.params)
    prog = tcsdf.param_program(scene.spec, param_offsets(layout))
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2.0, 2.0, (3, POINTS)).astype(np.float32)
    seed_v = rng.normal(size=POINTS).astype(np.float32)
    seed_g = rng.normal(size=(3, POINTS)).astype(np.float32)
    return scene, flat, layout, prog, pts, seed_v, seed_g


def _close(got, want, nan_too: bool = True) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if nan_too:
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = np.isfinite(want)
    scale = max(np.abs(want[ok]).max(initial=0.0), 1e-30)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=RTOL * scale)


@pytest.mark.parametrize("grad", [False, True], ids=["value", "value and gradient"])
@pytest.mark.parametrize("name", list(CASES))
def test_sweep_matches_autograd(name, grad):
    """The sweep's adjoints against autograd's backward (the value alone) or
    double backward (the value and the gradient) of the twin."""
    _, flat, _, prog, pts, seed_v, seed_g = _setup(CASES[name], 3)
    x, y, z = (torch.from_numpy(p) for p in pts)
    sv = torch.from_numpy(seed_v)
    sg = tuple(torch.from_numpy(g) for g in seed_g) if grad else None
    value, g, flat_bar, x_bar = tcsdf.param_program_adjoint_torch(prog, flat, x, y, z, sv, sg)

    fl = flat.clone().requires_grad_(True)
    xs = [v.clone().requires_grad_(True) for v in (x, y, z)]
    ref = tcsdf.param_program_csdf(prog)(fl, *xs)
    assert torch.equal(value, ref.detach())
    psi = (sv * ref).sum()
    if grad:
        ref_g = torch.autograd.grad(ref.sum(), xs, create_graph=True)
        for a, b in zip(g, ref_g):
            assert torch.allclose(a, b.detach(), rtol=1e-6, atol=1e-6, equal_nan=True)
        psi = psi + sum((s * v).sum() for s, v in zip(sg, ref_g))
    want = torch.autograd.grad(psi, [fl, *xs], allow_unused=True)
    _close(flat_bar.sum(0), want[0])
    for a, b in zip(x_bar, want[1:]):
        _close(a, torch.zeros_like(a) if b is None else b)


@pytest.mark.parametrize("name", list(CASES))
def test_sweep_matches_jax_vjp(name):
    """The sweep of the value and gradient against ``jax.vjp`` of the JAX
    package's composed value and ``jax.grad``, where JAX's adjoints are
    finite."""
    scene, flat, layout, prog, pts, seed_v, seed_g = _setup(CASES[name], 5)
    _, _, flat_bar, x_bar = tcsdf.param_program_adjoint_torch(
        prog, flat, *(torch.from_numpy(p) for p in pts), torch.from_numpy(seed_v),
        tuple(torch.from_numpy(g) for g in seed_g))
    jscene = jax_compose_scene(copy.deepcopy(CASES[name]))
    params = {k: jnp.asarray(v.numpy()) for k, v in scene.params.items()}

    def value_grad(p, q):
        f = lambda r: jscene.csdf(p, r[0], r[1], r[2])  # noqa: E731
        return jax.value_and_grad(f)(q)

    both = jax.vmap(value_grad, in_axes=(None, 1), out_axes=(0, 1))
    (_, _), pull = jax.vjp(both, params, jnp.asarray(pts))
    p_bar, q_bar = pull((jnp.asarray(seed_v), jnp.asarray(seed_g)))
    want = np.concatenate([np.asarray(p_bar[k], np.float32).reshape(-1) for k, _ in layout])
    _close(flat_bar.sum(0).numpy(), want, nan_too=False)
    _close(np.stack([v.numpy() for v in x_bar]), np.asarray(q_bar), nan_too=False)


def test_gadget_sweep_is_finite_where_jax_is_nan():
    """Inside the gadget's box the sweep, as the kernels' forward rules,
    stays finite where JAX's reverse mode is NaN."""
    scene, flat, layout, prog, _, seed_v, seed_g = _setup(SPECS["gadget"], 7)
    # points inside the box minus sphere: its box's inside distance
    pts = np.array([[0.55, 0.0, 0.0], [0.0, 0.55, 0.0], [0.0, 0.0, 0.55]], np.float32)
    pts = np.tile(pts.T, (1, POINTS // 3))
    _, _, flat_bar, x_bar = tcsdf.param_program_adjoint_torch(
        prog, flat, *(torch.from_numpy(p) for p in pts), torch.from_numpy(seed_v),
        tuple(torch.from_numpy(g) for g in seed_g))
    assert torch.isfinite(flat_bar).all() and all(torch.isfinite(v).all() for v in x_bar)
