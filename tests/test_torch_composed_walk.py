"""The forward walk of a composed scene's node program on the CPU: the words
that K1, K2 and K3 stage in shared memory (``ops/cuda/csdf.py::
walk_words``; ``csrc/composed.cuh`` ``composed_sdf``) and their plain twin
``walk_csdf``. The render twins run the node program's twin
(``_program_csdf``), an interpreter independent of these words, so the card
holds the walk against it.

* the walk's twin equals the node program's twin (``_program_csdf``, the
  taped walk's value) bit for bit, NaN at the same places, at 20,000 points
  drawn by numpy from seed 20 (``test_torch_compose._points``), and JAX's
  baked ``composed_baked_csdf`` within its bar (2e-5, NaN at the same
  places), for the three examples, the ground, the lattice, the 40-sphere
  union, the ten nested transforms and the right-nested union;
* the encoding: a fold whose right operand is one primitive, inside any
  frames, fused into it; each header's size; the caps mirrored in
  ``composed.cuh``;
* the tier chosen per walk (``large_tier``, ``kernel_structure``): the
  union takes the small tier's forward walk and the large tier's taped one;
  the nested transforms (10 frames) and the right-nested union (18 values)
  the large tier in both; a walk beyond the words the small tier stages the
  large tier;
* K1's twin with the walk's twin as its SDF against the JAX package's XLA
  render at 64x36, by ``test_torch_compose``'s bars (outcomes equal, the
  image within the reference scene's bars).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsdmg_tpu.models import compose as jcompose
from bsdmg_tpu.ops import shade as jshade
from bsdmg_tpu.ops import trace as jtrace
from bsdmg_tpu_torch.models import compose as tcompose
from bsdmg_tpu_torch.ops.cuda import csdf as tcsdf
from bsdmg_tpu_torch.ops.cuda import render_kernel
from bsdmg_tpu_torch.ops.cuda.render_kernel import render_image_cuda
from test_torch_compose import COLLISION, SPECS, _desc, _pair, _points, _rays
from test_torch_mesh import LARGE_SPECS
from test_torch_render_kernel import assert_image_bars

torch.set_num_threads(1)

CSRC = Path(tcsdf.__file__).resolve().parents[2] / "csrc"
NAMES = sorted(SPECS) + sorted(LARGE_SPECS)
SEED = 20


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    """Equal bit for bit, NaN at the same places."""
    return bool(((a == b) | (np.isnan(a) & np.isnan(b))).all())


@pytest.mark.parametrize("name", NAMES)
def test_walk_equals_the_node_program_and_jax(name):
    """The walk's twin against the node program's twin, bit for bit, and
    against JAX's baked SDF within 2e-5, NaN at the same places."""
    ref, _ = _pair(name)
    desc = _desc(name)
    p = _points(SEED, lim=4.0 if name == "lattice" else 2.2)
    cols = [torch.from_numpy(p[:, a].copy()) for a in range(3)]
    walk = tcsdf.walk_csdf(desc.program.walk)(*cols).numpy()
    node = tcsdf._program_csdf(desc.program.instructions)(*cols).numpy()
    assert _same(walk, node)
    assert _same(tcsdf.descriptor_csdf(desc)(*cols).numpy(), node)  # the render twins' SDF
    want = np.asarray(jcompose.composed_baked_csdf(ref, ref.params)(
        *(jnp.asarray(p[:, a]) for a in range(3))))
    np.testing.assert_array_equal(np.isnan(walk), np.isnan(want))
    np.testing.assert_allclose(walk, want, atol=2e-5, rtol=0)


def test_walk_encoding_fuses_folds_into_primitives():
    """The gadget's walk: box (set), sphere with the subtract fused, the
    transform, box pushed below the top, shell, pop, the union popping its
    left operand, the skeleton with the root union fused; each header's
    size its words, the constants the instructions' float32 bits (a fused
    fold's after its primitive's). The union of 40 spheres: a set and 39
    fused unions, so its walk touches no stack; the right-nested union
    pushes 16 values below the top, its innermost union fused into the
    last sphere, and pops them with 16 unfused unions."""
    desc = _desc("gadget")
    prog, walk = desc.program.instructions, desc.program.walk
    code = tcsdf._walk_instructions(walk)
    assert [(op, action) for op, action, _, _ in code] == [
        (tcsdf.OP_BOX, tcsdf.WALK_SET), (tcsdf.OP_SPHERE, tcsdf.OP_SUB),
        (tcsdf.OP_PUSH_TRANSFORM, 0), (tcsdf.OP_BOX, tcsdf.WALK_PUSH), (tcsdf.OP_SHELL, 0),
        (tcsdf.OP_POP, 0), (tcsdf.OP_MIN, 0), (tcsdf.OP_SKELETON, tcsdf.OP_MIN)]
    kept = [ins for ins in prog if ins.op not in (tcsdf.OP_SUB,) and ins is not prog[-1]]
    for (op, _, consts, fold), ins in zip(code, kept, strict=True):
        assert op == ins.op and consts == ins.constants and fold == ()
    sizes, pc = [], 0
    while pc < len(walk):
        sizes.append(int(walk[pc]) >> 8)
        pc += sizes[-1]
    assert pc == len(walk) and sizes == [1 + len(c) + len(f) for _, _, c, f in code]

    union = tcsdf._walk_instructions(_desc("deep").program.walk)
    assert [(op, a) for op, a, _, _ in union] == (
        [(tcsdf.OP_SPHERE, tcsdf.WALK_SET)] + [(tcsdf.OP_SPHERE, tcsdf.OP_MIN)] * 39)
    nested = [(op, a) for op, a, _, _ in tcsdf._walk_instructions(
        _desc("right-nested").program.walk)]
    assert nested.count((tcsdf.OP_SPHERE, tcsdf.WALK_PUSH)) == 16
    assert nested.count((tcsdf.OP_SPHERE, tcsdf.OP_MIN)) == 1
    assert nested.count((tcsdf.OP_MIN, 0)) == 16

    smooth = tcsdf._walk_instructions(_desc("snowman").program.walk)
    fused = [(c, f) for op, a, c, f in smooth if a == tcsdf.OP_SMOOTH]
    assert fused and all(len(f) == 2 and f[1] == float(np.float32(1.0 / 6.0)) for _, f in fused)

    header = (CSRC / "composed.cuh").read_text()
    for macro, value in (("BSDMG_WALK_WORDS", tcsdf.WALK_CAP),
                         ("BSDMG_WALK_SET", tcsdf.WALK_SET), ("BSDMG_WALK_PUSH", tcsdf.WALK_PUSH)):
        assert re.search(rf"#define {macro} {value}\b", header), macro


@pytest.mark.parametrize("name, forward, taped", [
    ("gadget", tcsdf.COMPOSED, tcsdf.COMPOSED),
    ("lattice", tcsdf.COMPOSED, tcsdf.COMPOSED),
    ("deep", tcsdf.COMPOSED, tcsdf.COMPOSED_LARGE),
    ("nested", tcsdf.COMPOSED_LARGE, tcsdf.COMPOSED_LARGE),
    ("right-nested", tcsdf.COMPOSED_LARGE, tcsdf.COMPOSED_LARGE),
])
def test_tier_is_chosen_per_walk(name, forward, taped):
    """K1, K2 and K3 take the forward walk's tier (no length cap), K6 and K7
    the taped walk's (``PROGRAM_CAP`` for the tape)."""
    desc = _desc(name)
    prog = desc.program.instructions
    assert tcsdf.kernel_structure(desc, taped=False) == forward
    assert tcsdf.kernel_structure(desc, taped=True) == taped == tcsdf.kernel_structure(desc)
    assert tcsdf.large_tier(prog, forward=True) == (forward == tcsdf.COMPOSED_LARGE)
    assert tcsdf.large_tier(prog) == (taped == tcsdf.COMPOSED_LARGE)


def test_walk_beyond_its_shared_memory_takes_the_large_tier():
    """A union of spheres whose walk outgrows the words of shared memory
    that the small tier stages (5 words a fused sphere) runs in the large
    tier; the longest union they hold stays in the small one."""
    fits = (tcsdf.WALK_CAP - 5) // 5 + 1  # the first sphere's 5 words, then 5 each

    def union(n):
        spec = {"name": "u", "root": {"op": "union", "children": [
            {"prim": "sphere", "center": [0.01 * i, 0.0, 0.0], "radius": 0.2}
            for i in range(n)]}}
        return tcsdf.compile_scene(tcompose.compose_scene(spec, device="cpu"))

    small, large = union(fits), union(fits + 1)
    assert len(small.program.walk) <= tcsdf.WALK_CAP < len(large.program.walk)
    assert tcsdf.kernel_structure(small, taped=False) == tcsdf.COMPOSED
    assert tcsdf.kernel_structure(large, taped=False) == tcsdf.COMPOSED_LARGE


@pytest.mark.parametrize("name", NAMES)
def test_k1_twin_over_the_walk_renders_like_jax(name, monkeypatch):
    """K1's twin (the fused render, culled where the scene has bounds), its
    SDF the walk's twin in place of the node program's, against the JAX
    package's XLA render at 64x36: outcomes equal on every pixel, the image
    within the bars."""
    plain = render_kernel.descriptor_csdf
    monkeypatch.setattr(render_kernel, "descriptor_csdf", lambda desc: (
        tcsdf.walk_csdf(desc.program.walk) if desc.kind == "composed" else plain(desc)))
    (jo, jd, jc), rays = _rays(64, 36)
    jscene, _ = _pair(name)
    outcome = np.asarray(jtrace.sphere_trace(jscene.bind(), jo, jd, jc).outcome)
    image = np.asarray(jshade.render_image(jscene.bind(), jo, jd, jc))
    rgb, _, _, got = (t.numpy() for t in render_image_cuda(_desc(name), *rays,
                                                           return_planes=True))
    np.testing.assert_array_equal(got, outcome)
    assert (got == COLLISION).sum() > 50
    assert_image_bars(rgb, image)
