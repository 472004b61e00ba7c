"""The port's multi-device paths (``bsdmg_tpu_torch/parallel/``) against
the single-device port and the JAX package's ``bsdmg_tpu/parallel``.

Two gloo worlds on the CPU, spawned once for the module and run while the
JAX side computes: two ranks on a 2x1 ``dp x sp`` mesh and four on 2x2
(``tests/torch_parallel_ranks.py::parallel_rank``). The JAX side runs in
this process on a mesh of as many of its 8 virtual devices. Inputs are
JAX's rays and numpy arrays from a seed; parameters and grids cross
through ``weights.py``.

* ``make_mesh``, ``shard_rays``, ``interleave_rows`` and ``shard_voxels``: JAX's shapes,
  errors and blocks, bit for bit;
* the sharded frame (K1's twin; K2 and K3's with ``two_phase=True``; block
  retirement) is bit-equal to the single-device render in the same mode,
  and within ``test_render_sharded_pallas_matches_single_device``'s bars of
  JAX's ``render_sharded_pallas`` (interpret mode);
* the sharded grid frame (K9, K8 and P1's twins) is bit-equal to the
  single-device grid render and within ``test_render_grid_sharded_matches_
  single``'s bars of JAX's ``render_grid_sharded``;
* ``train_step_fused`` (K5's twin) and ``train_step`` (K4's twin and
  autograd) with SGD against JAX's steps and its XLA ``value_and_grad``,
  at JAX's bars; the parameters bit-equal across ranks; the gradient the
  step sums over the world within 1e-5 of the unsharded gradient's norm;
* the sharded mesh has the single-device counts and JAX's sorted vertices
  within 1e-6; the sharded refine's survivor set and ``ShardedField.
  gather()`` equal the single-device set;
* two processes joined through ``BSDMG_*``, ``dryrun_multichip(4)``, the
  CLI's ``--sharded`` verbs and the scaling benches' keys.
"""

import os
import re
import subprocess
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import torch_parallel_ranks as ranks
from bsdmg_tpu.cam import generate_rays as jax_generate_rays
from bsdmg_tpu.cam import look_at as jax_look_at
from bsdmg_tpu.config import MeshGenConfig as JaxMeshGenConfig
from bsdmg_tpu.grad import render_image_diff as jax_render_image_diff
from bsdmg_tpu.models import reference_object as jax_reference_object
from bsdmg_tpu.models import reference_render_scene as jax_render_scene
from bsdmg_tpu.models.mesh_sdf import SdfGrid as JaxSdfGrid
from bsdmg_tpu.ops.pallas import compile_scene_csdf
from bsdmg_tpu.ops.pallas.csdf import scene_bounds as jax_scene_bounds
from bsdmg_tpu.ops.pallas.grid_kernel import make_contraction_levels as jax_levels
from bsdmg_tpu.parallel import generate_mesh_sharded as jax_generate_mesh_sharded
from bsdmg_tpu.parallel import make_mesh as jax_make_mesh
from bsdmg_tpu.parallel import render_sharded_pallas as jax_render_sharded_pallas
from bsdmg_tpu.parallel import shard_rays as jax_shard_rays
from bsdmg_tpu.parallel import train_step as jax_train_step
from bsdmg_tpu.parallel import train_step_fused as jax_train_step_fused
from bsdmg_tpu.parallel.multihost import shard_voxels as jax_shard_voxels
from bsdmg_tpu.parallel.sharding import interleave_rows as jax_interleave_rows
from bsdmg_tpu.parallel.sharding import render_grid_sharded as jax_render_grid_sharded
from bsdmg_tpu_torch import cli
from bsdmg_tpu_torch.config import MeshGenConfig
from bsdmg_tpu_torch.grad import render_image_diff
from bsdmg_tpu_torch.graft_entry import dryrun_multichip
from bsdmg_tpu_torch.mesh.field import create_voxel_field, refine_field
from bsdmg_tpu_torch.mesh.pipeline import generate_mesh
from bsdmg_tpu_torch.models import reference_object, reference_render_scene, sphere_scene
from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene
from bsdmg_tpu_torch.ops.cuda.diff_kernel import render_loss_grad_cuda
from bsdmg_tpu_torch.ops.cuda.grid_kernel import render_image_grid
from bsdmg_tpu_torch.ops.cuda.render_kernel import render_image_cuda
from bsdmg_tpu_torch.parallel import collectives, make_mesh, render_sharded_pallas
from bsdmg_tpu_torch.parallel.launch import free_port, spawn
from bsdmg_tpu_torch.parallel.sharding import interleave_rows
from bsdmg_tpu_torch.weights import grid_from_numpy, params_from_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
#: ranks -> the dp x sp mesh they form
WORLDS = {2: (2, 1), 4: (2, 2)}
W, H = 128, 32
GRID_RES, GRID_W, GRID_H = 48, 64, 32
LR = 1e-2
#: the summed gradient of a sharded step against the unsharded one
STEP_GRAD_REL = 1e-5
SPAWN_TIMEOUT = 240.0


def _rays(w, h, camera=(5.0, 2.0, -5.0), screen=(1920.0, 1080.0)):
    cam = jax_look_at(camera, (0.0, 0.0, 0.0), fov=np.pi / 4)
    return tuple(np.array(a) for a in jax_generate_rays(cam, (w, h), screen))


def _sphere_grid():
    ax = np.linspace(-1.5, 1.5, GRID_RES, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return np.sqrt(x * x + y * y + z * z) - 1.0, (-1.5,) * 3, (1.5,) * 3


def _fit_params(scene):
    return {k: np.asarray(v) for k, v in scene.params.items()
            if k not in ("object_center", "object_rotation")}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    scene = jax_render_scene()
    return {
        "noise": tuple(rng.normal(size=s).astype(np.float32)
                       for s in ((H, W, 3), (H, W, 3), (H, W))),
        "rays": _rays(W, H),
        "grid": _sphere_grid(),
        "grid_rays": _rays(GRID_W, GRID_H, (2.5, 1.0, -2.5), (float(GRID_W), float(GRID_H))),
        "fit_rays": _rays(W, H, screen=(float(W), float(H))),
        "target": rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
        "voxels": rng.uniform(-2, 2, (37, 3)).astype(np.float32),
        "fit": _fit_params(scene),
        "scene_params": {k: np.asarray(v) for k, v in scene.params.items()},
    }


def _multihost():
    """tests/test_multihost.py's two processes, joined through
    BSDMG_COORDINATOR/NUM_PROCESSES/PROCESS_ID: their outputs."""
    port = free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_parallel_ranks.py")],
            env={**os.environ, "BSDMG_COORDINATOR": f"localhost:{port}",
                 "BSDMG_NUM_PROCESSES": "2", "BSDMG_PROCESS_ID": str(pid)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in (0, 1)
    ]
    try:
        return [p.communicate(timeout=SPAWN_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait(10)


@pytest.fixture(scope="module")
def background(inputs, tmp_path_factory):
    """Every spawned world and process, and every JAX reference, computed
    at once in the background: name -> future."""
    jobs = {
        **{f"world{n}": (spawn, ranks.parallel_rank, n, shape, inputs, n == 2)
           for n, shape in WORLDS.items()},
        "world1": (spawn, ranks.bench_rank, 1),
        "dryrun": (dryrun_multichip, 4),
        "multihost": (_multihost,),
        "jax_frame": (_jax_frame, inputs),
        "jax_grid": (_jax_grid_frame, inputs),
        "jax_steps": (_jax_steps, inputs),
        "jax_mesh": (_jax_sharded_mesh,),
        "spawn_faults": (_spawn_faults, tmp_path_factory.mktemp("spawn")),
    }
    options = {"device": "cpu", "timeout": SPAWN_TIMEOUT}
    with ThreadPoolExecutor(len(jobs)) as pool:
        yield {name: pool.submit(fn, *args, **(options if fn is spawn else {}))
               for name, (fn, *args) in jobs.items()}


def _get(background, name):
    return background[name].result(timeout=2 * SPAWN_TIMEOUT)


def _world(background, n):
    return _get(background, f"world{n}")


def _jax_mesh(n):
    return jax_make_mesh(jax.devices()[:n], shape=WORLDS[n])


@pytest.fixture
def own_world():
    """A test that forms a world of one in this process leaves none behind."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# make_mesh, shard_rays, interleave_rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h, n", [(32, 2), (33, 4), (64, 8), (7, 3)])
def test_interleave_rows_equals_jax(h, n):
    np.testing.assert_array_equal(interleave_rows(h, n), jax_interleave_rows(h, n))


@pytest.mark.parametrize("n", sorted(WORLDS))
def test_make_mesh_matches_jax(background, n):
    mesh = _jax_mesh(n)
    with pytest.raises(ValueError) as jax_error:
        jax_make_mesh(jax.devices()[:n], shape=(3, 2))
    results = _world(background, n)
    coords = set()
    for r in results:
        assert r["names"] == tuple(mesh.axis_names)
        assert r["shape"] == tuple(mesh.shape[a] for a in mesh.axis_names)
        assert r["bad_shape"] == str(jax_error.value)
        coords.add(r["coordinate"])
    assert coords == {(i, j) for i in range(WORLDS[n][0]) for j in range(WORLDS[n][1])}


@pytest.mark.parametrize("interleave", [True, False])
@pytest.mark.parametrize("n", sorted(WORLDS))
def test_shard_rays_blocks_equal_jax(background, inputs, n, interleave):
    """Each rank's block is the shard JAX places on the device at its
    mesh coordinate, bit for bit."""
    mesh = _jax_mesh(n)
    sharded = jax_shard_rays(*inputs["noise"], mesh, interleave=interleave)[:3]
    where = {d: idx for idx, d in np.ndenumerate(mesh.devices)}
    for r in _world(background, n):
        for port, ref in zip(r["blocks"][interleave], sharded):
            (shard,) = [s for s in ref.addressable_shards if where[s.device] == r["coordinate"]]
            np.testing.assert_array_equal(port, np.asarray(shard.data))


@pytest.mark.parametrize("n", sorted(WORLDS))
def test_shard_voxels_blocks_equal_jax(background, inputs, n):
    """multihost.shard_voxels: 37 voxels padded to a multiple of dp with far
    voxels, each rank holding JAX's shard at its dp coordinate."""
    mesh = _jax_mesh(n)
    ref = jax_shard_voxels(jnp.asarray(inputs["voxels"]), mesh)
    blocks = {s.index[0].start or 0: np.asarray(s.data) for s in ref.addressable_shards}
    for r in _world(background, n):
        start = r["coordinate"][0] * r["voxel_block"].shape[0]
        np.testing.assert_array_equal(r["voxel_block"], blocks[start])


def test_make_mesh_forms_a_world_of_one(own_world):
    mesh = make_mesh(device="cpu")
    assert tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("dp", "sp")
    with pytest.raises(ValueError, match=re.escape("mesh shape (2, 1) != 1 devices")):
        make_mesh(shape=(2, 1), device="cpu")


def test_make_mesh_takes_the_world_s_ranks_in_order(own_world):
    assert tuple(make_mesh(devices=[0], device="cpu").shape) == (1, 1)
    for devices in ([1], [0, 0], []):
        with pytest.raises(ValueError, match="the mesh takes the world's ranks"):
            make_mesh(devices=devices, device="cpu")


def _spawn_faults(directory):
    """A world whose rank 1 raises, and one that hangs past its timeout:
    what each spawn raised, and the pids of the ranks that waited."""
    out = {}
    for name, fn, timeout in (("failing", ranks.failing_rank, SPAWN_TIMEOUT),
                              ("hanging", ranks.hanging_rank, 10.0)):
        where = Path(directory) / name
        where.mkdir()
        try:
            spawn(fn, 2, str(where), device="cpu", timeout=timeout)
            out[name] = None
        except Exception as e:  # noqa: BLE001 - the test reads what was raised
            out[name] = (type(e).__name__, str(e))
        out[f"{name}_pids"] = [int(f.read_text()) for f in sorted(where.glob("*.pid"))]
    return out


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


@pytest.mark.parametrize("fault", ["failing", "hanging"])
def test_spawn_raises_and_stops_every_rank(background, fault):
    """A rank that raises fails the spawn with its traceback, a world that
    outlives its timeout fails it too, and no rank outlives either."""
    out = _get(background, "spawn_faults")
    kind, message = out[fault]
    if fault == "failing":
        assert kind == "RuntimeError" and "rank 1:" in message
        assert "ValueError: a planted failure" in message
        assert len(out["failing_pids"]) == 1
    else:
        assert kind == "RuntimeError" and "2 of 2 ranks gave no result" in message
        assert len(out["hanging_pids"]) == 2
    assert not [pid for pid in out[f"{fault}_pids"] if _alive(pid)]


# ---------------------------------------------------------------------------
# sharded frames
# ---------------------------------------------------------------------------


def _jax_frame(inputs):
    scene = jax_render_scene()
    return np.asarray(jax_render_sharded_pallas(
        compile_scene_csdf(scene), *inputs["rays"], _jax_mesh(4), bb=jax_scene_bounds(scene),
        interpret=True,
    ))


@pytest.mark.parametrize("mode", ranks.MODES, ids=["single", "row", "block"])
@pytest.mark.parametrize("n", sorted(WORLDS))
def test_render_sharded_is_bit_equal_to_single_device(background, inputs, n, mode):
    desc = compile_scene(reference_render_scene(device="cpu"))
    single = render_image_cuda(desc, *ranks.tensors(*inputs["rays"]), two_phase=mode,
                               phase_a_steps=48).numpy()
    for r in _world(background, n):
        np.testing.assert_array_equal(r["frames"][str(mode)], single)


@pytest.mark.parametrize("n", sorted(WORLDS))
def test_render_sharded_matches_jax_render_sharded_pallas(background, n):
    jax_frame = _get(background, "jax_frame")
    """tests/test_parallel.py::test_render_sharded_pallas_matches_single_device's bars."""
    for r in _world(background, n):
        diff = np.abs(r["frames"]["False"] - jax_frame)
        assert (diff.max(-1) > 2e-2).mean() == 0.0
        assert diff.mean() < 1e-4


def _jax_grid_frame(inputs):
    values, lo, hi = inputs["grid"]
    grid = JaxSdfGrid(values=values, lo=lo, hi=hi)
    return np.asarray(jax_render_grid_sharded(grid, *inputs["grid_rays"], _jax_mesh(4),
                                              levels=jax_levels(grid), interpret=True))


@pytest.mark.parametrize("n", sorted(WORLDS))
def test_render_grid_sharded_matches_single_and_jax(background, inputs, n):
    jax_grid_frame = _get(background, "jax_grid")
    grid = grid_from_numpy(*inputs["grid"], "cpu")
    single = render_image_grid(grid, *ranks.tensors(*inputs["grid_rays"]),
                               mode="contraction").numpy()
    for r in _world(background, n):
        np.testing.assert_array_equal(r["grid_frame"], single)
        assert np.isfinite(r["grid_frame"]).all()
        # the port's grid frame against JAX's: test_torch_grid_kernel.py's
        # assert_image_bars. JAX's own sharded-vs-single bar (1e-5 on 99.9%)
        # holds JAX against itself; the port's single-device grid frame sits
        # up to 4.8e-5 from JAX's here (92.6% of pixels within 1e-5).
        diff = np.abs(r["grid_frame"] - jax_grid_frame).max(axis=-1)
        assert (diff < 1e-3).mean() >= 0.99, f"pixels over 1e-3: {(diff >= 1e-3).sum()}"
        assert r["grid_frame"].std() > 0.01


# ---------------------------------------------------------------------------
# the two training steps
# ---------------------------------------------------------------------------


def _jax_steps(inputs):
    """JAX's fused step (interpret mode), its XLA loss and gradient, and its
    XLA train_step, on the 2x2 mesh with SGD(LR)."""
    scene = jax_render_scene()
    o, d, c = inputs["fit_rays"]
    target = jnp.asarray(inputs["target"])
    fit = {k: jnp.asarray(v) for k, v in inputs["fit"].items()}

    def loss_fn(p):
        img = jax_render_image_diff(scene.sdf, p, o, d, c, csdf=scene.csdf)
        return jnp.mean((img - target) ** 2)

    xla_loss, xla_grad = jax.value_and_grad(loss_fn)(fit)
    mesh = _jax_mesh(4)
    so, sd, sc, _ = jax_shard_rays(o, d, c, mesh, interleave=False)
    opt = optax.sgd(LR)
    fused_p, _, fused_loss = jax_train_step_fused(
        scene.csdf, dict(fit), opt.init(fit), opt, target, so, sd, sc, mesh, interpret=True)
    full = {k: jnp.asarray(v) for k, v in inputs["scene_params"].items()}
    step_p, _, step_loss = jax_train_step(scene.sdf, full, opt.init(full), opt, target, so, sd,
                                          sc, mesh, csdf=scene.csdf)
    return {
        "xla": (float(xla_loss), {k: np.asarray(inputs["fit"][k]) - LR * np.asarray(g)
                                  for k, g in xla_grad.items()}),
        "fused": (float(fused_loss), {k: np.asarray(v) for k, v in fused_p.items()}),
        "step": (float(step_loss), {k: np.asarray(v) for k, v in step_p.items()}),
    }


def _hold(port, ref):
    """JAX's bars (tests/test_parallel.py::TestFusedTrainStep)."""
    loss, params = port
    ref_loss, ref_params = ref
    assert loss == pytest.approx(ref_loss, rel=1e-4)
    for k, v in ref_params.items():
        np.testing.assert_allclose(params[k], v, rtol=1e-3, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("against", ["fused", "xla"])
@pytest.mark.parametrize("n", sorted(WORLDS))
def test_train_step_fused_matches_jax(background, n, against):
    jax_steps = _get(background, "jax_steps")
    results = _world(background, n)
    for r in results:
        _hold(r["fused"], jax_steps[against])
        for k, v in r["fused"][1].items():
            np.testing.assert_array_equal(v, results[0]["fused"][1][k])


@pytest.mark.parametrize("n", sorted(WORLDS))
def test_train_step_matches_jax(background, n):
    jax_steps = _get(background, "jax_steps")
    results = _world(background, n)
    for r in results:
        _hold(r["step"], jax_steps["step"])
        for k, v in r["step"][1].items():
            np.testing.assert_array_equal(v, results[0]["step"][1][k])


def _single_device_grads(inputs):
    """The port's unsharded gradients of both steps on the whole frame."""
    scene = reference_render_scene(device="cpu")
    o, d, c = ranks.tensors(*inputs["fit_rays"])
    target = torch.from_numpy(inputs["target"])
    _, fused = render_loss_grad_cuda(scene.csdf, params_from_numpy(inputs["fit"], "cpu"), target,
                                     o, d, c)
    p = {k: v.requires_grad_() for k, v in params_from_numpy(inputs["scene_params"], "cpu").items()}
    img = render_image_diff(scene.sdf, p, o, d, c, csdf=scene.csdf)
    torch.mean((img - target) ** 2).backward()
    return {"fused": {k: v.numpy() for k, v in fused.items()},
            "step": {k: v.grad.numpy() for k, v in p.items()}}


@pytest.mark.parametrize("step", ["fused", "step"])
@pytest.mark.parametrize("n", sorted(WORLDS))
def test_sharded_step_gradient_equals_single_device(background, inputs, n, step):
    """The gradient the step's all_reduce sums, against the unsharded one at
    STEP_GRAD_REL of its norm: a uniform factor on the summed gradient
    would stay inside the parameter bars of one small SGD step."""
    ref = _single_device_grads(inputs)[step]
    flat = np.concatenate([ref[k].reshape(-1) for k in ref])
    assert np.linalg.norm(flat) > 0
    for r in _world(background, n):
        got = np.concatenate([r[f"{step}_grad"][k].reshape(-1) for k in ref])
        rel = np.linalg.norm(got - flat) / np.linalg.norm(flat)
        assert rel <= STEP_GRAD_REL, (step, rel)


# ---------------------------------------------------------------------------
# sharded mesh generation
# ---------------------------------------------------------------------------


def _sorted(v):
    return v[np.lexsort(v.T)]


def _jax_sharded_mesh():
    scene = jax_reference_object()
    mesh = jax_generate_mesh_sharded(scene.bind(), _jax_mesh(4), refine_steps=1,
                                     config=JaxMeshGenConfig(init_factor=8),
                                     csdf=compile_scene_csdf(scene))
    return np.asarray(mesh.vertices)


@pytest.mark.parametrize("n", sorted(WORLDS))
def test_generate_mesh_sharded_matches_single_and_jax(background, n):
    jax_sharded_mesh = _get(background, "jax_mesh")
    single = generate_mesh(compile_scene(reference_object(device="cpu")), 1,
                           MeshGenConfig(init_factor=8), device="cpu")
    for r in _world(background, n):
        vertices, triangles, count = r["mesh"]
        assert (triangles, count) == (single.triangle_count, single.vertex_count)
        np.testing.assert_allclose(_sorted(vertices), _sorted(jax_sharded_mesh), atol=1e-6)


@pytest.mark.parametrize("n", sorted(WORLDS))
def test_refine_field_sharded_and_gather_equal_single(background, n):
    desc = compile_scene(sphere_scene(1.0, device="cpu"))
    field = create_voxel_field(MeshGenConfig(init_factor=8, bb_size=4.0), "cpu")
    single = _sorted(refine_field(desc, field).to_numpy())
    results = _world(background, n)
    union = np.concatenate([r["refined_local"] for r in results])
    np.testing.assert_array_equal(_sorted(union), single)
    for r in results:
        assert r["refined_counts"].sum() == single.shape[0]
        np.testing.assert_array_equal(_sorted(r["gathered"]), single)


# ---------------------------------------------------------------------------
# multi-host, the graft entry, the CLI, the benches
# ---------------------------------------------------------------------------


def test_two_processes_join_through_bsdmg_variables(background):
    """Both processes print the single-device frame's sum."""
    outs = _get(background, "multihost")
    sums = {}
    for out in outs:
        m = re.search(r"MHRESULT (\d) (\d) ([-\d.]+)", out)
        assert m is not None, out[-2000:]
        assert m.group(2) == "2"
        sums[int(m.group(1))] = float(m.group(3))
    desc = compile_scene(reference_render_scene(device="cpu"))
    cam = ranks.look_at((5.0, 2.0, -5.0), fov=np.pi / 4, device="cpu")
    single = render_image_cuda(desc, *ranks.generate_rays(cam, (64, 32), (1920.0, 1080.0)))
    assert sums[0] == sums[1] == float(f"{float(single.double().sum()):.9f}")


def test_dryrun_multichip_four_ranks(background):
    out = _get(background, "dryrun")
    assert out["mesh"] == {"dp": 2, "sp": 2}
    assert out["sharded_refine_voxels"] > 0
    assert all(np.isfinite(out[k]) for k in ("loss", "fused_loss", "sharded_render_sum"))


def test_cli_render_sharded_equals_render(tmp_path, own_world):
    size = ["--device", "cpu", "--width", "48", "--height", "20"]
    cli.main(["render", *size, "-o", str(tmp_path / "u.npy")])
    cli.main(["render", "--sharded", *size, "-o", str(tmp_path / "s.npy")])
    np.testing.assert_array_equal(np.load(tmp_path / "s.npy"), np.load(tmp_path / "u.npy"))


@pytest.mark.parametrize("scene, extra", [
    ("reference_render_scene", []),
    ("reference_render_scene", ["--interpolate-edges"]),
    ("examples/snowman.json", []),
    ("mesh:torus.obj:8", []),
], ids=["object", "interpolate-edges", "spec", "mesh asset"])
def test_cli_mesh_sharded_has_the_counts_of_mesh(tmp_path, own_world, scene, extra):
    if scene.endswith(".json"):
        scene = str(ROOT / scene)
    elif scene.startswith("mesh:"):
        subprocess.run([sys.executable, str(ROOT / "tools" / "make_torus.py"),
                        str(tmp_path / "torus.obj")], check=True, timeout=120)
        scene = f"mesh:{tmp_path / 'torus.obj'}:8"
    argv = ["mesh", "--device", "cpu", "--scene", scene, "--init-factor", "8", "--refine", "1",
            *extra]
    cli.main([*argv, "-o", str(tmp_path / "u.obj")])
    cli.main([*argv, "--sharded", "-o", str(tmp_path / "s.obj")])
    counts = [Counter(line[:2] for line in (tmp_path / f).read_text().splitlines())
              for f in ("u.obj", "s.obj")]
    assert counts[0]["f "] > 0
    assert [c["v "] for c in counts] == [counts[0]["v "]] * 2
    assert [c["f "] for c in counts] == [counts[0]["f "]] * 2


def test_cli_mesh_sharded_runs_only_the_triangle_gather(tmp_path, own_world):
    collectives.reset()
    cli.main(["mesh", "--device", "cpu", "--init-factor", "8", "--refine", "1", "--sharded",
              "-o", str(tmp_path / "s.obj")])
    assert collectives.COLLECTIVES == {"all_gather": 2, "all_reduce": 0}


def test_render_sharded_counts_one_gather_in_a_world_of_one(own_world):
    mesh = make_mesh(device="cpu")
    desc = compile_scene(reference_render_scene(device="cpu"))
    rays = ranks.tensors(*_rays(16, 8))
    collectives.reset()
    frame = render_sharded_pallas(desc, *rays, mesh)
    assert collectives.COLLECTIVES == {"all_gather": 1, "all_reduce": 0}
    np.testing.assert_array_equal(frame.numpy(), render_image_cuda(desc, *rays).numpy())


@pytest.mark.parametrize("n", [1, 2])
def test_scaling_benches_report_jax_keys(background, n):
    """The keys of bsdmg_tpu/bench.py's benchmark_scaling and
    benchmark_scaling_overhead, at a world of one and of two; no wall-clock
    ratio is held."""
    found = _world(background, n)[0]
    single = set() if n == 1 else {"rays_per_s_single"}
    assert set(found["scaling"]) == {"devices", "rays_per_s", "efficiency"} | single
    assert found["scaling"]["devices"] == found["scaling_proxy"]["devices"] == n
    if n == 1:
        assert found["scaling"]["efficiency"] == 1.0
    assert set(found["scaling_proxy"]) == {"devices", "render_overhead",
                                           "render_projected_efficiency", "train_overhead",
                                           "train_projected_efficiency"}
    for key in ("scaling", "scaling_proxy"):
        assert all(np.isfinite(v) and v > 0 for v in found[key].values())
