"""The module of CUDA kernel K1 (bsdmg_tpu_torch/ops/cuda/render_kernel.py).

K1 itself needs nvcc and a card; chip_smoke.py holds it against its plain
version there. Here the plain version, on the descriptor from
ops/cuda/csdf.py, is held against the JAX package's fused Pallas kernel run
in interpret mode, on the same rays:

* outcome identical on >= 99.9% of rays, steps identical on every ray whose
  outcome matches, depth within 1e-4 where both collide;
* image max-channel difference < 2e-2 on >= 99.9% of pixels, mean < 1e-4
  (tests/test_pallas.py:117-119).

The two are not bit-equal: XLA's CPU compiler contracts multiply-adds into
FMAs, PyTorch does not.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from bsdmg_tpu.cam import generate_rays, look_at
from bsdmg_tpu.models import reference_render_scene as jax_scene
from bsdmg_tpu.ops.pallas import compile_scene_csdf
from bsdmg_tpu.ops.pallas.csdf import scene_bounds
from bsdmg_tpu.ops.pallas.render_kernel import render_image_pallas, trace_pallas
from bsdmg_tpu_torch.config import MarchConfig
from bsdmg_tpu_torch.models import reference_render_scene
from bsdmg_tpu_torch.ops.cuda import grid_box, render_kernel
from bsdmg_tpu_torch.ops.cuda.csdf import compile_scene
from bsdmg_tpu_torch.ops.cuda.render_kernel import render_image_cuda, render_image_planes_torch
from bsdmg_tpu_torch.weights import params_from_numpy

# one intra-op thread: PyTorch's spinning OpenMP pool would otherwise take
# every core from the timing-sensitive tests that run beside these
torch.set_num_threads(1)

COLLISION = 0
SOURCE = Path(__file__).resolve().parents[1] / render_kernel.SOURCE
#: the descriptor's C structs, shared by every kernel
SCENE_HEADER = SOURCE.parent / "scene_sdf.cuh"


def _jax_rays(w, h):
    cam = look_at((5.0, 2.0, -5.0), fov=np.pi / 4)
    return generate_rays(cam, (w, h), (1920.0, 1080.0))


def _to_torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def assert_image_bars(img, ref):
    diff = np.abs(img - ref).max(axis=-1)
    assert np.mean(diff < 2e-2) >= 0.999, f"mismatched pixels: {(diff >= 2e-2).sum()}"
    assert diff.mean() < 1e-4


@pytest.fixture(scope="module")
def reference_256x64():
    """JAX rays, fused-kernel image and trace planes, and the port's planes."""
    scene = jax_scene()
    csdf, bb = compile_scene_csdf(scene), scene_bounds(scene)
    o, d, c = _jax_rays(256, 64)
    image = np.asarray(render_image_pallas(csdf, o, d, c, bb=bb, interpret=True))
    planes = [np.asarray(x) for x in trace_pallas(csdf, o, d, c, bb=bb, use_bb_skip=True, interpret=True)]
    desc = compile_scene(reference_render_scene(device="cpu"))
    ours = render_image_planes_torch(desc, *_to_torch(o, d, c))
    return image, planes, [x.numpy() for x in ours]


def test_image_matches_render_image_pallas(reference_256x64):
    image, _, (rgb, *_) = reference_256x64
    assert rgb.shape == (64, 256, 3) and rgb.dtype == np.float32
    assert_image_bars(rgb, image)


def test_trace_planes_match_trace_pallas(reference_256x64):
    _, (depth_ref, steps_ref, outcome_ref), (_, depth, steps, outcome) = reference_256x64
    same = outcome == outcome_ref
    assert same.mean() >= 0.999
    np.testing.assert_array_equal(steps[same], steps_ref[same])
    both = same & (outcome == COLLISION)
    assert both.sum() > 1000  # the frame shows the object and the wireframe
    assert np.abs(depth - depth_ref)[both].max() <= 1e-4
    assert steps.dtype == outcome.dtype == np.int32


def test_transformed_object_matches_jax():
    """The object-transform path of the descriptor, rendered end to end."""
    scene = jax_scene()
    params = {k: np.asarray(v) for k, v in scene.params.items()}
    params["object_center"] = np.asarray([0.2, 0.3, -0.4], np.float32)
    params["object_rotation"] = np.asarray([0.96, 0.0, 0.28, 0.0], np.float32)
    o, d, c = _jax_rays(96, 54)
    ref = np.asarray(render_image_pallas(
        compile_scene_csdf(scene, params), o, d, c, bb=scene_bounds(scene, params), interpret=True,
    ))
    desc = compile_scene(reference_render_scene(device="cpu"), params_from_numpy(params, "cpu"))
    assert desc.translation is not None
    img = render_image_planes_torch(desc, *_to_torch(o, d, c))[0].numpy()
    assert_image_bars(img, ref)


def test_wrapper_sends_cpu_tensors_to_the_plain_version():
    desc = compile_scene(reference_render_scene(device="cpu"))
    o, d, c = _to_torch(*_jax_rays(40, 24))
    launches = render_kernel.LAUNCHES
    rgb = render_image_cuda(desc, o, d, c)
    planes = render_image_cuda(desc, o, d, c, return_planes=True)
    ref = render_image_planes_torch(desc, o, d, c)
    assert render_kernel.LAUNCHES == launches
    assert torch.equal(rgb, ref[0])
    for a, b in zip(planes, ref):
        assert torch.equal(a, b)


def _bad_inputs():
    o, d, c = _to_torch(*_jax_rays(16, 8))
    meta = torch.empty((8, 16), device="meta")
    return {
        "float64": ((o.double(), d, c), TypeError),
        "not a tensor": ((o.numpy(), d, c), TypeError),
        "shape": ((o[:4].contiguous(), d, c), ValueError),
        "rank": ((o, d, c[None]), ValueError),
        "non-contiguous": ((o.transpose(0, 1).contiguous().transpose(0, 1), d, c), ValueError),
        "device mismatch": ((o, d, meta), ValueError),
        "empty": ((o[:0], d[:0], c[:0]), ValueError),
        "unsupported device": ((o.to("meta"), d.to("meta"), meta), ValueError),
    }


BAD_INPUTS = [
    "device mismatch", "empty", "float64", "non-contiguous", "not a tensor", "rank", "shape",
    "unsupported device",
]


@pytest.mark.parametrize("case", BAD_INPUTS)
def test_wrapper_rejects_bad_inputs(case):
    args, error = _bad_inputs()[case]
    with pytest.raises(error):
        render_image_cuda(compile_scene(reference_render_scene(device="cpu")), *args)


def test_over_relaxation_matches_jax():
    """``MarchConfig.relaxation > 1`` runs K1's over-relaxed march: its
    twin's image against the JAX package's fused render with the same
    omega, at the image bars."""
    scene = jax_scene()
    o, d, c = _jax_rays(128, 32)
    ref = np.asarray(render_image_pallas(
        compile_scene_csdf(scene), o, d, c, bb=scene_bounds(scene), omega=1.5, interpret=True,
    ))
    desc = compile_scene(reference_render_scene(device="cpu"))
    img = render_image_cuda(desc, *_to_torch(o, d, c), MarchConfig(relaxation=1.5))
    assert_image_bars(img.numpy(), ref)
    twin = render_image_planes_torch(desc, *_to_torch(o, d, c), omega=1.5)[0]
    assert torch.equal(img, twin)


def _c_struct_fields(source: str, name: str):
    body = re.search(r"struct %s \{(.*?)\n\};" % name, source, re.S).group(1)
    fields = []
    for line in body.splitlines():
        m = re.match(r"\s*(?:const\s+)?(\w+\*?)\s+(\w+)(?:\[(\w+)\])?;", line)
        if m:
            fields.append(m.groups())
    return fields


@pytest.mark.parametrize(
    "c_name,py_struct",
    [
        ("CapsuleGroup", render_kernel._CapsuleGroupC),
        ("CapsuleSet", render_kernel._CapsuleSetC),
        ("SceneDesc", render_kernel._SceneDescC),
    ],
)
def test_descriptor_layout_matches_cuda_source(c_name, py_struct):
    """The ctypes mirror lists the C struct's fields in order, with the same
    types and array lengths (the library also checks sizeof at load)."""
    source = SCENE_HEADER.read_text()
    assert '#include "scene_sdf.cuh"' in SOURCE.read_text()
    lengths = {"BSDMG_GROUPS": 3, "BSDMG_GROUP_VALUES": 2}
    for name, value in lengths.items():
        assert f"#define {name} {value} " in source or f"#define {name} {value}\n" in source
    types = {
        "int": ctypes.c_int,
        "float": ctypes.c_float,
        "CapsuleGroup": render_kernel._CapsuleGroupC,
        "CapsuleSet": render_kernel._CapsuleSetC,
        "int*": ctypes.c_void_p,  # a composed scene's node program in device memory
        "float*": ctypes.c_void_p,  # a grid's table in device memory
        "GridBox": grid_box.GridBoxC,
    }
    c_fields = _c_struct_fields(source, c_name)
    assert [f[1] for f in c_fields] == [f[0] for f in py_struct._fields_]
    for (c_type, _, length), (_, py_type) in zip(c_fields, py_struct._fields_):
        if length is None:
            assert py_type is types[c_type]
        else:
            assert py_type._type_ is types[c_type]
            assert py_type._length_ == (lengths[length] if length in lengths else int(length))
