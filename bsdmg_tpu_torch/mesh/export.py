"""Mesh and image export: OBJ (and its reader), VTK legacy, PNG, animated
GIF, and voxel-field checkpoints.

Port of ``bsdmg_tpu/mesh/export.py``; each writer produces the JAX package's
exact format, so files and field checkpoints pass between the two packages.
The OBJ writer and reader are the native C++ ones by default
(``runtime/native.py``), as the JAX package's are; their Python paths are
the twins (``use_native=False``). The reference exports its welded mesh as
OBJ (src/renderer/mod.rs:204).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np
import torch

from bsdmg_tpu_torch.mesh.pipeline import Mesh
from bsdmg_tpu_torch.runtime.native import read_obj_native, write_obj_native


def save_obj(mesh: Mesh, path: str | Path, *, use_native: bool = True) -> None:
    """Wavefront OBJ with positions + normals, faces as ``v//vn`` (indices
    identical, as the reference asserts in obj_to_bevy_mesh,
    src/renderer/mod.rs:121). The native writer's file has the Python
    writer's lines but its header, ``# bsdmg_tpu generated mesh (native
    writer)``."""
    if use_native:
        write_obj_native(path, mesh.vertices, mesh.normals, mesh.faces)
        return
    lines = ["# bsdmg_tpu generated mesh"]
    lines += [f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}" for v in mesh.vertices.tolist()]
    lines += [f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}" for n in mesh.normals.tolist()]
    lines += [f"f {a}//{a} {b}//{b} {c}//{c}" for a, b, c in (mesh.faces + 1).tolist()]
    Path(path).write_text("\n".join(lines) + "\n")


def load_obj(path: str | Path, *, use_native: bool = True) -> Mesh:
    """Minimal OBJ reader: ``v``/``vn``/``f`` with arbitrary face arity
    (fan-triangulated) and negative (relative) indices. The native parser
    by default; the Python path (``use_native=False``) is the JAX package's,
    its behavioural oracle. Normals are kept only when there is one per
    vertex, else zeros."""
    if use_native:
        vertices, normals, faces = read_obj_native(path)
        return Mesh(vertices=vertices, normals=normals, faces=faces)
    vertices: list[list[float]] = []
    normals: list[list[float]] = []
    faces: list[tuple[int, int, int]] = []
    for raw in Path(path).read_text().splitlines():
        parts = raw.split()
        if not parts:
            continue
        if parts[0] == "v":
            vertices.append([float(x) for x in parts[1:4]])
        elif parts[0] == "vn":
            normals.append([float(x) for x in parts[1:4]])
        elif parts[0] == "f":
            idx = [int(p.split("/")[0]) for p in parts[1:]]
            idx = [i - 1 if i > 0 else len(vertices) + i for i in idx]
            for k in range(1, len(idx) - 1):
                faces.append((idx[0], idx[k], idx[k + 1]))
    v = np.asarray(vertices, np.float32)
    n = np.asarray(normals, np.float32) if len(normals) == len(vertices) else np.zeros_like(v)
    return Mesh(vertices=v, normals=n, faces=np.asarray(faces, np.int32))


def save_vtk(mesh: Mesh, path: str | Path) -> None:
    """Legacy VTK PolyData with point normals."""
    out = [
        "# vtk DataFile Version 3.0",
        "bsdmg_tpu mesh",
        "ASCII",
        "DATASET POLYDATA",
        f"POINTS {mesh.vertex_count} float",
    ]
    out += [f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}" for v in mesh.vertices.tolist()]
    out.append(f"POLYGONS {mesh.triangle_count} {4 * mesh.triangle_count}")
    out += [f"3 {a} {b} {c}" for a, b, c in mesh.faces.tolist()]
    out.append(f"POINT_DATA {mesh.vertex_count}")
    out.append("NORMALS normals float")
    out += [f"{n[0]:.6f} {n[1]:.6f} {n[2]:.6f}" for n in mesh.normals.tolist()]
    Path(path).write_text("\n".join(out) + "\n")


def save_png(image: np.ndarray, path: str | Path) -> None:
    """Write an (H, W, 3|4) uint8 image as PNG (zlib + struct, no deps)."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = (np.clip(image, 0.0, 1.0) * 255.0).astype(np.uint8)
    if image.ndim == 2:
        image = np.repeat(image[..., None], 3, axis=-1)
    h, w, c = image.shape
    color_type = {3: 2, 4: 6}[c]

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(
            ">I", zlib.crc32(body) & 0xFFFFFFFF
        )

    raw = b"".join(b"\x00" + image[y].tobytes() for y in range(h))
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    Path(path).write_bytes(png)


def save_gif(frames, path: str | Path, *, fps: float = 10.0) -> None:
    """Write a list of (H, W, 3|4) uint8 frames as a looping animated GIF
    (``cli animate --gif``), with Pillow, as the JAX package does; raises
    ``RuntimeError`` where Pillow is missing."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            "animated GIF export needs Pillow; write PNG frames instead"
        ) from e
    if not frames:
        raise ValueError("save_gif needs at least one frame")
    imgs = []
    for f in frames:
        f = np.asarray(f)
        if f.dtype != np.uint8:
            f = (np.clip(f, 0.0, 1.0) * 255.0).astype(np.uint8)
        imgs.append(Image.fromarray(f[..., :3], "RGB"))
    imgs[0].save(
        Path(path),
        save_all=True,
        append_images=imgs[1:],
        duration=max(int(round(1000.0 / fps)), 20),
        loop=0,
    )


def save_field(field, path: str | Path) -> None:
    """Checkpoint a voxel field between refine levels (deterministic resume);
    the JAX package's ``load_field`` reads it."""
    np.savez_compressed(
        path,
        lowers=field.to_numpy(),
        voxel_size=np.float32(field.voxel_size),
        level=np.int32(field.level),
    )


def load_field(path: str | Path, device: torch.device | str = "cuda"):
    """A field checkpoint, the JAX package's ``save_field`` output included,
    onto ``device``."""
    # imported here: weights.py imports mesh/field.py, whose package imports this module
    from bsdmg_tpu_torch.weights import field_from_numpy

    data = np.load(path)
    return field_from_numpy(data["lowers"], data["voxel_size"], data["level"], device)
