"""bsdmg_tpu_torch: the PyTorch + CUDA port of bsdmg_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same module paths: the
sphere-traced render of the built-in scenes runs through hand-written CUDA
kernels (``ops/cuda/render_kernel.py``, sources in ``csrc/``), mesh
generation (refine + marching cubes, and the ``session`` stage machine)
through two more (``ops/cuda/mc_kernel.py``, ``ops/cuda/mesh_kernel.py``),
inverse rendering (``grad/``, ``cli fit``) through two more
(``ops/cuda/diff_kernel.py``) and mesh assets through three more
(``ops/cuda/grid_kernel.py``); each has a plain PyTorch twin. The weld and
the OBJ files go through the native host runtime (``runtime/native.py``,
C++ built with g++). ``parallel/`` runs the render, the fit steps and
mesh generation over several devices, one process a device on
``torch.distributed``. ``bench`` and ``utils/profiling.py`` measure them.
The package imports torch and numpy, never jax; its entry points run on
the card unless the caller names another device.
"""

from bsdmg_tpu_torch.config import MarchConfig, MeshGenConfig, RenderConfig

__version__ = "0.1.0"

__all__ = ["config", "MarchConfig", "MeshGenConfig", "RenderConfig", "__version__"]
