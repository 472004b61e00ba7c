"""bsdmg_tpu_torch: the PyTorch + CUDA port of bsdmg_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same module paths: the
sphere-traced render of the reference scene runs through a hand-written CUDA
kernel (``ops/cuda/render_kernel.py``, source in ``csrc/``), and mesh
generation (refine + marching cubes) through two more
(``ops/cuda/mc_kernel.py``, ``ops/cuda/mesh_kernel.py``), and inverse
rendering (``grad/``, ``cli fit``) through two more
(``ops/cuda/diff_kernel.py``); each has a plain PyTorch twin. The package
imports torch and numpy, never jax.
"""

from bsdmg_tpu_torch.config import MarchConfig, MeshGenConfig, RenderConfig

__version__ = "0.1.0"

__all__ = ["MarchConfig", "MeshGenConfig", "RenderConfig", "__version__"]
