"""Hand-written CUDA kernels for Hopper, the counterparts of ``ops/pallas``.

* ``render_kernel`` — kernel K1, the fused sphere trace + shade, and its
  plain PyTorch twin;
* ``csdf`` — the scene compiler that lowers a scene to the descriptor K1
  reads;
* ``build`` — compiles ``csrc/*.cu`` with nvcc at first use.
"""
