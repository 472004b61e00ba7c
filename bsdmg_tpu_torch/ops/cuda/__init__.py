"""Hand-written CUDA kernels for Hopper, the counterparts of ``ops/pallas``.

* ``render_kernel`` — kernel K1, the fused sphere trace + shade, and its
  plain PyTorch twin;
* ``mc_kernel`` — kernel K6, the fused marching-cubes finish, and its twin;
* ``mesh_kernel`` — kernel K7, the Newton edge projection, and its twin
  (with the Newton and fd4 helpers K6's twin shares);
* ``diff_kernel`` — kernels K4, the march under runtime parameters, and K5,
  the fused image loss and gradient of ``fit --image``, and their twins;
* ``csdf`` — the scene compiler that lowers a scene to the descriptor the
  kernels read, and the descriptor's SDF and gradient in plain PyTorch;
* ``build`` — compiles ``csrc/*.cu`` with nvcc at first use.
"""
