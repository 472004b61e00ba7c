// The fd4 stencil, shared by K1 and K3 (render_kernel.cu), K6
// (mc_kernel.cu) and K7 (project_kernel.cu), and the Newton projection onto
// the isosurface of K6 and K7. Twins: fd4_grad, unit_normal_fd4 and newton
// in bsdmg_tpu_torch/ops/cuda/mesh_kernel.py, _fd_normal in
// ops/cuda/render_kernel.py; tests/test_torch_stencil.py holds the
// shared-term stencil to them in plain PyTorch.

#pragma once

#include "scene_sdf.cuh"

// 4th-order central-difference gradient, unnormalised, over 12 points
// (ops/pallas/mesh_kernel.py::_grad_fd4, render_kernel.py::_fd_normal):
// -f(p+2e) + 8 f(p+e) - 8 f(p-e) + f(p-2e) per axis, summed in that order.
//
// Both loops are unrolled: a shift along one axis moves one of the three
// terms of each capsule group (scene_sdf.cuh group_d2: the axial term of
// the group along that axis, a slot term of the others) and one of the
// sphere's three squares, and with the 12 inlined SDFs side by side nvcc
// computes every term that the shifts leave alone once. That is the
// shared-term stencil, about 40% fewer FP32 operations than 12 whole SDFs
// (utils/profiling.py fd4_ops), and each value is scene_sdf at its point bit
// for bit. An explicit form that keeps the centre's terms and recomputes
// only the moved one compiled to the same SASS within 8 instructions and
// ran 3.5% slower in K3 (PERF.md). With Rolled both loops stay rolled
// around one inlined SDF: K1's epilogue, which keeps K1's march at 32
// registers (unrolled, K1 takes 43). A structure whose points share no
// terms (S::unrolled false: the mandelbulb) keeps them rolled too, but a
// composed scene without Rolled, which walks the four points of each axis
// at once (K3, K7).
template <class S, bool Rolled = false>
__device__ __forceinline__ void fd4_grad(const SceneDesc& s, float x, float y, float z, float eps,
                                         float& gx, float& gy, float& gz) {
  const float e1 = eps, e2 = 2.0f * eps;
  if constexpr (std::is_same<S, Composed>::value && !Rolled) {
    // a composed scene's four points of an axis in one walk (composed.cuh
    // composed_sdf_n): the same points, values and sums (K1 and K6 pass
    // Rolled, for their registers)
#pragma unroll 1
    for (int a = 0; a < 3; ++a) {
      float px[4], py[4], pz[4], f[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float off = k == 0 ? e2 : (k == 1 ? e1 : (k == 2 ? -e1 : -e2));
        px[k] = a == 0 ? x + off : x;
        py[k] = a == 1 ? y + off : y;
        pz[k] = a == 2 ? z + off : z;
      }
      composed_sdf_n<4>(s, px, py, pz, f);
      const float acc = ((-f[0] + 8.0f * f[1]) - 8.0f * f[2]) + f[3];
      if (a == 0) gx = acc;
      else if (a == 1) gy = acc;
      else gz = acc;
    }
    return;
  }
  gx = gy = gz = 0.0f;
#pragma unroll ((Rolled || !S::unrolled) ? 1 : 3)
  for (int a = 0; a < 3; ++a) {
    float acc = 0.0f;
#pragma unroll ((Rolled || !S::unrolled) ? 1 : 4)
    for (int k = 0; k < 4; ++k) {
      const float off = k == 0 ? e2 : (k == 1 ? e1 : (k == 2 ? -e1 : -e2));
      const float f = scene_sdf<S>(s, a == 0 ? x + off : x, a == 1 ? y + off : y,
                                   a == 2 ? z + off : z);
      acc = k == 0 ? -f : (k == 1 ? acc + 8.0f * f : (k == 2 ? acc - 8.0f * f : acc + f));
    }
    if (a == 0) gx = acc;
    else if (a == 1) gy = acc;
    else gz = acc;
  }
}

// 1/|g| with the JAX kernels' 1e-24 floor; a correctly rounded sqrt and
// division (not rsqrtf), so the PyTorch twin can equal it bit for bit. The
// floor keeps a NaN, as jnp.maximum and the twin's clamp do (fmaxf drops
// it): a gradient NaN in one axis only (a composed scene's cylinder on its
// axis) makes the whole Newton step NaN, not a step by the other axes at
// 1e12. A compare and select: around vmaxn's inline asm ptxas spilled K6's
// wrapped-object instantiation.
__device__ __forceinline__ float inv_norm(float gx, float gy, float gz) {
  const float m = (gx * gx + gy * gy) + gz * gz;
  return 1.0f / sqrtf(m < 1e-24f ? 1e-24f : m);
}

// fd4 unit normal at (x, y, z) (fd4_grad<S, Rolled>)
template <class S, bool Rolled = false>
__device__ __forceinline__ void unit_normal_fd4(const SceneDesc& s, float x, float y, float z,
                                                float eps, float& nx, float& ny, float& nz) {
  float gx, gy, gz;
  fd4_grad<S, Rolled>(s, x, y, z, eps, gx, gy, gz);
  const float inv = inv_norm(gx, gy, gz);
  nx = gx * inv;
  ny = gy * inv;
  nz = gz * inv;
}

// At most `iters` Newton steps p <- p - sd * g / |g|, g the analytic
// gradient (use_grad) or the fd4 one. A point stops after the step at which
// |sd| <= tol, as each lane of the JAX kernels does
// (ops/pallas/mesh_kernel.py::_project_kernel). Returns the steps taken.
// Rolled as fd4_grad's.
template <class S, bool Rolled = false>
__device__ __forceinline__ int newton_project(const SceneDesc& s, float& x, float& y, float& z,
                                              int iters, float tol, float eps, int use_grad) {
  int i = 0;
#pragma unroll 1
  while (i < iters) {
    float sd, gx, gy, gz;
    if (use_grad) {
      scene_sdf_grad<S>(s, x, y, z, sd, gx, gy, gz);
    } else {
      sd = scene_sdf<S>(s, x, y, z);
      fd4_grad<S, Rolled>(s, x, y, z, eps, gx, gy, gz);
    }
    const float inv = inv_norm(gx, gy, gz);
    x = x - (sd * gx) * inv;
    y = y - (sd * gy) * inv;
    z = z - (sd * gz) * inv;
    ++i;
    if (!(fabsf(sd) > tol)) break;
  }
  return i;
}
