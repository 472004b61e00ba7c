// The grid SDF samplers of the mesh-asset render (K8, K9, P1): trilinear
// interpolation of a baked (R, R, R) table, C order, with the sound step
// outside the grid box.
//
// - InterpF32 is bsdmg_tpu/models/mesh_sdf.py::make_grid_interp_csdf, the
//   sampler of K8 (grid_kernel.py::_grid_trace_kernel) and of the XLA fine
//   finish and fd4 normals: eight corner gathers, lerps in that function's
//   order.
// - Hat<float> and Hat<__nv_bfloat16> are grid_kernel.py::
//   make_contraction_csdf, the sampler of K9 (_contraction_kernel) with an
//   exact or a bf16 table: the hat weights max(0, 1 - |c - a|) of the two
//   corners a = floor(c), floor(c) + 1 of each axis, which are not always
//   (1 - f, f) bit for bit (c - 1 rounds for small c); v(z) summed over the
//   four (x, y) corners in ascending x*R + y order, then v(z0) wz0 +
//   v(z1) wz1, the outside step, minus the level's margin. In bf16 the table
//   and each w_xy = wx*wy are rounded to bf16 (RNE) and the products summed
//   in float32, as the TPU's bf16 dot with preferred_element_type=f32. The
//   MXU contraction over all R^2 (x, y) columns is TPU layout: on this card
//   the four non-zero columns are gathered directly.
//
// Every float constant arrives as the float32 the plain twins
// (bsdmg_tpu_torch/models/mesh_sdf.py, ops/cuda/grid_kernel.py) compute
// with, and with -fmad=false each operation rounds as theirs do.

#pragma once

#include <cuda_bf16.h>

// the grid's box: its corners, scale = (r - 1) / (hi - lo) and the clamp
// r - 1 - 1e-4, all float32
struct GridBox {
  float lo[3];
  float hi[3];
  float scale[3];
  float clip_hi;
  int r;
};

// grid coordinate of one axis, clamped into the table (jnp.clip)
__device__ __forceinline__ float grid_coord(float v, float lo, float scale, float clip_hi) {
  return fminf(fmaxf((v - lo) * scale, 0.0f), clip_hi);
}

// mesh_sdf.py::_outside_step of the interior value: outside the box the
// larger of two lower bounds on the surface distance
__device__ __forceinline__ float outside_step(const GridBox& b, float x, float y, float z,
                                              float interior) {
  const float ox = fmaxf(fmaxf(b.lo[0] - x, x - b.hi[0]), 0.0f);
  const float oy = fmaxf(fmaxf(b.lo[1] - y, y - b.hi[1]), 0.0f);
  const float oz = fmaxf(fmaxf(b.lo[2] - z, z - b.hi[2]), 0.0f);
  const float sq = (ox * ox + oy * oy) + oz * oz;
  const float outside = sq > 0.0f ? sqrtf(sq) : 0.0f;
  return outside > 0.0f ? fmaxf(outside, interior - outside) : interior;
}

struct InterpF32 {
  const float* __restrict__ table;
  GridBox b;

  __device__ __forceinline__ float at(int ix, int iy, int iz) const {
    return table[(ix * b.r + iy) * b.r + iz];
  }

  __device__ __forceinline__ float operator()(float x, float y, float z) const {
    const float cx = grid_coord(x, b.lo[0], b.scale[0], b.clip_hi);
    const float cy = grid_coord(y, b.lo[1], b.scale[1], b.clip_hi);
    const float cz = grid_coord(z, b.lo[2], b.scale[2], b.clip_hi);
    const int x0 = static_cast<int>(floorf(cx));
    const int y0 = static_cast<int>(floorf(cy));
    const int z0 = static_cast<int>(floorf(cz));
    const float fx = cx - static_cast<float>(x0);
    const float fy = cy - static_cast<float>(y0);
    const float fz = cz - static_cast<float>(z0);
    const int x1 = min(x0 + 1, b.r - 1);
    const int y1 = min(y0 + 1, b.r - 1);
    const int z1 = min(z0 + 1, b.r - 1);
    const float gx = 1.0f - fx;
    const float c00 = at(x0, y0, z0) * gx + at(x1, y0, z0) * fx;
    const float c10 = at(x0, y1, z0) * gx + at(x1, y1, z0) * fx;
    const float c01 = at(x0, y0, z1) * gx + at(x1, y0, z1) * fx;
    const float c11 = at(x0, y1, z1) * gx + at(x1, y1, z1) * fx;
    const float c0 = c00 + (c10 - c00) * fy;
    const float c1 = c01 + (c11 - c01) * fy;
    const float interior = c0 + (c1 - c0) * fz;
    return outside_step(b, x, y, z, interior);
  }
};

__device__ __forceinline__ float table_value(const float* t, int i) { return t[i]; }
__device__ __forceinline__ float table_value(const __nv_bfloat16* t, int i) {
  return __bfloat162float(t[i]);
}

// the (x, y) weight as the contraction's operand: float32, or rounded to bf16
__device__ __forceinline__ float xy_weight(const float*, float w) { return w; }
__device__ __forceinline__ float xy_weight(const __nv_bfloat16*, float w) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

// hat weights of the two corners a = floor(c) and floor(c) + 1
__device__ __forceinline__ int hat_weights(float c, float& w0, float& w1) {
  const float a = floorf(c);
  w0 = fmaxf(0.0f, 1.0f - fabsf(c - a));
  w1 = fmaxf(0.0f, 1.0f - fabsf(c - (a + 1.0f)));
  return static_cast<int>(a);
}

template <class T>
struct Hat {
  const T* __restrict__ table;
  GridBox b;
  float margin;  // float32(_BF16_MARGIN * max|T|) for a bf16 level, else 0

  __device__ __forceinline__ float at(int ix, int iy, int iz) const {
    return table_value(table, (ix * b.r + iy) * b.r + iz);
  }

  // sum over the four (x, y) corners at z, in ascending x*R + y order
  __device__ __forceinline__ float v(int x0, int y0, int z, float w00, float w01, float w10,
                                     float w11) const {
    return ((at(x0, y0, z) * w00 + at(x0, y0 + 1, z) * w01) + at(x0 + 1, y0, z) * w10) +
           at(x0 + 1, y0 + 1, z) * w11;
  }

  __device__ __forceinline__ float operator()(float x, float y, float z) const {
    float wx0, wx1, wy0, wy1, wz0, wz1;
    const int x0 = hat_weights(grid_coord(x, b.lo[0], b.scale[0], b.clip_hi), wx0, wx1);
    const int y0 = hat_weights(grid_coord(y, b.lo[1], b.scale[1], b.clip_hi), wy0, wy1);
    const int z0 = hat_weights(grid_coord(z, b.lo[2], b.scale[2], b.clip_hi), wz0, wz1);
    const float w00 = xy_weight(table, wx0 * wy0);
    const float w01 = xy_weight(table, wx0 * wy1);
    const float w10 = xy_weight(table, wx1 * wy0);
    const float w11 = xy_weight(table, wx1 * wy1);
    const float interior =
        v(x0, y0, z0, w00, w01, w10, w11) * wz0 + v(x0, y0, z0 + 1, w00, w01, w10, w11) * wz1;
    return outside_step(b, x, y, z, interior) - margin;
  }
};

using HatF32 = Hat<float>;
using HatBf16 = Hat<__nv_bfloat16>;
