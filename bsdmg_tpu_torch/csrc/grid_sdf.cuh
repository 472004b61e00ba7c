// The grid SDF samplers of the mesh-asset render (K8, K9, P1): trilinear
// interpolation of a baked (R, R, R) table, C order, with the sound step
// outside the grid box.
//
// - InterpF32 is bsdmg_tpu/models/mesh_sdf.py::make_grid_interp_csdf, the
//   sampler of K8 (grid_kernel.py::_grid_trace_kernel) and of the XLA fine
//   finish and fd4 normals: eight corner gathers, lerps in that function's
//   order. P1 samples with it; K8 with InterpGather, the same arithmetic
//   with the eight reads at fixed offsets from one address.
// - hat_sample is grid_kernel.py::make_contraction_csdf, the sampler of K9
//   (_contraction_kernel) with an exact or a bf16 table: the hat weights
//   max(0, 1 - |c - a|) of the two corners a = floor(c), floor(c) + 1 of
//   each axis, which are not always (1 - f, f) bit for bit (c - 1 rounds
//   for small c); v(z) summed over the four (x, y) corners in ascending
//   x*R + y order, then v(z0) wz0 + v(z1) wz1, the outside step, minus the
//   level's margin. In bf16 the table and each w_xy = wx*wy are rounded to
//   bf16 (RNE) and the products summed in float32, as the TPU's bf16 dot
//   with preferred_element_type=f32. The MXU contraction over all R^2
//   (x, y) columns is TPU layout: on this card the four non-zero columns
//   are read directly. Hat<T> reads the eight corners from the raw table
//   (P1), HatCells<T> from the cell-packed copy (K9).
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
  if (!(sq > 0.0f)) return interior;  // inside the box: no square root
  const float outside = sqrtf(sq);    // > 0 for sq > 0
  return fmaxf(outside, interior - outside);
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

// K8's sampler: InterpF32's arithmetic in its order, the eight corners of
// the cell (x0, y0, z0) read at fixed offsets from one base address. The
// clamp to clip_hi keeps x0 <= r - 2 wherever clip_hi rounds below r - 1,
// that is for R <= 2049 (past the R <= 1290 that both samplers' 32-bit
// indices reach), which the wrapper checks (ops/cuda/grid_kernel.py::
// march_table), so InterpF32's min(x0 + 1, r - 1) is x0 + 1 and is not
// taken; floorf(c) is exact, so c - floorf(c) is InterpF32's c - float(x0).
struct InterpGather {
  const float* __restrict__ table;
  GridBox b;

  __device__ __forceinline__ float operator()(float x, float y, float z) const {
    const float cx = grid_coord(x, b.lo[0], b.scale[0], b.clip_hi);
    const float cy = grid_coord(y, b.lo[1], b.scale[1], b.clip_hi);
    const float cz = grid_coord(z, b.lo[2], b.scale[2], b.clip_hi);
    const float ax = floorf(cx), ay = floorf(cy), az = floorf(cz);
    const float fx = cx - ax, fy = cy - ay, fz = cz - az;
    const int r = b.r, rr = b.r * b.r;
    const float* p =
        table + (static_cast<int>(ax) * r + static_cast<int>(ay)) * r + static_cast<int>(az);
    const float gx = 1.0f - fx;
    const float c00 = __ldg(p) * gx + __ldg(p + rr) * fx;
    const float c10 = __ldg(p + r) * gx + __ldg(p + rr + r) * fx;
    const float c01 = __ldg(p + 1) * gx + __ldg(p + rr + 1) * fx;
    const float c11 = __ldg(p + r + 1) * gx + __ldg(p + rr + r + 1) * fx;
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

// hat weights max(0, 1 - |c - a|) of the two corners a = floor(c) and
// floor(c) + 1 of a coordinate c >= 0 (grid_coord's). The max with 0 never
// binds, so it is not taken: c - floor(c) lies in [0, 1) exactly, and
// c - (floor(c) + 1) rounds into [-1, 0], so both weights lie in [0, 1].
__device__ __forceinline__ int hat_weights(float c, float& w0, float& w1) {
  const float a = floorf(c);
  w0 = 1.0f - fabsf(c - a);
  w1 = 1.0f - fabsf(c - (a + 1.0f));
  return static_cast<int>(a);
}

// The hat-weight sample of a table of T whose `src.corners` gives the
// eight corners of the cell (x0, y0, z0) in the order they are summed:
// (x0, y0), (x0, y0 + 1), (x0 + 1, y0), (x0 + 1, y0 + 1) at z0, then the
// same four at z0 + 1. Each sampler below differs only in where it reads
// the corners from.
template <class T, class Corners>
__device__ __forceinline__ float hat_sample(const GridBox& b, float margin, const Corners& src,
                                            float x, float y, float z) {
  float wx0, wx1, wy0, wy1, wz0, wz1;
  const int x0 = hat_weights(grid_coord(x, b.lo[0], b.scale[0], b.clip_hi), wx0, wx1);
  const int y0 = hat_weights(grid_coord(y, b.lo[1], b.scale[1], b.clip_hi), wy0, wy1);
  const int z0 = hat_weights(grid_coord(z, b.lo[2], b.scale[2], b.clip_hi), wz0, wz1);
  const T* tag = nullptr;
  const float w00 = xy_weight(tag, wx0 * wy0);
  const float w01 = xy_weight(tag, wx0 * wy1);
  const float w10 = xy_weight(tag, wx1 * wy0);
  const float w11 = xy_weight(tag, wx1 * wy1);
  float c[8];
  src.corners(x0, y0, z0, c);
  // v(z) summed over the four (x, y) corners in ascending x*R + y order
  const float v0 = ((c[0] * w00 + c[1] * w01) + c[2] * w10) + c[3] * w11;
  const float v1 = ((c[4] * w00 + c[5] * w01) + c[6] * w10) + c[7] * w11;
  return outside_step(b, x, y, z, v0 * wz0 + v1 * wz1) - margin;
}

// the raw (R, R, R) table: eight gathers (P1's sampler)
template <class T>
struct Hat {
  const T* __restrict__ table;
  GridBox b;
  float margin;  // float32(_BF16_MARGIN * max|T|) for a bf16 level, else 0

  __device__ __forceinline__ float at(int ix, int iy, int iz) const {
    return table_value(table, (ix * b.r + iy) * b.r + iz);
  }

  __device__ __forceinline__ void corners(int x0, int y0, int z0, float* c) const {
#pragma unroll
    for (int k = 0; k < 8; ++k) c[k] = at(x0 + ((k >> 1) & 1), y0 + (k & 1), z0 + (k >> 2));
  }

  __device__ __forceinline__ float operator()(float x, float y, float z) const {
    return hat_sample<T>(b, margin, *this, x, y, z);
  }
};

using HatF32 = Hat<float>;
using HatBf16 = Hat<__nv_bfloat16>;

// K9's cell-packed table: cell (x0, y0, z0), x0, y0, z0 <= R - 2 (the clamp
// to R - 1 - 1e-4 keeps x0 + 1 in the table), holds its eight corners in
// hat_sample's order, ((x0 * (R - 1) + y0) * (R - 1) + z0) * 8 + k, built by
// ops/cuda/grid_kernel.py::cell_table. One sample reads one 16-byte cell in
// bf16, two in float32.
template <class T>
struct HatCells;

__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

template <>
struct HatCells<__nv_bfloat16> {
  const uint4* __restrict__ cells;
  GridBox b;
  float margin;

  __device__ __forceinline__ void corners(int x0, int y0, int z0, float* c) const {
    const int m = b.r - 1;
    const uint4 q = __ldg(cells + (x0 * m + y0) * m + z0);
    c[0] = bf16_lo(q.x);
    c[1] = bf16_hi(q.x);
    c[2] = bf16_lo(q.y);
    c[3] = bf16_hi(q.y);
    c[4] = bf16_lo(q.z);
    c[5] = bf16_hi(q.z);
    c[6] = bf16_lo(q.w);
    c[7] = bf16_hi(q.w);
  }

  __device__ __forceinline__ float operator()(float x, float y, float z) const {
    return hat_sample<__nv_bfloat16>(b, margin, *this, x, y, z);
  }
};

template <>
struct HatCells<float> {
  const float4* __restrict__ cells;
  GridBox b;
  float margin;

  __device__ __forceinline__ void corners(int x0, int y0, int z0, float* c) const {
    const int m = b.r - 1;
    const int i = 2 * ((x0 * m + y0) * m + z0);
    const float4 lo = __ldg(cells + i), hi = __ldg(cells + i + 1);
    c[0] = lo.x;
    c[1] = lo.y;
    c[2] = lo.z;
    c[3] = lo.w;
    c[4] = hi.x;
    c[5] = hi.y;
    c[6] = hi.z;
    c[7] = hi.w;
  }

  __device__ __forceinline__ float operator()(float x, float y, float z) const {
    return hat_sample<float>(b, margin, *this, x, y, z);
  }
};
