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
// - grid_scene is the grid as a scene of the mesh kernels K6 and K7
//   (scene_sdf.cuh GridScene): InterpF32's arithmetic ("weights", the JAX
//   package's grid_csdf) or grid_sdf's lerps ("lerp"), each point moved by
//   an offset first, and the value's gradient as jax.vjp takes it.
//
// Every float constant arrives as the float32 the plain twins
// (bsdmg_tpu_torch/models/mesh_sdf.py, ops/cuda/grid_kernel.py,
// ops/cuda/csdf.py) compute with, and with -fmad=false each operation
// rounds as theirs do.

#pragma once

#include <cuda_bf16.h>

#include "dual.cuh"

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

// ---------------------------------------------------------------------------
// a mesh asset's grid as a scene of K6 and K7
// ---------------------------------------------------------------------------

// the two forms the JAX package interpolates a grid in: grid_sdf's lerps
// c000 + (c100 - c000) * fx, which `cli mesh` meshes (through
// as_component), and grid_csdf's weights c000 * (1 - fx) + c100 * fx,
// which `cli remesh` meshes
enum GridForm { GRID_LERP = 0, GRID_WEIGHTS = 1 };

// The value at (x, y, z) + off, and with Grad its gradient by reverse mode
// with a cotangent of 1, as jax.vjp of the JAX function takes it: floor and
// the index casts carry nothing; jnp.clip's maximum(0, q) and
// minimum(clip_hi, .), the outside's maxima and the step's maximum weight
// their cotangents by JAX's tie rule (dual.cuh tie_weight); the square
// root's weight 0.5 / sqrt(sq) only where sq > 0. Cotangents that meet sum
// in the order of JAX's transpose (its equations in reverse): fx's from
// the lerps of c11, c01, c10 and c00 in turn (weights: + ct * c1, then
// - ct * c0), a coordinate's as (ct_hi - ct_lo) + ct_q * scale. The twin,
// operation for operation, is ops/cuda/csdf.py::_grid_value_and_grad; the
// value equals InterpF32's (weights) bit for bit at the same point.
template <int Form, bool Grad>
__device__ __forceinline__ float grid_scene(const float* __restrict__ table, const GridBox& b,
                                            const float* off, float x, float y, float z,
                                            float& gx, float& gy, float& gz) {
  const float u[3] = {x + off[0], y + off[1], z + off[2]};
  float q[3], m[3], c[3], f[3];
  int i0[3], i1[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    q[a] = (u[a] - b.lo[a]) * b.scale[a];
    m[a] = fmaxf(q[a], 0.0f);
    c[a] = fminf(m[a], b.clip_hi);
    const float base = floorf(c[a]);
    f[a] = c[a] - base;
    i0[a] = static_cast<int>(base);
    i1[a] = min(i0[a] + 1, b.r - 1);
  }
  const int r = b.r;
  // a[dy][dz][dx]
  float a[2][2][2];
#pragma unroll
  for (int dy = 0; dy < 2; ++dy)
#pragma unroll
    for (int dz = 0; dz < 2; ++dz)
#pragma unroll
      for (int dx = 0; dx < 2; ++dx)
        a[dy][dz][dx] = table[((dx ? i1[0] : i0[0]) * r + (dy ? i1[1] : i0[1])) * r +
                              (dz ? i1[2] : i0[2])];
  const float wx = 1.0f - f[0];
  float cx[2][2];
#pragma unroll
  for (int dy = 0; dy < 2; ++dy)
#pragma unroll
    for (int dz = 0; dz < 2; ++dz)
      cx[dy][dz] = Form == GRID_LERP ? a[dy][dz][0] + (a[dy][dz][1] - a[dy][dz][0]) * f[0]
                                     : a[dy][dz][0] * wx + a[dy][dz][1] * f[0];
  const float c0 = cx[0][0] + (cx[1][0] - cx[0][0]) * f[1];
  const float c1 = cx[0][1] + (cx[1][1] - cx[0][1]) * f[1];
  const float interior = c0 + (c1 - c0) * f[2];
  float below[3], above[3], m1[3], o[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    below[k] = b.lo[k] - u[k];
    above[k] = u[k] - b.hi[k];
    m1[k] = fmaxf(below[k], above[k]);
    o[k] = fmaxf(m1[k], 0.0f);
  }
  const float sq = (o[0] * o[0] + o[1] * o[1]) + o[2] * o[2];
  const bool out = sq > 0.0f;
  const float outside = out ? sqrtf(sq) : 0.0f;
  const float diff = interior - outside;
  const float mx = fmaxf(outside, diff);
  const bool stepped = outside > 0.0f;
  const float d = stepped ? mx : interior;
  if (!Grad) return d;

  // backward, cotangent 1
  const float w_diff = tie_weight(diff, mx, outside);
  const float ct_int = stepped ? w_diff : 1.0f;
  const float ct_out = stepped ? tie_weight(outside, mx, diff) - w_diff : 0.0f;
  const float ct_sq = out ? ct_out * (0.5f / outside) : 0.0f;
  const float ct_fz = ct_int * (c1 - c0);
  const float ct_c1 = ct_int * f[2];
  const float ct_c0 = ct_int - ct_c1;
  const float ct_fy = ct_c1 * (cx[1][1] - cx[0][1]) + ct_c0 * (cx[1][0] - cx[0][0]);
  const float ct_cx[2][2] = {{ct_c0 - ct_c0 * f[1], ct_c1 - ct_c1 * f[1]},
                             {ct_c0 * f[1], ct_c1 * f[1]}};
  // the lerps of c11, c01, c10, c00: [dy][dz] = [1][1], [0][1], [1][0], [0][0]
  float ct_fx = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int dy = (k & 1) ? 0 : 1, dz = k < 2 ? 1 : 0;
    const float ct = ct_cx[dy][dz];
    if (Form == GRID_LERP) {
      const float t = ct * (a[dy][dz][1] - a[dy][dz][0]);
      ct_fx = k == 0 ? t : ct_fx + t;
    } else {
      const float t = ct * a[dy][dz][1];
      ct_fx = (k == 0 ? t : ct_fx + t) - ct * a[dy][dz][0];
    }
  }
  const float ct_f[3] = {ct_fx, ct_fy, ct_fz};
  float g[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float ct_m = ct_f[k] * tie_weight(m[k], c[k], b.clip_hi);
    const float ct_t = (ct_m * tie_weight(q[k], m[k], 0.0f)) * b.scale[k];
    const float s = ct_sq * o[k];
    const float ct_m1 = (s + s) * tie_weight(m1[k], o[k], 0.0f);
    const float ct_above = ct_m1 * tie_weight(above[k], m1[k], below[k]);
    const float ct_below = ct_m1 * tie_weight(below[k], m1[k], above[k]);
    g[k] = (ct_above - ct_below) + ct_t;
  }
  gx = g[0];
  gy = g[1];
  gz = g[2];
  return d;
}
