// Device code that K1 (render_kernel.cu) shares with K4 and K5
// (diff_kernel.cu): the outcome codes, the slab cull of the march, and the
// shading (Lambert two-colour mix and ACES).
//
// The functions are templates over the descriptor S, which K1 takes as a
// SceneDesc (scene_sdf.cuh) and K4/K5 as a ParamScene (param_sdf.cuh): both
// carry the same field names for the bounds, the march limits and the
// shading constants. The shading is also a template over the scalar T:
// float in K1, Dual<N> in K5, which differentiates it. For float every
// function runs the operations K1 always ran, in the same order.

#pragma once

#include "dual.cuh"

enum { COLLISION = 0, STEP_LIMIT = 1, DEPTH_LIMIT = 2 };

// one axis of the slab test against [lo - margin, hi + margin]
__device__ __forceinline__ void slab_axis(float o, float d, float lo, float hi, float margin,
                                          float& t_near, float& t_far) {
  const float d_safe = fabsf(d) < 1e-12f ? (d < 0.0f ? -1e-12f : 1e-12f) : d;
  const float inv = 1.0f / d_safe;
  const float t1 = ((lo - margin) - o) * inv;
  const float t2 = ((hi + margin) - o) * inv;
  t_near = fminf(t1, t2);
  t_far = fmaxf(t1, t2);
}

// the slab cull (bsdmg_tpu/ops/pallas/render_kernel.py::_slab_cull): can the
// ray collide with a surface inside the bounds [s.lo, s.hi], inflated by
// cone * T* + eps + slack? Returns true for a ray that cannot; otherwise
// `limit` is the ray's stop depth, the box's exit depth capped at the
// depth limit.
template <class S>
__device__ __forceinline__ bool slab_cull(const S& s, float ox, float oy, float oz, float dx,
                                          float dy, float dz, float c, float& limit) {
  const float eps = s.collision_distance;
  const float ex = ox - s.cull_center[0], ey = oy - s.cull_center[1], ez = oz - s.cull_center[2];
  const float reach = ((sqrtf(ex * ex + ey * ey + ez * ez) + s.cull_radius) + s.slack) + eps;
  const float t_star = c < 0.5f ? reach / fmaxf(1.0f - c, 0.5f) : s.depth_limit;
  const float margin = (c * fminf(t_star, s.depth_limit) + eps) + s.slack;
  float nx, fx, ny, fy, nz, fz;
  slab_axis(ox, dx, s.lo[0], s.hi[0], margin, nx, fx);
  slab_axis(oy, dy, s.lo[1], s.hi[1], margin, ny, fy);
  slab_axis(oz, dz, s.lo[2], s.hi[2], margin, nz, fz);
  const float tmin = fmaxf(nx, fmaxf(ny, nz));
  const float tmax = fminf(fx, fminf(fy, fz));
  limit = fminf(fmaxf(tmax, 0.0f), s.depth_limit);
  return tmax < fmaxf(tmin, 0.0f);
}

// the fields of slab_cull for the near component's bounds of the near/far
// split (SceneDesc and ParamScene near_*), with the march's eps and limit
struct NearBox {
  float lo[3], hi[3], cull_center[3];
  float cull_radius, slack, collision_distance, depth_limit;
};

// the near/far split's test (render_kernel.py:412-425, diff_kernel.py
// :120-131): the slab cull against the near component's bounds, true for a
// ray that cannot reach them
template <class S>
__device__ __forceinline__ bool near_miss(const S& s, float ox, float oy, float oz, float dx,
                                          float dy, float dz, float c) {
  NearBox n;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    n.lo[a] = s.near_lo[a];
    n.hi[a] = s.near_hi[a];
    n.cull_center[a] = s.near_center[a];
  }
  n.cull_radius = s.near_radius;
  n.slack = s.near_slack;
  n.collision_distance = s.collision_distance;
  n.depth_limit = s.depth_limit;
  float limit;
  return slab_cull(n, ox, oy, oz, dx, dy, dz, c, limit);
}

// Lambert two-colour mix of a unit normal (ops/shade.py::shade_planes)
template <class S, class T>
__device__ __forceinline__ void shade_collision(const S& s, const T& nx, const T& ny, const T& nz,
                                                T& r, T& g, T& b) {
  const T t = (((nx * s.light[0] + ny * s.light[1]) + nz * s.light[2]) + 1.0f) * 0.5f;
  r = s.color_low[0] + t * s.color_delta[0];
  g = s.color_low[1] + t * s.color_delta[1];
  b = s.color_low[2] + t * s.color_delta[2];
}

template <class S, class T>
__device__ __forceinline__ T aces_curve(const S& s, const T& v) {
  return (v * (v + s.aces_curve[0]) - s.aces_curve[1]) /
         (v * (s.aces_curve[2] * v + s.aces_curve[3]) + s.aces_curve[4]);
}

// jnp.clip(v, 0, 1): minimum(1, maximum(0, v))
template <class T>
__device__ __forceinline__ T clip01(const T& v) {
  return vmin(vmax(v, 0.0f), 1.0f);
}

// ACES (bsdmg_tpu/ops/pallas/render_kernel.py::_aces_plane), clipped to [0, 1]
template <class S, class T>
__device__ __forceinline__ void aces(const S& s, const T& r, const T& g, const T& b, T out[3]) {
  const T vr = aces_curve(s, s.aces_m1[0] * r + s.aces_m1[1] * g + s.aces_m1[2] * b);
  const T vg = aces_curve(s, s.aces_m1[3] * r + s.aces_m1[4] * g + s.aces_m1[5] * b);
  const T vb = aces_curve(s, s.aces_m1[6] * r + s.aces_m1[7] * g + s.aces_m1[8] * b);
  out[0] = clip01(s.aces_m2[0] * vr + s.aces_m2[1] * vg + s.aces_m2[2] * vb);
  out[1] = clip01(s.aces_m2[3] * vr + s.aces_m2[4] * vg + s.aces_m2[5] * vb);
  out[2] = clip01(s.aces_m2[6] * vr + s.aces_m2[7] * vg + s.aces_m2[8] * vb);
}
