// The scene SDF of the reference scenes on the device, shared by K1
// (render_kernel.cu), K6 (mc_kernel.cu) and K7 (project_kernel.cu).
//
// Both functions take the JAX compiler's factorised capsule set
// (bsdmg_tpu/ops/pallas/csdf.py::capsule_set_sq_csdf): per parallel-edge
// group `(axial + min(V1)) + min(V2)`, then `min` across the groups and one
// sqrt. Float rounding is monotonic, so this equals the minimum over the
// segments of `(e^2 + o1^2) + o2^2` bit for bit, with about a third of the
// arithmetic. scene_sdf is the value; scene_sdf_grad is the value and its
// gradient as JAX's reverse mode takes it (jax.vjp with a cotangent of 1),
// with JAX's tie rules (min and max split the cotangent evenly at a tie,
// tie_weight in dual.cuh; abs passes +1 at 0). The plain PyTorch twins are
// descriptor_csdf and descriptor_csdf_value_and_grad in
// bsdmg_tpu_torch/ops/cuda/csdf.py.
//
// Numerics: the library is built with -fmad=false and without fast math,
// and every sum runs in the twin's order, so each function equals its twin
// bit for bit.

#pragma once

#include <math_constants.h>

#include "common.cuh"

#define BSDMG_GROUPS 3  // parallel-edge groups of a box skeleton
#define BSDMG_GROUP_VALUES 2  // distinct perpendicular coordinates per axis

// Segments of one direction, start and length whose perpendicular
// coordinates form the cross product v1 x v2. v1 lies on the lower, v2 on
// the higher of the two other axes, each ascending, n1 and n2 of them.
struct CapsuleGroup {
  int axis;
  float a0;
  float length;
  int n1;
  int n2;
  float v1[BSDMG_GROUP_VALUES];
  float v2[BSDMG_GROUP_VALUES];
};

// Axis-aligned capsules of one radius, as groups[0..n_groups) in the JAX
// compiler's order.
struct CapsuleSet {
  float radius;
  int n_groups;
  CapsuleGroup groups[BSDMG_GROUPS];
};

// Mirrors _SceneDescC in ops/cuda/render_kernel.py field by field. The mesh
// kernels read the scene fields only.
struct SceneDesc {
  CapsuleSet object;  // box skeleton of the CSG object
  CapsuleSet frame;   // bounding-box wireframe (used when has_frame)
  int has_frame;
  int has_transform;
  float sphere_radius;
  float smooth_k;
  float inv_k;  // float32(1/k), rounded from float64 like the JAX constant
  float k_6;    // float32(k/6)
  float inv_rotation[9];  // rows of R^T, applied after the translation
  float translation[3];
  float lo[3];  // scene bounds
  float hi[3];
  float cull_center[3];  // centre and half-diagonal of the bounds
  float cull_radius;
  float slack;  // the SDF's under-estimation bound
  float collision_distance;
  float depth_limit;
  float cull_depth;  // depth of a culled ray: 1.01 * depth_limit
  float normal_epsilon;
  int step_limit;
  float light[3];
  float color_low[3];
  float color_delta[3];
  float aces_m1[9];
  float aces_m2[9];
  float aces_curve[5];
};

__device__ __forceinline__ float pick(int axis, float x, float y, float z) {
  return axis == 0 ? x : (axis == 1 ? y : z);
}

__device__ __forceinline__ void add_to_axis(int axis, float v, float& gx, float& gy, float& gz) {
  if (axis == 0) gx += v;
  else if (axis == 1) gy += v;
  else gz += v;
}

// ---------------------------------------------------------------------------
// value
// ---------------------------------------------------------------------------

// squared distance of one group: (axial + min(V1)) + min(V2)
__device__ __forceinline__ float group_d2(const CapsuleGroup& g, float x, float y, float z) {
  const float r = pick(g.axis, x, y, z) - g.a0;
  const float e = r - fminf(fmaxf(r, 0.0f), g.length);
  const float c1 = pick(g.axis == 0 ? 1 : 0, x, y, z);
  const float c2 = pick(g.axis == 2 ? 1 : 2, x, y, z);
  const float d10 = c1 - g.v1[0];
  float m1 = d10 * d10;
  if (g.n1 > 1) {
    const float d11 = c1 - g.v1[1];
    m1 = fminf(m1, d11 * d11);
  }
  const float d20 = c2 - g.v2[0];
  float m2 = d20 * d20;
  if (g.n2 > 1) {
    const float d21 = c2 - g.v2[1];
    m2 = fminf(m2, d21 * d21);
  }
  return (e * e + m1) + m2;
}

// the squared distances of the groups and their running minimum
struct CapsuleFwd {
  float d2[BSDMG_GROUPS];
  float best[BSDMG_GROUPS];
  float root;  // sqrt of the overall minimum
};

__device__ __forceinline__ float capsule_set_fwd(const CapsuleSet& c, float x, float y, float z,
                                                 CapsuleFwd& f) {
  float best = CUDART_INF_F;
#pragma unroll
  for (int g = 0; g < BSDMG_GROUPS; ++g) {
    if (g < c.n_groups) {
      f.d2[g] = group_d2(c.groups[g], x, y, z);
      best = g == 0 ? f.d2[0] : fminf(best, f.d2[g]);
      f.best[g] = best;
    }
  }
  f.root = sqrtf(best);
  return f.root - c.radius;
}

// ops/pallas/csdf.py::reference_render_scene_csdf
__device__ __forceinline__ float scene_sdf(const SceneDesc& s, float x, float y, float z) {
  float ox = x, oy = y, oz = z;
  if (s.has_transform) {
    const float tx = x - s.translation[0];
    const float ty = y - s.translation[1];
    const float tz = z - s.translation[2];
    ox = s.inv_rotation[0] * tx + s.inv_rotation[1] * ty + s.inv_rotation[2] * tz;
    oy = s.inv_rotation[3] * tx + s.inv_rotation[4] * ty + s.inv_rotation[5] * tz;
    oz = s.inv_rotation[6] * tx + s.inv_rotation[7] * ty + s.inv_rotation[8] * tz;
  }
  CapsuleFwd fo;
  const float skel = capsule_set_fwd(s.object, ox, oy, oz, fo);
  const float sph = sqrtf(ox * ox + oy * oy + oz * oz) - s.sphere_radius;
  const float h = fmaxf(s.smooth_k - fabsf(skel - sph), 0.0f) * s.inv_k;
  float d = fminf(skel, sph) - h * h * h * s.k_6;
  if (s.has_frame) {
    CapsuleFwd ff;
    d = fminf(d, capsule_set_fwd(s.frame, x, y, z, ff));
  }
  return d;
}

// ---------------------------------------------------------------------------
// gradient
// ---------------------------------------------------------------------------

// the two squares of one perpendicular slot, backward: adds the cotangent of
// coordinate c given the cotangent ct of min(sq0, sq1) (or of sq0 alone)
__device__ __forceinline__ float slot_bwd(float c, const float* v, int n, float ct) {
  const float d0 = c - v[0];
  const float s0 = d0 * d0;
  float ct0 = ct, ct1 = 0.0f, d1 = 0.0f;
  if (n > 1) {
    d1 = c - v[1];
    const float s1 = d1 * d1;
    const float m = fminf(s0, s1);
    ct0 = ct * tie_weight(s0, m, s1);
    ct1 = ct * tie_weight(s1, m, s0);
  }
  // d(d*d) = ct*d + d*ct
  const float a0 = ct0 * d0;
  float out = a0 + a0;
  if (n > 1) {
    const float a1 = ct1 * d1;
    out += a1 + a1;
  }
  return out;
}

// one group, backward, with cotangent ct of its squared distance
__device__ __forceinline__ void group_bwd(const CapsuleGroup& g, float x, float y, float z, float ct,
                                          float& gx, float& gy, float& gz) {
  const float r = pick(g.axis, x, y, z) - g.a0;
  const float mx = fmaxf(r, 0.0f);  // jnp.clip: maximum(0, r), then minimum(length, .)
  const float t = fminf(mx, g.length);
  const float e = r - t;
  const float ce = ct * e;
  const float ct_e = ce + ce;
  const float ct_t = -ct_e;
  const float ct_mx = ct_t * tie_weight(mx, t, g.length);
  const float ct_r = ct_e + ct_mx * tie_weight(r, mx, 0.0f);
  add_to_axis(g.axis, ct_r, gx, gy, gz);
  const int lo = g.axis == 0 ? 1 : 0;
  const int hi = g.axis == 2 ? 1 : 2;
  add_to_axis(lo, slot_bwd(pick(lo, x, y, z), g.v1, g.n1, ct), gx, gy, gz);
  add_to_axis(hi, slot_bwd(pick(hi, x, y, z), g.v2, g.n2, ct), gx, gy, gz);
}

// adds ct * d(capsule set)/d(x, y, z) to (gx, gy, gz)
__device__ __forceinline__ void capsule_set_bwd(const CapsuleSet& c, float x, float y, float z,
                                                const CapsuleFwd& f, float ct, float& gx,
                                                float& gy, float& gz) {
  float w = ct * (0.5f / f.root);  // d sqrt(b) = (0.5 / sqrt(b)) db
  float ctg[BSDMG_GROUPS];
#pragma unroll
  for (int g = BSDMG_GROUPS - 1; g >= 1; --g) {
    if (g < c.n_groups) {
      ctg[g] = w * tie_weight(f.d2[g], f.best[g], f.best[g - 1]);
      w = w * tie_weight(f.best[g - 1], f.best[g], f.d2[g]);
    }
  }
  ctg[0] = w;
#pragma unroll
  for (int g = 0; g < BSDMG_GROUPS; ++g) {
    if (g < c.n_groups) group_bwd(c.groups[g], x, y, z, ctg[g], gx, gy, gz);
  }
}

// value and gradient of scene_sdf (the value equals scene_sdf's bit for bit)
__device__ __forceinline__ void scene_sdf_grad(const SceneDesc& s, float x, float y, float z,
                                               float& d, float& gx, float& gy, float& gz) {
  float ox = x, oy = y, oz = z;
  if (s.has_transform) {
    const float tx = x - s.translation[0];
    const float ty = y - s.translation[1];
    const float tz = z - s.translation[2];
    ox = s.inv_rotation[0] * tx + s.inv_rotation[1] * ty + s.inv_rotation[2] * tz;
    oy = s.inv_rotation[3] * tx + s.inv_rotation[4] * ty + s.inv_rotation[5] * tz;
    oz = s.inv_rotation[6] * tx + s.inv_rotation[7] * ty + s.inv_rotation[8] * tz;
  }
  // forward
  CapsuleFwd fo;
  const float skel = capsule_set_fwd(s.object, ox, oy, oz, fo);
  const float sroot = sqrtf(ox * ox + oy * oy + oz * oz);
  const float sph = sroot - s.sphere_radius;
  const float delta = skel - sph;
  const float u = s.smooth_k - fabsf(delta);
  const float hm = fmaxf(u, 0.0f);
  const float h = hm * s.inv_k;
  const float h2 = h * h;
  const float h3 = h2 * h;
  const float m = fminf(skel, sph);
  const float obj = m - h3 * s.k_6;
  d = obj;
  CapsuleFwd ff;
  float frame = 0.0f;
  if (s.has_frame) {
    frame = capsule_set_fwd(s.frame, x, y, z, ff);
    d = fminf(obj, frame);
  }

  // backward, cotangent 1
  float ct_obj = 1.0f;
  if (s.has_frame) ct_obj = tie_weight(obj, d, frame);
  const float ct_h3 = -ct_obj * s.k_6;
  const float ct_h2 = ct_h3 * h;
  const float ct_h = (h2 * ct_h3 + ct_h2 * h) + h * ct_h2;
  const float ct_u = (ct_h * s.inv_k) * tie_weight(u, hm, 0.0f);
  const float ct_abs = -ct_u;
  const float ct_delta = delta >= 0.0f ? ct_abs : -ct_abs;  // jax: d|x| = +1 at 0
  const float ct_skel = ct_obj * tie_weight(skel, m, sph) + ct_delta;
  const float ct_sph = ct_obj * tie_weight(sph, m, skel) - ct_delta;
  const float ct_s2 = ct_sph * (0.5f / sroot);

  float cx = 0.0f, cy = 0.0f, cz = 0.0f;
  capsule_set_bwd(s.object, ox, oy, oz, fo, ct_skel, cx, cy, cz);
  const float sx = ct_s2 * ox, sy = ct_s2 * oy, sz = ct_s2 * oz;
  cx += sx + sx;
  cy += sy + sy;
  cz += sz + sz;
  if (s.has_transform) {
    const float* m9 = s.inv_rotation;
    gx = (m9[0] * cx + m9[3] * cy) + m9[6] * cz;
    gy = (m9[1] * cx + m9[4] * cy) + m9[7] * cz;
    gz = (m9[2] * cx + m9[5] * cy) + m9[8] * cz;
  } else {
    gx = cx;
    gy = cy;
    gz = cz;
  }
  if (s.has_frame) capsule_set_bwd(s.frame, x, y, z, ff, tie_weight(frame, d, obj), gx, gy, gz);
}
