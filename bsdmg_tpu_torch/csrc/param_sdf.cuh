// The parameter form of the reference scenes on the device, for K4 and K5
// (diff_kernel.cu), and the ParamScene that every form is passed in (the
// other forms: param_forms.cuh).
//
// K1, K6 and K7 read a SceneDesc (scene_sdf.cuh) whose constants the host
// bakes in float64. The differentiable path evaluates the scene the way the
// JAX package's Scene.csdf does, from the parameter values at run time in
// float32: `lo = c - s/2` on every call, `o1 - s1`, the smooth minimum as
// `max(k - |a-b|, 0) / k` and `min - h*h*h*k*(1/6)`. The two forms round
// differently, and a silhouette ray would flip its hit test between them,
// so the kernels evaluate this form: bsdmg_tpu/models/scenes.py::_sd_obj_c
// (box skeleton, sphere, smooth minimum, optional object transform) and the
// render scene's union with the bounding-box wireframe, operation for
// operation. The plain PyTorch twin is ReferenceCsdf in
// bsdmg_tpu_torch/models/scenes.py.
//
// Everything is a template over the scalar T of the point and the values,
// and over the parameters' types: Dual<1> at a point whose tangent is the
// ray's direction for K4's directional derivative and K5's IFT
// denominator, Dual<N> (dual.cuh) in K5's tangent launches, where a lane
// seeds the parameters whose tangents it carries with their unit tangents
// and holds the others as floats. The march evaluates the scene in float32
// through its march form (MarchScene, below). scene_value is the SDF;
// scene_value_grad is its spatial gradient, written as a reverse pass by
// hand (as scene_sdf_grad is) with JAX's tie rules. Evaluated in Dual<N>,
// the gradient's tangents are the total derivatives
// d(grad_x f(q(theta), theta))/d theta that K5's shading normal needs.

#pragma once

#include <type_traits>

#include "common.cuh"
#include "grid_sdf.cuh"

#define BSDMG_MAX_PARAMS 64  // values of ParamScene::prm (the small tier's cap)
#define BSDMG_REFERENCE_PARAMS 16  // 9 shape values, object_center (3), object_rotation (4)

// the scene's form: the reference scenes (this header), or one of
// param_forms.cuh
enum ParamForm {
  FORM_REFERENCE,
  FORM_SPHERE,
  FORM_MANDELBULB,
  FORM_WRAPPED,
  FORM_PROGRAM,
  FORM_MESH_GRID,
  FORM_PROGRAM_LARGE
};

// Mirrors _ParamSceneC in ops/cuda/diff_kernel.py field by field.
struct ParamScene {
  // the parameter values at fixed places, which the kernels read as
  // constant operands: the skeleton's centre and size, its line width, the
  // sphere's radius, the smooth minimum's k; the object's centre (0 where
  // absent) and rotation ((1, 0, 0, 0) where absent)
  float shape_prm[9];
  float rigid_prm[7];
  int n_prm;  // the length of the flat parameter vector (weights.flatten_params)
  // the slots of prm whose adjoints K5 returns: n_prm, and for the wrapped
  // object, whose tangent launch sweeps its parameter program, the private
  // slots after the flat vector too (csdf.py wrapped_param_program)
  int n_slots;
  // index in the flat vector of each parameter's first component, which
  // places its gradient in K5's output; -1 where absent
  int skeleton_center;
  int skeleton_size;
  int skeleton_line_width;
  int sphere_radius;
  int smooth_k;
  int object_center;
  int object_rotation;
  int reference_compat;  // the skeleton's (dir+1)%2 size index
  int has_frame;         // the render scene: union with the wireframe
  float frame_size;
  float frame_line_width;
  int use_bounds;  // slab cull against lo/hi
  float lo[3];
  float hi[3];
  float cull_center[3];  // centre and half-diagonal of the bounds
  float cull_radius;
  float slack;
  float collision_distance;
  float depth_limit;
  float cull_depth;  // depth of a culled ray: 1.01 * depth_limit
  int step_limit;
  float light[3];
  float color_low[3];
  float color_delta[3];
  float aces_m1[9];
  float aces_m2[9];
  float aces_curve[5];
  // the forms beside the reference scenes' (param_forms.cuh)
  int form;                     // ParamForm
  float prm[BSDMG_MAX_PARAMS];  // the flat parameter vector
  int cell;                     // the wrapped object: the slot of its lattice period
  // a composed scene, or the wrapped object's lowered form for K5's tangent
  // launch: its parameter program in device memory, program_length
  // instructions of BSDMG_PARAM_WORDS words (csdf.py param_program_words);
  // the caller owns the buffer
  const int* program;
  int program_length;
  // a mesh asset's grid: its baked (r, r, r) table in device memory, C
  // order, read as data and no parameter (n_prm 0), and its box; the caller
  // keeps the table alive
  const float* grid_table;
  GridBox grid;
  // a composed scene in the large tier (FORM_PROGRAM_LARGE): the flat
  // parameter vector in device memory (n_prm values), the interpreter's
  // scratch buffer, sized by the wrapper for scratch_threads threads, and
  // the program's most values on the stack and nested frames at once
  const float* prm_values;
  float* scratch;
  int scratch_threads;
  int program_depth;
  int program_frames;
  // the near/far split of the march (split != 0, the reference form with
  // its wireframe): the near component's bounds, as lo, hi, their cull
  // sphere and slack; a patch of rays that all miss them marches the
  // wireframe alone
  int split;
  float near_lo[3];
  float near_hi[3];
  float near_center[3];
  float near_radius;
  float near_slack;
};

// The scene's optional parts: AnyParts reads them from the ParamScene at
// run time (K4's dfdt, K5's IFT denominator and the march form below, where
// they cost little and fixing them raised the registers and the time);
// Parts<Frame, Transform> fixes them at compile time (K5's tangent
// launches), Transform then reading which of the transform's parameters
// are there.
struct AnyParts {
  static __device__ __forceinline__ bool frame(const ParamScene& s) { return s.has_frame != 0; }
  static __device__ __forceinline__ bool translation(const ParamScene& s) {
    return s.object_center >= 0;
  }
  static __device__ __forceinline__ bool rotation(const ParamScene& s) {
    return s.object_rotation >= 0;
  }
};

template <bool Frame, bool Transform>
struct Parts {
  static __device__ __forceinline__ bool frame(const ParamScene&) { return Frame; }
  static __device__ __forceinline__ bool translation(const ParamScene& s) {
    return Transform && s.object_center >= 0;
  }
  static __device__ __forceinline__ bool rotation(const ParamScene& s) {
    return Transform && s.object_rotation >= 0;
  }
};

// the parameters: the shape's as S, the object's translation as Tr and
// rotation as Ro
template <class S, class Tr = S, class Ro = Tr>
struct ObjectParams {
  S center[3];
  S size[3];
  S line_width;
  S radius;
  S k;
  Tr translation[3];
  Ro rotation[4];  // quaternion (w, x, y, z)
};

// the parameters. A Dual<M> of S carries the tangents of the shape's
// parameters (places: skeleton centre 0-2, size 3-5, line width 6, sphere
// radius 7, smooth k 8) block * M .. block * M + M - 1, one of Tr or Ro the
// transform's (places: object centre 0-2, rotation 3-6); a float carries
// none.
template <class S, class Tr = S, class Ro = Tr, class Opt = AnyParts>
__device__ __forceinline__ ObjectParams<S, Tr, Ro> load_params(const ParamScene& s, int block = 0) {
  ObjectParams<S, Tr, Ro> p;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    p.center[a] = Scalar<S>::placed(s.shape_prm[a], a, block);
    p.size[a] = Scalar<S>::placed(s.shape_prm[3 + a], 3 + a, block);
  }
  p.line_width = Scalar<S>::placed(s.shape_prm[6], 6, block);
  p.radius = Scalar<S>::placed(s.shape_prm[7], 7, block);
  p.k = Scalar<S>::placed(s.shape_prm[8], 8, block);
  if (Opt::translation(s)) {
#pragma unroll
    for (int a = 0; a < 3; ++a) p.translation[a] = Scalar<Tr>::placed(s.rigid_prm[a], a, block);
  }
  if (Opt::rotation(s)) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
      p.rotation[a] = Scalar<Ro>::placed(s.rigid_prm[3 + a], 3 + a, block);
  }
  return p;
}

// ---------------------------------------------------------------------------
// box skeleton (sdf/primitives.py::sd_box_skeleton_c), P the parameters' type
// ---------------------------------------------------------------------------

template <class T>
struct SkeletonFwd {
  T d2[3];
  T best[3];
  T root;
};

template <class P>
__device__ __forceinline__ P perp_size(const P size[3], int d, int compat) {
  return compat ? size[(d + 1) % 2] : size[(d + 1) % 3];
}

template <class T, class P>
__device__ __forceinline__ T skeleton_fwd(const T c[3], const P lo[3], const P size[3],
                                          const P& line_width, int compat, SkeletonFwd<T>& f) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int a1 = (d + 1) % 3, a2 = (d + 2) % 3;
    const T r = c[d] - lo[d];
    const T t = vmin(vmax(r, 0.0f), size[d]);  // jnp.clip(r, 0, size[d])
    const T e = r - t;
    const T o1 = c[a1] - lo[a1];
    const T o1b = o1 - perp_size(size, d, compat);
    const T o2 = c[a2] - lo[a2];
    const T o2b = o2 - size[a2];
    f.d2[d] = (e * e + vmin(o1 * o1, o1b * o1b)) + vmin(o2 * o2, o2b * o2b);
    if (d == 0) f.best[0] = f.d2[0];
    else f.best[d] = vmin(f.best[d - 1], f.d2[d]);
  }
  f.root = vsqrt(f.best[2]);
  return f.root - line_width;
}

// the cotangent of a perpendicular coordinate from min(o*o, ob*ob), ob = o - size,
// given the cotangent ct of that minimum
template <class T>
__device__ __forceinline__ T slot_bwd(const T& o, const T& ob, const T& ct) {
  const T sa = o * o, sb = ob * ob;
  const float m = fminf(value_of(sa), value_of(sb));
  const T ca = ct * tie_weight(value_of(sa), m, value_of(sb));
  const T cb = ct * tie_weight(value_of(sb), m, value_of(sa));
  const T ga = ca * o, gb = cb * ob;
  return (ga + ga) + (gb + gb);
}

// adds ct * d(skeleton)/d(c) to g
template <class T, class P>
__device__ __forceinline__ void skeleton_bwd(const T c[3], const P lo[3], const P size[3], int compat,
                                             const SkeletonFwd<T>& f, const T& ct, T g[3]) {
  T w = ct * (0.5f / f.root);  // d sqrt(b) = (0.5 / sqrt(b)) db
  T ctd[3];
#pragma unroll
  for (int d = 2; d >= 1; --d) {
    ctd[d] = w * tie_weight(value_of(f.d2[d]), value_of(f.best[d]), value_of(f.best[d - 1]));
    w = w * tie_weight(value_of(f.best[d - 1]), value_of(f.best[d]), value_of(f.d2[d]));
  }
  ctd[0] = w;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int a1 = (d + 1) % 3, a2 = (d + 2) % 3;
    const T r = c[d] - lo[d];
    const T mx = vmax(r, 0.0f);
    const T t = vmin(mx, size[d]);
    const T e = r - t;
    const T ce = ctd[d] * e;
    const T ct_e = ce + ce;
    const T ct_mx = -ct_e * tie_weight(value_of(mx), value_of(t), value_of(size[d]));
    g[d] = g[d] + (ct_e + ct_mx * tie_weight(value_of(r), value_of(mx), 0.0f));
    const T o1 = c[a1] - lo[a1];
    g[a1] = g[a1] + slot_bwd(o1, o1 - perp_size(size, d, compat), ctd[d]);
    const T o2 = c[a2] - lo[a2];
    g[a2] = g[a2] + slot_bwd(o2, o2 - size[a2], ctd[d]);
  }
}

// ---------------------------------------------------------------------------
// the object (models/scenes.py::_sd_obj_c) and the scene
// ---------------------------------------------------------------------------

// rows of R(q)^T applied as models/scenes.py::_quat_inv_rotate_c does
template <class T>
struct Frame {
  T m[9];  // ox = m0 x + m3 y + m6 z, oy = m1 x + m4 y + m7 z, oz = m2 x + m5 y + m8 z
};

template <class T>
__device__ __forceinline__ Frame<T> rotation(const T q[4]) {
  const T inv = vrsqrt(vmax(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3], 1e-24f));
  const T w = q[0] * inv, qx = q[1] * inv, qy = q[2] * inv, qz = q[3] * inv;
  Frame<T> f;
  f.m[0] = 1.0f - 2.0f * (qy * qy + qz * qz);
  f.m[1] = 2.0f * (qx * qy - w * qz);
  f.m[2] = 2.0f * (qx * qz + w * qy);
  f.m[3] = 2.0f * (qx * qy + w * qz);
  f.m[4] = 1.0f - 2.0f * (qx * qx + qz * qz);
  f.m[5] = 2.0f * (qy * qz - w * qx);
  f.m[6] = 2.0f * (qx * qz - w * qy);
  f.m[7] = 2.0f * (qy * qz + w * qx);
  f.m[8] = 1.0f - 2.0f * (qx * qx + qy * qy);
  return f;
}

// world -> object coordinates (models/scenes.py::_object_space_c)
template <class Opt, class T, class S, class Tr, class Ro>
__device__ __forceinline__ void object_space(const ParamScene& s, const ObjectParams<S, Tr, Ro>& p,
                                             const Frame<Ro>& f, const T x[3], T o[3]) {
  T v[3] = {x[0], x[1], x[2]};
  if (Opt::translation(s)) {
#pragma unroll
    for (int a = 0; a < 3; ++a) v[a] = v[a] - p.translation[a];
  }
  if (Opt::rotation(s)) {
    o[0] = (f.m[0] * v[0] + f.m[3] * v[1]) + f.m[6] * v[2];
    o[1] = (f.m[1] * v[0] + f.m[4] * v[1]) + f.m[7] * v[2];
    o[2] = (f.m[2] * v[0] + f.m[5] * v[1]) + f.m[8] * v[2];
  } else {
#pragma unroll
    for (int a = 0; a < 3; ++a) o[a] = v[a];
  }
}

// forward values of the scene that its gradient reads back
template <class T, class S, class Ro>
struct SceneFwd {
  Frame<Ro> rot;
  T o[3];       // object-space point
  S lo[3];      // the skeleton's low corner
  SkeletonFwd<T> skel_f;
  T skel, sph, sroot, obj;
  SkeletonFwd<T> frame_f;
  T frame;
  T d;
};

__device__ __forceinline__ void frame_box(const ParamScene& s, float lo[3], float size[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    size[a] = s.frame_size;
    lo[a] = 0.0f - s.frame_size / 2.0f;
  }
}

// the object alone (the skeleton and the sphere, smoothly joined)
template <class Opt, class T, class S, class Tr, class Ro>
__device__ __forceinline__ T object_fwd(const ParamScene& s, const ObjectParams<S, Tr, Ro>& p,
                                        const T x[3], SceneFwd<T, S, Ro>& f) {
  if (Opt::rotation(s)) f.rot = rotation(p.rotation);
  object_space<Opt>(s, p, f.rot, x, f.o);
#pragma unroll
  for (int a = 0; a < 3; ++a) f.lo[a] = p.center[a] - p.size[a] / 2.0f;
  f.skel = skeleton_fwd(f.o, f.lo, p.size, p.line_width, s.reference_compat, f.skel_f);
  f.sroot = vsqrt((f.o[0] * f.o[0] + f.o[1] * f.o[1]) + f.o[2] * f.o[2]);
  f.sph = f.sroot - p.radius;
  // smooth_min(skel, sph, k) (sdf/primitives.py::smooth_min)
  const T h = vmax(p.k - vabs(f.skel - f.sph), 0.0f) / p.k;
  f.obj = vmin(f.skel, f.sph) - ((h * h) * h * p.k) * static_cast<float>(1.0 / 6.0);
  return f.obj;
}

// the bounding-box wireframe
template <class T>
__device__ __forceinline__ T frame_fwd(const ParamScene& s, const T x[3], SkeletonFwd<T>& f) {
  float flo[3], fsize[3];
  frame_box(s, flo, fsize);
  return skeleton_fwd(x, flo, fsize, s.frame_line_width, s.reference_compat, f);
}

template <class Opt = AnyParts, class T, class S, class Tr, class Ro>
__device__ __forceinline__ T scene_fwd(const ParamScene& s, const ObjectParams<S, Tr, Ro>& p,
                                       const T x[3], SceneFwd<T, S, Ro>& f) {
  f.d = object_fwd<Opt>(s, p, x, f);
  if (Opt::frame(s)) {
    f.frame = frame_fwd(s, x, f.frame_f);
    f.d = vmin(f.obj, f.frame);
  }
  return f.d;
}

template <class Opt = AnyParts, class T, class S, class Tr, class Ro>
__device__ __forceinline__ T scene_value(const ParamScene& s, const ObjectParams<S, Tr, Ro>& p,
                                         const T x[3]) {
  SceneFwd<T, S, Ro> f;
  return scene_fwd<Opt>(s, p, x, f);
}

// ---------------------------------------------------------------------------
// the march's form of the scene (K4 and K5's march launch), in float32
// ---------------------------------------------------------------------------

// What every step of the march reads and no step changes: the parameters
// and what object_fwd and frame_fwd derive from them on every call (the
// rotation's frame, the skeleton's low corner, the perpendicular sizes that
// reference_compat picks, the wireframe's box), computed once before the
// loop in the same float32 operations, so each keeps its bits. The
// translation is 0 where the object has none: x - 0 is x, bit for bit.
// The march keeps this form of its own: object_fwd split into these
// invariants and a per-point part, with the same zero-dividend branch,
// gave a loop of the same length but K4 up to 8% and K5 up to 5% slower,
// and moved the registers of K5's tangent launches (PERF.md).
struct MarchScene {
  float translation[3];
  bool rotate;
  Frame<float> rot;
  float lo[3], size[3], perp[3];  // the skeleton's box; perp[d] = perp_size(size, d, compat)
  float line_width, radius, k;
  float k_sign;  // 1 or -1 for a k of that sign, 0 for a k that is 0 or NaN
  bool frame;
  float frame_lo, frame_size, frame_line_width;  // the wireframe's box is a cube
};

__device__ __forceinline__ MarchScene march_scene(const ParamScene& s) {
  const ObjectParams<float> p = load_params<float>(s);
  MarchScene m;
  const bool translate = AnyParts::translation(s);
  m.rotate = AnyParts::rotation(s);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    m.translation[a] = translate ? p.translation[a] : 0.0f;
    m.size[a] = p.size[a];
    m.lo[a] = p.center[a] - p.size[a] / 2.0f;
  }
  if (m.rotate) m.rot = rotation(p.rotation);
#pragma unroll
  for (int d = 0; d < 3; ++d) m.perp[d] = perp_size(p.size, d, s.reference_compat);
  m.line_width = p.line_width;
  m.radius = p.radius;
  m.k = p.k;
  m.k_sign = p.k > 0.0f ? 1.0f : (p.k < 0.0f ? -1.0f : 0.0f);
  m.frame = AnyParts::frame(s);
  float flo[3], fsize[3];
  frame_box(s, flo, fsize);
  m.frame_lo = flo[0];
  m.frame_size = fsize[0];
  m.frame_line_width = s.frame_line_width;
  return m;
}

// skeleton_fwd's value from per-axis boxes, perp[d] the perpendicular size
// of axis d
__device__ __forceinline__ float skeleton_value(const float c[3], const float lo[3],
                                                const float size[3], const float perp[3],
                                                float line_width) {
  float best = 0.0f;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int a1 = (d + 1) % 3, a2 = (d + 2) % 3;
    const float r = c[d] - lo[d];
    const float t = fminf(fmaxf(r, 0.0f), size[d]);
    const float e = r - t;
    const float o1 = c[a1] - lo[a1];
    const float o1b = o1 - perp[d];
    const float o2 = c[a2] - lo[a2];
    const float o2b = o2 - size[a2];
    const float d2 = (e * e + fminf(o1 * o1, o1b * o1b)) + fminf(o2 * o2, o2b * o2b);
    best = d == 0 ? d2 : fminf(best, d2);
  }
  return sqrtf(best) - line_width;
}

// scene_value in float32 from the march's form: object_fwd, then the union
// with the wireframe, operation for operation
__device__ __forceinline__ float march_value(const MarchScene& m, const float x[3]) {
  float o[3];
  const float v[3] = {x[0] - m.translation[0], x[1] - m.translation[1], x[2] - m.translation[2]};
  if (m.rotate) {
    o[0] = (m.rot.m[0] * v[0] + m.rot.m[3] * v[1]) + m.rot.m[6] * v[2];
    o[1] = (m.rot.m[1] * v[0] + m.rot.m[4] * v[1]) + m.rot.m[7] * v[2];
    o[2] = (m.rot.m[2] * v[0] + m.rot.m[5] * v[1]) + m.rot.m[8] * v[2];
  } else {
#pragma unroll
    for (int a = 0; a < 3; ++a) o[a] = v[a];
  }
  const float skel = skeleton_value(o, m.lo, m.size, m.perp, m.line_width);
  const float sph = sqrtf((o[0] * o[0] + o[1] * o[1]) + o[2] * o[2]) - m.radius;
  // smooth_min's h = max(k - |skel - sph|, 0) / k. Away from the blend the
  // dividend is a zero, and the quotient the zero of the product of the two
  // signs: it is taken as that, since the division's range check sends a
  // zero dividend down its slow path
  const float num = fmaxf(m.k - fabsf(skel - sph), 0.0f);
  float h;
  if (num == 0.0f && m.k_sign != 0.0f) {
    h = num * m.k_sign;
  } else {
    h = num / m.k;
  }
  const float obj = fminf(skel, sph) - ((h * h) * h * m.k) * static_cast<float>(1.0 / 6.0);
  if (!m.frame) return obj;
  const float flo[3] = {m.frame_lo, m.frame_lo, m.frame_lo};
  const float fsize[3] = {m.frame_size, m.frame_size, m.frame_size};
  return fminf(obj, skeleton_value(x, flo, fsize, fsize, m.frame_line_width));
}

// the wireframe alone, march_value's last term: the far scene of the
// near/far split
__device__ __forceinline__ float far_march_value(const MarchScene& m, const float x[3]) {
  const float flo[3] = {m.frame_lo, m.frame_lo, m.frame_lo};
  const float fsize[3] = {m.frame_size, m.frame_size, m.frame_size};
  return skeleton_value(x, flo, fsize, fsize, m.frame_line_width);
}

// the parameters' values
template <class S, class Tr, class Ro>
__device__ __forceinline__ ObjectParams<float> values_of(const ObjectParams<S, Tr, Ro>& p) {
  ObjectParams<float> v;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    v.center[a] = value_of(p.center[a]);
    v.size[a] = value_of(p.size[a]);
    v.translation[a] = value_of(p.translation[a]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) v.rotation[a] = value_of(p.rotation[a]);
  v.line_width = value_of(p.line_width);
  v.radius = value_of(p.radius);
  v.k = value_of(p.k);
  return v;
}

// The gradient of the SDF with respect to x, by reverse mode with a
// cotangent of 1, added to g. With the wireframe, its part comes first:
// the min's tie weights need only the object's value, which a plain float
// pass gives (the same operations as the value of T's), so the wireframe's
// forward state is dead before the object's is built, and its gradient is
// added to the object's at the end.
template <class Opt = AnyParts, class T, class S, class Tr, class Ro>
__device__ __forceinline__ void scene_value_grad(const ParamScene& s,
                                                 const ObjectParams<S, Tr, Ro>& p, const T x[3],
                                                 T g[3]) {
  float ct_obj = 1.0f;
  T gf[3];
  if (Opt::frame(s)) {
    SceneFwd<float, float, float> fv;
    const float xv[3] = {value_of(x[0]), value_of(x[1]), value_of(x[2])};
    const float obj = object_fwd<Opt>(s, values_of(p), xv, fv);
    SkeletonFwd<T> ff;
    const T frame = frame_fwd(s, x, ff);
    const float d = fminf(obj, value_of(frame));
    ct_obj = tie_weight(obj, d, value_of(frame));
    float flo[3], fsize[3];
    frame_box(s, flo, fsize);
#pragma unroll
    for (int a = 0; a < 3; ++a) gf[a] = Scalar<T>::constant(0.0f);
    skeleton_bwd(x, flo, fsize, s.reference_compat, ff,
                 Scalar<T>::constant(tie_weight(value_of(frame), d, obj)), gf);
  }

  SceneFwd<T, S, Ro> f;
  object_fwd<Opt>(s, p, x, f);
  // smooth minimum, backward: delta = skel - sph, u = k - |delta|,
  // hm = max(u, 0), h = hm / k, obj = min(skel, sph) - h^3 k / 6
  const T delta = f.skel - f.sph;
  const T u = p.k - vabs(delta);
  const T hm = vmax(u, 0.0f);
  const T h = hm / p.k;
  const auto ct_h3 = (p.k * static_cast<float>(1.0 / 6.0)) * -ct_obj;  // an S
  const T ct_h2 = ct_h3 * h;
  const T ct_h = (h * h) * ct_h3 + (ct_h2 * h + h * ct_h2);
  const T ct_u = (ct_h / p.k) * tie_weight(value_of(u), value_of(hm), 0.0f);
  const T ct_delta = value_of(delta) >= 0.0f ? -ct_u : ct_u;  // jax: d|x| = +1 at 0
  const float m = fminf(value_of(f.skel), value_of(f.sph));
  const T ct_skel = ct_delta + ct_obj * tie_weight(value_of(f.skel), m, value_of(f.sph));
  const T ct_sph = ct_obj * tie_weight(value_of(f.sph), m, value_of(f.skel)) - ct_delta;
  const T ct_s2 = ct_sph * (0.5f / f.sroot);

  T c[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const T sa = ct_s2 * f.o[a];
    c[a] = sa + sa;
  }
  skeleton_bwd(f.o, f.lo, p.size, s.reference_compat, f.skel_f, ct_skel, c);
  if (Opt::rotation(s)) {
    Frame<Ro> rot = f.rot;
    if constexpr (!std::is_same<Ro, float>::value) {
      // with the rotation's tangents, its matrix again from a copy of the
      // quaternion the compiler cannot see through, so that the forward's
      // 9 duals are not held through the backward
      Ro q[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) q[a] = opaque(p.rotation[a]);
      rot = rotation(q);
    }
    const Ro* m9 = rot.m;
    g[0] = (m9[0] * c[0] + m9[1] * c[1]) + m9[2] * c[2];
    g[1] = (m9[3] * c[0] + m9[4] * c[1]) + m9[5] * c[2];
    g[2] = (m9[6] * c[0] + m9[7] * c[1]) + m9[8] * c[2];
  } else {
#pragma unroll
    for (int a = 0; a < 3; ++a) g[a] = c[a];
  }
  if (Opt::frame(s)) {
#pragma unroll
    for (int a = 0; a < 3; ++a) g[a] = g[a] + gf[a];
  }
}
