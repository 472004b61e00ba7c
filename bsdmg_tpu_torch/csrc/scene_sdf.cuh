// The scene SDF of the built-in scenes on the device, shared by K1, K2, K3
// (render_kernel.cu), K6 (mc_kernel.cu) and K7 (project_kernel.cu).
//
// The reference scenes take the JAX compiler's factorised capsule set
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
// The scene's structure is a template parameter. Box<Frame, Transform> is a
// reference scene: every capsule set is a box skeleton of 3 groups along x,
// y and z, each with 2 perpendicular coordinates per other axis, and the
// wireframe and the object transform are there or not. So the SDF is
// straight-line code with every axis and count fixed; the descriptor's
// values stay runtime data in the by-value SceneDesc. Sphere, SolidBox and
// Mandelbulb are the other built-in scenes (csdf.py sphere_csdf, box_csdf
// and the mandelbulb of compile_scene_csdf), Wrapped<Box<false, false>>
// the reference object on a lattice (its wrapped_object), and
// Wrapped<Box<false, true>> the same object moved by its object transform
// inside each cell (the lattice point wrapped first, then the transform, as
// bsdmg_tpu/models/scenes.py:225-245 orders them; cli animate --motion
// moves it), Composed and ComposedLarge a composed scene's node program
// in its small and large tier (composed.cuh), Far the wireframe that K1
// and K2 march where a patch of rays misses the near box, NearScene the
// render scene as they march it in the other patches. csdf.py::
// kernel_structure picks the structure from the descriptor (and raises for
// a descriptor that matches none); with_structure turns its index into the
// template on the host. GridScene<Form> is a mesh asset's baked grid
// (grid_sdf.cuh grid_scene), which only the mesh kernels K6 and K7 take:
// with_mesh_structure adds it to with_structure's, so K1, K2 and K3 are
// not built for it (a grid renders through grid_kernel.cu).
//
// The sphere's and the box's gradients are reverse mode with JAX's tie
// rules, as the reference scenes' are; the mandelbulb's is forward mode,
// Dual<3> (dual.cuh) through its loop, which a point leaves at its escape.
// The twins are csdf.py's _sphere_value_and_grad, _box_value_and_grad and
// _mandelbulb_value_and_grad.
//
// Numerics: the library is built with -fmad=false and without fast math,
// and every sum runs in the twin's order, so each function equals its twin
// bit for bit; but the mandelbulb's acosf, atan2f, powf, sincosf and logf,
// whose libdevice code differs from torch's in the last bits.

#pragma once

#include <math_constants.h>

#include <type_traits>

#include "common.cuh"
#include "grid_sdf.cuh"
#include "mandelbulb.cuh"

#define BSDMG_GROUPS 3  // parallel-edge groups of a box skeleton
#define BSDMG_GROUP_VALUES 2  // perpendicular coordinates per other axis

// Segments of one direction, start and length whose perpendicular
// coordinates form the cross product v1 x v2. v1 lies on the lower, v2 on
// the higher of the two other axes, each ascending. Group g of a set runs
// along axis g.
struct CapsuleGroup {
  float a0;
  float length;
  float v1[BSDMG_GROUP_VALUES];
  float v2[BSDMG_GROUP_VALUES];
};

// Axis-aligned capsules of one radius, as groups along x, y and z.
struct CapsuleSet {
  float radius;
  CapsuleGroup groups[BSDMG_GROUPS];
};

// Mirrors _SceneDescC in ops/cuda/render_kernel.py field by field. The mesh
// kernels read the scene fields only.
struct SceneDesc {
  CapsuleSet object;  // box skeleton of the CSG object
  CapsuleSet frame;   // bounding-box wireframe (read when the structure has one)
  int structure;      // the Box<Frame, Transform> the host launches: 2 * Frame + Transform
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
  float box_half[3];  // SolidBox: the half extents
  float scale;        // Mandelbulb: float32(scale * 0.4), points divided, distance multiplied
  float cell;         // Wrapped: the lattice period
  float half_cell;    // float32(cell / 2)
  // Composed: the node program in device memory, program_length
  // instructions of BSDMG_WORDS words (csdf.py program_words), then the
  // walk_words words of its forward walk (csdf.py walk_words), which each
  // block stages in shared memory (stage_walk); the descriptor on the host
  // owns the buffer
  const int* program;
  int program_length;
  int walk_words;
  // Grid: a mesh asset's baked (r, r, r) table in device memory, C order,
  // its box, and the offset added to each point first (0 for none); the
  // descriptor on the host keeps the table alive
  const float* grid_table;
  GridBox grid;
  float grid_offset[3];
  // ComposedLarge: the scratch buffer of the interpreter's stacks, sized by
  // the wrapper for scratch_threads threads (composed.cuh), and the
  // program's most values on the stack and nested frames at once
  float* scratch;
  int scratch_threads;
  int program_depth;
  int program_frames;
  // the near/far split of K1 and K2 (split != 0): the far scene, a
  // wireframe alone (Far), and the near component's bounds, as lo, hi,
  // their cull sphere and slack
  int split;
  CapsuleSet far;
  float near_lo[3];
  float near_hi[3];
  float near_center[3];
  float near_radius;
  float near_slack;
  // the planes of the wireframe's box (SceneDesc::frame), per axis the two
  // values that every capsule group's perpendicular coordinates take
  // (render_kernel.py frame_planes checks it), for NearScene's bound
  float frame_lo[3];
  float frame_hi[3];
};

enum SceneKind {
  KIND_REFERENCE,
  KIND_SPHERE,
  KIND_SOLID_BOX,
  KIND_MANDELBULB,
  KIND_WRAPPED,
  KIND_COMPOSED,
  KIND_GRID,
  KIND_FAR,
  KIND_NEAR
};

// The compile-time structure of a reference scene: with the wireframe or
// not, with the object transform or not. `unrolled` is whether the fd4
// stencil (project.cuh) unrolls its 12 SDFs, whose shifts share terms.
template <bool Frame, bool Transform>
struct Box {
  static constexpr SceneKind kind = KIND_REFERENCE;
  static constexpr bool frame = Frame;
  static constexpr bool transform = Transform;
  static constexpr bool unrolled = true;
};

struct Sphere {
  static constexpr SceneKind kind = KIND_SPHERE;
  static constexpr bool unrolled = true;
};

// the box scene (Box names the reference scenes' wireframe structure)
struct SolidBox {
  static constexpr SceneKind kind = KIND_SOLID_BOX;
  static constexpr bool unrolled = true;
};

// its 25-iteration loop shares nothing between the stencil's points, so
// the stencil stays rolled around one copy of it
struct Mandelbulb {
  static constexpr SceneKind kind = KIND_MANDELBULB;
  static constexpr bool unrolled = false;
};

// the scene Inner on a cubic lattice of period cell
template <class Inner>
struct Wrapped {
  static constexpr SceneKind kind = KIND_WRAPPED;
  static constexpr bool unrolled = Inner::unrolled;
  using inner = Inner;
};

// a composed scene: the node program is data, which composed.cuh's
// interpreter reads instruction by instruction; the stencil stays rolled
// around it (K3's and K7's walk an axis's four points at once: project.cuh
// fd4_grad). Composed is the small tier (the forward walk's words in the
// block's shared memory and its top of the stack in a register, the taped
// walk's stacks in local arrays, programs within program.cuh's caps of
// each walk), ComposedLarge the large tier (stacks in SceneDesc::scratch,
// any program); csdf.py::large_tier picks one per walk
struct Composed {
  static constexpr SceneKind kind = KIND_COMPOSED;
  static constexpr bool unrolled = false;
  static constexpr bool large = false;
};
struct ComposedLarge {
  static constexpr SceneKind kind = KIND_COMPOSED;
  static constexpr bool unrolled = false;
  static constexpr bool large = true;
};
// the far scene of K1's and K2's near/far split: the wireframe SceneDesc::
// far alone (csdf.py::compile_scene_split), which a patch of rays that all
// miss the near box marches; not a scene of its own, so with_structure
// does not name it
struct Far {
  static constexpr SceneKind kind = KIND_FAR;
  static constexpr bool unrolled = true;
};

// the reference render scene Box<true, Transform> as the near/far split's
// K1 and K2 march and shade it in a near patch: the same value bit for bit,
// its wireframe's term left out where a bound proves it cannot be the
// smaller (near_sdf); not a scene of its own, so with_structure does not
// name it
template <bool Transform>
struct NearScene {
  static constexpr SceneKind kind = KIND_NEAR;
  static constexpr bool frame = true;
  static constexpr bool transform = Transform;
  static constexpr bool unrolled = true;
};

// a mesh asset's grid in the form Form (grid_sdf.cuh GridForm): eight
// gathers share nothing between the stencil's points, so it stays rolled
template <int Form>
struct GridScene {
  static constexpr SceneKind kind = KIND_GRID;
  static constexpr int form = Form;
  static constexpr bool unrolled = false;
};

// Calls f(S{}) for the structure index csdf.py::kernel_structure gives:
// 2 * frame + transform for Box, then Sphere, SolidBox, Mandelbulb, the
// wrapped reference object, Composed, (11) the wrapped reference object
// moved by its object transform and (12) ComposedLarge; false for an index
// that names none.
// Indices 9 and 10 are the grid's (with_mesh_structure).
template <class F>
inline bool with_structure(int structure, F&& f) {
  switch (structure) {
    case 0: f(Box<false, false>{}); return true;
    case 1: f(Box<false, true>{}); return true;
    case 2: f(Box<true, false>{}); return true;
    case 3: f(Box<true, true>{}); return true;
    case 4: f(Sphere{}); return true;
    case 5: f(SolidBox{}); return true;
    case 6: f(Mandelbulb{}); return true;
    case 7: f(Wrapped<Box<false, false>>{}); return true;
    case 8: f(Composed{}); return true;
    case 11: f(Wrapped<Box<false, true>>{}); return true;
    case 12: f(ComposedLarge{}); return true;
    default: return false;
  }
}

// kernel_structure's index of ComposedLarge
#define BSDMG_COMPOSED_LARGE 12

// whether a launch of `threads` threads may run the scene: any but the
// large tier's, whose stacks need the scratch buffer to hold every thread
inline bool scratch_fits(const SceneDesc& s, long long threads) {
  return s.structure != BSDMG_COMPOSED_LARGE ||
         (s.scratch != nullptr && threads <= s.scratch_threads);
}

// with_structure's structures and the grid's two forms (csdf.py
// GRID_FORMS): the dispatch of the mesh kernels K6 and K7 alone
template <class F>
inline bool with_mesh_structure(int structure, F&& f) {
  switch (structure) {
    case 9: f(GridScene<GRID_LERP>{}); return true;
    case 10: f(GridScene<GRID_WEIGHTS>{}); return true;
    default: return with_structure(structure, f);
  }
}

// the axial coordinate of axis A and the lower and higher other ones
template <int A>
__device__ __forceinline__ void group_coords(float x, float y, float z, float& a, float& c1,
                                             float& c2) {
  a = A == 0 ? x : (A == 1 ? y : z);
  c1 = A == 0 ? y : x;
  c2 = A == 2 ? y : z;
}

template <int A>
__device__ __forceinline__ void add_to_axis(float v, float& gx, float& gy, float& gz) {
  if (A == 0) gx += v;
  else if (A == 1) gy += v;
  else gz += v;
}

// ---------------------------------------------------------------------------
// value
// ---------------------------------------------------------------------------

// squared distance to group A: (axial + min(V1)) + min(V2)
template <int A>
__device__ __forceinline__ float group_d2(const CapsuleGroup& g, float x, float y, float z) {
  float a, c1, c2;
  group_coords<A>(x, y, z, a, c1, c2);
  const float r = a - g.a0;
  const float e = r - fminf(fmaxf(r, 0.0f), g.length);
  const float d10 = c1 - g.v1[0], d11 = c1 - g.v1[1];
  const float d20 = c2 - g.v2[0], d21 = c2 - g.v2[1];
  return (e * e + fminf(d10 * d10, d11 * d11)) + fminf(d20 * d20, d21 * d21);
}

// the minimum over the groups of their squared distances
__device__ __forceinline__ float capsule_set_d2(const CapsuleSet& c, float x, float y, float z) {
  return fminf(fminf(group_d2<0>(c.groups[0], x, y, z), group_d2<1>(c.groups[1], x, y, z)),
               group_d2<2>(c.groups[2], x, y, z));
}

// world -> object coordinates
template <class S>
__device__ __forceinline__ void object_coords(const SceneDesc& s, float x, float y, float z,
                                              float& ox, float& oy, float& oz) {
  if (S::transform) {
    const float tx = x - s.translation[0];
    const float ty = y - s.translation[1];
    const float tz = z - s.translation[2];
    ox = s.inv_rotation[0] * tx + s.inv_rotation[1] * ty + s.inv_rotation[2] * tz;
    oy = s.inv_rotation[3] * tx + s.inv_rotation[4] * ty + s.inv_rotation[5] * tz;
    oz = s.inv_rotation[6] * tx + s.inv_rotation[7] * ty + s.inv_rotation[8] * tz;
  } else {
    ox = x;
    oy = y;
    oz = z;
  }
}

// ops/pallas/csdf.py::reference_render_scene_csdf
template <class S>
__device__ __forceinline__ float reference_sdf(const SceneDesc& s, float x, float y, float z) {
  float ox, oy, oz;
  object_coords<S>(s, x, y, z, ox, oy, oz);
  const float skel = sqrtf(capsule_set_d2(s.object, ox, oy, oz)) - s.object.radius;
  const float sph = sqrtf(ox * ox + oy * oy + oz * oz) - s.sphere_radius;
  const float h = fmaxf(s.smooth_k - fabsf(skel - sph), 0.0f) * s.inv_k;
  float d = fminf(skel, sph) - h * h * h * s.k_6;
  if (S::frame) d = fminf(d, sqrtf(capsule_set_d2(s.frame, x, y, z)) - s.frame.radius);
  return d;
}

// (1 - 2^-20): m * kFrameShrink rounds to at most the float below m
constexpr float kFrameShrink = 0.99999904632568359375f;

// Whether the wireframe's term of reference_sdf<Box<true, T>> at (x, y, z),
// fl(sqrtf(D) - radius) with D = capsule_set_d2(s.frame, ...), exceeds the
// object's value d, so that fminf(d, term) is d bit for bit and NearScene
// may leave the term out. The proof, for float inputs under round to
// nearest (no FMA contraction is needed, none is assumed):
//  * every group's perpendicular values on axis b are the box's planes
//    frame_lo[b], frame_hi[b] (the host checks it), so each of its
//    differences c - v is fl(c - lo) or fl(c - hi), and |c - v| >= a_b,
//    a_b = fminf(|fl(c_b - lo_b)|, |fl(c_b - hi_b)|) computed here;
//  * group_d2 = fl(fl(e*e + M1) + M2) with M1, M2 >= 0 floats is >= M1
//    and >= M2 (rounding is monotone and e*e >= 0), and M_k >= fl(a^2) for
//    its axis; the groups along x, y, z pair the axes (y, z), (x, z),
//    (x, y), so D = their minimum >= fl(m^2), m the median of a_x, a_y,
//    a_z (exact: a min and a max of floats);
//  * for m >= 1e-6 (m^2 normal) sqrtf(fl(m^2)) >= pred(m), the float below
//    m; fl(m * kFrameShrink) <= pred(m), since m 2^-20 is at least 8 ulps;
//    so sqrtf(D) >= fl(m * kFrameShrink) and, rounding being monotone,
//    term >= fl(fl(m * kFrameShrink) - radius) =: t;
//  * t > d gives term > d. A NaN coordinate makes m NaN (vminn, vmaxn)
//    and a NaN d fails t > d: both keep the term.
__device__ __forceinline__ bool frame_beyond(const SceneDesc& s, float x, float y, float z,
                                             float d) {
  const float ax = fminf(fabsf(x - s.frame_lo[0]), fabsf(x - s.frame_hi[0]));
  const float ay = fminf(fabsf(y - s.frame_lo[1]), fabsf(y - s.frame_hi[1]));
  const float az = fminf(fabsf(z - s.frame_lo[2]), fabsf(z - s.frame_hi[2]));
  const float m = vmaxn(vminn(ax, ay), vminn(vmaxn(ax, ay), az));
  return m > 1e-6f && m * kFrameShrink - s.frame.radius > d;
}

// NearScene: reference_sdf<Box<true, T>>'s value, the wireframe's term
// taken only where frame_beyond does not prove it larger. Inside the
// frame's box, around the object, that term is rarely the smaller, and it
// is about a third of a step's work.
template <class S>
__device__ __forceinline__ float near_sdf(const SceneDesc& s, float x, float y, float z) {
  const float d = reference_sdf<Box<false, S::transform>>(s, x, y, z);
  if (frame_beyond(s, x, y, z, d)) return d;
  return fminf(d, sqrtf(capsule_set_d2(s.frame, x, y, z)) - s.frame.radius);
}

// ---------------------------------------------------------------------------
// gradient
// ---------------------------------------------------------------------------

// the squared distances of a set's groups and their running minimum
struct CapsuleFwd {
  float d2[BSDMG_GROUPS];
  float best[BSDMG_GROUPS];
  float root;  // sqrt of the overall minimum
};

__device__ __forceinline__ float capsule_set_fwd(const CapsuleSet& c, float x, float y, float z,
                                                 CapsuleFwd& f) {
  f.d2[0] = group_d2<0>(c.groups[0], x, y, z);
  f.d2[1] = group_d2<1>(c.groups[1], x, y, z);
  f.d2[2] = group_d2<2>(c.groups[2], x, y, z);
  f.best[0] = f.d2[0];
  f.best[1] = fminf(f.best[0], f.d2[1]);
  f.best[2] = fminf(f.best[1], f.d2[2]);
  f.root = sqrtf(f.best[2]);
  return f.root - c.radius;
}

// the two squares of one perpendicular slot, backward: the cotangent of
// coordinate c given the cotangent ct of min((c - v0)^2, (c - v1)^2)
__device__ __forceinline__ float slot_bwd(float c, const float* v, float ct) {
  const float d0 = c - v[0];
  const float s0 = d0 * d0;
  const float d1 = c - v[1];
  const float s1 = d1 * d1;
  const float m = fminf(s0, s1);
  const float ct0 = ct * tie_weight(s0, m, s1);
  const float ct1 = ct * tie_weight(s1, m, s0);
  // d(d*d) = ct*d + d*ct
  const float a0 = ct0 * d0;
  const float a1 = ct1 * d1;
  return (a0 + a0) + (a1 + a1);
}

// group A, backward, with cotangent ct of its squared distance
template <int A>
__device__ __forceinline__ void group_bwd(const CapsuleGroup& g, float x, float y, float z, float ct,
                                          float& gx, float& gy, float& gz) {
  float a, c1, c2;
  group_coords<A>(x, y, z, a, c1, c2);
  const float r = a - g.a0;
  const float mx = fmaxf(r, 0.0f);  // jnp.clip: maximum(0, r), then minimum(length, .)
  const float t = fminf(mx, g.length);
  const float e = r - t;
  const float ce = ct * e;
  const float ct_e = ce + ce;
  const float ct_t = -ct_e;
  const float ct_mx = ct_t * tie_weight(mx, t, g.length);
  add_to_axis<A>(ct_e + ct_mx * tie_weight(r, mx, 0.0f), gx, gy, gz);
  add_to_axis<A == 0 ? 1 : 0>(slot_bwd(c1, g.v1, ct), gx, gy, gz);
  add_to_axis<A == 2 ? 1 : 2>(slot_bwd(c2, g.v2, ct), gx, gy, gz);
}

// adds ct * d(capsule set)/d(x, y, z) to (gx, gy, gz)
__device__ __forceinline__ void capsule_set_bwd(const CapsuleSet& c, float x, float y, float z,
                                                const CapsuleFwd& f, float ct, float& gx,
                                                float& gy, float& gz) {
  float w = ct * (0.5f / f.root);  // d sqrt(b) = (0.5 / sqrt(b)) db
  const float ct2 = w * tie_weight(f.d2[2], f.best[2], f.best[1]);
  w = w * tie_weight(f.best[1], f.best[2], f.d2[2]);
  const float ct1 = w * tie_weight(f.d2[1], f.best[1], f.best[0]);
  w = w * tie_weight(f.best[0], f.best[1], f.d2[1]);
  group_bwd<0>(c.groups[0], x, y, z, w, gx, gy, gz);
  group_bwd<1>(c.groups[1], x, y, z, ct1, gx, gy, gz);
  group_bwd<2>(c.groups[2], x, y, z, ct2, gx, gy, gz);
}

// value and gradient of reference_sdf (the value equals reference_sdf's bit
// for bit)
template <class S>
__device__ __forceinline__ void reference_sdf_grad(const SceneDesc& s, float x, float y, float z,
                                                   float& d, float& gx, float& gy, float& gz) {
  float ox, oy, oz;
  object_coords<S>(s, x, y, z, ox, oy, oz);
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
  if (S::frame) {
    frame = capsule_set_fwd(s.frame, x, y, z, ff);
    d = fminf(obj, frame);
  }

  // backward, cotangent 1
  const float ct_obj = S::frame ? tie_weight(obj, d, frame) : 1.0f;
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
  if (S::transform) {
    const float* m9 = s.inv_rotation;
    gx = (m9[0] * cx + m9[3] * cy) + m9[6] * cz;
    gy = (m9[1] * cx + m9[4] * cy) + m9[7] * cz;
    gz = (m9[2] * cx + m9[5] * cy) + m9[8] * cz;
  } else {
    gx = cx;
    gy = cy;
    gz = cz;
  }
  if (S::frame) capsule_set_bwd(s.frame, x, y, z, ff, tie_weight(frame, d, obj), gx, gy, gz);
}

// ---------------------------------------------------------------------------
// the sphere, the box, the mandelbulb and the wrap
// ---------------------------------------------------------------------------

// csdf.py::sphere_csdf at the origin; reverse mode: sqrt's weight 0.5 /
// root, each square's cotangent ct*x + x*ct
__device__ __forceinline__ float sphere_sdf(const SceneDesc& s, float x, float y, float z) {
  return sqrtf((x * x + y * y) + z * z) - s.sphere_radius;
}

__device__ __forceinline__ void sphere_sdf_grad(const SceneDesc& s, float x, float y, float z,
                                                float& d, float& gx, float& gy, float& gz) {
  const float root = sqrtf((x * x + y * y) + z * z);
  d = root - s.sphere_radius;
  const float w = 0.5f / root;
  const float sx = w * x, sy = w * y, sz = w * z;
  gx = sx + sx;
  gy = sy + sy;
  gz = sz + sz;
}

// sdf/primitives.py::sd_box_c at the origin; its min and max propagate a
// NaN (dual.cuh vmaxn), as the twin's and JAX's do: the box's gradient is
// NaN inside it, and the mesh kernels' Newton steps meet the NaN points
__device__ __forceinline__ float solid_box_sdf(const SceneDesc& s, float x, float y, float z) {
  const float qx = fabsf(x) - s.box_half[0];
  const float qy = fabsf(y) - s.box_half[1];
  const float qz = fabsf(z) - s.box_half[2];
  const float ox = vmaxn(qx, 0.0f), oy = vmaxn(qy, 0.0f), oz = vmaxn(qz, 0.0f);
  return sqrtf((ox * ox + oy * oy) + oz * oz) + vminn(vmaxn(qx, vmaxn(qy, qz)), 0.0f);
}

// one axis of the box's backward: the cotangent of coordinate c from the
// outside's term (weight w of its square) and the inside's (ct_in)
__device__ __forceinline__ float box_axis_bwd(float c, float q, float o, float w, float ct_in) {
  const float sq = w * o;
  const float ct_q = (sq + sq) * tie_weight(q, o, 0.0f) + ct_in;
  return c >= 0.0f ? ct_q : -ct_q;  // jax: d|x| = +1 at 0
}

// reverse mode with JAX's tie rules; inside the box the outside distance
// is 0 and its weight 0.5 / 0 meets a zero: NaN, as JAX's
__device__ __forceinline__ void solid_box_sdf_grad(const SceneDesc& s, float x, float y, float z,
                                                   float& d, float& gx, float& gy, float& gz) {
  const float qx = fabsf(x) - s.box_half[0];
  const float qy = fabsf(y) - s.box_half[1];
  const float qz = fabsf(z) - s.box_half[2];
  const float ox = vmaxn(qx, 0.0f), oy = vmaxn(qy, 0.0f), oz = vmaxn(qz, 0.0f);
  const float outside = sqrtf((ox * ox + oy * oy) + oz * oz);
  const float m2 = vmaxn(qy, qz);
  const float m3 = vmaxn(qx, m2);
  const float inside = vminn(m3, 0.0f);
  d = outside + inside;
  const float ct_m3 = tie_weight(m3, inside, 0.0f);
  const float ct_m2 = ct_m3 * tie_weight(m2, m3, qx);
  const float w = 0.5f / outside;
  gx = box_axis_bwd(x, qx, ox, w, ct_m3 * tie_weight(qx, m3, m2));
  gy = box_axis_bwd(y, qy, oy, w, ct_m2 * tie_weight(qy, m2, qz));
  gz = box_axis_bwd(z, qz, oz, w, ct_m2 * tie_weight(qz, m2, qy));
}

__device__ __forceinline__ float mandelbulb_sdf(const SceneDesc& s, float x, float y, float z) {
  return mandelbulb_de<float>(x / s.scale, y / s.scale, z / s.scale) * s.scale;
}

// forward mode: the point's coordinates seeded with the unit tangents
// divided by the scale
__device__ __forceinline__ void mandelbulb_sdf_grad(const SceneDesc& s, float x, float y, float z,
                                                    float& d, float& gx, float& gy, float& gz) {
  const float inv = 1.0f / s.scale;
  const Dual<3> px{x / s.scale, {inv, 0.0f, 0.0f}};
  const Dual<3> py{y / s.scale, {0.0f, inv, 0.0f}};
  const Dual<3> pz{z / s.scale, {0.0f, 0.0f, inv}};
  const Dual<3> de = mandelbulb_de(px, py, pz) * s.scale;
  d = de.v;
  gx = de.t[0];
  gy = de.t[1];
  gz = de.t[2];
}

// the wrap of signed_distance.cu:9-18, -half + jnp.mod(v + half, cell):
// fmod, plus the divisor where the remainder's sign differs (torch.remainder)
__device__ __forceinline__ float wrap_axis(float v, float cell, float half) {
  float m = fmodf(v + half, cell);
  if (m != 0.0f && ((cell < 0.0f) != (m < 0.0f))) m += cell;
  return -half + m;
}

__device__ __forceinline__ float wrap_coord(const SceneDesc& s, float v) {
  return wrap_axis(v, s.cell, s.half_cell);
}

#include "composed.cuh"

// The dynamic shared memory of a launch of structure S, in bytes: a
// Composed program's forward walk (stage_walk), none for any other; -1 for
// a program that a Composed kernel does not take (walk_fits; `taped` for
// K6 and K7, which walk the tape too), which the launch refuses.
template <class S>
inline long long scene_smem(const SceneDesc& s, bool taped) {
  if constexpr (std::is_same<S, Composed>::value) {
    return walk_fits(s, taped) ? static_cast<long long>(sizeof(int)) * s.walk_words : -1;
  } else {
    return 0;
  }
}

// the start of a kernel of structure S, which every thread of the block
// runs: a Composed program's forward walk into shared memory (stage_walk;
// `sync` false where a barrier of the kernel's own follows before the first
// walk)
template <class S>
__device__ __forceinline__ void stage_scene(const SceneDesc& s, bool sync = true) {
  if constexpr (std::is_same<S, Composed>::value) stage_walk(s, sync);
}

// ---------------------------------------------------------------------------
// the scene SDF of structure S, and its value and gradient
// ---------------------------------------------------------------------------

template <class S>
__device__ __forceinline__ float scene_sdf(const SceneDesc& s, float x, float y, float z) {
  if constexpr (S::kind == KIND_SPHERE) {
    return sphere_sdf(s, x, y, z);
  } else if constexpr (S::kind == KIND_SOLID_BOX) {
    return solid_box_sdf(s, x, y, z);
  } else if constexpr (S::kind == KIND_MANDELBULB) {
    return mandelbulb_sdf(s, x, y, z);
  } else if constexpr (S::kind == KIND_WRAPPED) {
    return scene_sdf<typename S::inner>(s, wrap_coord(s, x), wrap_coord(s, y), wrap_coord(s, z));
  } else if constexpr (S::kind == KIND_COMPOSED) {
    if constexpr (S::large) {
      return composed_sdf_large(s, x, y, z);
    } else {
      return composed_sdf(s, x, y, z);
    }
  } else if constexpr (S::kind == KIND_FAR) {
    return sqrtf(capsule_set_d2(s.far, x, y, z)) - s.far.radius;
  } else if constexpr (S::kind == KIND_NEAR) {
    return near_sdf<S>(s, x, y, z);
  } else if constexpr (S::kind == KIND_GRID) {
    float gx, gy, gz;
    return grid_scene<S::form, false>(s.grid_table, s.grid, s.grid_offset, x, y, z, gx, gy, gz);
  } else {
    return reference_sdf<S>(s, x, y, z);
  }
}

// the value (scene_sdf's bit for bit) and the gradient; a wrap passes the
// gradient unchanged
template <class S>
__device__ __forceinline__ void scene_sdf_grad(const SceneDesc& s, float x, float y, float z,
                                               float& d, float& gx, float& gy, float& gz) {
  if constexpr (S::kind == KIND_SPHERE) {
    sphere_sdf_grad(s, x, y, z, d, gx, gy, gz);
  } else if constexpr (S::kind == KIND_SOLID_BOX) {
    solid_box_sdf_grad(s, x, y, z, d, gx, gy, gz);
  } else if constexpr (S::kind == KIND_MANDELBULB) {
    mandelbulb_sdf_grad(s, x, y, z, d, gx, gy, gz);
  } else if constexpr (S::kind == KIND_WRAPPED) {
    scene_sdf_grad<typename S::inner>(s, wrap_coord(s, x), wrap_coord(s, y), wrap_coord(s, z), d,
                                      gx, gy, gz);
  } else if constexpr (S::kind == KIND_COMPOSED) {
    if constexpr (S::large) {
      composed_sdf_grad_large(s, x, y, z, d, gx, gy, gz);
    } else {
      composed_sdf_grad(s, x, y, z, d, gx, gy, gz);
    }
  } else if constexpr (S::kind == KIND_GRID) {
    d = grid_scene<S::form, true>(s.grid_table, s.grid, s.grid_offset, x, y, z, gx, gy, gz);
  } else {
    reference_sdf_grad<S>(s, x, y, z, d, gx, gy, gz);
  }
}
