// K4 and K5: the differentiable render's kernels, one thread per pixel.
//
// K4 (march_params_kernel) replaces the TPU kernel
// bsdmg_tpu/ops/pallas/diff_kernel.py::_march_kernel (pallas_call :162): the
// stopped sphere-trace march under runtime parameters that the
// differentiable render re-attaches by the implicit function theorem. Per
// ray: the optional slab cull against the caller's trust-region bounds, the
// exact march (omega = 1) with, on request, the closest-approach record
// (min_m = min over sampled points of f - cone*t, and its depth t_min), and
// dfdt, the SDF's derivative along the ray at the end point.
//
// Both are templates over the scene's parameter form (param_forms.cuh):
// the reference scenes' (ReferenceForm, param_sdf.cuh), the sphere's, the
// mandelbulb's, the wrapped object's, a composed scene's parameter
// program (param_program.cuh) and a mesh asset's grid, which reads no
// parameter (MeshGridForm: its K5 lanes carry no tangent, the loss
// alone); ParamScene::form picks it at launch
// (with_form), as K1's scene structure is picked.
//
// K5 (loss_march_kernel, loss_tangent_kernel or loss_tangent_form_kernel,
// loss_grad_sum) replaces
// diff_kernel.py::_loss_grad_kernel (pallas_call :405): the whole image-fit
// step. Per ray: K4's march, the IFT re-attachment t_diff = t0 -
// residual/denom, the analytic normal at q = o + t_diff d, the shading and
// ACES, the squared error against the target and, with edge_weight, the
// silhouette hinge of grad/edge.py at the closest-approach point. The JAX
// kernel differentiates this with reverse mode inside the kernel. Here a
// composed scene's parameter program does too: one reverse sweep a ray over
// a tape of its forward pass (loss_reverse_kernel, param_program.cuh
// program_reverse), whatever the number of parameter values; so does the
// wrapped object, whose function the host lowers to such a program
// (csdf.py wrapped_param_program). The other
// forms take the parameters as forward-mode duals (dual.cuh): each
// parameter carries its unit tangent, so the loss's tangents are
// dL/dtheta; the normal's tangents follow from evaluating the spatial
// gradient in duals at a point q whose tangents are dq/dtheta: the
// reference form's hand-written reverse pass (param_sdf.cuh), the others'
// forward pass in duals of duals (nested_dual.cuh).
//
// What bounds them on Hopper: instruction issue and the latency of each
// step's dependent chain (3 IEEE square roots and, near the blend of the
// smooth minimum, an IEEE division), warp divergence in the march, as in
// K1, and the occupancy that the registers allow; in K5 also the tangent
// work of each hit (in the forward forms about n_prm + 1 times a
// value-and-gradient; in a composed scene's reverse sweep a few times one,
// whatever n_prm) and the registers it needs. Memory traffic is 28 B in per ray and 16-24 B out
// (K4), 40-44 B in (K5). A K4 step issues about as many instructions as
// K1's; at 1080p the march, dfdt and the cull of every ray took 0.35 ms to
// K1's 0.19 at 79 registers, 24 warps an SM. With the design below K4
// takes 0.28 ms there, about half of it what a step limit of 1 leaves: the
// cull, the first step, dfdt and the planes of every ray (PERF.md).
//
// What the design does about it: K1's layout (warps on 8x4 pixel patches
// that finish in similar step counts, the scene as a by-value kernel
// parameter). The march reads the scene in its march form (param_sdf.cuh::
// MarchScene): what every step used to derive from the parameters (the
// rotation's frame, the skeleton's and the wireframe's boxes, the
// perpendicular sizes) is computed once before the loop, the translation
// is subtracted without a select, and the closest-approach record is a
// template argument. A zero dividend of the smooth minimum's division,
// which the division's range check sends down its slow path, gives its
// signed zero without it. dfdt is one forward pass in Dual<1>, at 55
// registers where the reverse-mode gradient held 79. K5 runs in three to
// five launches. The first marches every
// ray in plain float at K4's register budget, adds the loss of each ray
// that has no tangent (a miss without a hinge) to its block's sum, and
// lists the others (the hits and the hinge rays) per block of 16x8
// pixels, in thread order, with no atomics and no capacity. The second
// spreads the listed rays' tangent work over lanes. For the reference form
// a group of 3 lanes takes a ray, each lane the value and 3 of the 9 shape
// parameters' tangents (Dual<3>), 128 registers and 4 blocks an SM where
// one lane of 9 tangents took 255 registers and spilled; with the object
// transform, translation and rotation launches take its 7 tangents, one a
// lane. For a composed scene and the wrapped object (loss_reverse_kernel) a
// ray's lanes sweep its program backward, its parameters' adjoints
// accumulating per thread; for the sphere, the mandelbulb and the grid
// (loss_tangent_form_kernel) a thread takes a ray and carries its one
// parameter's tangent, or, for the mandelbulb over an image of few lists,
// a group of 4 lanes takes a ray's three spatial directions apart. Their
// blocks walk chunks of the lists in a fixed order and write one row of
// sums per chunk, or per warp. The last launch (loss_grad_sum) adds the rows
// in a fixed order. Two calls on the same inputs give the same bits.
//
// The near/far split of the TPU kernels (diff_kernel.py:120-139,
// :345-366) is taken per warp, as in K1 (render_kernel.cu march_split): in
// march_params_split_kernel and loss_march_split_kernel, the reference
// form's, an 8x4 patch whose rays all miss the caller's near box marches
// the wireframe alone (far_march_value) and takes dfdt of it; the tangent
// launches evaluate the full scene, as JAX's pixel_loss does. A composed
// scene beyond the small tier's caps (more than 64 parameter values, or a
// program beyond program.cuh's caps) runs in ProgramLargeForm, its values
// and stacks in device memory (param_program.cuh).
//
// Numerics: built with -fmad=false and without fast math, like K1. The
// march evaluates the scene in the twin's operation order, so K4's depth,
// steps, outcome, min_m and t_min equal the twin's bit for bit (but the
// mandelbulb's, whose libm calls may round otherwise); dfdt comes
// from forward mode and the twin's from autograd, which sum in other
// orders. Each tangent runs the operations the one-lane form ran on
// it; only the order of the final sums differs. The twins are
// march_params_torch and render_loss_grad_torch in
// bsdmg_tpu_torch/ops/cuda/diff_kernel.py.

#include <type_traits>

#include "param_forms.cuh"
#include "param_sdf.cuh"

// min_m of a ray that no sample reached (grad/edge.py::UNTRACKED)
#define BSDMG_UNTRACKED 1e9f

// the stopped march of one ray (render_kernel.py::_march, omega = 1, with
// the closest-approach record when Track); the scene in its form's march
// form, or with Far its wireframe alone (the near/far split's far scene)
template <class Form, bool Track, bool Far = false>
__device__ __forceinline__ void march(const ParamScene& s, const typename Form::March& ms,
                                      const float o[3], const float d[3], float c, float& depth,
                                      int& steps, int& outcome, float& min_m, float& t_min) {
  const float eps = s.collision_distance;
  depth = 0.0f;
  steps = 0;
  outcome = STEP_LIMIT;
  min_m = BSDMG_UNTRACKED;
  t_min = 0.0f;
  float limit = s.depth_limit;
  if (s.use_bounds && slab_cull(s, o[0], o[1], o[2], d[0], d[1], d[2], c, limit)) {
    depth = s.cull_depth;
    outcome = DEPTH_LIMIT;
    return;
  }
  for (;;) {
    const float cd = c * depth;
    const float x[3] = {o[0] + depth * d[0], o[1] + depth * d[1], o[2] + depth * d[2]};
    float dist;
    if constexpr (Far) {
      dist = Form::far_march_value(s, ms, x);
    } else {
      dist = Form::march_value(s, ms, x);
    }
    if (Track) {
      const float m = dist - cd;
      if (m < min_m) {
        min_m = m;
        t_min = depth;
      }
    }
    if (dist <= cd + eps) {
      outcome = COLLISION;
      return;
    }
    depth = (depth + dist) - cd;
    if (depth > limit) {
      outcome = DEPTH_LIMIT;
      return;
    }
    if (++steps >= s.step_limit) return;
  }
}

// the SDF's derivative along d at o + t d, parameters stopped: one forward
// pass in Dual<1> whose point carries the tangent d, as the JAX kernel's
// jax.jvp (diff_kernel.py:113-118). With it both march launches hold 54-56
// registers; the gradient by reverse mode and a dot with d held 79-80 and
// set their occupancy (PERF.md).
__device__ __forceinline__ float ray_derivative(const ParamScene& s, const ObjectParams<float>& p,
                                                const float o[3], const float d[3], float t) {
  Dual<1> x[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    x[a].v = o[a] + t * d[a];
    x[a].t[0] = d[a];
  }
  return scene_value(s, p, x).t[0];
}

// dfdt of the form: the reference form's ray_derivative, the others'
// form_ray_derivative (param_forms.cuh)
template <class Form>
__device__ __forceinline__ float form_dfdt(const ParamScene& s, const float o[3], const float d[3],
                                           float t) {
  if constexpr (std::is_same<Form, ReferenceForm>::value) {
    return ray_derivative(s, load_params<float>(s), o, d, t);
  } else if constexpr (std::is_same<Form, MeshGridForm>::value) {
    return MeshGridForm::ray_derivative(s, o, d, t);
  } else {
    return form_ray_derivative<Form>(s, o, d, t);
  }
}

// dfdt of the form, or with Far of its wireframe alone (the near/far
// split's far scene)
template <class Form, bool Far>
__device__ __forceinline__ float scene_dfdt(const ParamScene& s, const float o[3],
                                            const float d[3], float t) {
  if constexpr (Far) {
    return Form::far_dfdt(s, o, d, t);
  } else {
    return form_dfdt<Form>(s, o, d, t);
  }
}

// the pixel of thread threadIdx.x: a block covers 16x8 pixels, each of its 4
// warps an 8x4 patch
__device__ __forceinline__ void pixel_of_thread(int& px, int& py) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  px = blockIdx.x * 16 + (warp & 1) * 8 + (lane & 7);
  py = blockIdx.y * 8 + (warp >> 1) * 4 + (lane >> 3);
}

// The near/far split's vote of the warp (diff_kernel.py:120-139 and
// :345-366; render_kernel.cu march_split): true where none of the 8x4
// patch's rays that the slab cull keeps can reach the near box, and the
// patch marches the wireframe alone. `live` is false for a thread past the
// image, which takes part as a ray that cannot reach it; every thread of
// the warp that has not exited calls it.
__device__ __forceinline__ bool far_patch(const ParamScene& s, bool live, const float o[3],
                                          const float d[3], float c) {
  bool near = false;
  if (live) {
    float limit;
    const bool cull = s.use_bounds && slab_cull(s, o[0], o[1], o[2], d[0], d[1], d[2], c, limit);
    near = !cull && !near_miss(s, o[0], o[1], o[2], d[0], d[1], d[2], c);
  }
  return !__any_sync(0xffffffffu, near);
}

// K4 of one pixel; with Split (march_params_split_kernel, the reference
// form) its patch marches the far or the full scene, and dfdt is taken of
// the scene it marched, as JAX's march_fn
template <class Form, bool Track, bool Split>
__device__ __forceinline__ void march_params_pixel(
    const ParamScene& s, const float* __restrict__ origins, const float* __restrict__ directions,
    const float* __restrict__ cone, float* __restrict__ depth_out, int* __restrict__ steps_out,
    int* __restrict__ outcome_out, float* __restrict__ dfdt_out, float* __restrict__ min_m_out,
    float* __restrict__ t_min_out, int h, int w) {
  int px, py;
  pixel_of_thread(px, py);
  if (px >= w || py >= h) return;
  const long long i = (long long)py * w + px;
  const float o[3] = {origins[3 * i], origins[3 * i + 1], origins[3 * i + 2]};
  const float d[3] = {directions[3 * i], directions[3 * i + 1], directions[3 * i + 2]};
  const float c = cone[i];
  float depth, min_m, t_min;
  int steps, outcome;
  const bool far = Split && far_patch(s, true, o, d, c);
  if (far) {
    march<Form, Track, Split>(s, Form::march_scene(s), o, d, c, depth, steps, outcome, min_m,
                              t_min);
  } else {
    march<Form, Track>(s, Form::march_scene(s), o, d, c, depth, steps, outcome, min_m, t_min);
  }
  depth_out[i] = depth;
  steps_out[i] = steps;
  outcome_out[i] = outcome;
  dfdt_out[i] = far ? scene_dfdt<Form, Split>(s, o, d, depth) : form_dfdt<Form>(s, o, d, depth);
  if (Track) {
    min_m_out[i] = min_m;
    t_min_out[i] = t_min;
  }
}

#define K4_PARAMS                                                                               \
  const ParamScene s, const float *__restrict__ origins, const float *__restrict__ directions, \
      const float *__restrict__ cone, float *__restrict__ depth_out, int *__restrict__ steps_out, \
      int *__restrict__ outcome_out, float *__restrict__ dfdt_out,                            \
      float *__restrict__ min_m_out, float *__restrict__ t_min_out, int h, int w
#define K4_ARGS \
  s, origins, directions, cone, depth_out, steps_out, outcome_out, dfdt_out, min_m_out, t_min_out, h, w

template <class Form, bool Track>
__global__ void __launch_bounds__(128) march_params_kernel(K4_PARAMS) {
  march_params_pixel<Form, Track, false>(K4_ARGS);
}

template <bool Track>
__global__ void __launch_bounds__(128) march_params_split_kernel(K4_PARAMS) {
  march_params_pixel<ReferenceForm, Track, true>(K4_ARGS);
}

// K5's per-block record of a ray that needs tangents: a hit (the
// photometric term) or a ray with a silhouette hinge
struct TangentRay {
  int pixel;
  int outcome;
  float t0;     // the march's depth
  float min_m;  // the closest-approach record (edge term)
  float t_min;
  float denom;  // a hit's IFT denominator, stop(df/dt - cone)
};

// the hinge of grad/edge.py::edge_loss_planes: 1 appear, 2 vanish, else 0
__device__ __forceinline__ int hinge_kind(float t_state, bool collided, float min_m) {
  const bool valid = t_state > -0.5f;
  const bool target_miss = t_state > 0.5f;
  if (valid && !target_miss && !collided && min_m < BSDMG_UNTRACKED) return 1;
  if (valid && target_miss && collided) return 2;
  return 0;
}

// the photometric loss of a pixel whose colour is ACES of v (a miss)
__device__ __forceinline__ float constant_loss(const ParamScene& s, float v, const float* target,
                                               float inv_denom_elems) {
  float out[3];
  aces(s, v, v, v, out);
  const float er = out[0] - target[0], eg = out[1] - target[1], eb = out[2] - target[2];
  return ((er * er + eg * eg) + eb * eb) * inv_denom_elems;
}

// the IFT denominator of a hit at depth t0: stop(df/dt - cone), kept off 0;
// with Far, df/dt of the wireframe the ray marched
template <class Form, bool Far = false>
__device__ __forceinline__ float ift_denom(const ParamScene& s, const float o[3], const float d[3],
                                           float c, float t0) {
  float denom = scene_dfdt<Form, Far>(s, o, d, t0) - c;
  if (fabsf(denom) < 1e-6f) denom = -1e-6f;
  return denom;
}

// The scene as ray_loss evaluates it, at points in Dual<M>: its value and
// its spatial gradient. The reference form's: S, Tr and Ro are the shape's,
// the translation's and the rotation's parameter types, the lane carrying
// block `block` of the tangents of the one that is a Dual<M>, as
// load_params places them, the others as floats; the gradient reverse mode
// (param_sdf.cuh scene_value_grad).
template <class Opt, class S, class Tr, class Ro>
struct ReferenceEval {
  const ParamScene& s;
  const ObjectParams<S, Tr, Ro> p;
  __device__ __forceinline__ ReferenceEval(const ParamScene& s_, int block)
      : s(s_), p(load_params<S, Tr, Ro, Opt>(s_, block)) {}
  template <class D>
  __device__ __forceinline__ D value(const D x[3]) const {
    return scene_value<Opt>(s, p, x);
  }
  template <class D>
  __device__ __forceinline__ void grad(const D x[3], D g[3]) const {
    scene_value_grad<Opt>(s, p, x, g);
  }
};

// the other forms': every parameter a Dual<M> seeded by its slot
// (param_program.cuh Prm), the gradient forward over forward
// (param_forms.cuh form_value_grad)
template <class Form, int M>
struct FormEval {
  const ParamScene& s;
  const Prm<Dual<M>, Form::device> prm;
  __device__ __forceinline__ FormEval(const ParamScene& s_, int block) : s(s_), prm{&s_, block} {}
  __device__ __forceinline__ Dual<M> value(const Dual<M> x[3]) const {
    return Form::value(s, prm, x);
  }
  __device__ __forceinline__ void grad(const Dual<M> x[3], Dual<M> g[3]) const {
    form_value_grad<Form>(s, prm, x, g);
  }
};

// The loss of listed ray e (pixel i) and its tangents, D a Dual<M> for M
// parameters (diff_kernel.py:294-338): the IFT re-attachment at a hit, the
// analytic normal, the shading and ACES in duals, the squared error and the
// silhouette hinge, the scene evaluated by ev (ReferenceEval, FormEval).
// Each tangent runs the operations the one-lane Dual<N> form ran on it.
// With D a float (a form that reads no parameter, MeshGridForm::Eval) it
// is the loss alone. The ray and target are read where they are used, which
// keeps them out of registers in between.
template <class D, class Eval>
__device__ __forceinline__ D ray_loss(const ParamScene& s, const Eval& ev, const TangentRay& e,
                                      const float* __restrict__ origins,
                                      const float* __restrict__ directions,
                                      const float* __restrict__ cone,
                                      const float* __restrict__ target,
                                      const float* __restrict__ t_state, float inv_denom_elems,
                                      float inv_pixels, float edge_weight, float edge_band) {
  const long long i = e.pixel;
  const float t0 = e.t0;
  const bool collided = e.outcome == COLLISION;
  D rgb[3];
  if (collided) {
    const float o[3] = {origins[3 * i], origins[3 * i + 1], origins[3 * i + 2]};
    const float d[3] = {directions[3 * i], directions[3 * i + 1], directions[3 * i + 2]};
    const float c = cone[i];
    // IFT re-attachment: t_diff = t0 - (f(x0) - cone t0 - eps) / stop(df/dt - cone)
    const D x0[3] = {Scalar<D>::constant(o[0] + t0 * d[0]), Scalar<D>::constant(o[1] + t0 * d[1]),
                     Scalar<D>::constant(o[2] + t0 * d[2])};
    const D residual = (ev.value(x0) - c * t0) - s.collision_distance;
    const D t_diff = t0 - residual / e.denom;
    const D q[3] = {o[0] + t_diff * d[0], o[1] + t_diff * d[1], o[2] + t_diff * d[2]};
    D g[3];
    ev.grad(q, g);
    const D inv = 1.0f / vsqrt(vmax((g[0] * g[0] + g[1] * g[1]) + g[2] * g[2], 1e-24f));
    D r, gg, b;
    shade_collision(s, g[0] * inv, g[1] * inv, g[2] * inv, r, gg, b);
    aces(s, r, gg, b, rgb);
  } else {
    // a listed miss carries a hinge; its colour is ACES of white or black
    const float v = e.outcome == STEP_LIMIT ? 1.0f : 0.0f;
    float out[3];
    aces(s, v, v, v, out);
#pragma unroll
    for (int a = 0; a < 3; ++a) rgb[a] = Scalar<D>::constant(out[a]);
  }
  const D er = rgb[0] - target[3 * i], eg = rgb[1] - target[3 * i + 1],
          eb = rgb[2] - target[3 * i + 2];
  D total = ((er * er + eg * eg) + eb * eb) * inv_denom_elems;
  const int kind = t_state != nullptr ? hinge_kind(t_state[i], collided, e.min_m) : 0;
  if (kind != 0) {
    const float c = cone[i];
    const D xe[3] = {Scalar<D>::constant(origins[3 * i] + e.t_min * directions[3 * i]),
                     Scalar<D>::constant(origins[3 * i + 1] + e.t_min * directions[3 * i + 1]),
                     Scalar<D>::constant(origins[3 * i + 2] + e.t_min * directions[3 * i + 2])};
    const D m = ev.value(xe) - c * e.t_min;
    const D h = kind == 1 ? vmax(m, 0.0f) : vmax(edge_band - m, 0.0f);
    total = total + (h * edge_weight) * inv_pixels;
  }
  return total;
}

// K5, first launch: one thread per pixel in K4's layout marches in plain
// float (K4's march). A pixel whose loss has no tangents (a miss without a
// hinge) adds its loss to its block's sum `values[block]`, in a fixed
// order; every other pixel goes to its block's list `rays[block * 128 ..]`,
// in thread order, with the count in `counts[block]` and, for a hit, the
// IFT denominator. No atomics, no host sync, no capacity: a block lists at
// most its 128 rays. With Split (loss_march_split_kernel, the reference
// form) each 8x4 patch marches the far or the full scene (far_patch) and
// takes its hits' IFT denominators of the scene it marched; the tangent
// launches evaluate the full scene, as JAX's pixel_loss does, so a hit on
// the wireframe carries no object gradient.
template <class Form, bool Split>
__device__ __forceinline__ void loss_march_pixel(
    const ParamScene& s, const float* __restrict__ origins, const float* __restrict__ directions,
    const float* __restrict__ cone, const float* __restrict__ target,
    const float* __restrict__ t_state, TangentRay* __restrict__ rays, int* __restrict__ counts,
    float* __restrict__ values, int h, int w, float inv_denom_elems) {
  int px, py;
  pixel_of_thread(px, py);
  const long long block = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  TangentRay e{0, DEPTH_LIMIT, 0.0f, BSDMG_UNTRACKED, 0.0f, 0.0f};
  bool listed = false;
  float value = 0.0f;
  bool far = false;
  if constexpr (Split) {
    // a thread past the image reads ray 0 and votes as a ray that cannot
    // reach the near box
    const bool live = px < w && py < h;
    const long long i = live ? (long long)py * w + px : 0;
    const float o[3] = {origins[3 * i], origins[3 * i + 1], origins[3 * i + 2]};
    const float d[3] = {directions[3 * i], directions[3 * i + 1], directions[3 * i + 2]};
    far = far_patch(s, live, o, d, cone[i]);
  }
  if (px < w && py < h) {
    const long long i = (long long)py * w + px;
    const float o[3] = {origins[3 * i], origins[3 * i + 1], origins[3 * i + 2]};
    const float d[3] = {directions[3 * i], directions[3 * i + 1], directions[3 * i + 2]};
    const bool edge = t_state != nullptr;
    int steps;
    if (far && edge) {
      march<Form, true, Split>(s, Form::march_scene(s), o, d, cone[i], e.t0, steps, e.outcome,
                               e.min_m, e.t_min);
    } else if (far) {
      march<Form, false, Split>(s, Form::march_scene(s), o, d, cone[i], e.t0, steps, e.outcome,
                                e.min_m, e.t_min);
    } else if (edge) {
      march<Form, true>(s, Form::march_scene(s), o, d, cone[i], e.t0, steps, e.outcome, e.min_m,
                        e.t_min);
    } else {
      march<Form, false>(s, Form::march_scene(s), o, d, cone[i], e.t0, steps, e.outcome, e.min_m,
                         e.t_min);
    }
    e.pixel = static_cast<int>(i);
    const bool collided = e.outcome == COLLISION;
    if (collided) {
      e.denom = far ? ift_denom<Form, Split>(s, o, d, cone[i], e.t0)
                    : ift_denom<Form>(s, o, d, cone[i], e.t0);
    }
    listed = collided || (edge && hinge_kind(t_state[i], false, e.min_m) != 0);
    if (!listed) {
      value = constant_loss(s, e.outcome == STEP_LIMIT ? 1.0f : 0.0f, target + 3 * i,
                            inv_denom_elems);
    }
  }
  // the block's list, in thread order
  __shared__ int warp_counts[4];
  __shared__ float warp_values[4];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, listed);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) value += __shfl_down_sync(0xffffffffu, value, off);
  if (lane == 0) {
    warp_counts[warp] = __popc(ballot);
    warp_values[warp] = value;
  }
  __syncthreads();
  if (listed) {
    int slot = __popc(ballot & ((1u << lane) - 1u));
    for (int k = 0; k < warp; ++k) slot += warp_counts[k];
    rays[block * 128 + slot] = e;
  }
  if (threadIdx.x == 0) {
    counts[block] = ((warp_counts[0] + warp_counts[1]) + warp_counts[2]) + warp_counts[3];
    values[block] = ((warp_values[0] + warp_values[1]) + warp_values[2]) + warp_values[3];
  }
}

#define K5_MARCH_PARAMS                                                                         \
  const ParamScene s, const float *__restrict__ origins, const float *__restrict__ directions, \
      const float *__restrict__ cone, const float *__restrict__ target,                        \
      const float *__restrict__ t_state, TangentRay *__restrict__ rays, int *__restrict__ counts, \
      float *__restrict__ values, int h, int w, float inv_denom_elems
#define K5_MARCH_ARGS \
  s, origins, directions, cone, target, t_state, rays, counts, values, h, w, inv_denom_elems

template <class Form>
__global__ void __launch_bounds__(128) loss_march_kernel(K5_MARCH_PARAMS) {
  loss_march_pixel<Form, false>(K5_MARCH_ARGS);
}

template <class Form>
__global__ void __launch_bounds__(128) loss_march_split_kernel(K5_MARCH_PARAMS) {
  loss_march_pixel<Form, true>(K5_MARCH_ARGS);
}

// the slot in the flat parameter vector of a parameter's place among the shape's (0-8: skeleton
// centre, size, line width, sphere radius, smooth k) or the transform's
// (0-2 the object centre, 3-6 the rotation), -1 for one that is absent
__device__ __forceinline__ int shape_slot(const ParamScene& s, int c) {
  if (c < 3) return s.skeleton_center + c;
  if (c < 6) return s.skeleton_size + c - 3;
  return c == 6 ? s.skeleton_line_width : (c == 7 ? s.sphere_radius : s.smooth_k);
}

__device__ __forceinline__ int rigid_slot(const ParamScene& s, int c) {
  if (c < 3) return s.object_center >= 0 ? s.object_center + c : -1;
  return s.object_rotation >= 0 ? s.object_rotation + c - 3 : -1;
}

#define BSDMG_SHAPE_PARAMS 9

enum { SHAPE_LANES = 0, TRANSLATION_LANES = 1, ROTATION_LANES = 2 };

// The lanes of K5's tangent launches: a shape lane carries the value and 3
// of the shape's 9 tangents (Dual<3>, 3 lanes a ray); with the object
// transform, a translation lane 1 of the centre's 3 (Dual<1>, 3 lanes a
// ray), a rotation lane 1 of the quaternion's 4 (Dual<1>, 4 lanes a ray).
// Each lane holds only its own kind's parameters as duals, which keeps every
// launch within 128 registers without spills. A chunk is as many rays as a
// block of 128 threads takes at once.
template <int Lanes>
struct TangentLanes {
  static constexpr int tangents = Lanes == SHAPE_LANES ? 3 : 1;  // a lane's
  static constexpr int lanes = Lanes == ROTATION_LANES ? 4 : 3;  // a ray's
  static constexpr int first = Lanes == ROTATION_LANES ? 3 : 0;  // its first place
  static constexpr int groups = 128 / lanes;                     // rays of a chunk
  static constexpr int chunks = (128 + groups - 1) / groups;     // chunks of a list
};

// K5's tangent launches over the first launch's lists. An item is a chunk
// of one block's list; the blocks take the items in a fixed order and each
// item's sums go to its own row (the launch's rows start at row0), so the
// result never depends on which block took which item. In an item, each
// group of lanes takes one ray, and lane j of the group carries block j of
// the launch's parameters' tangents (TangentLanes): a ray's tangent work is
// spread over the group, and the kernel stays within 128 registers. The
// shape launch carries the shape's parameters; with the object transform,
// a translation and a rotation launch carry the transform's. An item's row
// of partials (stride floats) holds its loss (shape launch, the first
// chunk adding the first launch's sum) and dL/dprm at the launch's slots,
// and zero at the others.
template <class Opt, int Lanes>
__global__ void __launch_bounds__(128, 4)
loss_tangent_kernel(const ParamScene s, const float* __restrict__ origins,
                    const float* __restrict__ directions, const float* __restrict__ cone,
                    const float* __restrict__ target, const float* __restrict__ t_state,
                    const TangentRay* __restrict__ rays, const int* __restrict__ counts,
                    const float* __restrict__ values, float* __restrict__ partials, int stride,
                    long long row0, long long blocks, float inv_denom_elems, float inv_pixels,
                    float edge_weight, float edge_band) {
  typedef TangentLanes<Lanes> T;
  constexpr int M = T::tangents, L = T::lanes;
  const int group = threadIdx.x / L, j = threadIdx.x % L;
  // where output k (the loss, then dL/dprm by slot) sits in the sums: the
  // lane and component of the launch's parameter at slot k - 1, or -1
  int from = -1, component = 0;
  if (threadIdx.x < stride) {
    const int k = threadIdx.x;
    if (k == 0) {
      from = Lanes == SHAPE_LANES ? 0 : -1;
    } else {
      for (int c = 0; c < L * M; ++c) {
        if ((Lanes == SHAPE_LANES ? shape_slot(s, c) : rigid_slot(s, T::first + c)) == k - 1) {
          from = c / M;
          component = c % M + 1;
        }
      }
    }
  }
  __shared__ float sums[128][M + 1];
  const long long items = blocks * T::chunks;
  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    const long long block = w / T::chunks;
    const int first = static_cast<int>(w % T::chunks) * T::groups;
    const int n = counts[block];
    float acc[M + 1];
#pragma unroll
    for (int m = 0; m <= M; ++m) acc[m] = 0.0f;
    if (group < T::groups && first + group < n) {
      const TangentRay& e = rays[block * 128 + first + group];
      typedef Dual<M> D;
      const D loss =
          Lanes == SHAPE_LANES
              ? ray_loss<D>(s, ReferenceEval<Opt, D, float, float>(s, j), e, origins, directions,
                            cone, target, t_state, inv_denom_elems, inv_pixels, edge_weight,
                            edge_band)
          : Lanes == TRANSLATION_LANES
              ? ray_loss<D>(s, ReferenceEval<Opt, float, D, float>(s, j), e, origins, directions,
                            cone, target, t_state, inv_denom_elems, inv_pixels, edge_weight,
                            edge_band)
              : ray_loss<D>(s, ReferenceEval<Opt, float, float, D>(s, T::first + j), e, origins,
                            directions, cone, target, t_state, inv_denom_elems, inv_pixels,
                            edge_weight, edge_band);
      acc[0] = loss.v;
#pragma unroll
      for (int m = 0; m < M; ++m) acc[m + 1] = loss.t[m];
    }
    __syncthreads();  // the previous item's sums are read
#pragma unroll
    for (int m = 0; m <= M; ++m) sums[threadIdx.x][m] = acc[m];
    __syncthreads();
    if (threadIdx.x < stride) {
      float total = threadIdx.x == 0 && Lanes == SHAPE_LANES && first == 0 ? values[block] : 0.0f;
      if (from >= 0 && first < n) {
        for (int g = 0; g < T::groups; ++g) total += sums[g * L + from][component];
      }
      partials[(row0 + w) * stride + threadIdx.x] = total;
    }
  }
}

// The mandelbulb's scene as ray_loss evaluates it on a group of 4 lanes
// that takes one ray (sub, this lane's place in it; mask, the group's): the
// value in Dual<1> (its one parameter's tangent) on every lane, the spatial
// gradient one direction a lane, lane a < 3 the derivative along e_a in
// DualOf<1, Dual<1>> (4 floats a value, where DualOf<3, Dual<1>> carried
// 8), the three shared by __shfl_sync. Each component runs the operations
// that component ran in DualOf<3, Dual<1>> (nested_dual.cuh's rules act
// component by component), so the loss and its tangent are the one-lane
// form's bit for bit; every lane then finishes ray_loss, the first lane's
// counted. Lane 3 runs direction 0 again: the group's lanes stay in step.
template <class Form>
struct DirectionEval {
  const ParamScene& s;
  const Prm<Dual<1>, Form::device> prm;
  int sub;
  unsigned mask;
  __device__ __forceinline__ Dual<1> value(const Dual<1> x[3]) const {
    return Form::value(s, prm, x);
  }
  __device__ __forceinline__ void grad(const Dual<1> x[3], Dual<1> g[3]) const {
    const int axis = sub < 3 ? sub : 0;
    DualOf<1, Dual<1>> p[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      p[a].v = x[a];
      p[a].t[0] = Scalar<Dual<1>>::constant(a == axis ? 1.0f : 0.0f);
    }
    const Dual<1> mine = Form::value(s, prm, p).t[0];
    const int lead = __ffs(mask) - 1;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      g[a].v = __shfl_sync(mask, mine.v, lead + a);
      g[a].t[0] = __shfl_sync(mask, mine.t[0], lead + a);
    }
  }
};

// K5's tangent launch for the sphere's, the mandelbulb's and the grid's
// forms (a form with a Sweep, a composed scene's program or the wrapped
// object's, sweeps in reverse: loss_reverse_kernel below): a ray's lane
// carries the tangents of every parameter value (Dual<L>, L =
// form_tangents: one for the sphere and the mandelbulb, none for the grid).
// With Lanes 1 a thread takes a ray and an item is a block's whole list,
// whose row of partials (stride floats) holds its loss (the first
// launch's sum, then its rays' in thread order) and dL/dprm. With Lanes 4
// (a form with `directions`, where tangent_lanes says so) a group of 4
// lanes takes a ray (DirectionEval), an item is a quarter of a list, 32
// rays, and each ray writes a row of its own (at block * 128 + its place
// in the list), which loss_grad_sum_rays adds up as the one-lane launch
// does: the two give the same bits. The blocks take the items in a fixed
// order, so two calls give the same bits.
#define BSDMG_FORM_TANGENTS 1

// the tangents a lane carries: none for a form that reads no parameter
// (MeshGridForm, whose gradient is zero: its lane takes ray_loss in float
// through Form::Eval, the loss alone)
template <class Form>
__host__ __device__ constexpr int form_tangents() {
  return std::is_same<Form, MeshGridForm>::value ? 0 : BSDMG_FORM_TANGENTS;
}

template <class Form, int Lanes>
__global__ void __launch_bounds__(128)
loss_tangent_form_kernel(const ParamScene s, const float* __restrict__ origins,
                         const float* __restrict__ directions, const float* __restrict__ cone,
                         const float* __restrict__ target, const float* __restrict__ t_state,
                         const TangentRay* __restrict__ rays, const int* __restrict__ counts,
                         const float* __restrict__ values, float* __restrict__ partials,
                         int stride, long long blocks, float inv_denom_elems, float inv_pixels,
                         float edge_weight, float edge_band) {
  constexpr int L = form_tangents<Form>();
  constexpr int groups = 128 / Lanes;  // rays of an item
  const int group = threadIdx.x / Lanes, sub = threadIdx.x % Lanes;
  const int lane = threadIdx.x & 31;
  const unsigned mask = (0xffffffffu >> (32 - Lanes)) << (lane - sub);
  __shared__ float sums[128][L + 1];
  const long long items = blocks * Lanes;
  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    const long long block = w / Lanes;
    const int first = static_cast<int>(w % Lanes) * groups;
    const int n = counts[block];
    float acc[L + 1];
#pragma unroll
    for (int m = 0; m <= L; ++m) acc[m] = 0.0f;
    if (first + group < n) {
      const TangentRay& e = rays[block * 128 + first + group];
      if constexpr (L == 0) {
        acc[0] = ray_loss<float>(s, typename Form::Eval{s}, e, origins, directions, cone, target,
                                 t_state, inv_denom_elems, inv_pixels, edge_weight, edge_band);
      } else {
        Dual<L> loss;
        if constexpr (Lanes == 1) {
          loss = ray_loss<Dual<L>>(s, FormEval<Form, L>(s, 0), e, origins, directions, cone,
                                   target, t_state, inv_denom_elems, inv_pixels, edge_weight,
                                   edge_band);
        } else {
          static_assert(L == 1, "a ray's directions split over lanes carry one tangent");
          loss = ray_loss<Dual<1>>(s, DirectionEval<Form>{s, {&s, 0}, sub, mask}, e, origins,
                                   directions, cone, target, t_state, inv_denom_elems, inv_pixels,
                                   edge_weight, edge_band);
        }
        if (sub == 0) {
          acc[0] = loss.v;
#pragma unroll
          for (int m = 0; m < L; ++m) acc[m + 1] = loss.t[m];
        }
      }
      if (Lanes > 1 && sub == 0) {
        // the ray's own row
        float* row = partials + (block * 128 + first + group) * stride;
#pragma unroll
        for (int m = 0; m <= L; ++m) row[m] = acc[m];
      }
    }
    if constexpr (Lanes > 1) continue;
    __syncthreads();  // the previous item's sums are read
#pragma unroll
    for (int m = 0; m <= L; ++m) sums[threadIdx.x][m] = acc[m];
    __syncthreads();
    for (int k = threadIdx.x; k < stride; k += blockDim.x) {
      // output k: the loss, then slot k - 1's tangent
      float total = k == 0 && first == 0 ? values[block] : 0.0f;
      if (first < n) {
        for (int g = 0; g < groups; ++g) total += sums[g * Lanes][k];
      }
      partials[w * stride + k] = total;
    }
  }
}

// K5's tangent launch for a composed scene's parameter program (ProgramForm,
// ProgramLargeForm): one reverse sweep a listed ray, whatever the number of
// parameter values (param_program.cuh program_record, program_reverse).
// Per hit: the program at x0 in float, t_diff and q as ray_loss takes them;
// the program at q in Dual<3> (value and spatial gradient g) with its tape;
// the loss and dL/dg in Dual<3> through the normal, the shading, ACES and
// the squared error; the sweep at q from the adjoint (0, dL/dg), which adds
// dL/dprm at fixed q and gives dL/dq; then, since q moves along d with
// t_diff = t0 - (f(x0) - c t0 - eps) / stop(denom), the sweep at x0 from
// -(dL/dq . d) / denom. A hinge ray adds the sweep at its closest-approach
// point from the hinge's derivative (tie_weight at 0, as vmax's). A ray
// takes Lanes lanes (reverse_lanes: 4 where an image has no more lists than
// the card has SMs, else 1), which walk its sweeps together, each taking
// its share of every primitive's passes (param_program.cuh Adjoint): the
// latency of a sweep, which a small image's few rays leave exposed, falls
// by up to a primitive's passes (3 or 4); each is its own instantiation, so
// one lane a ray keeps its registers. The parameters'
// adjoints of a thread accumulate over its rays: in shared memory (small
// tier, BSDMG_MAX_PARAMS rows of 129 floats, conflict-free both across the
// threads and across the rows) or the scratch buffer after the sweep's
// slots (large tier). A sweep's stack, frames and tape are laid out by the
// program's own depth and frames in both tiers. An item is a warp's chunk
// of 32 / Lanes rays of one
// block's list (4 Lanes items a list); warp v of the launch takes items v,
// v + warps, ... in that order, lane 0 of the chunk 0 adding the first
// launch's sum of the block, and writes one row of partials (stride =
// n_slots + 1: the loss, then dL/dprm by slot, the wrapped object's
// private slots too, which the host folds), each output summed over its 32
// lanes in lane order: two calls give the same bits.
#define BSDMG_ADJ_STRIDE 129

// the ray's loss, its dL/dprm added to adj
template <bool D, bool Spilled, class A>
__device__ __forceinline__ float ray_loss_reverse(
    const ParamScene& s, Store<Spilled>& st, const SweepLayout& layout, A& adj,
    const TangentRay& e, const float* __restrict__ origins, const float* __restrict__ directions,
    const float* __restrict__ cone, const float* __restrict__ target,
    const float* __restrict__ t_state, float inv_denom_elems, float inv_pixels, float edge_weight,
    float edge_band) {
  const long long i = e.pixel;
  const bool collided = e.outcome == COLLISION;
  float total;
  int tp;
  if (collided) {
    const float o[3] = {origins[3 * i], origins[3 * i + 1], origins[3 * i + 2]};
    const float d[3] = {directions[3 * i], directions[3 * i + 1], directions[3 * i + 2]};
    const float c = cone[i];
    const float t0 = e.t0;
    const float x0[3] = {o[0] + t0 * d[0], o[1] + t0 * d[1], o[2] + t0 * d[2]};
    const float residual =
        (program_value(s, Prm<float, D>{&s, 0}, x0) - c * t0) - s.collision_distance;
    const float t_diff = t0 - residual / e.denom;
    Dual<3> q[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) q[a] = Scalar<Dual<3>>::placed(o[a] + t_diff * d[a], a, 0);
    const Dual<3> f = program_record<Dual<3>, D>(s, q, st, layout, tp);
    Dual<3> g[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) g[a] = Scalar<Dual<3>>::placed(f.t[a], a, 0);
    const Dual<3> inv = 1.0f / vsqrt(vmax((g[0] * g[0] + g[1] * g[1]) + g[2] * g[2], 1e-24f));
    Dual<3> r, gg, b, rgb[3];
    shade_collision(s, g[0] * inv, g[1] * inv, g[2] * inv, r, gg, b);
    aces(s, r, gg, b, rgb);
    const Dual<3> er = rgb[0] - target[3 * i], eg = rgb[1] - target[3 * i + 1],
                  eb = rgb[2] - target[3 * i + 2];
    const Dual<3> photo = ((er * er + eg * eg) + eb * eb) * inv_denom_elems;
    total = photo.v;
    Dual<3> seed = photo;
    seed.v = 0.0f;
    Dual<3> qbar[3];
    program_reverse<Dual<3>, D>(s, q, seed, st, layout, tp, adj, qbar);
    const float dt = (qbar[0].v * d[0] + qbar[1].v * d[1]) + qbar[2].v * d[2];
    program_record<float, D>(s, x0, st, layout, tp);
    float x0bar[3];
    program_reverse<float, D>(s, x0, -dt / e.denom, st, layout, tp, adj, x0bar);
  } else {
    const float v = e.outcome == STEP_LIMIT ? 1.0f : 0.0f;
    float rgb[3];
    aces(s, v, v, v, rgb);
    const float er = rgb[0] - target[3 * i], eg = rgb[1] - target[3 * i + 1],
                eb = rgb[2] - target[3 * i + 2];
    total = ((er * er + eg * eg) + eb * eb) * inv_denom_elems;
  }
  const int kind = t_state != nullptr ? hinge_kind(t_state[i], collided, e.min_m) : 0;
  if (kind != 0) {
    const float c = cone[i];
    const float xe[3] = {origins[3 * i] + e.t_min * directions[3 * i],
                         origins[3 * i + 1] + e.t_min * directions[3 * i + 1],
                         origins[3 * i + 2] + e.t_min * directions[3 * i + 2]};
    const float m = program_record<float, D>(s, xe, st, layout, tp) - c * e.t_min;
    const float arg = kind == 1 ? m : edge_band - m;
    const float h = vmax(arg, 0.0f);
    total = total + (h * edge_weight) * inv_pixels;
    const float dm = (kind == 1 ? 1.0f : -1.0f) * tie_weight(arg, h, 0.0f);
    float xebar[3];
    program_reverse<float, D>(s, xe, (dm * edge_weight) * inv_pixels, st, layout, tp, adj, xebar);
  }
  return total;
}

template <class Form, int Lanes>
__global__ void __launch_bounds__(128, !Form::device && Lanes == 1 ? 4 : 1)
loss_reverse_kernel(const ParamScene s, const float* __restrict__ origins,
                    const float* __restrict__ directions, const float* __restrict__ cone,
                    const float* __restrict__ target, const float* __restrict__ t_state,
                    const TangentRay* __restrict__ rays, const int* __restrict__ counts,
                    const float* __restrict__ values, float* __restrict__ partials, int stride,
                    long long blocks, float inv_denom_elems, float inv_pixels, float edge_weight,
                    float edge_band) {
  constexpr bool D = Form::device;  // the large tier: the sweep in the scratch buffer
  __shared__ float losses[128];
  __shared__ float adj_shared[D ? 1 : BSDMG_MAX_PARAMS * BSDMG_ADJ_STRIDE];
  const int lane = threadIdx.x & 31;
  const long long warps = 4LL * gridDim.x;
  const long long warp = 4LL * blockIdx.x + (threadIdx.x >> 5);
  const int n_slots = s.n_slots;
  // a ray's group of lanes: this lane's place in it, the group's mask
  const int sub = lane & (Lanes - 1);
  const unsigned mask = (0xffffffffu >> (32 - Lanes)) << (lane - sub);
  float local_slots[D ? 1 : BSDMG_SWEEP_SLOTS * BSDMG_SWEEP_WORDS];
  Store<D> st;
  Adjoint<Lanes> adj;
  SweepLayout layout(s.program_depth, s.program_frames);
  if constexpr (D) {
    const long long threads = s.scratch_threads;
    st = Store<D>{s.scratch + launch_thread(), threads};
    const long long words = (long long)BSDMG_SWEEP_WORDS *
                            (layout.tape + 3LL * s.program_length / 2);
    adj = Adjoint<Lanes>{s.scratch + words * threads + launch_thread(), threads, sub, mask};
  } else {
    st = Store<D>{local_slots, 1};
    adj = Adjoint<Lanes>{adj_shared + threadIdx.x, BSDMG_ADJ_STRIDE, sub, mask};
  }
  for (int k = 0; k < n_slots; ++k) adj.base[k * adj.stride] = 0.0f;
  float loss = 0.0f;
  constexpr int per_item = 32 / Lanes;  // rays an item
  const long long items = 4LL * Lanes * blocks;
  for (long long item = warp; item < items; item += warps) {
    const long long block = item / (4 * Lanes);
    const int first = static_cast<int>(item % (4 * Lanes)) * per_item;
    const int n = counts[block];
    if (first == 0 && lane == 0) loss += values[block];
    const int ray = first + lane / Lanes;
    if (ray < n) {
      const float l = ray_loss_reverse<D>(s, st, layout, adj, rays[block * 128 + ray], origins,
                                          directions, cone, target, t_state, inv_denom_elems,
                                          inv_pixels, edge_weight, edge_band);
      if (sub == 0) loss += l;
    }
  }
  losses[threadIdx.x] = loss;
  __syncwarp();
  const int warp0 = threadIdx.x - lane;
  for (int k = lane; k < stride; k += 32) {
    float total = 0.0f;
    for (int t = 0; t < 32; ++t) {
      total += k == 0 ? losses[warp0 + t]
                      : adj.base[(long long)(k - 1) * adj.stride + (t - lane)];
    }
    partials[warp * stride + k] = total;
  }
}

#if !defined(BSDMG_DIFF_SECOND_UNIT) && !defined(BSDMG_DIFF_REVERSE_UNIT) && \
    !defined(BSDMG_DIFF_LANES_UNIT)
// out[blockIdx.x] = the sum of the acc of the block's first 256 threads
// in a fixed tree (every thread of the block takes part)
__device__ __forceinline__ void tree_sum(float acc, float* __restrict__ out) {
  __shared__ float sums[256];
  if (threadIdx.x < 256) sums[threadIdx.x] = acc;
  __syncthreads();
  for (int half = 128; half > 0; half >>= 1) {
    if (threadIdx.x < half) sums[threadIdx.x] += sums[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = sums[0];
}

// out[k] = the sum over rows of partials[row * stride + k], one block per
// k, each thread over a fixed stride of rows, then a fixed tree; launched
// by this unit alone
__global__ void __launch_bounds__(256)
loss_grad_sum(const float* __restrict__ partials, int n_rows, int stride, float* __restrict__ out) {
  const int k = blockIdx.x;
  float acc = 0.0f;
  for (int b = threadIdx.x; b < n_rows; b += 256) acc += partials[(long long)b * stride + k];
  tree_sum(acc, out);
}

// the same over the rows of a launch that writes a row a ray
// (loss_tangent_form_kernel at 4 lanes a ray): block b's row is its first
// launch's sum (the loss), then its listed rays' rows added in list order,
// as loss_tangent_form_kernel<Form, 1> adds them (its idle threads' zeros
// too), and each of the first 256 threads adds the rows loss_grad_sum's
// would, in its order: both give the same bits. Each of the 32 warps takes
// a row at a time, its rays' outputs read at once into shared memory and
// added there by its first lane.
__global__ void __launch_bounds__(1024)
loss_grad_sum_rays(const float* __restrict__ partials, const float* __restrict__ values,
                   const int* __restrict__ counts, int n_blocks, int stride,
                   float* __restrict__ out) {
  __shared__ float staged[32][128];
  __shared__ float rows[256];
  const int k = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc = 0.0f;
  for (int base = 0; base < n_blocks; base += 256) {
    const int here = n_blocks - base < 256 ? n_blocks - base : 256;
    for (int r = warp; r < here; r += 32) {
      const long long b = base + r;
      const int n = counts[b];
      for (int g = lane; g < 128; g += 32) {
        staged[warp][g] = g < n ? partials[(b * 128 + g) * stride + k] : 0.0f;
      }
      __syncwarp();
      if (lane == 0) {
        float total = k == 0 ? values[b] : 0.0f;
        if (n > 0) {
          for (int g = 0; g < 128; ++g) total += staged[warp][g];
        }
        rows[r] = total;
      }
      __syncwarp();
    }
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < here) acc += rows[threadIdx.x];
    __syncthreads();
  }
  tree_sum(acc, out);
}
#endif  // the units

// the width of K5's partial sums for n_prm parameters of the reference
// form: 9 for the shape parameters alone, 16 with the object transform
static int tangents(int n_prm) {
  return n_prm <= BSDMG_SHAPE_PARAMS ? BSDMG_SHAPE_PARAMS : BSDMG_REFERENCE_PARAMS;
}

// f(Form{}) for the form ParamScene::form names; false for none
template <class F>
static bool with_form(int form, F&& f) {
  switch (form) {
    case FORM_REFERENCE: f(ReferenceForm{}); return true;
    case FORM_SPHERE: f(SphereForm{}); return true;
    case FORM_MANDELBULB: f(MandelbulbForm{}); return true;
    case FORM_WRAPPED: f(WrappedForm{}); return true;
    case FORM_PROGRAM: f(ProgramForm{}); return true;
    case FORM_MESH_GRID: f(MeshGridForm{}); return true;
    case FORM_PROGRAM_LARGE: f(ProgramLargeForm{}); return true;
    default: return false;
  }
}

// the ParamForm of form F
template <class F>
static constexpr int form_id() {
  return std::is_same<F, SphereForm>::value         ? FORM_SPHERE
         : std::is_same<F, MandelbulbForm>::value   ? FORM_MANDELBULB
         : std::is_same<F, WrappedForm>::value      ? FORM_WRAPPED
         : std::is_same<F, ProgramForm>::value      ? FORM_PROGRAM
         : std::is_same<F, MeshGridForm>::value     ? FORM_MESH_GRID
         : std::is_same<F, ProgramLargeForm>::value ? FORM_PROGRAM_LARGE
                                                    : FORM_REFERENCE;
}

// the form whose parameter program K5's tangent launch sweeps in reverse
// for form F (F::Sweep: a composed scene's own; ProgramForm for the wrapped
// object, lowered on the host), void for a form that takes lanes
template <class F, class = void>
struct sweep_of {
  typedef void type;
};
template <class F>
struct sweep_of<F, std::void_t<typename F::Sweep>> {
  typedef typename F::Sweep type;
};
template <class F>
struct sweeps : std::integral_constant<bool, !std::is_void<typename sweep_of<F>::type>::value> {};

// a form whose K5 lanes may take a ray's spatial directions apart
// (F::directions: the mandelbulb's)
template <class F, class = void>
struct has_directions : std::false_type {};
template <class F>
struct has_directions<F, std::void_t<decltype(F::directions)>>
    : std::integral_constant<bool, F::directions> {};

// the forms whose K5 sweeps a parameter program in reverse
static bool sweep_form(int form) {
  return form == FORM_PROGRAM || form == FORM_PROGRAM_LARGE || form == FORM_WRAPPED;
}

// f(Parts<frame, transform>{}) with both flags as template arguments
template <class F>
static void with_parts(bool frame, bool transform, F&& f) {
  if (frame && transform) f(Parts<true, true>{});
  else if (frame) f(Parts<true, false>{});
  else if (transform) f(Parts<false, true>{});
  else f(Parts<false, false>{});
}

// K5's blocks of 16x8 pixels
static long long loss_grad_blocks(int h, int w) {
  return (long long)((w + 15) / 16) * ((h + 7) / 8);
}

// rows of partial sums of K5 for its blocks: a chunk's for the shape launch
// and, with the object transform, for the translation and rotation
// launches (the scratch holds room for all three)
static long long loss_grad_rows(long long blocks, bool transform) {
  return blocks * (TangentLanes<SHAPE_LANES>::chunks +
                   (transform ? TangentLanes<TRANSLATION_LANES>::chunks +
                                    TangentLanes<ROTATION_LANES>::chunks
                              : 0));
}

// the card's SMs
static int card_sms() {
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  return sms > 0 ? sms : 1;
}

// blocks of a tangent launch over `items` chunks: 8 an SM at most (each
// block walks its share of the items)
static int tangent_grid(long long items) {
  const long long most = 8LL * card_sms();
  return static_cast<int>(items < most ? (items > 0 ? items : 1) : most);
}

// lanes a ray of the reverse launch (loss_reverse_kernel) over an image of
// `blocks` lists: 4 where there are no more lists than SMs (4 lanes a ray
// then take a block of 128 threads a list, at most one an SM), else 1
static int reverse_lanes(long long blocks) { return blocks <= card_sms() ? 4 : 1; }

// blocks of the reverse launch over `blocks` lists
static int reverse_grid(long long blocks) { return tangent_grid(blocks * reverse_lanes(blocks)); }

// lanes a ray of the mandelbulb's tangent launch over `blocks` lists: its
// directions on 4 (DirectionEval) where the launch's 4 * blocks items, a
// block of 128 threads each, take at most one block an SM, else 1. Each
// lane still runs every libm call of the loop, so the split pays only
// where the card idles. P C C P on NVIDIA H100 80GB HBM3, 700 W
// (tools/time_k5_bake.py; PERF.md), K5 at 4 lanes / at 1: 64x64 (32
// lists) 0.1880-0.1892 ms / 0.1971-0.1976; 128x128 (128 lists)
// 0.2581-0.2587 / 0.2577-0.2597, a tie, so 1 lane there; 256x256
// 0.278 / 0.260-0.263 and 512x512 0.322-0.326 / 0.277-0.280.
static int direction_lanes(long long blocks) { return 4 * blocks <= card_sms() ? 4 : 1; }

// lanes a ray of K5's tangent launch for the scene over `blocks` lists: a
// sweep's reverse_lanes, the mandelbulb's direction_lanes, else 1
static int tangent_lanes(const ParamScene& s, long long blocks) {
  if (sweep_form(s.form)) return reverse_lanes(blocks);
  return s.form == FORM_MANDELBULB ? direction_lanes(blocks) : 1;
}

// K5's partial sums for a scene: rows and their width (the loss and the
// gradient)
static void loss_grad_partials(const ParamScene& s, long long blocks, long long& rows,
                               int& stride) {
  if (s.form == FORM_REFERENCE) {
    rows = loss_grad_rows(blocks, s.n_prm > BSDMG_SHAPE_PARAMS);
    stride = tangents(s.n_prm) + 1;
    return;
  }
  // a sweep's reverse launch: a row a warp; the forms' lanes: a row a list,
  // or at 4 lanes a ray a row a ray
  if (sweep_form(s.form)) {
    rows = 4LL * reverse_grid(blocks);
  } else {
    rows = tangent_lanes(s, blocks) == 1 ? blocks : blocks * 128;
  }
  stride = s.n_slots + 1;
}

// floats of the large tier's scratch (ParamScene::scratch) for `threads`
// threads of a march: each thread's stack and frames, BSDMG_VALUE_WORDS floats a
// value (param_program.cuh); none for the other forms
static long long program_scratch(const ParamScene& s, long long threads) {
  if (s.form != FORM_PROGRAM_LARGE) return 0;
  return (long long)BSDMG_VALUE_WORDS * (s.program_depth + 3LL * s.program_frames) * threads;
}

// the same for `threads` threads of the reverse launch (loss_reverse_kernel):
// each thread's sweep (stack, frames and tape, BSDMG_SWEEP_WORDS floats a
// slot) and its parameters' adjoints
static long long sweep_scratch(const ParamScene& s, long long threads) {
  if (s.form != FORM_PROGRAM_LARGE) return 0;
  const long long slots =
      s.program_depth + 6LL * s.program_frames + 3LL * s.program_length / 2;
  return (BSDMG_SWEEP_WORDS * slots + s.n_slots) * threads;
}

// the scene with the large tier's scratch at `scratch`, for `threads` threads
static ParamScene with_scratch(const ParamScene& s, float* scratch, long long threads) {
  ParamScene out = s;
  if (s.form == FORM_PROGRAM_LARGE) {
    out.scratch = scratch;
    out.scratch_threads = static_cast<int>(threads);
  }
  return out;
}

// The instantiations are compiled in four units, so that they build in
// parallel: this file's (unit 0), diff_split.cu's (this file again, with
// BSDMG_DIFF_SECOND_UNIT defined; unit 1), which holds the near/far split's
// and the large tier's (ProgramLargeForm), diff_reverse.cu's (with
// BSDMG_DIFF_REVERSE_UNIT; unit 2), which holds the small tier's reverse
// launch (loss_reverse_kernel<ProgramForm, 1>, also the wrapped object's),
// and diff_lanes.cu's (with BSDMG_DIFF_LANES_UNIT; unit 3), every tangent
// launch at 4 lanes a ray: both tiers' reverse launch and the mandelbulb's
// directions. Each unit's dispatch instantiates only its own and answers
// OTHER_UNIT for the rest; loss_grad_sum, the last launch of every form,
// and the entries are unit 0's, which call the others'.
template <class F, bool Split>
struct DiffUnit
    : std::integral_constant<int, Split || std::is_same<F, ProgramLargeForm>::value ? 1 : 0> {};
// the unit of a form's tangent launches at 4 lanes a ray (Four) or 1: a
// sweep's are its program form's
template <class F, bool Four>
struct TangentUnit
    : std::integral_constant<
          int, Four ? 3
                    : (std::is_same<typename sweep_of<F>::type, ProgramForm>::value
                           ? 2
                           : DiffUnit<F, false>::value)> {};
#if defined(BSDMG_DIFF_LANES_UNIT)
constexpr int kUnit = 3;
#elif defined(BSDMG_DIFF_REVERSE_UNIT)
constexpr int kUnit = 2;
#elif defined(BSDMG_DIFF_SECOND_UNIT)
constexpr int kUnit = 1;
#else
constexpr int kUnit = 0;
#endif
constexpr int OTHER_UNIT = -1;

// g(Form{}, Split) for the scene's form and split where this unit holds the
// instantiation, else OTHER_UNIT; cudaErrorInvalidValue for a form that
// names none, or a split of another form than the reference one
template <class G>
static int with_launch(const ParamScene& s, G&& g) {
  if (s.split && s.form != FORM_REFERENCE) return cudaErrorInvalidValue;
  int err = cudaErrorInvalidValue;
  with_form(s.form, [&](auto form) {
    typedef decltype(form) F;
    if (s.split) {
      if constexpr (std::is_same<F, ReferenceForm>::value) {
        if constexpr (DiffUnit<F, true>::value == kUnit) {
          err = g(form, std::true_type{});
        } else {
          err = OTHER_UNIT;
        }
      }
    } else if constexpr (DiffUnit<F, false>::value == kUnit) {
      err = g(form, std::false_type{});
    } else {
      err = OTHER_UNIT;
    }
  });
  return err;
}

#define K4_HOST_PARAMS                                                                         \
  const ParamScene *scene, const float *origins, const float *directions, const float *cone,   \
      float *depth, int *steps, int *outcome, float *dfdt, float *min_m, float *t_min,         \
      float *scratch, int h, int w, void *stream
#define K4_HOST_ARGS \
  scene, origins, directions, cone, depth, steps, outcome, dfdt, min_m, t_min, scratch, h, w, stream
#define K5_LAUNCH_PARAMS                                                                       \
  const ParamScene *scene, const float *origins, const float *directions, const float *cone,   \
      const float *target, const float *t_state, float *partials, TangentRay *rays,            \
      int *counts, float *values, long long blocks, long long &rows, int stride, int h, int w, \
      float inv_denom_elems, float inv_pixels, float edge_weight, float edge_band,             \
      cudaStream_t st, int &launched
#define K5_LAUNCH_ARGS                                                                         \
  scene, origins, directions, cone, target, t_state, partials, rays, counts, values, blocks,   \
      rows, stride, h, w, inv_denom_elems, inv_pixels, edge_weight, edge_band, st, launched

// K4 of this unit's instantiations (bsdmg_march_params says what it takes)
static int march_params_in_unit(K4_HOST_PARAMS) {
  const dim3 grid((w + 15) / 16, (h + 7) / 8);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ParamScene s = with_scratch(*scene, scratch, loss_grad_blocks(h, w) * 128);
  return with_launch(s, [&](auto form, auto split) {
    typedef decltype(form) F;
    if constexpr (decltype(split)::value) {
      if (min_m != nullptr) {
        march_params_split_kernel<true><<<grid, 128, 0, st>>>(
            s, origins, directions, cone, depth, steps, outcome, dfdt, min_m, t_min, h, w);
      } else {
        march_params_split_kernel<false><<<grid, 128, 0, st>>>(
            s, origins, directions, cone, depth, steps, outcome, dfdt, min_m, t_min, h, w);
      }
    } else if (min_m != nullptr) {
      march_params_kernel<F, true><<<grid, 128, 0, st>>>(s, origins, directions, cone, depth,
                                                         steps, outcome, dfdt, min_m, t_min, h, w);
    } else {
      march_params_kernel<F, false><<<grid, 128, 0, st>>>(s, origins, directions, cone, depth,
                                                          steps, outcome, dfdt, min_m, t_min, h, w);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

// K5's first launch, the march and the lists, of this unit's
// instantiations, over the scene with its scratch attached (bsdmg_loss_grad
// lays the scratch out). Returns the cudaError_t of the launch.
static int loss_march_in_unit(K5_LAUNCH_PARAMS) {
  const dim3 grid((w + 15) / 16, (h + 7) / 8);
  return with_launch(*scene, [&](auto form, auto split) {
    typedef decltype(form) F;
    if constexpr (decltype(split)::value) {
      loss_march_split_kernel<F><<<grid, 128, 0, st>>>(*scene, origins, directions, cone, target,
                                                       t_state, rays, counts, values, h, w,
                                                       inv_denom_elems);
    } else {
      loss_march_kernel<F><<<grid, 128, 0, st>>>(*scene, origins, directions, cone, target,
                                                  t_state, rays, counts, values, h, w,
                                                  inv_denom_elems);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

// g(Form{}, lanes) for the scene's form where this unit holds its tangent
// launches, else OTHER_UNIT (with the split or without, the tangent
// launches are the form's); lanes, an integral_constant, 4 for a sweep's
// or the mandelbulb's launch at 4 lanes a ray (`four`, tangent_lanes),
// else 1; cudaErrorInvalidValue for a form that names none
template <class G>
static int with_tangent_launch(const ParamScene& s, bool four, G&& g) {
  int err = cudaErrorInvalidValue;
  with_form(s.form, [&](auto form) {
    typedef decltype(form) F;
    if constexpr (sweeps<F>::value || has_directions<F>::value) {
      if (four) {
        if constexpr (TangentUnit<F, true>::value == kUnit) {
          err = g(form, std::integral_constant<int, 4>{});
        } else {
          err = OTHER_UNIT;
        }
        return;
      }
    }
    if constexpr (TangentUnit<F, false>::value == kUnit) {
      err = g(form, std::integral_constant<int, 1>{});
    } else {
      err = OTHER_UNIT;
    }
  });
  return err;
}

// K5's tangent launches, of this unit's instantiations, into `partials`:
// `rows` rows of `stride` (set here for the reference form, whose launches'
// rows follow one another); `launched`, the instantiation launched, (kernel
// * 8 + form_id) * 8 + lanes a ray, kernel 0 for loss_tangent_kernel's
// launches (the reference form), 1 for loss_tangent_form_kernel, 2 for
// loss_reverse_kernel. Returns the cudaError_t of the first launch that
// failed, else 0.
static int loss_tangents_in_unit(K5_LAUNCH_PARAMS) {
  return with_tangent_launch(*scene, tangent_lanes(*scene, blocks) == 4, [&](auto form, auto lanes) {
    typedef decltype(form) F;
    if constexpr (std::is_same<F, ReferenceForm>::value) {
      // the wireframe at compile time; each launch's rows follow the last's
      const bool transform = scene->n_prm > BSDMG_SHAPE_PARAMS;
      const long long shape_rows = blocks * TangentLanes<SHAPE_LANES>::chunks;
      const long long translation_rows =
          scene->object_center >= 0 ? blocks * TangentLanes<TRANSLATION_LANES>::chunks : 0;
      const long long rotation_rows =
          scene->object_rotation >= 0 ? blocks * TangentLanes<ROTATION_LANES>::chunks : 0;
      rows = shape_rows + translation_rows + rotation_rows;
      const auto launch = [&](auto opt, auto lanes, long long row0, long long items) {
        loss_tangent_kernel<decltype(opt), decltype(lanes)::value>
            <<<tangent_grid(items), 128, 0, st>>>(*scene, origins, directions, cone, target,
                                                  t_state, rays, counts, values, partials, stride,
                                                  row0, blocks, inv_denom_elems, inv_pixels,
                                                  edge_weight, edge_band);
      };
      launched = (0 * 8 + FORM_REFERENCE) * 8 + 1;
      with_parts(scene->has_frame != 0, transform, [&](auto opt) {
        launch(opt, std::integral_constant<int, SHAPE_LANES>{}, 0, shape_rows);
        if (translation_rows > 0) {
          launch(opt, std::integral_constant<int, TRANSLATION_LANES>{}, shape_rows,
                 translation_rows);
        }
        if (rotation_rows > 0) {
          launch(opt, std::integral_constant<int, ROTATION_LANES>{},
                 shape_rows + translation_rows, rotation_rows);
        }
      });
    } else if constexpr (sweeps<F>::value) {
      // a composed scene's program, or the wrapped object's lowered one
      const int grid = reverse_grid(blocks);
      // the large tier's sweeps in the scratch buffer, a thread of this launch each
      const ParamScene sc = with_scratch(*scene, scene->scratch, 128LL * grid);
      typedef typename sweep_of<F>::type S;
      launched = (2 * 8 + form_id<S>()) * 8 + decltype(lanes)::value;
      loss_reverse_kernel<S, decltype(lanes)::value>
          <<<grid, 128, 0, st>>>(sc, origins, directions, cone, target, t_state, rays, counts,
                                 values, partials, stride, blocks, inv_denom_elems, inv_pixels,
                                 edge_weight, edge_band);
    } else {
      launched = (1 * 8 + form_id<F>()) * 8 + decltype(lanes)::value;
      loss_tangent_form_kernel<F, decltype(lanes)::value>
          <<<tangent_grid(blocks * decltype(lanes)::value), 128, 0, st>>>(
          *scene, origins, directions, cone, target, t_state, rays, counts, values, partials,
          stride, blocks, inv_denom_elems, inv_pixels, edge_weight, edge_band);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

#if defined(BSDMG_DIFF_SECOND_UNIT)

// diff_kernel.cu's entries for the instantiations of this unit
int march_params_second_unit(K4_HOST_PARAMS) { return march_params_in_unit(K4_HOST_ARGS); }
int loss_march_second_unit(K5_LAUNCH_PARAMS) { return loss_march_in_unit(K5_LAUNCH_ARGS); }
int loss_tangents_second_unit(K5_LAUNCH_PARAMS) { return loss_tangents_in_unit(K5_LAUNCH_ARGS); }

#elif defined(BSDMG_DIFF_REVERSE_UNIT)

int loss_tangents_reverse_unit(K5_LAUNCH_PARAMS) { return loss_tangents_in_unit(K5_LAUNCH_ARGS); }

#elif defined(BSDMG_DIFF_LANES_UNIT)

int loss_tangents_lanes_unit(K5_LAUNCH_PARAMS) { return loss_tangents_in_unit(K5_LAUNCH_ARGS); }

#else

int march_params_second_unit(K4_HOST_PARAMS);
int loss_march_second_unit(K5_LAUNCH_PARAMS);
int loss_tangents_second_unit(K5_LAUNCH_PARAMS);
int loss_tangents_reverse_unit(K5_LAUNCH_PARAMS);
int loss_tangents_lanes_unit(K5_LAUNCH_PARAMS);

extern "C" {

// floats of scratch that bsdmg_march_params needs for scene over an h x w
// image: the large tier's stacks, none for the other forms
long long bsdmg_march_params_scratch(const ParamScene* scene, int h, int w) {
  return program_scratch(*scene, loss_grad_blocks(h, w) * 128);
}

// Launches K4 on `stream` over an h x w image: origins and directions
// (h, w, 3), cone (h, w); depth, dfdt (float) and steps, outcome (int) are
// (h, w) planes, and min_m, t_min too when min_m is not null (track_min);
// scratch, bsdmg_march_params_scratch floats. The scene's `split` picks the
// near/far split (the reference form alone). Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a form that names none, or a split of
// another form).
int bsdmg_march_params(K4_HOST_PARAMS) {
  const int err = march_params_in_unit(K4_HOST_ARGS);
  return err == OTHER_UNIT ? march_params_second_unit(K4_HOST_ARGS) : err;
}

// floats of scratch that bsdmg_loss_grad needs for scene over an h x w
// image: the partial sums, the lists, and the large tier's stacks, for the
// march (a thread a pixel) or the reverse launch, whichever needs more
long long bsdmg_loss_grad_scratch(const ParamScene* scene, int h, int w) {
  const long long blocks = loss_grad_blocks(h, w);
  long long rows;
  int stride;
  loss_grad_partials(*scene, blocks, rows, stride);
  const long long march = program_scratch(*scene, blocks * 128);
  const long long sweep = sweep_scratch(*scene, 128LL * reverse_grid(blocks));
  return rows * stride + blocks * (128 * (sizeof(TangentRay) / sizeof(float)) + 2) +
         (march > sweep ? march : sweep);
}

// Launches K5 on `stream`: target (h, w, 3); t_state (h, w), or null for
// no edge term; scratch, bsdmg_loss_grad_scratch floats; out, n_slots + 1
// floats: the loss, then dL/dprm by slot (the wrapped object's private
// slots after the flat vector's, which the caller folds). The scene's
// `split` picks the near/far split of the march launch (the reference form
// alone). Three to five launches: the march and the lists
// (loss_march_kernel), the tangents (loss_tangent_kernel's shape,
// translation and rotation launches for the reference form,
// loss_reverse_kernel for a composed scene and the wrapped object,
// loss_tangent_form_kernel for the others, the loss alone for MeshGridForm,
// which reads no parameter), the sum over the blocks (loss_grad_sum, or
// loss_grad_sum_rays after the mandelbulb's 4 lanes a ray). made, 2 ints:
// the tangent instantiation launched (loss_tangents_in_unit's `launched`),
// then 1 where the sum was loss_grad_sum_rays, else 0. Returns the
// cudaError_t of the first launch that failed, else 0
// (cudaErrorInvalidValue for a form that names none).
int bsdmg_loss_grad(const ParamScene* scene, const float* origins, const float* directions,
                    const float* cone, const float* target, const float* t_state,
                    float* scratch, float* out, int h, int w, float inv_denom_elems,
                    float inv_pixels, float edge_weight, float edge_band, void* stream,
                    int* made) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long blocks = loss_grad_blocks(h, w);
  int launched = -1;
  long long rows;
  int stride;
  loss_grad_partials(*scene, blocks, rows, stride);
  float* partials = scratch;
  TangentRay* rays = reinterpret_cast<TangentRay*>(partials + rows * stride);
  int* counts = reinterpret_cast<int*>(rays + blocks * 128);
  float* values = reinterpret_cast<float*>(counts + blocks);
  // the launches read the scene with the large tier's stacks after the sums;
  // the march's a thread a pixel (the reverse launch sets its own threads)
  const ParamScene sc = with_scratch(*scene, values + blocks, blocks * 128);
  scene = &sc;
  int err = loss_march_in_unit(K5_LAUNCH_ARGS);
  if (err == OTHER_UNIT) err = loss_march_second_unit(K5_LAUNCH_ARGS);
  if (err != 0) return err;
  err = loss_tangents_in_unit(K5_LAUNCH_ARGS);
  if (err == OTHER_UNIT) err = loss_tangents_second_unit(K5_LAUNCH_ARGS);
  if (err == OTHER_UNIT) err = loss_tangents_reverse_unit(K5_LAUNCH_ARGS);
  if (err == OTHER_UNIT) err = loss_tangents_lanes_unit(K5_LAUNCH_ARGS);
  made[0] = launched;
  made[1] = 0;
  if (err != 0) return err;
  if (launched / 64 == 1 && launched % 8 == 4) {
    // a form's launch at 4 lanes a ray wrote a row a ray
    made[1] = 1;
    loss_grad_sum_rays<<<scene->n_slots + 1, 1024, 0, st>>>(partials, values, counts,
                                                          static_cast<int>(blocks), stride, out);
  } else {
    loss_grad_sum<<<scene->n_slots + 1, 256, 0, st>>>(partials, static_cast<int>(rows), stride,
                                                      out);
  }
  return static_cast<int>(cudaGetLastError());
}

int bsdmg_param_scene_size(void) { return static_cast<int>(sizeof(ParamScene)); }

}  // extern "C"

#endif  // the units
