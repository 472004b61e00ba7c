// The parameter forms of K4 and K5 (diff_kernel.cu): what each kernel
// evaluates of a scene, for every scene the image fit takes.
//
// A form is a compile-time structure, as K1's scene structure S is
// (scene_sdf.cuh with_structure); diff_kernel.cu's with_form turns
// ParamScene::form into it. Each gives
//   March, march_scene(s): what the march computes once before its loop;
//   march_value(s, m, x): the SDF in float32, the twin's operations in its
//     order, so that K4's march equals its twin's bit for bit;
//   value<T, P>(s, prm, x): the SDF at a point of scalar type T from the
//     parameters as P (param_program.cuh Prm);
// and the kernels derive the rest from value: dfdt (ray_derivative, Dual<1>
// whose point carries the ray's direction) and, in K5's tangent lanes, the
// value in Dual<L> and the spatial gradient with its parameter tangents,
// forward over forward in DualOf<3, Dual<L>> (value_grad), or, for a form
// with `directions`, one spatial direction a lane in DualOf<1, Dual<L>>
// (diff_kernel.cu DirectionEval). A form with a `Sweep` has K5 sweep that
// form's parameter program in reverse instead (param_program.cuh): a
// composed scene's own, and the wrapped object's lowered on the host.
//
// ReferenceForm is the reference scenes' form of param_sdf.cuh, unchanged:
// its march form (MarchScene), its dfdt and its hand-written reverse-mode
// gradient, with K5's lanes over the shape and the transform. The others
// take the flat parameter vector ParamScene::prm and K5's generic lanes:
//   SphereForm: bsdmg_tpu/models/scenes.py sphere_scene (radius, slot 0);
//   MandelbulbForm: mandelbulb_scene, sd_mandelbulb_c(x / s) * s with
//     s = scale * 0.4 (scale, slot 0), mandelbulb.cuh; its K5 lanes may
//     take a ray's three spatial directions apart (directions);
//   WrappedForm: wrapped_object_scene, each coordinate wrapped as
//     -half + mod(x + half, cell) with half = cell / 2, then the reference
//     object and its transform (param_sdf.cuh scene_value, AnyParts), in
//     its march and dfdt; K5's tangent launch sweeps the same function as
//     the parameter program wrap(transform(smooth_union(skeleton, sphere)))
//     (Sweep, csdf.py wrapped_param_program), whose value is this one's
//     bit for bit;
//   ProgramForm: a composed scene, its parameter program
//     (param_program.cuh), within the small tier's caps;
//   ProgramLargeForm: the same beyond them (the large tier: the values
//     and the stacks in device memory, param_program.cuh);
//   MeshGridForm: a mesh asset's baked grid, bsdmg_tpu/models/mesh_sdf.py
//     grid_csdf (the "weights" interpolation, grid_sdf.cuh grid_scene), the
//     table ParamScene::grid_table read as data: its Scene.csdf reads no
//     parameter, so its gradient is zero and K5 takes no tangent
//     (diff_kernel.cu loss_tangent_form_kernel takes each listed ray's
//     loss alone, in float, through MeshGridForm::Eval). Its march value
//     is grid_scene's
//     value; its dfdt is grid_scene's gradient (jax.vjp written out) dotted
//     with the ray's direction, as the twin's autograd takes it, so no dual
//     number meets the table's gathers.
// Twins: models/scenes.py SphereCsdf, MandelbulbCsdf, WrappedCsdf,
// models/compose.py ComposedCsdf, models/mesh_sdf.py GridCsdf.

#pragma once

#include "mandelbulb.cuh"
#include "param_program.cuh"

// The reference form; far_march_value and far_dfdt are its wireframe
// alone, the far scene of the near/far split (diff_kernel.cu)
struct ReferenceForm {
  typedef MarchScene March;
  static __device__ __forceinline__ March march_scene(const ParamScene& s) {
    return ::march_scene(s);
  }
  static __device__ __forceinline__ float march_value(const ParamScene&, const March& m,
                                                      const float x[3]) {
    return ::march_value(m, x);
  }
  static __device__ __forceinline__ float far_march_value(const ParamScene&, const March& m,
                                                          const float x[3]) {
    return ::far_march_value(m, x);
  }
  // the wireframe's derivative along d at o + t d: its forward pass in
  // Dual<1> whose point carries the tangent d
  static __device__ __forceinline__ float far_dfdt(const ParamScene& s, const float o[3],
                                                   const float d[3], float t) {
    Dual<1> x[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      x[a].v = o[a] + t * d[a];
      x[a].t[0] = d[a];
    }
    SkeletonFwd<Dual<1>> f;
    return frame_fwd(s, x, f).t[0];
  }
};

// the forms whose march evaluates value<float, float> and needs nothing
// computed before its loop; `device` is whether the form reads the
// parameter values from device memory (Prm<P, true>)
template <class F>
struct PlainMarch {
  static constexpr bool device = false;
  struct March {};
  static __device__ __forceinline__ March march_scene(const ParamScene&) { return March{}; }
  static __device__ __forceinline__ float march_value(const ParamScene& s, const March&,
                                                      const float x[3]) {
    return F::value(s, Prm<float, F::device>{&s, 0}, x);
  }
};

struct SphereForm : PlainMarch<SphereForm> {
  template <class T, class P>
  static __device__ __forceinline__ T value(const ParamScene&, const Prm<P>& prm, const T x[3]) {
    // sd_sphere_c at centre 0: x - 0 is x, bit for bit
    return vsqrt((x[0] * x[0] + x[1] * x[1]) + x[2] * x[2]) - prm(0);
  }
};

struct MandelbulbForm : PlainMarch<MandelbulbForm> {
  // K5's tangent launch may give a ray's spatial directions a lane each
  static constexpr bool directions = true;
  template <class T, class P>
  static __device__ __forceinline__ T value(const ParamScene&, const Prm<P>& prm, const T x[3]) {
    const P s = prm(0) * 0.4f;
    return mandelbulb_de<T>(x[0] / s, x[1] / s, x[2] / s) * s;
  }
};

struct ProgramForm : PlainMarch<ProgramForm> {
  typedef ProgramForm Sweep;
  template <class T, class P>
  static __device__ __forceinline__ T value(const ParamScene& s, const Prm<P>& prm, const T x[3]) {
    return program_value(s, prm, x);
  }
};

struct ProgramLargeForm : PlainMarch<ProgramLargeForm> {
  static constexpr bool device = true;
  typedef ProgramLargeForm Sweep;
  template <class T, class P>
  static __device__ __forceinline__ T value(const ParamScene& s, const Prm<P, true>& prm,
                                            const T x[3]) {
    return program_value(s, prm, x);
  }
};

// the reference object's parameters from their slots (load_params reads
// them at the reference form's fixed places)
template <class P>
__device__ __forceinline__ ObjectParams<P> slot_params(const ParamScene& s, const Prm<P>& prm) {
  ObjectParams<P> p;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    p.center[a] = prm(s.skeleton_center + a);
    p.size[a] = prm(s.skeleton_size + a);
  }
  p.line_width = prm(s.skeleton_line_width);
  p.radius = prm(s.sphere_radius);
  p.k = prm(s.smooth_k);
  if (AnyParts::translation(s)) {
#pragma unroll
    for (int a = 0; a < 3; ++a) p.translation[a] = prm(s.object_center + a);
  }
  if (AnyParts::rotation(s)) {
#pragma unroll
    for (int a = 0; a < 4; ++a) p.rotation[a] = prm(s.object_rotation + a);
  }
  return p;
}

struct WrappedForm {
  static constexpr bool device = false;
  // K5's tangent launch: the lowered program's reverse sweep, its private
  // slots (the cell's three copies, the sphere's pinned centre, an absent
  // transform part) after the flat vector in prm
  typedef ProgramForm Sweep;
  template <class T, class P>
  static __device__ __forceinline__ void wrap(const ParamScene& s, const Prm<P>& prm, const T x[3],
                                              T w[3]) {
    const P cell = prm(s.cell);
    const P half = cell / 2.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) w[a] = -half + vmod(x[a] + half, cell);
  }
  // the reference object's march form at the wrapped point
  typedef MarchScene March;
  static __device__ __forceinline__ March march_scene(const ParamScene& s) {
    return ::march_scene(s);
  }
  static __device__ __forceinline__ float march_value(const ParamScene& s, const March& m,
                                                      const float x[3]) {
    float w[3];
    wrap(s, Prm<float>{&s, 0}, x, w);
    return ::march_value(m, w);
  }
  template <class T, class P>
  static __device__ __forceinline__ T value(const ParamScene& s, const Prm<P>& prm, const T x[3]) {
    T w[3];
    wrap(s, prm, x, w);
    return scene_value<AnyParts>(s, slot_params(s, prm), w);
  }
};

// the grid at a point with no offset: its value, and with Grad its gradient
template <bool Grad>
__device__ __forceinline__ float mesh_grid_value(const ParamScene& s, const float x[3],
                                                 float g[3]) {
  const float no_offset[3] = {0.0f, 0.0f, 0.0f};
  return grid_scene<GRID_WEIGHTS, Grad>(s.grid_table, s.grid, no_offset, x[0], x[1], x[2], g[0],
                                        g[1], g[2]);
}

struct MeshGridForm {
  struct March {};
  static __device__ __forceinline__ March march_scene(const ParamScene&) { return March{}; }
  static __device__ __forceinline__ float march_value(const ParamScene& s, const March&,
                                                      const float x[3]) {
    float g[3];
    return mesh_grid_value<false>(s, x, g);
  }
  // d/dt f(o + t d): the gradient dotted with d in the twin's order
  static __device__ __forceinline__ float ray_derivative(const ParamScene& s, const float o[3],
                                                         const float d[3], float t) {
    const float x[3] = {o[0] + t * d[0], o[1] + t * d[1], o[2] + t * d[2]};
    float g[3];
    mesh_grid_value<true>(s, x, g);
    return (g[0] * d[0] + g[1] * d[1]) + g[2] * d[2];
  }
  // the scene as K5's ray_loss evaluates it, in float: no parameter
  // carries a tangent
  struct Eval {
    const ParamScene& s;
    __device__ __forceinline__ float value(const float x[3]) const {
      float g[3];
      return mesh_grid_value<false>(s, x, g);
    }
    __device__ __forceinline__ void grad(const float x[3], float g[3]) const {
      mesh_grid_value<true>(s, x, g);
    }
  };
};

// the form's SDF along d at o + t d, parameters as floats: a forward pass
// in Dual<1> whose point carries the tangent d (K4's dfdt, K5's IFT
// denominator)
template <class Form>
__device__ __forceinline__ float form_ray_derivative(const ParamScene& s, const float o[3],
                                                     const float d[3], float t) {
  Dual<1> x[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    x[a].v = o[a] + t * d[a];
    x[a].t[0] = d[a];
  }
  return Form::value(s, Prm<float, Form::device>{&s, 0}, x).t[0];
}

// the form's spatial gradient at x with the parameter tangents of C (a
// Dual<L>): one forward pass in DualOf<3, C> whose point carries the unit
// tangents of x, y and z
template <class Form, class C, bool D>
__device__ __forceinline__ void form_value_grad(const ParamScene& s, const Prm<C, D>& prm,
                                                const C x[3], C g[3]) {
  DualOf<3, C> p[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    p[a].v = x[a];
#pragma unroll
    for (int b = 0; b < 3; ++b) p[a].t[b] = Scalar<C>::constant(a == b ? 1.0f : 0.0f);
  }
  const DualOf<3, C> f = Form::value(s, prm, p);
#pragma unroll
  for (int a = 0; a < 3; ++a) g[a] = f.t[a];
}
