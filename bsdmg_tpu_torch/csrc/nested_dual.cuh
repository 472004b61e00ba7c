// Duals of duals, for the spatial gradient of a scene's parameter form in
// K5 (param_forms.cuh): DualOf<3, Dual<L>> carries a value, its gradient
// with respect to the point (three tangents) and, in every one of those
// four, the tangents of the L parameters that a lane of K5 seeds. So one
// forward pass gives the normal and the normal's derivatives with respect
// to the parameters (forward over forward), which the reverse pass of the
// reference form (param_sdf.cuh scene_value_grad) gives there by hand. K5's
// reverse sweep of a composed scene (param_program.cuh) differentiates each
// instruction in DualOf<1, Dual<3>>: the direction of the gradient's
// adjoint outside, three of the instruction's inputs inside.
//
// The rules are dual.cuh's, applied to components of type C (a Dual<L>)
// in place of floats: JAX's JVPs, min and max weighting each operand by
// tie_weight (1/2 at a tie), abs +1 at 0, sqrt t * (0.5 / sqrt(x)), and
// the mandelbulb's libm rules. C is never a float here: a dual of floats
// is a Dual<N>. An operand of type C or float holds no tangent of the
// point. mod (jnp.mod) is here for every scalar type, and the max and min
// of two Dual<N> that propagate NaN.

#pragma once

#include "dual.cuh"

template <int N>
__device__ __forceinline__ Dual<N> vmaxn(const Dual<N>& a, const Dual<N>& b) {
  return chooser(a, b, vmaxn(a.v, b.v));
}

template <int N>
__device__ __forceinline__ Dual<N> vminn(const Dual<N>& a, const Dual<N>& b) {
  return chooser(a, b, vminn(a.v, b.v));
}

template <int N, class C>
struct DualOf {
  C v;
  C t[N];
};

template <int N, class C>
__device__ __forceinline__ float value_of(const DualOf<N, C>& x) {
  return value_of(x.v);
}

template <int N, class C>
struct Scalar<DualOf<N, C>> {
  __device__ __forceinline__ static DualOf<N, C> constant(float v) {
    DualOf<N, C> r;
    r.v = Scalar<C>::constant(v);
#pragma unroll
    for (int i = 0; i < N; ++i) r.t[i] = Scalar<C>::constant(0.0f);
    return r;
  }
};

// ---------------------------------------------------------------------------
// arithmetic; B is C or float, an operand without tangents of the point
// ---------------------------------------------------------------------------

template <int N, class C>
__device__ __forceinline__ DualOf<N, C> operator-(const DualOf<N, C>& a) {
  DualOf<N, C> r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = -a.t[i];
  return r;
}

template <int N, class C>
__device__ __forceinline__ DualOf<N, C> operator+(const DualOf<N, C>& a, const DualOf<N, C>& b) {
  DualOf<N, C> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] + b.t[i];
  return r;
}

template <int N, class C>
__device__ __forceinline__ DualOf<N, C> operator-(const DualOf<N, C>& a, const DualOf<N, C>& b) {
  DualOf<N, C> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] - b.t[i];
  return r;
}

template <int N, class C>
__device__ __forceinline__ DualOf<N, C> operator*(const DualOf<N, C>& a, const DualOf<N, C>& b) {
  DualOf<N, C> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] * b.v + a.v * b.t[i];
  return r;
}

template <int N, class C>
__device__ __forceinline__ DualOf<N, C> operator/(const DualOf<N, C>& a, const DualOf<N, C>& b) {
  DualOf<N, C> r;
  r.v = a.v / b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = (a.t[i] - r.v * b.t[i]) / b.v;
  return r;
}

// the same with one operand of type C, then with a float
#define BSDMG_NESTED_MIXED(B)                                                              \
  template <int N, class C>                                                                \
  __device__ __forceinline__ DualOf<N, C> operator+(const DualOf<N, C>& a, const B& b) {   \
    DualOf<N, C> r = a;                                                                    \
    r.v = a.v + b;                                                                         \
    return r;                                                                              \
  }                                                                                        \
  template <int N, class C>                                                                \
  __device__ __forceinline__ DualOf<N, C> operator+(const B& a, const DualOf<N, C>& b) {   \
    DualOf<N, C> r = b;                                                                    \
    r.v = a + b.v;                                                                         \
    return r;                                                                              \
  }                                                                                        \
  template <int N, class C>                                                                \
  __device__ __forceinline__ DualOf<N, C> operator-(const DualOf<N, C>& a, const B& b) {   \
    DualOf<N, C> r = a;                                                                    \
    r.v = a.v - b;                                                                         \
    return r;                                                                              \
  }                                                                                        \
  template <int N, class C>                                                                \
  __device__ __forceinline__ DualOf<N, C> operator-(const B& a, const DualOf<N, C>& b) {   \
    DualOf<N, C> r;                                                                        \
    r.v = a - b.v;                                                                         \
    for (int i = 0; i < N; ++i) r.t[i] = -b.t[i];                                          \
    return r;                                                                              \
  }                                                                                        \
  template <int N, class C>                                                                \
  __device__ __forceinline__ DualOf<N, C> operator*(const DualOf<N, C>& a, const B& b) {   \
    DualOf<N, C> r;                                                                        \
    r.v = a.v * b;                                                                         \
    for (int i = 0; i < N; ++i) r.t[i] = a.t[i] * b;                                       \
    return r;                                                                              \
  }                                                                                        \
  template <int N, class C>                                                                \
  __device__ __forceinline__ DualOf<N, C> operator*(const B& a, const DualOf<N, C>& b) {   \
    return b * a;                                                                          \
  }                                                                                        \
  template <int N, class C>                                                                \
  __device__ __forceinline__ DualOf<N, C> operator/(const DualOf<N, C>& a, const B& b) {   \
    DualOf<N, C> r;                                                                        \
    r.v = a.v / b;                                                                         \
    for (int i = 0; i < N; ++i) r.t[i] = a.t[i] / b;                                       \
    return r;                                                                              \
  }                                                                                        \
  template <int N, class C>                                                                \
  __device__ __forceinline__ DualOf<N, C> operator/(const B& a, const DualOf<N, C>& b) {   \
    DualOf<N, C> r;                                                                        \
    r.v = a / b.v;                                                                         \
    for (int i = 0; i < N; ++i) r.t[i] = -(r.v * b.t[i]) / b.v;                            \
    return r;                                                                              \
  }                                                                                        \
  /* min or max of a and b whose value is z */                                             \
  template <int N, class C>                                                                \
  __device__ __forceinline__ DualOf<N, C> chooser(const DualOf<N, C>& a, const B& b,       \
                                                  const C& z) {                            \
    const float wa = tie_weight(value_of(a), value_of(z), value_of(b));                    \
    DualOf<N, C> r;                                                                        \
    r.v = z;                                                                               \
    for (int i = 0; i < N; ++i) r.t[i] = a.t[i] * wa;                                      \
    return r;                                                                              \
  }                                                                                        \
  template <int N, class C>                                                                \
  __device__ __forceinline__ DualOf<N, C> vmin(const DualOf<N, C>& a, const B& b) {        \
    return chooser(a, b, vmin(a.v, b));                                                    \
  }                                                                                        \
  template <int N, class C>                                                                \
  __device__ __forceinline__ DualOf<N, C> vmax(const DualOf<N, C>& a, const B& b) {        \
    return chooser(a, b, vmax(a.v, b));                                                    \
  }                                                                                        \
  template <int N, class C>                                                                \
  __device__ __forceinline__ DualOf<N, C> vmaxn(const DualOf<N, C>& a, const B& b) {       \
    return chooser(a, b, vmaxn(a.v, b));                                                   \
  }                                                                                        \
  template <int N, class C>                                                                \
  __device__ __forceinline__ DualOf<N, C> vminn(const DualOf<N, C>& a, const B& b) {       \
    return chooser(a, b, vminn(a.v, b));                                                   \
  }

BSDMG_NESTED_MIXED(C)
BSDMG_NESTED_MIXED(float)
#undef BSDMG_NESTED_MIXED

// ---------------------------------------------------------------------------
// min, max, abs, sqrt
// ---------------------------------------------------------------------------

template <int N, class C>
__device__ __forceinline__ DualOf<N, C> chooser(const DualOf<N, C>& a, const DualOf<N, C>& b,
                                                const C& z) {
  const float wa = tie_weight(value_of(a), value_of(z), value_of(b));
  const float wb = tie_weight(value_of(b), value_of(z), value_of(a));
  DualOf<N, C> r;
  r.v = z;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] * wa + b.t[i] * wb;
  return r;
}

template <int N, class C>
__device__ __forceinline__ DualOf<N, C> vmin(const DualOf<N, C>& a, const DualOf<N, C>& b) {
  return chooser(a, b, vmin(a.v, b.v));
}

template <int N, class C>
__device__ __forceinline__ DualOf<N, C> vmax(const DualOf<N, C>& a, const DualOf<N, C>& b) {
  return chooser(a, b, vmax(a.v, b.v));
}

template <int N, class C>
__device__ __forceinline__ DualOf<N, C> vminn(const DualOf<N, C>& a, const DualOf<N, C>& b) {
  return chooser(a, b, vminn(a.v, b.v));
}

template <int N, class C>
__device__ __forceinline__ DualOf<N, C> vmaxn(const DualOf<N, C>& a, const DualOf<N, C>& b) {
  return chooser(a, b, vmaxn(a.v, b.v));
}

template <int N, class C>
__device__ __forceinline__ DualOf<N, C> vabs(const DualOf<N, C>& a) {
  return value_of(a) >= 0.0f ? a : -a;
}

// the value v with the tangents of a times w: a unary rule whose
// derivative at a.v is w
template <int N, class C>
__device__ __forceinline__ DualOf<N, C> scaled(const DualOf<N, C>& a, const C& v, const C& w) {
  DualOf<N, C> r;
  r.v = v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] * w;
  return r;
}

template <int N, class C>
__device__ __forceinline__ DualOf<N, C> vsqrt(const DualOf<N, C>& a) {
  const C v = vsqrt(a.v);
  return scaled(a, v, 0.5f / v);
}

// sqrt as the parameter forms take it: a tangent that is 0 stays 0 where
// the weight 0.5 / sqrt(x) is infinite (x = 0). The twins' reverse mode
// (torch autograd) meets that infinity too, at a box's outside distance
// inside the box, but selects it away at the max below it (torch.maximum's
// and torch.where's backward select, where JAX's JVP multiplies by the
// weight 0); forward mode meets it as 0 * inf, which this keeps 0.
__device__ __forceinline__ bool is_zero(float x) { return x == 0.0f; }

template <int N>
__device__ __forceinline__ bool is_zero(const Dual<N>& x) {
  bool zero = x.v == 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) zero = zero && x.t[i] == 0.0f;
  return zero;
}

__device__ __forceinline__ float psqrt(float a) { return sqrtf(a); }

template <int N>
__device__ __forceinline__ Dual<N> psqrt(const Dual<N>& a) {
  Dual<N> r;
  r.v = sqrtf(a.v);
  const float w = 0.5f / r.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] == 0.0f ? 0.0f : a.t[i] * w;
  return r;
}

template <int N, class C>
__device__ __forceinline__ DualOf<N, C> psqrt(const DualOf<N, C>& a) {
  DualOf<N, C> r;
  r.v = psqrt(a.v);
  const C w = 0.5f / r.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = is_zero(a.t[i]) ? Scalar<C>::constant(0.0f) : a.t[i] * w;
  return r;
}

// ---------------------------------------------------------------------------
// libm: acos, atan2, pow, sin and cos, log (the mandelbulb)
// ---------------------------------------------------------------------------

template <int N, class C>
__device__ __forceinline__ DualOf<N, C> vacos(const DualOf<N, C>& a) {
  return scaled(a, vacos(a.v), -(1.0f / vsqrt(1.0f - a.v * a.v)));
}

template <int N, class C>
__device__ __forceinline__ DualOf<N, C> vatan2(const DualOf<N, C>& y, const DualOf<N, C>& x) {
  const C den = x.v * x.v + y.v * y.v;
  const C wy = x.v / den, wx = -y.v / den;
  DualOf<N, C> r;
  r.v = vatan2(y.v, x.v);
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = y.t[i] * wy + x.t[i] * wx;
  return r;
}

template <int N, class C>
__device__ __forceinline__ DualOf<N, C> vpow(const DualOf<N, C>& a, float p) {
  return scaled(a, vpow(a.v, p), p * vpow(a.v, p - 1.0f));
}

template <int N, class C>
__device__ __forceinline__ DualOf<N, C> vlog(const DualOf<N, C>& a) {
  return scaled(a, vlog(a.v), 1.0f / a.v);
}

template <int N, class C>
__device__ __forceinline__ void vsincos(const DualOf<N, C>& a, DualOf<N, C>& s, DualOf<N, C>& c) {
  C sv, cv;
  vsincos(a.v, sv, cv);
  s = scaled(a, sv, cv);
  c = scaled(a, cv, -sv);
}

// ---------------------------------------------------------------------------
// jnp.mod
// ---------------------------------------------------------------------------

// x with its innermost value replaced by m, every tangent kept
__device__ __forceinline__ float with_value(float, float m) { return m; }

template <int N>
__device__ __forceinline__ Dual<N> with_value(Dual<N> x, float m) {
  x.v = m;
  return x;
}

template <int N, class C>
__device__ __forceinline__ DualOf<N, C> with_value(DualOf<N, C> x, float m) {
  x.v = with_value(x.v, m);
  return x;
}

// jnp.mod(a, y): the value fmod(a, y), plus y where the remainder's sign
// differs from y's (torch.remainder's bits); the tangents JAX's: lax.rem's
// da - dy * trunc(a / y) of the rounded quotient, plus dy where y was added.
// Locally mod is a + y * (plus - trunc(a / y)), whose tangents these are.
template <class T, class P>
__device__ __forceinline__ T vmod(const T& a, const P& y) {
  const float av = value_of(a), yv = value_of(y);
  float m = fmodf(av, yv);
  const bool plus = m != 0.0f && ((m < 0.0f) != (yv < 0.0f));
  if (plus) m += yv;
  return with_value(a + y * ((plus ? 1.0f : 0.0f) - truncf(av / yv)), m);
}
