// Forward-mode dual numbers for the fused loss + gradient kernel (K5,
// diff_kernel.cu), and the scalar helpers the shared device code is written
// in, so that one template serves float and Dual<N>.
//
// A Dual<N> carries a float value and N tangents. K5 seeds parameter slot i
// with the unit tangent e_i, so every value computed from the parameters
// carries its derivative with respect to each of them. The rules follow
// JAX's JVPs (the reference differentiates the same expressions):
// min and max give each operand the weight tie_weight gives it, 1/2 at a tie
// (lax._balanced_eq); abs passes +1 at 0 (jax.grad(jnp.abs)(0.0) is 1.0 on
// JAX 0.9); sqrt's tangent is t * (0.5 / sqrt(x)). The libm rules below
// (acos, atan2, pow, sin and cos, log) serve the mandelbulb's gradient
// (scene_sdf.cuh); each has a float overload, so one template computes the
// value and the value with its tangents.

#pragma once

#include <cuda_runtime.h>

// JAX's weight of operand x of min(x, y) or max(x, y) whose result is z
// (lax._balanced_eq): 1 if x alone attains z, 1/2 at a tie, else 0
__device__ __forceinline__ float tie_weight(float x, float z, float y) {
  return (x == z ? 1.0f : 0.0f) / (y == z ? 2.0f : 1.0f);
}

__device__ __forceinline__ float value_of(float x) { return x; }
__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ float vabs(float a) { return fabsf(a); }
__device__ __forceinline__ float vsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ float vrsqrt(float a) { return rsqrtf(a); }
// max and min that return NaN when either operand is NaN (PTX max.NaN,
// sm_80 on), as torch.maximum, torch.clamp and XLA's max do; fmaxf and
// fminf return the other operand. The reference scenes never meet a NaN;
// the box's and the mandelbulb's gradients can be NaN, and a Newton step
// then carries it into the next evaluation.
__device__ __forceinline__ float vmaxn(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float vminn(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float vacos(float a) { return acosf(a); }
__device__ __forceinline__ float vatan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ float vpow(float a, float p) { return powf(a, p); }
__device__ __forceinline__ float vlog(float a) { return logf(a); }
__device__ __forceinline__ void vsincos(float a, float& s, float& c) { sincosf(a, &s, &c); }

template <int N>
struct Dual {
  float v;
  float t[N];
};

// Scalar<T>::constant(v) is v as a T; Scalar<T>::placed(v, place, block)
// is v with the unit tangent of parameter `place` in a lane that carries
// block `block` of the parameters' tangents (no tangent for float)
template <class T>
struct Scalar;

template <>
struct Scalar<float> {
  __device__ __forceinline__ static float constant(float v) { return v; }
  __device__ __forceinline__ static float placed(float v, int, int) { return v; }
};

template <int N>
struct Scalar<Dual<N>> {
  __device__ __forceinline__ static Dual<N> constant(float v) {
    Dual<N> r;
    r.v = v;
#pragma unroll
    for (int i = 0; i < N; ++i) r.t[i] = 0.0f;
    return r;
  }
  // the lane carries the tangents of places block * N .. block * N + N - 1:
  // the unit tangent at place % N when place / N is the block. With `place`
  // a constant, the component is one too, so a lane's seeds are a few
  // compares of `block`, not one a component.
  __device__ __forceinline__ static Dual<N> placed(float v, int place, int block) {
    Dual<N> r;
    r.v = v;
#pragma unroll
    for (int i = 0; i < N; ++i) r.t[i] = i == place % N && block == place / N ? 1.0f : 0.0f;
    return r;
  }
};

template <int N>
__device__ __forceinline__ float value_of(const Dual<N>& x) { return x.v; }

// x, as a value the compiler cannot see through: what is computed from it
// is computed again, not held in registers from an earlier computation
template <int N>
__device__ __forceinline__ Dual<N> opaque(Dual<N> x) {
  asm volatile("" : "+f"(x.v));
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x.t[i]));
  return x;
}

// ---------------------------------------------------------------------------
// arithmetic
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a) {
  Dual<N> r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = -a.t[i];
  return r;
}

template <int N>
__device__ __forceinline__ Dual<N> operator+(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] + b.t[i];
  return r;
}

template <int N>
__device__ __forceinline__ Dual<N> operator+(const Dual<N>& a, float b) {
  Dual<N> r = a;
  r.v = a.v + b;
  return r;
}

template <int N>
__device__ __forceinline__ Dual<N> operator+(float a, const Dual<N>& b) {
  Dual<N> r = b;
  r.v = a + b.v;
  return r;
}

template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] - b.t[i];
  return r;
}

template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a, float b) {
  Dual<N> r = a;
  r.v = a.v - b;
  return r;
}

template <int N>
__device__ __forceinline__ Dual<N> operator-(float a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = -b.t[i];
  return r;
}

template <int N>
__device__ __forceinline__ Dual<N> operator*(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] * b.v + a.v * b.t[i];
  return r;
}

template <int N>
__device__ __forceinline__ Dual<N> operator*(const Dual<N>& a, float b) {
  Dual<N> r;
  r.v = a.v * b;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] * b;
  return r;
}

template <int N>
__device__ __forceinline__ Dual<N> operator*(float a, const Dual<N>& b) {
  return b * a;
}

// d(a/b) = (da - (a/b) db) / b
template <int N>
__device__ __forceinline__ Dual<N> operator/(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v / b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = (a.t[i] - r.v * b.t[i]) / b.v;
  return r;
}

template <int N>
__device__ __forceinline__ Dual<N> operator/(const Dual<N>& a, float b) {
  Dual<N> r;
  r.v = a.v / b;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] / b;
  return r;
}

template <int N>
__device__ __forceinline__ Dual<N> operator/(float a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a / b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = -(r.v * b.t[i]) / b.v;
  return r;
}

// ---------------------------------------------------------------------------
// min, max, abs, sqrt
// ---------------------------------------------------------------------------

// min or max of a and b whose value is z, with JAX's tangent weights
template <int N>
__device__ __forceinline__ Dual<N> chooser(const Dual<N>& a, const Dual<N>& b, float z) {
  const float wa = tie_weight(a.v, z, b.v);
  const float wb = tie_weight(b.v, z, a.v);
  Dual<N> r;
  r.v = z;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] * wa + b.t[i] * wb;
  return r;
}

template <int N>
__device__ __forceinline__ Dual<N> chooser(const Dual<N>& a, float b, float z) {
  const float wa = tie_weight(a.v, z, b);
  Dual<N> r;
  r.v = z;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] * wa;
  return r;
}

template <int N>
__device__ __forceinline__ Dual<N> vmin(const Dual<N>& a, const Dual<N>& b) {
  return chooser(a, b, fminf(a.v, b.v));
}

template <int N>
__device__ __forceinline__ Dual<N> vmin(const Dual<N>& a, float b) {
  return chooser(a, b, fminf(a.v, b));
}

template <int N>
__device__ __forceinline__ Dual<N> vmin(float a, const Dual<N>& b) {
  return chooser(b, a, fminf(a, b.v));
}

template <int N>
__device__ __forceinline__ Dual<N> vmax(const Dual<N>& a, const Dual<N>& b) {
  return chooser(a, b, fmaxf(a.v, b.v));
}

template <int N>
__device__ __forceinline__ Dual<N> vmax(const Dual<N>& a, float b) {
  return chooser(a, b, fmaxf(a.v, b));
}

template <int N>
__device__ __forceinline__ Dual<N> vmax(float a, const Dual<N>& b) {
  return chooser(b, a, fmaxf(a, b.v));
}

// the NaN-propagating max and min of a dual and a constant
template <int N>
__device__ __forceinline__ Dual<N> vmaxn(const Dual<N>& a, float b) {
  return chooser(a, b, vmaxn(a.v, b));
}

template <int N>
__device__ __forceinline__ Dual<N> vminn(const Dual<N>& a, float b) {
  return chooser(a, b, vminn(a.v, b));
}

template <int N>
__device__ __forceinline__ Dual<N> vabs(const Dual<N>& a) {
  return a.v >= 0.0f ? a : -a;
}

template <int N>
__device__ __forceinline__ Dual<N> vsqrt(const Dual<N>& a) {
  Dual<N> r;
  r.v = sqrtf(a.v);
  const float w = 0.5f / r.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] * w;
  return r;
}

// d rsqrt(x) = dx * (-0.5 * rsqrt(x) / x)
template <int N>
__device__ __forceinline__ Dual<N> vrsqrt(const Dual<N>& a) {
  Dual<N> r;
  r.v = rsqrtf(a.v);
  const float w = -0.5f * (r.v / a.v);
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] * w;
  return r;
}

// ---------------------------------------------------------------------------
// libm: acos, atan2, pow, sin and cos, log
// ---------------------------------------------------------------------------

// the value v with the tangents of a times w: a unary rule whose
// derivative at a.v is w
template <int N>
__device__ __forceinline__ Dual<N> scaled(const Dual<N>& a, float v, float w) {
  Dual<N> r;
  r.v = v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] * w;
  return r;
}

// d acos(x) = dx * -(1 / sqrt(1 - x^2)): JAX's -rsqrt(1 - x^2), with the
// correctly rounded sqrt and division of the plain twin
template <int N>
__device__ __forceinline__ Dual<N> vacos(const Dual<N>& a) {
  return scaled(a, acosf(a.v), -(1.0f / sqrtf(1.0f - a.v * a.v)));
}

// d atan2(y, x) = dy * (x / (x^2 + y^2)) + dx * (-y / (x^2 + y^2))
template <int N>
__device__ __forceinline__ Dual<N> vatan2(const Dual<N>& y, const Dual<N>& x) {
  const float den = x.v * x.v + y.v * y.v;
  const float wy = x.v / den, wx = -y.v / den;
  Dual<N> r;
  r.v = atan2f(y.v, x.v);
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = y.t[i] * wy + x.t[i] * wx;
  return r;
}

// d x^p = dx * (p * x^(p - 1)), p a constant
template <int N>
__device__ __forceinline__ Dual<N> vpow(const Dual<N>& a, float p) {
  return scaled(a, powf(a.v, p), p * powf(a.v, p - 1.0f));
}

// d log(x) = dx * (1 / x)
template <int N>
__device__ __forceinline__ Dual<N> vlog(const Dual<N>& a) {
  return scaled(a, logf(a.v), 1.0f / a.v);
}

// d sin(x) = dx * cos(x), d cos(x) = dx * -sin(x)
template <int N>
__device__ __forceinline__ void vsincos(const Dual<N>& a, Dual<N>& s, Dual<N>& c) {
  float sv, cv;
  sincosf(a.v, &sv, &cv);
  s = scaled(a, sv, cv);
  c = scaled(a, cv, -sv);
}
