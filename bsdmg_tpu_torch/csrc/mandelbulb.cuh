// The mandelbulb's distance estimator, which K1, K2, K3, K6 and K7 run for
// the mandelbulb scene (scene_sdf.cuh) and K4 and K5 for its parameter form
// (param_forms.cuh).

#pragma once

#include "dual.cuh"

// The mandelbulb's distance estimator 0.5 * log(r) * r / dr
// (sdf/primitives.py::sd_mandelbulb_c: power 7, 25 iterations, escape
// radius 2) at points already divided by the scale, for T float (the value)
// or a dual (the value and its derivatives; in K5 a dual of duals,
// nested_dual.cuh: DualOf<3, Dual<1>> for the gradient on one lane, or
// DualOf<1, Dual<1>> for one direction of it on each of a ray's lanes,
// whose loop takes the same iterations, set by the value alone). A point
// leaves the loop at its escape: its later
// iterations in the JAX package change nothing. Its min and max propagate
// a NaN, as the solid box's.
template <class T>
__device__ __forceinline__ T mandelbulb_de(const T& x, const T& y, const T& z) {
  T zx = x, zy = y, zz = z;
  T dr = Scalar<T>::constant(1.0f);
  T r = Scalar<T>::constant(0.0f);
#pragma unroll 1
  for (int i = 0; i < 25; ++i) {
    r = vsqrt((zx * zx + zy * zy) + zz * zz);
    if (!(value_of(r) <= 2.0f)) break;
    const T sr = vmaxn(r, 1e-12f);
    const T theta = vacos(vminn(vmaxn(zz / sr, -1.0f), 1.0f)) * 7.0f;
    const T phi = vatan2(zy, zx) * 7.0f;
    const T zr = vpow(sr, 7.0f);
    dr = (vpow(sr, 6.0f) * 7.0f) * dr + 1.0f;
    T st, ct, sp, cp;
    vsincos(theta, st, ct);
    vsincos(phi, sp, cp);
    zx = (zr * st) * cp + x;
    zy = (zr * sp) * st + y;
    zz = zr * ct + z;
  }
  const T sr = vmaxn(r, 1e-12f);
  return ((vlog(sr) * 0.5f) * r) / dr;
}

