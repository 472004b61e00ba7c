// The interpreter of a composed scene's parameter program, the scene that
// K4 and K5 (diff_kernel.cu) evaluate for a JSON spec (models/compose.py).
// Replaces the param-traced closure that the JAX package traces into its
// Pallas kernels (bsdmg_tpu/models/compose.py _eval).
//
// ops/cuda/csdf.py::param_program flattens the spec into the node
// program's postfix order (program.cuh, composed.cuh), but where the node
// program holds constants baked in float64, each instruction here names
// the slots of its fields in the flat parameter vector: opcode, operand
// index, three slots, reference_compat (BSDMG_PARAM_WORDS words, device
// memory). Every derived value (a box skeleton's low corner, a capsule's
// segment and squared length, a plane's rsqrt, a rotation's matrix, a
// wrap's half cell) is derived from the parameter values on every call, in
// float32 and in _eval's operation order, so the value is the spec's
// component form bit for bit; a fold pops two values and pushes one, a
// push and a pop enter and leave a coordinate frame.
//
// It is a template over the scalar T of the point and the values and the
// type P of the parameters (param_forms.cuh Prm): float in the march,
// Dual<1> with the ray's direction for dfdt, Dual<L> in K5's tangent lanes
// and DualOf<3, Dual<L>> (nested_dual.cuh) for the normal and its
// parameter tangents. min and max propagate NaN (vmaxn), as torch.maximum
// does; sqrt is psqrt (nested_dual.cuh), whose tangents agree with the
// twins' reverse mode inside a box. Twin: csdf.py::param_program_csdf.
//
// ProgramForm (param_forms.cuh) is the small tier: the parameter values in
// ParamScene::prm, the stacks in local arrays of program.cuh's caps.
// ProgramLargeForm is the large tier, for any program and any number of
// values: the values in device memory (ParamScene::prm_values) and the
// stacks in the scratch buffer ParamScene::scratch (program.cuh
// SpilledSlots), whose T values take up to BSDMG_VALUE_WORDS slots each.

#pragma once

#include "nested_dual.cuh"
#include "param_sdf.cuh"
#include "program.cuh"

#define BSDMG_PARAM_WORDS 8  // csdf.py PARAM_WORDS
#define BSDMG_VALUE_WORDS 8  // floats of the widest value, K5's DualOf<3, Dual<1>>

static_assert(sizeof(DualOf<3, Dual<1>>) == BSDMG_VALUE_WORDS * sizeof(float),
              "the large tier's slots of a value");

// The parameter values as P: s.prm[slot], or with Device (the large tier)
// s.prm_values[slot], with the unit tangent of slot in a lane that carries
// block `block` of the tangents (Scalar<P>::placed), a plain value for P
// float.
template <class P, bool Device = false>
struct Prm {
  const ParamScene* s;
  int block;
  __device__ __forceinline__ P operator()(int slot) const {
    if constexpr (Device) {
      return Scalar<P>::placed(__ldg(s->prm_values + slot), slot, block);
    } else {
      return Scalar<P>::placed(s->prm[slot], slot, block);
    }
  }
};

// the value of primitive `op` at x, its fields' slots at w + 2 (csdf.py
// PARAM_FIELDS), as sdf/primitives.py's component forms compute it
template <class T, class P, bool D>
__device__ __forceinline__ T program_primitive(int op, const int* w, const Prm<P, D>& prm,
                                               const T x[3]) {
  const int s0 = __ldg(w + 2), s1 = __ldg(w + 3), s2 = __ldg(w + 4);
  if (op == OP_PLANE) {
    const P n0 = prm(s0), n1 = prm(s0 + 1), n2 = prm(s0 + 2);
    const P inv = vrsqrt(vmaxn((n0 * n0 + n1 * n1) + n2 * n2, 1e-24f));
    return ((x[0] * n0 + x[1] * n1) + x[2] * n2) * inv - prm(s1);
  }
  if (op == OP_SKELETON) {  // sd_box_skeleton_c
    const bool compat = __ldg(w + 5) != 0;
    P lo[3], size[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      size[a] = prm(s1 + a);
      lo[a] = prm(s0 + a) - size[a] / 2.0f;
    }
    T best;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int a1 = (d + 1) % 3, a2 = (d + 2) % 3;
      const T r = x[d] - lo[d];
      const T e = r - vminn(vmaxn(r, 0.0f), size[d]);
      const T o1 = x[a1] - lo[a1];
      const T o1b = o1 - (compat ? size[(d + 1) % 2] : size[a1]);
      const T o2 = x[a2] - lo[a2];
      const T o2b = o2 - size[a2];
      const T d2 = (e * e + vminn(o1 * o1, o1b * o1b)) + vminn(o2 * o2, o2b * o2b);
      best = d == 0 ? d2 : vminn(best, d2);
    }
    return psqrt(best) - prm(s2);
  }
  const T p[3] = {x[0] - prm(s0), x[1] - prm(s0 + 1), x[2] - prm(s0 + 2)};
  switch (op) {
    case OP_SPHERE:  // sd_sphere_c
      return psqrt((p[0] * p[0] + p[1] * p[1]) + p[2] * p[2]) - prm(s1);
    case OP_BOX: {  // sd_box_c
      T q[3], o[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        q[a] = vabs(p[a]) - prm(s1 + a) * 0.5f;
        o[a] = vmaxn(q[a], 0.0f);
      }
      const T outside = psqrt((o[0] * o[0] + o[1] * o[1]) + o[2] * o[2]);
      return outside + vminn(vmaxn(q[0], vmaxn(q[1], q[2])), 0.0f);
    }
    case OP_CAPSULE: {  // compose.py _sd_capsule_c, the segment from start (s0) to end (s1)
      P seg[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) seg[a] = prm(s1 + a) - prm(s0 + a);
      const P l2 = vmaxn((seg[0] * seg[0] + seg[1] * seg[1]) + seg[2] * seg[2], 1e-12f);
      const T t = vminn(vmaxn(((p[0] * seg[0] + p[1] * seg[1]) + p[2] * seg[2]) / l2, 0.0f), 1.0f);
      const T dx = p[0] - t * seg[0], dy = p[1] - t * seg[1], dz = p[2] - t * seg[2];
      return psqrt((dx * dx + dy * dy) + dz * dz) - prm(s2);
    }
    case OP_TORUS: {  // sd_torus_c
      const T ring = psqrt(p[0] * p[0] + p[2] * p[2]) - prm(s1);
      return psqrt(ring * ring + p[1] * p[1]) - prm(s2);
    }
    default: {  // OP_CYLINDER, sd_cylinder_c
      const T dr = psqrt(p[0] * p[0] + p[2] * p[2]) - prm(s1);
      const T dy = vabs(p[1]) - prm(s2) * 0.5f;
      const T ox = vmaxn(dr, 0.0f), oy = vmaxn(dy, 0.0f);
      return vminn(vmaxn(dr, dy), 0.0f) + psqrt(ox * ox + oy * oy);
    }
  }
}

// the child frame's coordinates of the push at w: a transform's x - offset,
// then the quaternion's inverse rotation (models/scenes.py
// _quat_inv_rotate_c); a wrap's -half + mod(x + half, cell) per axis
template <class T, class P, bool D>
__device__ __forceinline__ void program_frame(int op, const int* w, const Prm<P, D>& prm, T x[3]) {
  const int s0 = __ldg(w + 2);
  if (op == OP_PUSH_WRAP) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const P cell = prm(s0 + a);
      const P half = cell * 0.5f;
      x[a] = -half + vmod(x[a] + half, cell);
    }
    return;
  }
  const int s1 = __ldg(w + 3);
  const P q[4] = {prm(s1), prm(s1 + 1), prm(s1 + 2), prm(s1 + 3)};
  const Frame<P> f = rotation(q);
  const T v[3] = {x[0] - prm(s0), x[1] - prm(s0 + 1), x[2] - prm(s0 + 2)};
  x[0] = (f.m[0] * v[0] + f.m[3] * v[1]) + f.m[6] * v[2];
  x[1] = (f.m[1] * v[0] + f.m[4] * v[1]) + f.m[7] * v[2];
  x[2] = (f.m[2] * v[0] + f.m[5] * v[1]) + f.m[8] * v[2];
}

// a fold's value: union min, intersect max, subtract max(a, -b), smooth_union
// sdf/primitives.py smooth_min
template <class T, class P, bool D>
__device__ __forceinline__ T program_fold(int op, const int* w, const Prm<P, D>& prm, const T& a,
                                          const T& b) {
  switch (op) {
    case OP_MIN: return vminn(a, b);
    case OP_MAX: return vmaxn(a, b);
    case OP_SUB: return vmaxn(a, -b);
    default: {  // OP_SMOOTH
      const P k = prm(__ldg(w + 2));
      const T h = vmaxn(k - vabs(a - b), 0.0f) / k;
      return vminn(a, b) - (((h * h) * h) * k) * static_cast<float>(1.0 / 6.0);
    }
  }
}

// the program's value at x (the small tier: its stacks in local arrays)
template <class T, class P>
__device__ __forceinline__ T program_value(const ParamScene& s, const Prm<P>& prm, const T x[3]) {
  T stack[BSDMG_STACK];
  T frames[BSDMG_FRAMES][3];
  T c[3] = {x[0], x[1], x[2]};
  int sp = 0, fp = 0;
#pragma unroll 1
  for (int pc = 0; pc < s.program_length; ++pc) {
    const int* w = s.program + pc * BSDMG_PARAM_WORDS;
    const int op = __ldg(w);
    if (op <= OP_PLANE) {
      stack[sp++] = program_primitive(op, w, prm, c);
    } else if (op <= OP_SMOOTH) {
      const T b = stack[--sp];
      stack[sp - 1] = program_fold(op, w, prm, stack[sp - 1], b);
    } else if (op == OP_SHELL) {
      stack[sp - 1] = vabs(stack[sp - 1]) - prm(__ldg(w + 2));
    } else if (op == OP_POP) {
      --fp;
#pragma unroll
      for (int a = 0; a < 3; ++a) c[a] = frames[fp][a];
    } else {
#pragma unroll
      for (int a = 0; a < 3; ++a) frames[fp][a] = c[a];
      ++fp;
      program_frame(op, w, prm, c);
    }
  }
  return stack[0];
}

// the same walk in the large tier: the values read from device memory
// (Prm<P, true>), the stack and the frames (3 slots a frame) in
// ParamScene::scratch, the stack first, BSDMG_VALUE_WORDS slots a value at
// most
template <class T, class P>
__device__ __forceinline__ T program_value(const ParamScene& s, const Prm<P, true>& prm,
                                           const T x[3]) {
  SpilledSlots<T> stack(s.scratch, s.scratch_threads, 0);
  SpilledSlots<T> frames(s.scratch, s.scratch_threads,
                         (long long)s.program_depth * SpilledSlots<T>::W);
  T c[3] = {x[0], x[1], x[2]};
  int sp = 0, fp = 0;
#pragma unroll 1
  for (int pc = 0; pc < s.program_length; ++pc) {
    const int* w = s.program + pc * BSDMG_PARAM_WORDS;
    const int op = __ldg(w);
    if (op <= OP_PLANE) {
      stack.set(sp++, program_primitive(op, w, prm, c));
    } else if (op <= OP_SMOOTH) {
      const T b = stack.get(--sp);
      stack.set(sp - 1, program_fold(op, w, prm, stack.get(sp - 1), b));
    } else if (op == OP_SHELL) {
      stack.set(sp - 1, vabs(stack.get(sp - 1)) - prm(__ldg(w + 2)));
    } else if (op == OP_POP) {
      --fp;
#pragma unroll
      for (int a = 0; a < 3; ++a) c[a] = frames.get(3 * fp + a);
    } else {
#pragma unroll
      for (int a = 0; a < 3; ++a) frames.set(3 * fp + a, c[a]);
      ++fp;
      program_frame(op, w, prm, c);
    }
  }
  return stack.get(0);
}
