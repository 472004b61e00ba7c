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
// Dual<1> with the ray's direction for dfdt; K5 sweeps it in reverse (the
// end of this file). min and max propagate NaN (vmaxn), as torch.maximum
// does; sqrt is psqrt (nested_dual.cuh), whose tangents agree with the
// twins' reverse mode inside a box. Twin: csdf.py::param_program_csdf.
//
// ProgramForm (param_forms.cuh) is the small tier: the parameter values in
// ParamScene::prm, the stacks in local arrays of program.cuh's caps.
// ProgramLargeForm is the large tier, for any program and any number of
// values: the values in device memory (ParamScene::prm_values) and the
// stacks in the scratch buffer ParamScene::scratch (program.cuh
// SpilledSlots), whose T values take up to BSDMG_VALUE_WORDS slots each
// (the reverse sweep's, BSDMG_SWEEP_WORDS).

#pragma once

#include "nested_dual.cuh"
#include "param_sdf.cuh"
#include "program.cuh"

#define BSDMG_PARAM_WORDS 8  // csdf.py PARAM_WORDS
#define BSDMG_VALUE_WORDS 2  // floats of the widest value program_value keeps, Dual<1>

static_assert(sizeof(Dual<1>) == BSDMG_VALUE_WORDS * sizeof(float),
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
// PARAM_FIELDS), as sdf/primitives.py's component forms compute it; prm(slot)
// gives a parameter value as P (Prm, or the reverse sweep's LocalPrm)
template <class T, class G>
__device__ __forceinline__ T program_primitive(int op, const int* w, const G& prm, const T x[3]) {
  typedef decltype(prm(0)) P;
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
template <class T, class G>
__device__ __forceinline__ void program_frame(int op, const int* w, const G& prm, T x[3]) {
  typedef decltype(prm(0)) P;
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
template <class T, class G>
__device__ __forceinline__ T program_fold(int op, const int* w, const G& prm, const T& a,
                                          const T& b) {
  typedef decltype(prm(0)) P;
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

// ---------------------------------------------------------------------------
// The reverse sweep (K5's tangent launch of ProgramForm and ProgramLargeForm,
// diff_kernel.cu loss_reverse_kernel): the adjoint of a forward pass, in
// one walk a sweep whatever the number of parameter values.
//
// The forward pass (program_record) evaluates the program at x in T: float
// (the value alone) or Dual<3> (the value and its spatial gradient, the
// point's unit tangents seeded), and records on a tape what the backward
// walk needs and cannot recompute cheaply: a fold's two operands, a shell's
// operand, and at each POP the child frame's coordinates. The backward walk
// (program_reverse) goes from the last instruction to the first with the
// adjoint of the program's value (a T: the adjoint of the value and, in
// Dual<3>, of the three gradient components), a stack of the adjoints of the
// stack's values, and the adjoint of the current frame's coordinates; it
// adds each parameter's adjoint to its slot (an Adjoint) and returns the
// adjoint of x. Each instruction's adjoint is the adjoint of its forward in
// T under the forward lanes' rules (tie_weight, vmaxn's NaN, abs +1 at 0,
// psqrt's zero tangent, vmod's derivative): a primitive, a fold and a shell
// are differentiated by forward mode over their own inputs, their operands'
// values and their parameters, three a pass (Pass<T>: the nested types of
// nested_dual.cuh; with T Dual<3> the outer tangent is the direction u =
// sum_k adj.t[k] in.t[k], whose derivative is the gradient's adjoint
// contracted), so every rule is the forward lanes' own code; a transform's
// adjoint is its linear algebra, the rotation's matrix differentiated by
// forward mode in the quaternion (Dual<4>); a wrap's is vmod's, 1 in the
// point and plus - trunc(a / cell) in the cell.
//
// Storage: a Store<Spilled> of floats, T values of W floats each: the stack
// (its values forward, their adjoints backward), the frames (3 T a frame
// forward; 6 T backward: a frame's coordinates and their adjoint), then the
// tape, at most 3 * length / 2 T: a fold's 2 T come with a primitive's 0,
// since a program pushes one more primitive than it folds, a POP's 3 T with
// its PUSH's 0, a shell's 1 T. The small tier keeps it in a local array of
// the caps (BSDMG_SWEEP_SLOTS T), the large tier in ParamScene::scratch,
// slot-major (program.cuh SpilledSlots).
// ---------------------------------------------------------------------------

#define BSDMG_TAPE (3 * BSDMG_PROGRAM / 2)
#define BSDMG_SWEEP_SLOTS (BSDMG_STACK + 6 * BSDMG_FRAMES + BSDMG_TAPE)
#define BSDMG_SWEEP_WORDS 4  // floats of the widest recorded value, Dual<3>

// the T values of the sweep: slot k's floats at base[(k * W + j) * stride],
// stride 1 in a local array, the launch's threads in the scratch buffer
template <bool Spilled>
struct Store {
  float* base;
  long long stride;
  template <class T>
  __device__ __forceinline__ T get(int k) const {
    constexpr int W = sizeof(T) / sizeof(float);
    T x;
    float* f = reinterpret_cast<float*>(&x);
#pragma unroll
    for (int j = 0; j < W; ++j) f[j] = base[(long long)(k * W + j) * (Spilled ? stride : 1)];
    return x;
  }
  template <class T>
  __device__ __forceinline__ void set(int k, const T& x) {
    constexpr int W = sizeof(T) / sizeof(float);
    const float* f = reinterpret_cast<const float*>(&x);
#pragma unroll
    for (int j = 0; j < W; ++j) base[(long long)(k * W + j) * (Spilled ? stride : 1)] = f[j];
  }
};

// the parameters' adjoints: slot k's at base[k * stride]. A ray's sweep
// runs on a group of Lanes lanes of a warp (1 or 4; `mask` the group's,
// `sub` this lane's place in it): every lane walks the whole program, a
// primitive's passes are split over the lanes (lane sub takes passes sub,
// sub + Lanes, ..., adding with add_pass), and the group's first lane
// alone adds every other adjoint (add)
template <int Lanes>
struct Adjoint {
  static constexpr int lanes = Lanes;
  float* base;
  long long stride;
  int sub;
  unsigned mask;
  __device__ __forceinline__ int first_pass() const { return Lanes == 1 ? 0 : sub; }
  __device__ __forceinline__ void add(int k, float v) {
    if (Lanes == 1 || sub == 0) base[k * stride] += v;
  }
  __device__ __forceinline__ void add_pass(int k, float v) { base[k * stride] += v; }
  // x as the group's first lane holds it
  __device__ __forceinline__ float first(float x) const {
    return Lanes == 1 ? x : __shfl_sync(mask, x, __ffs(mask) - 1);
  }
  __device__ __forceinline__ Dual<3> first(const Dual<3>& x) const {
    Dual<3> r;
    r.v = first(x.v);
#pragma unroll
    for (int k = 0; k < 3; ++k) r.t[k] = first(x.t[k]);
    return r;
  }
};

// the sweep's regions, in T slots: the stack, the frames, the tape
struct SweepLayout {
  int frames, tape;
  __device__ __forceinline__ explicit SweepLayout(int depth, int nframes)
      : frames(depth), tape(depth + 6 * nframes) {}
};

typedef Dual<3> Local;  // a pass: the tangents of three of an instruction's inputs

__device__ __forceinline__ Local seeded(float v, int j) {
  Local r;
  r.v = v;
#pragma unroll
  for (int i = 0; i < 3; ++i) r.t[i] = i == j ? 1.0f : 0.0f;
  return r;
}

__device__ __forceinline__ float adj_value(float x) { return x; }
__device__ __forceinline__ float adj_value(const Dual<3>& x) { return x.v; }

// sum over the components of a * b: the adjoint's pairing with a value
__device__ __forceinline__ float pairing(float a, float b) { return a * b; }
__device__ __forceinline__ float pairing(const Dual<3>& a, const Dual<3>& b) {
  return ((a.v * b.v + a.t[0] * b.t[0]) + a.t[1] * b.t[1]) + a.t[2] * b.t[2];
}

// Pass<T>: an instruction's input of type T as the pass's nested type N,
// under the output's adjoint ob, with local seed j (-1 for none); and the
// pass's output r read back: the input's adjoint, or psi's derivative in
// seed j, psi = ob . (the output in T)
template <class T>
struct Pass;

template <>
struct Pass<float> {
  typedef Local N;
  static __device__ __forceinline__ N lift(float a, int j, float) { return seeded(a, j); }
  static __device__ __forceinline__ float dpsi(const N& r, int j, float ob) { return ob * r.t[j]; }
  static __device__ __forceinline__ void add_input(float& abar, const N& r, int j, float ob) {
    abar += ob * r.t[j];
  }
};

template <>
struct Pass<Dual<3>> {
  typedef DualOf<1, Local> N;
  static __device__ __forceinline__ N lift(const Dual<3>& a, int j, const Dual<3>& ob) {
    N r;
    r.v = seeded(a.v, j);
    r.t[0] = Scalar<Local>::constant((ob.t[0] * a.t[0] + ob.t[1] * a.t[1]) + ob.t[2] * a.t[2]);
    return r;
  }
  static __device__ __forceinline__ float dpsi(const N& r, int j, const Dual<3>& ob) {
    return ob.v * r.v.t[j] + r.t[0].t[j];
  }
  static __device__ __forceinline__ void add_input(Dual<3>& abar, const N& r, int j,
                                                   const Dual<3>& ob) {
    const float dv = r.v.t[j];
    abar.v += ob.v * dv + r.t[0].t[j];
#pragma unroll
    for (int k = 0; k < 3; ++k) abar.t[k] += dv * ob.t[k];
  }
};

// a parameter value as Local: the instruction's fields at local places
// first.., field 0 (slot s0, w0 values), field 1 (s1, w1), field 2 (s2, 1),
// seeded where the place is in pass `pass` (places 3 * pass .. + 2)
template <bool D>
struct LocalPrm {
  Prm<float, D> value;
  int first, s0, w0, s1, w1, s2, pass;
  __device__ __forceinline__ int place(int slot) const {
    if (slot - s0 >= 0 && slot - s0 < w0) return first + slot - s0;
    if (slot - s1 >= 0 && slot - s1 < w1) return first + w0 + slot - s1;
    return first + w0 + w1;  // s2
  }
  __device__ __forceinline__ int slot(int place) const {
    const int f = place - first;
    return f < w0 ? s0 + f : (f < w0 + w1 ? s1 + f - w0 : s2);
  }
  __device__ __forceinline__ Local operator()(int slot) const {
    const int j = place(slot) - 3 * pass;
    return seeded(value(slot), j >= 0 && j < 3 ? j : -1);
  }
};

// a primitive's adjoint at the frame's coordinates c under the output's
// adjoint ob: into the coordinates' adjoint cb and the fields' slots; the
// passes split over the ray's lanes, the coordinates' (pass 0, the group's
// first lane) then shared with the others
template <bool D, class T, class A>
__device__ __forceinline__ void primitive_adjoint(const ParamScene& s, int op, const int* w,
                                                  const T c[3], const T& ob, T cb[3], A& adj) {
  typedef Pass<T> PT;
  const int w1 = op == OP_BOX || op == OP_CAPSULE || op == OP_SKELETON ? 3 : 1;
  const bool f2 = op == OP_CAPSULE || op == OP_SKELETON || op == OP_TORUS || op == OP_CYLINDER;
  const int inputs = 6 + w1 + (f2 ? 1 : 0);
  LocalPrm<D> prm{{&s, 0}, 3, __ldg(w + 2), 3, __ldg(w + 3), w1, __ldg(w + 4), 0};
#pragma unroll 1
  for (int pass = adj.first_pass(); 3 * pass < inputs; pass += A::lanes) {
    prm.pass = pass;
    typename PT::N x[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) x[a] = PT::lift(c[a], pass == 0 ? a : -1, ob);
    const typename PT::N r = program_primitive(op, w, prm, x);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int place = 3 * pass + j;
      if (place < 3) {
        PT::add_input(cb[place], r, j, ob);
      } else if (place < inputs) {
        adj.add_pass(prm.slot(place), PT::dpsi(r, j, ob));
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) cb[a] = adj.first(cb[a]);
}

// a fold's adjoint: its operands' (a below b) and, for SMOOTH, k's
template <bool D, class T, class A>
__device__ __forceinline__ void fold_adjoint(const ParamScene& s, int op, const int* w, const T& a,
                                             const T& b, const T& ob, T& abar, T& bbar, A& adj) {
  typedef Pass<T> PT;
  const LocalPrm<D> prm{{&s, 0}, 2, __ldg(w + 2), 1, -1, 0, -1, 0};
  const typename PT::N r = program_fold(op, w, prm, PT::lift(a, 0, ob), PT::lift(b, 1, ob));
  abar = Scalar<T>::constant(0.0f);
  bbar = Scalar<T>::constant(0.0f);
  PT::add_input(abar, r, 0, ob);
  PT::add_input(bbar, r, 1, ob);
  if (op == OP_SMOOTH) adj.add(prm.s0, PT::dpsi(r, 2, ob));
}

// a shell's adjoint: its operand's and the thickness'
template <bool D, class T, class A>
__device__ __forceinline__ T shell_adjoint(const ParamScene& s, const int* w, const T& a,
                                           const T& ob, A& adj) {
  typedef Pass<T> PT;
  const LocalPrm<D> prm{{&s, 0}, 1, __ldg(w + 2), 1, -1, 0, -1, 0};
  const typename PT::N r = vabs(PT::lift(a, 0, ob)) - prm(prm.s0);
  T abar = Scalar<T>::constant(0.0f);
  PT::add_input(abar, r, 0, ob);
  adj.add(prm.s0, PT::dpsi(r, 1, ob));
  return abar;
}

// a push's adjoint: from the child frame's coordinates' adjoint cb to the
// parent's, pb (added to), at the parent's coordinates p, and the push's
// fields
template <bool D, class T, class A>
__device__ __forceinline__ void frame_adjoint(const ParamScene& s, int op, const int* w,
                                              const T p[3], const T cb[3], T pb[3], A& adj) {
  const Prm<float, D> prm{&s, 0};
  const int s0 = __ldg(w + 2);
  if (op == OP_PUSH_WRAP) {
    // c = -half + mod(p + half, cell): dc/dp 1, dc/dcell plus - trunc(a / cell)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float cell = prm(s0 + a);
      const float av = adj_value(p[a]) + cell * 0.5f;
      const float m = fmodf(av, cell);
      const bool plus = m != 0.0f && ((m < 0.0f) != (cell < 0.0f));
      const float k = (plus ? 1.0f : 0.0f) - truncf(av / cell);
      pb[a] = pb[a] + cb[a];
      adj.add(s0 + a, adj_value(cb[a]) * (-0.5f + (0.5f + k)));
    }
    return;
  }
  // c_a = m[a] v0 + m[a + 3] v1 + m[a + 6] v2 with v = p - offset, m the
  // rotation's matrix of the quaternion at s1
  const int s1 = __ldg(w + 3);
  float q[4];
  Dual<4> qd[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    q[j] = prm(s1 + j);
    qd[j] = Scalar<Dual<4>>::placed(q[j], j, 0);
  }
  const Frame<float> f = rotation(q);
  const Frame<Dual<4>> fd = rotation(qd);
  float qbar[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    const T v = p[b] - prm(s0 + b);
    const T vbar = (cb[0] * f.m[3 * b] + cb[1] * f.m[3 * b + 1]) + cb[2] * f.m[3 * b + 2];
    pb[b] = pb[b] + vbar;
    adj.add(s0 + b, -adj_value(vbar));
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float mbar = pairing(cb[a], v);
#pragma unroll
      for (int j = 0; j < 4; ++j) qbar[j] += mbar * fd.m[a + 3 * b].t[j];
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) adj.add(s1 + j, qbar[j]);
}

// the forward pass at x with the tape (from slot layout.tape on); returns
// the program's value, its tape's length in T slots in tp
template <class T, bool D, bool Spilled>
__device__ __forceinline__ T program_record(const ParamScene& s, const T x[3], Store<Spilled>& st,
                                            const SweepLayout& layout, int& tp) {
  const Prm<float, D> prm{&s, 0};
  T c[3] = {x[0], x[1], x[2]};
  int sp = 0, fp = 0;
  tp = layout.tape;
#pragma unroll 1
  for (int pc = 0; pc < s.program_length; ++pc) {
    const int* w = s.program + pc * BSDMG_PARAM_WORDS;
    const int op = __ldg(w);
    if (op <= OP_PLANE) {
      st.set(sp++, program_primitive(op, w, prm, c));
    } else if (op <= OP_SMOOTH) {
      const T b = st.template get<T>(--sp);
      const T a = st.template get<T>(sp - 1);
      st.set(tp++, a);
      st.set(tp++, b);
      st.set(sp - 1, program_fold(op, w, prm, a, b));
    } else if (op == OP_SHELL) {
      const T a = st.template get<T>(sp - 1);
      st.set(tp++, a);
      st.set(sp - 1, vabs(a) - prm(__ldg(w + 2)));
    } else if (op == OP_POP) {
#pragma unroll
      for (int a = 0; a < 3; ++a) st.set(tp++, c[a]);
      --fp;
#pragma unroll
      for (int a = 0; a < 3; ++a) c[a] = st.template get<T>(layout.frames + 3 * fp + a);
    } else {
#pragma unroll
      for (int a = 0; a < 3; ++a) st.set(layout.frames + 3 * fp + a, c[a]);
      ++fp;
      program_frame(op, w, prm, c);
    }
  }
  return st.template get<T>(0);
}

// the backward walk over program_record's tape (its end at tp), from the
// adjoint `seed` of the program's value at x: the parameters' adjoints into
// adj, the adjoint of x into xbar
template <class T, bool D, bool Spilled, class A>
__device__ __forceinline__ void program_reverse(const ParamScene& s, const T x[3], const T& seed,
                                                Store<Spilled>& st, const SweepLayout& layout,
                                                int tp, A& adj, T xbar[3]) {
  T c[3] = {x[0], x[1], x[2]};
  T cb[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) cb[a] = Scalar<T>::constant(0.0f);
  int sp = 0, fp = 0;
  st.set(sp++, seed);
#pragma unroll 1
  for (int pc = s.program_length - 1; pc >= 0; --pc) {
    const int* w = s.program + pc * BSDMG_PARAM_WORDS;
    const int op = __ldg(w);
    if (op <= OP_PLANE) {
      primitive_adjoint<D>(s, op, w, c, st.template get<T>(--sp), cb, adj);
    } else if (op <= OP_SMOOTH) {
      const T ob = st.template get<T>(--sp);
      tp -= 2;
      T abar, bbar;
      fold_adjoint<D>(s, op, w, st.template get<T>(tp), st.template get<T>(tp + 1), ob, abar, bbar,
                      adj);
      st.set(sp++, abar);
      st.set(sp++, bbar);
    } else if (op == OP_SHELL) {
      const T ob = st.template get<T>(--sp);
      tp -= 1;
      st.set(sp++, shell_adjoint<D>(s, w, st.template get<T>(tp), ob, adj));
    } else if (op == OP_POP) {
      // back into the child frame: keep the parent's coordinates and adjoint
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        st.set(layout.frames + 6 * fp + a, c[a]);
        st.set(layout.frames + 6 * fp + 3 + a, cb[a]);
      }
      ++fp;
      tp -= 3;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        c[a] = st.template get<T>(tp + a);
        cb[a] = Scalar<T>::constant(0.0f);
      }
    } else {
      // out to the parent frame
      --fp;
      T p[3], pb[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        p[a] = st.template get<T>(layout.frames + 6 * fp + a);
        pb[a] = st.template get<T>(layout.frames + 6 * fp + 3 + a);
      }
      frame_adjoint<D>(s, op, w, p, cb, pb, adj);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        c[a] = p[a];
        cb[a] = pb[a];
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) xbar[a] = cb[a];
}
