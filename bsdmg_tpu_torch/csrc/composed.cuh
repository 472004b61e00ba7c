// The interpreter of a composed scene's node program: scene_sdf and
// scene_sdf_grad of the Composed structure (scene_sdf.cuh), which K1, K2,
// K3 (render_kernel.cu), K6 (mc_kernel.cu) and K7 (project_kernel.cu) run
// for a scene built from a JSON spec (models/compose.py). Replaces the
// baked closure that the JAX package traces into each Pallas kernel
// (bsdmg_tpu/ops/pallas/csdf.py compile_scene_csdf, its spec branch, and
// bsdmg_tpu/models/compose.py composed_baked_csdf).
//
// The scene is data, not code: ops/cuda/csdf.py::node_program flattens the
// spec into a postfix program of BSDMG_WORDS-word instructions (opcode,
// operand index, 14 float32 constants) in device memory, which the
// descriptor owns and SceneDesc points at. A primitive pushes its value, a
// fold (union min, intersect max, subtract max(a, -b), smooth_union) pops
// two values and pushes one, shell maps the top; transform and wrap push a
// coordinate frame before their child and pop it after. Composed, the small
// tier, walks it in two ways. The taped walk (composed_forward, for the
// gradient of K6 and K7) reads the rows from device memory and keeps its
// stacks in small arrays in local memory, for programs within the caps of
// program.cuh. The forward walk (composed_sdf: scene_sdf of K1, K2, K3 and
// of K6's and K7's normals) reads csdf.py::walk_words from shared memory,
// where each block stages them once (stage_walk): every thread of a warp
// reads the same word, a broadcast off the global-load chain, and an
// instruction carries only the constants it uses. Its top of the stack is
// a register; a fold whose right operand is one primitive is fused into
// it, so a union's chain of primitives touches no memory, and only a
// right-nested operand (the stack below the top) or a frame does. No tape,
// so no length cap: the caps of the stack and the frames, and the
// BSDMG_WALK_WORDS a block stages. One walk serves N points at once
// (composed_sdf_n): K3's and K7's fd4 stencils walk the four points of an
// axis together, each instruction read and dispatched once for four.
// ComposedLarge, the large tier, keeps the stacks of both walks in the
// scratch buffer SceneDesc::scratch, for any program (program.cuh
// SpilledSlots); csdf.py::large_tier picks the tier per walk. (A constant
// bank written per launch, a warp in step for uniform loads, one switch an
// instruction and 16-byte rows were tried and measured slower: PERF.md,
// composed K1.)
//
// The gradient is reverse mode, as jax.vjp of the JAX package's baked SDF
// takes it: the forward pass keeps every instruction's value on a tape (of
// BSDMG_PROGRAM floats in the small tier), the backward walks the program from
// its end with a stack of cotangents; each primitive recomputes its
// forward and adds its gradient to the frame's; JAX's tie rules (tie_weight:
// min and max split a cotangent at a tie; abs passes +1 at 0), and every
// cotangent is computed where it is 0, so a NaN weight (the box's inside,
// sqrt at 0) gives a NaN as in JAX. min and max propagate NaN (vmaxn).
//
// Twins: _program_csdf and _program_value_and_grad in ops/cuda/csdf.py,
// operation for operation; under -fmad=false each equals its twin bit for
// bit, and walk_csdf, which reads the forward walk's words, equals
// _program_csdf bit for bit. What bounds it: its FP32 operations per evaluation
// (utils/profiling.py program_ops), as the fixed structures; the
// interpreter adds a uniform load and branch per instruction (and the
// taped walk's local-memory stack traffic).

#pragma once

#include "program.cuh"

#define BSDMG_WORDS 16         // csdf.py PROGRAM_WORDS
#define BSDMG_WALK_WORDS 8192  // csdf.py WALK_CAP
#define BSDMG_WALK_SET 0       // csdf.py WALK_SET
#define BSDMG_WALK_PUSH 1      // csdf.py WALK_PUSH

// constant i of the instruction at w
__device__ __forceinline__ float prog_k(const int* w, int i) { return __int_as_float(__ldg(w + 2 + i)); }

// the forward walk's words (csdf.py walk_words), staged by stage_walk in
// the block's dynamic shared memory
extern __shared__ int bsdmg_walk[];

// the constants of an instruction, k(i) its i-th: a row of the program in
// device memory (the taped walk), or words of the walk in shared memory
struct RowWords {
  const int* w;
  __device__ __forceinline__ float operator()(int i) const { return prog_k(w, i); }
};
struct WalkWords {
  int at;  // the word of constant 0
  __device__ __forceinline__ float operator()(int i) const {
    return __int_as_float(bsdmg_walk[at + i]);
  }
};

// the child frame's coordinates of the push `op`: a wrap per axis, or a
// transform's x - offset and then the rows of R^T (r00*x + r10*y + r20*z)
template <class K>
__device__ __forceinline__ void frame_coords(int op, const K& k, float& x, float& y, float& z) {
  if (op == OP_PUSH_WRAP) {
    x = wrap_axis(x, k(0), k(3));
    y = wrap_axis(y, k(1), k(4));
    z = wrap_axis(z, k(2), k(5));
    return;
  }
  const float tx = x - k(0), ty = y - k(1), tz = z - k(2);
  x = (k(3) * tx + k(6) * ty) + k(9) * tz;
  y = (k(4) * tx + k(7) * ty) + k(10) * tz;
  z = (k(5) * tx + k(8) * ty) + k(11) * tz;
}

// the same of the push at w, a row of the program
__device__ __forceinline__ void frame_coords(const int* w, float& x, float& y, float& z) {
  frame_coords(__ldg(w), RowWords{w}, x, y, z);
}

// one axis d of the box skeleton (sd_box_skeleton_c): the capsules along d
// as (axial + min(V1)) + min(V2)
struct SkeletonAxis {
  float r, mx, t, e, o1, o1b, o2, o2b, q1, q1b, q2, q2b, m1, m2, d2;
};

template <class K>
__device__ __forceinline__ void skeleton_axis(const K& k, int d, const float c[3],
                                              SkeletonAxis& a) {
  const int a1 = (d + 1) % 3, a2 = (d + 2) % 3;
  a.r = c[d] - k(d);
  a.mx = vmaxn(a.r, 0.0f);
  a.t = vminn(a.mx, k(3 + d));
  a.e = a.r - a.t;
  a.o1 = c[a1] - k(a1);
  a.o1b = a.o1 - k(6 + d);
  a.o2 = c[a2] - k(a2);
  a.o2b = a.o2 - k(3 + a2);
  a.q1 = a.o1 * a.o1;
  a.q1b = a.o1b * a.o1b;
  a.q2 = a.o2 * a.o2;
  a.q2b = a.o2b * a.o2b;
  a.m1 = vminn(a.q1, a.q1b);
  a.m2 = vminn(a.q2, a.q2b);
  a.d2 = (a.e * a.e + a.m1) + a.m2;
}

// a primitive's value (csdf.py _primitive_value), its constants k
template <class K>
__device__ __forceinline__ float primitive_value(int op, const K& k, float x, float y, float z) {
  if (op == OP_PLANE) {
    return ((x * k(0) + y * k(1)) + z * k(2)) * k(3) - k(4);
  }
  if (op == OP_SKELETON) {
    const float c[3] = {x, y, z};
    SkeletonAxis a;
    skeleton_axis(k, 0, c, a);
    float best = a.d2;
    skeleton_axis(k, 1, c, a);
    best = vminn(best, a.d2);
    skeleton_axis(k, 2, c, a);
    best = vminn(best, a.d2);
    return sqrtf(best) - k(9);
  }
  const float px = x - k(0), py = y - k(1), pz = z - k(2);
  switch (op) {
    case OP_SPHERE:
      return sqrtf((px * px + py * py) + pz * pz) - k(3);
    case OP_BOX: {
      const float qx = fabsf(px) - k(3);
      const float qy = fabsf(py) - k(4);
      const float qz = fabsf(pz) - k(5);
      const float ox = vmaxn(qx, 0.0f), oy = vmaxn(qy, 0.0f), oz = vmaxn(qz, 0.0f);
      const float outside = sqrtf((ox * ox + oy * oy) + oz * oz);
      return outside + vminn(vmaxn(qx, vmaxn(qy, qz)), 0.0f);
    }
    case OP_CAPSULE: {
      const float sx = k(3), sy = k(4), sz = k(5);
      const float q = ((px * sx + py * sy) + pz * sz) / k(6);
      const float t = vminn(vmaxn(q, 0.0f), 1.0f);
      const float dx = px - t * sx, dy = py - t * sy, dz = pz - t * sz;
      return sqrtf((dx * dx + dy * dy) + dz * dz) - k(7);
    }
    case OP_TORUS: {
      const float ring = sqrtf(px * px + pz * pz) - k(3);
      return sqrtf(ring * ring + py * py) - k(4);
    }
    default: {  // OP_CYLINDER
      const float dr = sqrtf(px * px + pz * pz) - k(3);
      const float dy = fabsf(py) - k(4);
      const float ox = vmaxn(dr, 0.0f), oy = vmaxn(dy, 0.0f);
      return vminn(vmaxn(dr, dy), 0.0f) + sqrtf(ox * ox + oy * oy);
    }
  }
}

__device__ __forceinline__ float primitive_value(int op, const int* w, float x, float y, float z) {
  return primitive_value(op, RowWords{w}, x, y, z);
}

// ct * the gradient of a primitive, into (gx, gy, gz) (csdf.py
// _primitive_bwd): its forward again, then reverse mode
__device__ __forceinline__ void primitive_grad(int op, const int* w, float x, float y, float z,
                                               float ct, float& gx, float& gy, float& gz) {
  if (op == OP_PLANE) {
    const float c = ct * prog_k(w, 3);
    gx = c * prog_k(w, 0);
    gy = c * prog_k(w, 1);
    gz = c * prog_k(w, 2);
    return;
  }
  if (op == OP_SKELETON) {
    const float c[3] = {x, y, z};
    SkeletonAxis ax[3];
    skeleton_axis(RowWords{w}, 0, c, ax[0]);
    skeleton_axis(RowWords{w}, 1, c, ax[1]);
    skeleton_axis(RowWords{w}, 2, c, ax[2]);
    const float best0 = ax[0].d2;
    const float best1 = vminn(best0, ax[1].d2);
    const float best2 = vminn(best1, ax[2].d2);
    const float root = sqrtf(best2);
    float wt = ct * (0.5f / root);
    float cts[3];
    cts[2] = wt * tie_weight(ax[2].d2, best2, best1);
    wt = wt * tie_weight(best1, best2, ax[2].d2);
    cts[1] = wt * tie_weight(ax[1].d2, best1, best0);
    cts[0] = wt * tie_weight(best0, best1, ax[1].d2);
    float g[3] = {0.0f, 0.0f, 0.0f};
    bool seen[3] = {false, false, false};
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const SkeletonAxis& a = ax[d];
      const float cd = cts[d];
      const float ce = cd * a.e;
      const float ct_e = ce + ce;
      const float ct_mx = -ct_e * tie_weight(a.mx, a.t, prog_k(w, 3 + d));
      const float ct_r = ct_e + ct_mx * tie_weight(a.r, a.mx, 0.0f);
      const float s0 = (cd * tie_weight(a.q1, a.m1, a.q1b)) * a.o1;
      const float s1 = (cd * tie_weight(a.q1b, a.m1, a.q1)) * a.o1b;
      const float ct_o1 = (s0 + s0) + (s1 + s1);
      const float s2 = (cd * tie_weight(a.q2, a.m2, a.q2b)) * a.o2;
      const float s3 = (cd * tie_weight(a.q2b, a.m2, a.q2)) * a.o2b;
      const float ct_o2 = (s2 + s2) + (s3 + s3);
      const int axes[3] = {d, (d + 1) % 3, (d + 2) % 3};
      const float vals[3] = {ct_r, ct_o1, ct_o2};
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        g[axes[j]] = seen[axes[j]] ? g[axes[j]] + vals[j] : vals[j];
        seen[axes[j]] = true;
      }
    }
    gx = g[0];
    gy = g[1];
    gz = g[2];
    return;
  }
  const float px = x - prog_k(w, 0), py = y - prog_k(w, 1), pz = z - prog_k(w, 2);
  switch (op) {
    case OP_SPHERE: {
      const float root = sqrtf((px * px + py * py) + pz * pz);
      const float wt = ct * (0.5f / root);
      const float sx = wt * px, sy = wt * py, sz = wt * pz;
      gx = sx + sx;
      gy = sy + sy;
      gz = sz + sz;
      return;
    }
    case OP_BOX: {
      const float p[3] = {px, py, pz};
      float q[3], o[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        q[a] = fabsf(p[a]) - prog_k(w, 3 + a);
        o[a] = vmaxn(q[a], 0.0f);
      }
      const float outside = sqrtf((o[0] * o[0] + o[1] * o[1]) + o[2] * o[2]);
      const float m2 = vmaxn(q[1], q[2]);
      const float m3 = vmaxn(q[0], m2);
      const float inside = vminn(m3, 0.0f);
      const float ct_m3 = ct * tie_weight(m3, inside, 0.0f);
      const float ct_m2 = ct_m3 * tie_weight(m2, m3, q[0]);
      const float ct_in[3] = {ct_m3 * tie_weight(q[0], m3, m2), ct_m2 * tie_weight(q[1], m2, q[2]),
                              ct_m2 * tie_weight(q[2], m2, q[1])};
      const float wt = ct * (0.5f / outside);
      float g[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float sq = wt * o[a];
        const float ct_q = (sq + sq) * tie_weight(q[a], o[a], 0.0f) + ct_in[a];
        g[a] = p[a] >= 0.0f ? ct_q : -ct_q;  // jax: d|x| = +1 at 0
      }
      gx = g[0];
      gy = g[1];
      gz = g[2];
      return;
    }
    case OP_CAPSULE: {
      const float sx = prog_k(w, 3), sy = prog_k(w, 4), sz = prog_k(w, 5);
      const float q = ((px * sx + py * sy) + pz * sz) / prog_k(w, 6);
      const float mx = vmaxn(q, 0.0f);
      const float t = vminn(mx, 1.0f);
      const float dx = px - t * sx, dy = py - t * sy, dz = pz - t * sz;
      const float root = sqrtf((dx * dx + dy * dy) + dz * dz);
      const float wt = ct * (0.5f / root);
      const float ax = wt * dx, ay = wt * dy, az = wt * dz;
      const float cdx = ax + ax, cdy = ay + ay, cdz = az + az;
      const float ct_t = -((cdx * sx + cdy * sy) + cdz * sz);
      const float ct_q = (ct_t * tie_weight(mx, t, 1.0f)) * tie_weight(q, mx, 0.0f);
      const float ct_dot = ct_q / prog_k(w, 6);
      gx = cdx + ct_dot * sx;
      gy = cdy + ct_dot * sy;
      gz = cdz + ct_dot * sz;
      return;
    }
    case OP_TORUS: {
      const float a = sqrtf(px * px + pz * pz);
      const float ring = a - prog_k(w, 3);
      const float b = sqrtf(ring * ring + py * py);
      const float wb = ct * (0.5f / b);
      const float sr = wb * ring;
      const float ct_ring = sr + sr;
      const float wa = ct_ring * (0.5f / a);
      const float sx = wa * px, sy = wb * py, sz = wa * pz;
      gx = sx + sx;
      gy = sy + sy;
      gz = sz + sz;
      return;
    }
    default: {  // OP_CYLINDER
      const float a = sqrtf(px * px + pz * pz);
      const float dr = a - prog_k(w, 3);
      const float dy = fabsf(py) - prog_k(w, 4);
      const float ox = vmaxn(dr, 0.0f), oy = vmaxn(dy, 0.0f);
      const float mxd = vmaxn(dr, dy);
      const float inner = vminn(mxd, 0.0f);
      const float root = sqrtf(ox * ox + oy * oy);
      const float wt = ct * (0.5f / root);
      const float so = wt * ox, sy = wt * oy;
      const float ct_ox = so + so, ct_oy = sy + sy;
      const float ct_mxd = ct * tie_weight(mxd, inner, 0.0f);
      const float ct_dr = ct_mxd * tie_weight(dr, mxd, dy) + ct_ox * tie_weight(dr, ox, 0.0f);
      const float ct_dy = ct_mxd * tie_weight(dy, mxd, dr) + ct_oy * tie_weight(dy, oy, 0.0f);
      const float wa = ct_dr * (0.5f / a);
      const float sx = wa * px, sz = wa * pz;
      gx = sx + sx;
      gy = py >= 0.0f ? ct_dy : -ct_dy;
      gz = sz + sz;
      return;
    }
  }
}

// a fold's value (csdf.py _fold_value); smooth_union is sdf smooth_min:
// h = max(k - |a - b|, 0) / k, min(a, b) - ((h*h*h) * k) * f32(1/6)
template <class K>
__device__ __forceinline__ float fold_value(int op, const K& c, float a, float b) {
  switch (op) {
    case OP_MIN: return vminn(a, b);
    case OP_MAX: return vmaxn(a, b);
    case OP_SUB: return vmaxn(a, -b);
    default: {  // OP_SMOOTH
      const float k = c(0);
      const float h = vmaxn(k - fabsf(a - b), 0.0f) / k;
      return vminn(a, b) - (((h * h) * h) * k) * c(1);
    }
  }
}

__device__ __forceinline__ float fold_value(int op, const int* w, float a, float b) {
  return fold_value(op, RowWords{w}, a, b);
}

// the cotangents of a fold's operands a and b, whose value is out (csdf.py
// _fold_bwd)
__device__ __forceinline__ void fold_bwd(int op, const int* w, float a, float b, float out, float ct,
                                         float& ct_a, float& ct_b) {
  switch (op) {
    case OP_MIN:
    case OP_MAX:
      ct_a = ct * tie_weight(a, out, b);
      ct_b = ct * tie_weight(b, out, a);
      return;
    case OP_SUB: {
      const float nb = -b;
      ct_a = ct * tie_weight(a, out, nb);
      ct_b = -(ct * tie_weight(nb, out, a));
      return;
    }
    default: {  // OP_SMOOTH
      const float k = prog_k(w, 0), c6 = prog_k(w, 1);
      const float delta = a - b;
      const float u = k - fabsf(delta);
      const float hm = vmaxn(u, 0.0f);
      const float h = hm / k;
      const float h2 = h * h;
      const float m = vminn(a, b);
      const float ct_h3 = (-ct * c6) * k;
      const float ct_h2 = ct_h3 * h;
      const float ct_h = (h2 * ct_h3 + ct_h2 * h) + h * ct_h2;
      const float ct_u = (ct_h / k) * tie_weight(u, hm, 0.0f);
      const float ct_abs = -ct_u;
      const float ct_delta = delta >= 0.0f ? ct_abs : -ct_abs;  // jax: d|x| = +1 at 0
      ct_a = ct * tie_weight(a, m, b) + ct_delta;
      ct_b = ct * tie_weight(b, m, a) - ct_delta;
      return;
    }
  }
}

// the program's value at (x, y, z); with a tape, every instruction's value
// (a pop's: its frame's value; a push's is not written)
template <bool Taped>
__device__ __forceinline__ float composed_forward(const SceneDesc& s, float x, float y, float z,
                                                  float* tape) {
  float stack[BSDMG_STACK];
  float frames[BSDMG_FRAMES][3];
  int sp = 0, fp = 0;
#pragma unroll 1
  for (int pc = 0; pc < s.program_length; ++pc) {
    const int* w = s.program + pc * BSDMG_WORDS;
    const int op = __ldg(w);
    if (op <= OP_PLANE) {
      stack[sp++] = primitive_value(op, w, x, y, z);
    } else if (op <= OP_SMOOTH) {
      const float b = stack[--sp];
      stack[sp - 1] = fold_value(op, w, stack[sp - 1], b);
    } else if (op == OP_SHELL) {
      stack[sp - 1] = fabsf(stack[sp - 1]) - prog_k(w, 0);
    } else if (op == OP_POP) {
      --fp;
      x = frames[fp][0];
      y = frames[fp][1];
      z = frames[fp][2];
    } else {
      frames[fp][0] = x;
      frames[fp][1] = y;
      frames[fp][2] = z;
      ++fp;
      frame_coords(w, x, y, z);
      continue;
    }
    if (Taped) tape[pc] = stack[sp - 1];
  }
  return stack[0];
}

// the program's value at N points at once by the forward walk (csdf.py
// walk_words, read on the CPU by walk_csdf), composed_forward's bit for bit
// at each point, which the card checks against _program_csdf, the node
// program's twin: an instruction is a header (opcode, action, its words)
// and its constants, in the block's shared memory (stage_walk), read and
// dispatched once and applied to every point in turn (K3's and K7's fd4
// stencils walk the four points of an axis, project.cuh fd4_grad; the
// others one, composed_sdf). A primitive sets the top, pushes the top below
// it first, or folds its value into it (a fused fold, its constants after
// the primitive's); an unfused fold pops its left operand. Only the stack
// below the top and the frames are arrays in local memory.
template <int N>
__device__ __forceinline__ void composed_sdf_n(const SceneDesc& s, float (&x)[N], float (&y)[N],
                                               float (&z)[N], float (&top)[N]) {
  float stack[BSDMG_STACK][N];
  float frames[BSDMG_FRAMES][3][N];
  int sp = 0, fp = 0;
#pragma unroll 1
  for (int pc = 0; pc < s.walk_words;) {
    const int head = bsdmg_walk[pc];
    const int op = head & 15, action = (head >> 4) & 15, size = head >> 8;
    if (op <= OP_PLANE) {
      if (action == BSDMG_WALK_PUSH) {
#pragma unroll
        for (int j = 0; j < N; ++j) stack[sp][j] = top[j];
        ++sp;
      }
      float v[N];
      switch (op) {  // each case one primitive, N times
#define BSDMG_WALK_N(Op)                                                                      \
  case Op:                                                                                  \
    _Pragma("unroll") for (int j = 0; j < N; ++j) {                                         \
      v[j] = primitive_value(Op, WalkWords{pc + 1}, x[j], y[j], z[j]);                      \
    }                                                                                       \
    break;
        BSDMG_WALK_N(OP_SPHERE)
        BSDMG_WALK_N(OP_BOX)
        BSDMG_WALK_N(OP_CAPSULE)
        BSDMG_WALK_N(OP_SKELETON)
        BSDMG_WALK_N(OP_TORUS)
        BSDMG_WALK_N(OP_CYLINDER)
        default:
          BSDMG_WALK_N(OP_PLANE)
#undef BSDMG_WALK_N
      }
      if (action <= BSDMG_WALK_PUSH) {
#pragma unroll
        for (int j = 0; j < N; ++j) top[j] = v[j];
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          top[j] = fold_value(action, WalkWords{pc + size - 2}, top[j], v[j]);
        }
      }
    } else if (op <= OP_SMOOTH) {
      --sp;
#pragma unroll
      for (int j = 0; j < N; ++j) top[j] = fold_value(op, WalkWords{pc + 1}, stack[sp][j], top[j]);
    } else if (op == OP_SHELL) {
      const float t = WalkWords{pc + 1}(0);
#pragma unroll
      for (int j = 0; j < N; ++j) top[j] = fabsf(top[j]) - t;
    } else if (op == OP_POP) {
      --fp;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        x[j] = frames[fp][0][j];
        y[j] = frames[fp][1][j];
        z[j] = frames[fp][2][j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        frames[fp][0][j] = x[j];
        frames[fp][1][j] = y[j];
        frames[fp][2][j] = z[j];
        frame_coords(op, WalkWords{pc + 1}, x[j], y[j], z[j]);
      }
      ++fp;
    }
    pc += size;
  }
}

// the program's value at (x, y, z): composed_sdf_n at one point
__device__ __forceinline__ float composed_sdf(const SceneDesc& s, float x, float y, float z) {
  float xs[1] = {x}, ys[1] = {y}, zs[1] = {z}, top[1] = {0.0f};
  composed_sdf_n<1>(s, xs, ys, zs, top);
  return top[0];
}

// Copies the forward walk of s's program (its words follow the taped walk's
// rows in s.program: csdf.py NodeProgram.on_device) into the block's
// shared memory. Every thread of the block calls it, first; with `sync` it
// waits for the block's copy, else a barrier of the kernel's own before the
// first walk does.
__device__ __forceinline__ void stage_walk(const SceneDesc& s, bool sync) {
  const int* words = s.program + BSDMG_WORDS * s.program_length;
  for (int k = threadIdx.x; k < s.walk_words; k += blockDim.x) bsdmg_walk[k] = __ldg(words + k);
  if (sync) __syncthreads();
}

// Whether a Composed kernel takes s's program: within the small tier of the
// forward walk (csdf.py large_tier), and with `taped` of the taped walk too.
inline bool walk_fits(const SceneDesc& s, bool taped) {
  return s.walk_words <= BSDMG_WALK_WORDS && s.program_depth <= BSDMG_STACK &&
         s.program_frames <= BSDMG_FRAMES && !(taped && s.program_length > BSDMG_PROGRAM);
}

// the value (composed_sdf's bit for bit) and the gradient, reverse mode
// over the tape (csdf.py _program_value_and_grad): a fold pops its
// cotangent and pushes its left operand's, then its right one's; a pop, met
// first, enters its frame again (its coordinates recomputed from the push),
// the push leaves it, mapping the frame's gradient back (a transform by R,
// a wrap unchanged)
__device__ __forceinline__ void composed_sdf_grad(const SceneDesc& s, float x, float y, float z,
                                                  float& d, float& gx, float& gy, float& gz) {
  float tape[BSDMG_PROGRAM];
  d = composed_forward<true>(s, x, y, z, tape);
  float cts[BSDMG_STACK];
  float frames[BSDMG_FRAMES][6];
  int cp = 0, fp = 0;
  cts[cp++] = 1.0f;
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
#pragma unroll 1
  for (int pc = s.program_length - 1; pc >= 0; --pc) {
    const int* w = s.program + pc * BSDMG_WORDS;
    const int op = __ldg(w);
    if (op <= OP_PLANE) {
      float g0, g1, g2;
      primitive_grad(op, w, x, y, z, cts[--cp], g0, g1, g2);
      ax = ax + g0;
      ay = ay + g1;
      az = az + g2;
    } else if (op <= OP_SMOOTH) {
      const float ct = cts[--cp];
      float ct_a, ct_b;
      fold_bwd(op, w, tape[__ldg(w + 1)], tape[pc - 1], tape[pc], ct, ct_a, ct_b);
      cts[cp++] = ct_a;
      cts[cp++] = ct_b;
    } else if (op == OP_SHELL) {
      const float ct = cts[cp - 1];
      cts[cp - 1] = tape[pc - 1] >= 0.0f ? ct : -ct;
    } else if (op == OP_POP) {
      float* f = frames[fp++];
      f[0] = x;
      f[1] = y;
      f[2] = z;
      f[3] = ax;
      f[4] = ay;
      f[5] = az;
      frame_coords(s.program + __ldg(w + 1) * BSDMG_WORDS, x, y, z);
      ax = ay = az = 0.0f;
    } else {
      if (op == OP_PUSH_TRANSFORM) {
        const float cx = ax, cy = ay, cz = az;
        ax = (prog_k(w, 3) * cx + prog_k(w, 4) * cy) + prog_k(w, 5) * cz;
        ay = (prog_k(w, 6) * cx + prog_k(w, 7) * cy) + prog_k(w, 8) * cz;
        az = (prog_k(w, 9) * cx + prog_k(w, 10) * cy) + prog_k(w, 11) * cz;
      }
      const float* f = frames[--fp];
      x = f[0];
      y = f[1];
      z = f[2];
      ax = f[3] + ax;
      ay = f[4] + ay;
      az = f[5] + az;
    }
  }
  gx = ax;
  gy = ay;
  gz = az;
}

// ---------------------------------------------------------------------------
// the large tier (ComposedLarge): the same walks over a program of any
// length, stack depth and nesting, its stack, frames (3 slots a frame),
// tape, cotangents and the backward's frames (6 a frame) in the scratch
// buffer SceneDesc::scratch (program.cuh SpilledSlots). The small tier
// above keeps its arrays, and with them its registers and stack.
// ---------------------------------------------------------------------------

template <bool Taped>
__device__ __forceinline__ float spilled_forward(const SceneDesc& s, float x, float y, float z,
                                                 SpilledSlots<float>& stack,
                                                 SpilledSlots<float>& frames,
                                                 SpilledSlots<float>& tape) {
  int sp = 0, fp = 0;
#pragma unroll 1
  for (int pc = 0; pc < s.program_length; ++pc) {
    const int* w = s.program + pc * BSDMG_WORDS;
    const int op = __ldg(w);
    if (op <= OP_PLANE) {
      stack.set(sp++, primitive_value(op, w, x, y, z));
    } else if (op <= OP_SMOOTH) {
      const float b = stack.get(--sp);
      stack.set(sp - 1, fold_value(op, w, stack.get(sp - 1), b));
    } else if (op == OP_SHELL) {
      stack.set(sp - 1, fabsf(stack.get(sp - 1)) - prog_k(w, 0));
    } else if (op == OP_POP) {
      --fp;
      x = frames.get(3 * fp);
      y = frames.get(3 * fp + 1);
      z = frames.get(3 * fp + 2);
    } else {
      frames.set(3 * fp, x);
      frames.set(3 * fp + 1, y);
      frames.set(3 * fp + 2, z);
      ++fp;
      frame_coords(w, x, y, z);
      continue;
    }
    if (Taped) tape.set(pc, stack.get(sp - 1));
  }
  return stack.get(0);
}

// the stack and the frames: a thread's first program_depth + 3 *
// program_frames slots (csdf.py program_slots sizes the buffer)
struct SpilledStacks {
  SpilledSlots<float> stack, frames;
  __device__ __forceinline__ explicit SpilledStacks(const SceneDesc& s)
      : stack(s.scratch, s.scratch_threads, 0),
        frames(s.scratch, s.scratch_threads, s.program_depth) {}
};

__device__ __forceinline__ float composed_sdf_large(const SceneDesc& s, float x, float y,
                                                    float z) {
  SpilledStacks st(s);
  return spilled_forward<false>(s, x, y, z, st.stack, st.frames, st.stack);
}

// composed_sdf_grad's backward, its cotangents and frames after the tape
__device__ __forceinline__ void composed_sdf_grad_large(const SceneDesc& s, float x, float y,
                                                        float z, float& d, float& gx, float& gy,
                                                        float& gz) {
  SpilledStacks st(s);
  const long long tape_at = s.program_depth + 3LL * s.program_frames;
  const long long cts_at = tape_at + s.program_length;
  SpilledSlots<float> tape(s.scratch, s.scratch_threads, tape_at);
  SpilledSlots<float> cts(s.scratch, s.scratch_threads, cts_at);
  SpilledSlots<float> frames(s.scratch, s.scratch_threads, cts_at + s.program_depth);
  d = spilled_forward<true>(s, x, y, z, st.stack, st.frames, tape);
  int cp = 0, fp = 0;
  cts.set(cp++, 1.0f);
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
#pragma unroll 1
  for (int pc = s.program_length - 1; pc >= 0; --pc) {
    const int* w = s.program + pc * BSDMG_WORDS;
    const int op = __ldg(w);
    if (op <= OP_PLANE) {
      float g0, g1, g2;
      primitive_grad(op, w, x, y, z, cts.get(--cp), g0, g1, g2);
      ax = ax + g0;
      ay = ay + g1;
      az = az + g2;
    } else if (op <= OP_SMOOTH) {
      const float ct = cts.get(--cp);
      float ct_a, ct_b;
      fold_bwd(op, w, tape.get(__ldg(w + 1)), tape.get(pc - 1), tape.get(pc), ct, ct_a, ct_b);
      cts.set(cp++, ct_a);
      cts.set(cp++, ct_b);
    } else if (op == OP_SHELL) {
      const float ct = cts.get(cp - 1);
      cts.set(cp - 1, tape.get(pc - 1) >= 0.0f ? ct : -ct);
    } else if (op == OP_POP) {
      const int f = 6 * fp++;
      frames.set(f, x);
      frames.set(f + 1, y);
      frames.set(f + 2, z);
      frames.set(f + 3, ax);
      frames.set(f + 4, ay);
      frames.set(f + 5, az);
      frame_coords(s.program + __ldg(w + 1) * BSDMG_WORDS, x, y, z);
      ax = ay = az = 0.0f;
    } else {
      if (op == OP_PUSH_TRANSFORM) {
        const float cx = ax, cy = ay, cz = az;
        ax = (prog_k(w, 3) * cx + prog_k(w, 4) * cy) + prog_k(w, 5) * cz;
        ay = (prog_k(w, 6) * cx + prog_k(w, 7) * cy) + prog_k(w, 8) * cz;
        az = (prog_k(w, 9) * cx + prog_k(w, 10) * cy) + prog_k(w, 11) * cz;
      }
      const int f = 6 * --fp;
      x = frames.get(f);
      y = frames.get(f + 1);
      z = frames.get(f + 2);
      ax = frames.get(f + 3) + ax;
      ay = frames.get(f + 4) + ay;
      az = frames.get(f + 5) + az;
    }
  }
  gx = ax;
  gy = ay;
  gz = az;
}
