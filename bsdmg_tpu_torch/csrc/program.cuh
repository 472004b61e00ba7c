// What the two interpreters of a composed scene's postfix program share:
// the node program of K1, K2, K3, K6 and K7 (composed.cuh), whose constants
// are baked, and the parameter program of K4 and K5 (param_program.cuh),
// whose instructions name parameter slots. Both come from ops/cuda/csdf.py
// (node_program, param_program) in the same order.
//
// Each interpreter comes in two tiers, which ops/cuda/csdf.py::large_tier
// picks for a program. The small tier keeps its stacks, frames and tape in
// local arrays of the caps below. The large tier takes any program: they
// live in a device scratch buffer that the wrapper sizes per launch from
// the program's length and depths (SpilledSlots), laid out slot-major,
// slot k of thread t at base[k * threads + t], so a warp's accesses
// coalesce as local memory's do.

#pragma once

#define BSDMG_PROGRAM 64  // csdf.py PROGRAM_CAP
#define BSDMG_STACK 16    // csdf.py STACK_CAP
#define BSDMG_FRAMES 8    // csdf.py FRAME_CAP

// csdf.py OP_*
enum Op {
  OP_SPHERE,
  OP_BOX,
  OP_CAPSULE,
  OP_SKELETON,
  OP_TORUS,
  OP_CYLINDER,
  OP_PLANE,
  OP_MIN,
  OP_MAX,
  OP_SUB,
  OP_SMOOTH,
  OP_SHELL,
  OP_PUSH_TRANSFORM,
  OP_PUSH_WRAP,
  OP_POP
};

// this thread's index in its launch
__device__ __forceinline__ long long launch_thread() {
  const long long block =
      ((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  return block * (blockDim.x * blockDim.y * blockDim.z) +
         (threadIdx.z * blockDim.y + threadIdx.y) * blockDim.x + threadIdx.x;
}

// slots of T in the scratch buffer from slot `first` of this thread on: the
// large tier. T's floats take consecutive slots.
template <class T>
struct SpilledSlots {
  static constexpr int W = sizeof(T) / sizeof(float);
  float* base;       // slot 0 of this thread
  long long stride;  // the threads the buffer holds
  __device__ __forceinline__ SpilledSlots(float* scratch, long long threads, long long first)
      : base(scratch + first * threads + launch_thread()), stride(threads) {}
  __device__ __forceinline__ T get(int k) const {
    T x;
    float* f = reinterpret_cast<float*>(&x);
#pragma unroll
    for (int j = 0; j < W; ++j) f[j] = base[(long long)(k * W + j) * stride];
    return x;
  }
  __device__ __forceinline__ void set(int k, const T& x) {
    const float* f = reinterpret_cast<const float*>(&x);
#pragma unroll
    for (int j = 0; j < W; ++j) base[(long long)(k * W + j) * stride] = f[j];
  }
};
