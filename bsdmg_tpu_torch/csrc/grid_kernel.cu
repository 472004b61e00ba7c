// K8, K9 and P1: the sphere trace and the point sampler of mesh-asset
// (grid SDF) scenes, one thread per ray or per point.
//
// Replaces three TPU kernels of the JAX package:
// - K8, bsdmg_tpu/ops/pallas/grid_kernel.py::_grid_trace_kernel (the
//   pallas_call at grid_kernel.py:143 of grid_trace_pallas): a march from
//   depth 0 over a grid SDF sampled by eight gathers. Here
//   grid_march_kernel<Resumed>, which also runs the fine finish of
//   the contraction route, resumed, where the JAX package marches XLA
//   gathers (grid_kernel.py:496-558).
// - K9, grid_kernel.py::_contraction_kernel (the pallas_call at :368 of
//   grid_trace_contraction_pallas): one resumable level of the contraction
//   ladder, sampled by hat weights against an exact or a bf16 table. Here
//   contraction_kernel<float> or <__nv_bfloat16>.
// - P1, tools/probe_mxu.py::kernel (the pallas_call at probe_mxu.py:32):
//   the hat-weight trilinear sample of points. Here
//   grid_sample_kernel<Sampler>; the render runs it with InterpF32 on the
//   twelve fd4 stencil points of every hit.
//
// The march is render_kernel.py::_march with omega = 1 and no slab cull
// (the grid route has none): a ray that is not active keeps its depth,
// steps and outcome; an active ray starts at outcome STEP_LIMIT from
// depth0 and steps0, always takes its first iteration, and stops at a hit,
// past the depth limit or when its steps reach min(budget, step_limit).
//
// What bounds them on Hopper: instruction issue. A march step is 100-160
// SASS instructions (83 counted FP32 operations for a hat sample, 59 for
// the trilinear one, 9 more for the step) around the table's reads; at the
// 32^3 level K9 issued 72% of what the SM can (PERF.md). A warp runs as
// long as its slowest ray. K8's finish marches 21% of the frame's rays; a
// thread and 28 B for each of the others would be 46 MB of the 77 MB a
// launch over every ray moves.
//
// What the design does about it. Both take the frame's rays in 16x8 tiles
// of 8x4 warp patches (K1's order), a block of 128 threads a tile, so a
// warp's rays are neighbours and end their marches together more often
// than a row of 32. K9 reads each level from a cell-packed copy
// (ops/cuda/grid_kernel.py::cell_table; 477 KB at 32^3 and 4 MB at 64^3 in
// bf16, which L2 holds): one 16-byte load a sample in bf16, two in
// float32, in place of eight dependent gathers and their address
// arithmetic; with the sampler's two trims (grid_sdf.cuh: no max on the hat
// weights, no square root inside the box) a bf16 step is 134 instructions.
// A 32^3 level read from shared memory was slower (PERF.md). K8 resumed
// lists each tile's active rays in shared memory in thread order (a ballot
// a warp and the warps' counts; no atomics, no capacity, no extra launch)
// and marches them on threads 0 .. count - 1, so a tile with 27 active rays
// runs one warp, not four; a ray that is not active costs its flag, and
// the route's finish writes into its own state planes. Its sampler
// (InterpGather) reads the raw table's eight corners at fixed offsets from
// one address, without InterpF32's min(x0 + 1, r - 1): fewer instructions
// a step, which decide here. A cell-packed float32 copy (two 16-byte loads
// a sample) saved a tenth of the finish but cost more to build, once per
// grid, than it saved on a frame, and was removed (PERF.md). What bounds
// K8's finish now: a warp runs as long as its tile's longest ray
// (compaction packs the rays into fewer warps but keeps that ray), so it
// issues about a third of the SM's rate at 8 times its bound (PERF.md). P1
// keeps one thread per point over the raw table.
//
// Numerics: -fmad=false, no fast math, and the plain twins' order
// (bsdmg_tpu_torch/ops/cuda/grid_kernel.py): depth, steps, outcome and the
// sampled values equal the twins' bit for bit; the layouts change where a
// corner is read from, not its value or the order of the sums.

#include "common.cuh"
#include "grid_sdf.cuh"

// the march's limits, as float32 and int
struct GridMarch {
  float collision_distance;
  float depth_limit;
  int step_cap;  // min(budget, step_limit)
};

// The march of ray i from depth and steps (0, 0 when fresh): returns the
// outcome and leaves the end depth and steps in `depth` and `steps`.
template <class Sampler>
__device__ __forceinline__ int march_steps(const Sampler& s, const GridMarch& m,
                                           const float* __restrict__ origins,
                                           const float* __restrict__ directions,
                                           const float* __restrict__ cone, int i, float& depth,
                                           int& steps) {
  const float ox = origins[3 * i], oy = origins[3 * i + 1], oz = origins[3 * i + 2];
  const float dx = directions[3 * i], dy = directions[3 * i + 1], dz = directions[3 * i + 2];
  const float c = cone[i];
  for (;;) {
    const float cd = c * depth;
    const float dist = s(ox + depth * dx, oy + depth * dy, oz + depth * dz);
    if (dist <= cd + m.collision_distance) return COLLISION;
    depth = (depth + dist) - cd;
    if (depth > m.depth_limit) return DEPTH_LIMIT;
    if (++steps >= m.step_cap) return STEP_LIMIT;
  }
}

// K9's march of ray i. origins and directions are (n, 3), cone (n,). With
// active == nullptr the ray starts fresh (depth 0, steps 0); otherwise
// active, depth0, steps0 and outcome0 are the previous level's (n,) planes,
// and a ray that is not active copies its three into the outputs.
template <class Sampler>
__device__ __forceinline__ void march_ray(const Sampler& s, const GridMarch& m,
                                          const float* __restrict__ origins,
                                          const float* __restrict__ directions,
                                          const float* __restrict__ cone,
                                          const int* __restrict__ active,
                                          const float* __restrict__ depth0,
                                          const int* __restrict__ steps0,
                                          const int* __restrict__ outcome0,
                                          float* __restrict__ depth_out, int* __restrict__ steps_out,
                                          int* __restrict__ outcome_out, int i) {
  float depth = 0.0f;
  int steps = 0;
  if (active != nullptr) {
    depth = depth0[i];
    steps = steps0[i];
    if (!active[i]) {
      depth_out[i] = depth;
      steps_out[i] = steps;
      outcome_out[i] = outcome0[i];
      return;
    }
  }
  const int outcome = march_steps(s, m, origins, directions, cone, i, depth, steps);
  depth_out[i] = depth;
  steps_out[i] = steps;
  outcome_out[i] = outcome;
}

#define MARCH_PLANES                                                                          \
  const float *__restrict__ origins, const float *__restrict__ directions,                   \
      const float *__restrict__ cone, const int *__restrict__ active,                        \
      const float *__restrict__ depth0, const int *__restrict__ steps0,                      \
      const int *__restrict__ outcome0, float *__restrict__ depth_out,                       \
      int *__restrict__ steps_out, int *__restrict__ outcome_out
#define MARCH_ARGS                                                                            \
  origins, directions, cone, active, depth0, steps0, outcome0, depth_out, steps_out, outcome_out

// The ray of lane `lane` of warp patch p over a frame of h rows of w rays:
// the frame in 16x8 tiles, row by row, each tile in four 8x4 patches (K1's
// blocks and warps, render_kernel.cu::block_pixel); -1 past the frame.
__device__ __forceinline__ int tile_ray(int p, int lane, int w, int h) {
  const int tiles_x = (w + 15) / 16;
  const int tile = p >> 2, q = p & 3;
  const int px = (tile % tiles_x) * 16 + (q & 1) * 8 + (lane & 7);
  const int py = (tile / tiles_x) * 8 + (q >> 1) * 4 + (lane >> 3);
  return px < w && py < h ? py * w + px : -1;
}

// K8: a block of 128 threads per 16x8 tile. Fresh, thread t marches the
// tile's ray t from depth 0. Resumed, the block lists the tile's active rays
// in shared memory in thread order (a ballot a warp, then the warps' counts
// in order; no atomics), threads 0 .. count - 1 march them from depth0 and
// steps0, and only the listed rays are read or written beyond their flags:
// a ray that is not active keeps whatever its output planes hold. The route
// passes its own state planes as the outputs (depth_out == depth0, steps_out
// == steps0), so those four pointers are not __restrict__; each listed ray
// reads its depth and steps before it writes them, in the same thread.
template <bool Resumed>
__global__ void __launch_bounds__(128)
grid_march_kernel(const InterpGather s, const GridMarch m, const float* __restrict__ origins,
                  const float* __restrict__ directions, const float* __restrict__ cone,
                  const int* __restrict__ active, const float* depth0, const int* steps0,
                  float* depth_out, int* steps_out, int* __restrict__ outcome_out, int w, int h) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int i = tile_ray(blockIdx.x * 4 + warp, lane, w, h);
  float depth = 0.0f;
  int steps = 0;
  if (Resumed) {
    __shared__ int listed[128];
    __shared__ int warp_counts[4];
    const bool marched = i >= 0 && active[i] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, marched);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int slot = __popc(ballot & ((1u << lane) - 1u)), count = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < warp) slot += warp_counts[k];
      count += warp_counts[k];
    }
    if (marched) listed[slot] = i;
    __syncthreads();
    if (static_cast<int>(threadIdx.x) >= count) return;
    i = listed[threadIdx.x];
    depth = depth0[i];
    steps = steps0[i];
  } else if (i < 0) {
    return;
  }
  const int outcome = march_steps(s, m, origins, directions, cone, i, depth, steps);
  depth_out[i] = depth;
  steps_out[i] = steps;
  outcome_out[i] = outcome;
}

// K9 on a cell-packed table: a block of 128 threads per 16x8 tile.
template <class T>
__global__ void __launch_bounds__(128)
contraction_kernel(const HatCells<T> s, const GridMarch m, MARCH_PLANES, int w, int h) {
  const int i = tile_ray(blockIdx.x * 4 + (threadIdx.x >> 5), threadIdx.x & 31, w, h);
  if (i >= 0) march_ray(s, m, MARCH_ARGS, i);
}

// One thread per point: out[i] = s(x[i], y[i], z[i]).
template <class Sampler>
__global__ void __launch_bounds__(128)
grid_sample_kernel(const Sampler s, const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ z, float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = s(x[i], y[i], z[i]);
}

// sampler kinds of the C interface (ops/cuda/grid_kernel.py)
enum { SAMPLER_INTERP_F32 = 0, SAMPLER_HAT_F32 = 1, SAMPLER_HAT_BF16 = 2 };

template <class Sampler>
static int launch_sample(const Sampler& s, const float* x, const float* y, const float* z,
                         float* out, int n, cudaStream_t stream) {
  grid_sample_kernel<Sampler><<<(n + 127) / 128, 128, 0, stream>>>(s, x, y, z, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

// Launches K8 (kind SAMPLER_INTERP_F32: table is the grid's (r^3,)
// float32 values, C order) or K9 (SAMPLER_HAT_F32 or SAMPLER_HAT_BF16: table is the level's cell-packed
// copy) on `stream` over n rays, taken in 16x8 tiles of a frame w rays
// wide. active, depth0, steps0 and outcome0 are all null (a fresh march) or
// all (n,) planes on the device. Resumed, K9 writes every ray's outputs
// (a ray that is not active copies its state) and K8 only the active rays':
// its outputs may be depth0 and steps0 themselves. Returns the cudaError_t
// of the launch, or cudaErrorInvalidValue for an unknown kind or a frame
// width that does not divide n.
int bsdmg_grid_march(int kind, const GridBox* box, const void* table, float margin,
                     const GridMarch* march, const float* origins, const float* directions,
                     const float* cone, const int* active, const float* depth0, const int* steps0,
                     const int* outcome0, float* depth_out, int* steps_out, int* outcome_out,
                     int n, int w, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const GridMarch& m = *march;
  if (w <= 0 || n % w != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int h = n / w;
  const int tiles = ((w + 15) / 16) * ((h + 7) / 8);
  if (kind == SAMPLER_INTERP_F32) {
    const InterpGather s{static_cast<const float*>(table), *box};
    if (active != nullptr) {
      grid_march_kernel<true><<<tiles, 128, 0, st>>>(s, m, origins, directions, cone, active,
                                                      depth0, steps0, depth_out, steps_out,
                                                      outcome_out, w, h);
    } else {
      grid_march_kernel<false><<<tiles, 128, 0, st>>>(s, m, origins, directions, cone, nullptr,
                                                       nullptr, nullptr, depth_out, steps_out,
                                                       outcome_out, w, h);
    }
  } else if (kind == SAMPLER_HAT_BF16) {
    const HatCells<__nv_bfloat16> s{static_cast<const uint4*>(table), *box, margin};
    contraction_kernel<<<tiles, 128, 0, st>>>(s, m, MARCH_ARGS, w, h);
  } else if (kind == SAMPLER_HAT_F32) {
    const HatCells<float> s{static_cast<const float4*>(table), *box, margin};
    contraction_kernel<<<tiles, 128, 0, st>>>(s, m, MARCH_ARGS, w, h);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches P1 on `stream` over n points: x, y, z (n,) float32 in, out (n,)
// float32, all on the device. Returns the cudaError_t of the launch.
int bsdmg_grid_sample(int kind, const GridBox* box, const void* table, float margin,
                      const float* x, const float* y, const float* z, float* out, int n,
                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case SAMPLER_INTERP_F32:
      return launch_sample(InterpF32{static_cast<const float*>(table), *box}, x, y, z, out, n,
                           st);
    case SAMPLER_HAT_F32:
      return launch_sample(HatF32{static_cast<const float*>(table), *box, margin}, x, y, z,
                           out, n, st);
    case SAMPLER_HAT_BF16:
      return launch_sample(HatBf16{static_cast<const __nv_bfloat16*>(table), *box, margin}, x,
                           y, z, out, n, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int bsdmg_grid_box_size(void) { return static_cast<int>(sizeof(GridBox)); }
int bsdmg_grid_march_size(void) { return static_cast<int>(sizeof(GridMarch)); }

}  // extern "C"
