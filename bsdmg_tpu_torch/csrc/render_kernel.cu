// The reference-scene render kernels, one thread per pixel:
//
// K1 render_kernel: fused sphere trace + shade. Replaces the TPU kernel
//    bsdmg_tpu/ops/pallas/render_kernel.py::_trace_kernel with shade=True,
//    the pallas_call at render_kernel.py:526 (_fused_call_resumable) of the
//    JAX package's default render path and of its block retirement
//    (_render_fused_blocks). Per ray: the slab cull (_slab_cull), the march
//    (_march), fd4 normals (_fd_normal), the Lambert two-colour mix
//    (ops/shade.py::shade_planes) and the ACES tonemap (_aces_plane).
// K2 trace_kernel: the same march alone, resumable. Replaces
//    _trace_kernel with shade=False, the pallas_call at render_kernel.py:495
//    (_trace_call) of trace_pallas, sphere_trace_pallas, the row two-phase
//    pipeline (_trace_pipeline) and the unswizzled render.
// K3 shade_kernel: shade only, from depth and outcome. Replaces
//    render_kernel.py::_shade_kernel, the pallas_call at :563 (_shade_call)
//    that follows every K2 pipeline.
//
// One march core (march_ray) serves K1 and K2, templated on the scene's
// structure, the slab cull and over-relaxation; one epilogue (shade_pixel)
// serves K1 and K3. K1 is
// also templated on its mode: FRESH is the default render (no carried
// state, budget step_limit; the code K1 always ran), PHASE_A the first phase
// of block retirement (a step budget, the `active` plane written), RESUME
// its second phase over a device-resident list of the 16x8 blocks that
// still hold an active ray, in place. K2 is templated on LISTED: a
// device-resident list of rays and its count, the compacted tail of the row
// two-phase pipeline, marched in place in the full-frame planes. Threads
// past the count exit at once, so the host never reads the count.
//
// What bounds them on Hopper: FP32 and SFU work per march step (one scene
// SDF is two sets of 12 capsules in 3 factorised groups each, a sphere and
// a smooth-min: 128 FP32 operations, 3 of them sqrt) and warp divergence,
// since a warp runs as long as its slowest ray and silhouette rays take up
// to 256 steps. Memory traffic is small: K1 reads 28 B a ray (origin,
// direction, cone) and writes 12 B (RGB), 52 B with the depth, steps and
// outcome planes; K2 reads 28 B, 44 B when it resumes, and writes 16 B; K3
// reads a pixel's outcome (4 B), a hit's depth and ray (28 B) more, and
// writes 12 B.
//
// What the design does about it: each warp covers a compact 8x4 pixel patch
// (the TPU path's 32x32 swizzle, render_kernel.py:834-854, stood in for the
// same thing), so its rays finish in similar step counts; each ray leaves
// the loop as soon as it resolves; the scene descriptor is a by-value
// kernel parameter, so every thread reads the same constant-bank words, and
// the scene's structure is a template parameter (Box<Frame, Transform>,
// scene_sdf.cuh), so the SDF is straight-line code with no runtime picks or
// tests. K1's fd4 stencil is a rolled loop around one inlined SDF, which
// keeps it at 32 registers and full occupancy for its march (the unrolled,
// shared-term stencil of project.cuh took it to 43). K3 lists each tile's
// hits and runs the shared-term stencil on full warps.
//
// The near/far split of the JAX kernels (render_kernel.py:412-432, the
// `split` of csdf.py::compile_scene_split) is taken per warp: K1 and K2
// have a second instantiation (render_split_kernel, trace_split_kernel) for
// the reference render scene, whose warps vote once (__any_sync) whether
// any of their rays can reach the near component's inflated box. A warp
// whose rays all miss it marches the wireframe alone (the Far structure),
// about half the full scene's work a step; the others march the full
// scene. The granule is the warp's 8x4 patch (K2's listed tail: its 32
// listed rays, listed in patch order) where JAX's is its tile; each ray's
// result is an exact march of the only surface it can reach either way.
// K1 · split shades a far patch's hits with the far scene, as JAX's fused
// epilogue does, on full warps from a list of each block's hits; K3 shades
// every hit with the full scene, as JAX's _shade_kernel does. A composed
// scene's program runs in the Composed instantiations by its forward walk
// (composed.cuh composed_sdf: the words staged by each block in its shared
// memory, the top of the stack in a register), or, beyond the caps of its
// stack and frames, in the ComposedLarge ones, its stacks in
// SceneDesc::scratch.
//
// Numerics: built without --use_fast_math (IEEE sqrtf and division) and
// with -fmad=false (ops/cuda/build.py). Every float constant arrives as the
// float32 the plain PyTorch twins (bsdmg_tpu_torch/ops/cuda/render_kernel.py)
// compute with, and each sum and product runs in the JAX kernel's order, so
// each kernel's planes and image equal its twin's bit for bit. With FMA
// contraction, silhouette rays flip the hit test `dist <= cd + eps` and end
// with other step counts. The scene SDF is scene_sdf.cuh's, shared with the
// mesh kernels; the slab cull and the shading are common.cuh's, shared with
// K4 and K5.

#include <type_traits>

#include "project.cuh"
#include "scene_sdf.cuh"

enum { K1_FRESH = 0, K1_PHASE_A = 1, K1_RESUME = 2 };

struct Ray {
  float ox, oy, oz, dx, dy, dz, c;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ origins,
                                        const float* __restrict__ directions,
                                        const float* __restrict__ cone, long long i) {
  return Ray{origins[3 * i],    origins[3 * i + 1],    origins[3 * i + 2], directions[3 * i],
             directions[3 * i + 1], directions[3 * i + 2], cone[i]};
}

// the pixel of thread t in the 16x8 block (bx, by): each of the block's 4
// warps covers an 8x4 patch
__device__ __forceinline__ void tile_pixel(int bx, int by, int t, int& px, int& py) {
  const int lane = t & 31;
  const int warp = t >> 5;
  px = bx * 16 + (warp & 1) * 8 + (lane & 7);
  py = by * 8 + (warp >> 1) * 4 + (lane >> 3);
}

// the pixel of this thread in the 16x8 block (bx, by)
__device__ __forceinline__ void block_pixel(int bx, int by, int& px, int& py) {
  tile_pixel(bx, by, threadIdx.x, px, py);
}

// The march of one active ray (render_kernel.py:336-379 and _march), from
// the carried (depth, steps); `outcome` holds the carried outcome on entry.
// With Cull a ray that cannot reach the bounds keeps its outcome and gets
// depth 1.01 * depth_limit (:355-368); every other ray stops at the box's
// exit depth, or at the depth limit without Cull. The march always takes
// its first iteration, then stops when its steps reach `cap` (the budget,
// at most step_limit). Relaxed is the over-relaxed step (step_relaxed,
// :211-237): safety spheres must overlap, else the ray rewinds to
// depth - step_len + prev_r and steps exactly from there; its state starts
// at (0, 0, omega) at every launch (:262-269).
template <class S, bool Relaxed>
__device__ __forceinline__ void march_loop(const SceneDesc& s, const Ray& r, float limit, int cap,
                                           float omega, float& depth, int& steps, int& outcome) {
  const float eps = s.collision_distance;
  outcome = STEP_LIMIT;
  if (!Relaxed) {
    for (;;) {
      const float cd = r.c * depth;
      const float dist =
          scene_sdf<S>(s, r.ox + depth * r.dx, r.oy + depth * r.dy, r.oz + depth * r.dz);
      if (dist <= cd + eps) {
        outcome = COLLISION;
        break;
      }
      depth = (depth + dist) - cd;
      if (depth > limit) {
        outcome = DEPTH_LIMIT;
        break;
      }
      if (++steps >= cap) break;
    }
  } else {
    float prev_r = 0.0f, step_len = 0.0f, om = omega;
    for (;;) {
      const float cd = r.c * depth;
      const float dist =
          scene_sdf<S>(s, r.ox + depth * r.dx, r.oy + depth * r.dy, r.oz + depth * r.dz);
      const float rad = dist - cd;
      const bool fail = step_len > fabsf(prev_r) + fabsf(rad);
      if (fail) {
        depth = (depth - step_len) + prev_r;
        om = 1.0f;
      } else if (dist <= cd + eps) {
        outcome = COLLISION;
        break;
      }
      const float new_step = fail ? 0.0f : om * rad;
      depth = depth + new_step;
      if (!fail) prev_r = rad;
      step_len = new_step;
      if (depth > limit) {
        outcome = DEPTH_LIMIT;
        break;
      }
      if (++steps >= cap) break;
    }
  }
}

// the slab cull of the march: true for a ray that cannot reach the bounds;
// otherwise `limit` is its stop depth
template <bool Cull>
__device__ __forceinline__ bool culled(const SceneDesc& s, const Ray& r, float& limit) {
  limit = s.depth_limit;
  return Cull && slab_cull(s, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.c, limit);
}

template <class S, bool Cull, bool Relaxed>
__device__ __forceinline__ void march_ray(const SceneDesc& s, const Ray& r, int cap, float omega,
                                          float& depth, int& steps, int& outcome) {
  float limit;
  if (culled<Cull>(s, r, limit)) {
    depth = s.cull_depth;
    return;
  }
  march_loop<S, Relaxed>(s, r, limit, cap, omega, depth, steps, outcome);
}

// The march of an `active` ray with the near/far split (render_kernel.py
// :412-432), which every thread of the warp calls: the warp's rays (K1's
// and K2's 8x4 patch, or 32 rays of K2's list) vote, and if none of its
// active rays that the slab cull keeps can reach the near box (near_miss),
// each marches the far scene (Far) alone, else the full scene S as
// NearScene evaluates it (scene_sdf.cuh: S's value bit for bit, its
// wireframe's term skipped where an exact bound proves it larger). The vote
// is one __any_sync, so the choice is uniform across the warp and adds no
// divergence; a ray that does not march (not active, or no ray at all: a
// thread past the frame's edge or K2's list) takes part as a ray that
// cannot reach the near box, as JAX's `active0 & ~n_miss` counts it.
// Returns the warp's choice: true where it marched the far scene.
template <class S, bool Cull, bool Relaxed>
__device__ __forceinline__ bool march_split(const SceneDesc& s, const Ray& r, bool active, int cap,
                                            float omega, float& depth, int& steps,
                                            int& outcome) {
  float limit = s.depth_limit;
  const bool cull = active && culled<Cull>(s, r, limit);
  const bool near = active && !cull && !near_miss(s, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.c);
  const bool far = !__any_sync(0xffffffffu, near);
  if (!active) return far;
  if (cull) {
    depth = s.cull_depth;
  } else if (far) {
    march_loop<Far, Relaxed>(s, r, limit, cap, omega, depth, steps, outcome);
  } else {
    march_loop<NearScene<S::transform>, Relaxed>(s, r, limit, cap, omega, depth, steps, outcome);
  }
  return far;
}

// the `active` plane a launch writes: the rays that stopped at the budget
// short of the step limit (render_kernel.py:281-283)
__device__ __forceinline__ int unresolved(const SceneDesc& s, int steps, int outcome, int cap) {
  return outcome == STEP_LIMIT && steps >= cap && steps < s.step_limit;
}

// the Lambert two-colour mix at the hit (x, y, z) of the scene S, before
// ACES: its fd4 normal (project.cuh fd4_grad, the loops rolled with Rolled)
template <class S, bool Rolled>
__device__ __forceinline__ void hit_colour(const SceneDesc& s, float x, float y, float z, float& r,
                                           float& g, float& b) {
  float gx, gy, gz;
  fd4_grad<S, Rolled>(s, x, y, z, s.normal_epsilon, gx, gy, gz);
  const float inv = rsqrtf(fmaxf(gx * gx + gy * gy + gz * gz, 1e-24f));
  shade_collision(s, gx * inv, gy * inv, gz * inv, r, g, b);
}

// fd4 normal, Lambert two-colour mix and ACES of one pixel, written to
// rgb[0..2]: the fused epilogue of the unsplit K1 (render_kernel.py:380-410)
// and K3 (:437-470). A hit runs hit_colour; any other pixel is ACES of
// white (STEP_LIMIT) or black.
template <class S, bool Rolled>
__device__ __forceinline__ void shade_pixel(const SceneDesc& s, const Ray& ray, float depth,
                                            int outcome, float* __restrict__ rgb) {
  float r, g, b;
  if (outcome == COLLISION) {
    hit_colour<S, Rolled>(s, ray.ox + depth * ray.dx, ray.oy + depth * ray.dy,
                          ray.oz + depth * ray.dz, r, g, b);
  } else {
    r = g = b = outcome == STEP_LIMIT ? 1.0f : 0.0f;
  }
  float out[3];
  aces(s, r, g, b, out);
  rgb[0] = out[0];
  rgb[1] = out[1];
  rgb[2] = out[2];
}

// K1. FRESH: every ray marches from depth 0 with budget step_limit; the
// depth, steps and outcome planes are written when depth_io is not null.
// PHASE_A: the same from depth 0 with budget `cap`, every plane and
// `active` written. RESUME: block blockIdx.x of the list `blocks` (first
// *count entries, each by * ceil(w / 16) + bx) resumes its active rays in
// place from the planes with budget `cap`; its other rays keep their planes
// and colour.
#define K1_PARAMS                                                                         \
  const SceneDesc &s, const float *__restrict__ origins,                                \
      const float *__restrict__ directions, const float *__restrict__ cone,             \
      float *__restrict__ rgb, float *depth_io, int *steps_io, int *outcome_io,          \
      int *active_io, const int *__restrict__ blocks, const int *__restrict__ count, int cap, \
      float omega, int h, int w
#define K1_ARGS \
  s, origins, directions, cone, rgb, depth_io, steps_io, outcome_io, active_io, blocks, count, \
      cap, omega, h, w

// the 16x8 block (bx, by) that K1's block blockIdx works on: its own, or in
// RESUME the listed one; false for a RESUME block past the list's count
template <int Mode>
__device__ __forceinline__ bool k1_block(const int* __restrict__ blocks,
                                         const int* __restrict__ count, int w, int& bx, int& by) {
  bx = blockIdx.x;
  by = blockIdx.y;
  if (Mode == K1_RESUME) {
    if (static_cast<int>(blockIdx.x) >= *count) return false;
    const int b = blocks[blockIdx.x];
    const int nbx = (w + 15) / 16;
    bx = b % nbx;
    by = b / nbx;
  }
  return true;
}

template <class S, bool Cull, bool Relaxed, int Mode>
__device__ __forceinline__ void render_pixel(K1_PARAMS) {
  stage_scene<S>(s);  // every thread of the block, before any leaves
  int bx, by;
  if (!k1_block<Mode>(blocks, count, w, bx, by)) return;
  int px, py;
  block_pixel(bx, by, px, py);
  if (px >= w || py >= h) return;
  const long long i = (long long)py * w + px;
  if (Mode == K1_RESUME && active_io[i] == 0) return;

  float depth = 0.0f;
  int steps = 0;
  int outcome = DEPTH_LIMIT;
  if (Mode == K1_RESUME) {
    depth = depth_io[i];
    steps = steps_io[i];
    outcome = outcome_io[i];
  }
  const int budget = Mode == K1_FRESH ? s.step_limit : cap;
  const Ray ray = load_ray(origins, directions, cone, i);
  march_ray<S, Cull, Relaxed>(s, ray, budget, omega, depth, steps, outcome);
  shade_pixel<S, true>(s, ray, depth, outcome, rgb + 3 * i);  // the rolled stencil
  if (Mode != K1_FRESH || depth_io != nullptr) {
    depth_io[i] = depth;
    steps_io[i] = steps;
    outcome_io[i] = outcome;
  }
  if (Mode != K1_FRESH) active_io[i] = unresolved(s, steps, outcome, budget);
}

template <class S, bool Cull, bool Relaxed, int Mode>
__global__ void __launch_bounds__(128) render_kernel(const SceneDesc s, const float* __restrict__ origins,
              const float* __restrict__ directions, const float* __restrict__ cone,
              float* __restrict__ rgb, float* depth_io, int* steps_io, int* outcome_io,
              int* active_io, const int* __restrict__ blocks, const int* __restrict__ count,
              int cap, float omega, int h, int w) {
  render_pixel<S, Cull, Relaxed, Mode>(K1_ARGS);
}

// K1 with the near/far split, one 16x8 block of 128 threads, in the modes
// of render_pixel. Each warp's 8x4 patch marches the far or the full scene
// (march_split); every thread of the block takes part, a thread past the
// frame's edge or (RESUME) a ray that is not active as one that does not
// march. The epilogue is JAX's fused one (render_kernel.py:380-384): a hit
// of a far patch takes its normal from the far scene, one of a near patch
// from the full scene. The block lists its hits in shared memory, the far
// patches' first and the near patches' from the next warp boundary, each
// with its point, and threads 0..far-1 shade the far hits with Far's
// unrolled stencil, the threads from that boundary the near hits with the
// full scene's rolled one (NearScene): full warps that each run one
// stencil, where a thread a pixel ran the full scene's stencil at every hit
// and held its warp's other lanes through it. Every other pixel is ACES of white (STEP_LIMIT) or black,
// taken once a block, as K3 takes it. A far patch's warp lists whole
// warps' hits, so the near hits start at most at the far warps' 32 slots
// each and fit in 128.
template <class S, bool Cull, bool Relaxed, int Mode>
__device__ __forceinline__ void render_split_block(K1_PARAMS) {
  __shared__ int warp_hits[4];
  __shared__ bool warp_far[4];
  __shared__ unsigned char listed[128];  // the hits' threads
  __shared__ float point[3][128];        // and their points
  __shared__ float flat[2][3];           // ACES of white and of black
  int bx, by;
  if (!k1_block<Mode>(blocks, count, w, bx, by)) return;  // the whole block
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int px, py;
  block_pixel(bx, by, px, py);
  const bool inside = px < w && py < h;
  const long long i = inside ? (long long)py * w + px : 0;
  const bool active = inside && (Mode != K1_RESUME || active_io[i] != 0);

  float depth = 0.0f;
  int steps = 0;
  int outcome = DEPTH_LIMIT;
  if (Mode == K1_RESUME && active) {
    depth = depth_io[i];
    steps = steps_io[i];
    outcome = outcome_io[i];
  }
  const int budget = Mode == K1_FRESH ? s.step_limit : cap;
  const Ray ray = load_ray(origins, directions, cone, i);  // pixel 0's for a thread outside
  const bool far = march_split<S, Cull, Relaxed>(s, ray, active, budget, omega, depth, steps,
                                                 outcome);
  const bool hit = active && outcome == COLLISION;
  const unsigned ballot = __ballot_sync(0xffffffffu, hit);
  if (lane == 0) {
    warp_hits[warp] = __popc(ballot);
    warp_far[warp] = far;
    if (warp < 2) {
      const float v = warp == 0 ? 1.0f : 0.0f;
      aces(s, v, v, v, flat[warp]);
    }
  }
  __syncthreads();
  int far_hits = 0, near_hits = 0, before = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int n = warp_hits[k];
    const bool f = warp_far[k];
    before += k < warp && f == far ? n : 0;
    far_hits += f ? n : 0;
    near_hits += f ? 0 : n;
  }
  const int near_from = (far_hits + 31) & ~31;
  if (hit) {
    const int slot = (far ? 0 : near_from) + before + __popc(ballot & ((1u << lane) - 1u));
    listed[slot] = static_cast<unsigned char>(t);
    point[0][slot] = ray.ox + depth * ray.dx;
    point[1][slot] = ray.oy + depth * ray.dy;
    point[2][slot] = ray.oz + depth * ray.dz;
  }
  if (active) {
    if (!hit) {
      const float* c = flat[outcome == STEP_LIMIT ? 0 : 1];
      rgb[3 * i] = c[0];
      rgb[3 * i + 1] = c[1];
      rgb[3 * i + 2] = c[2];
    }
    if (Mode != K1_FRESH || depth_io != nullptr) {
      depth_io[i] = depth;
      steps_io[i] = steps;
      outcome_io[i] = outcome;
    }
    if (Mode != K1_FRESH) active_io[i] = unresolved(s, steps, outcome, budget);
  }
  __syncthreads();
  const bool far_slot = t < far_hits;
  if (far_slot || (t >= near_from && t < near_from + near_hits)) {
    tile_pixel(bx, by, listed[t], px, py);
    float r, g, b, out[3];
    if (far_slot) {
      // unrolled: K1 · split at 1080p 0.1620-0.1634 ms against 0.1654-0.1656
      // rolled on an H100 (PERF.md)
      hit_colour<Far, false>(s, point[0][t], point[1][t], point[2][t], r, g, b);
    } else {
      hit_colour<NearScene<S::transform>, true>(s, point[0][t], point[1][t], point[2][t], r, g,
                                                b);
    }
    aces(s, r, g, b, out);
    float* dst = rgb + 3 * ((long long)py * w + px);
    dst[0] = out[0];
    dst[1] = out[1];
    dst[2] = out[2];
  }
}

template <class S, bool Cull, bool Relaxed, int Mode>
__global__ void __launch_bounds__(128) render_split_kernel(const SceneDesc s,
              const float* __restrict__ origins, const float* __restrict__ directions,
              const float* __restrict__ cone, float* __restrict__ rgb, float* depth_io,
              int* steps_io, int* outcome_io, int* active_io, const int* __restrict__ blocks,
              const int* __restrict__ count, int cap, float omega, int h, int w) {
  render_split_block<S, Cull, Relaxed, Mode>(K1_ARGS);
}

// K2. Without Listed, one thread per pixel in K1's layout; with Listed,
// thread t < *count marches ray rays[t] of the frame. The carried state is
// (depth0, steps0, outcome0, active0), or depth 0, steps 0, DEPTH_LIMIT and
// active for every ray when depth0 is null. Rays that are not active keep
// their state. `active` is written when not null. The carried planes may be
// the output planes (Listed runs in place).
#define K2_PARAMS                                                                              \
  const SceneDesc &s, const float *__restrict__ origins,                                     \
      const float *__restrict__ directions, const float *__restrict__ cone, const float *depth0, \
      const int *steps0, const int *outcome0, const int *active0, float *depth_out,          \
      int *steps_out, int *outcome_out, int *active_out, const int *__restrict__ rays,        \
      const int *__restrict__ count, int cap, float omega, int h, int w
#define K2_ARGS                                                                               \
  s, origins, directions, cone, depth0, steps0, outcome0, active0, depth_out, steps_out,    \
      outcome_out, active_out, rays, count, cap, omega, h, w

// the carried state of ray i (a fresh march's where depth0 is null); returns
// whether the ray is active
__device__ __forceinline__ bool carried_state(const float* depth0, const int* steps0,
                                              const int* outcome0, const int* active0, long long i,
                                              float& depth, int& steps, int& outcome) {
  depth = 0.0f;
  steps = 0;
  outcome = DEPTH_LIMIT;
  if (depth0 == nullptr) return true;
  depth = depth0[i];
  steps = steps0[i];
  outcome = outcome0[i];
  return active0[i] != 0;
}

// K2's outputs of ray i
__device__ __forceinline__ void write_trace(const SceneDesc& s, float* depth_out, int* steps_out,
                                            int* outcome_out, int* active_out, long long i,
                                            float depth, int steps, int outcome, int cap) {
  depth_out[i] = depth;
  steps_out[i] = steps;
  outcome_out[i] = outcome;
  if (active_out != nullptr) active_out[i] = unresolved(s, steps, outcome, cap);
}

template <class S, bool Cull, bool Relaxed, bool Listed>
__device__ __forceinline__ void trace_ray(K2_PARAMS) {
  stage_scene<S>(s);  // every thread of the block, before any leaves
  long long i;
  if (Listed) {
    const int t = blockIdx.x * 128 + threadIdx.x;
    if (t >= *count) return;
    i = rays[t];
  } else {
    int px, py;
    block_pixel(blockIdx.x, blockIdx.y, px, py);
    if (px >= w || py >= h) return;
    i = (long long)py * w + px;
  }
  float depth;
  int steps, outcome;
  if (carried_state(depth0, steps0, outcome0, active0, i, depth, steps, outcome)) {
    march_ray<S, Cull, Relaxed>(s, load_ray(origins, directions, cone, i), cap, omega, depth,
                                steps, outcome);
  }
  write_trace(s, depth_out, steps_out, outcome_out, active_out, i, depth, steps, outcome, cap);
}

// K2 with the near/far split: each warp, an 8x4 patch or 32 listed rays,
// marches the far or the full scene (march_split). Every thread of a warp
// that holds a ray takes part in its vote, a thread past the frame's edge
// or the list's end as one that does not march; a warp wholly past the
// list's end leaves at once. The row tail's list is in 8x4-patch order
// (render_kernel.py compact_list with patch_order), so a listed warp's rays
// are neighbours: their step counts and their vote agree as a patch's do.
template <class S, bool Cull, bool Relaxed, bool Listed>
__device__ __forceinline__ void trace_split_ray(K2_PARAMS) {
  bool live;
  long long i = 0;
  if (Listed) {
    const int t = blockIdx.x * 128 + threadIdx.x;
    const int n = *count;
    if ((t & ~31) >= n) return;  // the whole warp
    live = t < n;
    if (live) i = rays[t];
  } else {
    int px, py;
    block_pixel(blockIdx.x, blockIdx.y, px, py);
    live = px < w && py < h;
    if (live) i = (long long)py * w + px;
  }
  float depth = 0.0f;
  int steps = 0, outcome = DEPTH_LIMIT;
  const bool active =
      live && carried_state(depth0, steps0, outcome0, active0, i, depth, steps, outcome);
  march_split<S, Cull, Relaxed>(s, load_ray(origins, directions, cone, i), active, cap, omega,
                                depth, steps, outcome);  // ray 0's for a thread with no ray
  if (live) {
    write_trace(s, depth_out, steps_out, outcome_out, active_out, i, depth, steps, outcome, cap);
  }
}

template <class S, bool Cull, bool Relaxed, bool Listed>
__global__ void __launch_bounds__(128) trace_kernel(const SceneDesc s, const float* __restrict__ origins,
             const float* __restrict__ directions, const float* __restrict__ cone,
             const float* depth0, const int* steps0, const int* outcome0, const int* active0,
             float* depth_out, int* steps_out, int* outcome_out, int* active_out,
             const int* __restrict__ rays, const int* __restrict__ count, int cap, float omega,
             int h, int w) {
  trace_ray<S, Cull, Relaxed, Listed>(K2_ARGS);
}

template <class S, bool Cull, bool Relaxed, bool Listed>
__global__ void __launch_bounds__(128) trace_split_kernel(const SceneDesc s,
             const float* __restrict__ origins, const float* __restrict__ directions,
             const float* __restrict__ cone, const float* depth0, const int* steps0,
             const int* outcome0, const int* active0, float* depth_out, int* steps_out,
             int* outcome_out, int* active_out, const int* __restrict__ rays,
             const int* __restrict__ count, int cap, float omega, int h, int w) {
  trace_split_ray<S, Cull, Relaxed, Listed>(K2_ARGS);
}

// K3, one 16x8 tile a block of 128 threads. The block lists the tile's
// hits in shared memory, in thread order (a ballot and the warps' counts),
// and threads 0..hits-1 shade them, so the fd4 stencil runs on full warps
// where a thread a pixel ran it on the hits of each warp while the rest of
// the warp waited. Every other pixel is ACES of white (STEP_LIMIT) or black,
// taken once a block: the same aces on the same inputs, so the same bits.
template <class S>
__global__ void __launch_bounds__(128)
shade_kernel(const SceneDesc s, const float* __restrict__ origins,
             const float* __restrict__ directions, const float* __restrict__ depth,
             const int* __restrict__ outcome, float* __restrict__ rgb, int h, int w) {
  __shared__ int warp_hits[4];
  __shared__ unsigned char listed[128];  // the hits' threads, in thread order
  __shared__ float flat[2][3];            // ACES of white and of black
  stage_scene<S>(s, false);  // the barriers below order it
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int px, py;
  block_pixel(blockIdx.x, blockIdx.y, px, py);
  const bool inside = px < w && py < h;
  const long long i = (long long)py * w + px;
  const int oc = inside ? outcome[i] : DEPTH_LIMIT;
  const bool hit = inside && oc == COLLISION;
  const unsigned ballot = __ballot_sync(0xffffffffu, hit);
  if (lane == 0) warp_hits[warp] = __popc(ballot);
  if (lane == 0 && warp < 2) {
    const float v = warp == 0 ? 1.0f : 0.0f;
    float out[3];
    aces(s, v, v, v, out);
    flat[warp][0] = out[0];
    flat[warp][1] = out[1];
    flat[warp][2] = out[2];
  }
  __syncthreads();
  int before = 0, hits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    before += k < warp ? warp_hits[k] : 0;
    hits += warp_hits[k];
  }
  if (hit) listed[before + __popc(ballot & ((1u << lane) - 1u))] = static_cast<unsigned char>(t);
  __syncthreads();
  if (inside && !hit) {
    const float* c = flat[oc == STEP_LIMIT ? 0 : 1];
    rgb[3 * i] = c[0];
    rgb[3 * i + 1] = c[1];
    rgb[3 * i + 2] = c[2];
  }
  if (t < hits) {
    tile_pixel(blockIdx.x, blockIdx.y, listed[t], px, py);
    const long long j = (long long)py * w + px;
    const Ray ray{origins[3 * j],    origins[3 * j + 1],    origins[3 * j + 2], directions[3 * j],
                  directions[3 * j + 1], directions[3 * j + 2], 0.0f};
    shade_pixel<S, false>(s, ray, depth[j], COLLISION, rgb + 3 * j);
  }
}

// K1 of mode Mode, with the near/far split or without
template <class S, bool Cull, bool Relaxed, int Mode, bool Split>
static auto k1_kernel() {
  if constexpr (Split) {
    return render_split_kernel<S, Cull, Relaxed, Mode>;
  } else {
    return render_kernel<S, Cull, Relaxed, Mode>;
  }
}

// K2, listed or not, with the near/far split or without
template <class S, bool Cull, bool Relaxed, bool Listed, bool Split>
static auto k2_kernel() {
  if constexpr (Split) {
    return trace_split_kernel<S, Cull, Relaxed, Listed>;
  } else {
    return trace_kernel<S, Cull, Relaxed, Listed>;
  }
}

// the structures the near/far split is built for: the reference render
// scene's, with its wireframe (csdf.py::compile_scene_split splits it alone)
template <class S>
struct Splits : std::false_type {};
template <bool Transform>
struct Splits<Box<true, Transform>> : std::true_type {};

template <class S, bool Cull, bool Relaxed, bool Split>
static int launch_render(int mode, cudaStream_t stream, const SceneDesc& s, const float* origins,
                         const float* directions, const float* cone, float* rgb, float* depth,
                         int* steps, int* outcome, int* active, const int* blocks,
                         const int* count, int cap, float omega, int h, int w) {
  const dim3 block(128);
  const dim3 grid((w + 15) / 16, (h + 7) / 8);
  // RESUME: the worst case, every block listed, as many threads
  if (!scratch_fits(s, (long long)grid.x * grid.y * 128)) return cudaErrorInvalidValue;
  const long long smem = scene_smem<S>(s, false);
  if (smem < 0) return cudaErrorInvalidValue;
  if (mode == K1_FRESH) {
    k1_kernel<S, Cull, Relaxed, K1_FRESH, Split>()<<<grid, block, smem, stream>>>(
        s, origins, directions, cone, rgb, depth, steps, outcome, active, blocks, count, cap,
        omega, h, w);
  } else if (mode == K1_PHASE_A) {
    k1_kernel<S, Cull, Relaxed, K1_PHASE_A, Split>()<<<grid, block, smem, stream>>>(
        s, origins, directions, cone, rgb, depth, steps, outcome, active, blocks, count, cap,
        omega, h, w);
  } else {
    k1_kernel<S, Cull, Relaxed, K1_RESUME, Split>()<<<grid.x * grid.y, block, smem, stream>>>(
        s, origins, directions, cone, rgb, depth, steps, outcome, active, blocks, count, cap,
        omega, h, w);
  }
  return cudaGetLastError();
}

template <class S, bool Cull, bool Relaxed, bool Split>
static int launch_trace(cudaStream_t stream, const SceneDesc& s, const float* origins,
                        const float* directions, const float* cone, const float* depth0,
                        const int* steps0, const int* outcome0, const int* active0, float* depth,
                        int* steps, int* outcome, int* active, const int* rays, const int* count,
                        int cap, float omega, int h, int w) {
  const dim3 block(128);
  const long long smem = scene_smem<S>(s, false);
  if (smem < 0) return cudaErrorInvalidValue;
  if (rays != nullptr) {
    // the worst case: every ray listed
    const long long n = (long long)h * w;
    const unsigned blocks = static_cast<unsigned>((n + 127) / 128);
    if (!scratch_fits(s, (long long)blocks * 128)) return cudaErrorInvalidValue;
    k2_kernel<S, Cull, Relaxed, true, Split>()<<<blocks, block, smem, stream>>>(
        s, origins, directions, cone, depth0, steps0, outcome0, active0, depth, steps, outcome,
        active, rays, count, cap, omega, h, w);
  } else {
    const dim3 grid((w + 15) / 16, (h + 7) / 8);
    if (!scratch_fits(s, (long long)grid.x * grid.y * 128)) return cudaErrorInvalidValue;
    k2_kernel<S, Cull, Relaxed, false, Split>()<<<grid, block, smem, stream>>>(
        s, origins, directions, cone, depth0, steps0, outcome0, active0, depth, steps, outcome,
        active, rays, count, cap, omega, h, w);
  }
  return cudaGetLastError();
}

// f(Cull, Relaxed) with the two flags as template arguments
template <class F>
static void with_march(int cull, int relaxed, F&& f) {
  if (cull && !relaxed) f(std::true_type{}, std::false_type{});
  else if (cull) f(std::true_type{}, std::true_type{});
  else if (!relaxed) f(std::false_type{}, std::false_type{});
  else f(std::false_type{}, std::true_type{});
}

// The instantiations are compiled in two units, so that the two build in
// parallel: this file's, and render_split.cu's (this file again, with
// BSDMG_RENDER_SECOND_UNIT defined), which holds the near/far split's and
// the large tier's (ComposedLarge). Each unit's dispatch instantiates only
// its own and answers OTHER_UNIT for the rest.
template <class S, bool Split>
struct RenderSecondUnit : std::bool_constant<Split || std::is_same<S, ComposedLarge>::value> {};
#ifdef BSDMG_RENDER_SECOND_UNIT
constexpr bool kSecondUnit = true;
#else
constexpr bool kSecondUnit = false;
#endif
constexpr int OTHER_UNIT = -1;

// f(S, Cull, Relaxed, Split) for the descriptor's structure, its split and
// the two flags where this unit holds the instantiation, else OTHER_UNIT;
// cudaErrorInvalidValue for a structure that names none or a split of a
// structure it is not built for
template <class F>
static int with_launch(const SceneDesc& s, int cull, int relaxed, F&& f) {
  int err = cudaErrorInvalidValue;
  with_structure(s.structure, [&](auto scene) {
    typedef decltype(scene) S;
    with_march(cull, relaxed, [&](auto c, auto r) {
      if (!s.split) {
        if constexpr (RenderSecondUnit<S, false>::value == kSecondUnit) {
          err = f(scene, c, r, std::false_type{});
        } else {
          err = OTHER_UNIT;
        }
      } else if constexpr (Splits<S>::value) {
        if constexpr (RenderSecondUnit<S, true>::value == kSecondUnit) {
          err = f(scene, c, r, std::true_type{});
        } else {
          err = OTHER_UNIT;
        }
      }
    });
  });
  return err;
}

#define RENDER_PARAMS                                                                          \
  const SceneDesc *desc, const float *origins, const float *directions, const float *cone,     \
      float *rgb, float *depth, int *steps, int *outcome, int *active, const int *blocks,      \
      const int *count, int mode, int cull, int relaxed, int cap, float omega, int h, int w,   \
      void *stream
#define RENDER_ARGS                                                                             \
  desc, origins, directions, cone, rgb, depth, steps, outcome, active, blocks, count, mode, cull, \
      relaxed, cap, omega, h, w, stream
#define TRACE_PARAMS                                                                           \
  const SceneDesc *desc, const float *origins, const float *directions, const float *cone,     \
      const float *depth0, const int *steps0, const int *outcome0, const int *active0,         \
      float *depth, int *steps, int *outcome, int *active, const int *rays, const int *count,  \
      int cull, int relaxed, int cap, float omega, int h, int w, void *stream
#define TRACE_ARGS                                                                             \
  desc, origins, directions, cone, depth0, steps0, outcome0, active0, depth, steps, outcome,   \
      active, rays, count, cull, relaxed, cap, omega, h, w, stream
#define SHADE_PARAMS                                                                           \
  const SceneDesc *desc, const float *origins, const float *directions, const float *depth,    \
      const int *outcome, float *rgb, int h, int w, void *stream
#define SHADE_ARGS desc, origins, directions, depth, outcome, rgb, h, w, stream

// K1, K2 and K3 of this unit's instantiations (bsdmg_render, bsdmg_trace,
// bsdmg_shade say what they take)
static int render_in_unit(RENDER_PARAMS) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_launch(*desc, cull, relaxed, [&](auto scene, auto c, auto r, auto split) {
    return launch_render<decltype(scene), decltype(c)::value, decltype(r)::value,
                         decltype(split)::value>(mode, st, *desc, origins, directions, cone, rgb,
                                                 depth, steps, outcome, active, blocks, count,
                                                 cap, omega, h, w);
  });
}

static int trace_in_unit(TRACE_PARAMS) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_launch(*desc, cull, relaxed, [&](auto scene, auto c, auto r, auto split) {
    return launch_trace<decltype(scene), decltype(c)::value, decltype(r)::value,
                        decltype(split)::value>(st, *desc, origins, directions, cone, depth0,
                                                steps0, outcome0, active0, depth, steps, outcome,
                                                active, rays, count, cap, omega, h, w);
  });
}

static int shade_in_unit(SHADE_PARAMS) {
  const dim3 grid((w + 15) / 16, (h + 7) / 8);
  if (!scratch_fits(*desc, (long long)grid.x * grid.y * 128)) return cudaErrorInvalidValue;
  int err = cudaErrorInvalidValue;
  with_structure(desc->structure, [&](auto scene) {
    typedef decltype(scene) S;
    if constexpr (RenderSecondUnit<S, false>::value == kSecondUnit) {
      const long long smem = scene_smem<S>(*desc, false);
      if (smem < 0) return;
      shade_kernel<S><<<grid, dim3(128), smem, static_cast<cudaStream_t>(stream)>>>(
          *desc, origins, directions, depth, outcome, rgb, h, w);
      err = cudaGetLastError();
    } else {
      err = OTHER_UNIT;
    }
  });
  return err;
}

extern "C" {

#ifdef BSDMG_RENDER_SECOND_UNIT

// render_kernel.cu's entries for the instantiations of this unit
int bsdmg_render_second_unit(RENDER_PARAMS) { return render_in_unit(RENDER_ARGS); }
int bsdmg_trace_second_unit(TRACE_PARAMS) { return trace_in_unit(TRACE_ARGS); }
int bsdmg_shade_second_unit(SHADE_PARAMS) { return shade_in_unit(SHADE_ARGS); }

#else

int bsdmg_render_second_unit(RENDER_PARAMS);
int bsdmg_trace_second_unit(TRACE_PARAMS);
int bsdmg_shade_second_unit(SHADE_PARAMS);

// Launches K1 on `stream` over an h x w image. origins and directions are
// (h, w, 3), cone (h, w), rgb (h, w, 3), all float32 on the device; depth,
// steps, outcome and active are (h, w) planes. mode is 0 (FRESH; the planes
// written when depth is not null), 1 (PHASE_A) or 2 (RESUME over `blocks`
// and the device-resident `count`); cull and relaxed pick the march, the
// descriptor's `structure` the scene's instantiation and its `split` the
// near/far split; cap is the step budget of modes 1 and 2, omega the
// relaxation. Returns the cudaError_t of the launch (cudaErrorInvalidValue
// for a structure that names none, a split it is not built for, a
// large-tier program whose scratch does not hold the launch, or a
// small-tier one beyond the caps of the forward walk: composed.cuh
// walk_fits).
int bsdmg_render(RENDER_PARAMS) {
  const int err = render_in_unit(RENDER_ARGS);
  return err == OTHER_UNIT ? bsdmg_render_second_unit(RENDER_ARGS) : err;
}

// Launches K2 on `stream` over an h x w frame, planes as bsdmg_render's.
// depth0, steps0, outcome0 and active0 are the carried state, all null for
// a fresh march; `active` may be null. With `rays` not null, the first
// *count entries of it are the rays to march (count device-resident).
// Returns the cudaError_t of the launch, as bsdmg_render.
int bsdmg_trace(TRACE_PARAMS) {
  const int err = trace_in_unit(TRACE_ARGS);
  return err == OTHER_UNIT ? bsdmg_trace_second_unit(TRACE_ARGS) : err;
}

// Launches K3 on `stream`: rgb (h, w, 3) from the depth and outcome planes.
// Returns the cudaError_t of the launch.
int bsdmg_shade(SHADE_PARAMS) {
  const int err = shade_in_unit(SHADE_ARGS);
  return err == OTHER_UNIT ? bsdmg_shade_second_unit(SHADE_ARGS) : err;
}

int bsdmg_scene_desc_size(void) { return static_cast<int>(sizeof(SceneDesc)); }

const char* bsdmg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#endif  // BSDMG_RENDER_SECOND_UNIT

}  // extern "C"
