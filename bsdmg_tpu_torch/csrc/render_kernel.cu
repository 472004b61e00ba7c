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
// One march core (march_ray) serves K1 and K2, templated on the slab cull
// and on over-relaxation; one epilogue (shade_pixel) serves K1 and K3. K1 is
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
// the loop as soon as it resolves; the row two-phase tail packs the
// stragglers into full warps; the scene descriptor is a by-value kernel
// parameter, so every thread reads the same constant-bank words; the fd4
// stencil is a rolled loop around one inlined SDF, which keeps code size and
// registers down. The per-ray near/far scene split is not ported: by the
// JAX package's tests it changes no pixel, and making these kernels fast is
// later work.
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

// the pixel of this thread in the 16x8 block (bx, by): each of the block's
// 4 warps covers an 8x4 patch
__device__ __forceinline__ void block_pixel(int bx, int by, int& px, int& py) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  px = bx * 16 + (warp & 1) * 8 + (lane & 7);
  py = by * 8 + (warp >> 1) * 4 + (lane >> 3);
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
template <bool Cull, bool Relaxed>
__device__ __forceinline__ void march_ray(const SceneDesc& s, const Ray& r, int cap, float omega,
                                          float& depth, int& steps, int& outcome) {
  float limit = s.depth_limit;
  if (Cull && slab_cull(s, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.c, limit)) {
    depth = s.cull_depth;
    return;
  }
  const float eps = s.collision_distance;
  outcome = STEP_LIMIT;
  if (!Relaxed) {
    for (;;) {
      const float cd = r.c * depth;
      const float dist = scene_sdf(s, r.ox + depth * r.dx, r.oy + depth * r.dy, r.oz + depth * r.dz);
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
      const float dist = scene_sdf(s, r.ox + depth * r.dx, r.oy + depth * r.dy, r.oz + depth * r.dz);
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

// the `active` plane a launch writes: the rays that stopped at the budget
// short of the step limit (render_kernel.py:281-283)
__device__ __forceinline__ int unresolved(const SceneDesc& s, int steps, int outcome, int cap) {
  return outcome == STEP_LIMIT && steps >= cap && steps < s.step_limit;
}

// fd4 normal, Lambert two-colour mix and ACES of one pixel, written to
// rgb[0..2]: the fused epilogue of K1 (render_kernel.py:380-410) and K3
// (:437-470). A hit runs the 12-SDF stencil; any other pixel is ACES of
// white (STEP_LIMIT) or black. The TPU's per-tile pl.when gate is a branch
// per thread here.
__device__ __forceinline__ void shade_pixel(const SceneDesc& s, const Ray& ray, float depth,
                                            int outcome, float* __restrict__ rgb) {
  float r, g, b;
  if (outcome == COLLISION) {
    const float px3 = ray.ox + depth * ray.dx;
    const float py3 = ray.oy + depth * ray.dy;
    const float pz3 = ray.oz + depth * ray.dz;
    const float e1 = s.normal_epsilon, e2 = 2.0f * s.normal_epsilon;
    float gx = 0.0f, gy = 0.0f, gz = 0.0f;
#pragma unroll 1
    for (int a = 0; a < 3; ++a) {
      // -f(p+2e) + 8 f(p+e) - 8 f(p-e) + f(p-2e), summed in that order
      float acc = 0.0f;
#pragma unroll 1
      for (int k = 0; k < 4; ++k) {
        const float off = k == 0 ? e2 : (k == 1 ? e1 : (k == 2 ? -e1 : -e2));
        const float f = scene_sdf(s, a == 0 ? px3 + off : px3, a == 1 ? py3 + off : py3,
                                  a == 2 ? pz3 + off : pz3);
        acc = k == 0 ? -f : (k == 1 ? acc + 8.0f * f : (k == 2 ? acc - 8.0f * f : acc + f));
      }
      if (a == 0) gx = acc;
      else if (a == 1) gy = acc;
      else gz = acc;
    }
    const float inv = rsqrtf(fmaxf(gx * gx + gy * gy + gz * gz, 1e-24f));
    shade_collision(s, gx * inv, gy * inv, gz * inv, r, g, b);
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
template <bool Cull, bool Relaxed, int Mode>
__global__ void __launch_bounds__(128)
render_kernel(const SceneDesc s, const float* __restrict__ origins,
              const float* __restrict__ directions, const float* __restrict__ cone,
              float* __restrict__ rgb, float* depth_io, int* steps_io, int* outcome_io,
              int* active_io, const int* __restrict__ blocks, const int* __restrict__ count,
              int cap, float omega, int h, int w) {
  int bx = blockIdx.x, by = blockIdx.y;
  if (Mode == K1_RESUME) {
    if (static_cast<int>(blockIdx.x) >= *count) return;
    const int b = blocks[blockIdx.x];
    const int nbx = (w + 15) / 16;
    bx = b % nbx;
    by = b / nbx;
  }
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
  march_ray<Cull, Relaxed>(s, ray, budget, omega, depth, steps, outcome);
  shade_pixel(s, ray, depth, outcome, rgb + 3 * i);
  if (Mode != K1_FRESH || depth_io != nullptr) {
    depth_io[i] = depth;
    steps_io[i] = steps;
    outcome_io[i] = outcome;
  }
  if (Mode != K1_FRESH) active_io[i] = unresolved(s, steps, outcome, budget);
}

// K2. Without Listed, one thread per pixel in K1's layout; with Listed,
// thread t < *count marches ray rays[t] of the frame. The carried state is
// (depth0, steps0, outcome0, active0), or depth 0, steps 0, DEPTH_LIMIT and
// active for every ray when depth0 is null. Rays that are not active keep
// their state. `active` is written when not null. The carried planes may be
// the output planes (Listed runs in place).
template <bool Cull, bool Relaxed, bool Listed>
__global__ void __launch_bounds__(128)
trace_kernel(const SceneDesc s, const float* __restrict__ origins,
             const float* __restrict__ directions, const float* __restrict__ cone,
             const float* depth0, const int* steps0, const int* outcome0, const int* active0,
             float* depth_out, int* steps_out, int* outcome_out, int* active_out,
             const int* __restrict__ rays, const int* __restrict__ count, int cap, float omega,
             int h, int w) {
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
  float depth = 0.0f;
  int steps = 0;
  int outcome = DEPTH_LIMIT;
  bool active = true;
  if (depth0 != nullptr) {
    depth = depth0[i];
    steps = steps0[i];
    outcome = outcome0[i];
    active = active0[i] != 0;
  }
  if (active) {
    march_ray<Cull, Relaxed>(s, load_ray(origins, directions, cone, i), cap, omega, depth, steps,
                             outcome);
  }
  depth_out[i] = depth;
  steps_out[i] = steps;
  outcome_out[i] = outcome;
  if (active_out != nullptr) active_out[i] = unresolved(s, steps, outcome, cap);
}

// K3, one thread per pixel in K1's layout
__global__ void __launch_bounds__(128)
shade_kernel(const SceneDesc s, const float* __restrict__ origins,
             const float* __restrict__ directions, const float* __restrict__ depth,
             const int* __restrict__ outcome, float* __restrict__ rgb, int h, int w) {
  int px, py;
  block_pixel(blockIdx.x, blockIdx.y, px, py);
  if (px >= w || py >= h) return;
  const long long i = (long long)py * w + px;
  const int oc = outcome[i];
  Ray ray{};
  float t = 0.0f;
  if (oc == COLLISION) {
    // only a hit reads its depth and ray
    ray = Ray{origins[3 * i],    origins[3 * i + 1],    origins[3 * i + 2], directions[3 * i],
              directions[3 * i + 1], directions[3 * i + 2], 0.0f};
    t = depth[i];
  }
  shade_pixel(s, ray, t, oc, rgb + 3 * i);
}

template <bool Cull, bool Relaxed>
static void launch_render(int mode, cudaStream_t stream, const SceneDesc& s, const float* origins,
                          const float* directions, const float* cone, float* rgb, float* depth,
                          int* steps, int* outcome, int* active, const int* blocks,
                          const int* count, int cap, float omega, int h, int w) {
  const dim3 block(128);
  const dim3 grid((w + 15) / 16, (h + 7) / 8);
  if (mode == K1_FRESH) {
    render_kernel<Cull, Relaxed, K1_FRESH><<<grid, block, 0, stream>>>(
        s, origins, directions, cone, rgb, depth, steps, outcome, active, blocks, count, cap,
        omega, h, w);
  } else if (mode == K1_PHASE_A) {
    render_kernel<Cull, Relaxed, K1_PHASE_A><<<grid, block, 0, stream>>>(
        s, origins, directions, cone, rgb, depth, steps, outcome, active, blocks, count, cap,
        omega, h, w);
  } else {
    // the worst case: every block listed
    render_kernel<Cull, Relaxed, K1_RESUME><<<grid.x * grid.y, block, 0, stream>>>(
        s, origins, directions, cone, rgb, depth, steps, outcome, active, blocks, count, cap,
        omega, h, w);
  }
}

template <bool Cull, bool Relaxed>
static void launch_trace(cudaStream_t stream, const SceneDesc& s, const float* origins,
                         const float* directions, const float* cone, const float* depth0,
                         const int* steps0, const int* outcome0, const int* active0, float* depth,
                         int* steps, int* outcome, int* active, const int* rays, const int* count,
                         int cap, float omega, int h, int w) {
  const dim3 block(128);
  if (rays != nullptr) {
    // the worst case: every ray listed
    const long long n = (long long)h * w;
    trace_kernel<Cull, Relaxed, true><<<static_cast<unsigned>((n + 127) / 128), block, 0, stream>>>(
        s, origins, directions, cone, depth0, steps0, outcome0, active0, depth, steps, outcome,
        active, rays, count, cap, omega, h, w);
  } else {
    const dim3 grid((w + 15) / 16, (h + 7) / 8);
    trace_kernel<Cull, Relaxed, false><<<grid, block, 0, stream>>>(
        s, origins, directions, cone, depth0, steps0, outcome0, active0, depth, steps, outcome,
        active, rays, count, cap, omega, h, w);
  }
}

extern "C" {

// Launches K1 on `stream` over an h x w image. origins and directions are
// (h, w, 3), cone (h, w), rgb (h, w, 3), all float32 on the device; depth,
// steps, outcome and active are (h, w) planes. mode is 0 (FRESH; the planes
// written when depth is not null), 1 (PHASE_A) or 2 (RESUME over `blocks`
// and the device-resident `count`); cull and relaxed pick the march; cap is
// the step budget of modes 1 and 2, omega the relaxation. Returns the
// cudaError_t of the launch.
int bsdmg_render(const SceneDesc* desc, const float* origins, const float* directions,
                 const float* cone, float* rgb, float* depth, int* steps, int* outcome,
                 int* active, const int* blocks, const int* count, int mode, int cull,
                 int relaxed, int cap, float omega, int h, int w, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cull && !relaxed) {
    launch_render<true, false>(mode, st, *desc, origins, directions, cone, rgb, depth, steps,
                               outcome, active, blocks, count, cap, omega, h, w);
  } else if (cull) {
    launch_render<true, true>(mode, st, *desc, origins, directions, cone, rgb, depth, steps,
                              outcome, active, blocks, count, cap, omega, h, w);
  } else if (!relaxed) {
    launch_render<false, false>(mode, st, *desc, origins, directions, cone, rgb, depth, steps,
                                outcome, active, blocks, count, cap, omega, h, w);
  } else {
    launch_render<false, true>(mode, st, *desc, origins, directions, cone, rgb, depth, steps,
                               outcome, active, blocks, count, cap, omega, h, w);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K2 on `stream` over an h x w frame, planes as bsdmg_render's.
// depth0, steps0, outcome0 and active0 are the carried state, all null for
// a fresh march; `active` may be null. With `rays` not null, the first
// *count entries of it are the rays to march (count device-resident).
// Returns the cudaError_t of the launch.
int bsdmg_trace(const SceneDesc* desc, const float* origins, const float* directions,
                const float* cone, const float* depth0, const int* steps0, const int* outcome0,
                const int* active0, float* depth, int* steps, int* outcome, int* active,
                const int* rays, const int* count, int cull, int relaxed, int cap, float omega,
                int h, int w, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cull && !relaxed) {
    launch_trace<true, false>(st, *desc, origins, directions, cone, depth0, steps0, outcome0,
                              active0, depth, steps, outcome, active, rays, count, cap, omega, h,
                              w);
  } else if (cull) {
    launch_trace<true, true>(st, *desc, origins, directions, cone, depth0, steps0, outcome0,
                             active0, depth, steps, outcome, active, rays, count, cap, omega, h,
                             w);
  } else if (!relaxed) {
    launch_trace<false, false>(st, *desc, origins, directions, cone, depth0, steps0, outcome0,
                               active0, depth, steps, outcome, active, rays, count, cap, omega, h,
                               w);
  } else {
    launch_trace<false, true>(st, *desc, origins, directions, cone, depth0, steps0, outcome0,
                              active0, depth, steps, outcome, active, rays, count, cap, omega, h,
                              w);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K3 on `stream`: rgb (h, w, 3) from the depth and outcome planes.
// Returns the cudaError_t of the launch.
int bsdmg_shade(const SceneDesc* desc, const float* origins, const float* directions,
                const float* depth, const int* outcome, float* rgb, int h, int w, void* stream) {
  const dim3 grid((w + 15) / 16, (h + 7) / 8);
  shade_kernel<<<grid, dim3(128), 0, static_cast<cudaStream_t>(stream)>>>(
      *desc, origins, directions, depth, outcome, rgb, h, w);
  return static_cast<int>(cudaGetLastError());
}

int bsdmg_scene_desc_size(void) { return static_cast<int>(sizeof(SceneDesc)); }

const char* bsdmg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
