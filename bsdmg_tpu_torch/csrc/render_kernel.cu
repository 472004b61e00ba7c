// K1: fused sphere trace + shade of the reference scenes, one thread per pixel.
//
// Replaces the TPU kernel bsdmg_tpu/ops/pallas/render_kernel.py::_trace_kernel
// with shade=True: the single pallas_call (render_kernel.py:526) of the JAX
// package's default render path, render_image_pallas -> _render_fused_call.
// Per ray it runs the slab cull (_slab_cull), the exact sphere-trace march
// (_march, omega = 1), fd4 normals (_fd_normal), the Lambert two-colour mix
// (ops/shade.py::shade_planes) and the ACES tonemap (_aces_plane).
//
// What bounds it on Hopper: FP32 and SFU work per march step (one scene SDF
// is two sets of 12 capsules in 3 factorised groups each, a sphere and a
// smooth-min: 128 FP32 operations, 3 of them sqrt), and warp divergence, since a warp runs as long as
// its slowest ray and silhouette rays take up to 256 steps. Memory traffic
// is small: 28 B read (origin, direction, cone) and 12 B written (RGB) per
// ray, 52 B with the depth/steps/outcome planes.
//
// What the design does about it: each warp covers a compact 8x4 pixel patch
// (the TPU path's 32x32 swizzle, render_kernel.py:834-854, stood in for the
// same thing), so its rays finish in similar step counts; each ray leaves
// the loop as soon as it resolves; the scene descriptor is a by-value kernel
// parameter, so every thread reads the same constant-bank words; the fd4
// stencil is a rolled loop around one inlined SDF, which keeps code size
// and registers down. Over-relaxation, per-ray near/far scene splits and
// block retirement are not ported: by the JAX package's tests they change no
// pixel, and making this kernel fast is later work.
//
// Numerics: built without --use_fast_math (IEEE sqrtf and division) and
// with -fmad=false (ops/cuda/build.py). Every float constant arrives as the
// float32 the plain PyTorch twin (bsdmg_tpu_torch/ops/cuda/render_kernel.py)
// computes with, and each sum and product runs in the JAX kernel's order, so
// the kernel's planes and image equal the twin's bit for bit. With FMA
// contraction, silhouette rays flip the hit test `dist <= cd + eps` and end
// with other step counts. The scene SDF is scene_sdf.cuh's, shared with the
// mesh kernels; the slab cull and the shading are common.cuh's, shared with
// K4 and K5.

#include "scene_sdf.cuh"

__global__ void __launch_bounds__(128)
render_kernel(const SceneDesc s, const float* __restrict__ origins,
              const float* __restrict__ directions, const float* __restrict__ cone,
              float* __restrict__ rgb, float* __restrict__ depth_out,
              int* __restrict__ steps_out, int* __restrict__ outcome_out, int h, int w) {
  // a block covers 16x8 pixels, each of its 4 warps an 8x4 patch
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int px = blockIdx.x * 16 + (warp & 1) * 8 + (lane & 7);
  const int py = blockIdx.y * 8 + (warp >> 1) * 4 + (lane >> 3);
  if (px >= w || py >= h) return;
  const long long i = (long long)py * w + px;

  const float ox = origins[3 * i], oy = origins[3 * i + 1], oz = origins[3 * i + 2];
  const float dx = directions[3 * i], dy = directions[3 * i + 1], dz = directions[3 * i + 2];
  const float c = cone[i];
  const float eps = s.collision_distance;

  // slab cull (render_kernel.py:89-124, :355-368)
  float limit;
  const bool miss = slab_cull(s, ox, oy, oz, dx, dy, dz, c, limit);

  // exact sphere trace from depth 0 (render_kernel.py:170-190)
  float depth = 0.0f;
  int steps = 0;
  int outcome = STEP_LIMIT;
  if (miss) {
    depth = s.cull_depth;
    outcome = DEPTH_LIMIT;
  } else {
    for (;;) {
      const float cd = c * depth;
      const float dist = scene_sdf(s, ox + depth * dx, oy + depth * dy, oz + depth * dz);
      if (dist <= cd + eps) {
        outcome = COLLISION;
        break;
      }
      depth = (depth + dist) - cd;
      if (depth > limit) {
        outcome = DEPTH_LIMIT;
        break;
      }
      if (++steps >= s.step_limit) break;
    }
  }

  // shade (ops/shade.py::shade_planes)
  float r, g, b;
  if (outcome == COLLISION) {
    const float px3 = ox + depth * dx, py3 = oy + depth * dy, pz3 = oz + depth * dz;
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

  // ACES (render_kernel.py::_aces_plane)
  float out[3];
  aces(s, r, g, b, out);
  rgb[3 * i] = out[0];
  rgb[3 * i + 1] = out[1];
  rgb[3 * i + 2] = out[2];
  if (depth_out != nullptr) {
    depth_out[i] = depth;
    steps_out[i] = steps;
    outcome_out[i] = outcome;
  }
}

extern "C" {

// Launches K1 on `stream` over an h x w image. origins and directions are
// (h, w, 3), cone (h, w), rgb (h, w, 3), all float32 on the device; depth,
// steps and outcome are (h, w) planes, written when depth is not null.
// Returns the cudaError_t of the launch.
int bsdmg_render(const SceneDesc* desc, const float* origins, const float* directions,
                 const float* cone, float* rgb, float* depth, int* steps, int* outcome,
                 int h, int w, void* stream) {
  const dim3 block(128);
  const dim3 grid((w + 15) / 16, (h + 7) / 8);
  render_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      *desc, origins, directions, cone, rgb, depth, steps, outcome, h, w);
  return static_cast<int>(cudaGetLastError());
}

int bsdmg_scene_desc_size(void) { return static_cast<int>(sizeof(SceneDesc)); }

const char* bsdmg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
