// K4 and K5: the differentiable render's kernels, one thread per pixel.
//
// K4 (march_params_kernel) replaces the TPU kernel
// bsdmg_tpu/ops/pallas/diff_kernel.py::_march_kernel (pallas_call :162): the
// stopped sphere-trace march under runtime parameters that the
// differentiable render re-attaches by the implicit function theorem. Per
// ray: the optional slab cull against the caller's trust-region bounds, the
// exact march (omega = 1) with, on request, the closest-approach record
// (min_m = min over sampled points of f - cone*t, and its depth t_min), and
// dfdt, the SDF's derivative along the ray at the end point.
//
// K5 (loss_grad_kernel + loss_grad_sum) replaces
// diff_kernel.py::_loss_grad_kernel (pallas_call :405): the whole image-fit
// step. Per ray: K4's march, the IFT re-attachment t_diff = t0 -
// residual/denom, the analytic normal at q = o + t_diff d, the shading and
// ACES, the squared error against the target and, with edge_weight, the
// silhouette hinge of grad/edge.py at the closest-approach point. The JAX
// kernel differentiates this with reverse mode inside the kernel; here the
// parameters are forward-mode duals (dual.cuh): each parameter slot carries
// its unit tangent, so the loss's tangents are dL/dtheta. The normal's
// tangents follow from evaluating the hand-written spatial gradient
// (param_sdf.cuh) in duals at a point q whose tangents are dq/dtheta.
//
// What bounds them on Hopper: FP32 work, SFU work (3 sqrt per SDF) and warp
// divergence in the march, as in K1; in K5 also the tangent work of each
// hit, about n_prm + 1 times a value-and-gradient, and the registers it
// needs (Dual<9> holds 10 floats per value; Dual<16>, with the object
// transform, 17). Memory traffic is 28 B in per ray and 16-24 B out (K4),
// 40-44 B in (K5).
//
// What the design does about it: K1's layout (warps on 8x4 pixel patches
// that finish in similar step counts, the scene as a by-value kernel
// parameter); the march in plain float, tangents only for the rays that
// collide (photometric term) or carry a silhouette hinge; the dual width
// chosen per call (9 or 16 tangents). K5's sum is deterministic and uses no
// float atomics: a shuffle reduction per warp, a fixed-order sum per block
// into a scratch buffer, and a second launch (loss_grad_sum) that adds the
// blocks' partial sums in a fixed order. Two calls on the same inputs give
// the same bits. The near/far tile split of the TPU kernels is not ported:
// in a far tile the JAX march sees only the wireframe, which equals the full
// scene wherever such a ray goes.
//
// Numerics: built with -fmad=false and without fast math, like K1. The
// march evaluates the scene in the twin's operation order, so K4's depth,
// steps, outcome, min_m and t_min equal the twin's bit for bit; dfdt comes
// from the hand-written gradient and the twin's from autograd, which sum in
// other orders. The twins are march_params_torch and render_loss_grad_torch
// in bsdmg_tpu_torch/ops/cuda/diff_kernel.py.

#include "param_sdf.cuh"

// min_m of a ray that no sample reached (grad/edge.py::UNTRACKED)
#define BSDMG_UNTRACKED 1e9f

// the stopped march of one ray (render_kernel.py::_march, omega = 1, with
// track_min); the parameters are plain floats
__device__ __forceinline__ void march(const ParamScene& s, const ObjectParams<float>& p,
                                      const float o[3], const float d[3], float c, bool track,
                                      float& depth, int& steps, int& outcome, float& min_m,
                                      float& t_min) {
  const float eps = s.collision_distance;
  depth = 0.0f;
  steps = 0;
  outcome = STEP_LIMIT;
  min_m = BSDMG_UNTRACKED;
  t_min = 0.0f;
  float limit = s.depth_limit;
  if (s.use_bounds && slab_cull(s, o[0], o[1], o[2], d[0], d[1], d[2], c, limit)) {
    depth = s.cull_depth;
    outcome = DEPTH_LIMIT;
    return;
  }
  for (;;) {
    const float cd = c * depth;
    const float x[3] = {o[0] + depth * d[0], o[1] + depth * d[1], o[2] + depth * d[2]};
    const float dist = scene_value(s, p, x);
    if (track) {
      const float m = dist - cd;
      if (m < min_m) {
        min_m = m;
        t_min = depth;
      }
    }
    if (dist <= cd + eps) {
      outcome = COLLISION;
      return;
    }
    depth = (depth + dist) - cd;
    if (depth > limit) {
      outcome = DEPTH_LIMIT;
      return;
    }
    if (++steps >= s.step_limit) return;
  }
}

// the SDF's derivative along d at o + t d, parameters stopped
__device__ __forceinline__ float ray_derivative(const ParamScene& s, const ObjectParams<float>& p,
                                                const float o[3], const float d[3], float t) {
  const float x[3] = {o[0] + t * d[0], o[1] + t * d[1], o[2] + t * d[2]};
  float g[3];
  scene_value_grad(s, p, x, g);
  return (g[0] * d[0] + g[1] * d[1]) + g[2] * d[2];
}

// the pixel of thread threadIdx.x: a block covers 16x8 pixels, each of its 4
// warps an 8x4 patch
__device__ __forceinline__ void pixel_of_thread(int& px, int& py) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  px = blockIdx.x * 16 + (warp & 1) * 8 + (lane & 7);
  py = blockIdx.y * 8 + (warp >> 1) * 4 + (lane >> 3);
}

__global__ void __launch_bounds__(128)
march_params_kernel(const ParamScene s, const float* __restrict__ origins,
                    const float* __restrict__ directions, const float* __restrict__ cone,
                    float* __restrict__ depth_out, int* __restrict__ steps_out,
                    int* __restrict__ outcome_out, float* __restrict__ dfdt_out,
                    float* __restrict__ min_m_out, float* __restrict__ t_min_out, int h, int w) {
  int px, py;
  pixel_of_thread(px, py);
  if (px >= w || py >= h) return;
  const long long i = (long long)py * w + px;
  const float o[3] = {origins[3 * i], origins[3 * i + 1], origins[3 * i + 2]};
  const float d[3] = {directions[3 * i], directions[3 * i + 1], directions[3 * i + 2]};
  const float c = cone[i];
  const ObjectParams<float> p = load_params<float>(s);
  float depth, min_m, t_min;
  int steps, outcome;
  march(s, p, o, d, c, min_m_out != nullptr, depth, steps, outcome, min_m, t_min);
  depth_out[i] = depth;
  steps_out[i] = steps;
  outcome_out[i] = outcome;
  dfdt_out[i] = ray_derivative(s, p, o, d, depth);
  if (min_m_out != nullptr) {
    min_m_out[i] = min_m;
    t_min_out[i] = t_min;
  }
}

// the loss of one pixel and its tangents (diff_kernel.py:294-338)
template <int N>
__device__ __forceinline__ Dual<N> pixel_loss(const ParamScene& s, const float o[3], const float d[3],
                                              float c, const float target[3], float t_state,
                                              bool edge, float inv_denom_elems, float inv_pixels,
                                              float edge_weight, float edge_band) {
  typedef Dual<N> D;
  const ObjectParams<float> p0 = load_params<float>(s);
  float t0, min_m, t_min;
  int steps, outcome;
  march(s, p0, o, d, c, edge, t0, steps, outcome, min_m, t_min);
  const bool collided = outcome == COLLISION;
  const ObjectParams<D> p = load_params<D>(s);

  D rgb[3];
  if (collided) {
    // IFT re-attachment: t_diff = t0 - (f(x0) - cone t0 - eps) / stop(df/dt - cone)
    float denom = ray_derivative(s, p0, o, d, t0) - c;
    if (fabsf(denom) < 1e-6f) denom = -1e-6f;
    const D x0[3] = {Scalar<D>::constant(o[0] + t0 * d[0]), Scalar<D>::constant(o[1] + t0 * d[1]),
                     Scalar<D>::constant(o[2] + t0 * d[2])};
    const D residual = (scene_value(s, p, x0) - c * t0) - s.collision_distance;
    const D t_diff = t0 - residual / denom;
    const D q[3] = {o[0] + t_diff * d[0], o[1] + t_diff * d[1], o[2] + t_diff * d[2]};
    D g[3];
    scene_value_grad(s, p, q, g);
    const D inv = 1.0f / vsqrt(vmax((g[0] * g[0] + g[1] * g[1]) + g[2] * g[2], 1e-24f));
    D r, gg, b;
    shade_collision(s, g[0] * inv, g[1] * inv, g[2] * inv, r, gg, b);
    aces(s, r, gg, b, rgb);
  } else {
    const float v = outcome == STEP_LIMIT ? 1.0f : 0.0f;
    float out[3];
    aces(s, v, v, v, out);
#pragma unroll
    for (int a = 0; a < 3; ++a) rgb[a] = Scalar<D>::constant(out[a]);
  }
  const D er = rgb[0] - target[0], eg = rgb[1] - target[1], eb = rgb[2] - target[2];
  D total = ((er * er + eg * eg) + eb * eb) * inv_denom_elems;

  if (edge) {
    // silhouette hinge (grad/edge.py::edge_loss_planes)
    const bool valid = t_state > -0.5f;
    const bool target_miss = t_state > 0.5f;
    const bool appear = valid && !target_miss && !collided && min_m < BSDMG_UNTRACKED;
    const bool vanish = valid && target_miss && collided;
    if (appear || vanish) {
      const D xe[3] = {Scalar<D>::constant(o[0] + t_min * d[0]),
                       Scalar<D>::constant(o[1] + t_min * d[1]),
                       Scalar<D>::constant(o[2] + t_min * d[2])};
      const D m = scene_value(s, p, xe) - c * t_min;
      const D e = appear ? vmax(m, 0.0f) : vmax(edge_band - m, 0.0f);
      total = total + (e * edge_weight) * inv_pixels;
    }
  }
  return total;
}

template <int N>
__global__ void __launch_bounds__(128)
loss_grad_kernel(const ParamScene s, const float* __restrict__ origins,
                 const float* __restrict__ directions, const float* __restrict__ cone,
                 const float* __restrict__ target, const float* __restrict__ t_state,
                 float* __restrict__ partials, int h, int w, float inv_denom_elems,
                 float inv_pixels, float edge_weight, float edge_band) {
  int px, py;
  pixel_of_thread(px, py);
  float acc[N + 1];
#pragma unroll
  for (int k = 0; k <= N; ++k) acc[k] = 0.0f;
  if (px < w && py < h) {
    const long long i = (long long)py * w + px;
    const float o[3] = {origins[3 * i], origins[3 * i + 1], origins[3 * i + 2]};
    const float d[3] = {directions[3 * i], directions[3 * i + 1], directions[3 * i + 2]};
    const float tgt[3] = {target[3 * i], target[3 * i + 1], target[3 * i + 2]};
    const bool edge = t_state != nullptr;
    const Dual<N> loss = pixel_loss<N>(s, o, d, cone[i], tgt, edge ? t_state[i] : 0.0f, edge,
                                       inv_denom_elems, inv_pixels, edge_weight, edge_band);
    acc[0] = loss.v;
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k + 1] = loss.t[k];
  }

  // deterministic block sum: shuffles within each warp, then the 4 warps in order
  __shared__ float warp_sums[4][N + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k <= N; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x <= N) {
    const int k = threadIdx.x;
    const long long block = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    partials[block * (N + 1) + k] =
        ((warp_sums[0][k] + warp_sums[1][k]) + warp_sums[2][k]) + warp_sums[3][k];
  }
}

// out[k] = the sum over blocks of partials[block * stride + k], one block per
// k, each thread over a fixed stride of blocks, then a fixed tree
__global__ void __launch_bounds__(256)
loss_grad_sum(const float* __restrict__ partials, int n_blocks, int stride, float* __restrict__ out) {
  __shared__ float sums[256];
  const int k = blockIdx.x;
  float acc = 0.0f;
  for (int b = threadIdx.x; b < n_blocks; b += 256) acc += partials[(long long)b * stride + k];
  sums[threadIdx.x] = acc;
  __syncthreads();
  for (int half = 128; half > 0; half >>= 1) {
    if (threadIdx.x < half) sums[threadIdx.x] += sums[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[k] = sums[0];
}

// the dual width of K5 for n_prm parameters
static int tangents(int n_prm) { return n_prm <= 9 ? 9 : BSDMG_MAX_PARAMS; }

extern "C" {

// Launches K4 on `stream` over an h x w image: origins and directions
// (h, w, 3), cone (h, w); depth, dfdt (float) and steps, outcome (int) are
// (h, w) planes, and min_m, t_min too when min_m is not null (track_min).
// Returns the cudaError_t of the launch.
int bsdmg_march_params(const ParamScene* scene, const float* origins, const float* directions,
                       const float* cone, float* depth, int* steps, int* outcome, float* dfdt,
                       float* min_m, float* t_min, int h, int w, void* stream) {
  const dim3 grid((w + 15) / 16, (h + 7) / 8);
  march_params_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      *scene, origins, directions, cone, depth, steps, outcome, dfdt, min_m, t_min, h, w);
  return static_cast<int>(cudaGetLastError());
}

// floats of scratch that bsdmg_loss_grad needs for an h x w image
int bsdmg_loss_grad_scratch(int h, int w, int n_prm) {
  return ((w + 15) / 16) * ((h + 7) / 8) * (tangents(n_prm) + 1);
}

// Launches K5 on `stream`: target (h, w, 3); t_state (h, w), or null for
// no edge term; partials, bsdmg_loss_grad_scratch floats; out, n_prm + 1
// floats: the loss, then dL/dprm. Returns the cudaError_t of the first
// launch that failed, else 0.
int bsdmg_loss_grad(const ParamScene* scene, const float* origins, const float* directions,
                    const float* cone, const float* target, const float* t_state,
                    float* partials, float* out, int h, int w, float inv_denom_elems,
                    float inv_pixels, float edge_weight, float edge_band, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((w + 15) / 16, (h + 7) / 8);
  const int n = tangents(scene->n_prm);
  if (n == 9) {
    loss_grad_kernel<9><<<grid, 128, 0, st>>>(*scene, origins, directions, cone, target, t_state,
                                               partials, h, w, inv_denom_elems, inv_pixels,
                                               edge_weight, edge_band);
  } else {
    loss_grad_kernel<BSDMG_MAX_PARAMS><<<grid, 128, 0, st>>>(
        *scene, origins, directions, cone, target, t_state, partials, h, w, inv_denom_elems,
        inv_pixels, edge_weight, edge_band);
  }
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  loss_grad_sum<<<scene->n_prm + 1, 256, 0, st>>>(partials, grid.x * grid.y, n + 1, out);
  return static_cast<int>(cudaGetLastError());
}

int bsdmg_param_scene_size(void) { return static_cast<int>(sizeof(ParamScene)); }

}  // extern "C"
