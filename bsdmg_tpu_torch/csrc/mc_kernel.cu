// K6: the fused marching-cubes finish, one thread per voxel.
//
// Replaces the TPU kernel bsdmg_tpu/ops/pallas/mc_fused.py::_mc_kernel (the
// pallas_call at mc_fused.py:306 of mc_fused_pallas), which the JAX
// package's default mesh path reaches through
// ops/marching_cubes.py::_finish_fused. Per voxel, in order:
//
// 1. unpack the 12 crossing bits; an edge's exclusive rank is the number of
//    crossing edges before it;
// 2. the crossing edges of rank < budget start at their edge midpoints (the
//    reference's vertex placement, cuda/includes/marching_cubes.cu:14);
// 3. Newton projection of each (project.cuh, the analytic gradient of
//    scene_sdf.cuh or fd4), then the fd4 unit normal at the projected point;
// 4. each of the 15 triangle slots takes its edge's result through the
//    edge's rank; a slot whose edge has rank >= budget is invalid;
// 5. the winding test (vertex-mean normal, or the fd4 normal at the
//    centroid) and the a <-> c swap; invalid triangles are zero;
// 6. the meta word: bit t for triangle t valid, bits 5+ the count of
//    crossing edges beyond the budget.
//
// Outputs per voxel i: pos and nrm (N, 45) = (N, 5 triangles, 3 vertices,
// 3 coordinates), dot (N, 5) the winding dot product (0 for an invalid
// triangle), amb (N, 5) the ambiguous-winding flags that the wrapper
// re-resolves with the centroid stencil, meta (N,). Every slot names a
// crossing edge (a property of the case table for the case the crossing
// bits come from), so no slot reads a lane that was not projected.
//
// What bounds it on Hopper: FP32 work. A crossing edge costs a few Newton
// steps (one analytic value and gradient each, 263 FP32 operations with the
// update) and a 12-evaluation fd4 normal (~900 operations); a voxel has ~4
// crossing edges. Memory traffic is 24 B read and 404 B written per voxel, most of
// it the triangle soup. What the design does about it: one thread owns a
// voxel, so each edge leaves its Newton loop on its own, as each lane of
// the TPU kernel does, and nothing but the outputs touches device memory
// (the projected edges sit in a per-thread array). The TPU kernel's tile
// layout, interleaved Newton chains and select-based picks answer the TPU's
// vector unit and are left behind. Making this kernel fast is later work.
//
// Numerics: built with -fmad=false and without fast math (ops/cuda/build.py)
// and every operation in the twin's order (mc_fused_torch in
// bsdmg_tpu_torch/ops/cuda/mc_kernel.py), so the outputs equal the twin's
// bit for bit.

#include "project.cuh"

// MC_EDGE_MIDPOINTS of ops/tables.py, in voxel units
// (tests/test_torch_mc_kernel.py holds the two equal)
__constant__ float kEdgeMid[12][3] = {
    {0.5f, 0.0f, 0.0f}, {1.0f, 0.5f, 0.0f}, {0.5f, 1.0f, 0.0f}, {0.0f, 0.5f, 0.0f},
    {0.5f, 0.0f, 1.0f}, {1.0f, 0.5f, 1.0f}, {0.5f, 1.0f, 1.0f}, {0.0f, 0.5f, 1.0f},
    {0.0f, 0.0f, 0.5f}, {1.0f, 0.0f, 0.5f}, {1.0f, 1.0f, 0.5f}, {0.0f, 1.0f, 0.5f},
};

template <class S>
__global__ void __launch_bounds__(128)
mc_kernel(const SceneDesc s, const float* __restrict__ lx, const float* __restrict__ ly,
          const float* __restrict__ lz, const int* __restrict__ cross_bits,
          const int* __restrict__ t0, const int* __restrict__ t1, float vs, int n, int budget,
          int iters, float tol, float eps, int use_grad, int centroid_winding,
          float* __restrict__ pos, float* __restrict__ nrm, float* __restrict__ dot_out,
          int* __restrict__ amb_out, int* __restrict__ meta_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x0 = lx[i], y0 = ly[i], z0 = lz[i];
  const unsigned bits = static_cast<unsigned>(cross_bits[i]) & 0xfffu;

  // projected crossing edges, packed by rank
  float px[12], py[12], pz[12], qx[12], qy[12], qz[12];
  int run = 0;
#pragma unroll 1
  for (int e = 0; e < 12; ++e) {
    if (!((bits >> e) & 1u)) continue;
    const int j = run++;
    if (j >= budget) continue;
    float x = x0 + vs * kEdgeMid[e][0];
    float y = y0 + vs * kEdgeMid[e][1];
    float z = z0 + vs * kEdgeMid[e][2];
    newton_project<S>(s, x, y, z, iters, tol, eps, use_grad);
    px[j] = x;
    py[j] = y;
    pz[j] = z;
    unit_normal_fd4<S>(s, x, y, z, eps, qx[j], qy[j], qz[j]);
  }

  const unsigned lo = static_cast<unsigned>(t0[i]);
  const unsigned hi = static_cast<unsigned>(t1[i]);
  int meta = (run > budget ? run - budget : 0) << 5;
  const long long base = static_cast<long long>(i) * 45;
#pragma unroll 1
  for (int t = 0; t < 5; ++t) {
    float v[3][3], nn[3][3];
    bool tri_ok = true;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int slot = 3 * t + k;
      const unsigned nib = (slot < 8 ? lo >> (4 * slot) : hi >> (4 * (slot - 8))) & 15u;
      const int rank = nib < 12u ? __popc(bits & ((1u << nib) - 1u)) : budget;
      const bool ok = rank < budget;
      const int r = ok ? rank : 0;
      tri_ok = tri_ok && ok;
      v[k][0] = ok ? px[r] : 0.0f;
      v[k][1] = ok ? py[r] : 0.0f;
      v[k][2] = ok ? pz[r] : 0.0f;
      nn[k][0] = ok ? qx[r] : 0.0f;
      nn[k][1] = ok ? qy[r] : 0.0f;
      nn[k][2] = ok ? qz[r] : 0.0f;
    }
    float dot = 0.0f;
    bool amb = false;
    bool flip = false;
    if (tri_ok) {
      meta |= 1 << t;
      const float e1x = v[1][0] - v[0][0], e1y = v[1][1] - v[0][1], e1z = v[1][2] - v[0][2];
      const float e2x = v[2][0] - v[0][0], e2y = v[2][1] - v[0][1], e2z = v[2][2] - v[0][2];
      const float gx = e1y * e2z - e1z * e2y;
      const float gy = e1z * e2x - e1x * e2z;
      const float gz = e1x * e2y - e1y * e2x;
      float ax, ay, az;
      if (centroid_winding) {
        fd4_grad<S>(s, ((v[0][0] + v[1][0]) + v[2][0]) / 3.0f,
                    ((v[0][1] + v[1][1]) + v[2][1]) / 3.0f,
                    ((v[0][2] + v[1][2]) + v[2][2]) / 3.0f, eps, ax, ay, az);
        dot = (gx * ax + gy * ay) + gz * az;
      } else {
        ax = (nn[0][0] + nn[1][0]) + nn[2][0];
        ay = (nn[0][1] + nn[1][1]) + nn[2][1];
        az = (nn[0][2] + nn[1][2]) + nn[2][2];
        dot = (gx * ax + gy * ay) + gz * az;
        const float g2 = (gx * gx + gy * gy) + gz * gz;
        const float a2 = (ax * ax + ay * ay) + az * az;
        amb = dot * dot <= (1e-4f * g2) * a2;
      }
      flip = dot <= 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int src = flip ? 2 - k : k;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        pos[base + 9 * t + 3 * k + c] = tri_ok ? v[src][c] : 0.0f;
        nrm[base + 9 * t + 3 * k + c] = tri_ok ? nn[src][c] : 0.0f;
      }
    }
    dot_out[5 * static_cast<long long>(i) + t] = dot;
    amb_out[5 * static_cast<long long>(i) + t] = amb ? 1 : 0;
  }
  meta_out[i] = meta;
}

extern "C" {

// Launches K6 on `stream` over n voxels. lx, ly, lz (n,) float32 and
// cross_bits, t0, t1 (n,) int32 in; pos and nrm (n, 45) float32, dot (n, 5)
// float32, amb (n, 5) int32 and meta (n,) int32 out, all on the device.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a
// descriptor structure that names none).
int bsdmg_mc_fused(const SceneDesc* desc, const float* lx, const float* ly, const float* lz,
                   const int* cross_bits, const int* t0, const int* t1, float voxel_size, int n,
                   int budget, int iters, float tol, float eps, int use_grad,
                   int centroid_winding, float* pos, float* nrm, float* dot, int* amb,
                   int* meta, void* stream) {
  const dim3 block(128);
  const dim3 grid((n + 127) / 128);
  const bool known = with_structure(desc->structure, [&](auto scene) {
    mc_kernel<decltype(scene)><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        *desc, lx, ly, lz, cross_bits, t0, t1, voxel_size, n, budget, iters, tol, eps, use_grad,
        centroid_winding, pos, nrm, dot, amb, meta);
  });
  return known ? static_cast<int>(cudaGetLastError()) : static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
