// K6: the fused marching-cubes finish, one crossing edge a thread, each
// block's triangles assembled in shared memory.
//
// Replaces the TPU kernel bsdmg_tpu/ops/pallas/mc_fused.py::_mc_kernel (the
// pallas_call at mc_fused.py:306 of mc_fused_pallas), which the JAX
// package's default mesh path reaches through
// ops/marching_cubes.py::_finish_fused. It is built for every structure of
// with_mesh_structure (scene_sdf.cuh): the built-in scenes, a composed
// scene's node program, and a mesh asset's baked grid (GridScene), which
// the JAX package meshes in XLA. Per voxel, in order:
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
// re-resolves with the centroid stencil, meta (N,).
//
// What bounds it on Hopper: FP32 work and its spread over a warp's lanes. A
// crossing edge costs a few Newton steps (one analytic value and gradient
// each, 263 FP32 operations with the update) and a 12-point fd4 normal
// (~560 operations, the terms that a shift leaves alone shared: project.cuh);
// a voxel has ~4 crossing edges. Memory traffic is 24 B
// read and 404 B written per voxel, most of it the triangle soup.
//
// What the design does about it: a block of 256 threads owns 60
// consecutive voxels. It lists their projected edges in shared memory (an
// exclusive scan of min(popc(bits), budget) over the voxels gives each
// voxel its first slot, an edge's rank its place after it), and each thread
// projects the edges of the list that fall to it, about one, so a warp runs
// 32 edges of ~8 voxels side by side, not the union of 32 voxels' edges one
// edge index at a time (SIMT efficiency 0.81 against 0.32 at level 3), and
// the list fills the card at level 3 (1,103 blocks of 256 threads where one
// voxel a thread made 517 blocks of 128). The projected points and normals
// stay in shared memory; after a barrier a thread takes each triangle slot
// (one triangle index a warp), and the block writes its outputs as
// contiguous 16-byte stores staged through shared memory, where a thread a
// voxel wrote 45 floats at a 180-byte stride. Nothing is indexed at run
// time in per-thread arrays, so nothing goes to local memory (the old
// per-thread edge arrays took 368 bytes of it).
//
// Numerics: built with -fmad=false and without fast math (ops/cuda/build.py)
// and every operation in the twin's order (mc_fused_torch in
// bsdmg_tpu_torch/ops/cuda/mc_kernel.py), so the outputs equal the twin's
// bit for bit. A slot whose edge is not among its voxel's projected edges
// (the case table never makes one) reads zeros, as the twin's does.

#include "project.cuh"

// MC_EDGE_MIDPOINTS of ops/tables.py, in voxel units
// (tests/test_torch_mc_kernel.py holds the two equal)
__constant__ float kEdgeMid[12][3] = {
    {0.5f, 0.0f, 0.0f}, {1.0f, 0.5f, 0.0f}, {0.5f, 1.0f, 0.0f}, {0.0f, 0.5f, 0.0f},
    {0.5f, 0.0f, 1.0f}, {1.0f, 0.5f, 1.0f}, {0.5f, 1.0f, 1.0f}, {0.0f, 0.5f, 1.0f},
    {0.0f, 0.0f, 0.5f}, {1.0f, 0.0f, 0.5f}, {1.0f, 1.0f, 0.5f}, {0.0f, 1.0f, 0.5f},
};

// A block of kThreads owns kVoxels voxels, whose per-voxel state the first
// kSlots / 32 warps hold, one voxel a lane (the last slots empty). A voxel
// of the mesh path has 4 crossing edges (4.0004 on average at level 3,
// PERF.md): 60 voxels list ~240 edges, one round of 256 threads with 94% of
// the lanes busy. 32 voxels a block of 128 made 30% of the blocks take a
// second round for 1-5 edges; 28 voxels (one round, 88% busy) were faster
// at level 3 but slower at level 5 (PERF.md). 60 x 45 floats keep each
// block's outputs 16-byte aligned.
constexpr int kSlots = 64;
constexpr int kVoxels = 60;
constexpr int kThreads = 256;
constexpr int kEdges = kSlots * 12;  // the most projected edges a block lists
static_assert(kSlots % 32 == 0 && kVoxels <= kSlots && kSlots <= kThreads, "block shape");

// count 4-byte values from shared `src` to global `dst`, 16 bytes a store
// where dst is 16-byte aligned (src always is)
template <class T>
__device__ __forceinline__ void store_block(T* __restrict__ dst, const T* src, int count) {
  static_assert(sizeof(T) == 4, "4-byte values");
  int done = 0;
  if ((reinterpret_cast<unsigned long long>(dst) & 15u) == 0) {
    done = count & ~3;
    for (int k = threadIdx.x; 4 * k < done; k += kThreads)
      reinterpret_cast<float4*>(dst)[k] = reinterpret_cast<const float4*>(src)[k];
  }
  for (int k = done + threadIdx.x; k < count; k += kThreads) dst[k] = src[k];
}

// K6's fd4 stencils of a composed scene roll around single walks of the
// program (project.cuh fd4_grad<S, true>): its four-point walk took K6 to
// 100 registers and the lattice's K6 22% slower (PERF.md)
template <class S>
constexpr bool kSingleWalks = std::is_same<S, Composed>::value;

// The launch bound's minimum of one block an SM is the register hint that
// keeps ptxas from spilling: without it ptxas gave the reference structure
// Box<false, false> 64 registers and 12 B of spill stores (Box<true, true>
// in an earlier tree), with it 71 and none. The spilling build ran level 5
// 8% faster (PERF.md); the reference structures may not spill.
template <class S>
__global__ void __launch_bounds__(kThreads, 1)
mc_kernel(const SceneDesc s, const float* __restrict__ lx, const float* __restrict__ ly,
          const float* __restrict__ lz, const int* __restrict__ cross_bits,
          const int* __restrict__ t0, const int* __restrict__ t1, float vs, int n, int budget,
          int iters, float tol, float eps, int use_grad, int centroid_winding,
          float* __restrict__ pos, float* __restrict__ nrm, float* __restrict__ dot_out,
          int* __restrict__ amb_out, int* __restrict__ meta_out) {
  __shared__ float low[3][kSlots];
  __shared__ unsigned vbits[kSlots], vlo[kSlots], vhi[kSlots];
  __shared__ int first[kSlots], listed[kSlots], scan[kSlots];
  __shared__ __align__(16) int meta[kSlots];
  __shared__ float mid[12][3];
  __shared__ unsigned short list[kEdges];  // voxel << 4 | edge, in slot order
  __shared__ float proj[6][kEdges];       // projected x, y, z and unit normal per slot
  __shared__ __align__(16) float out_pos[kVoxels * 45], out_nrm[kVoxels * 45];
  __shared__ __align__(16) float out_dot[kVoxels * 5];
  __shared__ __align__(16) int out_amb[kVoxels * 5];
  stage_scene<S>(s, false);  // the barriers below order it

  const int tid = threadIdx.x;
  const int v0 = blockIdx.x * kVoxels;
  const int nv = min(kVoxels, n - v0);

  // the voxels, and the scan of their listed edges, warp by warp
  if (tid < 36) mid[tid / 3][tid % 3] = kEdgeMid[tid / 3][tid % 3];
  if (tid < kSlots) {
    unsigned bits = 0u;
    if (tid < nv) {
      const int i = v0 + tid;
      low[0][tid] = lx[i];
      low[1][tid] = ly[i];
      low[2][tid] = lz[i];
      bits = static_cast<unsigned>(cross_bits[i]) & 0xfffu;
      vlo[tid] = static_cast<unsigned>(t0[i]);
      vhi[tid] = static_cast<unsigned>(t1[i]);
    }
    const int run = __popc(bits);
    const int cnt = min(run, budget);
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if ((tid & 31) >= d) incl += y;
    }
    vbits[tid] = bits;
    listed[tid] = cnt;
    scan[tid] = incl;
    meta[tid] = (run > budget ? run - budget : 0) << 5;
  }
  __syncthreads();
  if (tid < kSlots) {
    int before = scan[tid] - listed[tid];
    for (int w = 0; w < tid / 32; ++w) before += scan[32 * w + 31];
    first[tid] = before;
  }
  int edges = 0;
#pragma unroll
  for (int w = 0; w < kSlots / 32; ++w) edges += scan[32 * w + 31];
  __syncthreads();

  // the list: each crossing edge of rank < budget at its voxel's first slot
  // plus its rank
  for (int k = tid; k < kEdges; k += kThreads) {
    const int v = k % kSlots, e = k / kSlots;
    const unsigned bits = vbits[v];
    if ((bits >> e) & 1u) {
      const int rank = __popc(bits & ((1u << e) - 1u));
      if (rank < budget) list[first[v] + rank] = static_cast<unsigned short>(v << 4 | e);
    }
  }
  __syncthreads();

  // project the listed edges, one a thread in turn
  for (int j = tid; j < edges; j += kThreads) {
    const int v = list[j] >> 4, e = list[j] & 15;
    float x = low[0][v] + vs * mid[e][0];
    float y = low[1][v] + vs * mid[e][1];
    float z = low[2][v] + vs * mid[e][2];
    newton_project<S, kSingleWalks<S>>(s, x, y, z, iters, tol, eps, use_grad);
    float qx, qy, qz;
    unit_normal_fd4<S, kSingleWalks<S>>(s, x, y, z, eps, qx, qy, qz);
    proj[0][j] = x;
    proj[1][j] = y;
    proj[2][j] = z;
    proj[3][j] = qx;
    proj[4][j] = qy;
    proj[5][j] = qz;
  }
  __syncthreads();

  // the 5 triangles of each voxel, one triangle index t a warp
  for (int k = tid; k < kSlots * 5; k += kThreads) {
    const int v = k % kSlots, t = k / kSlots;
    if (v >= nv) continue;
    const unsigned bits = vbits[v], lo = vlo[v], hi = vhi[v];
    float vx[3][3], nn[3][3];
    bool tri_ok = true;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int slot = 3 * t + c;
      const unsigned nib = (slot < 8 ? lo >> (4 * slot) : hi >> (4 * (slot - 8))) & 15u;
      const int rank = nib < 12u ? __popc(bits & ((1u << nib) - 1u)) : budget;
      const bool ok = rank < budget;
      const bool have = rank < listed[v];
      const int j = first[v] + (have ? rank : 0);
      tri_ok = tri_ok && ok;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        vx[c][a] = have ? proj[a][j] : 0.0f;
        nn[c][a] = have ? proj[3 + a][j] : 0.0f;
      }
    }
    float dot = 0.0f;
    bool amb = false;
    bool flip = false;
    if (tri_ok) {
      atomicOr(&meta[v], 1 << t);
      const float e1x = vx[1][0] - vx[0][0], e1y = vx[1][1] - vx[0][1], e1z = vx[1][2] - vx[0][2];
      const float e2x = vx[2][0] - vx[0][0], e2y = vx[2][1] - vx[0][1], e2z = vx[2][2] - vx[0][2];
      const float gx = e1y * e2z - e1z * e2y;
      const float gy = e1z * e2x - e1x * e2z;
      const float gz = e1x * e2y - e1y * e2x;
      float ax, ay, az;
      if (centroid_winding) {
        fd4_grad<S, kSingleWalks<S>>(s, ((vx[0][0] + vx[1][0]) + vx[2][0]) / 3.0f,
                    ((vx[0][1] + vx[1][1]) + vx[2][1]) / 3.0f,
                    ((vx[0][2] + vx[1][2]) + vx[2][2]) / 3.0f, eps, ax, ay, az);
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
    // the swap picks between two vertices named at compile time, so the
    // arrays stay in registers
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float p = flip ? vx[2 - c][a] : vx[c][a];
        const float q = flip ? nn[2 - c][a] : nn[c][a];
        out_pos[45 * v + 9 * t + 3 * c + a] = tri_ok ? p : 0.0f;
        out_nrm[45 * v + 9 * t + 3 * c + a] = tri_ok ? q : 0.0f;
      }
    }
    out_dot[5 * v + t] = dot;
    out_amb[5 * v + t] = amb ? 1 : 0;
  }
  __syncthreads();

  // the block's outputs, contiguous
  const long long base = static_cast<long long>(v0);
  store_block(pos + 45 * base, out_pos, 45 * nv);
  store_block(nrm + 45 * base, out_nrm, 45 * nv);
  store_block(dot_out + 5 * base, out_dot, 5 * nv);
  store_block(amb_out + 5 * base, out_amb, 5 * nv);
  store_block(meta_out + base, meta, nv);
}

extern "C" {

// Launches K6 on `stream` over n voxels. lx, ly, lz (n,) float32 and
// cross_bits, t0, t1 (n,) int32 in; pos and nrm (n, 45) float32, dot (n, 5)
// float32, amb (n, 5) int32 and meta (n,) int32 out, all on the device.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a
// descriptor structure that names none, a large-tier program whose
// scratch does not hold the launch, or a small-tier one beyond the caps of
// its walks: composed.cuh walk_fits).
int bsdmg_mc_fused(const SceneDesc* desc, const float* lx, const float* ly, const float* lz,
                   const int* cross_bits, const int* t0, const int* t1, float voxel_size, int n,
                   int budget, int iters, float tol, float eps, int use_grad,
                   int centroid_winding, float* pos, float* nrm, float* dot, int* amb,
                   int* meta, void* stream) {
  const dim3 block(kThreads);
  const dim3 grid((n + kVoxels - 1) / kVoxels);
  if (!scratch_fits(*desc, (long long)grid.x * kThreads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = cudaErrorInvalidValue;
  with_mesh_structure(desc->structure, [&](auto scene) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long smem = scene_smem<decltype(scene)>(*desc, true);
    if (smem < 0) return;
    if (smem > 0) {
      // the walk beside the kernel's 46 KB of static shared memory may pass
      // the 48 KB a launch takes without asking
      err = cudaFuncSetAttribute(mc_kernel<decltype(scene)>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return;
    }
    mc_kernel<decltype(scene)><<<grid, block, smem, st>>>(
        *desc, lx, ly, lz, cross_bits, t0, t1, voxel_size, n, budget, iters, tol, eps, use_grad,
        centroid_winding, pos, nrm, dot, amb, meta);
    err = cudaGetLastError();
  });
  return err;
}

}  // extern "C"
