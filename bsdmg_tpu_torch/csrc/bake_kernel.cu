// The mesh-asset bake: the exact signed distance of a triangle mesh at every
// node of a lattice, one thread per node.
//
// Replaces no TPU kernel. The JAX package bakes in XLA
// (bsdmg_tpu/models/mesh_sdf.py::mesh_signed_distance, :108, a lax.map over
// chunks of points); the port's plain version is
// bsdmg_tpu_torch/models/mesh_sdf.py::mesh_signed_distance, which builds
// (points, triangles) planes in chunks and took 20 s of the 20 s from an
// OBJ to its first frame at 128^3 on an H100 (PERF.md). Every mesh-asset
// command bakes, so this kernel computes the same function:
//
// 1. per pair (node p, triangle a, b, c): Eberly's point-triangle distance
//    as the twin takes it (_point_triangle_dist_sq): the unconstrained
//    barycentric minimiser clamped into the triangle, and the three edges'
//    projections, the least of the four squared distances;
// 2. per pair, the triangle's solid angle seen from p (van Oosterom and
//    Strackee, _winding_number): 2 atan2(a . (b x c), |a||b||c| + (a . b)|c|
//    + (b . c)|a| + (c . a)|b|) with a, b, c the vertices less p;
// 3. per node: the distance is the square root of the least squared
//    distance, negative where the winding number (the angles' sum over 4 pi)
//    exceeds 1/2.
//
// What bounds it on Hopper: FP32 operations, 213 a pair (five IEEE
// divisions, three square roots and an atan2 among them;
// utils/profiling.py bake_ops counts the twin's), and every node meets
// every triangle: 25.8 G pairs at 128^3 over the 12,288-triangle torus, 206 G
// at 256^3. Memory traffic is the output, 4 B a node.
//
// What the design does about it: a block of kThreads threads owns kThreads
// consecutive nodes (C order, so a block spans a few rows of the lattice)
// and walks the triangles in tiles of kThreads: each thread loads one
// triangle of the tile and computes its terms that do not depend on the
// node (the edges ab, ac and bc; ab.ab, ab.ac, ac.ac; the clamped
// determinant and denominators) once, into shared memory, where every
// thread of the block reads the same triangle at the same time (a
// broadcast). The nodes' coordinates are read from the three axes of the
// lattice (models/mesh_sdf.py::_linspace), not recomputed.
//
// Numerics: built with -fmad=false and without fast math (ops/cuda/build.py),
// every operation in the twin's order, so each pair's squared distances are
// the twin's bit for bit and so is the least of them, in any order: the
// distance equals the twin's at every node. The angles are summed in
// triangle order, torch.sum in its own, so the winding number differs in
// the last bits, and a node's sign may differ from the twin's only where
// the winding number lies within rounding of 1/2.

#include <cuda_runtime.h>
#include <math_constants.h>

constexpr int kThreads = 128;  // nodes a block; triangles a tile

// a triangle's terms in shared memory, one array a term, kThreads deep
enum Term {
  AX, AY, AZ, BX, BY, BZ, CX, CY, CZ,  // the vertices
  ABX, ABY, ABZ, ACX, ACY, ACZ,        // b - a, c - a
  BCX, BCY, BCZ,                       // ac - ab
  A00, A01, A11,                       // ab.ab, ab.ac, ac.ac
  DET,                                 // max(a00 a11 - a01^2, 1e-20)
  A00C, A11C, BCC,                     // max(a00, 1e-20), max(a11, 1e-20), max(bc.bc, 1e-20)
  kTerms
};

__device__ __forceinline__ float clamp01(float v) { return fminf(fmaxf(v, 0.0f), 1.0f); }

// the twin's clamped_eval: (s, t) into the triangle, |a + s ab + t ac - p|^2
__device__ __forceinline__ float clamped_eval(const float (*tri)[kThreads], int j, float px,
                                              float py, float pz, float s, float t) {
  s = clamp01(s);
  t = fminf(fmaxf(t, 0.0f), 1.0f - s);
  const float qx = ((tri[AX][j] + s * tri[ABX][j]) + t * tri[ACX][j]) - px;
  const float qy = ((tri[AY][j] + s * tri[ABY][j]) + t * tri[ACY][j]) - py;
  const float qz = ((tri[AZ][j] + s * tri[ABZ][j]) + t * tri[ACZ][j]) - pz;
  return (qx * qx + qy * qy) + qz * qz;
}

// an edge's candidate, a + s e - p with s in [0, 1]: clamped_eval at t = 0
// (edge ab, e = ab) or s = 0 (edge ac, e = ac), where the term the other
// coordinate multiplies is a signed zero, which adds nothing to a sum the
// square then takes
__device__ __forceinline__ float edge_eval(float ax, float ay, float az, float ex, float ey,
                                           float ez, float px, float py, float pz, float s) {
  const float qx = (ax + s * ex) - px;
  const float qy = (ay + s * ey) - py;
  const float qz = (az + s * ez) - pz;
  return (qx * qx + qy * qy) + qz * qz;
}

__global__ void __launch_bounds__(kThreads)
bake_kernel(const float* __restrict__ lx, const float* __restrict__ ly,
            const float* __restrict__ lz, int r, const float* __restrict__ va,
            const float* __restrict__ vb, const float* __restrict__ vc, int triangles,
            float* __restrict__ out) {
  __shared__ float tri[kTerms][kThreads];
  const int tid = threadIdx.x;
  const long long node = static_cast<long long>(blockIdx.x) * kThreads + tid;
  const long long nodes = static_cast<long long>(r) * r * r;
  const bool live = node < nodes;
  const int k = live ? static_cast<int>(node % r) : 0;
  const int j = live ? static_cast<int>((node / r) % r) : 0;
  const int i = live ? static_cast<int>(node / (static_cast<long long>(r) * r)) : 0;
  const float px = lx[i], py = ly[j], pz = lz[k];

  float best = CUDART_INF_F;
  float angles = 0.0f;
  for (int base = 0; base < triangles; base += kThreads) {
    const int count = min(kThreads, triangles - base);
    if (tid < count) {
      const int t = base + tid;
      const float ax = va[3 * t], ay = va[3 * t + 1], az = va[3 * t + 2];
      const float bx = vb[3 * t], by = vb[3 * t + 1], bz = vb[3 * t + 2];
      const float cx = vc[3 * t], cy = vc[3 * t + 1], cz = vc[3 * t + 2];
      const float abx = bx - ax, aby = by - ay, abz = bz - az;
      const float acx = cx - ax, acy = cy - ay, acz = cz - az;
      const float bcx = acx - abx, bcy = acy - aby, bcz = acz - abz;
      const float a00 = (abx * abx + aby * aby) + abz * abz;
      const float a01 = (abx * acx + aby * acy) + abz * acz;
      const float a11 = (acx * acx + acy * acy) + acz * acz;
      const float bcc = (bcx * bcx + bcy * bcy) + bcz * bcz;
      const float terms[kTerms] = {ax,  ay,  az,  bx,  by,  bz,  cx,  cy,  cz,
                                   abx, aby, abz, acx, acy, acz, bcx, bcy, bcz,
                                   a00, a01, a11, fmaxf(a00 * a11 - a01 * a01, 1e-20f),
                                   fmaxf(a00, 1e-20f), fmaxf(a11, 1e-20f), fmaxf(bcc, 1e-20f)};
#pragma unroll
      for (int m = 0; m < kTerms; ++m) tri[m][tid] = terms[m];
    }
    __syncthreads();
    if (live) {
#pragma unroll 1
      for (int q = 0; q < count; ++q) {
        // the distance
        const float apx = px - tri[AX][q], apy = py - tri[AY][q], apz = pz - tri[AZ][q];
        const float d1 = (tri[ABX][q] * apx + tri[ABY][q] * apy) + tri[ABZ][q] * apz;
        const float d2 = (tri[ACX][q] * apx + tri[ACY][q] * apy) + tri[ACZ][q] * apz;
        const float a00 = tri[A00][q], a01 = tri[A01][q], a11 = tri[A11][q];
        const float det = tri[DET][q];
        const float s = (a11 * d1 - a01 * d2) / det;
        const float t = (a00 * d2 - a01 * d1) / det;
        const float d_int = clamped_eval(tri, q, px, py, pz, s, t);
        const float d_ab = edge_eval(tri[AX][q], tri[AY][q], tri[AZ][q], tri[ABX][q],
                                     tri[ABY][q], tri[ABZ][q], px, py, pz,
                                     clamp01(d1 / tri[A00C][q]));
        const float d_ac = edge_eval(tri[AX][q], tri[AY][q], tri[AZ][q], tri[ACX][q],
                                     tri[ACY][q], tri[ACZ][q], px, py, pz,
                                     clamp01(d2 / tri[A11C][q]));
        const float bpx = apx - tri[ABX][q], bpy = apy - tri[ABY][q], bpz = apz - tri[ABZ][q];
        const float u = clamp01(((tri[BCX][q] * bpx + tri[BCY][q] * bpy) + tri[BCZ][q] * bpz) /
                                tri[BCC][q]);
        const float d_bc = clamped_eval(tri, q, px, py, pz, 1.0f - u, u);
        best = fminf(best, fminf(fminf(d_int, d_ab), fminf(d_ac, d_bc)));

        // the solid angle; a - p is -(p - a) bit for bit
        const float ax = -apx, ay = -apy, az = -apz;
        const float bx = tri[BX][q] - px, by = tri[BY][q] - py, bz = tri[BZ][q] - pz;
        const float cx = tri[CX][q] - px, cy = tri[CY][q] - py, cz = tri[CZ][q] - pz;
        const float la = sqrtf((ax * ax + ay * ay) + az * az);
        const float lb = sqrtf((bx * bx + by * by) + bz * bz);
        const float lc = sqrtf((cx * cx + cy * cy) + cz * cz);
        const float det3 = (ax * (by * cz - bz * cy) + ay * (bz * cx - bx * cz)) +
                           az * (bx * cy - by * cx);
        const float denom = (((la * lb) * lc + ((ax * bx + ay * by) + az * bz) * lc) +
                             ((bx * cx + by * cy) + bz * cz) * la) +
                            ((cx * ax + cy * ay) + cz * az) * lb;
        angles = angles + 2.0f * atan2f(det3, denom);
      }
    }
    __syncthreads();
  }
  if (live) {
    const float dist = sqrtf(best);
    // sum / (4 pi) as torch divides by a Python scalar on the card: a
    // multiplication by the float32 reciprocal of float32(4 pi)
    const float wn = angles * (1.0f / 12.566370614359172f);
    out[node] = wn > 0.5f ? -dist : dist;
  }
}

extern "C" {

// Launches the bake on `stream`: lx, ly, lz (r,) float32, the lattice's
// axes; va, vb, vc (triangles, 3) float32, each triangle's vertices; out
// (r, r, r) float32, C order, all on the device. Returns the cudaError_t of
// the launch.
int bsdmg_bake(const float* lx, const float* ly, const float* lz, int r, const float* va,
               const float* vb, const float* vc, int triangles, float* out, void* stream) {
  const long long nodes = static_cast<long long>(r) * r * r;
  const dim3 grid(static_cast<unsigned>((nodes + kThreads - 1) / kThreads));
  bake_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(lx, ly, lz, r, va, vb, vc,
                                                                       triangles, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
