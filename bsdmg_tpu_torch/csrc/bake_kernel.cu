// The mesh-asset bake: the exact signed distance of a triangle mesh at every
// node of a lattice, a brick of nodes a block.
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
// What bounds it on Hopper: FP32 operations. Every node meets every
// triangle in the winding number (about 85 operations a pair with its
// atan2, 25.8 G pairs at 128^3 over the 12,288-triangle torus, 206 G at
// 256^3); the distance (121 a pair, five IEEE divisions) only needs the
// triangles near a node. Memory traffic is the output, 4 B a node.
//
// What the design does about it:
// - A block owns a brick of kBrickI x kBrickJ x kBrickK nodes (i, j, k the
//   x, y and z indices; out stays (r, r, r) in C order, a warp's 8 k-nodes
//   of 4 rows), so its nodes are close together and share one box.
// - The wrapper (ops/cuda/bake_kernel.py bake_order) sorts the triangles by
//   the Morton code of their centroids on the lattice's box and groups them
//   in clusters of kCluster consecutive ones, each with its box (the least
//   and greatest vertex coordinates). The kernel walks the triangles in
//   that order, in tiles of kThreads (kThreads / kCluster clusters): each
//   thread loads one triangle of the tile and computes its terms that do
//   not depend on the node once, into shared memory, where every thread of
//   the block reads the same triangle at the same time (a broadcast).
// - The winding number sums every triangle of every tile.
// - The distance is culled, exactly: a cluster's triangles are evaluated
//   only where the cluster's bound, a lower bound of every squared
//   distance the float evaluation can give between a node of the brick and
//   a triangle of the cluster (cluster_bound), is not above the brick's
//   worst best, the greatest over its nodes of the least squared distance
//   found so far. A skipped triangle's squared distance is at least the
//   bound, above every node's best, so it cannot be any node's minimum,
//   and the minimum is the twin's bit for bit. The worst best is seeded
//   before the walk by the cluster of least bound, whose triangles the walk
//   then does not evaluate again, and updated after each tile (a
//   block-wide max). The decision is the block's: no divergence.
//
// The bound (cluster_bound). Per axis, the gap g between the brick's box
// [bmin, bmax] and the cluster's [cmin, cmax] is max(cmin - bmax, bmin -
// cmax, 0), in float; the bound is (1 - 2^-20) ((g'x^2 + g'y^2) + g'z^2) with
// g' = max(g - eta, 0), eta = 2^-17 S, S the greatest magnitude of a vertex
// coordinate and of a node coordinate (the wrapper's margin, computed on the
// device and read from device memory). Why it never
// exceeds a float squared distance F (u = 2^-24): every candidate the
// distance evaluates is fl(|q - p|^2) with q = (a + s ab) + t ac (or a + s e
// on an edge) for clamped s, t in [0, 1], t <= fl(1 - s). The exact point Q =
// a + s (b - a) + t (c - a) lies in the triangle but for the rounding of 1 -
// s, at most u |ac| <= 2 u S outside it, so along each axis it is at least
// the exact gap G less 2 u S from p; q differs from Q by the rounding of ab,
// ac, the two products and the two sums, at most about 15 u S an axis; the
// float gap g is at most G (1 + u) <= G + 2 u S; and fl(g - eta) rounds up by
// at most 2 u S. So g' <= |q_a - p_a| with eta = 128 u S >= 25 u S. The
// difference, its square and the two sums of F each round by a factor in
// [1 - u, 1 + u] on non-negative terms: F >= (1 - u)^5 sum (q_a - p_a)^2 >=
// (1 - u)^5 sum g'^2, and the bound's own squares, sums and scaling round up
// by at most (1 + u)^4, while (1 + u)^4 (1 - 2^-20) < (1 - u)^5. The
// candidates' minimum and the distance's square root then never see a
// skipped triangle. eta is about 1e-5 S, so the cull keeps few pairs more
// than an exact bound would (tests/test_torch_bake_cull.py holds a plain
// version of the decision, bake_kernel.py bake_cull_torch, and the margin).
//
// Numerics: built with -fmad=false and without fast math (ops/cuda/build.py),
// every operation in the twin's order, so each pair's squared distances are
// the twin's bit for bit and so is the least of them, in any order: the
// distance equals the twin's at every node. The angles are summed in the
// clusters' order, torch.sum in its own, so the winding number differs in
// the last bits, and a node's sign may differ from the twin's only where
// the winding number lies within rounding of 1/2.

#include <cuda_runtime.h>
#include <math_constants.h>

constexpr int kThreads = 128;  // nodes a block; triangles a tile
constexpr int kBrickI = 4, kBrickJ = 4, kBrickK = 8;
constexpr int kCluster = 32;  // triangles a cluster (bake_kernel.py CLUSTER)
constexpr int kTileClusters = kThreads / kCluster;
static_assert(kBrickI * kBrickJ * kBrickK == kThreads, "a brick is a block's nodes");

// the bound's factor 1 - 2^-20, exact in float
#define BSDMG_BAKE_SHRINK (1.0f - 1.0f / 1048576.0f)

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

// the least squared distance from p to triangle q of the tile
__device__ __forceinline__ float distance_sq(const float (*tri)[kThreads], int q, float px,
                                             float py, float pz) {
  const float apx = px - tri[AX][q], apy = py - tri[AY][q], apz = pz - tri[AZ][q];
  const float d1 = (tri[ABX][q] * apx + tri[ABY][q] * apy) + tri[ABZ][q] * apz;
  const float d2 = (tri[ACX][q] * apx + tri[ACY][q] * apy) + tri[ACZ][q] * apz;
  const float a00 = tri[A00][q], a01 = tri[A01][q], a11 = tri[A11][q];
  const float det = tri[DET][q];
  const float s = (a11 * d1 - a01 * d2) / det;
  const float t = (a00 * d2 - a01 * d1) / det;
  const float d_int = clamped_eval(tri, q, px, py, pz, s, t);
  const float d_ab = edge_eval(tri[AX][q], tri[AY][q], tri[AZ][q], tri[ABX][q], tri[ABY][q],
                               tri[ABZ][q], px, py, pz, clamp01(d1 / tri[A00C][q]));
  const float d_ac = edge_eval(tri[AX][q], tri[AY][q], tri[AZ][q], tri[ACX][q], tri[ACY][q],
                               tri[ACZ][q], px, py, pz, clamp01(d2 / tri[A11C][q]));
  const float bpx = apx - tri[ABX][q], bpy = apy - tri[ABY][q], bpz = apz - tri[ABZ][q];
  const float u =
      clamp01(((tri[BCX][q] * bpx + tri[BCY][q] * bpy) + tri[BCZ][q] * bpz) / tri[BCC][q]);
  const float d_bc = clamped_eval(tri, q, px, py, pz, 1.0f - u, u);
  return fminf(fminf(d_int, d_ab), fminf(d_ac, d_bc));
}

// the solid angle of triangle q of the tile seen from p, doubled as the
// twin's 2 atan2; a - p is -(p - a) bit for bit
__device__ __forceinline__ float solid_angle(const float (*tri)[kThreads], int q, float px,
                                             float py, float pz) {
  const float ax = -(px - tri[AX][q]), ay = -(py - tri[AY][q]), az = -(pz - tri[AZ][q]);
  const float bx = tri[BX][q] - px, by = tri[BY][q] - py, bz = tri[BZ][q] - pz;
  const float cx = tri[CX][q] - px, cy = tri[CY][q] - py, cz = tri[CZ][q] - pz;
  const float la = sqrtf((ax * ax + ay * ay) + az * az);
  const float lb = sqrtf((bx * bx + by * by) + bz * bz);
  const float lc = sqrtf((cx * cx + cy * cy) + cz * cz);
  const float det3 =
      (ax * (by * cz - bz * cy) + ay * (bz * cx - bx * cz)) + az * (bx * cy - by * cx);
  const float denom = (((la * lb) * lc + ((ax * bx + ay * by) + az * bz) * lc) +
                       ((bx * cx + by * cy) + bz * cz) * la) +
                      ((cx * ax + cy * ay) + cz * az) * lb;
  return 2.0f * atan2f(det3, denom);
}

// triangle t's terms into the tile's column j
__device__ __forceinline__ void load_triangle(float (*tri)[kThreads], int j, const float* va,
                                              const float* vb, const float* vc, int t) {
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
  for (int m = 0; m < kTerms; ++m) tri[m][j] = terms[m];
}

// the cluster's bound against the brick's box (the comment at the top):
// box (6 floats) the cluster's least and greatest coordinates
__device__ __forceinline__ float cluster_bound(const float* __restrict__ box, const float bmin[3],
                                               const float bmax[3], float eta) {
  float g[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float gap = fmaxf(fmaxf(box[a] - bmax[a], bmin[a] - box[3 + a]), 0.0f);
    g[a] = fmaxf(gap - eta, 0.0f);
  }
  return ((g[0] * g[0] + g[1] * g[1]) + g[2] * g[2]) * BSDMG_BAKE_SHRINK;
}

// the block's max of v (every thread calls it; the result in every thread)
__device__ __forceinline__ float block_max(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();  // the scratch's last readers are done
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  return fmaxf(fmaxf(scratch[0], scratch[1]), fmaxf(scratch[2], scratch[3]));
}

__global__ void __launch_bounds__(kThreads)
bake_kernel(const float* __restrict__ lx, const float* __restrict__ ly,
            const float* __restrict__ lz, int r, const float* __restrict__ va,
            const float* __restrict__ vb, const float* __restrict__ vc, int triangles,
            const float* __restrict__ boxes, const float* __restrict__ margin,
            float* __restrict__ out, int* __restrict__ pairs) {
  __shared__ float tri[kTerms][kThreads];
  __shared__ float reduce[4];
  __shared__ int seed_cluster[4];
  __shared__ float seed_bound[4];
  __shared__ bool need[kTileClusters];
  const int tid = threadIdx.x;
  const int i0 = blockIdx.z * kBrickI, j0 = blockIdx.y * kBrickJ, k0 = blockIdx.x * kBrickK;
  const int i = i0 + tid / (kBrickJ * kBrickK), j = j0 + (tid / kBrickK) % kBrickJ,
            k = k0 + tid % kBrickK;
  const bool live = i < r && j < r && k < r;
  const float px = lx[min(i, r - 1)], py = ly[min(j, r - 1)], pz = lz[min(k, r - 1)];
  // the brick's box over its nodes
  const int ni = min(kBrickI, r - i0), nj = min(kBrickJ, r - j0), nk = min(kBrickK, r - k0);
  float bmin[3] = {lx[i0], ly[j0], lz[k0]}, bmax[3] = {lx[i0], ly[j0], lz[k0]};
  for (int m = 1; m < ni; ++m) bmin[0] = fminf(bmin[0], lx[i0 + m]), bmax[0] = fmaxf(bmax[0], lx[i0 + m]);
  for (int m = 1; m < nj; ++m) bmin[1] = fminf(bmin[1], ly[j0 + m]), bmax[1] = fmaxf(bmax[1], ly[j0 + m]);
  for (int m = 1; m < nk; ++m) bmin[2] = fminf(bmin[2], lz[k0 + m]), bmax[2] = fmaxf(bmax[2], lz[k0 + m]);
  const int clusters = (triangles + kCluster - 1) / kCluster;
  const float eta = *margin;

  // the seed: the cluster of least bound (the least index at a tie)
  float least = CUDART_INF_F;
  int pick = 0;
  for (int c = tid; c < clusters; c += kThreads) {
    const float b = cluster_bound(boxes + 6 * c, bmin, bmax, eta);
    if (b < least) least = b, pick = c;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, least, off);
    const int oc = __shfl_xor_sync(0xffffffffu, pick, off);
    if (ob < least || (ob == least && oc < pick)) least = ob, pick = oc;
  }
  if ((tid & 31) == 0) seed_bound[tid >> 5] = least, seed_cluster[tid >> 5] = pick;
  __syncthreads();
  least = seed_bound[0];
  pick = seed_cluster[0];
#pragma unroll
  for (int w = 1; w < 4; ++w) {
    if (seed_bound[w] < least || (seed_bound[w] == least && seed_cluster[w] < pick)) {
      least = seed_bound[w], pick = seed_cluster[w];
    }
  }
  const int seed_first = pick * kCluster, seed_count = min(kCluster, triangles - seed_first);
  if (tid < seed_count) load_triangle(tri, tid, va, vb, vc, seed_first + tid);
  __syncthreads();
  float best = CUDART_INF_F;
  for (int q = 0; q < seed_count; ++q) best = fminf(best, distance_sq(tri, q, px, py, pz));
  float worst = block_max(live ? best : -CUDART_INF_F, reduce);
  long long evaluated = seed_count;

  float angles = 0.0f;
  for (int base = 0; base < triangles; base += kThreads) {
    const int count = min(kThreads, triangles - base);
    __syncthreads();  // the last tile is read
    if (tid < count) load_triangle(tri, tid, va, vb, vc, base + tid);
    if (tid < kTileClusters) {
      const int c = base / kCluster + tid;
      // the seed's distances are in every node's best already
      need[tid] = c < clusters && c != pick &&
                  cluster_bound(boxes + 6 * c, bmin, bmax, eta) <= worst;
    }
    __syncthreads();
#pragma unroll 1
    for (int g = 0; g * kCluster < count; ++g) {
      const int last = min(count, (g + 1) * kCluster);
      if (need[g]) {
        evaluated += last - g * kCluster;
#pragma unroll 1
        for (int q = g * kCluster; q < last; ++q) {
          best = fminf(best, distance_sq(tri, q, px, py, pz));
          angles = angles + solid_angle(tri, q, px, py, pz);
        }
      } else {
#pragma unroll 1
        for (int q = g * kCluster; q < last; ++q) angles = angles + solid_angle(tri, q, px, py, pz);
      }
    }
    worst = block_max(live ? best : -CUDART_INF_F, reduce);
  }
  if (live) {
    const float dist = sqrtf(best);
    // sum / (4 pi) as torch divides by a Python scalar on the card: a
    // multiplication by the float32 reciprocal of float32(4 pi)
    const float wn = angles * (1.0f / 12.566370614359172f);
    out[((long long)i * r + j) * r + k] = wn > 0.5f ? -dist : dist;
  }
  if (pairs != nullptr && tid == 0) {
    const long long block = ((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    pairs[block] = static_cast<int>(evaluated * (ni * nj * nk));
  }
}

extern "C" {

// Launches the bake on `stream`: lx, ly, lz (r,) float32, the lattice's
// axes; va, vb, vc (triangles, 3) float32, each triangle's vertices in the
// clusters' order; boxes (ceil(triangles / 32), 6) float32, each cluster's
// least and greatest coordinates; margin, one float32, the bound's eta; out (r, r, r)
// float32, C order; pairs, null or an int a brick (ceil(r / 4), ceil(r / 4),
// ceil(r / 8), C order): the distance pairs it evaluated. All on the
// device. Returns the cudaError_t of the launch.
int bsdmg_bake(const float* lx, const float* ly, const float* lz, int r, const float* va,
               const float* vb, const float* vc, int triangles, const float* boxes,
               const float* margin, float* out, int* pairs, void* stream) {
  const dim3 grid((r + kBrickK - 1) / kBrickK, (r + kBrickJ - 1) / kBrickJ,
                  (r + kBrickI - 1) / kBrickI);
  bake_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lx, ly, lz, r, va, vb, vc, triangles, boxes, margin, out, pairs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
