// K7: Newton projection of edge points onto the isosurface, one thread per
// point.
//
// Replaces the TPU kernel bsdmg_tpu/ops/pallas/mesh_kernel.py::_project_kernel
// (the pallas_call at mesh_kernel.py:162 of project_edges_pallas), which the
// JAX package's staged marching-cubes path runs (ops/marching_cubes.py:428,
// `mesh --interpolate-edges`). Per point: at most `iters` Newton steps with
// the analytic gradient (use_grad) or the fd4 one, a point stopping after
// the step at which |sd| <= tol (inactive points do not move), then the fd4
// unit normal at the final point, for every point as in the JAX kernel.
// Built for every structure of with_mesh_structure (scene_sdf.cuh), a mesh
// asset's grid (GridScene) among them, as K6 is.
//
// What bounds it on Hopper: FP32 work, the same per point as one edge of K6
// (project.cuh): a few Newton steps and the fd4 normal; memory traffic is
// 16 B read and 24 B written per point.
// What the design does about it: the staged mesh path
// (ops/marching_cubes.py::_finish_staged) hands the kernel the listed
// crossing edges only, voxel by voxel in rank order, every point active,
// where the JAX layout padded each voxel to `budget` lanes, a third of them
// empty at level 3, each taking a normal that was thrown away and waiting
// out its warp's Newton loop. A thread per point, so each point leaves its
// Newton loop on its own; the normal is the shared-term fd4 stencil. The
// kernel still takes padded points with an `active` mask, as the JAX
// kernel does.
//
// Numerics: -fmad=false, no fast math, the twin's order
// (project_edges_torch in bsdmg_tpu_torch/ops/cuda/mesh_kernel.py): the
// outputs equal the twin's bit for bit.

#include "project.cuh"

template <class S>
__global__ void __launch_bounds__(128)
project_kernel(const SceneDesc s, const float* __restrict__ xs, const float* __restrict__ ys,
               const float* __restrict__ zs, const int* __restrict__ active, int m, int iters,
               float tol, float eps, int use_grad, float* __restrict__ px,
               float* __restrict__ py, float* __restrict__ pz, float* __restrict__ nx,
               float* __restrict__ ny, float* __restrict__ nz) {
  stage_scene<S>(s);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float x = xs[i], y = ys[i], z = zs[i];
  if (active[i]) newton_project<S>(s, x, y, z, iters, tol, eps, use_grad);
  float a, b, c;
  unit_normal_fd4<S>(s, x, y, z, eps, a, b, c);
  px[i] = x;
  py[i] = y;
  pz[i] = z;
  nx[i] = a;
  ny[i] = b;
  nz[i] = c;
}

extern "C" {

// Launches K7 on `stream` over m points: x, y, z (m,) float32 and active
// (m,) int32 in, px, py, pz, nx, ny, nz (m,) float32 out, all on the device.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a
// descriptor structure that names none, a large-tier program whose
// scratch does not hold the launch, or a small-tier one beyond the caps of
// its walks: composed.cuh walk_fits).
int bsdmg_project_edges(const SceneDesc* desc, const float* x, const float* y, const float* z,
                        const int* active, int m, int iters, float tol, float eps, int use_grad,
                        float* px, float* py, float* pz, float* nx, float* ny, float* nz,
                        void* stream) {
  const dim3 block(128);
  const dim3 grid((m + 127) / 128);
  if (!scratch_fits(*desc, (long long)grid.x * 128)) return static_cast<int>(cudaErrorInvalidValue);
  int err = cudaErrorInvalidValue;
  with_mesh_structure(desc->structure, [&](auto scene) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long smem = scene_smem<decltype(scene)>(*desc, true);
    if (smem < 0) return;
    project_kernel<decltype(scene)><<<grid, block, smem, st>>>(
        *desc, x, y, z, active, m, iters, tol, eps, use_grad, px, py, pz, nx, ny, nz);
    err = cudaGetLastError();
  });
  return err;
}

}  // extern "C"
