// B5: the whole textbook red-black SOR solve (2 * iterations colour
// half-sweeps, fresh halo every half-sweep) in one launch.
//
// Replaces hnanosolver_tpu/ops/pallas_pressure.py::_fused_kernel (built by
// _build_fused, entry solve_pressure_fused), which keeps p in VMEM for the
// whole solve and assembles neighbour rows with SMEM-indexed row copies.
// It serves every solve at T <= MAX_FUSED_ROWS (2048) tiles: small domains
// and the coarse multigrid levels.
//
// A persistent cooperative kernel: the grid holds as many 256-thread
// blocks as can be resident at once (occupancy x SM count, at most T),
// each walks the tiles with a grid stride and updates one colour in place
// (rbsor.cuh::sor_point), and cooperative_groups' grid barrier separates
// the half-sweeps. At T <= 2048 p is at most 4 MB and stays in the 50 MB
// L2 for the whole solve. At entry p = p0, with voxels outside the
// optional in-domain mask set to 0; those voxels never update.
//
// What bounds it on the H100: neither memory nor arithmetic but the
// 2 * iterations grid barriers (a few microseconds each) and the latency
// of each half-sweep's L2 reads. The launch moves p0, div and mask in and
// p out once (16 B per voxel).
#include <cooperative_groups.h>

#include "rbsor.cuh"

namespace hn {

__global__ void __launch_bounds__(HALF)
rbsor_fused_kernel(const float* __restrict__ p0, const float* __restrict__ div,
                   const int* __restrict__ nbr, const float* __restrict__ mask, float* p,
                   int T, int iterations, float omega, float dx2) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const size_t n = (size_t)T * TILE;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    p[i] = in_domain(mask, i) ? p0[i] : 0.0f;
  grid.sync();
  for (int s = 0; s < 2 * iterations; ++s) {
    const int c = color_col(threadIdx.x, s & 1);
    for (size_t t = blockIdx.x; t < (size_t)T; t += gridDim.x) {
      const size_t self = t * TILE + c;
      if (in_domain(mask, self)) p[self] = sor_point(p, div, nbr + t * 27, t, c, omega, dx2);
    }
    grid.sync();
  }
}

}  // namespace hn

// p0, div [T, 512] f32; nbr [T, 27] i32; mask [T, 512] f32 or null;
// p [T, 512] f32 output (must not alias p0).
extern "C" int hn_rbsor_fused(const void* p0, const void* div, const void* nbr,
                              const void* mask, void* p, int T, int iterations, float omega,
                              float dx2, void* stream) {
  if (T <= 0 || iterations < 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hn::rbsor_fused_kernel, hn::HALF,
                                                      0);
  if (e != cudaSuccess) return (int)e;
  const int grid = per_sm * sms < T ? per_sm * sms : T;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const float* a_p0 = static_cast<const float*>(p0);
  const float* a_div = static_cast<const float*>(div);
  const int* a_nbr = static_cast<const int*>(nbr);
  const float* a_mask = static_cast<const float*>(mask);
  float* a_p = static_cast<float*>(p);
  void* args[] = {&a_p0, &a_div, &a_nbr, &a_mask, &a_p, &T, &iterations, &omega, &dx2};
  return (int)cudaLaunchCooperativeKernel((const void*)hn::rbsor_fused_kernel, dim3(grid),
                                          dim3(hn::HALF), args, 0,
                                          static_cast<cudaStream_t>(stream));
}
