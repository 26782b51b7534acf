// B4: one red-black SOR colour half-sweep with a fresh halo, in place.
//
// Replaces hnanosolver_tpu/ops/pallas_pressure.py::_kernel (built by _build,
// entry solve_pressure_pallas), which takes G-tile blocks and the six face
// rows of each tile pre-gathered by XLA. Here each thread reads its six
// faces straight from the current p (rbsor.cuh::sor_point): in-tile from
// the tile's row, cross-tile through nbr.
//
// One 256-thread block per tile, one thread per voxel of the active colour
// (rbsor.cuh::color_col); voxels outside the optional in-domain mask never
// update. In place rather than ping-pong: a colour reads only the other
// colour, which this launch never writes, so the result does not depend on
// the order the blocks run in, and only the half of p that changes is
// written back.
//
// What bounds it on the H100: memory. A launch reads p and div once and
// writes half of p: 12 B per voxel at most, counted as B3's launch (p and
// div in, p out); the cross-tile face reads are L2 hits.
#include "rbsor.cuh"

namespace hn {

__global__ void __launch_bounds__(HALF)
rbsor_color_kernel(float* p, const float* __restrict__ div, const int* __restrict__ nbr,
                   const float* __restrict__ mask, int color, float omega, float dx2) {
  const size_t t = blockIdx.x;
  const int c = color_col(threadIdx.x, color);
  const size_t self = t * TILE + c;
  if (!in_domain(mask, self)) return;
  const float v = sor_point(p, div, nbr + t * 27, t, c, omega, dx2);
  p[self] = v;
}

}  // namespace hn

// p [T, 512] f32 (updated in place), div [T, 512] f32, nbr [T, 27] i32,
// mask [T, 512] f32 or null. color 0 (red) or 1 (black).
extern "C" int hn_rbsor_color(void* p, const void* div, const void* nbr, const void* mask,
                              int T, int color, float omega, float dx2, void* stream) {
  if (T <= 0 || (color != 0 && color != 1)) return (int)cudaErrorInvalidValue;
  hn::rbsor_color_kernel<<<T, hn::HALF, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(div),
      static_cast<const int*>(nbr), static_cast<const float*>(mask), color, omega, dx2);
  return (int)cudaGetLastError();
}
