// B3: lagged-halo red-black SOR, K red+black pairs per launch.
//
// Replaces hnanosolver_tpu/ops/pallas_pressure.py::_kernel_lagged_planes
// (built by _build_lagged_planes, entry solve_pressure_lagged with
// PLANES_HALO=True). It computes the same function as the full-face form
// _kernel_lagged (PLANES_HALO=False).
//
// Per half-sweep of colour c (c = 0 then 1, K times), on voxels with
// (x+y+z) & 1 == c (tile origins are multiples of 8, so the in-tile
// coordinates give the global parity):
//   pgs = (sum_6 p_nbr - div*dx2) / 6,  p <- p + omega*(pgs - p)
// with the six neighbours added in the order +x -x +y -y +z -z. In-tile
// neighbours are fresh; cross-tile face values are taken once per launch
// from the launch-start p (lagged halo) and stay fixed for the K pairs.
//
// One 512-thread block per tile; p's tile lives in shared memory for the
// whole launch and a __syncthreads() separates half-sweeps (a colour reads
// only the other colour's cells, so one barrier per half-sweep suffices).
// The kernel reads p_in and writes p_out, never in place: blocks run in any
// order, and in place a block could read face planes a neighbour had
// already updated, where the lagged semantics gather them before the launch.
//
// Optional in-domain mask [T, 512] (the multigrid coarse levels, JAX's
// voxel-granular porg): a voxel whose mask is not > 0 never updates; the
// caller zeroes those voxels of p once before the first launch, as
// solve_pressure_lagged does. Without a mask (null) every voxel of every
// row updates, through the same code as before the mask existed (the
// template's MASKED = false instance). So the null and padding rows are
// updated too, and they stay 0 only because they enter at 0, their div is
// 0 and their nbr entries are all 0: every cross-tile face read of theirs
// is a read of the null row, which stays 0 for the same reasons.
//
// What bounds it on the H100: memory. A launch reads p and div once (8 B per
// voxel), the six face planes of the neighbours (6*64*4 B per tile, mostly
// L2 hits) and writes p once (4 B per voxel); the 2K half-sweeps run in
// shared memory. The bench's 50 iterations at K = 5 are 10 launches.
#include "common.cuh"

namespace hn {

template <bool MASKED>
__global__ void __launch_bounds__(TILE)
rbsor_lagged_kernel(const float* __restrict__ p_in, const float* __restrict__ div,
                    const int* __restrict__ nbr, const float* __restrict__ mask,
                    float* __restrict__ p_out, int K, float omega, float dx2) {
  __shared__ float s[TILE];
  const int t = blockIdx.x;
  const int c = threadIdx.x;
  const size_t self = (size_t)t * TILE + c;
  const int cx = c >> 6, cy = (c >> 3) & 7, cz = c & 7;
  const int* nb = nbr + (size_t)t * 27;

  float p = p_in[self];
  s[c] = p;
  // lagged cross-tile face values: the neighbour row's voxel on the
  // touching plane (coordinate wrapped mod 8); only boundary ones are used
  const float fpx = (cx == 7) ? p_in[(size_t)nb[D_PX] * TILE + c - 448] : 0.0f;
  const float fmx = (cx == 0) ? p_in[(size_t)nb[D_MX] * TILE + c + 448] : 0.0f;
  const float fpy = (cy == 7) ? p_in[(size_t)nb[D_PY] * TILE + c - 56] : 0.0f;
  const float fmy = (cy == 0) ? p_in[(size_t)nb[D_MY] * TILE + c + 56] : 0.0f;
  const float fpz = (cz == 7) ? p_in[(size_t)nb[D_PZ] * TILE + c - 7] : 0.0f;
  const float fmz = (cz == 0) ? p_in[(size_t)nb[D_MZ] * TILE + c + 7] : 0.0f;
  const float rhs = mul(div[self], dx2);
  const float sixth = 1.0f / 6.0f;
  const int parity = (cx + cy + cz) & 1;
  const bool in_dom = !MASKED || mask[self] > 0.0f;
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    for (int color = 0; color < 2; ++color) {
      if (parity == color && in_dom) {
        float sum = (cx == 7) ? fpx : s[cx == 7 ? c : c + 64];
        sum = add(sum, (cx == 0) ? fmx : s[cx == 0 ? c : c - 64]);
        sum = add(sum, (cy == 7) ? fpy : s[cy == 7 ? c : c + 8]);
        sum = add(sum, (cy == 0) ? fmy : s[cy == 0 ? c : c - 8]);
        sum = add(sum, (cz == 7) ? fpz : s[cz == 7 ? c : c + 1]);
        sum = add(sum, (cz == 0) ? fmz : s[cz == 0 ? c : c - 1]);
        const float pgs = mul(sub(sum, rhs), sixth);
        p = add(p, mul(omega, sub(pgs, p)));
        s[c] = p;
      }
      __syncthreads();
    }
  }
  p_out[self] = p;
}

}  // namespace hn

// p_in, div, p_out: [T, 512] f32 (p_out must not alias p_in); nbr [T, 27] i32;
// mask [T, 512] f32 or null (every voxel in the domain).
extern "C" int hn_rbsor_lagged(const void* p_in, const void* div, const void* nbr,
                               const void* mask, void* p_out, int T, int K, float omega,
                               float dx2, void* stream) {
  if (T <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const float* pi = static_cast<const float*>(p_in);
  const float* d = static_cast<const float*>(div);
  const int* n = static_cast<const int*>(nbr);
  const float* m = static_cast<const float*>(mask);
  float* po = static_cast<float*>(p_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == nullptr)
    hn::rbsor_lagged_kernel<false><<<T, hn::TILE, 0, s>>>(pi, d, n, m, po, K, omega, dx2);
  else
    hn::rbsor_lagged_kernel<true><<<T, hn::TILE, 0, s>>>(pi, d, n, m, po, K, omega, dx2);
  return (int)cudaGetLastError();
}
