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
// The kernel reads p_in and writes p_out, never in place: blocks run in any
// order, and in place a block could read face planes a neighbour had
// already updated, where the lagged semantics gather them before the launch.
//
// What bounds it on the H100: memory. A launch must read p and div once
// and write p once (12 B a voxel); the 2K half-sweeps run on chip. The
// design keeps every voxel busy and every load in full sectors
// (tile_ring.cuh): one warp a tile, G tiles a block, a lane holding two
// (x, y) columns of 8 z values in registers, A with xa + y even and B at
// xa ^ 1, so in every half-sweep each lane updates 4 voxels of each column
// (A's colour-c voxels have z parity c, B's 1 - c: compile-time indices
// once the colour loop is unrolled); p and div load, and p_out stores, as
// float4 pairs.
//   - The x/y neighbours are other lanes' columns, exchanged through the
//     tile's shared copy, whose ring holds the lagged +-x and +-y faces. A
//     half-sweep reads the other colour, which lies in the same parity half
//     as the lane's own colour, from its four x/y neighbour columns (four
//     16-byte loads) and writes its own colour's half back. It writes only
//     its colour and reads only the other, so one __syncwarp per half-sweep
//     is exact, and no tile waits on another.
//   - The lagged +-z faces come from the block neighbour's launch-start
//     plane where nbr points at it, else from p_in.
// The sum runs through common.cuh's round-to-nearest intrinsics in the
// plain version's order, so the result is bitwise that of
// ops/cuda_pressure.py::rbsor_lagged_plain.
//
// Optional in-domain mask [T, 512] (the multigrid coarse levels, JAX's
// voxel-granular porg): a voxel whose mask is not > 0 never updates; the
// caller zeroes those voxels of p once before the first launch, as
// solve_pressure_lagged does (the MASKED = true instance). Without a mask
// (null) every voxel of every row updates. So the null and padding rows
// are updated too, and they stay 0 only because they enter at 0, their div
// is 0 and their nbr entries are all 0: every cross-tile face read of
// theirs is a read of the null row, which stays 0 for the same reasons.
#include "tile_ring.cuh"

namespace hn {

// One half-sweep of column (x, y) whose colour lies at z parity O: the
// four x/y neighbours from the shared copy (their other colour is in half O
// too), the z neighbours from the column itself or the lagged faces zp
// (above z = 7) and zm (below z = 0).
template <bool MASKED, int O>
__device__ __forceinline__ void update_column(float4* st, int x, int y, float* v,
                                              const float* r, float zp, float zm,
                                              unsigned in_dom, float omega) {
  const float4* h = st + O * HALF_STRIDE;
  const float4 px = h[ring(x + 1, y)], mx = h[ring(x - 1, y)];
  const float4 py = h[ring(x, y + 1)], my = h[ring(x, y - 1)];
  const float fpx[4] = {px.x, px.y, px.z, px.w}, fmx[4] = {mx.x, mx.y, mx.z, mx.w};
  const float fpy[4] = {py.x, py.y, py.z, py.w}, fmy[4] = {my.x, my.y, my.z, my.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int z = 2 * j + O;
    if (MASKED && !((in_dom >> z) & 1u)) continue;
    float sum = add(fpx[j], fmx[j]);
    sum = add(sum, fpy[j]);
    sum = add(sum, fmy[j]);
    sum = add(sum, z == 7 ? zp : v[z == 7 ? z : z + 1]);
    sum = add(sum, z == 0 ? zm : v[z == 0 ? z : z - 1]);
    const float pgs = mul(sub(sum, r[z]), 1.0f / 6.0f);
    v[z] = add(v[z], mul(omega, sub(pgs, v[z])));
  }
  st[O * HALF_STRIDE + ring(x, y)] = make_float4(v[O], v[O + 2], v[O + 4], v[O + 6]);
}

// 64 registers a thread (8 blocks, 32 warps an SM); the masked instance
// needs 80 not to spill (6 blocks)
template <bool MASKED>
__global__ void __launch_bounds__(G * 32, MASKED ? 6 : 8)
rbsor_lagged_kernel(const float* __restrict__ p_in, const float* __restrict__ div,
                    const int* __restrict__ nbr, const float* __restrict__ mask,
                    float* __restrict__ p_out, int T, int K, float omega, float dx2) {
  __shared__ float4 tiles[G][2 * HALF_STRIDE];
  __shared__ float zplane[G][2][64];  // launch-start z = 0 and z = 7 planes
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * G + g;
  const bool active = t < T;  // the tail block's extra warps only meet the barrier
  float4* st = tiles[g];

  float a[8], b[8], ra[8], rb[8];
  unsigned ma = 0xffu, mb = 0xffu;
  ZFaces zf;
  const LaneCols c(lane);
  const FaceRows f(nbr, active ? t : 0, lane);
  if (active) {
    const size_t row = (size_t)t * TILE;
    load_col(p_in + row + c.ca(), a);
    load_col(p_in + row + c.cb(), b);
    load_col(div + row + c.ca(), ra);
    load_col(div + row + c.cb(), rb);
#pragma unroll
    for (int z = 0; z < 8; ++z) ra[z] = mul(ra[z], dx2), rb[z] = mul(rb[z], dx2);
    if (MASKED) {
      float m[8];
      ma = mb = 0u;
      load_col(mask + row + c.ca(), m);
#pragma unroll
      for (int z = 0; z < 8; ++z) ma |= (m[z] > 0.0f ? 1u : 0u) << z;
      load_col(mask + row + c.cb(), m);
#pragma unroll
      for (int z = 0; z < 8; ++z) mb |= (m[z] > 0.0f ? 1u : 0u) << z;
    }
    stage_tile(st, zplane[g], p_in, f, c, lane, a, b);
    zf.from_p(g, t, p_in, f, c);  // the lagged +-z faces: the launch-start values
  }
  __syncthreads();
  if (!active) return;
  zf.from_planes(zplane, g, c);
  const int xa = c.xa, xb = c.xb, y = c.y;
  const float zpa = zf.pa, zpb = zf.pb, zma = zf.ma, zmb = zf.mb;

  for (int k = 0; k < K; ++k) {
    update_column<MASKED, 0>(st, xa, y, a, ra, zpa, zma, ma, omega);
    update_column<MASKED, 1>(st, xb, y, b, rb, zpb, zmb, mb, omega);
    __syncwarp();
    update_column<MASKED, 1>(st, xa, y, a, ra, zpa, zma, ma, omega);
    update_column<MASKED, 0>(st, xb, y, b, rb, zpb, zmb, mb, omega);
    __syncwarp();
  }
  const size_t row = (size_t)t * TILE;
  store_col(p_out + row + xa * 64 + y * 8, a);
  store_col(p_out + row + xb * 64 + y * 8, b);
}

}  // namespace hn

// p_in, div, p_out: [T, 512] f32, 16-byte aligned (float4 loads; p_out must
// not alias p_in); nbr [T, 27] i32; mask [T, 512] f32 or null (every voxel
// in the domain), 16-byte aligned.
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
  const int blocks = (T + hn::G - 1) / hn::G;
  if (m == nullptr)
    hn::rbsor_lagged_kernel<false><<<blocks, hn::G * 32, 0, s>>>(pi, d, n, m, po, T, K, omega,
                                                                 dx2);
  else
    hn::rbsor_lagged_kernel<true><<<blocks, hn::G * 32, 0, s>>>(pi, d, n, m, po, T, K, omega,
                                                                dx2);
  return (int)cudaGetLastError();
}
