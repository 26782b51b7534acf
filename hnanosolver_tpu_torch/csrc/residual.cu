// B6: the pointwise Poisson residual r = div - (sum_6 p_nbr - 6 p) / dx2.
//
// Replaces hnanosolver_tpu/ops/pallas_stencil.py::_residual_kernel (built
// by _build_residual, entry residual_fused), which lands packed 64-lane
// neighbour planes on the tile boundary with one-hot MXU dots.
//
// The six faces are added left to right in the order +x -x +y -y +z -z
// (a cross-tile face read from the neighbour's row, the null row 0 where
// absent), then 6p is subtracted and the difference divided by dx2 with a
// true division (__fdiv_rn, not a multiply by the reciprocal): the op
// order of ops/cuda_stencil.py's plain form, so the kernel is bitwise equal
// to it at any dx. No mask: multigrid.v_cycle multiplies by the level's
// mask afterwards, as the JAX package does.
//
// What bounds it on the H100: memory. It must read p and div once and write
// r once: 12 B a voxel. The design moves little more than that, in full
// sectors (tile_ring.cuh, the layout of B3): one warp a tile, G tiles a
// block, a lane holding two (x, y) columns of p in registers, loaded and
// stored as float4 pairs; the x/y neighbours from the tile's shared copy,
// whose ring holds the neighbours' +-x / +-y face columns (one full-sector
// column load a lane); the in-tile z neighbours from the lane's own
// registers; the +-z faces from the block neighbour's z = 0 / z = 7 plane
// where nbr[t, +-z] = t +- 1, else from p (the only scalar loads left).
#include "tile_ring.cuh"

namespace hn {

// r of the 8 voxels of column (x, y), p values v, one z-parity half at a
// time: x/y neighbours from the shared copy, z neighbours from v or the
// faces zp (above z = 7) and zm (below z = 0)
__device__ __forceinline__ void residual_column(const float4* st, int x, int y,
                                                const float* v, float zp, float zm,
                                                const float* d, float* r, float dx2) {
#pragma unroll
  for (int O = 0; O < 2; ++O) {
    const float4* h = st + O * HALF_STRIDE;
    const float4 px = h[ring(x + 1, y)], mx = h[ring(x - 1, y)];
    const float4 py = h[ring(x, y + 1)], my = h[ring(x, y - 1)];
    const float fpx[4] = {px.x, px.y, px.z, px.w}, fmx[4] = {mx.x, mx.y, mx.z, mx.w};
    const float fpy[4] = {py.x, py.y, py.z, py.w}, fmy[4] = {my.x, my.y, my.z, my.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int z = 2 * j + O;
      float sum = add(fpx[j], fmx[j]);
      sum = add(sum, fpy[j]);
      sum = add(sum, fmy[j]);
      sum = add(sum, z == 7 ? zp : v[z == 7 ? z : z + 1]);
      sum = add(sum, z == 0 ? zm : v[z == 0 ? z : z - 1]);
      r[z] = sub(d[z], __fdiv_rn(sub(sum, mul(6.0f, v[z])), dx2));
    }
  }
}

// 64 registers a thread: 8 blocks, 32 warps an SM
__global__ void __launch_bounds__(G * 32, 8)
residual_kernel(const float* __restrict__ p, const float* __restrict__ div,
                const int* __restrict__ nbr, float* __restrict__ out, int T, float dx2) {
  __shared__ float4 tiles[G][2 * HALF_STRIDE];
  __shared__ float zplane[G][2][64];  // the tiles' z = 0 and z = 7 planes
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * G + g;
  const bool active = t < T;  // the tail block's extra warps only meet the barrier
  float4* st = tiles[g];

  float a[8], b[8], da[8], db[8];
  ZFaces zf;
  const LaneCols c(lane);
  const FaceRows f(nbr, active ? t : 0, lane);
  const size_t row = (size_t)t * TILE;
  if (active) {
    load_col(p + row + c.ca(), a);
    load_col(p + row + c.cb(), b);
    load_col(div + row + c.ca(), da);  // in flight across the barrier
    load_col(div + row + c.cb(), db);
    stage_tile(st, zplane[g], p, f, c, lane, a, b);
    zf.from_p(g, t, p, f, c);
  }
  __syncthreads();
  if (!active) return;
  zf.from_planes(zplane, g, c);
  float r[8];
  residual_column(st, c.xa, c.y, a, zf.pa, zf.ma, da, r, dx2);
  store_col(out + row + c.ca(), r);
  residual_column(st, c.xb, c.y, b, zf.pb, zf.mb, db, r, dx2);
  store_col(out + row + c.cb(), r);
}

}  // namespace hn

// p, div, out: [T, 512] f32, 16-byte aligned (float4 loads); nbr [T, 27] i32.
extern "C" int hn_residual(const void* p, const void* div, const void* nbr, void* out, int T,
                           float dx2, void* stream) {
  if (T <= 0) return (int)cudaErrorInvalidValue;
  hn::residual_kernel<<<(T + hn::G - 1) / hn::G, hn::G * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(div),
      static_cast<const int*>(nbr), static_cast<float*>(out), T, dx2);
  return (int)cudaGetLastError();
}
