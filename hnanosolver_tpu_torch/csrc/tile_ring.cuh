// The shared tile copy of kernels B3 (rbsor_lagged.cu) and B6 (residual.cu):
// one warp a tile, G tiles a block, each lane holding two (x, y) columns of
// 8 z values in registers.
//
//   - Lane l owns column A at (xa, y) and column B at (xb, y) = (xa ^ 1, y),
//     y = l & 7 and xa + y even: xa + y even and xb + y odd, so in a
//     red-black half-sweep each lane updates 4 voxels of each column with
//     compile-time z indices.
//   - The tile's shared copy is 10 x 10 columns (x, y in [-1, 8]) split by z
//     parity into two float4 (z even, z odd): the tile's own 8 x 8 columns
//     and a ring of the +-x and +-y face columns of the neighbour tiles,
//     one neighbour column a lane, loaded as full-sector float4 pairs. The
//     8 lanes of a quarter warp (y = 0..7) touch 8 consecutive float4.
//   - The +-z faces: with sorted keys nbr[t, +z] is t + 1 or 0 and
//     nbr[t, -z] is t - 1 or 0 (the key's low bits are tz; held by
//     tests/test_torch_nbr_order.py). Each tile writes its z = 0 and z = 7
//     planes to shared memory before the block barrier; a tile whose z
//     neighbour is its block neighbour reads the face there, any other from
//     p in device memory. The invariant decides where a value is read from,
//     never which value: both hold the p the tile was staged from.
#pragma once

#include "common.cuh"

namespace hn {

// tiles a block, one warp each (G = 8 ran as fast as 4 for B3 on the H100;
// 4 makes smaller blocks and a smaller tail)
constexpr int G = 4;
constexpr int RING = 10;                  // columns a side of a tile's shared copy
constexpr int HALF_STRIDE = RING * RING;  // float4 between the z-even and z-odd halves
constexpr unsigned FULL = 0xffffffffu;

// float4 index of column (x, y), x and y in [-1, 8], in parity half 0
__device__ __forceinline__ int ring(int x, int y) { return (x + 1) * RING + (y + 1); }

__device__ __forceinline__ void load_col(const float* __restrict__ src, float* v) {
  const float4 lo = *reinterpret_cast<const float4*>(src);
  const float4 hi = *reinterpret_cast<const float4*>(src + 4);
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

__device__ __forceinline__ void store_col(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// column v (8 z values) into the tile's shared copy at ring index r
__device__ __forceinline__ void put_col(float4* st, int r, const float* v) {
  st[r] = make_float4(v[0], v[2], v[4], v[6]);
  st[HALF_STRIDE + r] = make_float4(v[1], v[3], v[5], v[7]);
}

// the 8 z values of the column at ring index r of the shared copy
__device__ __forceinline__ void get_col(const float4* st, int r, float* v) {
  const float4 e = st[r], o = st[HALF_STRIDE + r];
  v[0] = e.x, v[1] = o.x, v[2] = e.y, v[3] = o.y;
  v[4] = e.z, v[5] = o.z, v[6] = e.w, v[7] = o.w;
}

// A lane's two columns in its tile
struct LaneCols {
  int y, xa, xb;
  __device__ __forceinline__ explicit LaneCols(int lane)
      : y(lane & 7), xa(2 * (lane >> 3) + (lane & 1)), xb(xa ^ 1) {}
  __device__ __forceinline__ int ca() const { return xa * 64 + y * 8; }
  __device__ __forceinline__ int cb() const { return xb * 64 + y * 8; }
};

// The rows of tile t's six face neighbours, read by lanes 0-26 and shuffled
struct FaceRows {
  int px, mx, py, my, pz, mz;
  __device__ __forceinline__ FaceRows(const int* __restrict__ nbr, int t, int lane) {
    const int nb = lane < 27 ? nbr[(size_t)t * 27 + lane] : 0;
    px = __shfl_sync(FULL, nb, D_PX), mx = __shfl_sync(FULL, nb, D_MX);
    py = __shfl_sync(FULL, nb, D_PY), my = __shfl_sync(FULL, nb, D_MY);
    pz = __shfl_sync(FULL, nb, D_PZ), mz = __shfl_sync(FULL, nb, D_MZ);
  }
};

// Before the block barrier: the lane's columns a and b (tile t's own, from
// p) into the shared copy st and the planes zplane[0] (z = 0) and zplane[1]
// (z = 7), and one +-x / +-y face column of the neighbours from p into the
// ring: lane -> (face, i), face 0..3 = +x -x +y -y, i the column along it
// (x = 0 or 7 of the x neighbours, y = 0 or 7 of the y neighbours).
__device__ __forceinline__ void stage_tile(float4* st, float (*zplane)[64],
                                           const float* __restrict__ p, const FaceRows& f,
                                           const LaneCols& c, int lane, const float* a,
                                           const float* b) {
  put_col(st, ring(c.xa, c.y), a);
  put_col(st, ring(c.xb, c.y), b);
  zplane[0][c.xa * 8 + c.y] = a[0], zplane[1][c.xa * 8 + c.y] = a[7];
  zplane[0][c.xb * 8 + c.y] = b[0], zplane[1][c.xb * 8 + c.y] = b[7];
  const int face = lane >> 3, i = lane & 7;
  const int src = face == 0 ? f.px : face == 1 ? f.mx : face == 2 ? f.py : f.my;
  const int scol = face == 0 ? i * 8 : face == 1 ? 448 + i * 8 : face == 2 ? i * 64 : i * 64 + 56;
  const int dst = face == 0 ? ring(8, i) : face == 1 ? ring(-1, i) : face == 2 ? ring(i, 8)
                                                                                 : ring(i, -1);
  float h[8];
  load_col(p + (size_t)src * TILE + scol, h);
  put_col(st, dst, h);
}

// The +z faces (z = 0 of the tile above) of columns a and b and the -z
// faces (z = 7 of the tile below): from the block neighbour's plane where
// nbr points at it (g is the tile's warp in the block), else from p. The
// reads from p go out before the block barrier (from_p), the plane reads
// after it (from_planes).
struct ZFaces {
  float pa = 0.0f, pb = 0.0f, ma = 0.0f, mb = 0.0f;
  bool p_plane = false, m_plane = false;  // read from the block neighbour's plane

  __device__ __forceinline__ void from_p(int g, int t, const float* __restrict__ p,
                                         const FaceRows& f, const LaneCols& c) {
    p_plane = f.pz == t + 1 && g + 1 < G;
    m_plane = f.mz == t - 1 && g > 0;
    if (!p_plane) {
      const float* q = p + (size_t)f.pz * TILE + c.y * 8;
      pa = q[c.xa * 64];
      pb = q[c.xb * 64];
    }
    if (!m_plane) {
      const float* q = p + (size_t)f.mz * TILE + c.y * 8 + 7;
      ma = q[c.xa * 64];
      mb = q[c.xb * 64];
    }
  }

  __device__ __forceinline__ void from_planes(const float (*zplane)[2][64], int g,
                                              const LaneCols& c) {
    if (p_plane) {
      pa = zplane[g + 1][0][c.xa * 8 + c.y];
      pb = zplane[g + 1][0][c.xb * 8 + c.y];
    }
    if (m_plane) {
      ma = zplane[g - 1][1][c.xa * 8 + c.y];
      mb = zplane[g - 1][1][c.xb * 8 + c.y];
    }
  }
};

}  // namespace hn
