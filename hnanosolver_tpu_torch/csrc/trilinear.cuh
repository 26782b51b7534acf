// The trilinear sample shared by B1 (bfecc_sample.cu) and B8/B9
// (sample_at.cu), so that an RK pass samples exactly as B1 does.
//
// Sample of fields [LO, NB) of `fields` (planes of `plane` floats, layout
// [F, T, 512]) at x + d for voxel (cx, cy, cz) of the tile whose 27 nbr
// entries are `snbr`: floor/frac weights (wx*wy)*wz, the eight corners
// summed in (di, dj, dk) order, as the plain version
// (ops/cuda_sample.py::sample_at_plain) does. |d| < 7 keeps every corner
// coordinate in [-8, 15], inside the tile's 3x3x3 neighbourhood, so a
// corner is read straight from its tile row snbr[(qx+8)>>3 ...] (the null
// row 0 where the neighbour is absent), through the read-only cache.
#pragma once

#include "common.cuh"

namespace hn {

template <int LO, int NB>
__device__ __forceinline__ void sample(const float* __restrict__ fields, size_t plane,
                                       const int* snbr, int cx, int cy, int cz,
                                       float dx, float dy, float dz, float* acc) {
  const float lx = add((float)cx, dx);
  const float ly = add((float)cy, dy);
  const float lz = add((float)cz, dz);
  const float bx = floorf(lx), by = floorf(ly), bz = floorf(lz);
  const float fx = sub(lx, bx), fy = sub(ly, by), fz = sub(lz, bz);
  const float ix = sub(1.0f, fx), iy = sub(1.0f, fy), iz = sub(1.0f, fz);
  const int ibx = (int)bx, iby = (int)by, ibz = (int)bz;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int di = k >> 2, dj = (k >> 1) & 1, dk = k & 1;
    const float w = mul(mul(di ? fx : ix, dj ? fy : iy), dk ? fz : iz);
    const int qx = ibx + di, qy = iby + dj, qz = ibz + dk;
    const int row = snbr[((qx + 8) >> 3) * 9 + ((qy + 8) >> 3) * 3 + ((qz + 8) >> 3)];
    const size_t off = (size_t)row * TILE + (qx & 7) * 64 + (qy & 7) * 8 + (qz & 7);
#pragma unroll
    for (int f = LO; f < NB; ++f) {
      const float v = mul(__ldg(fields + f * plane + off), w);
      acc[f - LO] = (k == 0) ? v : add(acc[f - LO], v);
    }
  }
}

}  // namespace hn
