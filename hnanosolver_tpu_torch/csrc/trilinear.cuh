// The trilinear sample shared by B1 (bfecc_sample.cu: the nbr form and the
// dual-table form) and B8/B9 (sample_at.cu), so that every pass samples
// with one arithmetic and one summation order.
//
// Sample of fields [LO, NB) at x + d for voxel (cx, cy, cz) of a tile:
// floor/frac weights (wx*wy)*wz, the eight corners summed in (di, dj, dk)
// order, as the plain versions (ops/cuda_sample.py::sample_at_plain,
// ops/cuda_bfecc.py::sample_dual_plain) do. Where a corner's values are
// read from is the Corners policy: at(qx, qy, qz) points at field 0 of the
// corner at in-tile position q, and field f lies stride() floats further.
//
// NbrCorners: fields [F, T, 512], the tile's 27 nbr entries. |d| < 7
// keeps every corner coordinate in [-8, 15], inside the tile's 3x3x3
// neighbourhood, so a corner is read straight from its tile row
// snbr[(qx+8)>>3 ...] (the null row 0 where the neighbour is absent).
//
// DualCorners: the tile's chunk of a dual table (rows u*nf + f of 512
// columns, ops/tables.py) and the tile's 8 chunk_ldual entries. Dual row
// j = jx*4 + jy*2 + jz holds f at in-tile positions jx*8 + l - 4 per axis,
// so a corner at q in [-4, 12) per axis reads row sdual[((qx+4)>>3)*4 ...]
// at column ((qx+4)&7)*64 + ...; |d| < 4 keeps every corner there (the
// callers' CFL bounds).
#pragma once

#include "common.cuh"

namespace hn {

struct NbrCorners {
  const float* fields;
  size_t plane;  // floats between two fields
  const int* snbr;

  __device__ __forceinline__ const float* at(int qx, int qy, int qz) const {
    const int row = snbr[((qx + 8) >> 3) * 9 + ((qy + 8) >> 3) * 3 + ((qz + 8) >> 3)];
    return fields + (size_t)row * TILE + (qx & 7) * 64 + (qy & 7) * 8 + (qz & 7);
  }
  __device__ __forceinline__ size_t stride() const { return plane; }
};

struct DualCorners {
  const float* table;  // the chunk's [Ud*nf, 512] rows, offset to field 0
  int nf;              // fields per dual row of the table
  const int* sdual;

  __device__ __forceinline__ const float* at(int qx, int qy, int qz) const {
    const int px = qx + 4, py = qy + 4, pz = qz + 4;
    const int row = sdual[(px >> 3) * 4 + (py >> 3) * 2 + (pz >> 3)];
    return table + (size_t)row * nf * TILE + (px & 7) * 64 + (py & 7) * 8 + (pz & 7);
  }
  __device__ __forceinline__ size_t stride() const { return TILE; }
};

template <int LO, int NB, class Corners>
__device__ __forceinline__ void sample(const Corners& cs, int cx, int cy, int cz, float dx,
                                       float dy, float dz, float* acc) {
  const float lx = add((float)cx, dx);
  const float ly = add((float)cy, dy);
  const float lz = add((float)cz, dz);
  const float bx = floorf(lx), by = floorf(ly), bz = floorf(lz);
  const float fx = sub(lx, bx), fy = sub(ly, by), fz = sub(lz, bz);
  const float ix = sub(1.0f, fx), iy = sub(1.0f, fy), iz = sub(1.0f, fz);
  const int ibx = (int)bx, iby = (int)by, ibz = (int)bz;
  const size_t stride = cs.stride();
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int di = k >> 2, dj = (k >> 1) & 1, dk = k & 1;
    const float w = mul(mul(di ? fx : ix, dj ? fy : iy), dk ? fz : iz);
    const float* p = cs.at(ibx + di, iby + dj, ibz + dk);
#pragma unroll
    for (int f = LO; f < NB; ++f) {
      const float v = mul(__ldg(p + f * stride), w);
      acc[f - LO] = (k == 0) ? v : add(acc[f - LO], v);
    }
  }
}

}  // namespace hn
