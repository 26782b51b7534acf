// The fresh-halo red-black SOR update shared by B4 (rbsor_color.cu) and B5
// (rbsor_fused.cu).
//
// One update of voxel c of tile t on the current p (in place):
//   pgs = (sum_6 p_nbr - div*dx2) / 6,  p <- p + omega*(pgs - p)
// with the six faces summed by common.cuh::face_sum from t's own row and
// the neighbours' rows of the current p. Every face of
// a voxel has the other colour, and a half-sweep writes only its own
// colour, so reads and writes of one half-sweep never overlap: updating in
// place is race-free and deterministic.
#pragma once

#include "common.cuh"

namespace hn {

// threads per tile: one per voxel of the active colour
constexpr int HALF = TILE / 2;

// The in-tile column of voxel i (0 <= i < 256) of colour `color`. Tile
// origins are multiples of 8, so (x + y + z) & 1 is the global parity:
// each (x, y) row holds that colour at z = o, o+2, o+4, o+6 with
// o = (x + y + color) & 1.
__device__ __forceinline__ int color_col(int i, int color) {
  const int x = i >> 5, y = (i >> 2) & 7;
  const int z = 2 * (i & 3) + ((x + y + color) & 1);
  return x * 64 + y * 8 + z;
}

// p is read and written by other threads between grid-wide barriers (B5),
// so it is read through plain loads, never the read-only cache.
__device__ __forceinline__ float sor_point(const float* p, const float* __restrict__ div,
                                           const int* __restrict__ nb, size_t t, int c,
                                           float omega, float dx2) {
  const float* row = p + t * TILE;
  const float sum = face_sum(p, row, nb, c);
  const float pgs = mul(sub(sum, mul(div[t * TILE + c], dx2)), 1.0f / 6.0f);
  const float pc = row[c];
  return add(pc, mul(omega, sub(pgs, pc)));
}

// mask == nullptr: every voxel is in the domain; else mask > 0 marks it
__device__ __forceinline__ bool in_domain(const float* __restrict__ mask, size_t i) {
  return mask == nullptr || mask[i] > 0.0f;
}

}  // namespace hn
