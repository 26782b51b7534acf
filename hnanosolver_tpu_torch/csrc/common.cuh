// Shared helpers for the hand-written Hopper kernels of hnanosolver_tpu_torch.
//
// Layout (core/layout.py): a field is [T, 512] float32 per 8^3 tile, in-tile
// column col = x*64 + y*8 + z. nbr is [T, 27] int32, entry
// (dx+1)*9 + (dy+1)*3 + (dz+1) is the row of that neighbour tile, 0 (the
// all-zero null row) where absent.
//
// Arithmetic goes through the round-to-nearest intrinsics so that nvcc
// cannot contract a*b + c into one FMA: each kernel then rounds exactly as
// its plain PyTorch version does, op for op. The kernels are bound by memory
// traffic, so the lost FMA throughput costs nothing measurable.
#pragma once

#include <cuda_runtime.h>

namespace hn {

constexpr int TILE = 512;

// nbr columns of the six face neighbours, in the order +x -x +y -y +z -z
constexpr int D_PX = 22, D_MX = 4, D_PY = 16, D_MY = 10, D_PZ = 14, D_MZ = 12;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// The six face values of voxel c of tile t added left to right in the
// order +x -x +y -y +z -z (the plain versions' FACE_DIRS order): in-tile
// faces from `row` (t's row of p, in global or shared memory), cross-tile
// faces from the neighbour's row of p through nb (t's 27 nbr entries; the
// null row 0, all zeros, where the neighbour is absent). A cross-tile face
// reads the neighbour row's voxel on the touching plane (the coordinate
// wrapped mod 8); the in-tile index is clamped to the row on the boundary
// so no address outside it is ever formed.
__device__ __forceinline__ float face_sum(const float* p, const float* row, const int* nb,
                                          int c) {
  const int cx = c >> 6, cy = (c >> 3) & 7, cz = c & 7;
  float sum = (cx == 7) ? p[(size_t)nb[D_PX] * TILE + c - 448] : row[cx == 7 ? c : c + 64];
  sum = add(sum, (cx == 0) ? p[(size_t)nb[D_MX] * TILE + c + 448] : row[cx == 0 ? c : c - 64]);
  sum = add(sum, (cy == 7) ? p[(size_t)nb[D_PY] * TILE + c - 56] : row[cy == 7 ? c : c + 8]);
  sum = add(sum, (cy == 0) ? p[(size_t)nb[D_MY] * TILE + c + 56] : row[cy == 0 ? c : c - 8]);
  sum = add(sum, (cz == 7) ? p[(size_t)nb[D_PZ] * TILE + c - 7] : row[cz == 7 ? c : c + 1]);
  return add(sum, (cz == 0) ? p[(size_t)nb[D_MZ] * TILE + c + 7] : row[cz == 0 ? c : c - 1]);
}

// jnp.clip / torch.clamp order: max with the lower bound, then min
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

}  // namespace hn
