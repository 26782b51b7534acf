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

// The face value of voxel c of tile t in direction D (one of the D_* nbr
// columns above; shifts.shifted_view in the plain versions): in-tile from
// `row` (t's row of p, in global or shared memory), cross-tile from the
// neighbour's row of p through nb (t's 27 nbr entries; the null row 0, all
// zeros, where the neighbour is absent). A cross-tile face reads the
// neighbour row's voxel on the touching plane (the coordinate wrapped mod
// 8); the in-tile index is clamped to the row on the boundary so no
// address outside it is ever formed.
template <int D>
__device__ __forceinline__ float face(const float* p, const float* row, const int* nb, int c) {
  static_assert(D == D_PX || D == D_MX || D == D_PY || D == D_MY || D == D_PZ || D == D_MZ,
                "not a face direction");
  constexpr bool plus = D == D_PX || D == D_PY || D == D_PZ;
  constexpr int step = (D == D_PX || D == D_MX) ? 64 : (D == D_PY || D == D_MY) ? 8 : 1;
  const int coord = (c / step) & 7;
  const bool edge = plus ? coord == 7 : coord == 0;
  return edge ? p[(size_t)nb[D] * TILE + (plus ? c - 7 * step : c + 7 * step)]
              : row[edge ? c : (plus ? c + step : c - step)];
}

// The six face values of voxel c of tile t added left to right in the
// order +x -x +y -y +z -z (the plain versions' FACE_DIRS order).
__device__ __forceinline__ float face_sum(const float* p, const float* row, const int* nb,
                                          int c) {
  float sum = face<D_PX>(p, row, nb, c);
  sum = add(sum, face<D_MX>(p, row, nb, c));
  sum = add(sum, face<D_PY>(p, row, nb, c));
  sum = add(sum, face<D_MY>(p, row, nb, c));
  sum = add(sum, face<D_PZ>(p, row, nb, c));
  return add(sum, face<D_MZ>(p, row, nb, c));
}

// jnp.clip / torch.clamp order: max with the lower bound, then min
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

}  // namespace hn
