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

// jnp.clip / torch.clamp order: max with the lower bound, then min
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

}  // namespace hn
