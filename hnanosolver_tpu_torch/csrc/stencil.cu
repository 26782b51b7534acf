// B7a: divergence, B7b: u - grad(p), collocated central differences.
//
// Replaces hnanosolver_tpu/ops/pallas_stencil.py::_div_kernel (built by
// _build_div, entry divergence_fused) and ::_subgrad_kernel (built by
// _build_subgrad, entry subtract_gradient_fused), which land packed 64-lane
// neighbour planes on the tile boundary with one-hot MXU dots.
//
// Per voxel, with v_{+a} / v_{-a} the face neighbours along axis a
// (common.cuh::face, the null row 0 where a neighbour is absent):
//   B7a  div    = ((ux_{+x} - ux_{-x}) + (uy_{+y} - uy_{-y})) + (uz_{+z} - uz_{-z}),
//        out    = div * scale
//   B7b  out[a] = vel[a] - (p_{+a} - p_{-a}) * scale
// with scale = 0.5 * inv_dx rounded to float32 by the caller: the op order
// of ops/stencil.py's plain forms, so each kernel is bitwise equal to its
// plain version.
//
// One 512-thread block per tile, one thread per voxel; the tile's rows of
// the differenced fields and its 27 nbr entries are staged in shared
// memory, cross-tile faces are read straight from the neighbour rows.
//
// What bounds it on the H100: memory. B7a reads the three velocity
// components once and writes div (16 B per voxel); B7b reads velocity and
// p and writes velocity (28 B per voxel). The neighbours' face planes are
// another 6*64*4 B per tile and field, mostly L2 hits.
#include "common.cuh"

namespace hn {

__global__ void __launch_bounds__(TILE)
divergence_kernel(const float* __restrict__ vel, const int* __restrict__ nbr,
                  float* __restrict__ out, int T, float scale) {
  __shared__ float s[3][TILE];
  __shared__ int nb[27];
  const size_t t = blockIdx.x;
  const int c = threadIdx.x;
  const size_t plane = (size_t)T * TILE;
  const size_t self = t * TILE + c;
#pragma unroll
  for (int a = 0; a < 3; ++a) s[a][c] = vel[a * plane + self];
  if (c < 27) nb[c] = nbr[t * 27 + c];
  __syncthreads();

  const float* ux = vel;
  const float* uy = vel + plane;
  const float* uz = vel + 2 * plane;
  float acc = sub(face<D_PX>(ux, s[0], nb, c), face<D_MX>(ux, s[0], nb, c));
  acc = add(acc, sub(face<D_PY>(uy, s[1], nb, c), face<D_MY>(uy, s[1], nb, c)));
  acc = add(acc, sub(face<D_PZ>(uz, s[2], nb, c), face<D_MZ>(uz, s[2], nb, c)));
  out[self] = mul(acc, scale);
}

__global__ void __launch_bounds__(TILE)
subtract_gradient_kernel(const float* __restrict__ vel, const float* __restrict__ p,
                         const int* __restrict__ nbr, float* __restrict__ out, int T,
                         float scale) {
  __shared__ float s[TILE];
  __shared__ int nb[27];
  const size_t t = blockIdx.x;
  const int c = threadIdx.x;
  const size_t plane = (size_t)T * TILE;
  const size_t self = t * TILE + c;
  s[c] = p[self];
  if (c < 27) nb[c] = nbr[t * 27 + c];
  __syncthreads();

  const float gx = mul(sub(face<D_PX>(p, s, nb, c), face<D_MX>(p, s, nb, c)), scale);
  const float gy = mul(sub(face<D_PY>(p, s, nb, c), face<D_MY>(p, s, nb, c)), scale);
  const float gz = mul(sub(face<D_PZ>(p, s, nb, c), face<D_MZ>(p, s, nb, c)), scale);
  out[self] = sub(vel[self], gx);
  out[plane + self] = sub(vel[plane + self], gy);
  out[2 * plane + self] = sub(vel[2 * plane + self], gz);
}

}  // namespace hn

// vel [3, T, 512] f32, nbr [T, 27] i32, out [T, 512] f32.
extern "C" int hn_divergence(const void* vel, const void* nbr, void* out, int T, float scale,
                             void* stream) {
  if (T <= 0) return (int)cudaErrorInvalidValue;
  hn::divergence_kernel<<<T, hn::TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vel), static_cast<const int*>(nbr), static_cast<float*>(out),
      T, scale);
  return (int)cudaGetLastError();
}

// vel [3, T, 512] f32, p [T, 512] f32, nbr [T, 27] i32, out [3, T, 512] f32.
extern "C" int hn_subtract_gradient(const void* vel, const void* p, const void* nbr, void* out,
                                    int T, float scale, void* stream) {
  if (T <= 0) return (int)cudaErrorInvalidValue;
  hn::subtract_gradient_kernel<<<T, hn::TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vel), static_cast<const float*>(p),
      static_cast<const int*>(nbr), static_cast<float*>(out), T, scale);
  return (int)cudaGetLastError();
}
