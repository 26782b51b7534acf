// B6: the pointwise Poisson residual r = div - (sum_6 p_nbr - 6 p) / dx2.
//
// Replaces hnanosolver_tpu/ops/pallas_stencil.py::_residual_kernel (built
// by _build_residual, entry residual_fused), which lands packed 64-lane
// neighbour planes on the tile boundary with one-hot MXU dots.
//
// One 512-thread block per tile, one thread per voxel. The tile's row of p
// and its nbr entries are staged in shared memory; common.cuh::face_sum
// adds the six faces left to right in the order +x -x +y -y +z -z (a
// cross-tile face read straight from the neighbour's row, the null row 0
// where absent), then 6p is subtracted and the difference divided by
// dx2 with a true division (__fdiv_rn, not a multiply by the reciprocal):
// the op order of ops/pressure.py's plain form, so the kernel is bitwise
// equal to it at any dx.
//
// What bounds it on the H100: memory. It reads p and div once and writes r
// once: 12 B per voxel (the neighbours' face planes are mostly L2 hits).
#include "common.cuh"

namespace hn {

__global__ void __launch_bounds__(TILE)
residual_kernel(const float* __restrict__ p, const float* __restrict__ div,
                const int* __restrict__ nbr, float* __restrict__ out, float dx2) {
  __shared__ float s[TILE];
  __shared__ int nb[27];
  const size_t t = blockIdx.x;
  const int c = threadIdx.x;
  const size_t self = t * TILE + c;
  const float pc = p[self];
  s[c] = pc;
  if (c < 27) nb[c] = nbr[t * 27 + c];
  __syncthreads();

  const float acc = face_sum(p, s, nb, c);
  out[self] = sub(div[self], __fdiv_rn(sub(acc, mul(6.0f, pc)), dx2));
}

}  // namespace hn

// p, div, out: [T, 512] f32; nbr [T, 27] i32.
extern "C" int hn_residual(const void* p, const void* div, const void* nbr, void* out, int T,
                           float dx2, void* stream) {
  if (T <= 0) return (int)cudaErrorInvalidValue;
  hn::residual_kernel<<<T, hn::TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(div),
      static_cast<const int*>(nbr), static_cast<float*>(out), dx2);
  return (int)cudaGetLastError();
}
