// B2: fused BFECC tail (limiter bounds + correction + clip).
//
// Replaces hnanosolver_tpu/ops/pallas_tail.py::_kernel (built by _build,
// entry bfecc_tail_fused), which lands packed 64-lane neighbour planes on the
// tile boundary with one-hot MXU dots.
//
// Per voxel of field f:
//   out = clip(pf + 0.5*(phi0 - pb), lo, hi)
//   lo/hi = min/max over {phi0, its six face neighbours, pf}
// Absent face neighbours read the null row, i.e. 0.
//
// One 512-thread block per (tile, field). The tile's phi0 row is staged in
// shared memory for the in-tile faces; a cross-tile face is read directly
// from the neighbour's row of phi0 through nbr. phi0 is read-only, so no
// plane-pack pass is needed. The correction keeps the expression
// pf + 0.5f*(phi0 - pb) with explicit round-to-nearest ops; 0.5*x is exact
// and min, max and clip are exact, so the kernel is bitwise equal to its
// plain PyTorch version.
//
// What bounds it on the H100: memory. It reads phi0, pf and pb once and
// writes out once: 16 B per voxel and field (the 64-value face planes of
// the neighbours are another 6*64*4 B per tile, mostly L2 hits).
#include "common.cuh"

namespace hn {

__global__ void __launch_bounds__(TILE)
bfecc_tail_kernel(const float* __restrict__ phi0, const float* __restrict__ pf,
                  const float* __restrict__ pb, const int* __restrict__ nbr,
                  float* __restrict__ out, int T) {
  __shared__ float s[TILE];
  __shared__ int face[6];
  const int t = blockIdx.x;
  const int f = blockIdx.y;
  const int c = threadIdx.x;
  const size_t field = (size_t)f * T * TILE;
  const size_t self = field + (size_t)t * TILE + c;
  const float phi = phi0[self];
  s[c] = phi;
  if (c < 6) {
    const int d[6] = {D_PX, D_MX, D_PY, D_MY, D_PZ, D_MZ};
    face[c] = nbr[(size_t)t * 27 + d[c]];
  }
  __syncthreads();

  const int cx = c >> 6, cy = (c >> 3) & 7, cz = c & 7;
  // a cross-tile face reads the neighbour row's voxel on the touching plane
  // (the coordinate wrapped mod 8); an in-tile face reads shared memory
  const float* f0 = phi0 + field;
  float v[6];
  v[0] = (cx == 7) ? f0[(size_t)face[0] * TILE + c - 448] : s[cx == 7 ? c : c + 64];
  v[1] = (cx == 0) ? f0[(size_t)face[1] * TILE + c + 448] : s[cx == 0 ? c : c - 64];
  v[2] = (cy == 7) ? f0[(size_t)face[2] * TILE + c - 56] : s[cy == 7 ? c : c + 8];
  v[3] = (cy == 0) ? f0[(size_t)face[3] * TILE + c + 56] : s[cy == 0 ? c : c - 8];
  v[4] = (cz == 7) ? f0[(size_t)face[4] * TILE + c - 7] : s[cz == 7 ? c : c + 1];
  v[5] = (cz == 0) ? f0[(size_t)face[5] * TILE + c + 7] : s[cz == 0 ? c : c - 1];

  const float p_f = pf[self];
  float lo = fminf(phi, p_f), hi = fmaxf(phi, p_f);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    lo = fminf(lo, v[k]);
    hi = fmaxf(hi, v[k]);
  }
  const float corr = add(p_f, mul(0.5f, sub(phi, pb[self])));
  out[self] = clampf(corr, lo, hi);
}

}  // namespace hn

// phi0, pf, pb, out: [F, T, 512] f32; nbr [T, 27] i32.
extern "C" int hn_bfecc_tail(const void* phi0, const void* pf, const void* pb,
                             const void* nbr, void* out, int F, int T, void* stream) {
  if (F <= 0 || T <= 0 || F > 65535) return (int)cudaErrorInvalidValue;
  hn::bfecc_tail_kernel<<<dim3(T, F), hn::TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(phi0), static_cast<const float*>(pf),
      static_cast<const float*>(pb), static_cast<const int*>(nbr),
      static_cast<float*>(out), T);
  return (int)cudaGetLastError();
}
