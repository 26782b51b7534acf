// B8/B9: trilinear samples of n fields at per-voxel displacements.
//
// Replaces hnanosolver_tpu/ops/pallas_interp2.py::_kernel (B8, built by
// _build, entry sample_tables: chunked unique-row VMEM tables and a
// hat-weight MXU contraction) and hnanosolver_tpu/ops/pallas_interp.py::
// _kernel (B9, built by _build, entry sample_fields_pallas: per-tile
// 27-row tables, same contraction). Both compute one function:
//   out_f(x) = trilinear(field f, x + d(x))   for f in [0, n)
// with d [3, T, 512] clamped by the caller to |d| < 7 voxels per axis
// (advection.DISP_LIMIT), so every corner lies in the tile's 3x3x3
// neighbourhood. Callers: the RK2-4 velocity stages, the SDF probes and the
// back and forward passes of RK advection (ops/advection.py).
//
// No tables and no contraction: one 512-thread block per tile, one thread
// per voxel; the tile's 27 nbr entries are staged in shared memory and each
// corner is read through them (trilinear.cuh, the sample B1 takes, so an RK
// pass samples exactly as B1 does). N is a template parameter (1..8) so the
// per-field sums stay in registers; the wrapper splits larger n into groups
// of 8, one launch each.
//
// What bounds it on the H100: memory. Each voxel reads its n fields and
// three displacements once and writes n samples: (8n + 12) B per voxel; its
// 8n corner reads fall in 27 neighbouring tile rows, served by L1/L2.
#include "trilinear.cuh"

namespace hn {

template <int N>
__global__ void __launch_bounds__(TILE)
sample_at_kernel(const float* __restrict__ fields, const float* __restrict__ d,
                 const int* __restrict__ nbr, float* __restrict__ out, int T) {
  __shared__ int snbr[27];
  const int t = blockIdx.x;
  const int c = threadIdx.x;
  if (c < 27) snbr[c] = nbr[(size_t)t * 27 + c];
  __syncthreads();

  const size_t plane = (size_t)T * TILE;
  const size_t self = (size_t)t * TILE + c;
  float acc[N];
  sample<0, N>(NbrCorners{fields, plane, snbr}, c >> 6, (c >> 3) & 7, c & 7, d[self],
               d[plane + self], d[2 * plane + self], acc);
#pragma unroll
  for (int j = 0; j < N; ++j) out[j * plane + self] = acc[j];
}

template <int N>
static cudaError_t launch(const float* fields, const float* d, const int* nbr, float* out,
                          int T, cudaStream_t s) {
  sample_at_kernel<N><<<T, TILE, 0, s>>>(fields, d, nbr, out, T);
  return cudaGetLastError();
}

}  // namespace hn

// fields [n, T, 512] f32, d [3, T, 512] f32, nbr [T, 27] i32,
// out [n, T, 512] f32; 1 <= n <= 8.
extern "C" int hn_sample_at(const void* fields, const void* d, const void* nbr, void* out,
                            int T, int n, void* stream) {
  const float* f = static_cast<const float*>(fields);
  const float* dd = static_cast<const float*>(d);
  const int* nb = static_cast<const int*>(nbr);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 0) return (int)cudaErrorInvalidValue;
  switch (n) {
    case 1: return (int)hn::launch<1>(f, dd, nb, o, T, s);
    case 2: return (int)hn::launch<2>(f, dd, nb, o, T, s);
    case 3: return (int)hn::launch<3>(f, dd, nb, o, T, s);
    case 4: return (int)hn::launch<4>(f, dd, nb, o, T, s);
    case 5: return (int)hn::launch<5>(f, dd, nb, o, T, s);
    case 6: return (int)hn::launch<6>(f, dd, nb, o, T, s);
    case 7: return (int)hn::launch<7>(f, dd, nb, o, T, s);
    case 8: return (int)hn::launch<8>(f, dd, nb, o, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
