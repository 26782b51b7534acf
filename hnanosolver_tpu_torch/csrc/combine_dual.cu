// B11: the dual (half-shifted) chunk table, built from the 27-table.
//
// Replaces hnanosolver_tpu/ops/pallas_bfecc.py::_combine_dual_kernel
// (entry build_table_dual_combine), which copies each dual row's 8 source
// rows out of the chunk's 27-table in VMEM (chunk_dloc indirection) and
// places their octants with a per-axis roll-and-select ladder. That ladder
// is a fixed gather, written here as the gather it is:
//   out[c, u*nf + f, l] = tbl27[c, dloc[c, u, j(l)]*nf + f, l ^ 292]
// with l = x*64 + y*8 + z, j(l) = (x>=4)*4 + (y>=4)*2 + (z>=4), and
// l ^ 292 = (x^4, y^4, z^4): the voxel of source j that dual voxel l is.
//
// One 512-thread block per dual row (c, u), one thread per column; the
// row's 8 dloc entries are staged in shared memory and the block loops over
// the nf fields, so each write is one coalesced 2 KB row. A read takes 64
// consecutive floats of one source row per 64-lane group.
//
// What bounds it on the H100: memory. It reads each output value once from
// the 27-table and writes it once: 2 * 4 B per output value, no arithmetic.
#include "common.cuh"

namespace hn {

__global__ void __launch_bounds__(TILE)
combine_dual_kernel(const float* __restrict__ tbl27, const int* __restrict__ dloc,
                    float* __restrict__ out, int U, int Ud, int nf) {
  __shared__ int sloc[8];
  const int row = blockIdx.x;  // c * Ud + u
  const int c = row / Ud;
  const int l = threadIdx.x;
  if (l < 8) sloc[l] = dloc[(size_t)row * 8 + l];
  __syncthreads();

  const int j = ((l >> 6) >= 4) * 4 + (((l >> 3) & 7) >= 4) * 2 + ((l & 7) >= 4);
  const float* src = tbl27 + ((size_t)c * U + sloc[j]) * nf * TILE + (l ^ 292);
  float* dst = out + (size_t)row * nf * TILE + l;
  for (int f = 0; f < nf; ++f) dst[(size_t)f * TILE] = __ldg(src + (size_t)f * TILE);
}

}  // namespace hn

// tbl27 [nc, U*nf, 8, 64] f32, dloc [nc, Ud, 8] i32 (positions in [0, U)),
// out [nc, Ud*nf, 8, 64] f32.
extern "C" int hn_combine_dual(const void* tbl27, const void* dloc, void* out, int nc, int U,
                               int Ud, int nf, void* stream) {
  if (nc <= 0 || U <= 0 || Ud <= 0 || nf <= 0) return (int)cudaErrorInvalidValue;
  hn::combine_dual_kernel<<<nc * Ud, hn::TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tbl27), static_cast<const int*>(dloc),
      static_cast<float*>(out), U, Ud, nf);
  return (int)cudaGetLastError();
}
