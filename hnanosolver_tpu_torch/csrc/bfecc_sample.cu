// B1: fused BFECC sampling, one launch per advection pass.
//
// Replaces hnanosolver_tpu/ops/pallas_bfecc.py::_make_kernel (built by
// _build, entry bfecc_sample_fused), the TPU megakernel that samples through
// VMEM chunk tables with one-hot MXU contractions over 16^3 or 24^3 windows.
//
// Per voxel x of tile t (one thread per voxel, one 512-thread block per tile):
//   d   = clamp(-u(x) * sdt, +-lim)                 back trace
//   phiF_f = trilinear(field f, x + d)   for f in [0, nb)
//   d2  = clamp(d + phiF_{0..2} * sdt, +-lim)       re-trace from u(back)
//   phiB_f = trilinear(field f, x + d2)  for f in [f_lo, nb)
//   out[j] = phiF_{f_lo+j}, out[nb-f_lo+j] = phiB_{f_lo+j}
// fields[0:3] are the velocity components. Velocity mode: nb = 3, f_lo = 0
// (the back samples are both u(back) and phiF). Scalar mode: nb = 3 + n,
// f_lo = 3.
//
// Trilinear weights as advection._corners: floor and frac of c + d, weight
// (wx*wy)*wz, corners summed in (di, dj, dk) order. |d| <= lim < 7 keeps every
// corner coordinate in [-8, 15], inside the tile's 3x3x3 neighbourhood, so a
// corner is read straight from its tile row nbr[t, (qx+8)>>3 ...] (the null
// row 0 where the neighbour is absent). The window-width dispatch of the TPU
// kernel (a VMEM limit) has no counterpart: one launch serves every CFL.
//
// What bounds it on the H100: memory. Each voxel reads its nb fields once
// from DRAM and writes 2*(nb - f_lo) outputs (72 B/voxel in scalar mode with
// 5 scalars); its 16*nb corner reads fall inside 27 neighbouring tile rows
// and are served by L1/L2. The simple design: stage the tile's 27 nbr
// entries in shared memory, read corners through the read-only cache
// (__ldg), keep all per-field sums in registers (NB is a template
// parameter), no shared-memory staging of field data yet.
#include "common.cuh"

namespace hn {

template <int LO, int NB>
__device__ __forceinline__ void sample(const float* __restrict__ fields, size_t plane,
                                       const int* snbr, int cx, int cy, int cz,
                                       float dx, float dy, float dz, float* acc) {
  const float lx = add((float)cx, dx);
  const float ly = add((float)cy, dy);
  const float lz = add((float)cz, dz);
  const float bx = floorf(lx), by = floorf(ly), bz = floorf(lz);
  const float fx = sub(lx, bx), fy = sub(ly, by), fz = sub(lz, bz);
  const float ix = sub(1.0f, fx), iy = sub(1.0f, fy), iz = sub(1.0f, fz);
  const int ibx = (int)bx, iby = (int)by, ibz = (int)bz;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int di = k >> 2, dj = (k >> 1) & 1, dk = k & 1;
    const float w = mul(mul(di ? fx : ix, dj ? fy : iy), dk ? fz : iz);
    const int qx = ibx + di, qy = iby + dj, qz = ibz + dk;
    const int row = snbr[((qx + 8) >> 3) * 9 + ((qy + 8) >> 3) * 3 + ((qz + 8) >> 3)];
    const size_t off = (size_t)row * TILE + (qx & 7) * 64 + (qy & 7) * 8 + (qz & 7);
#pragma unroll
    for (int f = LO; f < NB; ++f) {
      const float v = mul(__ldg(fields + f * plane + off), w);
      acc[f - LO] = (k == 0) ? v : add(acc[f - LO], v);
    }
  }
}

template <int NB, int FLO>
__global__ void __launch_bounds__(TILE)
bfecc_sample_kernel(const float* __restrict__ fields, const int* __restrict__ nbr,
                    float* __restrict__ out, int T, float sdt, float lim) {
  __shared__ int snbr[27];
  const int t = blockIdx.x;
  const int c = threadIdx.x;
  if (c < 27) snbr[c] = nbr[(size_t)t * 27 + c];
  __syncthreads();

  const size_t plane = (size_t)T * TILE;
  const size_t self = (size_t)t * TILE + c;
  const int cx = c >> 6, cy = (c >> 3) & 7, cz = c & 7;
  const float dx = clampf(mul(-fields[self], sdt), -lim, lim);
  const float dy = clampf(mul(-fields[plane + self], sdt), -lim, lim);
  const float dz = clampf(mul(-fields[2 * plane + self], sdt), -lim, lim);

  float back[NB];
  sample<0, NB>(fields, plane, snbr, cx, cy, cz, dx, dy, dz, back);
  const float d2x = clampf(add(dx, mul(back[0], sdt)), -lim, lim);
  const float d2y = clampf(add(dy, mul(back[1], sdt)), -lim, lim);
  const float d2z = clampf(add(dz, mul(back[2], sdt)), -lim, lim);
  constexpr int NO = NB - FLO;
  float fwd[NO];
  sample<FLO, NB>(fields, plane, snbr, cx, cy, cz, d2x, d2y, d2z, fwd);

#pragma unroll
  for (int j = 0; j < NO; ++j) {
    out[j * plane + self] = back[FLO + j];
    out[(NO + j) * plane + self] = fwd[j];
  }
}

template <int NB, int FLO>
static cudaError_t launch(const float* fields, const int* nbr, float* out, int T,
                          float sdt, float lim, cudaStream_t s) {
  bfecc_sample_kernel<NB, FLO><<<T, TILE, 0, s>>>(fields, nbr, out, T, sdt, lim);
  return cudaGetLastError();
}

}  // namespace hn

// fields [nb, T, 512] f32, nbr [T, 27] i32, out [2*(nb-f_lo), T, 512] f32.
// Supported: (nb, f_lo) = (3, 0), or f_lo = 3 with 1..8 scalars.
extern "C" int hn_bfecc_sample(const void* fields, const void* nbr, void* out, int T,
                               int nb, int f_lo, float sdt, float lim, void* stream) {
  const float* f = static_cast<const float*>(fields);
  const int* n = static_cast<const int*>(nbr);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 0) return (int)cudaErrorInvalidValue;
  if (f_lo == 0 && nb == 3) return (int)hn::launch<3, 0>(f, n, o, T, sdt, lim, s);
  if (f_lo != 3) return (int)cudaErrorInvalidValue;
  switch (nb) {
    case 4: return (int)hn::launch<4, 3>(f, n, o, T, sdt, lim, s);
    case 5: return (int)hn::launch<5, 3>(f, n, o, T, sdt, lim, s);
    case 6: return (int)hn::launch<6, 3>(f, n, o, T, sdt, lim, s);
    case 7: return (int)hn::launch<7, 3>(f, n, o, T, sdt, lim, s);
    case 8: return (int)hn::launch<8, 3>(f, n, o, T, sdt, lim, s);
    case 9: return (int)hn::launch<9, 3>(f, n, o, T, sdt, lim, s);
    case 10: return (int)hn::launch<10, 3>(f, n, o, T, sdt, lim, s);
    case 11: return (int)hn::launch<11, 3>(f, n, o, T, sdt, lim, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
