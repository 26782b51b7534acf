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
// With a collision SDF (sdf != null; pallas_bfecc.py:391-399,420-426): the
// SDF is probed, never advected. sdf(x + d) < 0 (the back trace entered the
// solid) sets d = 0 before the back samples; sdf(x + d2) < 0 (the re-trace
// entered it) sets d2 = d before the forward samples. Each probe is its own
// trilinear sample at that position. Without an SDF the HAS_SDF = false
// instance is the kernel as it was before the SDF existed.
//
// The trilinear sample (trilinear.cuh, shared with B8/B9): floor and frac of
// c + d, weight (wx*wy)*wz, corners summed in (di, dj, dk) order. |d| <= lim
// < 7 keeps every corner inside the tile's 3x3x3 neighbourhood. The
// window-width dispatch of the TPU kernel (a VMEM limit) has no counterpart:
// one launch serves every CFL.
//
// What bounds it on the H100: memory. Each voxel reads its nb fields once
// from DRAM and writes 2*(nb - f_lo) outputs (72 B/voxel in scalar mode with
// 5 scalars); its 16*nb corner reads fall inside 27 neighbouring tile rows
// and are served by L1/L2. The simple design: stage the tile's 27 nbr
// entries in shared memory, read corners through the read-only cache
// (__ldg), keep all per-field sums in registers (NB is a template
// parameter), no shared-memory staging of field data yet.
#include "trilinear.cuh"

namespace hn {

template <int NB, int FLO, bool HAS_SDF>
__global__ void __launch_bounds__(TILE)
bfecc_sample_kernel(const float* __restrict__ fields, const float* __restrict__ sdf,
                    const int* __restrict__ nbr, float* __restrict__ out, int T, float sdt,
                    float lim) {
  __shared__ int snbr[27];
  const int t = blockIdx.x;
  const int c = threadIdx.x;
  if (c < 27) snbr[c] = nbr[(size_t)t * 27 + c];
  __syncthreads();

  const size_t plane = (size_t)T * TILE;
  const size_t self = (size_t)t * TILE + c;
  const int cx = c >> 6, cy = (c >> 3) & 7, cz = c & 7;
  float dx = clampf(mul(-fields[self], sdt), -lim, lim);
  float dy = clampf(mul(-fields[plane + self], sdt), -lim, lim);
  float dz = clampf(mul(-fields[2 * plane + self], sdt), -lim, lim);
  if constexpr (HAS_SDF) {
    float probe[1];
    sample<0, 1>(sdf, plane, snbr, cx, cy, cz, dx, dy, dz, probe);
    if (probe[0] < 0.0f) dx = dy = dz = 0.0f;
  }

  float back[NB];
  sample<0, NB>(fields, plane, snbr, cx, cy, cz, dx, dy, dz, back);
  float d2x = clampf(add(dx, mul(back[0], sdt)), -lim, lim);
  float d2y = clampf(add(dy, mul(back[1], sdt)), -lim, lim);
  float d2z = clampf(add(dz, mul(back[2], sdt)), -lim, lim);
  if constexpr (HAS_SDF) {
    float probe[1];
    sample<0, 1>(sdf, plane, snbr, cx, cy, cz, d2x, d2y, d2z, probe);
    if (probe[0] < 0.0f) {
      d2x = dx;
      d2y = dy;
      d2z = dz;
    }
  }
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
static cudaError_t launch(const float* fields, const float* sdf, const int* nbr, float* out,
                          int T, float sdt, float lim, cudaStream_t s) {
  if (sdf == nullptr)
    bfecc_sample_kernel<NB, FLO, false><<<T, TILE, 0, s>>>(fields, sdf, nbr, out, T, sdt, lim);
  else
    bfecc_sample_kernel<NB, FLO, true><<<T, TILE, 0, s>>>(fields, sdf, nbr, out, T, sdt, lim);
  return cudaGetLastError();
}

}  // namespace hn

// fields [nb, T, 512] f32, sdf [T, 512] f32 or null (no collision SDF),
// nbr [T, 27] i32, out [2*(nb-f_lo), T, 512] f32.
// Supported: (nb, f_lo) = (3, 0), or f_lo = 3 with 1..8 scalars.
extern "C" int hn_bfecc_sample(const void* fields, const void* sdf, const void* nbr, void* out,
                               int T, int nb, int f_lo, float sdt, float lim, void* stream) {
  const float* f = static_cast<const float*>(fields);
  const float* g = static_cast<const float*>(sdf);
  const int* n = static_cast<const int*>(nbr);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 0) return (int)cudaErrorInvalidValue;
  if (f_lo == 0 && nb == 3) return (int)hn::launch<3, 0>(f, g, n, o, T, sdt, lim, s);
  if (f_lo != 3) return (int)cudaErrorInvalidValue;
  switch (nb) {
    case 4: return (int)hn::launch<4, 3>(f, g, n, o, T, sdt, lim, s);
    case 5: return (int)hn::launch<5, 3>(f, g, n, o, T, sdt, lim, s);
    case 6: return (int)hn::launch<6, 3>(f, g, n, o, T, sdt, lim, s);
    case 7: return (int)hn::launch<7, 3>(f, g, n, o, T, sdt, lim, s);
    case 8: return (int)hn::launch<8, 3>(f, g, n, o, T, sdt, lim, s);
    case 9: return (int)hn::launch<9, 3>(f, g, n, o, T, sdt, lim, s);
    case 10: return (int)hn::launch<10, 3>(f, g, n, o, T, sdt, lim, s);
    case 11: return (int)hn::launch<11, 3>(f, g, n, o, T, sdt, lim, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
