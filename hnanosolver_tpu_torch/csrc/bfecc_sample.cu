// B1: fused BFECC sampling, one launch per advection pass, in two forms
// that share one body and one trilinear sample (trilinear.cuh):
//   - the nbr form (hn_bfecc_sample): corners read through the tile's 27
//     nbr entries, valid for every clamped displacement;
//   - the dual-table form (hn_bfecc_sample_dual, hn_sample_dual): corners
//     read from the chunk's half-shifted dual table (ops/tables.py, built
//     by build_table_dual or by kernel B11), valid while every corner lies
//     within 4 voxels of the tile.
//
// Replaces hnanosolver_tpu/ops/pallas_bfecc.py::_make_kernel (built by
// _build, entry bfecc_sample_fused), the TPU megakernel that samples through
// VMEM chunk tables with one-hot MXU contractions over 16^3 or 24^3 windows;
// the dual form is its use_dual instance (the 16^3 window on the dual
// table) in the modes "both", "back" and "fwd".
//
// Per voxel x of tile t (one thread per voxel, one 512-thread block per tile):
//   d   = clamp(-u(x) * sdt, +-lim)                 back trace
//   phiF_f = trilinear(field f, x + d)   for f in [0, nb)
//   d2  = clamp(d + phiF_{0..2} * sdt, +-lim)       re-trace from u(back)
//   phiB_f = trilinear(field f, x + d2)  for f in [f_lo, nb)
//   out[j] = phiF_{f_lo+j}, out[nb-f_lo+j] = phiB_{f_lo+j}
// fields[0:3] are the velocity components. Velocity mode: nb = 3, f_lo = 0
// (the back samples are both u(back) and phiF). Scalar mode: nb = 3 + n,
// f_lo = 3. The split passes of the dual form ("back": d from u as above;
// "fwd": d given) sample fields [lo, lo + n) at x + d, one output each.
//
// With a collision SDF (pallas_bfecc.py:391-399,420-426): the SDF is
// probed, never advected. sdf(x + d) < 0 (the back trace entered the solid)
// sets d = 0 before the back samples; sdf(x + d2) < 0 (the re-trace entered
// it) sets d2 = d before the forward samples. Each probe is its own
// trilinear sample at that position. In the nbr form the SDF is its own
// [T, 512] array; in the dual form it is the table's last field. The
// HAS_SDF = false instances have no probe.
//
// What bounds it on the H100: memory. Each voxel reads its nb fields once
// and writes 2*(nb - f_lo) outputs (72 B/voxel in scalar mode with 5
// scalars); its 16*nb corner reads fall inside 27 neighbouring tile rows
// (nbr form) or 8 dual rows (dual form) and are served by L1/L2. The simple
// design: stage the tile's 27 nbr (or 8 ldual) entries in shared memory,
// read corners through the read-only cache (__ldg), keep all per-field sums
// in registers (NB is a template parameter), no shared-memory staging of
// field data yet.
#include "trilinear.cuh"

namespace hn {

// The fused pair (back sample, re-trace, forward sample) from the back
// displacement d; fc reads the fields, sc the SDF (HAS_SDF only).
template <int NB, int FLO, bool HAS_SDF, class Corners>
__device__ __forceinline__ void fused_pair(const Corners& fc, const Corners& sc, int cx,
                                           int cy, int cz, float dx, float dy, float dz,
                                           float sdt, float lim, float* __restrict__ out,
                                           size_t plane, size_t self) {
  if constexpr (HAS_SDF) {
    float probe[1];
    sample<0, 1>(sc, cx, cy, cz, dx, dy, dz, probe);
    if (probe[0] < 0.0f) dx = dy = dz = 0.0f;
  }

  float back[NB];
  sample<0, NB>(fc, cx, cy, cz, dx, dy, dz, back);
  float d2x = clampf(add(dx, mul(back[0], sdt)), -lim, lim);
  float d2y = clampf(add(dy, mul(back[1], sdt)), -lim, lim);
  float d2z = clampf(add(dz, mul(back[2], sdt)), -lim, lim);
  if constexpr (HAS_SDF) {
    float probe[1];
    sample<0, 1>(sc, cx, cy, cz, d2x, d2y, d2z, probe);
    if (probe[0] < 0.0f) {
      d2x = dx;
      d2y = dy;
      d2z = dz;
    }
  }
  constexpr int NO = NB - FLO;
  float fwd[NO];
  sample<FLO, NB>(fc, cx, cy, cz, d2x, d2y, d2z, fwd);

#pragma unroll
  for (int j = 0; j < NO; ++j) {
    out[j * plane + self] = back[FLO + j];
    out[(NO + j) * plane + self] = fwd[j];
  }
}

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
  const float dx = clampf(mul(-fields[self], sdt), -lim, lim);
  const float dy = clampf(mul(-fields[plane + self], sdt), -lim, lim);
  const float dz = clampf(mul(-fields[2 * plane + self], sdt), -lim, lim);
  fused_pair<NB, FLO, HAS_SDF>(NbrCorners{fields, plane, snbr}, NbrCorners{sdf, plane, snbr},
                               c >> 6, (c >> 3) & 7, c & 7, dx, dy, dz, sdt, lim, out, plane,
                               self);
}

// Dual form, mode "both". tbl [nc, Ud*nf, 512] with nf = NB (+1: the SDF
// last); tile t belongs to chunk t / C.
template <int NB, int FLO, bool HAS_SDF>
__global__ void __launch_bounds__(TILE)
bfecc_dual_kernel(const float* __restrict__ tbl, const int* __restrict__ ldual,
                  const float* __restrict__ vel, float* __restrict__ out, int T, int C, int Ud,
                  float sdt, float lim) {
  __shared__ int sdual[8];
  const int t = blockIdx.x;
  const int c = threadIdx.x;
  if (c < 8) sdual[c] = ldual[(size_t)t * 8 + c];
  __syncthreads();

  constexpr int NF = NB + (HAS_SDF ? 1 : 0);
  const float* chunk = tbl + (size_t)(t / C) * Ud * NF * TILE;
  const size_t plane = (size_t)T * TILE;
  const size_t self = (size_t)t * TILE + c;
  const float dx = clampf(mul(-vel[self], sdt), -lim, lim);
  const float dy = clampf(mul(-vel[plane + self], sdt), -lim, lim);
  const float dz = clampf(mul(-vel[2 * plane + self], sdt), -lim, lim);
  fused_pair<NB, FLO, HAS_SDF>(DualCorners{chunk, NF, sdual},
                               DualCorners{chunk + NB * TILE, NF, sdual}, c >> 6, (c >> 3) & 7,
                               c & 7, dx, dy, dz, sdt, lim, out, plane, self);
}

// Dual form, modes "back" (FROM_VEL: d = clamp(-vd * sdt)) and "fwd" (d =
// vd): fields [lo, lo + N) of a table of nf fields sampled at x + d.
template <int N, bool FROM_VEL>
__global__ void __launch_bounds__(TILE)
sample_dual_kernel(const float* __restrict__ tbl, const int* __restrict__ ldual,
                   const float* __restrict__ vd, float* __restrict__ out, int T, int C, int Ud,
                   int nf, int lo, float sdt, float lim) {
  __shared__ int sdual[8];
  const int t = blockIdx.x;
  const int c = threadIdx.x;
  if (c < 8) sdual[c] = ldual[(size_t)t * 8 + c];
  __syncthreads();

  const float* chunk = tbl + (size_t)(t / C) * Ud * nf * TILE + (size_t)lo * TILE;
  const size_t plane = (size_t)T * TILE;
  const size_t self = (size_t)t * TILE + c;
  float dx = vd[self], dy = vd[plane + self], dz = vd[2 * plane + self];
  if constexpr (FROM_VEL) {
    dx = clampf(mul(-dx, sdt), -lim, lim);
    dy = clampf(mul(-dy, sdt), -lim, lim);
    dz = clampf(mul(-dz, sdt), -lim, lim);
  }
  float acc[N];
  sample<0, N>(DualCorners{chunk, nf, sdual}, c >> 6, (c >> 3) & 7, c & 7, dx, dy, dz, acc);
#pragma unroll
  for (int j = 0; j < N; ++j) out[j * plane + self] = acc[j];
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

template <int NB, int FLO>
static cudaError_t launch_dual(const float* tbl, const int* ldual, const float* vel, float* out,
                               int T, int C, int Ud, bool has_sdf, float sdt, float lim,
                               cudaStream_t s) {
  if (has_sdf)
    bfecc_dual_kernel<NB, FLO, true><<<T, TILE, 0, s>>>(tbl, ldual, vel, out, T, C, Ud, sdt,
                                                        lim);
  else
    bfecc_dual_kernel<NB, FLO, false><<<T, TILE, 0, s>>>(tbl, ldual, vel, out, T, C, Ud, sdt,
                                                         lim);
  return cudaGetLastError();
}

template <int N>
static cudaError_t launch_pass(const float* tbl, const int* ldual, const float* vd, float* out,
                              int T, int C, int Ud, int nf, int lo, bool from_vel, float sdt,
                              float lim, cudaStream_t s) {
  if (from_vel)
    sample_dual_kernel<N, true><<<T, TILE, 0, s>>>(tbl, ldual, vd, out, T, C, Ud, nf, lo, sdt,
                                                   lim);
  else
    sample_dual_kernel<N, false><<<T, TILE, 0, s>>>(tbl, ldual, vd, out, T, C, Ud, nf, lo, sdt,
                                                    lim);
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

// Mode "both" of the dual form. tbl [nc, Ud*(nb+has_sdf), 8, 64] f32 (the
// SDF the last field), ldual [T, 8] i32, vel [3, T, 512] f32, out
// [2*(nb-f_lo), T, 512] f32; chunk size C = T / nc. (nb, f_lo) as
// hn_bfecc_sample.
extern "C" int hn_bfecc_sample_dual(const void* tbl, const void* ldual, const void* vel,
                                    void* out, int T, int C, int Ud, int nb, int f_lo,
                                    int has_sdf, float sdt, float lim, void* stream) {
  const float* tb = static_cast<const float*>(tbl);
  const int* ld = static_cast<const int*>(ldual);
  const float* v = static_cast<const float*>(vel);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool g = has_sdf != 0;
  if (T <= 0 || C <= 0 || Ud <= 0) return (int)cudaErrorInvalidValue;
  if (f_lo == 0 && nb == 3)
    return (int)hn::launch_dual<3, 0>(tb, ld, v, o, T, C, Ud, g, sdt, lim, s);
  if (f_lo != 3) return (int)cudaErrorInvalidValue;
  switch (nb) {
    case 4: return (int)hn::launch_dual<4, 3>(tb, ld, v, o, T, C, Ud, g, sdt, lim, s);
    case 5: return (int)hn::launch_dual<5, 3>(tb, ld, v, o, T, C, Ud, g, sdt, lim, s);
    case 6: return (int)hn::launch_dual<6, 3>(tb, ld, v, o, T, C, Ud, g, sdt, lim, s);
    case 7: return (int)hn::launch_dual<7, 3>(tb, ld, v, o, T, C, Ud, g, sdt, lim, s);
    case 8: return (int)hn::launch_dual<8, 3>(tb, ld, v, o, T, C, Ud, g, sdt, lim, s);
    case 9: return (int)hn::launch_dual<9, 3>(tb, ld, v, o, T, C, Ud, g, sdt, lim, s);
    case 10: return (int)hn::launch_dual<10, 3>(tb, ld, v, o, T, C, Ud, g, sdt, lim, s);
    case 11: return (int)hn::launch_dual<11, 3>(tb, ld, v, o, T, C, Ud, g, sdt, lim, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Modes "back" (from_vel = 1: vd is the velocity) and "fwd" (from_vel = 0:
// vd is the displacement) of the dual form. tbl [nc, Ud*nf, 8, 64] f32,
// ldual [T, 8] i32, vd [3, T, 512] f32, out [n, T, 512] f32 = fields
// [lo, lo + n) at x + d; 1 <= n <= 11, lo + n <= nf.
extern "C" int hn_sample_dual(const void* tbl, const void* ldual, const void* vd, void* out,
                              int T, int C, int Ud, int nf, int lo, int n, int from_vel,
                              float sdt, float lim, void* stream) {
  const float* tb = static_cast<const float*>(tbl);
  const int* ld = static_cast<const int*>(ldual);
  const float* v = static_cast<const float*>(vd);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fv = from_vel != 0;
  if (T <= 0 || C <= 0 || Ud <= 0 || lo < 0 || lo + n > nf) return (int)cudaErrorInvalidValue;
  switch (n) {
    case 1: return (int)hn::launch_pass<1>(tb, ld, v, o, T, C, Ud, nf, lo, fv, sdt, lim, s);
    case 2: return (int)hn::launch_pass<2>(tb, ld, v, o, T, C, Ud, nf, lo, fv, sdt, lim, s);
    case 3: return (int)hn::launch_pass<3>(tb, ld, v, o, T, C, Ud, nf, lo, fv, sdt, lim, s);
    case 4: return (int)hn::launch_pass<4>(tb, ld, v, o, T, C, Ud, nf, lo, fv, sdt, lim, s);
    case 5: return (int)hn::launch_pass<5>(tb, ld, v, o, T, C, Ud, nf, lo, fv, sdt, lim, s);
    case 6: return (int)hn::launch_pass<6>(tb, ld, v, o, T, C, Ud, nf, lo, fv, sdt, lim, s);
    case 7: return (int)hn::launch_pass<7>(tb, ld, v, o, T, C, Ud, nf, lo, fv, sdt, lim, s);
    case 8: return (int)hn::launch_pass<8>(tb, ld, v, o, T, C, Ud, nf, lo, fv, sdt, lim, s);
    case 9: return (int)hn::launch_pass<9>(tb, ld, v, o, T, C, Ud, nf, lo, fv, sdt, lim, s);
    case 10: return (int)hn::launch_pass<10>(tb, ld, v, o, T, C, Ud, nf, lo, fv, sdt, lim, s);
    case 11: return (int)hn::launch_pass<11>(tb, ld, v, o, T, C, Ud, nf, lo, fv, sdt, lim, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
