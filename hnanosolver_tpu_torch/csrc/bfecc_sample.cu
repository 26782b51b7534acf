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
// Per voxel x of tile t:
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
// (nbr form) or 8 dual rows (dual form) and are served by L1/L2. Both forms
// stage the tile's 27 nbr (or 8 ldual) entries in shared memory and read
// corners through the read-only cache (__ldg), per-field sums in registers
// (NB is a template parameter).
//
// A voxel's gathers form two dependent rounds (8*nb corner loads, the
// re-trace, 8*(nb - f_lo) more), so one voxel a thread left one chain of
// loads in flight a thread. Here a thread carries V voxels (c and c + 512/V
// of its tile, so that every warp-wide load still covers 32 consecutive
// voxels) through each phase together, and samples the velocity first: the
// re-trace needs only u at the back trace, so its clamp and probe come
// before the scalar samples, and the back and forward scalar samples of all
// V voxels are then independent chains. V = 2 in blocks of 256 threads, or
// V = 1 in blocks of 512 where the SDF probes add two samples a voxel;
// __launch_bounds__ caps the registers at 64 a thread, so that 32 warps stay
// resident on an SM. The dual form's mode "both" runs the same body in the
// same shape; its split modes ("back", "fwd": one sample a field) carry V = 4
// voxels a thread where they sample at most three fields, else V = 2
// (PassShape). Each field of each voxel still goes through
// trilinear.cuh::sample with the same arguments, so each result is the same
// float as before, bitwise.
//
// The dual form was also built the other way, as a staged kernel: a block
// of G tiles deduping its dual rows and streaming them through shared memory
// by bulk asynchronous copies. It lost to this shape at every launch shape
// tried (PERF.md, section 6): one field a copy ran at the copy engine's rate of
// ~60 ns a 2 KB copy an SM, three fields a copy left too few warps resident
// beside the stages, and its per-field corner sums cost more instructions
// than the gathers they replaced. The table is three times the L2 at the
// bench, yet with the table in the L2 a launch is only 13-25% faster: the
// gathers' latency and issue, not HBM, are what bound it.
#include "trilinear.cuh"

namespace hn {

// The launch shape of the nbr form and of the dual form's mode "both": V
// voxels a thread, blocks of TILE / V threads (a tile), 2 * V blocks
// resident an SM (64 registers a thread, 32 warps). V = 2, or 1 with the
// SDF probes: their two extra samples a voxel make a thread of two voxels
// spill.
template <bool HAS_SDF>
struct NbrShape {
  static constexpr int V = HAS_SDF ? 1 : 2;
  static constexpr int THREADS = TILE / V;
  static constexpr int MIN_BLOCKS = 2 * V;
};

// The fused pairs (back sample, re-trace, forward sample) of V voxels from
// their back displacements d, phase by phase across the V voxels; fc reads
// the fields, sc the SDF (HAS_SDF only). Voxel v is (cx[v], cy[v], cz[v])
// of its tile and writes out[j * plane + self[v]].
template <int V, int NB, int FLO, bool HAS_SDF, class Corners>
__device__ __forceinline__ void fused_pairs(const Corners& fc, const Corners& sc,
                                            const int (&cx)[V], const int (&cy)[V],
                                            const int (&cz)[V], float (&dx)[V],
                                            float (&dy)[V], float (&dz)[V], float sdt,
                                            float lim, float* __restrict__ out, size_t plane,
                                            const size_t (&self)[V]) {
  if constexpr (HAS_SDF) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float probe[1];
      sample<0, 1>(sc, cx[v], cy[v], cz[v], dx[v], dy[v], dz[v], probe);
      if (probe[0] < 0.0f) dx[v] = dy[v] = dz[v] = 0.0f;
    }
  }

  // the velocity at the back trace first: the re-trace needs only it
  float uv[V][3];
#pragma unroll
  for (int v = 0; v < V; ++v)
    sample<0, 3>(fc, cx[v], cy[v], cz[v], dx[v], dy[v], dz[v], uv[v]);
  float d2x[V], d2y[V], d2z[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    d2x[v] = clampf(add(dx[v], mul(uv[v][0], sdt)), -lim, lim);
    d2y[v] = clampf(add(dy[v], mul(uv[v][1], sdt)), -lim, lim);
    d2z[v] = clampf(add(dz[v], mul(uv[v][2], sdt)), -lim, lim);
  }
  if constexpr (HAS_SDF) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float probe[1];
      sample<0, 1>(sc, cx[v], cy[v], cz[v], d2x[v], d2y[v], d2z[v], probe);
      if (probe[0] < 0.0f) {
        d2x[v] = dx[v];
        d2y[v] = dy[v];
        d2z[v] = dz[v];
      }
    }
  }
  constexpr int NO = NB - FLO;
  float back[V][NO], fwd[V][NO];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if constexpr (FLO == 0) {
#pragma unroll
      for (int j = 0; j < NO; ++j) back[v][j] = uv[v][j];
    } else {
      sample<FLO, NB>(fc, cx[v], cy[v], cz[v], dx[v], dy[v], dz[v], back[v]);
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v)
    sample<FLO, NB>(fc, cx[v], cy[v], cz[v], d2x[v], d2y[v], d2z[v], fwd[v]);

#pragma unroll
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      out[j * plane + self[v]] = back[v][j];
      out[(NO + j) * plane + self[v]] = fwd[v][j];
    }
  }
}

// The back displacement clamp(-u * sdt, +-lim) of voxel `self` from the
// velocity rows (3 planes `plane` floats apart).
__device__ __forceinline__ void back_disp(const float* __restrict__ vel, size_t plane,
                                          size_t self, float sdt, float lim, float& dx,
                                          float& dy, float& dz) {
  dx = clampf(mul(-vel[self], sdt), -lim, lim);
  dy = clampf(mul(-vel[plane + self], sdt), -lim, lim);
  dz = clampf(mul(-vel[2 * plane + self], sdt), -lim, lim);
}

template <int NB, int FLO, bool HAS_SDF>
__global__ void __launch_bounds__(NbrShape<HAS_SDF>::THREADS, NbrShape<HAS_SDF>::MIN_BLOCKS)
bfecc_sample_kernel(const float* __restrict__ fields, const float* __restrict__ sdf,
                    const int* __restrict__ nbr, float* __restrict__ out, int T, float sdt,
                    float lim) {
  __shared__ int snbr[27];
  const int t = blockIdx.x;
  if (threadIdx.x < 27) snbr[threadIdx.x] = nbr[(size_t)t * 27 + threadIdx.x];
  __syncthreads();

  constexpr int V = NbrShape<HAS_SDF>::V;
  const size_t plane = (size_t)T * TILE;
  int cx[V], cy[V], cz[V];
  size_t self[V];
  float dx[V], dy[V], dz[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = threadIdx.x + v * NbrShape<HAS_SDF>::THREADS;
    cx[v] = c >> 6, cy[v] = (c >> 3) & 7, cz[v] = c & 7;
    self[v] = (size_t)t * TILE + c;
    back_disp(fields, plane, self[v], sdt, lim, dx[v], dy[v], dz[v]);
  }
  fused_pairs<V, NB, FLO, HAS_SDF>(NbrCorners{fields, plane, snbr},
                                   NbrCorners{sdf, plane, snbr}, cx, cy, cz, dx, dy, dz, sdt,
                                   lim, out, plane, self);
}

// The dual form's split modes' launch shape: V voxels a thread, blocks of
// TILE / V threads (a tile), 2 * V blocks resident an SM (32 warps at 64
// registers a thread). V = 4 for at most three fields, else 2: the faster
// of V = 1, 2 and 4 at the bench's three- and eight-field launches
// (tools/b1d_cost.py); at five fields V = 2 was ~2% slower than V = 1.
template <int N>
struct PassShape {
  static constexpr int V = N <= 3 ? 4 : 2;
  static constexpr int THREADS = TILE / V;
  static constexpr int MIN_BLOCKS = 2 * V;
};

// Dual form, mode "both". tbl [nc, Ud*nf, 512] with nf = NB (+1: the SDF
// last); tile t belongs to chunk t / C. B1's body in its shape.
template <int NB, int FLO, bool HAS_SDF>
__global__ void __launch_bounds__(NbrShape<HAS_SDF>::THREADS, NbrShape<HAS_SDF>::MIN_BLOCKS)
bfecc_dual_kernel(const float* __restrict__ tbl, const int* __restrict__ ldual,
                  const float* __restrict__ vel, float* __restrict__ out, int T, int C, int Ud,
                  float sdt, float lim) {
  __shared__ int sdual[8];
  const int t = blockIdx.x;
  if (threadIdx.x < 8) sdual[threadIdx.x] = ldual[(size_t)t * 8 + threadIdx.x];
  __syncthreads();

  constexpr int NF = NB + (HAS_SDF ? 1 : 0);
  constexpr int V = NbrShape<HAS_SDF>::V;
  const float* chunk = tbl + (size_t)(t / C) * Ud * NF * TILE;
  const size_t plane = (size_t)T * TILE;
  int cx[V], cy[V], cz[V];
  size_t self[V];
  float dx[V], dy[V], dz[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = threadIdx.x + v * NbrShape<HAS_SDF>::THREADS;
    cx[v] = c >> 6, cy[v] = (c >> 3) & 7, cz[v] = c & 7;
    self[v] = (size_t)t * TILE + c;
    back_disp(vel, plane, self[v], sdt, lim, dx[v], dy[v], dz[v]);
  }
  fused_pairs<V, NB, FLO, HAS_SDF>(DualCorners{chunk, NF, sdual},
                                   DualCorners{chunk + NB * TILE, NF, sdual}, cx, cy, cz, dx,
                                   dy, dz, sdt, lim, out, plane, self);
}

// Dual form, modes "back" (FROM_VEL: d = clamp(-vd * sdt)) and "fwd" (d =
// vd): fields [lo, lo + N) of a table of nf fields sampled at x + d, the V
// voxels' samples independent chains.
template <int N, bool FROM_VEL>
__global__ void __launch_bounds__(PassShape<N>::THREADS, PassShape<N>::MIN_BLOCKS)
sample_dual_kernel(const float* __restrict__ tbl, const int* __restrict__ ldual,
                   const float* __restrict__ vd, float* __restrict__ out, int T, int C, int Ud,
                   int nf, int lo, float sdt, float lim) {
  __shared__ int sdual[8];
  const int t = blockIdx.x;
  if (threadIdx.x < 8) sdual[threadIdx.x] = ldual[(size_t)t * 8 + threadIdx.x];
  __syncthreads();

  constexpr int V = PassShape<N>::V;
  const float* chunk = tbl + (size_t)(t / C) * Ud * nf * TILE + (size_t)lo * TILE;
  const size_t plane = (size_t)T * TILE;
  float acc[V][N];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = threadIdx.x + v * PassShape<N>::THREADS;
    const size_t self = (size_t)t * TILE + c;
    float dx = vd[self], dy = vd[plane + self], dz = vd[2 * plane + self];
    if constexpr (FROM_VEL) {
      dx = clampf(mul(-dx, sdt), -lim, lim);
      dy = clampf(mul(-dy, sdt), -lim, lim);
      dz = clampf(mul(-dz, sdt), -lim, lim);
    }
    sample<0, N>(DualCorners{chunk, nf, sdual}, c >> 6, (c >> 3) & 7, c & 7, dx, dy, dz,
                 acc[v]);
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const size_t self = (size_t)t * TILE + threadIdx.x + v * PassShape<N>::THREADS;
#pragma unroll
    for (int j = 0; j < N; ++j) out[j * plane + self] = acc[v][j];
  }
}

template <int NB, int FLO>
static cudaError_t launch(const float* fields, const float* sdf, const int* nbr, float* out,
                          int T, float sdt, float lim, cudaStream_t s) {
  if (sdf == nullptr)
    bfecc_sample_kernel<NB, FLO, false><<<T, NbrShape<false>::THREADS, 0, s>>>(
        fields, sdf, nbr, out, T, sdt, lim);
  else
    bfecc_sample_kernel<NB, FLO, true><<<T, NbrShape<true>::THREADS, 0, s>>>(
        fields, sdf, nbr, out, T, sdt, lim);
  return cudaGetLastError();
}

template <int NB, int FLO>
static cudaError_t launch_dual(const float* tbl, const int* ldual, const float* vel, float* out,
                               int T, int C, int Ud, bool has_sdf, float sdt, float lim,
                               cudaStream_t s) {
  if (has_sdf)
    bfecc_dual_kernel<NB, FLO, true><<<T, NbrShape<true>::THREADS, 0, s>>>(
        tbl, ldual, vel, out, T, C, Ud, sdt, lim);
  else
    bfecc_dual_kernel<NB, FLO, false><<<T, NbrShape<false>::THREADS, 0, s>>>(
        tbl, ldual, vel, out, T, C, Ud, sdt, lim);
  return cudaGetLastError();
}

template <int N>
static cudaError_t launch_pass(const float* tbl, const int* ldual, const float* vd, float* out,
                              int T, int C, int Ud, int nf, int lo, bool from_vel, float sdt,
                              float lim, cudaStream_t s) {
  if (from_vel)
    sample_dual_kernel<N, true><<<T, PassShape<N>::THREADS, 0, s>>>(
        tbl, ldual, vd, out, T, C, Ud, nf, lo, sdt, lim);
  else
    sample_dual_kernel<N, false><<<T, PassShape<N>::THREADS, 0, s>>>(
        tbl, ldual, vd, out, T, C, Ud, nf, lo, sdt, lim);
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
