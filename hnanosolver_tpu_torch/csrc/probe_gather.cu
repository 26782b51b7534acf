// PG: cross-row gathers on [R, 512] f32 rows, in three forms.
//
// Replaces the in-kernel gathers of tools/probe_dgather.py, the JAX
// package's probe of whether a pressure solve could gather its cross-tile
// halo inside one kernel:
//   per-element  k_small (pallas_call :59):  out[i, c] = x[idx[i, c], c]
//   row          k_full  (pallas_call :79):  out[i, :] = x[idx[i], :]
//   chain        k_time  (pallas_call :109): s = x; reps times, for d = 0..5
//                in order, s = s + x[nbr6[d]] * 1e-30 (gathered from x, not s)
// ops/probe.py holds the plain versions. An index outside [0, rows of x)
// is clamped into it, so that no address outside x is formed.
//
// One warp per output row, 256-thread blocks (8 rows). A row is 128
// float4: each lane moves 4 of them with 16-byte loads and stores. The row
// and chain forms read whole source rows; the per-element form reads one
// float per column from the row its index names (4 scalar loads for each
// float4 of the output).
//
// The chain runs its reps inside one launch: every output element depends
// only on its own column of six source rows, so no grid barrier is needed.
// What stays on chip: at the bench (T = 4608) x is 9.4 MB and stays in the
// 50 MB L2 across the 6 * reps gathers, this card's counterpart of the
// TPU's VMEM-resident operand; each rep reads its rows from the L2 again. The multiply and the add are rounded apart
// (__fmul_rn, __fadd_rn, no FMA), in the plain version's order, so the
// chain is bitwise equal to it.
//
// What bounds it on the H100: memory. The row form reads the gathered rows
// and writes the output once (2 x 9.4 MB at the bench, 5.6 us over 3.35
// TB/s, about the cost of a launch); the chain reads 6 x 9.4 MB per rep
// from the L2.
#include "common.cuh"

namespace hn {

constexpr int VEC = TILE / 4;          // float4 per row
constexpr int GATHER_THREADS = 256;
constexpr int GATHER_ROWS = GATHER_THREADS / 32;  // rows per block
constexpr float CHAIN_SCALE = 1e-30f;

__device__ __forceinline__ int clamp_row(int r, int rows) { return min(max(r, 0), rows - 1); }

__global__ void __launch_bounds__(GATHER_THREADS)
take_along_rows_kernel(const float* __restrict__ x, const int4* __restrict__ idx,
                       float4* __restrict__ out, int R, int Rx) {
  const int i = blockIdx.x * GATHER_ROWS + threadIdx.x / 32;
  if (i >= R) return;
  for (int v = threadIdx.x % 32; v < VEC; v += 32) {
    const int4 r = idx[(size_t)i * VEC + v];
    const int c = 4 * v;
    float4 o;
    o.x = x[(size_t)clamp_row(r.x, Rx) * TILE + c];
    o.y = x[(size_t)clamp_row(r.y, Rx) * TILE + c + 1];
    o.z = x[(size_t)clamp_row(r.z, Rx) * TILE + c + 2];
    o.w = x[(size_t)clamp_row(r.w, Rx) * TILE + c + 3];
    out[(size_t)i * VEC + v] = o;
  }
}

__global__ void __launch_bounds__(GATHER_THREADS)
take_rows_kernel(const float4* __restrict__ x, const int* __restrict__ idx,
                 float4* __restrict__ out, int R, int Rx) {
  const int i = blockIdx.x * GATHER_ROWS + threadIdx.x / 32;
  if (i >= R) return;
  const float4* row = x + (size_t)clamp_row(idx[i], Rx) * VEC;
#pragma unroll
  for (int k = 0; k < VEC / 32; ++k) {
    const int v = threadIdx.x % 32 + 32 * k;
    out[(size_t)i * VEC + v] = row[v];
  }
}

__device__ __forceinline__ float chain_add(float s, float g) {
  return add(s, mul(g, CHAIN_SCALE));
}

// A load performed every time it is reached, from the L2 (ld.volatile: not
// kept in L1, never merged or hoisted). The chain's gathers are the same in
// every rep, and nvcc and ptxas would otherwise keep the rows in registers
// or L1 across reps: the probe times six gathers a rep, as a solve whose
// rows change every sweep must make them.
__device__ __forceinline__ float4 load_each_rep(const float4* p) {
  float4 v;
  asm volatile("ld.volatile.global.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__global__ void __launch_bounds__(GATHER_THREADS)
take_chain_kernel(const float4* __restrict__ x, const int* __restrict__ nbr6,
                  float4* __restrict__ out, int T, int reps) {
  const int t = blockIdx.x * GATHER_ROWS + threadIdx.x / 32;
  if (t >= T) return;
  const int lane = threadIdx.x % 32;
  float4 s[VEC / 32];
#pragma unroll
  for (int k = 0; k < VEC / 32; ++k) s[k] = x[(size_t)t * VEC + lane + 32 * k];
  const float4* nb[6];
#pragma unroll
  for (int d = 0; d < 6; ++d) nb[d] = x + (size_t)clamp_row(nbr6[(size_t)d * T + t], T) * VEC;
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int d = 0; d < 6; ++d) {
#pragma unroll
      for (int k = 0; k < VEC / 32; ++k) {
        const float4 g = load_each_rep(nb[d] + lane + 32 * k);
        s[k].x = chain_add(s[k].x, g.x);
        s[k].y = chain_add(s[k].y, g.y);
        s[k].z = chain_add(s[k].z, g.z);
        s[k].w = chain_add(s[k].w, g.w);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < VEC / 32; ++k) out[(size_t)t * VEC + lane + 32 * k] = s[k];
}

inline unsigned gather_blocks(int R) { return (unsigned)((R + GATHER_ROWS - 1) / GATHER_ROWS); }

}  // namespace hn

// x [Rx, 512] f32, idx [R, 512] i32, out [R, 512] f32.
extern "C" int hn_take_along_rows(const void* x, const void* idx, void* out, int R, int Rx,
                                  void* stream) {
  if (R <= 0 || Rx <= 0) return (int)cudaErrorInvalidValue;
  hn::take_along_rows_kernel<<<hn::gather_blocks(R), hn::GATHER_THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int4*>(idx), static_cast<float4*>(out), R,
      Rx);
  return (int)cudaGetLastError();
}

// x [Rx, 512] f32, idx [R] i32, out [R, 512] f32.
extern "C" int hn_take_rows(const void* x, const void* idx, void* out, int R, int Rx,
                            void* stream) {
  if (R <= 0 || Rx <= 0) return (int)cudaErrorInvalidValue;
  hn::take_rows_kernel<<<hn::gather_blocks(R), hn::GATHER_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const int*>(idx), static_cast<float4*>(out), R,
      Rx);
  return (int)cudaGetLastError();
}

// x, out [T, 512] f32, nbr6 [6, T] i32.
extern "C" int hn_take_chain(const void* x, const void* nbr6, void* out, int T, int reps,
                             void* stream) {
  if (T <= 0 || reps < 0) return (int)cudaErrorInvalidValue;
  hn::take_chain_kernel<<<hn::gather_blocks(T), hn::GATHER_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const int*>(nbr6), static_cast<float4*>(out), T,
      reps);
  return (int)cudaGetLastError();
}
