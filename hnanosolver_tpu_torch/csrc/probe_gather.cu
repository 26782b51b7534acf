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
// Per-element form, two designs chosen by shape (ops/cuda_probe.py
// along_rows_form, passed in as `form`; a pure function of Rx):
//   slab (Rx <= SLAB_MAX_ROWS = 7,264)  output column c reads only column c
//     of x, so a block takes a slab of 8 columns (32 bytes of a row: one
//     sector) and half of the output rows (64 slabs x 2 = 128 blocks, one an
//     SM). It stages x[:, c0:c0+8] in shared memory with 16-byte cp.async
//     (Rx x 32 B: 147 KB at the bench's 4,608 rows), then 8 lanes a row read
//     idx's 32-byte run, gather from the slab and write out's 32-byte run.
//     Every global access is a whole sector: x is read once a row chunk, idx
//     and out once. Above 7,264 rows the slab does not fit a block's 227 KB.
//   direct (larger Rx)  one warp a row, 4 scalar loads from the rows the
//     index names for each float4 of the output: each 4-byte load pulls a
//     32-byte sector from the L2 (about 8x the bytes the function needs).
//
// Row form: one warp per output row, 256-thread blocks (8 rows); a row is
// 128 float4, each lane moves 4 of them with 16-byte loads and stores.
//
// Chain form: a block holds 6 output rows (a warp each) and first stages
// their six neighbour rows in shared memory (6 x 6 x 2 KB = 72 KB: three
// blocks an SM, 18 rows, so that the bench's 4,608 rows take 1.94 waves of
// 132 x 18); each lane copies, with 16-byte cp.async, the 4 float4 of each
// neighbour row that it alone reads back. Then the reps run inside the
// launch (every output element depends only on its column of six source
// rows: no grid barrier). Every rep gathers its six rows again, from shared
// memory with ld.volatile.shared: the TPU kernel gathers from its VMEM-
// resident x every rep, and the probe prices that gather, so the rows are
// never hoisted into registers. The multiply and the add are rounded apart
// (__fmul_rn, __fadd_rn, no FMA), in the plain version's order, so the chain
// is bitwise equal to it.
//
// What bounds each on the H100: the slab and row forms, memory (the row
// form reads the gathered rows and writes the output once: 2 x 9.4 MB at
// the bench, 5.6 us over 3.35 TB/s; the slab form adds x's sectors once, a
// third of that again); the chain, shared-memory bandwidth: 6 x 9.4 MB read
// from shared memory a rep (1.8 us a rep on an NVIDIA H100 80GB HBM3 at 700 W,
// chip_smoke phase 15; PERF.md), where the function itself,
// each product computed once, needs only x, nbr6 and out moved once and two
// f32 operations a value a gather. The chain stays under half of that bound
// by design: it keeps its six gathers a rep.
#include "common.cuh"

namespace hn {

constexpr int VEC = TILE / 4;          // float4 per row
constexpr int GATHER_THREADS = 256;
constexpr int GATHER_ROWS = GATHER_THREADS / 32;  // rows per block
constexpr float CHAIN_SCALE = 1e-30f;

// per-element slab form (ops/probe.py SLAB_COLS, SLAB_MAX_ROWS)
constexpr int SLAB = 8;                // columns a slab: 32 bytes of a row
constexpr int SLAB_THREADS = 1024;
constexpr int SLAB_ROW_CHUNKS = 2;     // 64 slabs x 2 = 128 blocks
constexpr int SLAB_UNROLL = 8;         // rows a thread has in flight
constexpr int MAX_SMEM = 227 * 1024;   // dynamic shared memory a block (H100)
constexpr int SLAB_MAX_ROWS = MAX_SMEM / (SLAB * 4);
enum AlongRowsForm { DIRECT = 0, SLAB_FORM = 1 };  // ops/cuda_probe.py ALONG_ROWS_FORMS

// chain form (ops/cuda_probe.py CHAIN_ROWS, chain_smem_bytes)
constexpr int CHAIN_ROWS = 6;
constexpr int CHAIN_THREADS = CHAIN_ROWS * 32;
constexpr int CHAIN_SMEM = CHAIN_ROWS * 6 * TILE * 4;

__device__ __forceinline__ int clamp_row(int r, int rows) { return min(max(r, 0), rows - 1); }

// 16 bytes from global to shared memory, through the L2 only
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// wait for this thread's cp.async copies: their data is then visible to it
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

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

// grid (TILE / SLAB, SLAB_ROW_CHUNKS); dynamic shared memory Rx * SLAB floats
__global__ void __launch_bounds__(SLAB_THREADS)
take_slab_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                 float* __restrict__ out, int R, int Rx) {
  extern __shared__ __align__(16) float slab[];  // [Rx, SLAB]
  const int c0 = blockIdx.x * SLAB;
  for (int k = threadIdx.x; k < 2 * Rx; k += blockDim.x) {
    const int r = k >> 1, h = (k & 1) * 4;
    cp_async16(slab + r * SLAB + h, x + (size_t)r * TILE + c0 + h);
  }
  cp_async_wait_all();
  __syncthreads();
  const int chunk = (R + gridDim.y - 1) / gridDim.y;
  const int i0 = blockIdx.y * chunk, i1 = min(R, i0 + chunk);
  const int j = threadIdx.x % SLAB;
  const int pass = blockDim.x / SLAB;  // rows a pass of the block
  for (int i = i0 + threadIdx.x / SLAB; i < i1; i += SLAB_UNROLL * pass) {
    int r[SLAB_UNROLL];
#pragma unroll
    for (int u = 0; u < SLAB_UNROLL; ++u) {
      const int iu = i + u * pass;
      r[u] = iu < i1 ? idx[(size_t)iu * TILE + c0 + j] : 0;
    }
#pragma unroll
    for (int u = 0; u < SLAB_UNROLL; ++u) {
      const int iu = i + u * pass;
      if (iu < i1) out[(size_t)iu * TILE + c0 + j] = slab[clamp_row(r[u], Rx) * SLAB + j];
    }
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

// A shared-memory load performed every time it is reached (ld.volatile:
// never merged or hoisted). The chain's gathers are the same in every rep,
// and nvcc and ptxas would otherwise keep the rows in registers across
// reps: the probe times six gathers a rep, as a solve whose rows change
// every sweep must make them.
__device__ __forceinline__ float4 load_each_rep(uint32_t addr) {
  float4 v;
  asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// dynamic shared memory CHAIN_SMEM: [CHAIN_ROWS][6][VEC] float4
__global__ void __launch_bounds__(CHAIN_THREADS)
take_chain_kernel(const float4* __restrict__ x, const int* __restrict__ nbr6,
                  float4* __restrict__ out, int T, int reps) {
  extern __shared__ __align__(16) float4 faces[];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = blockIdx.x * CHAIN_ROWS + w;
  if (t >= T) return;  // no block-wide barrier below
  float4* mine = faces + (size_t)w * 6 * VEC;
#pragma unroll
  for (int d = 0; d < 6; ++d) {
    const float4* row = x + (size_t)clamp_row(nbr6[(size_t)d * T + t], T) * VEC;
#pragma unroll
    for (int k = 0; k < VEC / 32; ++k)
      cp_async16(mine + d * VEC + lane + 32 * k, row + lane + 32 * k);
  }
  float4 s[VEC / 32];
#pragma unroll
  for (int k = 0; k < VEC / 32; ++k) s[k] = x[(size_t)t * VEC + lane + 32 * k];
  cp_async_wait_all();  // each lane reads back only the float4 it copied
  const uint32_t base = smem_addr(mine + lane);
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int d = 0; d < 6; ++d) {
#pragma unroll
      for (int k = 0; k < VEC / 32; ++k) {
        const float4 g = load_each_rep(base + (uint32_t)(d * VEC + 32 * k) * 16);
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

SmemLimit slab_limit, chain_limit;

}  // namespace hn

// x [Rx, 512] f32, idx [R, 512] i32, out [R, 512] f32; form: hn::AlongRowsForm,
// chosen by the caller from Rx (the slab form only where Rx <= SLAB_MAX_ROWS).
extern "C" int hn_take_along_rows(const void* x, const void* idx, void* out, int R, int Rx,
                                  int form, void* stream) {
  if (R <= 0 || Rx <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == hn::DIRECT) {
    hn::take_along_rows_kernel<<<hn::gather_blocks(R), hn::GATHER_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int4*>(idx), static_cast<float4*>(out),
        R, Rx);
    return (int)cudaGetLastError();
  }
  if (form != hn::SLAB_FORM || Rx > hn::SLAB_MAX_ROWS) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)Rx * hn::SLAB * 4;
  cudaError_t e = hn::raise_smem_limit(hn::take_slab_kernel, smem, hn::slab_limit);
  if (e != cudaSuccess) return (int)e;
  hn::take_slab_kernel<<<dim3(hn::TILE / hn::SLAB, hn::SLAB_ROW_CHUNKS), hn::SLAB_THREADS, smem,
                         s>>>(static_cast<const float*>(x), static_cast<const int*>(idx),
                              static_cast<float*>(out), R, Rx);
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
  cudaError_t e = hn::raise_smem_limit(hn::take_chain_kernel, hn::CHAIN_SMEM, hn::chain_limit);
  if (e != cudaSuccess) return (int)e;
  hn::take_chain_kernel<<<(T + hn::CHAIN_ROWS - 1) / hn::CHAIN_ROWS, hn::CHAIN_THREADS,
                          hn::CHAIN_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const int*>(nbr6), static_cast<float4*>(out), T,
      reps);
  return (int)cudaGetLastError();
}
