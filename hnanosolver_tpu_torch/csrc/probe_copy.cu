// PC: asynchronous row copies into a shared-memory stage, one thread
// issuing bulk copies that complete on an mbarrier.
//
// Replaces the DMA probe kernels of the JAX package (tools/), which timed
// pltpu.make_async_copy for a pressure halo assembled on chip:
//   probe_dmabisect.py   run() :39 (v0-v5), v6 :164
//   probe_dmabisect2.py  v7 :59, v8 :81, v9 :113, v10 :149, v11 :184, v12 :222
//   probe_dmacost.py     make() :89, dyn_kernel :134
// ops/probe.py::row_copy defines the function and holds the plain version:
// copy i (0 <= i < n) of every rep writes source rows [s_i, s_i + span)
// into stage rows [(i * step * span) mod S, ... + span) of the S = 64-row
// stage; after each rep, acc += stage[r mod S][r mod 512]. The maps of the
// probes' variants:
//   v0, v4        one copy, rows [0, 8) -> stage [0, 8)
//   v1 / v1b      one copy of rows[0], span 8 / 1 -> stage row 0
//   v2, v9        copy i: row rows[i] -> stage row i (64 copies)
//   v3            copy i: row rows[i] -> stage row (3 i) mod 64 (step 3)
//   v5            no copy: the zeroed stage is read
//   v6, v10       as v1 / v9 from the on-chip source
//   v7            one copy of rows[0] -> stage row 0
//   v8            one copy of the 8-row block 8 q -> stage [0, 8)
//   v11, dyn      as v9 with n read on the device (count[0])
//   v12           copy i: row rows[i] -> stage row i mod 64, n = 512
//   dmacost       copy i: rows [rows[i], + span) -> stage (i span) mod 64
//
// The TPU kernels issue all n descriptors onto one semaphore, then drain
// them; overlapping slots there end with an unordered writer. Here the
// copies of a rep go in batches of at most S / span, and a batch completes
// on the mbarrier before the next one is issued, so every slot ends with
// its last writer's row (the order ops/probe.py fixes). With n <= S / span
// a rep is one batch, all its copies in flight together and drained once,
// as on the TPU: the probes time that case beside the batched one, to part
// the cost of issuing a copy from the cost of a drain.
//
// Mechanism, the Hopper counterpart of a DMA descriptor: one thread issues
// each copy as a 1-D bulk asynchronous copy (TMA),
//   device-memory source  cp.async.bulk.shared::cluster.global
//   on-chip source        cp.async.bulk.shared::cluster.shared::cta
// both .mbarrier::complete_tx::bytes, after arming the barrier with the
// batch's byte count; the block is launched as a cluster of one, which the
// shared-to-shared form needs. A row is 2 KB, so every span is 16-byte aligned and a
// multiple of 16 bytes. The on-chip source is rows [0, R) of src, staged
// by one bulk copy beside the stage (its row starts are taken mod
// R - span + 1); the rows table sits in shared memory too, reduced to
// source rows before the first copy, as the TPU kernels read it from SMEM.
// Shared memory per block: S + R rows of 2 KB, the table and the barrier,
// at most 227 KB (a 64-row stage takes 128 KB; probe_dmacost.py's 2056-row
// stage does not fit any block and is cut to 64 rows).
//
// Every one of `ctas` blocks runs the whole function (1 block: the TPU's
// one core, the cost per copy; one per SM: the aggregate rate); block b
// writes acc[b], block 0 the stage. What bounds it: the copy engine's
// issue rate per SM and, across SMs, the L2 / HBM rate (2 KB per row).
#include <cstdint>

#include "common.cuh"

namespace hn {

constexpr int ROW_BYTES = TILE * 4;
constexpr int S = 64;  // stage rows (ops/probe.py STAGE_ROWS)
constexpr int COPY_THREADS = 256;
constexpr int MAX_SMEM = 227 * 1024;  // dynamic shared memory per block (H100)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(1) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive (the one expected arrival) and expect `bytes` of copies
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void copy_from_global(uint32_t dst, const void* src, uint32_t bytes,
                                                 uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void copy_from_shared(uint32_t dst, uint32_t src, uint32_t bytes,
                                                 uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst), "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// order this thread's generic-proxy shared-memory accesses before later
// async-proxy (bulk copy) accesses
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the row-start table's ints, padded to 16 bytes
__host__ __device__ inline int table_ints(int n_rows) { return (n_rows + 3) / 4 * 4; }

inline size_t copy_smem_bytes(int R, int n_rows) {
  return (size_t)(S + R) * ROW_BYTES + 4 * (size_t)table_ints(n_rows) + 16;
}

__global__ void __launch_bounds__(COPY_THREADS)
row_copy_kernel(const float* __restrict__ src, int src_rows, const int* __restrict__ rows,
                int n_rows, const int* __restrict__ count, int n_host, int span, int step,
                int reps, int R, float4* __restrict__ stage_out, float* __restrict__ acc_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);
  float* onchip = stage + (size_t)S * TILE;
  int* table = reinterpret_cast<int*>(onchip + (size_t)R * TILE);
  uint64_t* bar_p = reinterpret_cast<uint64_t*>(table + table_ints(n_rows));
  uint32_t* phases = reinterpret_cast<uint32_t*>(bar_p + 1);  // in the barrier's 16 bytes
  const uint32_t bar = smem_addr(bar_p);

  // the stage starts at zero (a slot no copy writes reads 0); the table of
  // first source rows: mod R - span + 1 on chip, else clamped into src
  float4* stage4 = reinterpret_cast<float4*>(stage);
  for (int k = threadIdx.x; k < S * TILE / 4; k += blockDim.x)
    stage4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int m = R - span + 1;
  for (int k = threadIdx.x; k < n_rows; k += blockDim.x) {
    const int r = rows[k];
    table[k] = R > 0 ? ((r % m) + m) % m : min(max(r, 0), src_rows - span);
  }
  if (threadIdx.x == 0) mbar_init(bar);
  fence_async_shared();  // the zero fill before the copies overwrite it
  __syncthreads();

  if (threadIdx.x == 0) {
    uint32_t parity = 0;
    const int n = count != nullptr ? min(max(*count, 0), n_rows) : n_host;
    const uint32_t stage_s = smem_addr(stage), onchip_s = smem_addr(onchip);
    const uint32_t bytes = (uint32_t)span * ROW_BYTES;
    if (R > 0 && n > 0 && reps > 0) {
      mbar_expect(bar, (uint32_t)R * ROW_BYTES);
      copy_from_global(onchip_s, src, (uint32_t)R * ROW_BYTES, bar);
      mbar_wait(bar, parity);
      parity ^= 1;
    }
    const int per_batch = S / span;
    const int slot_step = (int)(((long long)step * span) % S);
    float acc = 0.f;
    for (int r = 0; r < reps; ++r) {
      int slot = 0;  // (i * step * span) mod S
      for (int b0 = 0; b0 < n; b0 += per_batch) {
        const int b1 = min(b0 + per_batch, n);
        mbar_expect(bar, (uint32_t)(b1 - b0) * bytes);
        for (int i = b0; i < b1; ++i) {
          const uint32_t dst = stage_s + (uint32_t)slot * ROW_BYTES;
          if (R > 0)
            copy_from_shared(dst, onchip_s + (uint32_t)table[i] * ROW_BYTES, bytes, bar);
          else
            copy_from_global(dst, src + (size_t)table[i] * TILE, bytes, bar);
          slot += slot_step;
          if (slot >= S) slot -= S;
        }
        mbar_wait(bar, parity);
        parity ^= 1;
      }
      acc = add(acc, stage[(r % S) * TILE + r % TILE]);
      fence_async_shared();  // this read before the next rep's copies
    }
    acc_out[blockIdx.x] = acc;
    // bit 0: the next phase's parity (phases completed, mod 2); bit 1: any
    *phases = parity | (n > 0 && reps > 0 ? 2u : 0u);
  }
  __syncthreads();
  if (blockIdx.x == 0) {
    // every reader acquires the copies' writes through the barrier itself:
    // a wait on the last completed phase returns at once
    if (*phases & 2u) mbar_wait(bar, (*phases & 1u) ^ 1u);
    for (int k = threadIdx.x; k < S * TILE / 4; k += blockDim.x) stage_out[k] = stage4[k];
  }
}

}  // namespace hn

// src [src_rows, 512] f32; rows [n_rows] i32; count: one i32 on the device
// (n = count[0] clamped into [0, n_rows]) or null (n = n_host); stage_out
// [64, 512] f32; acc_out [ctas] f32.
extern "C" int hn_row_copy(const void* src, int src_rows, const void* rows, int n_rows,
                           const void* count, int n_host, int span, int step, int reps, int R,
                           int ctas, void* stage_out, void* acc_out, void* stream) {
  if (span < 1 || hn::S % span || n_rows < 1 || n_host < 0 || n_host > n_rows ||
      reps < 0 || ctas < 1 || src_rows < span || R < 0 || (R > 0 && (R < span || R > src_rows)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = hn::copy_smem_bytes(R, n_rows);
  if (smem > (size_t)hn::MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(hn::row_copy_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  // each block a cluster of one: the shared::cta -> shared::cluster copy
  // faults as an illegal instruction in a launch without cluster dimensions
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(hn::COPY_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, hn::row_copy_kernel, static_cast<const float*>(src), src_rows,
                         static_cast<const int*>(rows), n_rows, static_cast<const int*>(count),
                         n_host, span, step, reps, R, static_cast<float4*>(stage_out),
                         static_cast<float*>(acc_out));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
