// PC: asynchronous row copies into a shared-memory stage, issued by one
// warp as bulk copies that complete on an mbarrier.
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
// Mechanism, the Hopper counterpart of a DMA descriptor: each copy is one
// 1-D bulk asynchronous copy (TMA),
//   device-memory source  cp.async.bulk.shared::cluster.global
//   on-chip source        cp.async.bulk.shared::cluster.shared::cta
// both .mbarrier::complete_tx::bytes. Warp 0 issues them: lane 0 arms the
// barrier with the batch's bytes, then lane j issues copies j, j + 32, ...
// of the batch (its slots are distinct, so the order of issue within a
// batch cannot change a slot's writer), and the warp waits for the phase.
// Copies of 8 rows (16 KB) or more go from lane 0 alone, chosen by span
// (ops/cuda_probe.py copy_issue_lanes): a batch of them is at most 8
// copies, whose serial issue (~44 ns each) is short beside their transfer,
// and issuing them at once was slower at 132 blocks (tools/pc_cost.py).
// A row is 2 KB, so every span is 16-byte aligned and a multiple of 16
// bytes. The on-chip source is rows [0, R) of src, staged by one bulk copy
// beside the stage (its row starts are taken mod R - span + 1); the rows
// table sits in shared memory too, reduced to source rows before the first
// copy, as the TPU kernels read it from SMEM. Shared memory per block: S +
// R rows of 2 KB, the table and the barrier, at most 227 KB (a 64-row
// stage takes 128 KB; probe_dmacost.py's 2056-row stage does not fit any
// block and is cut to 64 rows).
//
// Every one of `ctas` blocks runs the whole function (1 block: the TPU's
// one core, the cost per copy; one per SM: the aggregate rate): every copy
// of every rep is issued, lands in the stage and is drained on the
// barrier, since the probes' ns a copy and acc are what it measures (a
// kernel that copied each source row once would skip what it times).
// Block b writes acc[b] and, with ctas > 1, its share of the stage's rows,
// [64 b / ctas, 64 (b + 1) / ctas), with one bulk copy
// (cp.async.bulk.global.shared::cta). A single block writes all 64 rows
// with its threads' 16-byte stores, chosen by ctas: one 128 KB bulk copy was
// ~0.1 us slower there (tools/pc_cost.py); from one SM it takes ~1.9 us,
// the floor of a one-block launch.
//
// Around the copies, a launch's fixed cost (tools/pc_cost.py parts it):
//   - the set-up is sized to n: the stage is not zeroed when the first
//     batch covers all 64 rows (its slots are distinct: n * span >= 64,
//     ops/probe.py first_batch_covers), and only the n row starts the
//     copies use are read into the table (v5, n = 0, reads no global memory);
//   - the launch: a plain one for the device-memory source; a cluster of one
//     for the on-chip source, whose shared::cta -> shared::cluster copy
//     faults as an illegal instruction in a launch without cluster
//     dimensions;
//   - the shared-memory attribute is set once a device and size.
// hn_row_copy_parts takes these design choices one by one (PARTS; 0 is the
// design before: one thread issues, the whole stage zeroed and every row
// start read, block 0's threads write all of it out, a cluster launch and
// the attribute set every call), so that tools/pc_cost.py prices each;
// hn_row_copy runs DESIGN.
//
// What bounds it: the copy engine's issue rate per SM and, across SMs, the
// L2 / HBM rate (2 KB per row); at a few copies, the launch.
#include <cstdint>

#include "common.cuh"

namespace hn {

constexpr int ROW_BYTES = TILE * 4;
constexpr int S = 64;  // stage rows (ops/probe.py STAGE_ROWS)
constexpr int COPY_THREADS = 256;
constexpr int MAX_SMEM = 227 * 1024;  // dynamic shared memory per block (H100)

// the design's parts (tools/pc_cost.py PARTS): each on, the design; EMPTY
// returns at once, the launch alone
constexpr int WARP_ISSUE = 1, SETUP_BY_N = 2, BULK_OUT = 4, PLAIN_LAUNCH = 8, ATTR_ONCE = 16,
              EMPTY = 32;
constexpr int DESIGN = WARP_ISSUE | SETUP_BY_N | BULK_OUT | PLAIN_LAUNCH | ATTR_ONCE;
constexpr int SERIAL_SPAN = 8;  // copies of this many rows or more: lane 0 issues them

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

// shared memory to global memory, then wait until the copy has read the
// shared memory (the block may then exit)
__device__ __forceinline__ void store_to_global(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
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
                int reps, int R, float4* __restrict__ stage_out, float* __restrict__ acc_out,
                int parts) {
  if (parts & EMPTY) return;
  extern __shared__ __align__(128) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);
  float* onchip = stage + (size_t)S * TILE;
  int* table = reinterpret_cast<int*>(onchip + (size_t)R * TILE);
  uint64_t* bar_p = reinterpret_cast<uint64_t*>(table + table_ints(n_rows));
  uint32_t* phases = reinterpret_cast<uint32_t*>(bar_p + 1);  // in the barrier's 16 bytes
  const uint32_t bar = smem_addr(bar_p);
  const int n = count != nullptr ? min(max(*count, 0), n_rows) : n_host;

  // the stage starts at zero (a slot no copy writes reads 0); the table of
  // first source rows: mod R - span + 1 on chip, else clamped into src
  const bool by_n = parts & SETUP_BY_N;
  float4* stage4 = reinterpret_cast<float4*>(stage);
  if (!(by_n && reps > 0 && n * span >= S))  // else the first batch covers the stage
    for (int k = threadIdx.x; k < S * TILE / 4; k += blockDim.x)
      stage4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int m = R - span + 1;
  for (int k = threadIdx.x; k < (by_n ? n : n_rows); k += blockDim.x) {
    const int r = rows[k];
    table[k] = R > 0 ? ((r % m) + m) % m : min(max(r, 0), src_rows - span);
  }
  if (threadIdx.x == 0) mbar_init(bar);
  fence_async_shared();  // the zero fill before the copies overwrite it
  __syncthreads();

  if (threadIdx.x < 32) {  // warp 0 issues and drains every copy
    const int lane = threadIdx.x;
    const int lanes = parts & WARP_ISSUE && span < SERIAL_SPAN ? 32 : 1;
    uint32_t parity = 0;
    const uint32_t stage_s = smem_addr(stage), onchip_s = smem_addr(onchip);
    const uint32_t bytes = (uint32_t)span * ROW_BYTES;
    if (R > 0 && n > 0 && reps > 0) {
      if (lane == 0) {
        mbar_expect(bar, (uint32_t)R * ROW_BYTES);
        copy_from_global(onchip_s, src, (uint32_t)R * ROW_BYTES, bar);
      }
      mbar_wait(bar, parity);
      parity ^= 1;
    }
    const int per_batch = S / span;
    const int slot_step = (int)(((long long)step * span) % S);
    // copy i goes to slot (i * slot_step) mod S; a batch starts at slot 0
    // (per_batch * slot_step is a multiple of S), lane j at j * slot_step
    const int lane_slot = (int)(((long long)lane * slot_step) % S);
    const int lanes_step = (int)(((long long)lanes * slot_step) % S);
    float acc = 0.f;
    for (int r = 0; r < reps; ++r) {
      for (int b0 = 0; b0 < n; b0 += per_batch) {
        const int b1 = min(b0 + per_batch, n);
        if (lane == 0) mbar_expect(bar, (uint32_t)(b1 - b0) * bytes);
        __syncwarp();
        if (lane < lanes) {
          int slot = lane_slot;
          for (int i = b0 + lane; i < b1; i += lanes) {
            const uint32_t dst = stage_s + (uint32_t)slot * ROW_BYTES;
            if (R > 0)
              copy_from_shared(dst, onchip_s + (uint32_t)table[i] * ROW_BYTES, bytes, bar);
            else
              copy_from_global(dst, src + (size_t)table[i] * TILE, bytes, bar);
            slot += lanes_step;
            if (slot >= S) slot -= S;
          }
        }
        mbar_wait(bar, parity);  // every lane acquires the batch's writes
        parity ^= 1;
      }
      if (lane == 0) {
        acc = add(acc, stage[(r % S) * TILE + r % TILE]);
        fence_async_shared();  // this read before the next rep's copies
      }
      __syncwarp();
    }
    if (lane == 0) {
      acc_out[blockIdx.x] = acc;
      // bit 0: the next phase's parity (phases completed, mod 2); bit 1: any
      *phases = parity | (n > 0 && reps > 0 ? 2u : 0u);
    }
  }
  __syncthreads();
  if (parts & BULK_OUT && gridDim.x > 1) {
    // thread 0 drained every copy; its bulk copy reads the stage after the
    // copies' writes and (fenced above, before the barrier) the zero fill
    const int r0 = S * blockIdx.x / gridDim.x, r1 = S * (blockIdx.x + 1) / gridDim.x;
    if (threadIdx.x == 0 && r1 > r0) {
      fence_async_shared();
      store_to_global(stage_out + (size_t)r0 * (TILE / 4), smem_addr(stage) + r0 * ROW_BYTES,
                      (uint32_t)(r1 - r0) * ROW_BYTES);
    }
  } else if (blockIdx.x == 0) {
    // every reader acquires the copies' writes through the barrier itself:
    // a wait on the last completed phase returns at once
    if (*phases & 2u) mbar_wait(bar, (*phases & 1u) ^ 1u);
    for (int k = threadIdx.x; k < S * TILE / 4; k += blockDim.x) stage_out[k] = stage4[k];
  }
}

SmemLimit copy_limit;

}  // namespace hn

// src [src_rows, 512] f32; rows [n_rows] i32; count: one i32 on the device
// (n = count[0] clamped into [0, n_rows]) or null (n = n_host); stage_out
// [64, 512] f32; acc_out [ctas] f32; parts: the design's parts (hn::DESIGN
// for the design, 0 for the design before; tools/pc_cost.py).
extern "C" int hn_row_copy_parts(const void* src, int src_rows, const void* rows, int n_rows,
                                 const void* count, int n_host, int span, int step, int reps,
                                 int R, int ctas, void* stage_out, void* acc_out, int parts,
                                 void* stream) {
  if (span < 1 || hn::S % span || n_rows < 1 || n_host < 0 || n_host > n_rows ||
      reps < 0 || ctas < 1 || src_rows < span || R < 0 || (R > 0 && (R < span || R > src_rows))
      || parts < 0 || parts > (hn::DESIGN | hn::EMPTY))
    return (int)cudaErrorInvalidValue;
  const size_t smem = hn::copy_smem_bytes(R, n_rows);
  if (smem > (size_t)hn::MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t e = hn::raise_smem_limit(hn::row_copy_kernel, smem, hn::copy_limit,
                                       !(parts & hn::ATTR_ONCE));
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* src_f = static_cast<const float*>(src);
  const int* rows_i = static_cast<const int*>(rows);
  const int* count_i = static_cast<const int*>(count);
  float4* stage_f = static_cast<float4*>(stage_out);
  float* acc_f = static_cast<float*>(acc_out);
  if (R == 0 && parts & hn::PLAIN_LAUNCH) {
    hn::row_copy_kernel<<<ctas, hn::COPY_THREADS, smem, s>>>(
        src_f, src_rows, rows_i, n_rows, count_i, n_host, span, step, reps, R, stage_f, acc_f,
        parts);
    return (int)cudaGetLastError();
  }
  // each block a cluster of one: the on-chip source's shared::cta ->
  // shared::cluster copy faults in a launch without cluster dimensions
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(hn::COPY_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, hn::row_copy_kernel, src_f, src_rows, rows_i, n_rows, count_i,
                         n_host, span, step, reps, R, stage_f, acc_f, parts);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// As hn_row_copy_parts with the design (hn::DESIGN): the wrapper's entry.
extern "C" int hn_row_copy(const void* src, int src_rows, const void* rows, int n_rows,
                           const void* count, int n_host, int span, int step, int reps, int R,
                           int ctas, void* stage_out, void* acc_out, void* stream) {
  return hn_row_copy_parts(src, src_rows, rows, n_rows, count, n_host, span, step, reps, R, ctas,
                           stage_out, acc_out, hn::DESIGN, stream);
}
