// B5: the whole textbook red-black SOR solve (2 * iterations colour
// half-sweeps, fresh halo every half-sweep) in one launch.
//
// Replaces hnanosolver_tpu/ops/pallas_pressure.py::_fused_kernel (built by
// _build_fused, entry solve_pressure_fused), which keeps p in VMEM for the
// whole solve and assembles neighbour rows with SMEM-indexed row copies.
// It serves every solve at T <= MAX_FUSED_ROWS (2048) tiles: small domains
// and the coarse multigrid levels. At entry p = p0, with voxels outside the
// optional in-domain mask set to 0; those voxels never update.
//
// What bounds it on the H100: neither memory nor arithmetic (the launch
// must move p0, div and mask in and p out once: 16 B a voxel, a few
// microseconds) but the 2 * iterations barriers between half-sweeps and the
// latency of each half-sweep's reads. Two forms, chosen by the wrapper
// (ops/cuda_pressure.py::fused_shape) from T and passed in as the launch
// shape, which the entry checks again:
//
// The cluster form (T <= CLUSTER_ROWS = 224: the levels of 32 and 128 rows
// of the main paths). The level lives on chip in one thread-block cluster
// of C <= 16 blocks, with no grid barrier:
//   - block b owns tiles [b * tpb, (b + 1) * tpb) for the whole solve and
//     holds their p in its dynamic shared memory, each tile as two halves
//     of 64 float4 (z even, z odd) as B3 lays it out (tile_ring.cuh);
//   - a thread owns one column (a tile's (x, y) row of 8 z values) and
//     keeps its div * dx2 in registers and its mask as bits;
//   - p0 is read once at entry and p written once at the end;
//   - a half-sweep of colour c updates a column's 4 voxels of z parity
//     O = (x + y + c) & 1 from six float4 reads (its own half, its other
//     half and the x/y neighbours' half O, which holds their other colour)
//     and one read of the z face beyond the column's end. A cross-tile
//     neighbour is read where its tile lives: this block's shared memory or
//     another block's through distributed shared memory, by a per-tile
//     table of the six face-neighbour tiles' addresses built once at entry
//     from nbr (cluster.map_shared_rank). The null row, which every absent
//     neighbour and every padding row reads, is a local zero tile where it
//     enters as +0 with div 0 (it then stays +0 bit for bit): otherwise
//     every block would read it from block 0;
//   - one cluster barrier (release / acquire) separates the half-sweeps:
//     a half-sweep writes only its colour and reads only the other, so the
//     result does not depend on which thread owns which voxel.
// The cluster barrier costs 0.46-0.76 us and a half-sweep's reads about as
// much again, against a grid barrier of 1.1-2.2 us; but 16 SMs move the
// prologue's bytes and hold the columns, so above 224 rows a 2-iteration
// smoother runs faster on the whole card (tools/b5_cost.py, PERF.md).
// The grid form (224 < T <= 2048): a persistent cooperative kernel, at
// most 4 resident 256-thread blocks an SM (at most T), each walks the tiles
// with a grid stride and updates one colour in place (rbsor.cuh::sor_point),
// and cooperative_groups' grid barrier separates the half-sweeps; p (<= 4
// MB) stays in the 50 MB L2.
//
// Both forms add the faces in the order +x -x +y -y +z -z through
// common.cuh's round-to-nearest intrinsics, then (sum - div * dx2) * (1/6)
// and p + omega * (pgs - p): bitwise ops/cuda_pressure.py's plain version.
#include <cooperative_groups.h>

#include <mutex>

#include "rbsor.cuh"
#include "tile_ring.cuh"

namespace cg = cooperative_groups;

namespace hn {

// -- the cluster form -------------------------------------------------------

constexpr int TILE4 = TILE / 4;          // float4 a tile: [2 z-parity halves][64 columns]
constexpr int NB_BYTES = 6 * 8;          // a tile's six face-neighbour addresses
constexpr int MAX_CLUSTER = 16;          // blocks (non-portable above 8)
constexpr int MAX_TILES_PER_BLOCK = 16;  // a thread a column: 1024 threads

// One half-sweep of column q (tile q >> 6 of the block, (x, y) = q & 63) of
// colour c: its 4 voxels at z parity O = (x + y + c) & 1. The x/y
// neighbours' half O holds their other colour: from the tile's shared copy,
// or from the touching column of the neighbour tile through the tile's
// table tn (+x -x +y -y +z -z: this block's tile, another block's, or the
// local null row). The z neighbours are the column's other half but for the
// face beyond its end on the colour's side: z = 0 of the tile above (O = 1,
// voxel z = 7) or z = 7 of the tile below (O = 0, voxel z = 0). r holds the
// column's div * dx2 by z, in_dom its mask bits.
template <bool MASKED>
__device__ __forceinline__ void cluster_update(float4* tiles, const float4* const* nb, int q,
                                               int color, const float* r, unsigned in_dom,
                                               float omega) {
  const int lt = q >> 6, xy = q & 63, x = xy >> 3, y = xy & 7;
  const int O = (x + y + color) & 1;
  const int h = O * 64;
  float4* tb = tiles + lt * TILE4;
  const float4* const* tn = nb + lt * 6;
  const float4 px = x < 7 ? tb[h + xy + 8] : tn[0][h + y];
  const float4 mx = x > 0 ? tb[h + xy - 8] : tn[1][h + 56 + y];
  const float4 py = y < 7 ? tb[h + xy + 1] : tn[2][h + x * 8];
  const float4 my = y > 0 ? tb[h + xy - 1] : tn[3][h + x * 8 + 7];
  const float edge = O ? tn[4][xy].x : tn[5][64 + xy].w;
  const float4 e = tb[64 - h + xy];
  const float4 v = tb[h + xy];
  const float fpx[4] = {px.x, px.y, px.z, px.w}, fmx[4] = {mx.x, mx.y, mx.z, mx.w};
  const float fpy[4] = {py.x, py.y, py.z, py.w}, fmy[4] = {my.x, my.y, my.z, my.w};
  const float fe[4] = {e.x, e.y, e.z, e.w};
  float fv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // voxel z = 2j + O; its z neighbours are the other half's values
    const float zp = O ? (j < 3 ? fe[j < 3 ? j + 1 : j] : edge) : fe[j];
    const float zm = O ? fe[j] : (j > 0 ? fe[j > 0 ? j - 1 : j] : edge);
    const float rz = O ? r[2 * j + 1] : r[2 * j];
    float sum = add(fpx[j], fmx[j]);
    sum = add(sum, fpy[j]);
    sum = add(sum, fmy[j]);
    sum = add(sum, zp);
    sum = add(sum, zm);
    const float pgs = mul(sub(sum, rz), 1.0f / 6.0f);
    const float nv = add(fv[j], mul(omega, sub(pgs, fv[j])));
    if (!MASKED || ((in_dom >> (2 * j + O)) & 1u)) fv[j] = nv;
  }
  tb[h + xy] = make_float4(fv[0], fv[1], fv[2], fv[3]);
}

// A thread a column, 64 a tile, tpb tiles a block, one cluster.
template <bool MASKED>
__global__ void __launch_bounds__(MAX_TILES_PER_BLOCK * 64, 1)
rbsor_cluster_kernel(const float* __restrict__ p0, const float* __restrict__ div,
                     const int* __restrict__ nbr, const float* __restrict__ mask,
                     float* __restrict__ p, int T, int tpb, int iterations, float omega,
                     float dx2) {
  extern __shared__ float4 smem[];
  float4* tiles = smem;                                 // [tpb][2][64]
  float4* zero = smem + (size_t)tpb * TILE4;            // [2][64]: a local null row
  const float4** nb = reinterpret_cast<const float4**>(zero + TILE4);  // [tpb][6]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t0 = rank * tpb;
  const int q = threadIdx.x;  // the thread's column
  const bool active = q < max(0, min(tpb, T - t0)) * 64;  // else it only meets the barriers

  // The prologue's global reads go out together: this thread's entry of the
  // neighbour table (tpb * 6 entries, tpb * 64 threads), the null row's p0 /
  // div / mask and the thread's column.
  const int ent_lt = q / 6, ent_d = q - ent_lt * 6;
  const bool has_ent = q < tpb * 6 && t0 + ent_lt < T;
  const int ent_row = has_ent ? nbr[(size_t)(t0 + ent_lt) * 27 +
                                    (ent_d == 0 ? D_PX : ent_d == 1 ? D_MX : ent_d == 2 ? D_PY
                                     : ent_d == 3 ? D_MY : ent_d == 4 ? D_PZ : D_MZ)]
                              : 0;
  // The null row 0 (every absent neighbour, every face of the padding rows)
  // lives in block 0. Where it enters as +0 with div 0 it stays +0 through
  // every half-sweep, bit for bit, so the block reads it from a local
  // zero tile instead of block 0's shared memory; else from block 0.
  bool null_zero = true;
  for (int i = q; i < TILE4; i += blockDim.x) {
    float4 v = reinterpret_cast<const float4*>(p0)[i];
    const float4 d = reinterpret_cast<const float4*>(div)[i];
    if (MASKED) {
      const float4 m = reinterpret_cast<const float4*>(mask)[i];
      v = make_float4(m.x > 0.0f ? v.x : 0.0f, m.y > 0.0f ? v.y : 0.0f,
                      m.z > 0.0f ? v.z : 0.0f, m.w > 0.0f ? v.w : 0.0f);
    }
    null_zero &= (__float_as_uint(v.x) | __float_as_uint(v.y) | __float_as_uint(v.z) |
                  __float_as_uint(v.w)) == 0u;
    null_zero &= d.x == 0.0f && d.y == 0.0f && d.z == 0.0f && d.w == 0.0f;
    zero[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  float r[8];
  unsigned in_dom = 0xffu;
  const size_t g = (size_t)(t0 + (q >> 6)) * TILE + (q & 63) * 8;
  if (active) {
    float v[8];
    load_col(p0 + g, v);
    load_col(div + g, r);
#pragma unroll
    for (int z = 0; z < 8; ++z) r[z] = mul(r[z], dx2);
    if (MASKED) {
      float m[8];
      load_col(mask + g, m);
      in_dom = 0u;
#pragma unroll
      for (int z = 0; z < 8; ++z) {
        in_dom |= (m[z] > 0.0f ? 1u : 0u) << z;
        v[z] = m[z] > 0.0f ? v[z] : 0.0f;
      }
    }
    float4* tb = tiles + (q >> 6) * TILE4 + (q & 63);
    tb[0] = make_float4(v[0], v[2], v[4], v[6]);
    tb[64] = make_float4(v[1], v[3], v[5], v[7]);
  }
  null_zero = __syncthreads_and(null_zero);
  // the entry: a local address where the neighbour tile is this block's (or
  // the null row, where it is all +0), else its address in the owner
  // block's shared memory
  if (has_ent) {
    const int owner = ent_row / tpb;
    float4* local = tiles + (size_t)(ent_row - owner * tpb) * TILE4;
    nb[q] = ent_row == 0 && null_zero ? zero
          : owner == rank             ? local
                                      : cluster.map_shared_rank(local, owner);
  }
  cluster.sync();  // every block's tiles and tables in place
  for (int s = 0; s < 2 * iterations; ++s) {
    if (active) cluster_update<MASKED>(tiles, nb, q, s & 1, r, in_dom, omega);
    cluster.sync();  // release / acquire: the half-sweep's writes seen cluster-wide
  }
  if (active) {
    const float4* tb = tiles + (q >> 6) * TILE4 + (q & 63);
    const float4 a = tb[0], b = tb[64];
    const float v[8] = {a.x, b.x, a.y, b.y, a.z, b.z, a.w, b.w};
    store_col(p + g, v);
  }
}

// The cluster form's launch shape, as ops/cuda_pressure.py::fused_shape
// computes it: C the least power of two >= min(T, 16), tpb = ceil(T / C)
// tiles a block (at most 16), a thread a column, shared memory the tiles, the
// null row and the tiles' tables.
__host__ bool cluster_shape_ok(int T, int C, int tpb, int threads, int smem) {
  int want_c = 1;
  while (want_c < T && want_c < MAX_CLUSTER) want_c *= 2;
  if (C != want_c || tpb != (T + C - 1) / C || tpb > MAX_TILES_PER_BLOCK) return false;
  return threads == tpb * 64 && smem == tpb * (TILE * 4 + NB_BYTES) + TILE * 4;
}

// Host state of the launches below, kept per device (a function attribute
// is set in the current device's context) and shared by the threads that
// launch at once (the sharded step's): taken under this lock.
std::mutex host_state;
constexpr int MAX_DEVICES = 64;

// The host work of a cluster launch done once a device: the kernel's
// attribute for the non-portable cluster size (its shared memory, at most
// 16 * 2096 + 2048 B, needs none) and, per distinct shape, the occupancy
// query that refuses a cluster the card cannot hold (-1). Shapes are few
// (one per T), so a short list holds the ones already found to fit.
template <bool MASKED>
int launch_cluster(const float* p0, const float* div, const int* nbr, const float* mask,
                   float* p, int T, int C, int tpb, int threads, int smem, int iterations,
                   float omega, float dx2, cudaStream_t stream) {
  auto kernel = rbsor_cluster_kernel<MASKED>;
  static bool attributes_set[MAX_DEVICES] = {};
  static int fits[64][4];  // (device, C, threads, smem) of the shapes found to fit
  static int n_fits = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  {
    std::lock_guard<std::mutex> lock(host_state);
    if (!attributes_set[dev]) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return (int)e;
      attributes_set[dev] = true;
    }
    bool known = false;
    for (int i = 0; i < n_fits && !known; ++i)
      known = fits[i][0] == dev && fits[i][1] == C && fits[i][2] == threads && fits[i][3] == smem;
    if (!known) {
      int clusters = 0;
      e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
      if (e != cudaSuccess) return (int)e;
      if (clusters < 1) return -1;  // the card cannot hold one such cluster: refused
      if (n_fits < 64) {
        fits[n_fits][0] = dev, fits[n_fits][1] = C, fits[n_fits][2] = threads;
        fits[n_fits][3] = smem, ++n_fits;
      }
    }
  }
  e = cudaLaunchKernelEx(&cfg, kernel, p0, div, nbr, mask, p, T, tpb, iterations, omega, dx2);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// -- the grid form ------------------------------------------------------------

constexpr int GRID_BLOCKS_PER_SM = 4;

__global__ void __launch_bounds__(HALF)
rbsor_fused_kernel(const float* __restrict__ p0, const float* __restrict__ div,
                   const int* __restrict__ nbr, const float* __restrict__ mask, float* p,
                   int T, int iterations, float omega, float dx2) {
  cg::grid_group grid = cg::this_grid();
  const size_t n = (size_t)T * TILE;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    p[i] = in_domain(mask, i) ? p0[i] : 0.0f;
  grid.sync();
  for (int s = 0; s < 2 * iterations; ++s) {
    const int c = color_col(threadIdx.x, s & 1);
    for (size_t t = blockIdx.x; t < (size_t)T; t += gridDim.x) {
      const size_t self = t * TILE + c;
      if (in_domain(mask, self)) p[self] = sor_point(p, div, nbr + t * 27, t, c, omega, dx2);
    }
    grid.sync();
  }
}

}  // namespace hn

// p0, div [T, 512] f32; nbr [T, 27] i32; mask [T, 512] f32 or null;
// p [T, 512] f32 output (must not alias p0). The cluster form reads p0, div
// and mask and writes p as float4: 16-byte aligned.
// Launch shape: cluster 0 for the grid form (threads 256, tiles_per_block
// and smem 0), else the cluster form's C, tpb, threads and shared bytes
// (cluster_shape_ok). Returns -1 when the card cannot hold the cluster
// (cudaOccupancyMaxActiveClusters gives 0), else a CUDA error.
extern "C" int hn_rbsor_fused(const void* p0, const void* div, const void* nbr,
                              const void* mask, void* p, int T, int iterations, float omega,
                              float dx2, int cluster, int tiles_per_block, int threads, int smem,
                              void* stream) {
  if (T <= 0 || iterations < 0) return (int)cudaErrorInvalidValue;
  const float* a_p0 = static_cast<const float*>(p0);
  const float* a_div = static_cast<const float*>(div);
  const int* a_nbr = static_cast<const int*>(nbr);
  const float* a_mask = static_cast<const float*>(mask);
  float* a_p = static_cast<float*>(p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster > 0) {
    if (!hn::cluster_shape_ok(T, cluster, tiles_per_block, threads, smem))
      return (int)cudaErrorInvalidValue;
    return a_mask != nullptr
               ? hn::launch_cluster<true>(a_p0, a_div, a_nbr, a_mask, a_p, T, cluster,
                                          tiles_per_block, threads, smem, iterations, omega,
                                          dx2, s)
               : hn::launch_cluster<false>(a_p0, a_div, a_nbr, a_mask, a_p, T, cluster,
                                           tiles_per_block, threads, smem, iterations, omega,
                                           dx2, s);
  }
  if (cluster < 0 || tiles_per_block != 0 || threads != hn::HALF || smem != 0)
    return (int)cudaErrorInvalidValue;
  // the resident blocks, found once a device: at most 4 an SM, since fewer
  // blocks meet at each grid barrier (on the H100 4 ran faster at T = 1024
  // and 2048 than the 8 that fit, and than 2)
  static int resident_of[hn::MAX_DEVICES] = {};  // 0: not found yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= hn::MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int resident = 0;
  {
    std::lock_guard<std::mutex> lock(hn::host_state);
    if (resident_of[dev] == 0) {
      int sms = 0, per_sm = 0;
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hn::rbsor_fused_kernel,
                                                          hn::HALF, 0);
      if (e != cudaSuccess) return (int)e;
      resident_of[dev] =
          (per_sm < hn::GRID_BLOCKS_PER_SM ? per_sm : hn::GRID_BLOCKS_PER_SM) * sms;
    }
    resident = resident_of[dev];
  }
  const int grid = resident < T ? resident : T;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a_p0, &a_div, &a_nbr, &a_mask, &a_p, &T, &iterations, &omega, &dx2};
  return (int)cudaLaunchCooperativeKernel((const void*)hn::rbsor_fused_kernel, dim3(grid),
                                          dim3(hn::HALF), args, 0, s);
}
