// The barriers kernel B5 (rbsor_fused.cu) is built on, alone: n empty
// grid-wide barriers of a cooperative launch (its grid form) or n cluster
// barriers of one thread-block cluster (its cluster form). The cost of one
// barrier is the slope of the launch time over n
// (hnanosolver_tpu_torch/tools/b5_cost.py). Not a port of a TPU kernel: a
// measurement of what a B5 half-sweep's barrier costs on the card.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace hn {

__global__ void grid_sync_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

__global__ void cluster_sync_kernel(int n) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = 0; i < n; ++i) cluster.sync();
}

}  // namespace hn

// n grid barriers over `blocks` blocks of `threads` threads (all resident).
extern "C" int hn_grid_sync_loop(int n, int blocks, int threads, void* stream) {
  if (n < 0 || blocks < 1 || threads < 1 || threads > 1024) return (int)cudaErrorInvalidValue;
  void* args[] = {&n};
  return (int)cudaLaunchCooperativeKernel((const void*)hn::grid_sync_kernel, dim3(blocks),
                                          dim3(threads), args, 0,
                                          static_cast<cudaStream_t>(stream));
}

// n cluster barriers in one cluster of `cluster` blocks of `threads` threads.
extern "C" int hn_cluster_sync_loop(int n, int cluster, int threads, void* stream) {
  if (n < 0 || cluster < 1 || cluster > 16 || threads < 1 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  if (cluster > 8)
    e = cudaFuncSetAttribute(hn::cluster_sync_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, hn::cluster_sync_kernel, n);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
