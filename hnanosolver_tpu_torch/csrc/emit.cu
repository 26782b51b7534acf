// EM: the plume's emit (models/plume.py::emit) on the flat layout, in one
// launch.
//
// Replaces no TPU kernel: the JAX package computes the emit as plain XLA
// (hnanosolver_tpu/models/plume.py::emit). Its plain PyTorch version,
// ops/cuda_emit.py::emit_plain, builds the voxel positions, the squared
// distance to the emitter's centre, the row mask and the four sourced fields
// in ~35 launches over every row.
//
// Per voxel of row t, at p = float(origin_t * 8 + (x, y, z)) (int32 sums,
// then one round-to-nearest conversion, as positions_flat and .to(float32)):
//   d2     = ((px - cx)*(px - cx) + (py - cy)*(py - cy)) + (pz - cz)*(pz - cz)
//   inside = (1 <= t <= n_active and d2 < r2) ? 1 : 0
//   density' = density + inside * kd
//   fuel'    = min(fuel + inside * kf, 1)          a NaN stays NaN
//   T'       = inside ? max(T, target) : T         a NaN stays NaN
//   u_y'     = inside ? jet : u_y;  u_x, u_z copied
// r2, kd, kf, target and jet are the float32 values PyTorch casts the plain
// version's Python scalars to, computed by the caller; the NaN tests are
// those of torch.clamp's CUDA kernel. The op order and the round-to-nearest
// intrinsics (no FMA contraction) are the plain version's, so the kernel is
// bitwise equal to it on the card. Every voxel goes through the same
// arithmetic: there is no path that skips the rows outside the sphere.
//
// What bounds it on the H100: memory. It reads density, fuel, temperature and
// the three velocity components once and writes six new fields (48 B a
// voxel; the state stays as it was, since the step is a pure function), and
// 12 B of origin a tile. One 128-thread block a tile, four voxels (one
// float4 of each field) a thread: the in-tile coordinates come from the
// thread index, the tile's origin is one broadcast load a warp, and each
// thread puts its six 16-byte loads in flight before it computes. The loads
// and stores stream past the L1 and the L2 (__ldcs / __stcs): nothing is
// read twice.
#include "common.cuh"

namespace hn {

constexpr int EM_THREADS = TILE / 4;  // a tile, four voxels a thread

__device__ __forceinline__ float sq(float a) { return mul(a, a); }

// one voxel; in: inside the sphere on an active row
__device__ __forceinline__ void emit_voxel(bool in, float kd, float kf, float target, float jet,
                                           float& d, float& f, float& h, float& v) {
  const float inside = in ? 1.0f : 0.0f;
  d = add(d, mul(inside, kd));
  const float fs = add(f, mul(inside, kf));
  f = isnan(fs) ? fs : fminf(fs, 1.0f);
  h = (in && !isnan(h)) ? fmaxf(h, target) : h;
  v = in ? jet : v;
}

__global__ void __launch_bounds__(EM_THREADS)
emit_kernel(const float4* __restrict__ density, const float4* __restrict__ fuel,
            const float4* __restrict__ temperature, const float4* __restrict__ vel,
            const int* __restrict__ origins, float4* __restrict__ o_density,
            float4* __restrict__ o_fuel, float4* __restrict__ o_temperature,
            float4* __restrict__ o_vel, int T, int n_active, float cx, float cy, float cz,
            float r2, float kd, float kf, float target, float jet) {
  const int row = blockIdx.x;
  const size_t t = row;
  const int q = threadIdx.x;  // the float4 of the row: columns 4q .. 4q + 3
  const size_t i = t * EM_THREADS + q;
  const size_t plane = (size_t)T * EM_THREADS;
  float4 d = __ldcs(density + i), f = __ldcs(fuel + i), h = __ldcs(temperature + i);
  const float4 u = __ldcs(vel + i), w = __ldcs(vel + 2 * plane + i);
  float4 v = __ldcs(vel + plane + i);
  const int ox = __ldg(origins + 3 * t), oy = __ldg(origins + 3 * t + 1),
            oz = __ldg(origins + 3 * t + 2);

  // col = x*64 + y*8 + z: the four columns share x and y, z = (4q & 7) + j
  const int c = 4 * q;
  const float dx = sub(__int2float_rn(ox * 8 + (c >> 6)), cx);
  const float dy = sub(__int2float_rn(oy * 8 + ((c >> 3) & 7)), cy);
  const float dxy = add(sq(dx), sq(dy));
  const bool active = row >= 1 && row <= n_active;
  const int z0 = oz * 8 + (c & 7);
  bool in[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    in[j] = active && add(dxy, sq(sub(__int2float_rn(z0 + j), cz))) < r2;

  emit_voxel(in[0], kd, kf, target, jet, d.x, f.x, h.x, v.x);
  emit_voxel(in[1], kd, kf, target, jet, d.y, f.y, h.y, v.y);
  emit_voxel(in[2], kd, kf, target, jet, d.z, f.z, h.z, v.z);
  emit_voxel(in[3], kd, kf, target, jet, d.w, f.w, h.w, v.w);
  __stcs(o_density + i, d);
  __stcs(o_fuel + i, f);
  __stcs(o_temperature + i, h);
  __stcs(o_vel + i, u);
  __stcs(o_vel + plane + i, v);
  __stcs(o_vel + 2 * plane + i, w);
}

}  // namespace hn

// density, fuel, temperature [T, 512] f32; vel [3, T, 512] f32; origins [T, 3]
// i32; the outputs likewise, each 16-byte aligned.
extern "C" int hn_emit(const void* density, const void* fuel, const void* temperature,
                       const void* vel, const void* origins, void* o_density, void* o_fuel,
                       void* o_temperature, void* o_vel, int T, int n_active, float cx, float cy,
                       float cz, float r2, float kd, float kf, float target, float jet,
                       void* stream) {
  if (T <= 0) return (int)cudaErrorInvalidValue;
  hn::emit_kernel<<<T, hn::EM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(density), static_cast<const float4*>(fuel),
      static_cast<const float4*>(temperature), static_cast<const float4*>(vel),
      static_cast<const int*>(origins), static_cast<float4*>(o_density),
      static_cast<float4*>(o_fuel), static_cast<float4*>(o_temperature),
      static_cast<float4*>(o_vel), T, n_active, cx, cy, cz, r2, kd, kf, target, jet);
  return (int)cudaGetLastError();
}
