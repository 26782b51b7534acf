// CE: the collision's enforce pass (enforceCollisionBoundaries) on the flat
// layout, in one launch.
//
// Replaces no TPU kernel: the JAX package computes the collision as plain
// XLA (hnanosolver_tpu/ops/collision.py::enforce_collision, with
// sdf_normal_field and no_slip). Its plain PyTorch version,
// ops/cuda_collision.py::enforce_collision_plain, builds the SDF normal from
// six shifted views (rolls and row gathers) and blends in ~40 launches.
//
// Per voxel, with s_{+a} / s_{-a} the SDF's face neighbours along axis a
// (common.cuh::face, the null row 0 where a neighbour is absent):
//   g_a    = (s_{+a} - s_{-a}) * scale                  scale = 0.5 * inv_dx
//   glen   = sqrt((gx*gx + gy*gy) + gz*gz)
//   n_a    = glen > 1e-6 ? g_a / max(glen, 1e-30) : 0
//   blend  = clamp(1 - sdf * inv_denom, 0, 1)
//   vdotn  = (v0*n0 + v1*n1) + v2*n2
//   out_a  = sdf < 0 ? +0 : sdf < margin ? v_a*(1 - blend) + (v_a - n_a*vdotn)*blend : v_a
// inv_denom is the float32 reciprocal of blend_denom, computed by the
// caller: PyTorch's CUDA division of a tensor by a Python number multiplies
// by that reciprocal, so the kernel does too. The op order and the
// round-to-nearest intrinsics (no FMA contraction) are the plain version's,
// so the kernel is bitwise equal to it on the card. A voxel at or beyond the
// margin keeps its velocity and reads no neighbour.
//
// One 512-thread block per tile, one thread per voxel (B7b's shape,
// stencil.cu): the tile's SDF row and its 27 nbr entries are staged in
// shared memory, cross-tile faces are read straight from the neighbour rows.
//
// What bounds it on the H100: memory. It reads the SDF and the three
// velocity components once and writes three (28 B per voxel, coalesced); no
// scratch in device memory. The neighbours' face planes of the SDF are
// read only for voxels inside the margin, mostly L2 hits.
#include "common.cuh"

namespace hn {

__global__ void __launch_bounds__(TILE)
enforce_collision_kernel(const float* __restrict__ vel, const float* __restrict__ sdf,
                         const int* __restrict__ nbr, float* __restrict__ out, int T,
                         float scale, float margin, float inv_denom) {
  __shared__ float s[TILE];
  __shared__ int nb[27];
  const size_t t = blockIdx.x;
  const int c = threadIdx.x;
  const size_t plane = (size_t)T * TILE;
  const size_t self = t * TILE + c;
  const float d = sdf[self];
  s[c] = d;
  if (c < 27) nb[c] = nbr[t * 27 + c];
  __syncthreads();

  float v[3] = {vel[self], vel[plane + self], vel[2 * plane + self]};
  if (d < 0.0f) {
    v[0] = v[1] = v[2] = 0.0f;
  } else if (d < margin) {
    const float g[3] = {
        mul(sub(face<D_PX>(sdf, s, nb, c), face<D_MX>(sdf, s, nb, c)), scale),
        mul(sub(face<D_PY>(sdf, s, nb, c), face<D_MY>(sdf, s, nb, c)), scale),
        mul(sub(face<D_PZ>(sdf, s, nb, c), face<D_MZ>(sdf, s, nb, c)), scale)};
    const float glen = __fsqrt_rn(add(add(mul(g[0], g[0]), mul(g[1], g[1])), mul(g[2], g[2])));
    float n[3] = {0.0f, 0.0f, 0.0f};
    if (glen > 1e-6f) {
      const float len = fmaxf(glen, 1e-30f);
#pragma unroll
      for (int a = 0; a < 3; ++a) n[a] = __fdiv_rn(g[a], len);
    }
    const float blend = clampf(sub(1.0f, mul(d, inv_denom)), 0.0f, 1.0f);
    const float keep = sub(1.0f, blend);
    const float vdotn = add(add(mul(v[0], n[0]), mul(v[1], n[1])), mul(v[2], n[2]));
#pragma unroll
    for (int a = 0; a < 3; ++a)
      v[a] = add(mul(v[a], keep), mul(sub(v[a], mul(n[a], vdotn)), blend));
  }
  out[self] = v[0];
  out[plane + self] = v[1];
  out[2 * plane + self] = v[2];
}

}  // namespace hn

// vel [3, T, 512] f32, sdf [T, 512] f32, nbr [T, 27] i32, out [3, T, 512] f32.
extern "C" int hn_enforce_collision(const void* vel, const void* sdf, const void* nbr, void* out,
                                    int T, float scale, float margin, float inv_denom,
                                    void* stream) {
  if (T <= 0) return (int)cudaErrorInvalidValue;
  hn::enforce_collision_kernel<<<T, hn::TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vel), static_cast<const float*>(sdf),
      static_cast<const int*>(nbr), static_cast<float*>(out), T, scale, margin, inv_denom);
  return (int)cudaGetLastError();
}
