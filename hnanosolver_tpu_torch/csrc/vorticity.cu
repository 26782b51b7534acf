// VC: the vorticity confinement (ops/stencil.py::vorticity_confinement at an
// offset s != 0) on the flat layout, in one launch.
//
// Replaces no TPU kernel: the JAX package computes the confinement as plain
// XLA (hnanosolver_tpu/ops/stencil.py::vorticity_confinement, with curl and
// _curl_mag_at_offset). Its plain PyTorch version,
// ops/cuda_vorticity.py::vorticity_confinement_plain, builds the curl from six
// shifted views and |omega| at voxel +- s along each axis from 72 offset
// reads (an int64 index [T, 512] and a gather each): ~3,000 launches a call.
//
// Per voxel v of row t, with factor = float32(0.5 * inv_dx) and u_c(q) the
// velocity's component c at voxel q (through t's nbr entries; the null row 0,
// all zeros, where the tile holding q is absent):
//   w_x(q) = ((u_z(q+y) - u_z(q-y)) - (u_y(q+z) - u_y(q-z))) * factor
//   w_y(q) = ((u_x(q+z) - u_x(q-z)) - (u_z(q+x) - u_z(q-x))) * factor
//   w_z(q) = ((u_y(q+x) - u_y(q-x)) - (u_x(q+y) - u_x(q-y))) * factor
//   m(q)   = sqrt((w_x*w_x + w_y*w_y) + w_z*w_z)
//   g_a    = (m(v + s e_a) - m(v - s e_a)) * factor
//   glen   = sqrt((g_x*g_x + g_y*g_y) + g_z*g_z) + 1e-5
//   N_a    = g_a / glen
//   f      = (N_y*w_z - N_z*w_y, N_z*w_x - N_x*w_z, N_x*w_y - N_y*w_x)   w = w(v)
//   out_a  = u_a(v) + (scale * f_a) * dt
// scale and dt are the float32 values PyTorch casts the plain version's
// Python scalars to; the two products are rounded apart, as the plain
// version's two tensor-times-scalar ops are. The op order (the sums of three
// squares left to right, as torch.sum over the stacked axis adds them on the
// card), the round-to-nearest intrinsics (no FMA contraction), __fsqrt_rn
// and __fdiv_rn are the plain version's, so the kernel is bitwise equal to
// it on the card, on every row: m reads the tile's own voxels through
// nbr[t, 13] as the offset reads do, and w(v) and u(v) read row t itself as
// the shifted views do (the two differ only on the null and padding rows,
// whose nbr entries are all 0). A negative s swaps m(+) and m(-).
//
// What bounds it on the H100: memory. It must read the velocity once and
// write it once: 24 B a voxel, 415.2 MB at the fire512 cell's 33,792 rows
// (0.124 ms at 3.35 TB/s), against 154 float32 operations a voxel (0.040 ms
// at 67 TFLOP/s). The plain version's 72 gathers move that field many times
// over and recompute each |omega| six times.
//
// The design: one block a tile, blocks in row (tile key) order, so that the
// neighbours' blocks run close in time and their halo reads hit the L2.
//  1. Stage: the three components of the box [-h, 8 + h)^3 around the tile,
//     h = |s| + 1, into shared memory, from the tile's 27 nbr rows. Only the
//     points some read reaches are loaded: at most two axes outside the
//     tile, and then one of them by a single voxel and the other by at most
//     |s| (the corners and most of the edges are left out).
//  2. |omega| once a point, on the cross-shaped set the gradient reads (the
//     tile and the slabs [-|s|, 0) and [8, 8 + |s|) along each axis: 896
//     points at |s| = 1), kept in shared memory; omega at the thread's own
//     two voxels kept in registers.
//  3. On a null or padding row (nbr[t, 13] != t) the box's centre is loaded
//     again from row t, and omega(v) computed again from it, as the plain
//     version's curl and addition read it.
//  4. A voxel (two a thread): g from the |omega| set, N, the force and one
//     coalesced write of each component.
// The box and the set are sized from |s| (a template argument, 1..7), as
// dynamic shared memory: 24.3 KB at |s| = 1, 178.8 KB at |s| = 7 (where
// h = 8 keeps the box inside the tile's 3x3x3 neighbourhood).
#include "common.cuh"

namespace hn {

constexpr int VC_THREADS = 256;  // a tile, two voxels a thread
constexpr int VC_MAX_OFFSET = 7;

template <int S>
struct VcShape {
  static constexpr int H = S + 1;               // the box's halo
  static constexpr int B = 8 + 2 * H;           // the box's edge
  static constexpr int BOX = B * B * B;         // points a component
  static constexpr int SLAB = S * 64;           // |omega| points a slab
  static constexpr int MAGS = TILE + 6 * SLAB;  // the cross-shaped set
  static constexpr int SMEM = (3 * BOX + MAGS) * 4;
};

// how far a coordinate in [-8, 16) lies outside [0, 8)
__device__ __forceinline__ int excess(int q) { return q < 0 ? -q : (q > 7 ? q - 7 : 0); }

// the box index of voxel (x, y, z), each in [-H, 8 + H)
template <int S>
__device__ __forceinline__ int box_at(int x, int y, int z) {
  using V = VcShape<S>;
  return ((x + V::H) * V::B + (y + V::H)) * V::B + (z + V::H);
}

// omega at the voxel of box index i, from the box's components u[0..2]
template <int S>
__device__ __forceinline__ void curl_at(const float* u, int i, float factor, float w[3]) {
  constexpr int DX = VcShape<S>::B * VcShape<S>::B, DY = VcShape<S>::B, DZ = 1;
  const float* ux = u;
  const float* uy = u + VcShape<S>::BOX;
  const float* uz = u + 2 * VcShape<S>::BOX;
  w[0] = mul(sub(sub(uz[i + DY], uz[i - DY]), sub(uy[i + DZ], uy[i - DZ])), factor);
  w[1] = mul(sub(sub(ux[i + DZ], ux[i - DZ]), sub(uz[i + DX], uz[i - DX])), factor);
  w[2] = mul(sub(sub(uy[i + DX], uy[i - DX]), sub(ux[i + DY], ux[i - DY])), factor);
}

__device__ __forceinline__ float norm3(float a, float b, float c) {
  return __fsqrt_rn(add(add(mul(a, a), mul(b, b)), mul(c, c)));
}

// the index in the |omega| set of voxel q, one coordinate q[a] in
// [-S, 8 + S) and the others in [0, 8)
template <int S>
__device__ __forceinline__ int mag_index(int x, int y, int z) {
  constexpr int SLAB = VcShape<S>::SLAB;
  if ((unsigned)x < 8 && (unsigned)y < 8 && (unsigned)z < 8) return x * 64 + y * 8 + z;
  if ((unsigned)x >= 8)
    return TILE + (x >= 8 ? SLAB + (x - 8) * 64 : (-1 - x) * 64) + y * 8 + z;
  if ((unsigned)y >= 8)
    return TILE + 2 * SLAB + (y >= 8 ? SLAB + (y - 8) * 64 : (-1 - y) * 64) + x * 8 + z;
  return TILE + 4 * SLAB + (z >= 8 ? SLAB + (z - 8) * 64 : (-1 - z) * 64) + x * 8 + y;
}

template <int S>
__global__ void __launch_bounds__(VC_THREADS)
vorticity_kernel(const float* __restrict__ vel, const int* __restrict__ nbr,
                 float* __restrict__ out, int T, bool negative, float factor, float scale,
                 float dt) {
  using V = VcShape<S>;
  extern __shared__ float smem[];
  float* u = smem;                 // [3][BOX]
  float* mags = smem + 3 * V::BOX;  // [MAGS]
  __shared__ int nb[27];
  const int t = blockIdx.x;
  const size_t plane = (size_t)T * TILE;
  if (threadIdx.x < 27) nb[threadIdx.x] = nbr[(size_t)t * 27 + threadIdx.x];
  __syncthreads();

  // 1. the box, from the neighbour rows (unrolled, so that a thread has
  // several iterations' loads in flight at once)
#pragma unroll 4
  for (int i = threadIdx.x; i < V::BOX; i += VC_THREADS) {
    const int bz = i % V::B, by = (i / V::B) % V::B, bx = i / (V::B * V::B);
    const int x = bx - V::H, y = by - V::H, z = bz - V::H;
    const int ex = excess(x), ey = excess(y), ez = excess(z);
    const int outside = (ex > 0) + (ey > 0) + (ez > 0);
    const int far = max(ex, max(ey, ez));
    const int near = ex + ey + ez - far;  // the smaller excess when two are outside
    if (outside == 3 || (outside == 2 && (near != 1 || far > S))) continue;
    const int d = ((x + 8) >> 3) * 9 + ((y + 8) >> 3) * 3 + ((z + 8) >> 3);
    const size_t at = (size_t)nb[d] * TILE + (x & 7) * 64 + (y & 7) * 8 + (z & 7);
    const float a = __ldg(vel + at), b = __ldg(vel + plane + at), c = __ldg(vel + 2 * plane + at);
    u[i] = a;
    u[V::BOX + i] = b;
    u[2 * V::BOX + i] = c;
  }
  __syncthreads();

  // 2. |omega| on the cross-shaped set: first the tile's own voxels, two a
  // thread as step 4 takes them (omega there is kept for step 4), then the
  // six slabs
  float w[TILE / VC_THREADS][3];
#pragma unroll
  for (int h = 0; h < TILE / VC_THREADS; ++h) {
    const int c = threadIdx.x + h * VC_THREADS;
    curl_at<S>(u, box_at<S>(c >> 6, (c >> 3) & 7, c & 7), factor, w[h]);
    mags[c] = norm3(w[h][0], w[h][1], w[h][2]);
  }
  for (int j = TILE + threadIdx.x; j < V::MAGS; j += VC_THREADS) {
    // slab 2a + side of axis a: k voxels beyond the face, then the two
    // other coordinates in axis order (mag_index)
    const int r = j - TILE, slab = r / V::SLAB, k = (r % V::SLAB) >> 6;
    const int p = (r >> 3) & 7, q = r & 7;
    const int c = (slab & 1) ? 8 + k : -1 - k;
    const int axis = slab >> 1;
    const int x = axis == 0 ? c : p;
    const int y = axis == 0 ? p : (axis == 1 ? c : q);
    const int z = axis == 2 ? c : q;
    float wj[3];
    curl_at<S>(u, box_at<S>(x, y, z), factor, wj);
    mags[j] = norm3(wj[0], wj[1], wj[2]);
  }
  __syncthreads();

  // 3. the null and padding rows: omega(v) and u(v) read row t itself
  if (nb[13] != t) {
    for (int c = threadIdx.x; c < TILE; c += VC_THREADS) {
      const int i = box_at<S>(c >> 6, (c >> 3) & 7, c & 7);
      const size_t at = (size_t)t * TILE + c;
      u[i] = vel[at];
      u[V::BOX + i] = vel[plane + at];
      u[2 * V::BOX + i] = vel[2 * plane + at];
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < TILE / VC_THREADS; ++h) {
      const int c = threadIdx.x + h * VC_THREADS;
      curl_at<S>(u, box_at<S>(c >> 6, (c >> 3) & 7, c & 7), factor, w[h]);
    }
  }

  // 4. the force at each voxel
#pragma unroll
  for (int h = 0; h < TILE / VC_THREADS; ++h) {
    const int c = threadIdx.x + h * VC_THREADS;
    const int x = c >> 6, y = (c >> 3) & 7, z = c & 7;
    const int i = box_at<S>(x, y, z);
    const int sp = negative ? -S : S;
    const float g[3] = {
        mul(sub(mags[mag_index<S>(x + sp, y, z)], mags[mag_index<S>(x - sp, y, z)]), factor),
        mul(sub(mags[mag_index<S>(x, y + sp, z)], mags[mag_index<S>(x, y - sp, z)]), factor),
        mul(sub(mags[mag_index<S>(x, y, z + sp)], mags[mag_index<S>(x, y, z - sp)]), factor)};
    const float glen = add(norm3(g[0], g[1], g[2]), 1e-5f);
    float n[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) n[a] = __fdiv_rn(g[a], glen);
    const float* wv = w[h];
    const float f[3] = {sub(mul(n[1], wv[2]), mul(n[2], wv[1])),
                        sub(mul(n[2], wv[0]), mul(n[0], wv[2])),
                        sub(mul(n[0], wv[1]), mul(n[1], wv[0]))};
    const size_t at = (size_t)t * TILE + c;
#pragma unroll
    for (int a = 0; a < 3; ++a)
      out[a * plane + at] = add(u[a * V::BOX + i], mul(mul(scale, f[a]), dt));
  }
}

template <int S>
cudaError_t launch_vorticity(const float* vel, const int* nbr, float* out, int T, bool negative,
                             float factor, float scale, float dt, cudaStream_t stream) {
  static SmemLimit limit;
  const size_t bytes = VcShape<S>::SMEM;
  cudaError_t e = raise_smem_limit(vorticity_kernel<S>, bytes, limit);
  if (e != cudaSuccess) return e;
  vorticity_kernel<S><<<T, VC_THREADS, bytes, stream>>>(vel, nbr, out, T, negative, factor,
                                                         scale, dt);
  return cudaGetLastError();
}

}  // namespace hn

// vel [3, T, 512] f32, nbr [T, 27] i32, out [3, T, 512] f32; s the offset,
// 1 <= |s| <= 7; factor = float32(0.5 * inv_dx), scale and dt as float32.
extern "C" int hn_vorticity_confinement(const void* vel, const void* nbr, void* out, int T, int s,
                                        float factor, float scale, float dt, void* stream) {
  const int S = s < 0 ? -s : s;
  if (T <= 0 || S < 1 || S > hn::VC_MAX_OFFSET) return (int)cudaErrorInvalidValue;
  const float* v = static_cast<const float*>(vel);
  const int* n = static_cast<const int*>(nbr);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool neg = s < 0;
  switch (S) {
    case 1: return (int)hn::launch_vorticity<1>(v, n, o, T, neg, factor, scale, dt, st);
    case 2: return (int)hn::launch_vorticity<2>(v, n, o, T, neg, factor, scale, dt, st);
    case 3: return (int)hn::launch_vorticity<3>(v, n, o, T, neg, factor, scale, dt, st);
    case 4: return (int)hn::launch_vorticity<4>(v, n, o, T, neg, factor, scale, dt, st);
    case 5: return (int)hn::launch_vorticity<5>(v, n, o, T, neg, factor, scale, dt, st);
    case 6: return (int)hn::launch_vorticity<6>(v, n, o, T, neg, factor, scale, dt, st);
    default: return (int)hn::launch_vorticity<7>(v, n, o, T, neg, factor, scale, dt, st);
  }
}
