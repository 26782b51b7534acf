// MR and MP: multigrid's transfers between a level and the next coarser one
// (ops/multigrid.py), on [T, 512] rows of 8^3 tiles.
//
// Neither replaces a TPU kernel: in the JAX package XLA computed the
// transfers (hnanosolver_tpu/ops/multigrid.py, plain jnp), so the port's
// first form was plain PyTorch too, ~100 ops a level (rolls, lane gathers,
// row gathers, stacks). ops/multigrid.py keeps that form as restrict_plain /
// prolong_trilinear_plain; each kernel here is bitwise equal to it.
//
// MR, restriction: coarse row c, lane (ox*4+a, oy*4+b, oz*4+cz) is the mean
// of the 2x2x2 block (2a.., 2b.., 2cz..) of fine row children[c, o], o =
// ox*4 + oy*2 + oz (row 0 where the child is absent, as the plain gather
// reads it). The sum is the plain form's: pairs along z, then y, then x,
//   (((f[l]+f[l+1]) + (f[l+8]+f[l+9])) + ((f[l+64]+f[l+65]) + (f[l+72]+f[l+73])))
// times 0.125, adds only. Optional fused masks: the fine values times
// fmask before the sum (v_cycle's r * mask) and the result times cmask
// (v_cycle's and the FMG start's rc * level.mask), multiplies the plain
// form makes as separate ops, in the same places.
//
// MP, trilinear prolongation fused with the add: fine row f, parent P =
// parent[f], octant o = octant[f], fine voxel (x, y, z) sits in coarse cell
// c = (ox*4 + x/2, oy*4 + y/2, oz*4 + z/2) with parities (x&1, y&1, z&1); a
// set parity bit means the +1 coarse neighbour along that axis, a clear
// one the -1 neighbour. The plain form evaluates
//   X = 0.75*F + 0.25*F(+-x),  Y = 0.75*X + 0.25*X(+-y),  Z = 0.75*Y + 0.25*Y(+-z)
// as three passes of face-shifted views over the whole coarse level: the
// z pass reads Y across a tile face through nbr[P, +-z], the y pass reads
// X across a face of THAT tile, and the x pass F across a face of the tile
// the y step reached. So a coarse value beyond an edge or a corner is
// reached by chained face steps, z first, then y, then x; where a face tile
// on the chain is absent the chain goes through row 0 (and row 0's own nbr
// entries), even when the nbr table's corner entry exists. The kernel
// builds the same chain (8 tiles a fine row, lanes 0-7 one each) and never
// reads the table's edge or corner entries. Each product and sum is rounded
// on its own (__fmul_rn, __fadd_rn: no FMA), in the plain order; then
// p + Z (v_cycle) or Z alone (the FMG start), times mask if given.
//
// What bounds them on the H100: memory, both. MR must read every child row
// once and write the coarse rows (at config 5's level 1: 551 MB + 92 MB,
// 0.19 ms at 3.35 TB/s); MP must read p and write the result (2 x 551 MB)
// and read the coarse rows (92 MB): 0.36 ms. The plain chains move several
// times that through ~50 launches each. The designs move each byte once:
// MR, a block a coarse tile and a warp a child, loads every child row in
// full sectors (float4 a lane, two lanes a 32-byte sector), stages the
// 64 means of each child at their assembled lanes in shared memory and
// stores the coarse row as one coalesced 2 KB row. MP, a warp a fine
// tile, loads and stores p in float4 (one 512-byte run a warp
// instruction), stages the coarse 6^3 neighbourhood of the fine tile's
// octant block (216 values from at most 8 coarse rows) in shared memory
// and evaluates every fine voxel from there. Fine rows run in row order, so
// the rows sharing a parent (and its neighbours) run close together and the
// L2 serves the coarse re-reads.
#include "common.cuh"

namespace hn {

constexpr int MR_THREADS = 256;  // a block a coarse tile, a warp a child (octant)
constexpr int MP_WARPS = 4;      // a warp a fine tile, 4 a block
constexpr int NB = 6;            // the neighbourhood's edge: the octant block +- 1
constexpr int NB3 = NB * NB * NB;

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(mul(a.x, b.x), mul(a.y, b.y), mul(a.z, b.z), mul(a.w, b.w));
}

// The plain form's block sum for the two z pairs of float4 lanes (x, y),
// (x, y+1), (x+1, y), (x+1, y+1): pair j of each is lanes 2j, 2j+1.
__device__ __forceinline__ float block_sum(const float4* v, int j) {
  const float a0 = j ? v[0].z : v[0].x, a1 = j ? v[0].w : v[0].y;
  const float b0 = j ? v[1].z : v[1].x, b1 = j ? v[1].w : v[1].y;
  const float c0 = j ? v[2].z : v[2].x, c1 = j ? v[2].w : v[2].y;
  const float d0 = j ? v[3].z : v[3].x, d1 = j ? v[3].w : v[3].y;
  return add(add(add(a0, a1), add(b0, b1)), add(add(c0, c1), add(d0, d1)));
}

template <bool FMASK, bool CMASK>
__global__ void __launch_bounds__(MR_THREADS)
mg_restrict_kernel(const float* __restrict__ fine, const int* __restrict__ children,
                   const float* __restrict__ fmask, const float* __restrict__ cmask,
                   float* __restrict__ out) {
  __shared__ __align__(16) float tile[TILE];
  const int c = blockIdx.x;
  const int o = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // lane -> the two means (a, b, 2h) and (a, b, 2h + 1) of the child's 4^3
  const int a = lane >> 3, b = (lane >> 1) & 3, h = lane & 1;
  const size_t row = (size_t)__ldg(children + (size_t)c * 8 + o) * TILE;
  const int l = (2 * a) * 64 + (2 * b) * 8 + 4 * h;
  // v[k]: the column (x + k/2, y + k%2), lanes z = 4h..4h+3
  float4 v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = ld4(fine + row + l + (k >> 1) * 64 + (k & 1) * 8);
  if (FMASK) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = mul4(v[k], ld4(fmask + row + l + (k >> 1) * 64 + (k & 1) * 8));
  }
  const int ox = (o >> 2) & 1, oy = (o >> 1) & 1, oz = o & 1;
  const int m = (ox * 4 + a) * 64 + (oy * 4 + b) * 8 + oz * 4 + 2 * h;
  tile[m] = mul(block_sum(v, 0), 0.125f);
  tile[m + 1] = mul(block_sum(v, 1), 0.125f);
  __syncthreads();
  if (threadIdx.x < TILE / 4) {
    float4 r = reinterpret_cast<const float4*>(tile)[threadIdx.x];
    const size_t at = (size_t)c * TILE + 4 * threadIdx.x;
    if (CMASK) r = mul4(r, ld4(cmask + at));
    *reinterpret_cast<float4*>(out + at) = r;
  }
}

// 0.75 * a + 0.25 * b, each product rounded, then the sum
__device__ __forceinline__ float lerp_q(float a, float b) {
  return add(mul(0.75f, a), mul(0.25f, b));
}

template <bool HAS_P, bool MASK>
__global__ void __launch_bounds__(MP_WARPS * 32)
mg_prolong_kernel(const float* __restrict__ coarse, const int* __restrict__ nbr,
                  const int* __restrict__ parent, const int* __restrict__ octant,
                  const float* __restrict__ p, const float* __restrict__ mask,
                  float* __restrict__ out, int Tf) {
  __shared__ float nb_all[MP_WARPS][NB3];
  __shared__ int tiles_all[MP_WARPS][8];
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f = blockIdx.x * MP_WARPS + g;
  if (f >= Tf) return;  // a warp a tile: no block-wide barrier below
  float* nb = nb_all[g];
  int* tiles = tiles_all[g];
  const size_t frow = (size_t)f * TILE;
  float4 pv[4];
  if (HAS_P) {  // in flight while the maps and the neighbourhood load
#pragma unroll
    for (int n = 0; n < 4; ++n) pv[n] = ld4(p + frow + 4 * (lane + 32 * n));
  }
  const int P = __ldg(parent + f), o = __ldg(octant + f);
  const int ox = (o >> 2) & 1, oy = (o >> 1) & 1, oz = o & 1;
  // the 8 tiles the chains reach, entry zo*4 + yo*2 + xo: a set bit is one
  // face step off the octant block's side of P, z first, then y, then x
  if (lane < 8) {
    int t = P;
    if (lane & 4) t = __ldg(nbr + (size_t)t * 27 + (oz ? D_PZ : D_MZ));
    if (lane & 2) t = __ldg(nbr + (size_t)t * 27 + (oy ? D_PY : D_MY));
    if (lane & 1) t = __ldg(nbr + (size_t)t * 27 + (ox ? D_PX : D_MX));
    tiles[lane] = t;
  }
  __syncwarp();
  // neighbourhood entry (i, j, k) <-> coarse (ox*4 - 1 + i, oy*4 - 1 + j, oz*4 - 1 + k)
  for (int e = lane; e < NB3; e += 32) {
    const int cx = ox * 4 - 1 + e / (NB * NB), cy = oy * 4 - 1 + (e / NB) % NB,
              cz = oz * 4 - 1 + e % NB;
    const int out_of = ((unsigned)cz > 7u) * 4 + ((unsigned)cy > 7u) * 2 + ((unsigned)cx > 7u);
    nb[e] = __ldg(coarse + (size_t)tiles[out_of] * TILE + (cx & 7) * 64 + (cy & 7) * 8 +
                  (cz & 7));
  }
  __syncwarp();
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int q = lane + 32 * n;  // float4 q: lanes 4q..4q+3 of the fine tile
    const int x = q >> 4, y = (q >> 1) & 7, z0 = (q & 1) * 4;
    const int sx = (x & 1) ? NB * NB : -NB * NB, sy = (y & 1) ? NB : -NB;
    const int base = ((x >> 1) + 1) * NB * NB + ((y >> 1) + 1) * NB;
    float r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int z = z0 + j;
      const int c0 = base + (z >> 1) + 1, sz = (z & 1) ? 1 : -1;
      const float x00 = lerp_q(nb[c0], nb[c0 + sx]);
      const float x10 = lerp_q(nb[c0 + sy], nb[c0 + sy + sx]);
      const float x01 = lerp_q(nb[c0 + sz], nb[c0 + sz + sx]);
      const float x11 = lerp_q(nb[c0 + sz + sy], nb[c0 + sz + sy + sx]);
      r[j] = lerp_q(lerp_q(x00, x10), lerp_q(x01, x11));
    }
    float4 res = make_float4(r[0], r[1], r[2], r[3]);
    if (HAS_P)
      res = make_float4(add(pv[n].x, res.x), add(pv[n].y, res.y), add(pv[n].z, res.z),
                        add(pv[n].w, res.w));
    const size_t at = frow + 4 * q;
    if (MASK) res = mul4(res, ld4(mask + at));
    *reinterpret_cast<float4*>(out + at) = res;
  }
}

}  // namespace hn

// fine [Tf, 512], children [Tc, 8] i32, fmask [Tf, 512] or null, cmask and
// out [Tc, 512]; the float arrays 16-byte aligned (float4 loads and stores).
extern "C" int hn_mg_restrict(const void* fine, const void* children, const void* fmask,
                              const void* cmask, void* out, int Tc, void* stream) {
  if (Tc <= 0) return (int)cudaErrorInvalidValue;
  const float* f = static_cast<const float*>(fine);
  const int* ch = static_cast<const int*>(children);
  const float* fm = static_cast<const float*>(fmask);
  const float* cm = static_cast<const float*>(cmask);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fm == nullptr && cm == nullptr)
    hn::mg_restrict_kernel<false, false><<<Tc, hn::MR_THREADS, 0, s>>>(f, ch, fm, cm, o);
  else if (fm == nullptr)
    hn::mg_restrict_kernel<false, true><<<Tc, hn::MR_THREADS, 0, s>>>(f, ch, fm, cm, o);
  else if (cm == nullptr)
    hn::mg_restrict_kernel<true, false><<<Tc, hn::MR_THREADS, 0, s>>>(f, ch, fm, cm, o);
  else
    hn::mg_restrict_kernel<true, true><<<Tc, hn::MR_THREADS, 0, s>>>(f, ch, fm, cm, o);
  return (int)cudaGetLastError();
}

// coarse [Tc, 512], nbr [Tc, 27] i32 (the coarse level's), parent and octant
// [Tf] i32, p, mask (each may be null) and out [Tf, 512]; p, mask and out
// 16-byte aligned, out apart from p (p is read through the read-only path).
extern "C" int hn_mg_prolong(const void* coarse, const void* nbr, const void* parent,
                             const void* octant, const void* p, const void* mask, void* out,
                             int Tf, void* stream) {
  if (Tf <= 0) return (int)cudaErrorInvalidValue;
  const float* c = static_cast<const float*>(coarse);
  const int* n = static_cast<const int*>(nbr);
  const int* pa = static_cast<const int*>(parent);
  const int* oc = static_cast<const int*>(octant);
  const float* pp = static_cast<const float*>(p);
  const float* m = static_cast<const float*>(mask);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (Tf + hn::MP_WARPS - 1) / hn::MP_WARPS;
  constexpr int threads = hn::MP_WARPS * 32;
  if (pp == nullptr && m == nullptr)
    hn::mg_prolong_kernel<false, false><<<blocks, threads, 0, s>>>(c, n, pa, oc, pp, m, o, Tf);
  else if (pp == nullptr)
    hn::mg_prolong_kernel<false, true><<<blocks, threads, 0, s>>>(c, n, pa, oc, pp, m, o, Tf);
  else if (m == nullptr)
    hn::mg_prolong_kernel<true, false><<<blocks, threads, 0, s>>>(c, n, pa, oc, pp, m, o, Tf);
  else
    hn::mg_prolong_kernel<true, true><<<blocks, threads, 0, s>>>(c, n, pa, oc, pp, m, o, Tf);
  return (int)cudaGetLastError();
}
