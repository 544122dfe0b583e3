// Exact 1-NN over a whole planar target: the ICP correspondence search.
//
// Replaces pointclouds_tpu/spatial/pallas_kernels.py::nn_argmin (kernel body
// _nn_argmin_kernel). Per query: the smallest d2 over the valid candidates
// (+inf if none) and its flat position row * 128 + lane as f32; among equal
// d2 the LAST position wins (the TPU kernel's per-lane `<=` overwrite and
// max-position tie extraction, the same rule as the JAX package's XLA
// path). With no valid candidate every d2 is +inf, so the last position of
// the target wins, as on the TPU. d2 is pinned to fma(dz, dz, fma(dx, dx,
// dy*dy)) (common.cuh), the form XLA's CPU backend gives the TPU kernel's
// (q - c)**2 sum. A query with w <= 0.5 or a non-finite coordinate gets
// (+inf, -1): the TPU kernel leaves such rows undefined and its callers
// mask them.
//
// Design: one launch of the register-tiled walk (countwalk.cuh) with the
// Nearest action: kNnWarps warps a CTA, each holding the block's 128
// queries (four a lane), C CTAs a query block, CTA s walking its
// contiguous share of the target's rows through the cp.async ring, its
// warps splitting each staged tile's rows. A pair is the pinned d2, a `<=`
// compare and two predicated moves (the d2 and the position, which is
// uniform over the warp and formed once a candidate); a masked candidate
// (w <= 0.5) gets x = +inf, so its d2 is +inf: it never beats a valid one
// but keeps the last-position rule when no candidate is valid. Each warp
// walks its rows in ascending position, so `<=` leaves it the last of its
// ties. Partial results combine as 64-bit keys (d2 bits above, 0xFFFFFFFF -
// position below: d2 is never negative, so the least key is the smallest
// d2, ties to the largest position, the winner of one ascending walk):
// the warps' through shared memory, the CTAs' with atomicMin into a key
// scratch kept per device and stream. The last CTA of a block to arrive (a
// counter per block after a __threadfence) writes the block's d2 and
// positions and leaves its keys all-ones and its counter zero for the next
// call: one device launch a call, no memset and no merge kernel. Bound on
// Hopper: operations (9 issued instructions a pair; each staged row is
// reused by 128 queries); the target (160 KB at 10K) stays in L2.
#include <math.h>

#include "countwalk.cuh"

namespace {

// The smallest d2 and its position: d2 <= best moves both (predicated).
struct Nearest : PointD2 {
  struct State {
    float best;
    int pos;
  };
  // Live: w > 0.5 (whether a live query is served, `served` decides).
  __device__ static bool init(State& s, float&, float w) {
    s.best = kInf;
    s.pos = -1;
    return w > 0.5f;
  }
  __device__ static float mask(float cx, float cw) {
    return cw > 0.5f ? cx : kInf;  // masked: d2 +inf
  }
  __device__ static void pair(State& s, float d2, float, int pos) {
    asm("{\n\t.reg .pred p;\n\tsetp.le.f32 p, %2, %0;\n\t"
        "@p mov.f32 %0, %2;\n\t@p mov.b32 %1, %3;\n\t}"
        : "+f"(s.best), "+r"(s.pos)
        : "f"(d2), "r"(pos));
  }
};

// A state's key: the least is the smallest d2, ties to the largest
// position; a warp that walked no row has the largest.
__device__ __forceinline__ Key nearest_key(const Nearest::State& s) {
  return s.pos < 0 ? key_none<Key>()
                   : make_key(s.best, (int)(0xffffffffu - (unsigned)s.pos));
}

// Whether query j of planar row q is served.
__device__ __forceinline__ bool served(const float* q, int j) {
  return q[3 * kLanes + j] > 0.5f && isfinite(q[j]) &&
         isfinite(q[kLanes + j]) && isfinite(q[2 * kLanes + j]);
}

// q: [qb, 4, 128]; cand: [nr, 4, 128]; out: [2, qb * 128]; keys [qb * 128]
// all-ones and arrived [qb] zero at the call, and left so. CTA i = b * C
// + s serves query block b, walking rows [nr s / C, nr (s + 1) / C).
template <int W>
__global__ void __launch_bounds__(W * 32)
    nn_kernel(const float* __restrict__ qpl, const float* __restrict__ cand,
              float* __restrict__ out, int qb, int nr, int C, Key* keys,
              unsigned* arrived) {
  __shared__ __align__(16) float sh[kStages * kTileFloats];
  static_assert(W * kLanes * sizeof(Key) < sizeof(sh), "keys fit");
  const int b = blockIdx.x / C;
  const int s = blockIdx.x % C;
  const long long nq = (long long)qb * kLanes;
  const float* q = qpl + (long long)b * kRowFloats;
  float* col = out + (long long)b * kLanes;
  // Unserved queries compute too (their x may be NaN), masked at the end.
  QueryTile<Nearest> tile;
  // The same answer on every CTA of the block.
  if (!__syncthreads_or(tile.load(q, threadIdx.x & 31))) {
    if (s == 0)
      for (int i = threadIdx.x; i < kLanes; i += W * 32) {
        col[i] = kInf;
        col[nq + i] = -1.0f;
      }
    return;
  }
  const int lo = (int)((long long)nr * s / C);
  const int hi = (int)((long long)nr * (s + 1) / C);
  walk_tile<W * 32>(cand, RowsFrom<EveryRow>{{}, lo}, hi - lo, sh, tile);
  Key* part = reinterpret_cast<Key*>(sh);
  int* last = reinterpret_cast<int*>(part + W * kLanes);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < kCountQ; ++u)
    part[warp * kLanes + lane + 32 * u] = nearest_key(tile.st[u]);
  __syncthreads();
  Key* acc = keys + (long long)b * kLanes;
  for (int i = threadIdx.x; i < kLanes; i += W * 32) {
    Key m = part[i];
#pragma unroll
    for (int w = 1; w < W; ++w) m = kmin(m, part[w * kLanes + i]);
    if (m != key_none<Key>()) atomicMin(acc + i, m);
  }
  if (last_to_arrive(arrived + b, C, last))
    for (int i = threadIdx.x; i < kLanes; i += W * 32) {
      const Key m = atomicExch(acc + i, key_none<Key>());
      const bool ok = served(q, i);
      col[i] = ok ? key_value(m) : kInf;
      col[nq + i] = ok ? (float)(0xffffffffu - (unsigned)m) : -1.0f;
    }
}

// Warps per CTA and CTAs of a query block, measured on the H100 at the
// ICP 10K op's capture (79 blocks) and the half-shift lattice (84;
// PERF.md): (W 4, C 8) beat (4, 4) by 6%, (8, 8) and (2, 8) by 12%, and
// every C of 1 or 2 by 39-192%; C 16 and a two-tile ring came within 2%.
// C is the smallest power of two, up to kNnMaxSplit, that gives the call
// kWalkCtasPerSm CTAs an SM (walk_split), so a larger cloud takes fewer.
constexpr int kNnWarps = 4;
constexpr int kNnMaxSplit = 8;

}  // namespace

// out: [2, qb * 128] (d2, then positions as f32); keys [qb * 128], filled
// with all-ones, and arrived [qb], zeroed, once by the caller and left so
// by every call. cand 16-byte aligned.
extern "C" int pc_nn_argmin(const float* q, const float* cand, float* out,
                            int qb, int nr, unsigned long long* keys,
                            unsigned* arrived, void* stream) {
  if (qb == 0) return 0;
  int split = 1;
  const int err = walk_split(qb, kNnMaxSplit, split);
  if (err != 0) return err;
  nn_kernel<kNnWarps><<<qb * split, kNnWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      q, cand, out, qb, nr, split, keys, arrived);
  return (int)cudaGetLastError();
}
