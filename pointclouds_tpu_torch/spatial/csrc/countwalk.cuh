// Register-tiled exact radius counts for Hopper: one warp holds all 128
// queries of a block, kCountQ = 4 a lane (query lane + 32 u), and counts
// for each the valid candidates with d2 <= r2 (inclusive, d2 pinned as
// d2_rn) over candidate rows streamed through the cp.async ring of
// warpselect.cuh (walk_rows). The walk of brute_radius_count (brute.cu);
// it takes its rows from a RowAt (step t -> candidate row), as
// select_rows and the min-label walk do, so the window and group counts
// (kernels 11 and 12) can walk their rows the same way.
//
// Replaces the per-thread count walk: a thread per query, every candidate
// row staged by the block behind two barriers, and four broadcast shared
// loads (x, y, z, w) per pair for the one query the thread holds.
//
// Bound on Hopper: operations. A pair is the pinned d2 (three
// subtractions, a multiply, two fmas), the compare and a predicated
// integer add: 8 issued instructions. Shared loads and masking stay off
// that stream: each candidate comes from shared memory in a float4
// broadcast (four candidates a load, the same address on every lane) and
// feeds the lane's four queries; a masked candidate (w <= 0.5, NaN too)
// gets x = NaN once, so its d2 is NaN and no compare holds, with no branch
// in the pair loop. Counts stay in integer registers (exact in any order);
// the warps that share a block's queries split each staged tile's rows
// and sum their counts at the end (sum_warps).
#pragma once
#include "warpselect.cuh"

constexpr int kCountQ = kLanes / 32;  // queries a lane holds

// n += (d2 <= r2) as a compare and a predicated add (false for NaN).
__device__ __forceinline__ void add_within(int& n, float d2, float r2) {
  asm("{\n\t.reg .pred p;\n\tsetp.le.f32 p, %1, %2;\n\t"
      "@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(n)
      : "f"(d2), "f"(r2));
}

// The 128 queries of one planar query row (w = r2; r2 < 0 marks an
// invalid query, which counts nothing), queries lane + 32 u of this lane,
// and their counts.
struct CountTile {
  float x[kCountQ], y[kCountQ], z[kCountQ], r2[kCountQ];
  int n[kCountQ];

  __device__ void load(const float* __restrict__ q, int lane) {
#pragma unroll
    for (int u = 0; u < kCountQ; ++u) {
      const int j = lane + 32 * u;
      x[u] = q[j];
      y[u] = q[kLanes + j];
      z[u] = q[2 * kLanes + j];
      r2[u] = q[3 * kLanes + j];
      n[u] = 0;
    }
  }

  // Whether this lane holds a valid query (r2 >= 0).
  __device__ bool any_valid() const {
    bool any = false;
#pragma unroll
    for (int u = 0; u < kCountQ; ++u) any |= r2[u] >= 0.0f;
    return any;
  }

  __device__ __forceinline__ void candidate(float cx, float cy, float cz,
                                            float cw) {
    cx = cw > 0.5f ? cx : __int_as_float(0x7fffffff);  // masked: NaN
#pragma unroll
    for (int u = 0; u < kCountQ; ++u)
      add_within(n[u], d2_rn(x[u], y[u], z[u], cx, cy, cz), r2[u]);
  }

  // Count the 128 candidates of staged row `s` ([x | y | z | w], 128 each).
  // Four float4 steps an iteration: 1% faster than two on the H100 at the
  // fused ROR op's full capture, the whole row unrolled 25% slower.
  __device__ __forceinline__ void count_row(const float* s) {
    const float4* v = reinterpret_cast<const float4*>(s);
#pragma unroll 4
    for (int c = 0; c < kLanes / 4; ++c) {
      const float4 cx = v[c], cy = v[32 + c], cz = v[64 + c],
                   cw = v[96 + c];
      candidate(cx.x, cy.x, cz.x, cw.x);
      candidate(cx.y, cy.y, cz.y, cw.y);
      candidate(cx.z, cy.z, cz.z, cw.z);
      candidate(cx.w, cy.w, cz.w, cw.w);
    }
  }
};

// Count over `nrows` rows of `pts` (the t-th is row_at(t)) into `tile`:
// the CTA's warps (kThreads / 32, all holding the same queries) split each
// staged 8-row tile's rows. Every thread of the CTA calls this with the
// same nrows; the ring `sh` is free again when it returns.
template <int kThreads, class RowAt>
__device__ __forceinline__ void count_rows(const float* __restrict__ pts,
                                           RowAt row_at, int nrows,
                                           float* sh, CountTile& tile) {
  walk_rows<kThreads>(pts, row_at, nrows, sh, true, threadIdx.x / 32,
                      kThreads / 32, [&](const float* s, int) {
                        tile.count_row(s);
                      });
}

// The CTA's counts of query i (< 128), summed over its W warps into
// sums[i] through part [W * 128] (both shared). Every thread of the CTA
// calls this; thread i % (W * 32) writes sums[i], and any other thread
// syncs before reading it.
template <int W>
__device__ __forceinline__ void sum_warps(const CountTile& tile, int* part,
                                          int* sums) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < kCountQ; ++u)
    part[warp * kLanes + lane + 32 * u] = tile.n[u];
  __syncthreads();
  for (int i = threadIdx.x; i < kLanes; i += W * 32) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) total += part[w * kLanes + i];
    sums[i] = total;
  }
}
