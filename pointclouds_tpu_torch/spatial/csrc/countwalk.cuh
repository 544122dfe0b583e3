// The register-tiled pair walk for Hopper: one warp holds all 128 queries
// of a block, kCountQ = 4 a lane (query lane + 32 u), and applies a
// per-pair action (an Op, below) to each against candidate rows streamed
// through the cp.async ring of warpselect.cuh (walk_rows), d2 pinned as
// d2_rn. It takes its rows from a RowAt (step t -> candidate row), as
// select_rows and the min-label walk do. Its users:
//   * brute_radius_count (kernel 14, brute.cu): counts d2 <= the query's
//     r2 over every row (WithinQueryR2);
//   * count_within (kernel 11, radius.cu): counts d2 <= the candidate's
//     r2 over the block's nine windows (WithinCandR2);
//   * nn_argmin (kernel 15, nn.cu): the smallest d2 and its position over
//     every row (Nearest, in nn.cu).
//
// Replaces the per-thread walk: a thread per query, every candidate row
// staged by the block behind two barriers, and four broadcast shared
// loads (x, y, z, w) per pair for the one query the thread holds.
//
// Bound on Hopper: operations. A pair is the pinned d2 (three
// subtractions, a multiply, two fmas), the compare and one or two
// predicated moves or adds: 8 or 9 issued instructions. Shared loads and
// masking stay off that stream: each candidate comes from shared memory
// in a float4 broadcast (four candidates a load, the same address on
// every lane) and feeds the lane's four queries; a masked candidate gets
// its x replaced once (Op::mask), so that no compare of its d2 holds,
// with no branch in the pair loop. The warps that share a block's
// queries split each staged tile's rows and combine their results at the
// end (sum_warps for counts: integers, exact in any order).
#pragma once
#include "warpselect.cuh"

constexpr int kCountQ = kLanes / 32;  // queries a lane holds

#define kNaN __int_as_float(0x7fffffff)

// n += (d2 <= r2) as a compare and a predicated add (false for NaN).
__device__ __forceinline__ void add_within(int& n, float d2, float r2) {
  asm("{\n\t.reg .pred p;\n\tsetp.le.f32 p, %1, %2;\n\t"
      "@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(n)
      : "f"(d2), "f"(r2));
}

// A per-pair action: State is what a query keeps; init sets it from the
// query's w (it may make the query's x NaN, so that no pair of it
// counts) and says whether the query is live; mask gives a candidate's x
// as the pairs see it; pair folds in one pair's d2, with the candidate's
// w and flat position.

// Kernel 14: the valid candidates (w > 0.5) with d2 <= the query's r2
// (its w; r2 < 0 marks an invalid query, which no d2 is below).
struct WithinQueryR2 {
  struct State {
    float r2;
    int n;
  };
  __device__ static bool init(State& s, float& x, float w) {
    s.r2 = w;
    s.n = 0;
    return w >= 0.0f;
  }
  __device__ static float mask(float cx, float cw) {
    return cw > 0.5f ? cx : kNaN;  // masked: d2 NaN, no compare holds
  }
  __device__ static void pair(State& s, float d2, float, int) {
    add_within(s.n, d2, s.r2);
  }
};

// Kernel 11: a pair counts iff the query and the candidate are valid (w
// > 0: w is r2 for a valid point, 0 for a masked one) and d2 <= the
// CANDIDATE's r2. Both sides are masked to NaN: a masked candidate's w
// of 0 would count a duplicate point (d2 0).
struct WithinCandR2 {
  struct State {
    int n;
  };
  __device__ static bool init(State& s, float& x, float w) {
    s.n = 0;
    const bool valid = w > 0.0f;
    x = valid ? x : kNaN;
    return valid;
  }
  __device__ static float mask(float cx, float cw) {
    return cw > 0.0f ? cx : kNaN;
  }
  __device__ static void pair(State& s, float d2, float cw, int) {
    add_within(s.n, d2, cw);
  }
};

// The 128 queries of one planar query row, queries lane + 32 u of this
// lane, each with its Op state.
template <class Op>
struct QueryTile {
  float x[kCountQ], y[kCountQ], z[kCountQ];
  typename Op::State st[kCountQ];

  // Load the lane's queries from planar row `q`; whether any is live.
  __device__ bool load(const float* __restrict__ q, int lane) {
    bool any = false;
#pragma unroll
    for (int u = 0; u < kCountQ; ++u) {
      const int j = lane + 32 * u;
      x[u] = q[j];
      y[u] = q[kLanes + j];
      z[u] = q[2 * kLanes + j];
      any |= Op::init(st[u], x[u], q[3 * kLanes + j]);
    }
    return any;
  }

  __device__ __forceinline__ void candidate(float cx, float cy, float cz,
                                            float cw, int pos) {
    cx = Op::mask(cx, cw);
#pragma unroll
    for (int u = 0; u < kCountQ; ++u)
      Op::pair(st[u], d2_rn(x[u], y[u], z[u], cx, cy, cz), cw, pos);
  }

  // The 128 candidates of staged row `s` ([x | y | z | w], 128 each), in
  // ascending position from pos0. Four float4 steps an iteration: 1%
  // faster than two on the H100 at the fused ROR op's full capture, the
  // whole row unrolled 25% slower.
  __device__ __forceinline__ void row(const float* s, int pos0) {
    const float4* v = reinterpret_cast<const float4*>(s);
#pragma unroll 4
    for (int c = 0; c < kLanes / 4; ++c) {
      const float4 cx = v[c], cy = v[32 + c], cz = v[64 + c],
                   cw = v[96 + c];
      const int p = pos0 + 4 * c;
      candidate(cx.x, cy.x, cz.x, cw.x, p);
      candidate(cx.y, cy.y, cz.y, cw.y, p + 1);
      candidate(cx.z, cy.z, cz.z, cw.z, p + 2);
      candidate(cx.w, cy.w, cz.w, cw.w, p + 3);
    }
  }
};

// Walk `nrows` rows of `pts` (the t-th is row_at(t)) into `tile`: the
// CTA's warps (kThreads / 32, all holding the same queries) split each
// staged 8-row tile's rows, each visiting its rows in ascending order.
// Every thread of the CTA calls this with the same nrows; the ring `sh`
// is free again when it returns.
template <int kThreads, class RowAt, class Op>
__device__ __forceinline__ void walk_tile(const float* __restrict__ pts,
                                          RowAt row_at, int nrows,
                                          float* sh, QueryTile<Op>& tile) {
  walk_rows<kThreads>(pts, row_at, nrows, sh, true, threadIdx.x / 32,
                      kThreads / 32, [&](const float* s, int t) {
                        tile.row(s, (int)row_at(t) * kLanes);
                      });
}

// The CTA's counts of query i (< 128), summed over its W warps through
// part [W * 128] (shared), go to emit(i, total) on thread i % (W * 32).
// Every thread of the CTA calls this.
template <int W, class Op, class Emit>
__device__ __forceinline__ void sum_warps(const QueryTile<Op>& tile,
                                          int* part, Emit emit) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < kCountQ; ++u)
    part[warp * kLanes + lane + 32 * u] = tile.st[u].n;
  __syncthreads();
  for (int i = threadIdx.x; i < kLanes; i += W * 32) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) total += part[w * kLanes + i];
    emit(i, total);
  }
}

// Whether this CTA is the last of the C that share counter `arrived` (a
// query block's CTAs, which combine their results in device memory first):
// its results are fenced before it arrives, and the last one fences again
// before it reads the others' and resets the counter for the next call.
// Every thread of the CTA calls this; `flag` is a shared int.
__device__ __forceinline__ bool last_to_arrive(unsigned* arrived, int C,
                                               int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    *flag = atomicAdd(arrived, 1u) == (unsigned)C - 1;
    if (*flag) *arrived = 0;  // every CTA of the block has arrived
  }
  __syncthreads();
  if (*flag) __threadfence();
  return *flag;
}
