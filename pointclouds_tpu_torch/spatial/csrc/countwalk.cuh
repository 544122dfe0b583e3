// The register-tiled pair walk for Hopper: one warp holds 128 queries of
// a block, kCountQ = 4 a lane (query lane + 32 u), and applies a per-pair
// action (an Op, below) to each against candidate rows streamed through
// the cp.async ring of warpselect.cuh (walk_rows). The Op gives each pair
// its measure (the pinned d2_rn, or a plane distance) and folds it in. It
// takes its rows from a RowAt (step t -> candidate row), as select_rows
// and the min-label walk do. Its users:
//   * brute_radius_count (kernel 14, brute.cu): counts d2 <= the query's
//     r2 over every row (WithinQueryR2), C CTAs a block (count_block);
//   * rescue_radius_count_groups (kernel 12, radius.cu): the same over
//     the rows of the block's active groups (GroupRows);
//   * count_within (kernel 11, radius.cu): counts d2 <= the candidate's
//     r2 over the block's nine windows (WithinCandR2);
//   * nn_argmin (kernel 15, nn.cu): the smallest d2 and its position over
//     every row (Nearest, in nn.cu);
//   * ransac_score_counts (kernel 5, ransac.cu): a tile holds 128 plane
//     hypotheses in the query slots and counts the points within each
//     one's threshold over every row (WithinPlane, in ransac.cu; also
//     count_block).
//
// Replaces the per-thread walk: a thread per query, every candidate row
// staged by the block behind two barriers, and four broadcast shared
// loads (x, y, z, w) per pair for the one query the thread holds.
//
// Bound on Hopper: operations. A pair is the pinned d2 (three
// subtractions, a multiply, two fmas), the compare and one or two
// predicated moves or adds: 8 or 9 issued instructions (a plane pair 6).
// Shared loads and masking stay off that stream: each candidate comes
// from shared memory in a float4 broadcast (four candidates a load, the
// same address on every lane) and feeds the lane's four queries; a masked
// candidate gets its x replaced once (Op::mask), so that no compare of
// its measure holds, with no branch in the pair loop. The warps that
// share a block's queries split each staged tile's rows and combine their
// results at the end (sum_warps for counts: integers, exact in any order).
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
// as the pairs see it; measure gives a pair's measure from the query's
// slots and state and the candidate; pair folds it in, with the
// candidate's w and flat position.

// The measure of the point queries: the pinned d2.
struct PointD2 {
  template <class State>
  __device__ static float measure(const State&, float x, float y, float z,
                                  float cx, float cy, float cz) {
    return d2_rn(x, y, z, cx, cy, cz);
  }
};

// Kernels 14 and 12: the valid candidates (w > 0.5) with d2 <= the
// query's r2 (its w; r2 < 0 marks an invalid query, which no d2 is below).
struct WithinQueryR2 : PointD2 {
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
struct WithinCandR2 : PointD2 {
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

// The 128 queries of one planar query row (or columns of a column
// layout), queries lane + 32 u of this lane, each with its Op state.
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

  // Load the lane's queries from columns h0 + lane + 32 u of a [R, n]
  // array whose rows 0-2 fill the x, y, z slots; Op::init_column reads the
  // rest of the column (row stride n). Whether any is live.
  __device__ bool load_columns(const float* __restrict__ a, int n, int h0,
                               int lane) {
    bool any = false;
#pragma unroll
    for (int u = 0; u < kCountQ; ++u) {
      const int j = h0 + lane + 32 * u;
      x[u] = a[j];
      y[u] = a[n + j];
      z[u] = a[2 * n + j];
      any |= Op::init_column(st[u], a + 3 * n + j, n);
    }
    return any;
  }

  __device__ __forceinline__ void candidate(float cx, float cy, float cz,
                                            float cw, int pos) {
    cx = Op::mask(cx, cw);
#pragma unroll
    for (int u = 0; u < kCountQ; ++u)
      Op::pair(st[u], Op::measure(st[u], x[u], y[u], z[u], cx, cy, cz), cw,
               pos);
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

// The counts of one block's 128 queries (`tile`, loaded; `live`: whether
// this lane holds a live one) over the n candidate rows rows(0), ...,
// rows(n - 1) of `cand`, on CTA s of the C that share the block: it walks
// steps [n s / C, n (s + 1) / C), adds its counts into `acc` (the block's
// 128, zero at the call) with integer atomics (exact in any order), and
// the block's last CTA to arrive writes them to `col` as f32 (exact:
// below 2^24), leaving `acc` and *arrived zero for the next call. A block
// with no live query, or no row, walks nothing: CTA 0 writes zeros. Every
// thread of the CTA calls this, with the same answer on every CTA of the
// block.
template <int W, class Op, class RowAt>
__device__ __forceinline__ void count_block(QueryTile<Op>& tile, bool live,
                                            const float* __restrict__ cand,
                                            RowAt rows, int n, int s, int C,
                                            float* __restrict__ col,
                                            int* acc, unsigned* arrived,
                                            float* sh) {
  static_assert(W * kLanes < kStages * kTileFloats, "sums fit");
  if (!__syncthreads_or(live) || n == 0) {
    if (s == 0)
      for (int i = threadIdx.x; i < kLanes; i += W * 32) col[i] = 0.0f;
    return;
  }
  const int lo = (int)((long long)n * s / C);
  const int hi = (int)((long long)n * (s + 1) / C);
  walk_tile<W * 32>(cand, RowsFrom<RowAt>{rows, lo}, hi - lo, sh, tile);
  int* part = reinterpret_cast<int*>(sh);
  int* last = part + W * kLanes;  // "this CTA is last"
  sum_warps<W>(tile, part, [&](int i, int total) {
    if (total) atomicAdd(acc + i, total);
  });
  if (last_to_arrive(arrived, C, last))
    for (int i = threadIdx.x; i < kLanes; i += W * 32)
      col[i] = (float)atomicExch(acc + i, 0);
}

// CTAs an SM that walk_split aims for: at 48 KB of ring each, as many as
// fit an SM at once (kernel 15's measured choice, PERF.md).
constexpr int kWalkCtasPerSm = 4;

// CTAs that share one block's walk, for `blocks` blocks on the current
// device: the smallest power of two, up to max_split, that gives the call
// kWalkCtasPerSm CTAs an SM (1 if max_split < 2). The SM count is read
// once per device: a call is short enough that the query would show in
// its host time. Returns a CUDA error, or 0.
inline int walk_split(long long blocks, int max_split, int& split) {
  constexpr int kMaxDevices = 64;
  static int sms[kMaxDevices];  // 0: not read yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  split = 1;
  while (2 * split <= max_split &&
         blocks * split < (long long)kWalkCtasPerSm * sms[dev])
    split *= 2;
  return 0;
}
