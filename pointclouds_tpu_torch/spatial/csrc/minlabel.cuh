// Min-label walk over a 128-query block's candidate rows, the core of the
// two clustering kernels that hop labels over the nine sorted windows:
// cluster_propagate (propagate.cu, the hop loop's Jacobi hop) and
// cluster_multisweep_windows (cluster.cu, rounds with Shiloach-Vishkin
// hooking). Each valid query takes the smallest label among its own and
// those of the valid candidates with d2 <= r2 (inclusive, d2 pinned as
// d2_rn).
//
// Replaces the walk both kernels ran before: a thread per query, every
// candidate row staged by the block behind two barriers with no copy in
// flight, and five shared-memory loads (x, y, z, w, label) per pair.
//
// Bound on Hopper: operations. A pair is the pinned d2 (three
// subtractions, a multiply, two fmas), the compare and a predicated
// integer min: ~9 f32 operations a pair at 67 TFLOP/s in chip_smoke's
// bound, 8 issued instructions (a warp scheduler issues one a cycle, so
// the issue rate caps a pair stream at ~16 pairs an SM a cycle). The walk
// keeps shared loads and bookkeeping off that stream:
//
// * Staging: a kStages-deep ring of kTileRows-row tiles filled by
//   cp.async.cg (as walk_rows in warpselect.cuh), each row's four channels
//   and its 128 labels side by side. cp.async.cg reads L2, as __ldcg does,
//   so labels that another CTA lowered by atomicMin (kernel 8) are read as
//   they stand there.
// * Validity: the thread that staged four candidates rewrites their labels
//   to kLabelFree (INT_MAX) where w <= 0.5 (NaN too) once its own copies
//   land. min(best, INT_MAX) == best, so a masked candidate is exactly a
//   skipped one whatever its coordinates, as the plain versions' both-valid
//   mask. The warp that masked a row keeps its smallest label (rowmin).
// * Query tiling: each lane holds Q queries; every candidate read from
//   shared memory (float4: four candidates a load, a broadcast) feeds Q
//   pairs, so a pair costs 1/Q of a shared load.
// * Row prune (exact): a warp skips a staged row whose rowmin is at or
//   above the largest label its valid queries hold: no candidate of it can
//   lower one. A hop from own positions skips every row after the block's
//   own in sorted order (their labels are larger); once labels settle,
//   most rows.
// * Splitting rows: the warps that hold the same queries take rows slice,
//   slice + S, ... of each staged tile; a minimum does not depend on the
//   order of its inputs, so any split merged by min gives the same bits.
//   (Splitting a block's tiles over 2 or 4 CTAs as well measured slower at
//   both kernels' captures, PERF.md.)
#pragma once
#include <climits>

#include "warpselect.cuh"

// The staged label of a masked candidate: it never lowers a minimum.
constexpr int kLabelFree = INT_MAX;

// best = min(best, label) where d2 <= r2 (false for NaN), as a compare and
// a predicated min: 8 instructions a pair with the d2. Written in C++
// (`if (d2 <= r2) best = min(best, label)`, or a select of label or INT_MAX
// before a min) nvcc emits a compare, an integer compare and a select, 9 a
// pair: 0.65-0.66 against 0.59-0.61 ms of device time at the 1.2M-point
// cloud's first hop (PERF.md).
__device__ __forceinline__ void min_within(int& best, float d2, float r2,
                                           int label) {
  asm("{\n\t.reg .pred p;\n\tsetp.le.f32 p, %1, %2;\n\t"
      "@p min.s32 %0, %0, %3;\n\t}"
      : "+r"(best)
      : "f"(d2), "f"(r2), "r"(label));
}

// A ring stage: kTileRows rows of four channels, then their labels.
constexpr int kMlTileFloats = kTileRows * (kRowFloats + kLanes);
constexpr int kMlRingFloats = kStages * kMlTileFloats;
// Past the ring: rowmin [kStages * kTileRows], the windows' pre [kShifts +
// 1] and base [kShifts] (WindowRows), the block's labels at the walk's
// start [kLanes] (kernel 8's hook).
constexpr int kMlPreInt = kStages * kTileRows;
constexpr int kMlBaseInt = kMlPreInt + kShifts + 1;
constexpr int kMlLabInt = (kMlBaseInt + kShifts + 3) / 4 * 4;
constexpr int kMlSmem = (kMlRingFloats + kMlLabInt + kLanes) * sizeof(int);

__device__ __forceinline__ int* ml_tail(float* sh) {
  return reinterpret_cast<int*>(sh + kMlRingFloats);
}

// Walk the rows row_at(t), t < nrows, in tiles of kTileRows, staging
// channels from `pts` [.., 4, 128] and labels from `labels` [.., 128]
// (both 16-byte aligned) into the ring at `sh`; each warp calls
// visit(channels, labels, rowmin) on rows first, first + step, ... of each
// staged tile. Every thread of the CTA (kThreads) calls this with the same
// arguments but first.
template <int kThreads, class RowAt, class Visit>
__device__ __forceinline__ void walk_label_rows(const float* __restrict__ pts,
                                                const int* labels,
                                                RowAt row_at, int nrows,
                                                float* sh, int first,
                                                int step, Visit visit) {
  static_assert(kThreads % 32 == 0, "whole warps");
  int* rowmin = ml_tail(sh);
  const int lane = threadIdx.x & 31;
  const int ntiles = (nrows + kTileRows - 1) / kTileRows;
  auto stage = [&](int i) { return sh + (i % kStages) * kMlTileFloats; };
  // Stage tile i (if it exists) as one commit group; a thread copies all
  // five 16-byte chunks of its quartets of candidates.
  auto issue = [&](int i) {
    if (i < ntiles) {
      float* buf = stage(i);
      const int r0 = i * kTileRows;
      const int nr = min(kTileRows, nrows - r0);
      for (int g = threadIdx.x; g < nr * 32; g += kThreads) {
        const int r = g >> 5, off = (g & 31) * 4;
        const long long row = row_at(r0 + r);
        const float* src = pts + row * kRowFloats + off;
        float* dst = buf + r * kRowFloats + off;
#pragma unroll
        for (int ch = 0; ch < 4; ++ch)
          cp_async16(dst + ch * kLanes, src + ch * kLanes);
        cp_async16(buf + kTileRows * kRowFloats + r * kLanes + off,
                   reinterpret_cast<const float*>(labels + row * kLanes + off));
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile i landed
    float* buf = stage(i);
    int* lab = reinterpret_cast<int*>(buf + kTileRows * kRowFloats);
    int* rmin = rowmin + (i % kStages) * kTileRows;
    const int nr = min(kTileRows, nrows - i * kTileRows);
    // Mask the quartets this thread staged; a warp covers whole rows (32
    // quartets each), so its min is the row's.
    for (int g = threadIdx.x; g < nr * 32; g += kThreads) {
      const int r = g >> 5, off = (g & 31) * 4;
      const float4 w =
          *reinterpret_cast<const float4*>(buf + r * kRowFloats + 3 * kLanes + off);
      int4 l = *reinterpret_cast<int4*>(lab + r * kLanes + off);
      l.x = w.x > 0.5f ? l.x : kLabelFree;
      l.y = w.y > 0.5f ? l.y : kLabelFree;
      l.z = w.z > 0.5f ? l.z : kLabelFree;
      l.w = w.w > 0.5f ? l.w : kLabelFree;
      *reinterpret_cast<int4*>(lab + r * kLanes + off) = l;
      const int m =
          __reduce_min_sync(kFullMask, min(min(l.x, l.y), min(l.z, l.w)));
      if (lane == 0) rmin[r] = m;
    }
    // Tile i is masked and visible to all, and every warp is done with
    // tile i - 1, whose buffer the next issue refills.
    __syncthreads();
    issue(i + kStages - 1);
    for (int r = first; r < nr; r += step)
      visit(buf + r * kRowFloats, lab + r * kLanes, rmin[r]);
  }
  __syncthreads();  // the ring is free
}

// Q queries of a block on each lane: query u * 32 + lane of the lane's
// group of 32 * Q. `best` starts at the query's label, or at INT_MIN for
// an invalid query (never lowered, and it holds no row back): the block's
// `start_labels`.
template <int Q>
struct MinLabelQueries {
  float x[Q], y[Q], z[Q];
  int best[Q];

  // The block's query row `q` [4, 128] and its start labels `start`
  // [128]; group `g` holds queries g * 32 * Q + u * 32 + lane.
  __device__ __forceinline__ void load(const float* q, const int* start,
                                       int g, int lane) {
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const int j = slot(g, u, lane);
      x[u] = q[j];
      y[u] = q[kLanes + j];
      z[u] = q[2 * kLanes + j];
      best[u] = start[j];
    }
  }

  __device__ static __forceinline__ int slot(int g, int u, int lane) {
    return g * 32 * Q + u * 32 + lane;
  }

  // The largest label the warp's valid queries hold (INT_MIN if none).
  __device__ __forceinline__ int largest() const {
    int m = best[0];
#pragma unroll
    for (int u = 1; u < Q; ++u) m = max(m, best[u]);
    return __reduce_max_sync(kFullMask, m);
  }

  // Four candidates (one float4 of each channel, one int4 of labels)
  // against the lane's Q queries.
  __device__ __forceinline__ void quad(float4 cx, float4 cy, float4 cz,
                                       int4 cl, float r2) {
    const float px[4] = {cx.x, cx.y, cx.z, cx.w};
    const float py[4] = {cy.x, cy.y, cy.z, cy.w};
    const float pz[4] = {cz.x, cz.y, cz.z, cz.w};
    const int pl[4] = {cl.x, cl.y, cl.z, cl.w};
#pragma unroll
    for (int u = 0; u < Q; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        min_within(best[u], d2_rn(x[u], y[u], z[u], px[i], py[i], pz[i]), r2,
                   pl[i]);
  }

  // One staged row: channels `s` [4, 128], masked labels `lab` [128], its
  // smallest label `rmin`. Returns whether the row was walked (not pruned).
  __device__ __forceinline__ bool row(const float* s, const int* lab,
                                      int rmin, float r2) {
    if (rmin >= largest()) return false;  // warp-uniform
    const float4* c = reinterpret_cast<const float4*>(s);
    const int4* l = reinterpret_cast<const int4*>(lab);
#pragma unroll 4
    for (int i = 0; i < kLanes / 4; ++i) {
      quad(c[i], c[32 + i], c[64 + i], l[i], r2);
    }
    return true;
  }
};

// A block's start labels in shared memory (past the ring): its label
// where the query is valid, INT_MIN where not. Threads < 128 write them;
// the caller syncs.
__device__ __forceinline__ int* start_labels(float* sh, const float* q,
                                             const int* labels) {
  int* start = ml_tail(sh) + kMlLabInt;
  if (threadIdx.x < kLanes)
    start[threadIdx.x] = q[3 * kLanes + threadIdx.x] > 0.5f
                             ? __ldcg(labels + threadIdx.x)
                             : INT_MIN;
  return start;
}

// The hop of a CTA over its block (query row `q`, start labels `start`):
// the warps of query group g = warp % G (G = 128 / (32 Q) groups) take row
// slice warp / G of S = W / G. Returns each query's minimum over the block's
// rows and its start label, in shared memory [kLanes] (after a barrier;
// the ring is reused for it), and in `visits` the warp-row visits that
// were not pruned.
template <int W, int Q, class RowAt>
__device__ __forceinline__ int* minlabel_hop(const float* __restrict__ pts,
                                             const int* labels,
                                             const float* q, const int* start,
                                             RowAt rows, int nrows, float r2,
                                             float* sh, int& visits) {
  constexpr int G = kLanes / (32 * Q);
  constexpr int S = W / G;
  static_assert(G * 32 * Q == kLanes && S * G == W, "Q and W split 128");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = warp % G, slice = warp / G;
  MinLabelQueries<Q> qs;
  qs.load(q, start, g, lane);
  visits = 0;
  walk_label_rows<W * 32>(pts, labels, rows, nrows, sh, slice, S,
                          [&](const float* s, const int* l, int rmin) {
    visits += qs.row(s, l, rmin, r2);
  });
  // Merge the S slices in shared memory, then one thread a query reads.
  int* part = reinterpret_cast<int*>(sh);
#pragma unroll
  for (int u = 0; u < Q; ++u)
    part[slice * kLanes + MinLabelQueries<Q>::slot(g, u, lane)] = qs.best[u];
  __syncthreads();
  if (S > 1) {
    for (int j = threadIdx.x; j < kLanes; j += W * 32) {
      int m = part[j];
      for (int s = 1; s < S; ++s) m = min(m, part[s * kLanes + j]);
      part[j] = m;
    }
    __syncthreads();
  }
  return part;
}
