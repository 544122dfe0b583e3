// Warp-cooperative exact k-smallest selection (k <= 32) for Hopper: one
// warp serves one query, all the warps of a CTA read one shared staging of
// their query block's candidate rows.
//
// The selection builds on FAISS's WarpSelect (Johnson, Douze and Jegou,
// "Billion-scale similarity search with GPUs", 2017): lane i of the warp
// holds the i-th smallest key offered so far (a warp-wide list of 32,
// ascending by lane, padded with the largest key), and tau = entry k-1
// (read with one shuffle; capped by a bound from a first walk, see
// select_rows) is the threshold a candidate must beat. A key is the d2
// itself (WarpKSmallest<float>: only the multiset of the k smallest values
// leaves the kernel, and a value equal to entry k-1 cannot change it, so
// skipping it is exact), or (d2, position) as one 64-bit key
// (WarpKSmallest<Key>: positions leave the kernel, ties at equal d2 go to
// the smaller position, and all keys differ). Each lane computes the d2 of
// four candidates of each staged row (128); a row is skipped unless some
// lane's d2 may still enter, and a candidate enters only if its key is
// below tau. Per 32-candidate step, a ballot of the accepted lanes: a few
// are inserted one at a time (shuffle-up shift of the list, tau refreshed
// after each); many (more than kBulk) are sorted across the warp and
// merged into the list at once (bitonic, over shuffles). WarpSelect's
// per-lane thread queues of 2 or 4 values, merged when a ballot shows one
// full, measured slower on both SOR passes at the KITTI bench inputs
// (PERF.md). The list ends as the exact 32 smallest of everything below
// the final tau, so its first k entries are the k smallest offered keys.
#pragma once
#include "topk.cuh"

constexpr unsigned kFullMask = 0xffffffffu;

// Candidate rows staged per tile (2 KB each), in a ring of kStages tiles
// (48 KB): while one is read, the next kStages - 1 are in flight.
constexpr int kTileRows = 8;
constexpr int kTileFloats = kTileRows * kRowFloats;
constexpr int kStages = 3;
// Accepted values in one step above which they are sorted and merged all
// at once instead of inserted one by one.
constexpr int kBulk = 8;

// (d2, position) as one key: d2's bits above (for d2 >= 0 and +inf they
// order as the values do; d2_rn is never negative), the position below.
// Its order is the plain versions' `_topk_lex` order.
using Key = unsigned long long;
__device__ __forceinline__ Key make_key(float d, int pos) {
  return (Key)__float_as_uint(d) << 32 | (unsigned)pos;
}
__device__ __forceinline__ float key_value(Key x) {
  return __uint_as_float((unsigned)(x >> 32));
}

// A key above every candidate's.
template <class K>
__device__ __forceinline__ K key_none();
template <>
__device__ __forceinline__ float key_none<float>() { return kInf; }
template <>
__device__ __forceinline__ Key key_none<Key>() { return ~0ull; }

// The least key of value v: keys below it hold a smaller value.
template <class K>
__device__ __forceinline__ K value_bound(float v) {
  if constexpr (sizeof(K) == 8)
    return (Key)__float_as_uint(v) << 32;
  else
    return v;
}

__device__ __forceinline__ float kmin(float x, float y) { return fminf(x, y); }
__device__ __forceinline__ Key kmin(Key x, Key y) { return x < y ? x : y; }

// The min or the max of x and y.
__device__ __forceinline__ float pick(float x, float y, bool keep_min) {
  return keep_min ? fminf(x, y) : fmaxf(x, y);
}
__device__ __forceinline__ Key pick(Key x, Key y, bool keep_min) {
  return (x < y) == keep_min ? x : y;
}

// Compare-exchange with the lane `stride` away: keep the min or the max.
template <class K>
__device__ __forceinline__ K cmpx(K x, int stride, bool keep_min) {
  return pick(x, __shfl_xor_sync(kFullMask, x, stride), keep_min);
}

// Bitonic sort of one key per lane, ascending by lane.
template <class K>
__device__ __forceinline__ K warp_sort(K x, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const bool asc = (lane & size) == 0;  // always true at size 32
      x = cmpx(x, stride, ((lane & stride) == 0) == asc);
    }
  }
  return x;
}

// `list` and `s` ascending by lane: returns the 32 smallest of both,
// ascending. min(list[i], s[31 - i]) holds them as a bitonic sequence,
// which the half-cleaners sort.
template <class K>
__device__ __forceinline__ K warp_merge(K list, K s, int lane) {
  K m = kmin(list, __shfl_sync(kFullMask, s, 31 - lane));
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1)
    m = cmpx(m, stride, (lane & stride) == 0);
  return m;
}

template <class K>
struct WarpKSmallest {
  static constexpr bool kKeyed = sizeof(K) == 8;
  K list;   // this lane's entry of the 32 smallest (ascending by lane)
  K tau;    // min(entry k-1, bound), the same on every lane
  K bound;  // from set_bound: keys at or above it cannot be needed
  int k, lane;

  // An empty list; the bound admits every finite d2 (a masked candidate's
  // +inf never enters, so a row's vote can read tau's value from the start).
  __device__ void init(int k_, int lane_) {
    k = k_;
    lane = lane_;
    list = key_none<K>();
    bound = value_bound<K>(kInf);
    tau = bound;
  }

  __device__ __forceinline__ void refresh() {
    tau = kmin(__shfl_sync(kFullMask, list, k - 1), bound);
  }

  // `m1` <= `m2`: the two smallest d2 among this lane's candidates. The
  // k-th smallest of these 64 values is the k-th smallest of 64 real
  // candidates, so it is at or above the k-th smallest of all: values
  // above it cannot enter, values equal to it may (+inf when fewer than k
  // candidates were seen). The bound is a value bound for either key. The
  // whole warp calls this.
  __device__ void set_bound(float m1, float m2) {
    const float s = warp_merge(warp_sort(m1, lane), warp_sort(m2, lane), lane);
    bound = value_bound<K>(
        nextafterf(__shfl_sync(kFullMask, s, k - 1), kInf));
    refresh();
  }

  // Whether a candidate at distance d may still enter (a row's vote): a
  // value below tau's, or equal to it with a smaller position. Tau's value
  // is at most +inf (init, set_bound).
  __device__ __forceinline__ bool may_enter(float d) const {
    if constexpr (kKeyed)
      return d <= key_value(tau);
    else
      return d < tau;
  }

  // The key of a candidate: its d2, or (d2, position).
  __device__ __forceinline__ K key(float d, int pos) const {
    if constexpr (kKeyed)
      return make_key(d, pos);
    else
      return d;
  }

  // The warp offers 32 candidates' keys, one per lane (key_none: none).
  __device__ __forceinline__ void offer(K x) {
    const bool acc = x < tau;
    unsigned m = __ballot_sync(kFullMask, acc);
    if (m == 0) return;
    if (__popc(m) > kBulk) {
      list = warp_merge(list, warp_sort(acc ? x : key_none<K>(), lane), lane);
      refresh();
      return;
    }
    do {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const K v = __shfl_sync(kFullMask, x, src);
      if (v < tau) {  // warp-uniform
        const int pos = __popc(__ballot_sync(kFullMask, list < v));
        const K up = __shfl_up_sync(kFullMask, list, 1);
        list = lane > pos ? up : (lane == pos ? v : list);
        refresh();
      }
    } while (m);
  }

  // The number of finite d2 among the k smallest (a prefix of the list)
  // and the last of them (0 if none), on every lane.
  __device__ void count_kth(int& count, float& kth) const {
    float v;
    if constexpr (kKeyed)
      v = key_value(list);
    else
      v = list;
    count = __popc(__ballot_sync(kFullMask, lane < k && v < kInf));
    kth = __shfl_sync(kFullMask, v, max(count - 1, 0));
    if (count == 0) kth = 0.0f;
  }

  // Lane 0 stores (total, count, kth, ok = 1) of the k smallest values at
  // column `col` of out [4, stride]: total adds sqrt of each finite value
  // in ascending order (the TPU kernels' extraction order), count the
  // finite ones, kth the last of them (0 if none).
  __device__ void store(float* out, long long stride, long long col) const {
    static_assert(!kKeyed, "store: the value list");
    const float root = sqrtf(fmaxf(list, 0.0f));  // each lane its own entry
    float total = 0.0f, count = 0.0f, kth = 0.0f;
    for (int i = 0; i < k; ++i) {
      const float v = __shfl_sync(kFullMask, list, i);
      const float r = __shfl_sync(kFullMask, root, i);
      if (v < kInf) {
        total = __fadd_rn(total, r);
        count = __fadd_rn(count, 1.0f);
        kth = v;
      }
    }
    if (lane == 0) {
      out[col] = total;
      out[stride + col] = count;
      out[2 * stride + col] = kth;
      out[3 * stride + col] = 1.0f;
    }
  }

  // The kNN output rows of query `col` of out [2k + 3, nq]: lane i < k
  // writes its entry's sqrt d2 (+inf pad) and position (-1 pad), lane 0 the
  // count, the kth d2 (0 if none) and the certificate, always 1 (the
  // selection is exact). Without `stats`, out is
  // [2k + 1, nq]: the count is its last row.
  __device__ void store_knn(float* out, long long nq, long long col,
                            bool stats = true) const {
    static_assert(kKeyed, "store_knn: the keyed list");
    int count;
    float kth;
    count_kth(count, kth);
    if (lane < k) {
      const bool found = lane < count;
      out[lane * nq + col] =
          found ? sqrtf(fmaxf(key_value(list), 0.0f)) : kInf;
      out[(k + lane) * nq + col] = found ? (float)(unsigned)list : -1.0f;
    }
    if (lane == 0) {
      out[2 * k * nq + col] = (float)count;
      if (stats) {
        out[(2 * k + 1) * nq + col] = kth;
        out[(2 * k + 2) * nq + col] = 1.0f;
      }
    }
  }
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The d2 to the query of four candidates of staged row `s` (+inf where
// masked): candidates lane + 32 u (kStrided: a lane's four lie apart in
// the sorted row, so a query's nearest spread over the lanes) or 4 lane + u
// (one 16-byte load per channel). Every load and d2 is unconditional, so
// the four run side by side (a masked branch would serialise them).
template <bool kStrided>
__device__ __forceinline__ void row_d2(const float* s, int lane, float qx,
                                       float qy, float qz, float d[4]) {
  float x[4], y[4], z[4], w[4];
  if (kStrided) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = u * 32 + lane;
      x[u] = s[j];
      y[u] = s[kLanes + j];
      z[u] = s[2 * kLanes + j];
      w[u] = s[3 * kLanes + j];
    }
  } else {
    const float4* v = reinterpret_cast<const float4*>(s);
    const float4 a = v[lane], b = v[32 + lane], c = v[64 + lane],
                 e = v[96 + lane];
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    y[0] = b.x, y[1] = b.y, y[2] = b.z, y[3] = b.w;
    z[0] = c.x, z[1] = c.y, z[2] = c.z, z[3] = c.w;
    w[0] = e.x, w[1] = e.y, w[2] = e.z, w[3] = e.w;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
    d[u] = w[u] > 0.5f ? d2_rn(qx, qy, qz, x[u], y[u], z[u]) : kInf;
}

// Walk `nrows` planar rows of `pts` (the t-th is row_at(t)) in tiles of
// kTileRows staged into the ring `sh` [kStages * kTileFloats] by cp.async;
// warps with a live query call visit(staged row, t) on rows first, first +
// step, ... of each staged tile. All threads of the CTA (kThreads) must
// call it with the same nrows; `pts` 16-byte aligned.
template <int kThreads, class RowAt, class Visit>
__device__ __forceinline__ void walk_rows(const float* __restrict__ pts,
                                          RowAt row_at, int nrows,
                                          float* sh, bool live, int first,
                                          int step, Visit visit) {
  constexpr int kRowChunks = kRowFloats / 4;  // 16-byte chunks per row
  const int ntiles = (nrows + kTileRows - 1) / kTileRows;
  // Stage tile `tile` (if it exists) as one commit group; an empty group
  // past the end keeps one group per tile for the wait below.
  auto issue = [&](int tile) {
    if (tile < ntiles) {
      float* buf = sh + (tile % kStages) * kTileFloats;
      const int r0 = tile * kTileRows;
      const int nr = min(kTileRows, nrows - r0);
      for (int c = threadIdx.x; c < nr * kRowChunks; c += kThreads) {
        const int r = c / kRowChunks, off = (c % kRowChunks) * 4;
        cp_async16(buf + r * kRowFloats + off,
                   pts + row_at(r0 + r) * kRowFloats + off);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile t landed
    // Everyone's copies of tile t are visible, and every warp is done with
    // tile t - 1, whose buffer the next issue refills.
    __syncthreads();
    issue(t + kStages - 1);
    if (live) {
      const float* tile = sh + (t % kStages) * kTileFloats;
      const int nr = min(kTileRows, nrows - t * kTileRows);
#pragma unroll 2
      for (int r = first; r < nr; r += step)
        visit(tile + r * kRowFloats, t * kTileRows + r);
    }
  }
  __syncthreads();  // the ring is free for the next walk
}

// The exact k smallest keys of the query (qx, qy, qz) over its share of
// the `nrows` candidate rows (rows slice, slice + S, ... of each 8-row
// tile) into `sel`. With kBoundWalk, in two walks: the rows arrive in
// sorted-cell order, so a query's distances mostly fall as the walk nears
// its own cell, and streamed as they come nearly every step would carry a
// merge. The first walk keeps each lane's two smallest d2 (strided lanes)
// for `set_bound`; the second offers only what lies at or below that
// bound, a few more values than k a query. Both SOR passes measured faster
// this way than with one streamed walk, in the same run on the H100 at the
// KITTI bench inputs (PERF.md). Without it, one streamed walk: for rows in
// no spatial order (the whole-cloud rescues), where tau falls as fast as
// it would behind a bound and the second read buys nothing. A keyed
// selection's positions are row_at(t) * 128 + lane of the candidate frame.
// Every thread of the CTA calls this with the same nrows; `live` is
// uniform over each warp.
template <int kThreads, int S, bool kBoundWalk = true, class RowAt, class K>
__device__ __forceinline__ void select_rows(const float* __restrict__ pts,
                                            RowAt row_at, int nrows,
                                            float* sh, float qx, float qy,
                                            float qz, bool live, int slice,
                                            WarpKSmallest<K>& sel) {
  const int lane = threadIdx.x & 31;
  if constexpr (kBoundWalk) {
    float m1 = kInf, m2 = kInf;  // this lane's two smallest d2
    walk_rows<kThreads>(pts, row_at, nrows, sh, live, slice, S,
                        [&](const float* s, int) {
      float d[4];
      row_d2<true>(s, lane, qx, qy, qz, d);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        m2 = fminf(m2, fmaxf(m1, d[u]));
        m1 = fminf(m1, d[u]);
      }
    });
    sel.set_bound(m1, m2);
  }
  walk_rows<kThreads>(pts, row_at, nrows, sh, live, slice, S,
                      [&](const float* s, int t) {
    float d[4];
    row_d2<false>(s, lane, qx, qy, qz, d);
    // Most rows hold nothing below tau: one vote skips them.
    if (__any_sync(kFullMask, sel.may_enter(fminf(fminf(d[0], d[1]),
                                                  fminf(d[2], d[3]))))) {
      int pos = 0;  // of candidate 4 lane (the 16-byte loads' order)
      if constexpr (WarpKSmallest<K>::kKeyed)
        pos = (int)row_at(t) * kLanes + 4 * lane;
#pragma unroll
      for (int u = 0; u < 4; ++u) sel.offer(sel.key(d[u], pos + u));
    }
  });
}

// The S warps of each query (consecutive warps of the CTA) merge their
// lists through the free ring `sh` (>= 32 keys a warp) into the first
// one's: the k smallest of the union are the k smallest of the parts.
// Every thread of the CTA calls this, after select_rows.
template <int S, class K>
__device__ __forceinline__ void merge_slices(float* sh,
                                             WarpKSmallest<K>& sel) {
  if (S == 1) return;
  K* keys = reinterpret_cast<K*>(sh);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  keys[warp * 32 + lane] = sel.list;
  __syncthreads();
  if (warp % S == 0) {
#pragma unroll
    for (int j = 1; j < S; ++j)
      sel.list = warp_merge(sel.list, keys[(warp + j) * 32 + lane], lane);
  }
}

// CTAs per 128-query block: each serves W / S of its queries.
__host__ __device__ constexpr int ctas_per_block(int w, int s) {
  return kLanes / (w / s);
}

// The rows of a block's nine windows, window by window: step t lies in
// window j where pre[j] <= t < pre[j + 1] (pre: prefix sums of the
// windows' row counts), at row base[j] + t (base[j] = first row - pre[j]).
// Both live in the kernel's shared memory.
struct WindowRows {
  const int* pre;
  const int* base;

  // One thread fills pre [kShifts + 1] and base [kShifts] from a block's
  // starts pack `ss`: windows [start + skip, start + length), or with
  // kSkip false [start, start + length) (the cluster hop reads no skip).
  // The CTA syncs before the rows are read.
  template <bool kSkip>
  __device__ static void fill(const int* ss, int* pre, int* base) {
    pre[0] = 0;
    for (int j = 0; j < kShifts; ++j) {
      const int skip = kSkip ? ss[kShifts + j] : 0;
      pre[j + 1] = pre[j] + max(ss[2 * kShifts + j] - skip, 0);
      base[j] = ss[j] + skip - pre[j];
    }
  }

  __device__ long long operator()(int t) const {
    int j = 0;
#pragma unroll
    for (int i = 1; i < kShifts; ++i) j += pre[i] <= t;
    return (long long)base[j] + t;
  }
};

// Dynamic shared memory of a window selection: the ring, then WindowRows'
// prefix sums and bases (80 bytes past the 48 KB static limit).
constexpr int kWindowSmem =
    kStages * kTileFloats * sizeof(float) + 2 * (kShifts + 1) * sizeof(int);

// The exact k smallest keys of query `qi` of block b (row b of `qpl`) over
// the block's nine windows [start + skip, start + length) of the
// candidate rows `pts` (starts: [nb, 28], the window pack) into `sel`, on
// S warps a query (this warp walks slice warp % S), the slices merged into
// the first. The windows arrive in sorted-cell order (select_rows). A
// block whose flag is 0, or whose windows hold no row, walks nothing.
// `sh`: kWindowSmem bytes of dynamic shared memory; every thread of the
// CTA calls this.
template <int W, int S, bool kBoundWalk, class K>
__device__ __forceinline__ void select_windows(const float* __restrict__ pts,
                                               const float* __restrict__ qpl,
                                               const int* __restrict__ starts,
                                               float* sh, int b, int qi,
                                               WarpKSmallest<K>& sel) {
  int* pre = reinterpret_cast<int*>(sh + kStages * kTileFloats);
  int* base = pre + kShifts + 1;
  const int* ss = starts + (long long)b * kStartsCols;
  if (threadIdx.x == 0) WindowRows::fill<true>(ss, pre, base);
  __syncthreads();
  const int nrows = ss[3 * kShifts] != 0 ? pre[kShifts] : 0;
  const float* q = qpl + (long long)b * kRowFloats;
  const bool live = q[3 * kLanes + qi] > 0.5f;
  if (__syncthreads_or(live && nrows > 0)) {
    select_rows<W * 32, S, kBoundWalk>(
        pts, WindowRows{pre, base}, nrows, sh, q[qi], q[kLanes + qi],
        q[2 * kLanes + qi], live, (threadIdx.x / 32) % S, sel);
    merge_slices<S>(sh, sel);
  }
}

// Every candidate row: step t is row t (the whole-cloud rescues).
struct EveryRow {
  __device__ long long operator()(int t) const { return t; }
};

// Rows lo, lo + 1, ... of a row source (a CTA's share of its block's).
template <class RowAt>
struct RowsFrom {
  RowAt rows;
  int lo;
  __device__ long long operator()(int t) const { return rows(lo + t); }
};

// The rows of a rescue query block's active groups: active [1 + ng]
// (count, then ascending group ids); step t is row t % gr of group t / gr.
struct GroupRows {
  const int* act;
  int gr;
  // The pipelines' 8-row groups take no division: 40 registers against
  // 54 with it in rescue_select, so 3 CTAs of 512 threads fit an SM
  // instead of 2 (PERF.md).
  __device__ long long operator()(int t) const {
    if (gr == kTileRows)
      return (long long)act[1 + t / kTileRows] * kTileRows + t % kTileRows;
    return (long long)act[1 + t / gr] * gr + t % gr;
  }
};
