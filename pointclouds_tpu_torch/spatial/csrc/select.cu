// Exact k-smallest neighbour selection for the sweep SOR (passes 1 and 2).
//
// Replaces, in pointclouds_tpu/spatial/pallas_kernels.py:
//   * sweep_select_rows (kernel body _sweep_select_rows_kernel): per 128-query
//     block, the k smallest masked squared distances over the block's flat
//     list of candidate rows (SOR pass 1);
//   * sweep_select (kernel body _sweep_select_kernel): the same over the
//     block's nine deduplicated windows [start + skip, start + length), with
//     no row cap (SOR pass 1 of the multi-dispatch fallback, engine.sor_means);
//   * rescue_select (bodies _rescue_select_kernel / _rescue_walk_store): the
//     same selection for compacted flagged query blocks, walking only the
//     8-row candidate groups in each block's AABB-pruned active list (pass 2).
//
// The TPU kernels keep per-lane-segment finalists (a lane trick) and certify
// them; here every query gets an exact k smallest, so `ok` is always 1.
// Outputs per query: total = sum of sqrt(d2) over the k smallest, added in
// ascending order (the TPU kernel's extraction order, so the f32 sum is
// bitwise the same), count = number extracted, kth = the last extracted d2
// (0 if none). They depend on the multiset of the k smallest alone, so any
// visiting order or partition of the candidates gives the same bits.
//
// Bound on Hopper: the per-pair d2 + compare work (operations), not memory:
// each staged row is reused by every query of its block.
//
// sweep_select_rows and rescue_select (the KITTI frame's SOR passes) are
// warp-cooperative (warpselect.cuh): S warps per query (each walking every
// S-th row of each tile, their lists merged in shared memory at the end),
// W warps per CTA = W / S queries of one 128-query block, sharing a
// cp.async staging of the block's candidate rows in a ring of three 8-row
// tiles (pass 1: its row list; pass 2: its active 8-row groups). A first
// walk takes a bound from each lane's two smallest d2; in the second most
// candidates cost one d2 and, per row, one vote against the warp's
// threshold, and the few insertions are shared by the warp instead of run
// per thread under divergence. Pass 2 has no split over blocks, no partial
// lists in device memory and no merge kernel: its fix_cap queries are
// fix_cap * S warps (16,384 at the KITTI bench frame), so its critical
// path is the longest active list (91 of the 96 groups there) walked by
// 32 * S lanes. W and S were tuned on the H100 at the KITTI bench inputs
// (below; PERF.md has the table).
//
// sweep_select (kernel 9) keeps the per-thread design: one block of 128
// threads per query block, each thread an exact sorted top-k in registers
// (topk.cuh), each candidate row staged in shared memory by the block.
#include "warpselect.cuh"

namespace {

__device__ void store_topk(const TopK& tk, float* out, long long stride,
                           long long q, int k) {
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxK; ++i)
    if (i < k && tk.r[i] < kInf)
      total = __fadd_rn(total, sqrtf(fmaxf(tk.r[i], 0.0f)));
  float count, kth;
  tk.count_kth(k, count, kth);
  out[q] = total;
  out[stride + q] = count;
  out[2 * stride + q] = kth;
  out[3 * stride + q] = 1.0f;
}

// pts: [nr + 1, 4, 128] (pad row nr all-masked); rowlist: [nb, cap + 2]
// (row ids, block-valid flag, true row count). Query block b = row b; CTA
// i serves its queries (i % kPer) * (W / S) + warp / S.
struct ListRows {
  const int* rl;
  __device__ long long operator()(int t) const { return rl[t]; }
};

template <int W, int S>
__global__ void __launch_bounds__(W * 32)
    sweep_select_rows_kernel(const float* __restrict__ pts,
                             const int* __restrict__ rowlist,
                             float* __restrict__ out, int nb, int cap,
                             int k) {
  __shared__ __align__(16) float sh[kStages * kTileFloats];
  constexpr int kPer = ctas_per_block(W, S);
  const int b = blockIdx.x / kPer;
  const int warp = threadIdx.x / 32;
  const int qi = (blockIdx.x % kPer) * (W / S) + warp / S;
  const int* rl = rowlist + (long long)b * (cap + 2);
  const float* q = pts + (long long)b * kRowFloats;
  const bool walk = rl[cap] != 0;
  const bool live = walk && q[3 * kLanes + qi] > 0.5f;
  WarpKSmallest<float> sel;
  sel.init(k, threadIdx.x & 31);
  if (__syncthreads_or(live)) {
    select_rows<W * 32, S>(pts, ListRows{rl},
                           walk ? min(rl[cap + 1], cap) : 0, sh, q[qi],
                           q[kLanes + qi], q[2 * kLanes + qi], live,
                           warp % S, sel);
    merge_slices<S>(sh, sel);
  }
  if (warp % S == 0)
    sel.store(out, (long long)nb * kLanes, (long long)b * kLanes + qi);
}

// pts: [nr, 4, 128]; starts: [nb, 28] (the window pack). Query block b =
// row b; it walks its nine windows [start + skip, start + length).
__global__ void sweep_select_kernel(const float* __restrict__ pts,
                                    const int* __restrict__ starts,
                                    float* __restrict__ out, int nb, int k) {
  __shared__ float sh[kRowFloats];
  const int b = blockIdx.x;
  const int l = threadIdx.x;
  const int* ss = starts + (long long)b * kStartsCols;
  const float* q = pts + (long long)b * kRowFloats;
  const float qx = q[l], qy = q[kLanes + l], qz = q[2 * kLanes + l];
  const bool qv = q[3 * kLanes + l] > 0.5f;
  TopK tk;
  tk.init();
  if (ss[3 * kShifts] != 0) {
    for (int j = 0; j < kShifts; ++j) {
      const int st = ss[j], ln = ss[2 * kShifts + j];
      for (int r = ss[kShifts + j]; r < ln; ++r)
        visit_row(pts, st + r, sh, qx, qy, qz, qv, tk, k);
    }
  }
  store_topk(tk, out, (long long)nb * kLanes, (long long)b * kLanes + l, k);
}

// cand: [nr, 4, 128]; q: [qb, 4, 128]; active: [qb, 1 + ng] (count, then
// ascending group ids; entries past the count are garbage and never read).
// CTA i serves queries (i % kPer) * (W / S) + warp / S of block i / kPer,
// together walking every row of the block's active groups (GroupRows).
template <int W, int S>
__global__ void __launch_bounds__(W * 32)
    rescue_select_kernel(const float* __restrict__ cand,
                         const float* __restrict__ qpl,
                         const int* __restrict__ active,
                         float* __restrict__ out, int qb, int ng1, int gr,
                         int k) {
  __shared__ __align__(16) float sh[kStages * kTileFloats];
  constexpr int kPer = ctas_per_block(W, S);
  const int b = blockIdx.x / kPer;
  const int warp = threadIdx.x / 32;
  const int qi = (blockIdx.x % kPer) * (W / S) + warp / S;
  const float* q = qpl + (long long)b * kRowFloats;
  const int* act = active + (long long)b * ng1;
  const bool live = q[3 * kLanes + qi] > 0.5f;
  WarpKSmallest<float> sel;
  sel.init(k, threadIdx.x & 31);
  if (__syncthreads_or(live)) {
    select_rows<W * 32, S>(cand, GroupRows{act, gr}, act[0] * gr, sh, q[qi],
                           q[kLanes + qi], q[2 * kLanes + qi], live,
                           warp % S, sel);
    merge_slices<S>(sh, sel);
  }
  if (warp % S == 0)
    sel.store(out, (long long)qb * kLanes, (long long)b * kLanes + qi);
}

// (warps per CTA, warps per query), tuned on the H100 at the KITTI bench
// inputs, W over {4, 8, 16, 32}, then S over {1, 2, 4} at W 8 and 16
// (PERF.md): pass 1's many short walks want one warp a query, pass 2's
// one long active list four.
constexpr int kRowsWarps = 8, kRowsSlices = 1;
constexpr int kRescueWarps = 16, kRescueSlices = 4;

}  // namespace

extern "C" int pc_max_k() { return kMaxK; }

extern "C" int pc_sweep_select_rows(const float* pts, const int* rowlist,
                                    float* out, int nb, int cap, int k,
                                    void* stream) {
  if (nb > 0)
    sweep_select_rows_kernel<kRowsWarps, kRowsSlices>
        <<<nb * ctas_per_block(kRowsWarps, kRowsSlices), kRowsWarps * 32, 0,
           static_cast<cudaStream_t>(stream)>>>(pts, rowlist, out, nb, cap,
                                                k);
  return (int)cudaGetLastError();
}

extern "C" int pc_sweep_select(const float* pts, const int* starts,
                               float* out, int nb, int k, void* stream) {
  if (nb > 0)
    sweep_select_kernel<<<nb, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
        pts, starts, out, nb, k);
  return (int)cudaGetLastError();
}

extern "C" int pc_rescue_select(const float* cand, const float* q,
                                const int* active, float* out, int qb,
                                int ng1, int gr, int k, void* stream) {
  if (qb > 0)
    rescue_select_kernel<kRescueWarps, kRescueSlices>
        <<<qb * ctas_per_block(kRescueWarps, kRescueSlices),
           kRescueWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
            cand, q, active, out, qb, ng1, gr, k);
  return (int)cudaGetLastError();
}
