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
// All three are warp-cooperative (warpselect.cuh): S warps per query (each
// walking every S-th row of each tile, their lists merged in shared memory
// at the end), W warps per CTA = W / S queries of one 128-query block,
// sharing a cp.async staging of the block's candidate rows in a ring of
// three 8-row tiles (sweep_select_rows: its row list; sweep_select: its
// nine windows, WindowRows; rescue_select: its active 8-row groups). The
// insertions are shared by the warp instead of run per thread under
// divergence. Kernels 2 and 3 first walk their rows for a bound from each
// lane's two smallest d2, so that in the second most candidates cost one
// d2 and, per row, one vote against the warp's threshold; kernel 9 walks
// its ~49 window rows a block once, streamed (the bound walk's second read
// measured slower than the insertions it saves). No kernel splits a
// block's rows over CTAs,
// keeps partial lists in device memory or needs a merge kernel. Pass 2's
// fix_cap queries are fix_cap * S warps (16,384 at the KITTI bench frame),
// so its critical path is the longest active list (91 of the 96 groups
// there) walked by 32 * S lanes. W and S were tuned on the H100: kernels 2
// and 3 at the KITTI bench inputs, kernel 9 at the overflow SOR op's
// (PERF.md has the tables).
#include "warpselect.cuh"

namespace {

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
// row b (rows nb.. are candidates only); CTA i serves its queries
// (i % kPer) * (W / S) + warp / S over the block's nine windows.
template <int W, int S, bool kBoundWalk>
__global__ void __launch_bounds__(W * 32)
    sweep_select_kernel(const float* __restrict__ pts,
                        const int* __restrict__ starts,
                        float* __restrict__ out, int nb, int k) {
  extern __shared__ __align__(16) float sh[];  // kWindowSmem bytes
  constexpr int kPer = ctas_per_block(W, S);
  const int b = blockIdx.x / kPer;
  const int warp = threadIdx.x / 32;
  const int qi = (blockIdx.x % kPer) * (W / S) + warp / S;
  WarpKSmallest<float> sel;
  sel.init(k, threadIdx.x & 31);
  select_windows<W, S, kBoundWalk>(pts, pts, starts, sh, b, qi, sel);
  if (warp % S == 0)
    sel.store(out, (long long)nb * kLanes, (long long)b * kLanes + qi);
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
// (warps per CTA, warps per query, bound walk) of kernel 9, measured on the
// H100 at the overflow SOR op's inputs (PERF.md): with one streamed walk W
// 32 beat 16 by 3% and 8 by 20%, S 2 was 40% slower; the bound walk was
// 14-25% slower at W 16 and 32 (fewer CTAs a block stage each row fewer
// times).
constexpr int kWindowsWarps = 32, kWindowsSlices = 1;
constexpr bool kWindowsBoundWalk = false;

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
  if (nb == 0) return 0;
  auto kernel =
      sweep_select_kernel<kWindowsWarps, kWindowsSlices, kWindowsBoundWalk>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWindowSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nb * ctas_per_block(kWindowsWarps, kWindowsSlices),
           kWindowsWarps * 32, kWindowSmem,
           static_cast<cudaStream_t>(stream)>>>(pts, starts, out, nb, k);
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
