// Group-pruned exact k-NN with sorted-frame positions (the normals rescue
// and the kNN two-pass and cross-cloud rescues).
//
// Replaces pointclouds_tpu/spatial/pallas_kernels.py::rescue_knn_idx (kernel
// body _rescue_knn_kernel): compacted flagged query blocks against only the
// 8-row candidate groups in each block's AABB-pruned active list. Per query
// it returns the k smallest distances (sqrt d2, +inf pad), their positions
// in the padded sorted frame (row * 128 + lane, as f32, -1 pad), the count,
// the kth d2 (0 if none) and a certificate. The TPU kernel keeps per-lane
// segment finalists and certifies them; the selection here is exact, so
// the certificate is always 1. Ties at equal d2 go to the smaller
// position: the selection keeps the k smallest (d2, position) keys, so the
// result does not depend on the walk order or the split of the rows.
//
// Bound on Hopper: the per-pair d2 + compare work over the active groups
// (operations), not memory: each staged row is reused by 128 queries.
//
// Design: rescue_select's (select.cu) on the warp-select core
// (warpselect.cuh) with 64-bit (d2, position) keys. S warps per query (each
// walking every S-th row of each tile, their lists merged in shared memory
// at the end), W warps per CTA = W / S queries of one compacted block,
// sharing a cp.async ring of 8-row tiles over the block's active groups. A
// first walk bounds the kth d2 from each lane's two smallest; the second
// offers keys to the warp's list, one vote a row (a d2 equal to tau's
// passes the vote, and the key decides). One launch: no split over blocks,
// no partial lists in device memory and no merge kernel. A query block's
// critical path is its longest active list (43 groups at the 100K normals
// op) walked by 32 * S lanes.
#include "warpselect.cuh"

namespace {

// cand: [nr, 4, 128]; q: [qb, 4, 128]; active: [qb, 1 + ng]; out: [2k + 3,
// qb * 128]. CTA i serves queries (i % kPer) * (W / S) + warp / S of block
// i / kPer.
template <int W, int S>
__global__ void __launch_bounds__(W * 32)
    rescue_knn_kernel(const float* __restrict__ cand,
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
  WarpKSmallest<Key> sel;
  sel.init(k, threadIdx.x & 31);
  if (__syncthreads_or(live)) {
    select_rows<W * 32, S>(cand, GroupRows{act, gr}, act[0] * gr, sh, q[qi],
                           q[kLanes + qi], q[2 * kLanes + qi], live,
                           warp % S, sel);
    merge_slices<S>(sh, sel);
  }
  if (warp % S == 0)
    sel.store_knn(out, (long long)qb * kLanes, (long long)b * kLanes + qi);
}

// (warps per CTA, warps per query), measured on the H100 at the normals
// 100K op's and the aerial rescue frame's inputs (PERF.md): 2 warps a
// query beat 4 and 8 at both (the keyed insertions run once per slice),
// and 1 at the op's, whose 14 live blocks want the parallelism; W 16 beat
// 8 and 32. The compiler's own register choice (56, no spill) beat a cap
// of 40 (3 CTAs an SM).
constexpr int kKnnWarps = 16, kKnnSlices = 2;

}  // namespace

extern "C" int pc_rescue_knn_idx(const float* cand, const float* q,
                                 const int* active, float* out, int qb,
                                 int ng1, int gr, int k, void* stream) {
  if (qb > 0)
    rescue_knn_kernel<kKnnWarps, kKnnSlices>
        <<<qb * ctas_per_block(kKnnWarps, kKnnSlices), kKnnWarps * 32, 0,
           static_cast<cudaStream_t>(stream)>>>(cand, q, active, out, qb,
                                                ng1, gr, k);
  return (int)cudaGetLastError();
}
