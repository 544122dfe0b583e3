// Whole-cloud exact rescues of the fused filter ops: kNN with positions
// (statistical outlier removal, normals) and inclusive radius counts (radius
// outlier removal), for the few flagged queries that the sweep and its
// group-pruned rescue left.
//
// Replaces, in pointclouds_tpu/spatial/pallas_kernels.py:
//   * brute_knn_idx (kernel body _brute_knn_kernel): per query, the k
//     nearest valid candidates over the whole cloud; rows [0, k) sqrt(d2)
//     ascending (+inf pad), [k, 2k) flat positions row * 128 + lane as f32
//     (-1 pad), row 2k the count found;
//   * brute_radius_count (kernel body _brute_radius_count_kernel): per query
//     (w = r2, -1 for padding), the valid candidates with d2 <= r2.
//
// d2 is the pinned d2_rn, the form XLA's CPU backend gives both TPU kernels
// in interpret mode (measured), so distances are bitwise the reference's and
// a point on the radius counts as there. Ties at equal d2 go to the smaller
// position (a lexicographic (d2, position) order), whatever the split.
//
// The callers compact flagged queries to the front, so only the first
// ceil(nflag / 128) of at most 32 query blocks hold a valid query. Bound on
// Hopper: the per-pair d2 + compare work of the live queries (operations;
// each staged row is reused by the CTA's queries).
//
// brute_knn_idx runs on the warp-select core (warpselect.cuh) with 64-bit
// (d2, position) keys, as rescue_knn_idx (knn.cu), over every row of the
// cloud: S warps per query, each walking every S-th row of each 8-row tile,
// their lists merged in shared memory at the end; W warps per CTA = W / S
// queries of one block, sharing a cp.async ring of the cloud's rows. One
// launch over (query block x CTA of the block); a CTA with no valid query
// skips the walk and writes the fill (+inf, -1, 0), so a call with no live
// block costs one launch of empty CTAs. No partial lists in device memory,
// no merge kernel. The cloud comes in its own order, not sorted by cell, so
// one streamed walk (tau falls as the list fills) replaces the bound walk:
// 1.5-1.7x faster on the H100 at the noisy and overflow SOR ops' inputs.
//
// brute_radius_count splits every query block over `nsplit` CUDA blocks that
// walk rows s, s + nsplit, ... (32 blocks could not fill 132 SMs) and adds
// integer counts with atomics (exact in any order), written out as f32.
#include "warpselect.cuh"

namespace {

// cand: [nr, 4, 128]; q: [qb, 4, 128] (w = validity); out: [2k + 1, qb *
// 128]. CTA i serves queries (i % kPer) * (W / S) + warp / S of block i /
// kPer.
template <int W, int S>
__global__ void __launch_bounds__(W * 32)
    brute_knn_kernel(const float* __restrict__ cand,
                     const float* __restrict__ qpl, float* __restrict__ out,
                     int qb, int nr, int k) {
  __shared__ __align__(16) float sh[kStages * kTileFloats];
  constexpr int kPer = ctas_per_block(W, S);
  const int b = blockIdx.x / kPer;
  const int warp = threadIdx.x / 32;
  const int qi = (blockIdx.x % kPer) * (W / S) + warp / S;
  const float* q = qpl + (long long)b * kRowFloats;
  const bool live = q[3 * kLanes + qi] > 0.5f;
  WarpKSmallest<Key> sel;
  sel.init(k, threadIdx.x & 31);
  if (__syncthreads_or(live)) {
    select_rows<W * 32, S, false>(cand, EveryRow{}, nr, sh, q[qi],
                                  q[kLanes + qi], q[2 * kLanes + qi], live,
                                  warp % S, sel);
    merge_slices<S>(sh, sel);
  }
  if (warp % S == 0)
    sel.store_knn(out, (long long)qb * kLanes, (long long)b * kLanes + qi,
                  false);
}

// (warps per CTA, warps per query), measured on the H100 at the noisy and
// the overflow SOR ops' inputs (PERF.md): at the noisy op's 276 live
// queries 4 warps a query tied 8 and beat 2 and 16; at the overflow op's
// 4,096, where more queries share each staged row, 2 beat 4 by 1.35x and 4
// beat 8 and 16. Few live queries are the common call. W 32 was no faster.
constexpr int kBruteWarps = 16, kBruteSlices = 4;

// q: [qb, 4, 128] (w = r2, -1 invalid); cand: [nr, 4, 128] (w = validity).
// Block (b, s) adds its hits over rows s, s + nsplit, ... to counts.
__global__ void brute_radius_partial(const float* __restrict__ qpl,
                                     const float* __restrict__ cand,
                                     int* __restrict__ counts, int nr) {
  __shared__ float sh[kRowFloats];
  __shared__ int live;
  const int b = blockIdx.x;
  const int l = threadIdx.x;
  const float* q = qpl + (long long)b * kRowFloats;
  const float qx = q[l], qy = q[kLanes + l], qz = q[2 * kLanes + l];
  const float qr2 = q[3 * kLanes + l];
  if (!block_any(qr2 >= 0.0f, &live)) return;
  int cnt = 0;
  for (int r = blockIdx.y; r < nr; r += gridDim.y) {
    stage_row(cand, r, sh);
    for (int c = 0; c < kLanes; ++c)
      if (sh[3 * kLanes + c] > 0.5f &&
          d2_rn(qx, qy, qz, sh[c], sh[kLanes + c], sh[2 * kLanes + c]) <= qr2)
        ++cnt;
  }
  if (cnt) atomicAdd(counts + (long long)b * kLanes + l, cnt);
}

}  // namespace

// out: [2k + 1, qb * 128].
extern "C" int pc_brute_knn_idx(const float* q, const float* cand, float* out,
                                int qb, int nr, int k, void* stream) {
  if (qb > 0)
    brute_knn_kernel<kBruteWarps, kBruteSlices>
        <<<qb * ctas_per_block(kBruteWarps, kBruteSlices), kBruteWarps * 32,
           0, static_cast<cudaStream_t>(stream)>>>(cand, q, out, qb, nr, k);
  return (int)cudaGetLastError();
}

// counts: int [qb * 128], zeroed by the caller; out: f32 [qb * 128].
extern "C" int pc_brute_radius_count(const float* q, const float* cand,
                                     int qb, int nr, int nsplit, int* counts,
                                     float* out, void* stream) {
  if (qb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  brute_radius_partial<<<dim3(qb, nsplit), kLanes, 0, s>>>(q, cand, counts,
                                                           nr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long nq = (long long)qb * kLanes;
  counts_to_f32<<<(unsigned)((nq + 255) / 256), 256, 0, s>>>(counts, out, nq);
  return (int)cudaGetLastError();
}
