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
// brute_radius_count is one launch of the register-tiled count walk
// (countwalk.cuh, count_block): kBruteSplit CTAs per query block (32
// blocks alone could not fill 132 SMs), each of kRadiusWarps warps that
// all hold the block's 128 queries, four a lane. CTA s of a block walks
// its contiguous share of the cloud's rows through the cp.async ring, its
// warps splitting each tile's rows; the warps' integer counts are summed
// in shared memory and added into a zeroed int32 scratch with atomics
// (exact in any order). The block's last CTA to arrive (a counter per
// block after a __threadfence) writes the counts out as f32 (exact: every
// count is below 2^24) and zeroes the scratch and its counter for the
// next call: no memset, no conversion kernel. A thread-block cluster a
// query block, the counts summed through distributed shared memory,
// measured 1.45x slower at the full capture with 8 CTAs a cluster and 2x
// with 4 (PERF.md). A block with no valid query (r2 < 0 on every lane)
// walks nothing and writes zeros, so the fused ROR ops' usual call, with
// no live block, is one launch of CTAs that exit at once.
#include "countwalk.cuh"

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

// (warps per CTA, CTAs per query block), measured on the H100 at the
// fused ROR op's full capture (32 live blocks, 1,024 rows; PERF.md): W 4
// beat 8 by 2%; C 8, 16 and 32 came within 2% of each other (every SM
// walks ~256 rows either way).
constexpr int kRadiusWarps = 4, kBruteSplit = 16;

// q: [qb, 4, 128] (w = r2, -1 invalid); cand: [nr, 4, 128] (w = validity);
// out: f32 [qb * 128]; counts: int [qb * 128] and arrived: [qb], zero at
// the call and left zero. CTA i = b * C + s serves query block b, walking
// rows [nr s / C, nr (s + 1) / C).
template <int W, int C>
__global__ void __launch_bounds__(W * 32)
    brute_radius_kernel(const float* __restrict__ qpl,
                        const float* __restrict__ cand,
                        float* __restrict__ out, int nr, int* counts,
                        unsigned* arrived) {
  __shared__ __align__(16) float sh[kStages * kTileFloats];
  const int b = blockIdx.x / C;
  QueryTile<WithinQueryR2> tile;
  const bool live =
      tile.load(qpl + (long long)b * kRowFloats, threadIdx.x & 31);
  count_block<W>(tile, live, cand, EveryRow{}, nr, blockIdx.x % C, C,
                 out + (long long)b * kLanes, counts + (long long)b * kLanes,
                 arrived + b, sh);
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

// out: f32 [qb * 128]; counts: int [qb * 128] and arrived: [qb], zeroed
// once by the caller and left zero by every call.
extern "C" int pc_brute_radius_count(const float* q, const float* cand,
                                     float* out, int qb, int nr, int* counts,
                                     unsigned* arrived, void* stream) {
  if (qb > 0)
    brute_radius_kernel<kRadiusWarps, kBruteSplit>
        <<<qb * kBruteSplit, kRadiusWarps * 32, 0,
           static_cast<cudaStream_t>(stream)>>>(q, cand, out, nr, counts,
                                                arrived);
  return (int)cudaGetLastError();
}
