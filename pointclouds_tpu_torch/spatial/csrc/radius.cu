// Inclusive within-radius counts for radius outlier removal (passes 1 and 2).
//
// Replaces, in pointclouds_tpu/spatial/pallas_kernels.py:
//   * count_within (kernel body _count_within_kernel): per query, the
//     candidates within its radius over the block's nine deduplicated windows
//     [start + skip, start + length); r2 rides the w channel (r2 for a valid
//     point, 0 for a masked one) and a candidate counts iff both are valid
//     and d2 <= its w;
//   * rescue_radius_count_groups (kernel body _rescue_radius_count_kernel):
//     per compacted flagged query (w = r2, -1 for padding), the valid
//     candidates with d2 <= r2 in the 8-row groups of its block's
//     AABB-pruned active list.
//
// The boundary is inclusive, so the d2 form decides a point that lies on the
// radius: d2 is the pinned d2_rn, fma(dz, dz, fma(dx, dx, dy*dy)), the form
// XLA's CPU backend gives both TPU kernels (interpret mode) and their XLA
// mirrors (measured: 100% bitwise on points placed on the radius, against
// 88-97% for the other orders); the plain torch versions emulate it.
//
// count_within is the register-tiled count walk (countwalk.cuh) over the
// block's windows (WindowRows, as the window selections of warpselect.cuh
// read them): one CTA of kWithinWarps warps per 128-query block, every warp
// holding all 128 queries (four a lane), the warps splitting each staged
// 8-row tile's rows and summing their counts in shared memory. The pair
// test takes the candidate's r2 (WithinCandR2): a pair is the pinned d2, a
// compare with the candidate's w and a predicated add. Pass 1 has one
// block per 128 sorted points (782 at the 100K ROR op), enough to fill the
// card, so no CTAs share a block and nothing is combined across CTAs. A
// block whose flag is 0, or with no valid query, writes zeros and reads no
// candidate row. Bound on Hopper: operations (8 issued instructions a
// pair, each staged row reused by 128 queries).
//
// rescue_radius_count_groups is one launch of the same walk over the rows
// of each query block's active groups (GroupRows), with kernel 14's action
// and combine (count_block, WithinQueryR2: the query's r2, a valid
// candidate has w > 0.5): pass 2 has only fix_cap / 128 (32) query
// blocks, each with a list of ~50 rows at the fused ROR op, too few to
// fill 132 SMs, so C CTAs share a block (walk_split, from the SM count)
// and CTA s walks steps [n s / C, n (s + 1) / C) of its n = count * gr
// rows: split by steps, not by groups, so an uneven list still spreads
// over all C. Their counts meet in a scratch by integer atomics (exact in
// any order), and the block's last CTA writes them out as f32 and leaves
// the scratch zero: no memset, no conversion kernel. A block with no
// valid query or no group walks nothing and writes zeros (the noisy 100K
// ROR op's call has 2 live blocks of 32).
#include "countwalk.cuh"

namespace {

// Warps per CTA, measured on the H100 at the noisy 100K ROR op's capture
// (PERF.md): W 4 took 3-6% longer, 2 30% and 1 64%. A two-tile ring (32
// KB, 6 CTAs an SM) came within 3% at W 4 and 8 (at W 2 it gained 21%).
constexpr int kWithinWarps = 8;

// pts: [nr, 4, 128] (w = r2 or 0); starts: [nb, 28]; out: [nb * 128].
// Query block b = row b; CTA b serves it.
template <int W>
__global__ void __launch_bounds__(W * 32)
    count_within_kernel(const float* __restrict__ pts,
                        const int* __restrict__ starts,
                        float* __restrict__ out) {
  extern __shared__ __align__(16) float sh[];  // kWindowSmem bytes
  static_assert(W * kLanes <= kStages * kTileFloats, "counts fit");
  const int b = blockIdx.x;
  const int* ss = starts + (long long)b * kStartsCols;
  float* col = out + (long long)b * kLanes;
  int* pre = reinterpret_cast<int*>(sh + kStages * kTileFloats);
  int* base = pre + kShifts + 1;
  QueryTile<WithinCandR2> tile;
  bool live = false;
  if (ss[3 * kShifts] != 0) {
    if (threadIdx.x == 0) WindowRows::fill<true>(ss, pre, base);
    live = tile.load(pts + (long long)b * kRowFloats, threadIdx.x & 31);
  }
  // pre is visible past this barrier; the same answer on every thread.
  if (!__syncthreads_or(live) || pre[kShifts] == 0) {
    for (int i = threadIdx.x; i < kLanes; i += W * 32) col[i] = 0.0f;
    return;
  }
  walk_tile<W * 32>(pts, WindowRows{pre, base}, pre[kShifts], sh, tile);
  sum_warps<W>(tile, reinterpret_cast<int*>(sh), [&](int i, int total) {
    col[i] = (float)total;  // exact: below 2^24
  });
}

// cand: [nr, 4, 128] (w = validity); q: [qb, 4, 128] (w = r2, -1
// invalid); active: [qb, ng1] (count, then group ids); out: f32 [qb *
// 128]; counts: int [qb * 128] and arrived: [qb], zero at the call and
// left zero. CTA i = b * C + s serves query block b.
template <int W>
__global__ void __launch_bounds__(W * 32)
    rescue_radius_kernel(const float* __restrict__ cand,
                         const float* __restrict__ qpl,
                         const int* __restrict__ active,
                         float* __restrict__ out, int ng1, int gr, int C,
                         int* counts, unsigned* arrived) {
  __shared__ __align__(16) float sh[kStages * kTileFloats];
  const int b = blockIdx.x / C;
  const int* act = active + (long long)b * ng1;
  QueryTile<WithinQueryR2> tile;
  const bool live =
      tile.load(qpl + (long long)b * kRowFloats, threadIdx.x & 31);
  count_block<W>(tile, live, cand, GroupRows{act, gr}, act[0] * gr,
                 blockIdx.x % C, C, out + (long long)b * kLanes,
                 counts + (long long)b * kLanes, arrived + b, sh);
}

// Warps per CTA and CTAs a query block at most (walk_split), measured on the
// H100 at the fused ROR op's capture (32 live blocks, 193 groups, 11 at most)
// and the noisy ROR op's (2 live blocks, 17 groups; PERF.md). The time follows
// the rows a warp walks in the longest list: at W 4, C 8 beat C 4 by 1.3x, C 2
// by 2.2x and C 1 by 4.2x; W 8 tied W 4 and W 2 lost 1.3x at C 8. C 16 (512
// CTAs) took 3% less than C 8 at the full capture and 27% less on the noisy
// call; C 32 (1,024, past the 528 resident) took 27% more at the full capture,
// 34% less on the noisy call. A two-tile ring came within 3%.
constexpr int kRescueWarps = 4;
constexpr int kRescueMaxSplit = 16;

}  // namespace

// pts 16-byte aligned; out: f32 [nb * 128].
extern "C" int pc_count_within(const float* pts, const int* starts,
                               float* out, int nb, void* stream) {
  if (nb == 0) return 0;
  auto kernel = count_within_kernel<kWithinWarps>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWindowSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nb, kWithinWarps * 32, kWindowSmem,
           static_cast<cudaStream_t>(stream)>>>(pts, starts, out);
  return (int)cudaGetLastError();
}

// out: f32 [qb * 128]; counts: int [qb * 128] and arrived: [qb], zeroed
// once by the caller and left zero by every call. cand 16-byte aligned.
extern "C" int pc_rescue_radius_count(const float* cand, const float* q,
                                      const int* active, float* out, int qb,
                                      int ng1, int gr, int* counts,
                                      unsigned* arrived, void* stream) {
  if (qb == 0) return 0;
  int split = 1;
  const int err = walk_split(qb, kRescueMaxSplit, split);
  if (err != 0) return err;
  rescue_radius_kernel<kRescueWarps>
      <<<qb * split, kRescueWarps * 32, 0,
         static_cast<cudaStream_t>(stream)>>>(cand, q, active, out, ng1, gr,
                                              split, counts, arrived);
  return (int)cudaGetLastError();
}
