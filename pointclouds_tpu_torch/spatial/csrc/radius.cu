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
// rescue_radius_count_groups: one block of 128 threads per 128-query block,
// each candidate row staged in shared memory and read by all 128 queries.
// Pass 2 has only fix_cap / 128 (32) query blocks that each walk many
// groups, so each block's group list is split over `nsplit` blocks; their
// counts meet in integer atomics (exact in any order), written out as f32.
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

// cand: [nr, 4, 128] (w = validity); q: [qb, 4, 128] (w = r2, -1 invalid);
// active: [qb, 1 + ng]. Block (b, s) walks groups s, s + nsplit, ... and
// adds its hits to counts[b * 128 + lane].
__global__ void rescue_radius_partial(const float* __restrict__ cand,
                                      const float* __restrict__ qpl,
                                      const int* __restrict__ active,
                                      int* __restrict__ counts, int ng1,
                                      int gr) {
  __shared__ float sh[kRowFloats];
  __shared__ int live;
  const int b = blockIdx.x;
  const int l = threadIdx.x;
  const float* q = qpl + (long long)b * kRowFloats;
  const float qx = q[l], qy = q[kLanes + l], qz = q[2 * kLanes + l];
  const float qr2 = q[3 * kLanes + l];
  if (!block_any(qr2 >= 0.0f, &live)) return;
  const int* act = active + (long long)b * ng1;
  const int ngroups = act[0];
  int cnt = 0;
  for (int t = blockIdx.y; t < ngroups; t += gridDim.y) {
    const long long base = (long long)act[1 + t] * gr;
    for (int r = 0; r < gr; ++r) {
      stage_row(cand, base + r, sh);
      for (int c = 0; c < kLanes; ++c)
        if (sh[3 * kLanes + c] > 0.5f &&
            d2_rn(qx, qy, qz, sh[c], sh[kLanes + c], sh[2 * kLanes + c]) <=
                qr2)
          ++cnt;
    }
  }
  if (cnt) atomicAdd(counts + (long long)b * kLanes + l, cnt);
}

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

// counts: int [qb * 128], zeroed by the caller; out: f32 [qb * 128].
extern "C" int pc_rescue_radius_count(const float* cand, const float* q,
                                      const int* active, int qb, int ng1,
                                      int gr, int nsplit, int* counts,
                                      float* out, void* stream) {
  if (qb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rescue_radius_partial<<<dim3(qb, nsplit), kLanes, 0, s>>>(
      cand, q, active, counts, ng1, gr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long nq = (long long)qb * kLanes;
  counts_to_f32<<<(unsigned)((nq + 255) / 256), 256, 0, s>>>(counts, out, nq);
  return (int)cudaGetLastError();
}
