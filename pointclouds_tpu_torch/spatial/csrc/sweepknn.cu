// Exact k-NN with sorted-frame positions over each query block's nine
// sorted windows: pass 1 of the all-points kNN sweep, same-cloud and
// cross-cloud.
//
// Replaces pointclouds_tpu/spatial/pallas_kernels.py::sweep_knn_select
// (kernel body _sweep_knn_kernel). Query block b (128 queries: row b of the
// query frame, which is the point frame itself for the same-cloud sweep)
// walks its nine windows [start + skip, start + length) of the cell-sorted
// candidate rows. Per query it returns the k smallest distances (sqrt d2,
// +inf pad), their positions in the candidate frame (row * 128 + lane, as
// f32, -1 pad), the count, the kth d2 (0 if none) and a certificate. The
// TPU kernel keeps `per_seg` finalists per lane (ties keep the earlier-seen
// register), extracts the k smallest over a register-major stack and
// certifies the segments; here the selection keeps the k smallest (d2,
// position) keys, so the certificate is always 1 and ties at equal d2 go to
// the smaller position, whatever the walk order or the split of the rows.
//
// Bound on Hopper: the per-pair d2 + compare work over the window rows
// (operations), not memory: each staged row is reused by 128 queries.
//
// Design: rescue_knn_idx's (knn.cu) on the warp-select core
// (warpselect.cuh) with 64-bit (d2, position) keys, over the rows of the
// block's windows (WindowRows) as sweep_moments (moments.cu) walks them. S
// warps per query (each walking every S-th row of each tile, their lists
// merged in shared memory at the end), W warps per CTA = W / S queries of
// one block, sharing a cp.async ring of 8-row tiles. The windows arrive in
// sorted-cell order, so a first walk bounds the kth d2 from each lane's two
// smallest and the second offers only what lies at or below it (one vote a
// row; a d2 equal to tau's passes it and the key decides).
#include "warpselect.cuh"

namespace {

// pts: [nr, 4, 128] candidate rows; qpl: [>= nb, 4, 128] query rows;
// starts: [nb, 28] (the window pack); out: [2k + 3, nb * 128]. CTA i
// serves queries (i % kPer) * (W / S) + warp / S of block i / kPer.
template <int W, int S, bool kBoundWalk>
__global__ void __launch_bounds__(W * 32)
    sweep_knn_kernel(const float* __restrict__ pts,
                     const float* __restrict__ qpl,
                     const int* __restrict__ starts, float* __restrict__ out,
                     int nb, int k) {
  extern __shared__ __align__(16) float sh[];  // kWindowSmem bytes
  constexpr int kPer = ctas_per_block(W, S);
  const int b = blockIdx.x / kPer;
  const int warp = threadIdx.x / 32;
  const int qi = (blockIdx.x % kPer) * (W / S) + warp / S;
  WarpKSmallest<Key> sel;
  sel.init(k, threadIdx.x & 31);
  select_windows<W, S, kBoundWalk>(pts, qpl, starts, sh, b, qi, sel);
  if (warp % S == 0)
    sel.store_knn(out, (long long)nb * kLanes, (long long)b * kLanes + qi);
}

// (warps per CTA, warps per query, bound walk), measured on the H100 at the
// `knn` 100K op's same-cloud and cross-cloud inputs (PERF.md).
constexpr int kSweepKnnWarps = 16, kSweepKnnSlices = 1;
constexpr bool kSweepKnnBoundWalk = true;

}  // namespace

extern "C" int pc_sweep_knn_select(const float* pts, const float* q,
                                   const int* starts, float* out, int nb,
                                   int k, void* stream) {
  if (nb == 0) return 0;
  auto kernel =
      sweep_knn_kernel<kSweepKnnWarps, kSweepKnnSlices, kSweepKnnBoundWalk>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWindowSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nb * ctas_per_block(kSweepKnnWarps, kSweepKnnSlices),
           kSweepKnnWarps * 32, kWindowSmem,
           static_cast<cudaStream_t>(stream)>>>(pts, q, starts, out, nb, k);
  return (int)cudaGetLastError();
}
