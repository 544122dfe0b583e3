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
// certifies the segments; here each thread keeps an exact top-k of (d2,
// position) pairs in lexicographic order, so the certificate is always 1
// and ties at equal d2 go to the smaller position, whatever the walk order.
//
// Design: sweep_select's (select.cu) one block of 128 threads per query
// block, each candidate row (2 KB) staged in shared memory once and scanned
// by all 128 queries. At 100K points there are ~780 query blocks, each
// walking a few window rows: enough blocks to fill the card. Bound on
// Hopper: the per-pair d2 + compare work (each staged row is reused 128
// times); the insertion network runs only for candidates below the current
// kth.
#include "topk.cuh"

namespace {

// pts: [nr, 4, 128] candidate rows; qpl: [>= nb, 4, 128] query rows;
// starts: [nb, 28] (the window pack); out: [2k + 3, nb * 128].
__global__ void sweep_knn_kernel(const float* __restrict__ pts,
                                 const float* __restrict__ qpl,
                                 const int* __restrict__ starts,
                                 float* __restrict__ out, int nb, int k) {
  __shared__ float sh[kRowFloats];
  const int b = blockIdx.x;
  const int l = threadIdx.x;
  const int* ss = starts + (long long)b * kStartsCols;
  const float* q = qpl + (long long)b * kRowFloats;
  const float qx = q[l], qy = q[kLanes + l], qz = q[2 * kLanes + l];
  const bool qv = q[3 * kLanes + l] > 0.5f;
  TopKIdx tk;
  tk.init();
  if (ss[3 * kShifts] != 0) {  // block-uniform: barriers below are safe
    for (int j = 0; j < kShifts; ++j) {
      const int st = ss[j], ln = ss[2 * kShifts + j];
      for (int r = ss[kShifts + j]; r < ln; ++r)
        visit_row_idx(pts, st + r, sh, qx, qy, qz, qv, tk, k);
    }
  }
  store_knn_idx(tk, out, (long long)nb * kLanes, (long long)b * kLanes + l,
                k);
}

}  // namespace

extern "C" int pc_sweep_knn_select(const float* pts, const float* q,
                                   const int* starts, float* out, int nb,
                                   int k, void* stream) {
  if (nb > 0)
    sweep_knn_kernel<<<nb, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
        pts, q, starts, out, nb, k);
  return (int)cudaGetLastError();
}
