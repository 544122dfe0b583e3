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
// position, so the result does not depend on the walk order.
//
// Design: select.cu's rescue split. A rescue has few query blocks
// (fix_cap / 128) that each walk many groups, so each query block's group
// list is split over `nsplit` CUDA blocks, each keeping a partial top-k of
// (d2, position) pairs in registers, and a merge kernel takes the k
// smallest of their union, carrying the positions. Bound on Hopper: the
// per-pair d2 + compare work over the active groups (each staged row is
// reused by 128 queries); the insertion network runs only for candidates
// below the current kth.
#include "topk.cuh"

namespace {

// cand: [nr, 4, 128]; q: [qb, 4, 128]; active: [qb, 1 + ng]. Block (b, s)
// walks groups s, s + nsplit, ... and writes its partial list to
// part_v / part_p [nsplit][k][qb * 128].
__global__ void knn_partial_kernel(const float* __restrict__ cand,
                                   const float* __restrict__ qpl,
                                   const int* __restrict__ active,
                                   float* __restrict__ part_v,
                                   int* __restrict__ part_p, int qb, int ng1,
                                   int gr, int k) {
  __shared__ float sh[kRowFloats];
  __shared__ int any_valid;
  const int b = blockIdx.x;
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  const int l = threadIdx.x;
  const float* q = qpl + (long long)b * kRowFloats;
  const float qx = q[l], qy = q[kLanes + l], qz = q[2 * kLanes + l];
  const bool qv = q[3 * kLanes + l] > 0.5f;
  TopKIdx tk;
  tk.init();
  if (block_any(qv, &any_valid)) {
    const int* act = active + (long long)b * ng1;
    const int ngroups = act[0];
    for (int t = split; t < ngroups; t += nsplit) {
      const long long base = (long long)act[1 + t] * gr;
      for (int r = 0; r < gr; ++r)
        visit_row_idx(cand, base + r, sh, qx, qy, qz, qv, tk, k);
    }
  }
  store_partial_idx(tk, part_v, part_p, split, k, (long long)qb * kLanes,
                    (long long)b * kLanes + l);
}

// One thread per query: the k smallest (d2, position) pairs of the union of
// the partial lists; out rows [0, k) sqrt d2, [k, 2k) positions, then
// count, kth d2, certificate.
__global__ void knn_merge_kernel(const float* __restrict__ part_v,
                                 const int* __restrict__ part_p,
                                 float* __restrict__ out, long long nq,
                                 int nsplit, int k) {
  const long long qi = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (qi >= nq) return;
  TopKIdx tk;
  merge_partials_idx(part_v, part_p, nq, nsplit, k, qi, tk);
  store_knn_idx(tk, out, nq, qi, k);
}

}  // namespace

// part_v / part_p: scratch of nsplit * k * qb * 128 each; out: [2k + 3,
// qb * 128].
extern "C" int pc_rescue_knn_idx(const float* cand, const float* q,
                                 const int* active, float* part_v,
                                 int* part_p, float* out, int qb, int ng1,
                                 int gr, int k, int nsplit, void* stream) {
  if (qb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  knn_partial_kernel<<<dim3(qb, nsplit), kLanes, 0, s>>>(
      cand, q, active, part_v, part_p, qb, ng1, gr, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long nq = (long long)qb * kLanes;
  knn_merge_kernel<<<(unsigned)((nq + 127) / 128), 128, 0, s>>>(
      part_v, part_p, out, nq, nsplit, k);
  return (int)cudaGetLastError();
}
