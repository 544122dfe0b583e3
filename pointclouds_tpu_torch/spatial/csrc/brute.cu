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
// Design: the callers compact flagged queries to the front, so only the
// first ceil(nflag / 128) of at most 32 query blocks hold a valid query;
// the others exit at once. 32 blocks could not fill 132 SMs, and each walks
// the whole cloud (1,024 rows at 131,072 points), so every query block is
// split over `nsplit` CUDA blocks that walk rows s, s + nsplit, ... Bound on
// Hopper: the per-pair d2 + compare work of the live blocks (each staged
// row is reused by 128 queries). kNN splits keep partial (d2, position)
// top-k lists in registers and a merge kernel takes the k smallest of
// their union; radius splits add integer counts with atomics (exact in any
// order), written out as f32.
#include "topk.cuh"

namespace {

// q: [qb, 4, 128] (w = validity); cand: [nr, 4, 128]. Block (b, s) writes
// its partial lists to part_v / part_p [nsplit][k][qb * 128].
__global__ void brute_knn_partial(const float* __restrict__ qpl,
                                  const float* __restrict__ cand,
                                  float* __restrict__ part_v,
                                  int* __restrict__ part_p, int qb, int nr,
                                  int k) {
  __shared__ float sh[kRowFloats];
  __shared__ int live;
  const int b = blockIdx.x;
  const int l = threadIdx.x;
  const float* q = qpl + (long long)b * kRowFloats;
  const float qx = q[l], qy = q[kLanes + l], qz = q[2 * kLanes + l];
  const bool qv = q[3 * kLanes + l] > 0.5f;
  TopKIdx tk;
  tk.init();
  if (block_any(qv, &live))
    for (int r = blockIdx.y; r < nr; r += gridDim.y)
      visit_row_idx(cand, r, sh, qx, qy, qz, qv, tk, k);
  store_partial_idx(tk, part_v, part_p, blockIdx.y, k, (long long)qb * kLanes,
                    (long long)b * kLanes + l);
}

// One thread per query: the k smallest (d2, position) pairs of the partial
// lists' union; out rows [0, k) sqrt d2, [k, 2k) positions, 2k the count.
__global__ void brute_knn_merge(const float* __restrict__ part_v,
                                const int* __restrict__ part_p,
                                float* __restrict__ out, long long nq,
                                int nsplit, int k) {
  const long long qi = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (qi >= nq) return;
  TopKIdx tk;
  merge_partials_idx(part_v, part_p, nq, nsplit, k, qi, tk);
  float count = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxK; ++i) {
    if (i < k) {
      const bool found = tk.r[i] < kInf;
      out[i * nq + qi] = found ? sqrtf(fmaxf(tk.r[i], 0.0f)) : kInf;
      out[(k + i) * nq + qi] = found ? (float)tk.p[i] : -1.0f;
      if (found) count = __fadd_rn(count, 1.0f);
    }
  }
  out[2 * k * nq + qi] = count;
}

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

// part_v / part_p: scratch of nsplit * k * qb * 128 each; out: [2k + 1,
// qb * 128].
extern "C" int pc_brute_knn_idx(const float* q, const float* cand,
                                float* part_v, int* part_p, float* out,
                                int qb, int nr, int k, int nsplit,
                                void* stream) {
  if (qb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  brute_knn_partial<<<dim3(qb, nsplit), kLanes, 0, s>>>(q, cand, part_v,
                                                        part_p, qb, nr, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long nq = (long long)qb * kLanes;
  brute_knn_merge<<<(unsigned)((nq + 127) / 128), 128, 0, s>>>(
      part_v, part_p, out, nq, nsplit, k);
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
