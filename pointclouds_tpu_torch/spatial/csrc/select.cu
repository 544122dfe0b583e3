// Exact k-smallest neighbour selection for the sweep SOR (passes 1 and 2).
//
// Replaces, in pointclouds_tpu/spatial/pallas_kernels.py:
//   * sweep_select_rows (kernel body _sweep_select_rows_kernel): per 128-query
//     block, the k smallest masked squared distances over the block's flat
//     list of candidate rows (SOR pass 1);
//   * rescue_select (bodies _rescue_select_kernel / _rescue_walk_store): the
//     same selection for compacted flagged query blocks, walking only the
//     8-row candidate groups in each block's AABB-pruned active list (pass 2).
//
// The TPU kernels keep per-lane-segment finalists (a lane trick) and certify
// them; here each thread owns one query and keeps an exact sorted top-k in
// registers, so the result is always exact and `ok` is always 1. Outputs per
// query: total = sum of sqrt(d2) over the k smallest, added in ascending
// order (the TPU kernel's extraction order, so the f32 sum is bitwise the
// same), count = number extracted, kth = the last extracted d2 (0 if none).
//
// Design: one block of 128 threads per query block. Each candidate row (128
// points, 2 KB) is staged in shared memory by the block, then every thread
// scans it. Bound on Hopper: the per-pair d2 + compare work, not memory:
// each staged row is reused by all 128 queries, and insertions are rare
// after the first k candidates. Pass 1 has ~768 query blocks, enough to
// fill the card. Pass 2 has only fix_cap/128 (32) blocks, each walking up
// to every group of the cloud, so its group list is split over `nsplit`
// blocks per query block, each keeping a partial top-k, and a second
// kernel merges the partial lists (the k smallest of their union).
#include "common.cuh"

namespace {

constexpr int kMaxK = 32;

struct TopK {
  float r[kMaxK];
  float thr;  // r[k - 1]: candidates at or above it cannot enter

  __device__ void init() {
#pragma unroll
    for (int i = 0; i < kMaxK; ++i) r[i] = __int_as_float(0x7f800000);
    thr = __int_as_float(0x7f800000);
  }

  __device__ void push(float d2, int k) {
    if (!(d2 < thr)) return;
    float cur = d2;
#pragma unroll
    for (int i = 0; i < kMaxK; ++i) {
      float lo = fminf(r[i], cur);
      cur = fmaxf(r[i], cur);
      r[i] = lo;
    }
#pragma unroll
    for (int i = 0; i < kMaxK; ++i)
      if (i == k - 1) thr = r[i];
  }

  __device__ void store(float* out, long long stride, long long q, int k) {
    float total = 0.0f, count = 0.0f, kth = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxK; ++i) {
      if (i < k && r[i] < __int_as_float(0x7f800000)) {
        total = __fadd_rn(total, sqrtf(fmaxf(r[i], 0.0f)));
        count = __fadd_rn(count, 1.0f);
        kth = r[i];
      }
    }
    out[q] = total;
    out[stride + q] = count;
    out[2 * stride + q] = kth;
    out[3 * stride + q] = 1.0f;
  }
};

// Stage planar row `row` of `pts` into shared memory, then fold its 128
// candidates into this thread's top-k.
__device__ __forceinline__ void visit_row(const float* __restrict__ pts,
                                          long long row, float* sh, float qx,
                                          float qy, float qz, bool qv,
                                          TopK& tk, int k) {
  const int l = threadIdx.x;
  __syncthreads();  // previous row fully consumed
  const float* src = pts + row * kRowFloats;
  sh[l] = src[l];
  sh[kLanes + l] = src[kLanes + l];
  sh[2 * kLanes + l] = src[2 * kLanes + l];
  sh[3 * kLanes + l] = src[3 * kLanes + l];
  __syncthreads();
  if (!qv) return;
  for (int j = 0; j < kLanes; ++j) {
    if (sh[3 * kLanes + j] > 0.5f)
      tk.push(d2_rn(qx, qy, qz, sh[j], sh[kLanes + j], sh[2 * kLanes + j]), k);
  }
}

// pts: [nr + 1, 4, 128] (pad row nr all-masked); rowlist: [nb, cap + 2]
// (row ids, block-valid flag, true row count). Query block b = row b.
__global__ void sweep_select_rows_kernel(const float* __restrict__ pts,
                                         const int* __restrict__ rowlist,
                                         float* __restrict__ out, int nb,
                                         int cap, int k) {
  __shared__ float sh[kRowFloats];
  const int b = blockIdx.x;
  const int l = threadIdx.x;
  const int* rl = rowlist + (long long)b * (cap + 2);
  const float* q = pts + (long long)b * kRowFloats;
  float qx = q[l], qy = q[kLanes + l], qz = q[2 * kLanes + l];
  bool qv = q[3 * kLanes + l] > 0.5f;
  TopK tk;
  tk.init();
  if (rl[cap] != 0) {
    int nrows = min(rl[cap + 1], cap);
    for (int t = 0; t < nrows; ++t)
      visit_row(pts, rl[t], sh, qx, qy, qz, qv, tk, k);
  }
  tk.store(out, (long long)nb * kLanes, (long long)b * kLanes + l, k);
}

// cand: [nr, 4, 128]; q: [qb, 4, 128]; active: [qb, 1 + ng] (count, then
// ascending group ids; entries past the count are garbage and never read).
// Block (b, s) walks groups s, s + nsplit, ... of query block b's list and
// writes its partial top-k to part[s][i][q] (inf-padded).
__global__ void rescue_partial_kernel(const float* __restrict__ cand,
                                      const float* __restrict__ qpl,
                                      const int* __restrict__ active,
                                      float* __restrict__ part, int qb,
                                      int ng1, int gr, int k) {
  __shared__ float sh[kRowFloats];
  __shared__ int any_valid;
  const int b = blockIdx.x;
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  const int l = threadIdx.x;
  const float* q = qpl + (long long)b * kRowFloats;
  float qx = q[l], qy = q[kLanes + l], qz = q[2 * kLanes + l];
  bool qv = q[3 * kLanes + l] > 0.5f;
  if (l == 0) any_valid = 0;
  __syncthreads();
  if (qv) any_valid = 1;
  __syncthreads();
  TopK tk;
  tk.init();
  if (any_valid) {
    const int* act = active + (long long)b * ng1;
    int ngroups = act[0];
    for (int t = split; t < ngroups; t += nsplit) {
      long long base = (long long)act[1 + t] * gr;
      for (int r = 0; r < gr; ++r)
        visit_row(cand, base + r, sh, qx, qy, qz, qv, tk, k);
    }
  }
  const long long nq = (long long)qb * kLanes;
  const long long qi = (long long)b * kLanes + l;
#pragma unroll
  for (int i = 0; i < kMaxK; ++i)
    if (i < k) part[((long long)split * k + i) * nq + qi] = tk.r[i];
}

// One thread per query: merge the nsplit partial top-k lists (the k
// smallest of their union are the k smallest overall) and store.
__global__ void rescue_merge_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, long long nq,
                                    int nsplit, int k) {
  long long qi = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (qi >= nq) return;
  TopK tk;
  tk.init();
  for (int s = 0; s < nsplit; ++s)
    for (int i = 0; i < k; ++i)
      tk.push(part[((long long)s * k + i) * nq + qi], k);
  tk.store(out, nq, qi, k);
}

}  // namespace

extern "C" int pc_max_k() { return kMaxK; }

extern "C" int pc_sweep_select_rows(const float* pts, const int* rowlist,
                                    float* out, int nb, int cap, int k,
                                    void* stream) {
  if (nb > 0)
    sweep_select_rows_kernel<<<nb, kLanes, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        pts, rowlist, out, nb, cap, k);
  return (int)cudaGetLastError();
}

// part: scratch of nsplit * k * qb * 128 floats.
extern "C" int pc_rescue_select(const float* cand, const float* q,
                                const int* active, float* part, float* out,
                                int qb, int ng1, int gr, int k, int nsplit,
                                void* stream) {
  if (qb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rescue_partial_kernel<<<dim3(qb, nsplit), kLanes, 0, s>>>(
      cand, q, active, part, qb, ng1, gr, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  long long nq = (long long)qb * kLanes;
  rescue_merge_kernel<<<(unsigned)((nq + 127) / 128), 128, 0, s>>>(
      part, out, nq, nsplit, k);
  return (int)cudaGetLastError();
}
