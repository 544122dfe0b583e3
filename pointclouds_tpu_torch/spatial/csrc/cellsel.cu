// Exact k-smallest selections of the cell-grid SOR backends.
//
// Replaces, in pointclouds_tpu/spatial/pallas_kernels.py:
//   * sor_select (kernel body _sor_select_kernel): per cell, the k+1
//     smallest squared distances of each of the cell's M queries to the
//     valid candidates of its gathered 27-cell slab
//     (cellgrid.cell_sor_mean_dists, sor_backend="pallas");
//   * segmented_select (body _segmented_select_kernel): the k smallest
//     values of each row of materialised squared distances
//     (cellgrid.point_sor_mean_dists, sor_backend="xla", and the port's
//     _smallest_k_sum_count on the card).
//
// The TPU kernels extract minima one at a time (sor_select) or through
// per-lane segment finalists with a certificate (segmented_select). Here
// the selection is an exact top-k in registers (topk.cuh), so
// segmented_select's ok is always 1. total adds sqrt of the selected values
// in ascending order (the TPU kernels' extraction order, so the f32 sums are
// bitwise the same), count counts them, kth is the last of them (0 if none).
//
// sor_select: one block per cell, a thread per query. The slab's candidates
// are staged in shared memory in tiles of kTile (x, y, z, valid), each tile
// reused by all the cell's queries; a cell with no valid query (every slot
// past num_cells) returns at once. Bound: the d2 + compare of M * CAND pairs
// per occupied cell (operations).
//
// segmented_select: one warp per row. Lane l folds elements l, l + 32, ...
// (coalesced loads) into its own top-k; then k rounds of a warp-wide
// (value, lane) minimum merge the 32 sorted lists, the winning lane shifting
// its list by one. Bound: one read of the work array (bytes); after the
// first k elements most pushes stop at the threshold compare.
#include "topk.cuh"

namespace {

constexpr int kTile = 512;

__global__ void sor_select_kernel(const float* __restrict__ q,
                                  const unsigned char* __restrict__ qm,
                                  const float* __restrict__ cand,
                                  const unsigned char* __restrict__ cv,
                                  float* __restrict__ total,
                                  int* __restrict__ count,
                                  float* __restrict__ kth, int m, int ncand,
                                  int k1) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile];
  __shared__ unsigned char sv[kTile];
  __shared__ int any_valid;
  const long long c = blockIdx.x;
  const int t = threadIdx.x;
  const unsigned char* qmc = qm + c * m;
  if (t == 0) any_valid = 0;
  __syncthreads();
  for (int i = t; i < m; i += blockDim.x)
    if (qmc[i]) any_valid = 1;
  __syncthreads();
  const bool any = any_valid != 0;
  const float* qc = q + c * 3 * m;
  const float* cc = cand + c * ncand * 3;
  const unsigned char* cvc = cv + c * ncand;
  for (int base = 0; base < m; base += blockDim.x) {
    const int i = base + t;
    const bool live = i < m;
    const bool qv = live && qmc[i];
    const float qx = live ? qc[i] : 0.0f;
    const float qy = live ? qc[m + i] : 0.0f;
    const float qz = live ? qc[2 * m + i] : 0.0f;
    TopK tk;
    tk.init();
    for (int t0 = 0; any && t0 < ncand; t0 += kTile) {
      const int nt = min(kTile, ncand - t0);
      __syncthreads();  // previous tile fully consumed
      for (int j = t; j < nt; j += blockDim.x) {
        const float* p = cc + (long long)(t0 + j) * 3;
        sx[j] = p[0];
        sy[j] = p[1];
        sz[j] = p[2];
        sv[j] = cvc[t0 + j];
      }
      __syncthreads();
      if (qv)
        for (int j = 0; j < nt; ++j)
          if (sv[j]) tk.push(d2_rn(qx, qy, qz, sx[j], sy[j], sz[j]), k1);
    }
    if (live) {
      float tot = 0.0f, kv = 0.0f;
      int cnt = 0;
#pragma unroll
      for (int r = 0; r < kMaxK; ++r)
        if (r < k1 && tk.r[r] < kInf) {
          tot = __fadd_rn(tot, sqrtf(fmaxf(tk.r[r], 0.0f)));
          ++cnt;
          kv = tk.r[r];
        }
      total[c * m + i] = tot;
      count[c * m + i] = cnt;
      kth[c * m + i] = kv;
    }
  }
}

__global__ void segmented_select_kernel(const float* __restrict__ work,
                                        float* __restrict__ out, long long nq,
                                        int w, int k) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= nq) return;  // the whole warp: row is warp-uniform
  const float* wr = work + row * w;
  TopK tk;
  tk.init();
  for (int j = lane; j < w; j += 32) tk.push(__ldg(wr + j), k);
  float total = 0.0f, count = 0.0f, kth = 0.0f;
  for (int i = 0; i < k; ++i) {
    float v = tk.r[0];
    int who = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int ow = __shfl_xor_sync(0xffffffffu, who, off);
      if (ov < v || (ov == v && ow < who)) {
        v = ov;
        who = ow;
      }
    }
    if (lane == who) {
#pragma unroll
      for (int j = 0; j < kMaxK - 1; ++j) tk.r[j] = tk.r[j + 1];
      tk.r[kMaxK - 1] = kInf;
    }
    if (v < kInf) {
      total = __fadd_rn(total, sqrtf(fmaxf(v, 0.0f)));
      count = __fadd_rn(count, 1.0f);
      kth = v;
    }
  }
  if (lane == 0) {
    out[row] = total;
    out[nq + row] = count;
    out[2 * nq + row] = kth;
    out[3 * nq + row] = 1.0f;
  }
}

}  // namespace

// q [c, 3, m], qm [c, m] (bool bytes), cand [c, ncand, 3], cv [c, ncand];
// outputs [c, m]. k1 = k + 1 <= kMaxK values are selected.
extern "C" int pc_sor_select(const float* q, const unsigned char* qm,
                             const float* cand, const unsigned char* cv,
                             float* total, int* count, float* kth, int c,
                             int m, int ncand, int k1, void* stream) {
  if (c == 0 || m == 0) return 0;
  const int threads = min(max(32, (m + 31) / 32 * 32), 256);
  sor_select_kernel<<<c, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, qm, cand, cv, total, count, kth, m, ncand, k1);
  return (int)cudaGetLastError();
}

// work [nq, w]; out [4, nq] rows total, count, kth, ok.
extern "C" int pc_segmented_select(const float* work, float* out,
                                   long long nq, int w, int k, void* stream) {
  if (nq == 0) return 0;
  constexpr int kWarps = 8;
  const unsigned blocks = (unsigned)((nq + kWarps - 1) / kWarps);
  segmented_select_kernel<<<blocks, kWarps * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(work, out, nq,
                                                                 w, k);
  return (int)cudaGetLastError();
}
