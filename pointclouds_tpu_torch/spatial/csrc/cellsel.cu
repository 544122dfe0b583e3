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
// each selection is exact, so segmented_select's ok is always 1. total adds
// sqrt of the selected values in ascending order (the TPU kernels'
// extraction order, so the f32 sums are bitwise the same), count counts
// them, kth is the last of them (0 if none).
//
// sor_select: one block per cell, a thread per query, each an exact top-k
// in registers (topk.cuh). The slab's candidates are staged in shared
// memory in tiles of kTile (x, y, z, valid), each tile reused by all the
// cell's queries; a cell with no valid query (every slot past num_cells)
// returns at once. Bound: the d2 + compare of M * CAND pairs per occupied
// cell (operations).
//
// segmented_select: one warp per row on the warp-select core
// (warpselect.cuh, WarpKSmallest<float>: lane i holds the i-th smallest
// value, tau = entry k-1). Bound: one read of the work array (bytes), so
// the row is read once, in chunks of 32 * kSegValues values held in
// registers (16-byte loads where the rows are 16-byte aligned, all of a
// chunk's loads in flight at once). Each lane keeps its four smallest of
// the chunk (a min/max network, no shuffles) and the warp offers those
// four steps to the list: a ballot each, few insertions. The k smallest
// of a row rarely put more than four in one lane; a lane whose fourth is
// still below tau then offers the rest of its chunk (its values above the
// fourth and its extra copies of it: everything below the fourth is among
// the first three). Only the multiset of the k smallest leaves the kernel,
// so skipping a value equal to tau is exact.
#include "warpselect.cuh"

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

// Values a lane holds per chunk of a row and warps per CTA, measured on
// the H100 at the KITTI "xla" frame's inputs (PERF.md): 16 and 32 values
// ran as fast as 48; 16 warps (64 registers, 2 CTAs an SM) beat 8 and 4.
// Offering every value behind a vote per four, instead of a lane's four
// smallest, ran 1.12x slower.
constexpr int kSegValues = 48;
constexpr int kSegWarps = 16;

// This lane's kSegValues values of the chunk at c0 of row `wr` (+inf past
// w; NaN read as +inf, as the plain version ranks it): kVec, elements c0 +
// 4 (32 u + lane) + j, one 16-byte load each (wr and w 16-byte aligned);
// else c0 + 32 u + lane.
template <bool kVec>
__device__ __forceinline__ void load_chunk(const float* __restrict__ wr,
                                           int c0, int w, int lane,
                                           float (&v)[kSegValues]) {
  if constexpr (kVec) {
    const float4* p = reinterpret_cast<const float4*>(wr + c0);
#pragma unroll
    for (int u = 0; u < kSegValues / 4; ++u) {
      float4 x = make_float4(kInf, kInf, kInf, kInf);
      if (c0 + 4 * (32 * u + lane) < w) x = __ldg(p + 32 * u + lane);
      v[4 * u] = x.x;
      v[4 * u + 1] = x.y;
      v[4 * u + 2] = x.z;
      v[4 * u + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < kSegValues; ++u) {
      const int e = c0 + 32 * u + lane;
      v[u] = e < w ? __ldg(wr + e) : kInf;
    }
  }
#pragma unroll
  for (int u = 0; u < kSegValues; ++u) v[u] = fminf(v[u], kInf);
}

// Lanes with `rest` offer what their chunk holds beyond its four smallest
// m[0..3]: the values above m[3] and the copies of m[3] past those among
// m[0..3]. The whole warp calls this.
__device__ void offer_rest(const float (&v)[kSegValues], const float (&m)[4],
                           bool rest, WarpKSmallest<float>& sel) {
  int extra = 0;
#pragma unroll
  for (int u = 0; u < kSegValues; ++u) {
    sel.offer(rest && v[u] > m[3] ? v[u] : kInf);
    extra += v[u] == m[3];
  }
  extra = rest ? extra - 1 - (m[0] == m[3]) - (m[1] == m[3]) - (m[2] == m[3])
               : 0;
  while (__any_sync(kFullMask, extra > 0)) {
    sel.offer(extra > 0 ? m[3] : kInf);
    --extra;
  }
}

// work: [nq, w]; out: [4, nq]. Warp i of CTA b selects row b * kSegWarps + i.
template <bool kVec>
__global__ void __launch_bounds__(kSegWarps * 32)
    segmented_select_kernel(const float* __restrict__ work,
                            float* __restrict__ out, long long nq, int w,
                            int k) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kSegWarps + threadIdx.x / 32;
  if (row >= nq) return;  // the whole warp: row is warp-uniform
  const float* wr = work + row * w;
  WarpKSmallest<float> sel;
  sel.init(k, lane);
  for (int c0 = 0; c0 < w; c0 += 32 * kSegValues) {
    float v[kSegValues];
    load_chunk<kVec>(wr, c0, w, lane, v);
    float m[4] = {kInf, kInf, kInf, kInf};  // this lane's four smallest
#pragma unroll
    for (int u = 0; u < kSegValues; ++u) {
      m[3] = fminf(m[3], fmaxf(m[2], v[u]));
      m[2] = fminf(m[2], fmaxf(m[1], v[u]));
      m[1] = fminf(m[1], fmaxf(m[0], v[u]));
      m[0] = fminf(m[0], v[u]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) sel.offer(m[j]);
    const bool rest = m[3] < sel.tau;
    if (__any_sync(kFullMask, rest)) offer_rest(v, m, rest, sel);
  }
  sel.store(out, nq, row);
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
  const unsigned blocks = (unsigned)((nq + kSegWarps - 1) / kSegWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((unsigned long long)work % 16 == 0 && w % 4 == 0)
    segmented_select_kernel<true><<<blocks, kSegWarps * 32, 0, s>>>(
        work, out, nq, w, k);
  else
    segmented_select_kernel<false><<<blocks, kSegWarps * 32, 0, s>>>(
        work, out, nq, w, k);
  return (int)cudaGetLastError();
}
