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
// sor_select: what bounds it is the bytes any implementation must move:
// the qm and cv masks whole, the sectors of q and cand that hold a valid
// query's or a valid candidate's coordinates, and the outputs. At the
// KITTI "pallas" frame ~96% of the [C, 27 M, 3] slab is masked padding
// (~61 valid slots of 1,512 a cell, ~3.5 valid queries of 56), so a warp
// compacts its cell before any arithmetic: it lists the valid queries
// (their coordinates loaded side by side into shared memory), reads the
// cv row with 8-byte loads where the row is 8-byte aligned (bytes
// otherwise), gives each valid slot its place by a ballot and a prefix
// popcount (indices into shared memory), then loads only those slots' x,
// y and z, all in flight at once, into a stage (structure of arrays,
// kSorStage candidates; a dense cell's rest are read by index through
// L1). A masked slot's coordinates are never read. Then the CTA's warps
// take its cells' valid queries in turn, so a dense cell (up to 27
// queries and 605 valid slots at the bench frame) spreads over the CTA,
// and the CTAs take cells at a stride, so the dense cells, which lie
// together in cell order, spread over the CTAs. A query's d2 (pinned
// form) go to a warp's list (WarpKSmallest<float>, k1 = k + 1 <= 32): the
// first two rows of 32 sorted and merged, later rows offered a row at a
// time, or as a lane's four smallest of kSorValues (the network
// segmented_select uses, below). Measured, the kernel stays far above its
// byte bound: it is held by instruction issue in the selection (sorting
// four rows at once instead of two ran slower; PERF.md).
// Compaction is exact: only the multiset of the k + 1 smallest d2 leaves
// the kernel, summed in ascending order, so skipping masked slots and
// reordering the valid ones changes nothing. Every [C, M] slot is
// written: an invalid query's (and every slot of a cell with none) gets
// 0, 0, 0.
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
template <int N>
__device__ void offer_rest(const float (&v)[N], const float (&m)[4],
                           bool rest, WarpKSmallest<float>& sel) {
  int extra = 0;
#pragma unroll
  for (int u = 0; u < N; ++u) {
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

// The warp offers each lane's N values (no NaN): the lane's four smallest
// (a min/max network) in four steps, then, where a lane's fourth is still
// below tau, the rest of its values. The whole warp calls this.
template <int N>
__device__ __forceinline__ void offer_values(const float (&v)[N],
                                             WarpKSmallest<float>& sel) {
  float m[4] = {kInf, kInf, kInf, kInf};  // this lane's four smallest
#pragma unroll
  for (int u = 0; u < N; ++u) {
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
    offer_values(v, sel);
  }
  sel.store(out, nq, row);
}

// Cells a CTA (a warp each to compact; their queries shared by all the
// CTA's warps), compacted candidates a cell staged as structure of arrays
// (the rest are read by index through L1), values a lane holds in the
// four-smallest path (dense cells), and 8-byte cv words a lane has in
// flight at once.
constexpr int kSorWarps = 8;
constexpr int kSorStage = 256;
constexpr int kSorValues = 16;
constexpr int kCvWords = 8;

// One cell's shared memory: the stage, the valid queries' coordinates and
// columns, the valid count and query count, the valid slots' indices.
struct SorCell {
  float *sx, *sy, *sz, *qx, *qy, *qz;
  int *qcol, *counts;  // counts: valid candidates, valid queries
  unsigned short* idx;

  __host__ __device__ static int words(int m, int ncand) {
    return 3 * kSorStage + 4 * m + 2 + (ncand + 1) / 2;
  }
  __device__ SorCell(float* base, int m) {
    sx = base;
    sy = sx + kSorStage;
    sz = sy + kSorStage;
    qx = sz + kSorStage;
    qy = qx + m;
    qz = qy + m;
    qcol = reinterpret_cast<int*>(qz + m);
    counts = qcol + m;
    idx = reinterpret_cast<unsigned short*>(counts + 2);
  }
};

// One warp lists the cell's valid queries (columns and coordinates, loaded
// side by side) and writes zeros to every other slot. Returns their count.
__device__ int list_queries(const float* __restrict__ qc,
                            const unsigned char* __restrict__ qmc, int m,
                            const SorCell& s, float* total, int* count,
                            float* kth, long long out0, int lane) {
  const unsigned below = (1u << lane) - 1;
  int nq = 0;
  for (int j0 = 0; j0 < m; j0 += 32) {
    const int j = j0 + lane;
    const bool v = j < m && qmc[j] != 0;
    const unsigned bal = __ballot_sync(kFullMask, v);
    if (v) {
      const int p = nq + __popc(bal & below);
      s.qcol[p] = j;
      s.qx[p] = __ldg(qc + j);
      s.qy[p] = __ldg(qc + m + j);
      s.qz[p] = __ldg(qc + 2 * m + j);
    } else if (j < m) {
      total[out0 + j] = 0.0f;
      count[out0 + j] = 0;
      kth[out0 + j] = 0.0f;
    }
    nq += __popc(bal);
  }
  return nq;
}

// One warp compacts the valid slots of a cell's candidate row `cvc` (bool
// bytes) into s.idx, in row order, by ballot and prefix popcount: 8-byte
// loads (kCvWords a lane in flight) where the row is 8-byte aligned,
// bytes otherwise. Returns the number of valid slots.
__device__ int compact_cell(const unsigned char* __restrict__ cvc,
                            int ncand, unsigned short* idx, int lane) {
  const unsigned below = (1u << lane) - 1;
  int n = 0, s0 = 0;
  if ((unsigned long long)cvc % 8 == 0) {
    const int words = ncand / 8;
    const unsigned long long* w8 =
        reinterpret_cast<const unsigned long long*>(cvc);
    for (int w0 = 0; w0 < words; w0 += 32 * kCvWords) {
      unsigned long long bits[kCvWords];
#pragma unroll
      for (int u = 0; u < kCvWords; ++u) {
        const int w = w0 + 32 * u + lane;
        bits[u] = w < words ? __ldg(w8 + w) : 0ull;
      }
#pragma unroll
      for (int u = 0; u < kCvWords; ++u) {
        if (w0 + 32 * u >= words) break;  // warp-uniform
        unsigned mask = 0;
#pragma unroll
        for (int b = 0; b < 8; ++b)
          mask |= ((bits[u] >> (8 * b)) & 0xffull) != 0 ? 1u << b : 0u;
        const int cnt = __popc(mask);
        int incl = cnt;
#pragma unroll
        for (int o = 1; o < 32; o *= 2) {
          const int t = __shfl_up_sync(kFullMask, incl, o);
          if (lane >= o) incl += t;
        }
        int p = n + incl - cnt;
        const int slot0 = 8 * (w0 + 32 * u + lane);
        while (mask) {
          idx[p++] = (unsigned short)(slot0 + __ffs(mask) - 1);
          mask &= mask - 1;
        }
        n += __shfl_sync(kFullMask, incl, 31);
      }
    }
    s0 = words * 8;
  }
  for (; s0 < ncand; s0 += 32) {  // a slot a lane: the tail, or every slot
    const int slot = s0 + lane;
    const bool v = slot < ncand && cvc[slot] != 0;
    const unsigned bal = __ballot_sync(kFullMask, v);
    if (v) idx[n + __popc(bal & below)] = (unsigned short)slot;
    n += __popc(bal);
  }
  return n;
}

// sqrt of a selected finite value, else +0.0.
__device__ __forceinline__ float lane_root(float v, bool selected) {
  return selected && v < kInf ? sqrtf(fmaxf(v, 0.0f)) : 0.0f;
}

// The warp's list of the k1 smallest d2 of query (qx, qy, qz) over the
// cell's n valid candidates: the first kSorStage from the stage, the rest
// by index from `cc` [ncand, 3] (read through L1; only dense cells have
// them). The first two rows of 32 are sorted across the warp and merged
// (two independent sorts: no ballot, no insertion); later rows are
// offered to the list a row at a time for a few rows, else as a lane's
// four smallest of kSorValues.
__device__ __forceinline__ void select_cell(const SorCell& s, int n,
                                            const float* __restrict__ cc,
                                            float qx, float qy, float qz,
                                            int lane,
                                            WarpKSmallest<float>& sel) {
  auto d2 = [&](int j) {
    if (j >= n) return kInf;
    float x, y, z;
    if (j < kSorStage) {
      x = s.sx[j], y = s.sy[j], z = s.sz[j];
    } else {
      const float* p = cc + 3 * (int)s.idx[j];
      x = __ldg(p), y = __ldg(p + 1), z = __ldg(p + 2);
    }
    return fminf(d2_rn(qx, qy, qz, x, y, z), kInf);
  };
  const float a = warp_sort(d2(lane), lane);
  sel.list = n <= 32 ? a : warp_merge(a, warp_sort(d2(32 + lane), lane), lane);
  if (n <= 64) return;
  sel.refresh();
  if (n <= 4 * 32) {  // a few more rows of 32: offer them as they are
    for (int j0 = 64; j0 < n; j0 += 32) sel.offer(d2(j0 + lane));
    return;
  }
  for (int c0 = 64; c0 < n; c0 += 32 * kSorValues) {
    float v[kSorValues];
#pragma unroll
    for (int u = 0; u < kSorValues; ++u) v[u] = d2(c0 + 32 * u + lane);
    offer_values(v, sel);
  }
}

// Lane 0 stores the k1 smallest's (total, count, kth) at `col`: total adds
// sqrt of each finite value in ascending order (a non-finite one adds
// +0.0 to a sum that is never -0.0: no change), count the finite ones, kth
// the last of them (0 if none).
__device__ __forceinline__ void store_sor(const WarpKSmallest<float>& sel,
                                          float* total, int* count,
                                          float* kth, long long col) {
  const float root =  // each lane its entry
      lane_root(sel.list, sel.lane < sel.k);
  float tot = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i)  // independent shuffles, one add chain
    tot = __fadd_rn(tot, __shfl_sync(kFullMask, root, i));
  int cnt;
  float kv;
  sel.count_kth(cnt, kv);
  if (sel.lane == 0) {
    total[col] = tot;
    count[col] = cnt;
    kth[col] = kv;
  }
}

// q [c, 3, m], qm [c, m], cand [c, ncand, 3], cv [c, ncand]; outputs [c, m].
// CTA b of B holds cells b, b + B, ..., b + (W - 1) B (W = its warps):
// warp w lists and compacts cell b + w B, then the CTA's warps take the
// cells' valid queries in turn (item i: warp i % W), so a cell with many
// queries spreads over the CTA. The stride spreads the dense cells, which
// lie together in cell order, over the CTAs. Shared memory: W SorCells.
__global__ void __launch_bounds__(kSorWarps * 32)
    sor_select_kernel(const float* __restrict__ q,
                      const unsigned char* __restrict__ qm,
                      const float* __restrict__ cand,
                      const unsigned char* __restrict__ cv,
                      float* __restrict__ total, int* __restrict__ count,
                      float* __restrict__ kth, int cells, int m, int ncand,
                      int k1) {
  extern __shared__ float sh[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int nw = blockDim.x / 32;
  const int cw = SorCell::words(m, ncand);
  {
    const long long c = blockIdx.x + (long long)warp * gridDim.x;
    const SorCell s(sh + warp * cw, m);
    int nq = 0, n = 0;
    if (c < cells) {
      nq = list_queries(q + c * 3 * m, qm + c * m, m, s, total, count, kth,
                        c * m, lane);
      if (nq > 0) {
        n = compact_cell(cv + c * ncand, ncand, s.idx, lane);
        __syncwarp();
        const float* cc = cand + c * ncand * 3;
#pragma unroll 4
        for (int p = lane; p < min(n, kSorStage); p += 32) {
          const float* src = cc + 3 * (int)s.idx[p];
          s.sx[p] = __ldg(src);
          s.sy[p] = __ldg(src + 1);
          s.sz[p] = __ldg(src + 2);
        }
      }
    }
    if (lane == 0) {
      s.counts[0] = n;
      s.counts[1] = nq;
    }
  }
  __syncthreads();
  int pre[kSorWarps + 1];  // prefix of the cells' valid queries
  pre[0] = 0;
#pragma unroll
  for (int g = 0; g < kSorWarps; ++g)
    pre[g + 1] = pre[g] + (g < nw ? SorCell(sh + g * cw, m).counts[1] : 0);
  for (int item = warp; item < pre[kSorWarps]; item += nw) {
    int g = 0;
#pragma unroll
    for (int i = 1; i < kSorWarps; ++i) g += pre[i] <= item;
    const SorCell s(sh + g * cw, m);
    const int j = item - pre[g];
    const long long c = blockIdx.x + (long long)g * gridDim.x;
    WarpKSmallest<float> sel;
    sel.init(k1, lane);
    select_cell(s, s.counts[0], cand + c * ncand * 3, s.qx[j], s.qy[j],
                s.qz[j], lane, sel);
    store_sor(sel, total, count, kth, c * m + s.qcol[j]);
  }
}

}  // namespace

// q [c, 3, m], qm [c, m] (bool bytes), cand [c, ncand, 3], cv [c, ncand];
// outputs [c, m]. k1 = k + 1 <= kMaxK values are selected; ncand < 2^16.
// A CTA holds as many cells (at most kSorWarps) as its shared memory fits.
extern "C" int pc_sor_select(const float* q, const unsigned char* qm,
                             const float* cand, const unsigned char* cv,
                             float* total, int* count, float* kth, int c,
                             int m, int ncand, int k1, void* stream) {
  constexpr int kMaxSmem = 227 * 1024;
  static int allowed = 48 * 1024;
  if (c == 0 || m == 0) return 0;
  if (ncand > 65535) return (int)cudaErrorInvalidValue;
  const int cell_bytes = SorCell::words(m, ncand) * (int)sizeof(float);
  const int warps = min(kSorWarps, kMaxSmem / cell_bytes);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const int smem = warps * cell_bytes;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        sor_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  const unsigned blocks = (unsigned)((c + warps - 1) / warps);
  sor_select_kernel<<<blocks, warps * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      q, qm, cand, cv, total, count, kth, c, m, ncand, k1);
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
