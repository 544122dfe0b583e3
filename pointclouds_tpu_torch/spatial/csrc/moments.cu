// kNN selection + query-centred neighbour moments over the sorted windows
// (normal estimation).
//
// Replaces pointclouds_tpu/spatial/pallas_kernels.py::sweep_moments (kernel
// body _sweep_moments_kernel). Per query, over the block's nine
// deduplicated windows [start + skip, start + length):
//   A. the exact k smallest d2: count and kth;
//   B. a walk over the same rows that sums (c - q) and its six products
//      over every candidate with d2 <= kth * f32(1 + D2_BAND), and counts
//      `cle`, the candidates with d2 <= kth * f32(1 + 3 * D2_BAND).
// Outputs 16 rows per query: m1 (x, y, z), m2 (xx, yy, zz, xy, xz, yz),
// cle, count, kth, cert, 0, 0, 0.
//
// The TPU kernel keeps per-lane segment finalists and certifies them
// (cert); the selection here is exact, so cert is 1 wherever the block is
// valid, and the caller's cle == count test still flags ties at kth. The
// TPU kernel centres the moment features at the block's mean query to feed
// its matrix unit; this kernel centres at the query itself, as the XLA
// mirror (_sweep_moments_xla) does, and adds the included candidates one
// at a time in ascending candidate order (window by window, row by row,
// lane 0-127), so results are deterministic and bitwise equal to the plain
// torch version. Against the mirror (a tree-ordered f32 sum of the same
// products) m1/m2 agree to a few ulps of the summed magnitudes; against
// the TPU kernel's block-centred recombination to ~1e-5 relative. d2 is
// the pinned d2_rn in every walk, so phase B sees exactly the values
// phase A selected from.
//
// Bound on Hopper: the per-pair d2 + compare work (operations), ~975
// candidates a query at the aerial bench frame; each staged row is reused
// by all 128 queries of its block.
//
// Design: the warp-select core (warpselect.cuh). One warp serves a query
// and the W warps of a CTA are W queries of one block, sharing a cp.async
// ring of 8-row tiles over the block's window rows (WindowRows). Phase A is
// select_rows (a bound walk, then the selection walk); only count and kth
// leave it, so it needs no positions. Phase B walks the same rows once
// more: each lane forms the d2 of candidates u * 32 + lane, `cle` is a
// ballot count per step (an integer, exact in any order), and the lanes
// whose candidate falls in the band are walked in ascending lane order,
// which is ascending candidate order: each one's differences are shuffled
// to the warp and added to the running sums. About k candidates a query
// pass, so the sums cost ~k shuffled adds without divergence. A sequential
// sum cannot be split, so a query has one warp.
#include "warpselect.cuh"

namespace {

// The rows of the block's nine windows (WindowRows, warpselect.cuh): their
// prefix sums and bases live in shared memory past the ring, 48 KB and 80
// bytes, above the static limit, so the kernel takes its shared memory
// dynamically.
constexpr int kRingBytes = kStages * kTileFloats * sizeof(float);
constexpr int kMomentsSmem = kRingBytes + 2 * 10 * sizeof(int);

// pts: [nr, 4, 128]; starts: [nb, 28]; out: [16, nb * 128]. CTA i serves
// queries (i % kPer) * W + warp of block i / kPer.
template <int W>
__global__ void __launch_bounds__(W * 32, 3)
    sweep_moments_kernel(const float* __restrict__ pts,
                         const int* __restrict__ starts,
                         float* __restrict__ out, int nb, int k, float band1,
                         float band3) {
  extern __shared__ __align__(16) float sh[];  // kMomentsSmem bytes
  int* pre = reinterpret_cast<int*>(sh + kStages * kTileFloats);
  int* base = pre + kShifts + 1;
  constexpr int kPer = kLanes / W;
  const int b = blockIdx.x / kPer;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int qi = (blockIdx.x % kPer) * W + warp;
  const int* ss = starts + (long long)b * kStartsCols;
  if (threadIdx.x == 0) WindowRows::fill<true>(ss, pre, base);
  __syncthreads();
  // A block with no valid query walks nothing: the zero/ok pattern.
  const int nrows = ss[3 * kShifts] != 0 ? pre[kShifts] : 0;
  const WindowRows rows{pre, base};
  const float* q = pts + (long long)b * kRowFloats;
  const float qx = q[qi], qy = q[kLanes + qi], qz = q[2 * kLanes + qi];
  const bool live = q[3 * kLanes + qi] > 0.5f;

  // ── Phase A: the exact k smallest d2 ──
  WarpKSmallest<float> sel;
  sel.init(k, lane);
  const bool walk = __syncthreads_or(live && nrows > 0);
  if (walk)
    select_rows<W * 32, 1>(pts, rows, nrows, sh, qx, qy, qz, live, 0, sel);
  int count;
  float kth;
  sel.count_kth(count, kth);
  const float kth_hi = __fmul_rn(kth, band1);
  const float kth_hi2 = __fmul_rn(kth, band3);

  // ── Phase B: banded moments + cle, ascending candidate order ──
  int cle = 0;
  float m[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) m[i] = 0.0f;
  if (walk)
    walk_rows<W * 32>(pts, rows, nrows, sh, live, 0, 1,
                      [&](const float* s, int) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = u * 32 + lane;
        const float cx = s[j], cy = s[kLanes + j], cz = s[2 * kLanes + j];
        const bool valid = s[3 * kLanes + j] > 0.5f;
        const float d2 = d2_rn(qx, qy, qz, cx, cy, cz);
        const unsigned near = __ballot_sync(kFullMask, valid && d2 <= kth_hi2);
        if (near == 0) continue;  // warp-uniform; the band lies within
        cle += __popc(near);
        unsigned band = __ballot_sync(kFullMask, valid && d2 <= kth_hi);
        const float rx = __fsub_rn(cx, qx);
        const float ry = __fsub_rn(cy, qy);
        const float rz = __fsub_rn(cz, qz);
        while (band) {
          const int src = __ffs(band) - 1;
          band &= band - 1;
          const float x = __shfl_sync(kFullMask, rx, src);
          const float y = __shfl_sync(kFullMask, ry, src);
          const float z = __shfl_sync(kFullMask, rz, src);
          m[0] = __fadd_rn(m[0], x);
          m[1] = __fadd_rn(m[1], y);
          m[2] = __fadd_rn(m[2], z);
          m[3] = __fadd_rn(m[3], __fmul_rn(x, x));
          m[4] = __fadd_rn(m[4], __fmul_rn(y, y));
          m[5] = __fadd_rn(m[5], __fmul_rn(z, z));
          m[6] = __fadd_rn(m[6], __fmul_rn(x, y));
          m[7] = __fadd_rn(m[7], __fmul_rn(x, z));
          m[8] = __fadd_rn(m[8], __fmul_rn(y, z));
        }
      }
    });
  if (lane == 0) {
    const long long stride = (long long)nb * kLanes;
    const long long col = (long long)b * kLanes + qi;
#pragma unroll
    for (int i = 0; i < 9; ++i) out[i * stride + col] = m[i];
    out[9 * stride + col] = (float)cle;
    out[10 * stride + col] = (float)count;
    out[11 * stride + col] = kth;
    out[12 * stride + col] = 1.0f;
    out[13 * stride + col] = 0.0f;
    out[14 * stride + col] = 0.0f;
    out[15 * stride + col] = 0.0f;
  }
}

// Warps (queries) per CTA, measured on the H100 at the aerial frame's and
// the normals 100K op's inputs (PERF.md): 16 beat 8 and 32; phase A's
// bound walk beat one streamed walk (0.84 against 0.94 ms at the aerial
// frame's), as in SOR pass 1; and 3 CTAs an SM (__launch_bounds__: 40
// registers, 52 bytes of spill stores) beat 2 (64 registers, no spill)
// and 4 (32 registers, 240 bytes).
constexpr int kMomentsWarps = 16;

}  // namespace

extern "C" int pc_sweep_moments(const float* pts, const int* starts,
                                float* out, int nb, int k, float band1,
                                float band3, void* stream) {
  if (nb == 0) return 0;
  auto kernel = sweep_moments_kernel<kMomentsWarps>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMomentsSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nb * (kLanes / kMomentsWarps), kMomentsWarps * 32, kMomentsSmem,
           static_cast<cudaStream_t>(stream)>>>(pts, starts, out, nb, k,
                                                band1, band3);
  return (int)cudaGetLastError();
}
