// kNN selection + query-centred neighbour moments over the sorted windows
// (normal estimation).
//
// Replaces pointclouds_tpu/spatial/pallas_kernels.py::sweep_moments (kernel
// body _sweep_moments_kernel). Per query, two walks over the block's nine
// deduplicated windows [start + skip, start + length):
//   A. an exact top-k of d2 in registers (k <= 32): count and kth;
//   B. a second walk over the same rows that sums (c - q) and its six
//      products over every candidate with d2 <= kth * f32(1 + D2_BAND), and
//      counts `cle`, the candidates with d2 <= kth * f32(1 + 3 * D2_BAND).
// Outputs 16 rows per query: m1 (x, y, z), m2 (xx, yy, zz, xy, xz, yz),
// cle, count, kth, cert, 0, 0, 0.
//
// The TPU kernel keeps per-lane segment finalists and certifies them
// (cert); the top-k here is exact, so cert is 1 wherever the block is
// valid, and the caller's cle == count test still flags ties at kth. The
// TPU kernel centres the moment features at the block's mean query to feed
// its matrix unit; this kernel centres at the query itself, as the XLA
// mirror (_sweep_moments_xla) does, and adds the included candidates in
// ascending candidate order, so results are deterministic and bitwise
// equal to the plain torch version. Against the mirror (a tree-ordered
// f32 sum of the same products) m1/m2 agree to a few ulps of the summed
// magnitudes; against the TPU kernel's block-centred recombination to
// ~1e-5 relative. d2 is the pinned d2_rn in both walks, so phase B sees
// exactly the values phase A selected from.
//
// Design: one block of 128 threads per 128-query block; each candidate row
// is staged in shared memory and read by all 128 queries. Bound on Hopper:
// the per-pair work, twice (select, then accumulate), ~9 * 4 * 128 = 4608
// candidates per query at the aerial shapes; memory traffic is one 2 KB
// row per staged step, reused 128 times.
#include "topk.cuh"

namespace {

// pts: [nr, 4, 128]; starts: [nb, 28]; out: [16, nb * 128].
__global__ void sweep_moments_kernel(const float* __restrict__ pts,
                                     const int* __restrict__ starts,
                                     float* __restrict__ out, int nb, int k,
                                     float band1, float band3) {
  __shared__ float sh[kRowFloats];
  const int b = blockIdx.x;
  const int l = threadIdx.x;
  const long long stride = (long long)nb * kLanes;
  const long long qi = (long long)b * kLanes + l;
  const int* ss = starts + (long long)b * kStartsCols;
  if (ss[3 * kShifts] == 0) {  // no valid query: the zero/ok pattern
    for (int i = 0; i < 16; ++i) out[i * stride + qi] = i == 12 ? 1.0f : 0.0f;
    return;
  }
  const float* q = pts + (long long)b * kRowFloats;
  const float qx = q[l], qy = q[kLanes + l], qz = q[2 * kLanes + l];
  const bool qv = q[3 * kLanes + l] > 0.5f;

  // ── Phase A: exact top-k of d2 ──
  TopK tk;
  tk.init();
  for (int j = 0; j < kShifts; ++j) {
    const int st = ss[j], ln = ss[2 * kShifts + j];
    for (int r = ss[kShifts + j]; r < ln; ++r)
      visit_row(pts, st + r, sh, qx, qy, qz, qv, tk, k);
  }
  float count, kth;
  tk.count_kth(k, count, kth);
  const float kth_hi = __fmul_rn(kth, band1);
  const float kth_hi2 = __fmul_rn(kth, band3);

  // ── Phase B: banded moments + cle, ascending candidate order ──
  float cle = 0.0f;
  float m[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) m[i] = 0.0f;
  for (int j = 0; j < kShifts; ++j) {
    const int st = ss[j], ln = ss[2 * kShifts + j];
    for (int r = ss[kShifts + j]; r < ln; ++r) {
      stage_row(pts, st + r, sh);
      if (!qv) continue;
      for (int c = 0; c < kLanes; ++c) {
        if (!(sh[3 * kLanes + c] > 0.5f)) continue;
        const float cx = sh[c], cy = sh[kLanes + c], cz = sh[2 * kLanes + c];
        const float d2 = d2_rn(qx, qy, qz, cx, cy, cz);
        if (d2 <= kth_hi2) cle = __fadd_rn(cle, 1.0f);
        if (d2 <= kth_hi) {
          const float rx = __fsub_rn(cx, qx);
          const float ry = __fsub_rn(cy, qy);
          const float rz = __fsub_rn(cz, qz);
          m[0] = __fadd_rn(m[0], rx);
          m[1] = __fadd_rn(m[1], ry);
          m[2] = __fadd_rn(m[2], rz);
          m[3] = __fadd_rn(m[3], __fmul_rn(rx, rx));
          m[4] = __fadd_rn(m[4], __fmul_rn(ry, ry));
          m[5] = __fadd_rn(m[5], __fmul_rn(rz, rz));
          m[6] = __fadd_rn(m[6], __fmul_rn(rx, ry));
          m[7] = __fadd_rn(m[7], __fmul_rn(rx, rz));
          m[8] = __fadd_rn(m[8], __fmul_rn(ry, rz));
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) out[i * stride + qi] = m[i];
  out[9 * stride + qi] = cle;
  out[10 * stride + qi] = count;
  out[11 * stride + qi] = kth;
  out[12 * stride + qi] = 1.0f;
  out[13 * stride + qi] = 0.0f;
  out[14 * stride + qi] = 0.0f;
  out[15 * stride + qi] = 0.0f;
}

}  // namespace

extern "C" int pc_sweep_moments(const float* pts, const int* starts,
                                float* out, int nb, int k, float band1,
                                float band3, void* stream) {
  if (nb > 0)
    sweep_moments_kernel<<<nb, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
        pts, starts, out, nb, k, band1, band3);
  return (int)cudaGetLastError();
}
