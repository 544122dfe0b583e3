// Per-thread exact top-k (k <= 32) in registers (sweep_select), and the row
// staging of the kernels that keep one thread per query (sweep_select, the
// radius counts, brute_radius_count, nn_argmin): each thread owns one query;
// candidate rows of 128 points are staged in shared memory by the whole
// block (`stage_row`). The warp-cooperative
// kernels build on warpselect.cuh.
#pragma once
#include "common.cuh"

constexpr int kMaxK = 32;
// +inf, for device code.
#define kInf __int_as_float(0x7f800000)

// The k smallest values seen, ascending in r[0..k).
struct TopK {
  float r[kMaxK];
  float thr;  // r[k - 1]: candidates at or above it cannot enter

  __device__ void init() {
#pragma unroll
    for (int i = 0; i < kMaxK; ++i) r[i] = kInf;
    thr = kInf;
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

  // count = finite values among the k smallest, kth = the last of them
  // (0 when there is none).
  __device__ void count_kth(int k, float& count, float& kth) const {
    count = 0.0f;
    kth = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxK; ++i) {
      if (i < k && r[i] < kInf) {
        count = __fadd_rn(count, 1.0f);
        kth = r[i];
      }
    }
  }
};

// Stage planar row `row` of `pts` into shared memory `sh` (all threads of
// a 128-thread block take part; the caller reads sh after this returns).
__device__ __forceinline__ void stage_row(const float* __restrict__ pts,
                                          long long row, float* sh) {
  const int l = threadIdx.x;
  __syncthreads();  // previous row fully consumed
  const float* src = pts + row * kRowFloats;
  sh[l] = src[l];
  sh[kLanes + l] = src[kLanes + l];
  sh[2 * kLanes + l] = src[2 * kLanes + l];
  sh[3 * kLanes + l] = src[3 * kLanes + l];
  __syncthreads();
}

// Stage a row, then fold its valid candidates' d2 into this thread's top-k.
__device__ __forceinline__ void visit_row(const float* __restrict__ pts,
                                          long long row, float* sh, float qx,
                                          float qy, float qz, bool qv,
                                          TopK& tk, int k) {
  stage_row(pts, row, sh);
  if (!qv) return;
  for (int j = 0; j < kLanes; ++j) {
    if (sh[3 * kLanes + j] > 0.5f)
      tk.push(d2_rn(qx, qy, qz, sh[j], sh[kLanes + j], sh[2 * kLanes + j]), k);
  }
}

// Every thread of a 128-thread block learns whether any thread's `mine`
// is true (a block-uniform test before a walk with barriers in it).
__device__ __forceinline__ bool block_any(bool mine, int* flag) {
  if (threadIdx.x == 0) *flag = 0;
  __syncthreads();
  if (mine) *flag = 1;
  __syncthreads();
  return *flag != 0;
}

// The starts pack of the window sweeps: per block, nshift window start
// rows, nshift dedup skips, nshift lengths and the block-has-valid flag; a
// window covers rows [start + skip, start + length).
constexpr int kShifts = 9;
constexpr int kStartsCols = 3 * kShifts + 1;
