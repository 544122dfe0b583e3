// The selection limit, +inf for device code, and the row staging of the
// kernel that keeps one thread per query (the group radius counts of
// kernel 12): each thread owns one query; candidate rows of 128 points are
// staged in shared memory by the whole block (`stage_row`). The
// warp-cooperative kernels build on warpselect.cuh, the register-tiled
// pair walk on countwalk.cuh.
#pragma once
#include "common.cuh"

constexpr int kMaxK = 32;
// +inf, for device code.
#define kInf __int_as_float(0x7f800000)

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
