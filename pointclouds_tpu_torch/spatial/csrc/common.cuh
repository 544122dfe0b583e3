// Shared helpers for the port's hand-written Hopper kernels.
#pragma once
#include <cuda_runtime.h>

// Squared distance with its contraction pinned: fma(dz, dz, fma(dx, dx,
// dy*dy)), the form XLA's CPU backend compiles the JAX package's
// (qx-cx)**2 + (qy-cy)**2 + (qz-cz)**2 to. Every rounding is explicit (the
// library is also built with --fmad=false), so the kernels' d2 values are
// bitwise equal to the plain torch versions' (which emulate the same fma
// exactly) and to the JAX reference run on the CPU.
__device__ __forceinline__ float d2_rn(float qx, float qy, float qz,
                                       float cx, float cy, float cz) {
  float dx = __fsub_rn(qx, cx);
  float dy = __fsub_rn(qy, cy);
  float dz = __fsub_rn(qz, cz);
  return __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
}

// Planar rows: row r holds 128 points as [x*128 | y*128 | z*128 | w*128].
constexpr int kLanes = 128;
constexpr int kRowFloats = 4 * kLanes;
