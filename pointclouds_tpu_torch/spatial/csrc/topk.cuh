// The selection limit, +inf for device code, and the window sweeps'
// starts pack, shared by the warp-cooperative kernels (warpselect.cuh),
// the min-label walk (minlabel.cuh) and the register-tiled pair walk
// (countwalk.cuh).
#pragma once
#include "common.cuh"

constexpr int kMaxK = 32;
// +inf, for device code.
#define kInf __int_as_float(0x7f800000)

// The starts pack of the window sweeps: per block, nshift window start
// rows, nshift dedup skips, nshift lengths and the block-has-valid flag; a
// window covers rows [start + skip, start + length).
constexpr int kShifts = 9;
constexpr int kStartsCols = 3 * kShifts + 1;
