// Segmented inclusive scan of (x, y, z, count) over flat arrays, segments
// starting where first == 1.0.
//
// Replaces pointclouds_tpu/spatial/pallas_kernels.py::segmented_scan_sums
// (kernel body _segscan5_kernel). The TPU kernel scans each [BR, 128] tile
// (BR = min(512, rows)) in VMEM by Hillis-Steele steps over the tile's flat
// index (shifts 1, 2, ..., 64, then 128, 256, ... 128*BR/2), then chains
// the tiles with a sequential carry. A 512x128 tile of five channels is
// ~1.3 MB, far above the 227 KB a block may hold, so this port runs each
// Hillis-Steele step as one grid-wide elementwise pass through device
// memory (ping-pong buffers), then one carry pass. Every add is the TPU
// kernel's add on the same operands, including the `x + 0.0` where the
// shifted operand is masked (not a no-op for -0.0), so the sums are
// BITWISE equal to the reference. Bound on Hopper: memory bandwidth and
// launch latency -- log2(BR*128) + 1 passes of ~20 bytes per element.
#include "common.cuh"

namespace {

__global__ void segscan_step(const float* __restrict__ fi,
                             const float* __restrict__ xi,
                             const float* __restrict__ yi,
                             const float* __restrict__ zi,
                             const float* __restrict__ ci,
                             float* __restrict__ fo, float* __restrict__ xo,
                             float* __restrict__ yo, float* __restrict__ zo,
                             float* __restrict__ co, long long total,
                             int tile_len, int d) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  int local = (int)(i % tile_len);
  bool ok = local >= d;
  float fs = ok ? fi[i - d] : 0.0f;
  float xs = ok ? xi[i - d] : 0.0f;
  float ys = ok ? yi[i - d] : 0.0f;
  float zs = ok ? zi[i - d] : 0.0f;
  float cs = ok ? ci[i - d] : 0.0f;
  float f = fi[i];
  bool start = f > 0.5f;
  xo[i] = start ? xi[i] : __fadd_rn(xi[i], xs);
  yo[i] = start ? yi[i] : __fadd_rn(yi[i], ys);
  zo[i] = start ? zi[i] : __fadd_rn(zi[i], zs);
  co[i] = start ? ci[i] : __fadd_rn(ci[i], cs);
  fo[i] = fmaxf(f, fs);
}

// Sequential tile carry: tile t adds the post-carry last element of tile
// t-1 to its elements before the tile's first segment start. Each thread
// replays the (short) chain of carries up to its own tile.
__global__ void segscan_carry(const float* __restrict__ f,
                              const float* __restrict__ x,
                              const float* __restrict__ y,
                              const float* __restrict__ z,
                              const float* __restrict__ c,
                              float* __restrict__ out, long long total,
                              int tile_len) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  long long t = i / tile_len;
  float cx = 0.0f, cy = 0.0f, cz = 0.0f, cc = 0.0f;
  for (long long tt = 0; tt < t; ++tt) {
    long long last = (tt + 1) * tile_len - 1;
    bool start = f[last] > 0.5f;
    cx = start ? x[last] : __fadd_rn(x[last], cx);
    cy = start ? y[last] : __fadd_rn(y[last], cy);
    cz = start ? z[last] : __fadd_rn(z[last], cz);
    cc = start ? c[last] : __fadd_rn(c[last], cc);
  }
  bool start = f[i] > 0.5f;
  out[i] = start ? x[i] : __fadd_rn(x[i], cx);
  out[total + i] = start ? y[i] : __fadd_rn(y[i], cy);
  out[2 * total + i] = start ? z[i] : __fadd_rn(z[i], cz);
  out[3 * total + i] = start ? c[i] : __fadd_rn(c[i], cc);
}

}  // namespace

// in5: five channel pointers (first, x, y, z, count), each `total` floats,
// total = tiles * tile_len. scratch: 2 * 5 * total floats. out: 4 * total.
extern "C" int pc_segscan5(const float* first, const float* x, const float* y,
                           const float* z, const float* c, float* scratch,
                           float* out, long long total, int tile_len,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  const float* src[5] = {first, x, y, z, c};
  int buf = 0;
  for (int d = 1; d < tile_len; d *= 2) {
    float* dst = scratch + (long long)buf * 5 * total;
    segscan_step<<<blocks, threads, 0, s>>>(
        src[0], src[1], src[2], src[3], src[4], dst, dst + total,
        dst + 2 * total, dst + 3 * total, dst + 4 * total, total, tile_len, d);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    for (int ch = 0; ch < 5; ++ch) src[ch] = dst + ch * total;
    buf ^= 1;
  }
  segscan_carry<<<blocks, threads, 0, s>>>(src[0], src[1], src[2], src[3],
                                           src[4], out, total, tile_len);
  return (int)cudaGetLastError();
}
