// Segmented inclusive scan of (x, y, z, count) over flat arrays, segments
// starting where first == 1.0.
//
// Replaces pointclouds_tpu/spatial/pallas_kernels.py::segmented_scan_sums
// (kernel body _segscan5_kernel). The TPU kernel scans each [BR, 128] tile
// (BR = min(512, rows)) in VMEM by Hillis-Steele steps over the tile's flat
// index (shifts 1, 2, 4, ... < tile length), then chains the tiles with a
// sequential carry. A 512x128 tile of five channels is ~1.3 MB, far above
// the 227 KB a block may hold. The work is ~20 bytes an element, so the
// bound is memory and, at the pipelines' sizes, launch latency: the design
// runs the same tree in three launches instead of one launch a step.
//
// Exactness. After step s (shift 2^(s-1)) an element depends only on the
// 2^s elements of its tile that end at it, so
//   pass A: the steps with shift 1 .. 2^(L-1) run in shared memory on a
//           chunk of kScanChunk elements plus the 2^L - 1 before it in its
//           tile (fewer at the tile's start: the masked operand there is
//           0.0, as in the reference);
//   pass B: every later step (shift 2^L, 2^(L+1), ... < tile length) adds
//           only elements with the same index mod 2^L, so a block runs them
//           in shared memory on kScanResidues residues of one tile: over a
//           residue's sequence they are shifts 1, 2, 4, ..., masked where
//           the row index is below the shift;
//   pass C: the tile carry, as the reference chains it, where it applies
//           (tiles >= 1, before their first segment start).
// Every add is the reference's add on the same operands, including the
// `x + 0.0` of a masked operand and of tile 0's zero carry (neither is a
// no-op for -0.0), and the flag is carried as fmaxf, so the sums are
// BITWISE equal to the reference. Each pass reads and writes its elements
// once; pass B writes the finished elements to the output and keeps the
// rest (before a tile's first start) in the scratch for pass C.
#include "common.cuh"

namespace {

// L: pass A runs the steps with shift below 2^kScanLog, pass B the rest.
constexpr int kScanLog = 10;
constexpr int kScanSpan = 1 << kScanLog;
// Elements a pass-A block scans (plus its halo of kScanSpan - 1).
constexpr int kScanChunk = 2048;
// Residues mod kScanSpan a pass-B block scans: one 128-byte row each.
constexpr int kScanResidues = 32;
// The reference's largest tile: 512 rows of 128.
constexpr int kScanMaxTile = 512 * 128;
constexpr int kScanThreads = 1024;
// Elements each thread of a block holds in a step.
constexpr int kScanPerA =
    (kScanChunk + kScanSpan - 1 + kScanThreads - 1) / kScanThreads;
constexpr int kScanRowsB =
    kScanMaxTile / kScanSpan > 0 ? kScanMaxTile / kScanSpan : 1;
constexpr int kScanPerB =
    (kScanRowsB * kScanResidues + kScanThreads - 1) / kScanThreads;
static_assert(kScanSpan % kScanResidues == 0, "residue runs tile 2^L");

struct ScanArgs {
  const float* in[5];  // first, x, y, z, count
  float* scratch;      // [5, total]
  float* out;          // [4, total]
  long long total;
  int tile_len;
};

// One Hillis-Steele step on the n staged elements of sm [5][stride]:
// element e adds element e - shift where ok(e) (else the masked 0.0),
// unless its flag marks a segment start; the flag takes the fmaxf. All
// threads of the block call it.
template <int kPer, class Ok>
__device__ __forceinline__ void scan_step(float* sm, int stride, int n,
                                          int shift, Ok ok) {
  float sh[5][kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * kScanThreads;
    const bool take = e < n && ok(e);
#pragma unroll
    for (int ch = 0; ch < 5; ++ch)
      sh[ch][j] = take ? sm[ch * stride + e - shift] : 0.0f;
  }
  __syncthreads();  // every shifted operand read before any is replaced
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * kScanThreads;
    if (e < n) {
      const float f = sm[e];
      const bool start = f > 0.5f;
#pragma unroll
      for (int ch = 1; ch < 5; ++ch) {
        const float v = sm[ch * stride + e];
        sm[ch * stride + e] = start ? v : __fadd_rn(v, sh[ch][j]);
      }
      sm[e] = fmaxf(f, sh[0][j]);
    }
  }
  __syncthreads();
}

// Element i (of tile `tile`) after every in-tile step: tile 0 takes its
// zero carry (`v + 0.0` before the first start) and is done; a later tile's
// elements from its first start on are done; the others keep their sums in
// the scratch for pass C. The flag goes to the scratch for pass C.
__device__ __forceinline__ void scan_finish(const ScanArgs& a, long long i,
                                            long long tile, const float* v,
                                            float f) {
  a.scratch[i] = f;
  const bool start = f > 0.5f;
  if (tile == 0) {
#pragma unroll
    for (int ch = 0; ch < 4; ++ch)
      a.out[ch * a.total + i] = start ? v[ch] : __fadd_rn(v[ch], 0.0f);
  } else if (start) {
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) a.out[ch * a.total + i] = v[ch];
  } else {
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) a.scratch[(ch + 1) * a.total + i] = v[ch];
  }
}

// Pass A: block b scans chunk b % chunks of tile b / chunks, with the
// steps of shift < min(2^L, tile length). `finish`: no later step (the
// tile is no longer than 2^L), so the block finishes its elements.
__global__ void __launch_bounds__(kScanThreads)
    scan_pass_a(ScanArgs a, int chunks, int stride, bool finish) {
  extern __shared__ float sm[];  // [5][stride]
  const long long tile = blockIdx.x / chunks;
  const int lc = (blockIdx.x % chunks) * kScanChunk;  // chunk start in tile
  const int len = min(kScanChunk, a.tile_len - lc);
  const int halo = min(kScanSpan - 1, lc);
  const int n = halo + len;
  const int local0 = lc - halo;  // tile index of staged element 0
  const long long g0 = tile * a.tile_len + local0;
  for (int e = threadIdx.x; e < n; e += kScanThreads)
#pragma unroll
    for (int ch = 0; ch < 5; ++ch) sm[ch * stride + e] = a.in[ch][g0 + e];
  __syncthreads();
  for (int d = 1; d < kScanSpan && d < a.tile_len; d *= 2)
    // Masked where the tile index is below d. A halo element whose operand
    // lies before the staged window needs no right value: no chunk
    // element depends on it.
    scan_step<kScanPerA>(sm, stride, n, d,
                         [&](int e) { return local0 + e >= d && e >= d; });
  for (int e = halo + threadIdx.x; e < n; e += kScanThreads) {
    const long long i = g0 + e;
    if (finish) {
      const float v[4] = {sm[stride + e], sm[2 * stride + e],
                          sm[3 * stride + e], sm[4 * stride + e]};
      scan_finish(a, i, tile, v, sm[e]);
    } else {
#pragma unroll
      for (int ch = 0; ch < 5; ++ch)
        a.scratch[ch * a.total + i] = sm[ch * stride + e];
    }
  }
}

// Pass B: block b scans residues r0 .. r0 + kScanResidues - 1 (mod 2^L)
// of tile b / groups, staged as rows p (elements p 2^L + r0 .. + R - 1),
// with the steps of shift 2^L, 2^(L+1), ... < tile length, then finishes
// its elements.
__global__ void __launch_bounds__(kScanThreads)
    scan_pass_b(ScanArgs a, int rows) {
  extern __shared__ float sm[];  // [5][rows * kScanResidues]
  constexpr int kGroups = kScanSpan / kScanResidues;
  const long long tile = blockIdx.x / kGroups;
  const int r0 = (blockIdx.x % kGroups) * kScanResidues;
  const int stride = rows * kScanResidues;
  const long long t0 = tile * a.tile_len;
  auto local = [&](int e) {
    return (e / kScanResidues) * kScanSpan + r0 + e % kScanResidues;
  };
  for (int e = threadIdx.x; e < stride; e += kScanThreads)
    if (local(e) < a.tile_len)
#pragma unroll
      for (int ch = 0; ch < 5; ++ch)
        sm[ch * stride + e] = a.scratch[ch * a.total + t0 + local(e)];
  __syncthreads();
  for (int s = 1; (long long)s * kScanSpan < a.tile_len; s *= 2)
    scan_step<kScanPerB>(sm, stride, stride, s * kScanResidues, [&](int e) {
      return e / kScanResidues >= s && local(e) < a.tile_len;
    });
  for (int e = threadIdx.x; e < stride; e += kScanThreads)
    if (local(e) < a.tile_len) {
      const float v[4] = {sm[stride + e], sm[2 * stride + e],
                          sm[3 * stride + e], sm[4 * stride + e]};
      scan_finish(a, t0 + local(e), tile, v, sm[e]);
    }
}

// Pass C: tile t >= 1 adds the post-carry last element of tile t-1 to its
// elements before its first segment start, as the reference chains it;
// each such thread replays the (short) chain of carries up to its tile.
// Finished elements (the output) are only read here, pending ones (the
// scratch) only read, so the pass needs no ordering between threads.
__global__ void scan_pass_c(ScanArgs a) {
  const long long i =
      a.tile_len + blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= a.total || a.scratch[i] > 0.5f) return;
  const long long t = i / a.tile_len;
  float carry[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (long long tt = 0; tt < t; ++tt) {
    const long long last = (tt + 1) * a.tile_len - 1;
    const bool done = tt == 0 || a.scratch[last] > 0.5f;
#pragma unroll
    for (int ch = 0; ch < 4; ++ch)
      carry[ch] = done ? a.out[ch * a.total + last]
                       : __fadd_rn(a.scratch[(ch + 1) * a.total + last],
                                   carry[ch]);
  }
#pragma unroll
  for (int ch = 0; ch < 4; ++ch)
    a.out[ch * a.total + i] =
        __fadd_rn(a.scratch[(ch + 1) * a.total + i], carry[ch]);
}

// Dynamic shared memory above the 48 KB default, once per size.
template <class F>
cudaError_t allow_smem(F* fn, int bytes, int& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

}  // namespace

// in5: five channel pointers (first, x, y, z, count), each `total` floats,
// total = tiles * tile_len. scratch: 5 * total floats. out: 4 * total.
// Three launches at most: pass A, pass B (tiles longer than 2^L), pass C
// (more than one tile).
extern "C" int pc_segscan5(const float* first, const float* x, const float* y,
                           const float* z, const float* c, float* scratch,
                           float* out, long long total, int tile_len,
                           void* stream) {
  static int allowed_a = 48 * 1024, allowed_b = 48 * 1024;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ScanArgs a = {{first, x, y, z, c}, scratch, out, total, tile_len};
  const long long tiles = total / tile_len;
  const bool later = tile_len > kScanSpan;  // steps left for pass B
  const int chunks = (tile_len + kScanChunk - 1) / kScanChunk;
  const int stride_a = min(tile_len, kScanChunk + kScanSpan - 1);
  const int smem_a = 5 * stride_a * (int)sizeof(float);
  cudaError_t err = allow_smem(scan_pass_a, smem_a, allowed_a);
  if (err != cudaSuccess) return (int)err;
  scan_pass_a<<<(unsigned)(tiles * chunks), kScanThreads, smem_a, s>>>(
      a, chunks, stride_a, !later);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (later) {
    const int rows = (tile_len + kScanSpan - 1) / kScanSpan;
    const int smem_b = 5 * rows * kScanResidues * (int)sizeof(float);
    err = allow_smem(scan_pass_b, smem_b, allowed_b);
    if (err != cudaSuccess) return (int)err;
    scan_pass_b<<<(unsigned)(tiles * (kScanSpan / kScanResidues)),
                  kScanThreads, smem_b, s>>>(a, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (tiles > 1) {
    const int threads = 256;
    scan_pass_c<<<(unsigned)((total - tile_len + threads - 1) / threads),
                  threads, 0, s>>>(a);
    err = cudaGetLastError();
  }
  return (int)err;
}

