// RANSAC inlier counts: for each plane hypothesis (n, d, threshold), the
// number of valid points with |n.p + d| <= threshold over the whole cloud.
//
// Replaces pointclouds_tpu/spatial/pallas_kernels.py::ransac_score_counts
// (kernel body _ransac_score_kernel). The TPU kernel walks the planar cloud
// one 128-point row per grid step and carries a [128, NH] f32 hit tile in
// VMEM across the sequential grid. Blocks here run in parallel and in no
// order, so the grid is 2-D: (hypothesis tile of 128) x (chunk of rows).
// Each thread owns one hypothesis, walks its block's rows from shared
// memory, counts hits in a register and adds them to the hypothesis' count
// with one integer atomicAdd per block: integer sums are exact and do not
// depend on the order the blocks finish in. A last pass writes the counts
// as f32, as the TPU kernel returns them.
//
// The distance form is pinned: |fma(z, nz, fma(x, nx, y*ny)) + d|, the
// contraction XLA's CPU backend compiles the TPU kernel's
// `qx*nx + qy*ny + qz*nz + dd` to in interpret mode, so points lying on the
// threshold fall on the same side as in the JAX reference and in the plain
// torch version (which emulates the same fmas exactly).
//
// Bound on Hopper: the per-pair work (two fmas, a multiply, an add and a
// compare), not memory: each staged row is reused by the block's 128
// hypotheses. At 500 iterations over ~229K rows that is 4 x 224 blocks,
// enough to fill the card.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

// hyp: [5, nh] (nx, ny, nz, d, threshold; pad slots carry threshold -1);
// pts: [nr, 4, 128] (w = validity). counts: int [nh], zeroed.
__global__ void ransac_score_kernel(const float* __restrict__ hyp,
                                    const float* __restrict__ pts,
                                    int* __restrict__ counts, int nh,
                                    int nr) {
  __shared__ float sh[kRowFloats];
  const int l = threadIdx.x;
  const int h = blockIdx.x * kLanes + l;
  const float nx = hyp[h], ny = hyp[nh + h], nz = hyp[2 * nh + h];
  const float dd = hyp[3 * nh + h], th = hyp[4 * nh + h];
  const int r0 = blockIdx.y * kRowsPerBlock;
  const int r1 = min(r0 + kRowsPerBlock, nr);
  int cnt = 0;
  for (int r = r0; r < r1; ++r) {
    __syncthreads();
    const float* src = pts + (long long)r * kRowFloats;
    sh[l] = src[l];
    sh[kLanes + l] = src[kLanes + l];
    sh[2 * kLanes + l] = src[2 * kLanes + l];
    sh[3 * kLanes + l] = src[3 * kLanes + l];
    __syncthreads();
    for (int j = 0; j < kLanes; ++j) {
      float s = __fmaf_rn(sh[2 * kLanes + j], nz,
                          __fmaf_rn(sh[j], nx, __fmul_rn(sh[kLanes + j], ny)));
      float dist = fabsf(__fadd_rn(s, dd));
      cnt += (sh[3 * kLanes + j] > 0.5f && dist <= th) ? 1 : 0;
    }
  }
  if (cnt) atomicAdd(counts + h, cnt);
}

}  // namespace

// nh a multiple of 128. counts: int scratch of nh; out: f32 [nh].
extern "C" int pc_ransac_score_counts(const float* hyp, const float* pts,
                                      int* counts, float* out, int nh, int nr,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * nh, s);
  if (err != cudaSuccess) return (int)err;
  if (nh == 0) return 0;
  if (nr > 0) {
    dim3 grid(nh / kLanes, (nr + kRowsPerBlock - 1) / kRowsPerBlock);
    ransac_score_kernel<<<grid, kLanes, 0, s>>>(hyp, pts, counts, nh, nr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  counts_to_f32<<<(nh + 255) / 256, 256, 0, s>>>(counts, out, nh);
  return (int)cudaGetLastError();
}
