// Exact 1-NN over a whole planar target: the ICP correspondence search.
//
// Replaces pointclouds_tpu/spatial/pallas_kernels.py::nn_argmin (kernel body
// _nn_argmin_kernel). Per query: the smallest d2 over the valid candidates
// (+inf if none) and its flat position row * 128 + lane as f32; among equal
// d2 the LAST position wins (the TPU kernel's per-lane `<=` overwrite and
// max-position tie extraction, the same rule as the JAX package's XLA
// path). With no valid candidate every d2 is +inf, so the last position of
// the target wins, as on the TPU. d2 is pinned to fma(dz, dz, fma(dx, dx,
// dy*dy)) (common.cuh), the form XLA's CPU backend gives the TPU kernel's
// (q - c)**2 sum. A query with w <= 0.5 or a non-finite coordinate gets
// (+inf, -1): the TPU kernel leaves such rows undefined and its callers
// mask them.
//
// Design: ICP's clouds are small (10K points: 80 query blocks), so each
// query block's walk over the target rows is split over `nsplit` CUDA
// blocks (rows s, s + nsplit, ...), each keeping one (d2, position) per
// thread, and a merge kernel takes the smallest d2, ties to the largest
// position, which is the same winner as one ascending walk. Bound on
// Hopper: the per-pair d2 + compare work (each staged target row is reused
// by 128 queries); the target (160 KB at 10K) stays in L2.
#include <math.h>

#include "topk.cuh"

namespace {

__device__ __forceinline__ bool query_ok(const float* q, int l, float& qx,
                                         float& qy, float& qz) {
  qx = q[l];
  qy = q[kLanes + l];
  qz = q[2 * kLanes + l];
  return q[3 * kLanes + l] > 0.5f && isfinite(qx) && isfinite(qy) &&
         isfinite(qz);
}

// q: [qb, 4, 128]; cand: [nr, 4, 128]; part_d / part_p: [nsplit][qb * 128].
__global__ void nn_partial_kernel(const float* __restrict__ qpl,
                                  const float* __restrict__ cand,
                                  float* __restrict__ part_d,
                                  int* __restrict__ part_p, int qb, int nr) {
  __shared__ float sh[kRowFloats];
  const int b = blockIdx.x;
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  const int l = threadIdx.x;
  float qx, qy, qz;
  const bool qv = query_ok(qpl + (long long)b * kRowFloats, l, qx, qy, qz);
  float best = kInf;
  int bpos = -1;
  for (int r = split; r < nr; r += nsplit) {
    stage_row(cand, r, sh);
    if (!qv) continue;
    const int pos0 = r * kLanes;
    for (int j = 0; j < kLanes; ++j) {
      const float w =
          sh[3 * kLanes + j] > 0.5f
              ? d2_rn(qx, qy, qz, sh[j], sh[kLanes + j], sh[2 * kLanes + j])
              : kInf;
      if (w <= best) {  // ascending walk: ties to the later position
        best = w;
        bpos = pos0 + j;
      }
    }
  }
  const long long nq = (long long)qb * kLanes;
  const long long qi = (long long)b * kLanes + l;
  part_d[split * nq + qi] = best;
  part_p[split * nq + qi] = bpos;
}

// One thread per query: the smallest partial d2, ties to the largest
// position; out rows 0 (d2) and 1 (position).
__global__ void nn_merge_kernel(const float* __restrict__ qpl,
                                const float* __restrict__ part_d,
                                const int* __restrict__ part_p,
                                float* __restrict__ out, long long nq,
                                int nsplit) {
  const long long qi = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (qi >= nq) return;
  float qx, qy, qz;
  const bool qv = query_ok(qpl + (qi / kLanes) * kRowFloats,
                           (int)(qi % kLanes), qx, qy, qz);
  float best = kInf;
  int bpos = -1;
  for (int s = 0; s < nsplit; ++s) {
    const float v = part_d[s * nq + qi];
    const int p = part_p[s * nq + qi];
    if (p >= 0 && (v < best || (v == best && p > bpos))) {
      best = v;
      bpos = p;
    }
  }
  out[qi] = qv ? best : kInf;
  out[nq + qi] = qv ? (float)bpos : -1.0f;
}

}  // namespace

// part_d / part_p: scratch of nsplit * qb * 128 each; out: [2, qb * 128].
extern "C" int pc_nn_argmin(const float* q, const float* cand, float* part_d,
                            int* part_p, float* out, int qb, int nr,
                            int nsplit, void* stream) {
  if (qb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nn_partial_kernel<<<dim3(qb, nsplit), kLanes, 0, s>>>(q, cand, part_d,
                                                        part_p, qb, nr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long nq = (long long)qb * kLanes;
  nn_merge_kernel<<<(unsigned)((nq + 127) / 128), 128, 0, s>>>(
      q, part_d, part_p, out, nq, nsplit);
  return (int)cudaGetLastError();
}
