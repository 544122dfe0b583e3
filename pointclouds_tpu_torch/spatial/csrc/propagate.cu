// One min-label hop of the cluster hop loop over the nine sorted windows.
//
// Replaces pointclouds_tpu/spatial/pallas_kernels.py cluster_propagate
// (kernel body _cluster_propagate_kernel): the hop that
// sweep.sweep_cluster_labels iterates, with a scatter-min hook, two pointer
// jumps and a frontier of active blocks in torch, for clouds above the
// reference's residency gate (CLUSTER_RESIDENT_BYTES: more than 2^20 rows).
//
// One block of 128 threads per 128-query block, a thread per query. A block
// without a valid query or not active (no window row changed in the last
// iteration) passes its labels through with changed = 0. Otherwise each
// window row [start, start + length) is staged in shared memory with its 128
// labels, and each valid query takes the smallest label among its own and
// those of the valid candidates with d2 <= r2 (inclusive; d2 pinned as the
// reference computes it on the CPU). Labels are int32, the reference's
// exact-integer f32 labels; an invalid query of a running block gets 2^25,
// as there. The hop reads the labels and writes a separate output (a Jacobi
// step, as the reference). Bound: the d2 + compare of every query of the
// active blocks against its windows' rows (operations); the frontier skips
// the blocks whose result cannot change.
#include "topk.cuh"

namespace {

constexpr int kHopCols = kStartsCols + 1;  // the window pack + ACTIVE
constexpr int kBigLab = 1 << 25;

__global__ void cluster_propagate_kernel(const float* __restrict__ pts,
                                         const int* __restrict__ labels,
                                         const int* __restrict__ starts,
                                         int* __restrict__ out, int nb,
                                         float r2) {
  __shared__ float sh[kRowFloats];
  __shared__ int shl[kLanes];
  const int b = blockIdx.x;
  const int l = threadIdx.x;
  const long long qi = (long long)b * kLanes + l;
  const long long nq = (long long)nb * kLanes;
  const int* ss = starts + (long long)b * kHopCols;
  const int lab = labels[qi];
  if (ss[3 * kShifts] == 0 || ss[3 * kShifts + 1] == 0) {  // block-uniform
    out[qi] = lab;
    out[nq + qi] = 0;
    return;
  }
  const float* q = pts + (long long)b * kRowFloats;
  const float qx = q[l], qy = q[kLanes + l], qz = q[2 * kLanes + l];
  const bool qv = q[3 * kLanes + l] > 0.5f;
  int best = qv ? lab : kBigLab;
  for (int j = 0; j < kShifts; ++j) {
    const int st = ss[j], ln = ss[2 * kShifts + j];
    for (int r = 0; r < ln; ++r) {
      const long long row = st + r;
      const float* src = pts + row * kRowFloats;
      __syncthreads();  // previous row fully consumed
      sh[l] = src[l];
      sh[kLanes + l] = src[kLanes + l];
      sh[2 * kLanes + l] = src[2 * kLanes + l];
      sh[3 * kLanes + l] = src[3 * kLanes + l];
      shl[l] = labels[row * kLanes + l];
      __syncthreads();
      if (qv) {
        for (int c = 0; c < kLanes; ++c) {
          if (sh[3 * kLanes + c] > 0.5f &&
              d2_rn(qx, qy, qz, sh[c], sh[kLanes + c], sh[2 * kLanes + c]) <=
                  r2)
            best = min(best, shl[c]);
        }
      }
    }
  }
  out[qi] = best;
  out[nq + qi] = (qv && best < lab) ? 1 : 0;
}

}  // namespace

// pts [nr, 4, 128]; labels [nr * 128]; starts [nb, 29]; out [2, nb * 128]
// (labels, changed).
extern "C" int pc_cluster_propagate(const float* pts, const int* labels,
                                    const int* starts, int* out, int nb,
                                    float r2, void* stream) {
  if (nb == 0) return 0;
  cluster_propagate_kernel<<<nb, kLanes, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      pts, labels, starts, out, nb, r2);
  return (int)cudaGetLastError();
}
