// Euclidean-cluster labels by min-label propagation over per-block row lists
// or over the nine sorted windows.
//
// Replaces, in pointclouds_tpu/spatial/pallas_kernels.py:
//   * cluster_multisweep (kernel body _cluster_multisweep_kernel): rounds
//     over each block's flat candidate row list (`cluster_hop`);
//   * cluster_multisweep_windows (body _cluster_multisweep_windows_kernel):
//     the same rounds over the block's nine deduplicated windows
//     [start + skip, start + length), with no row cap (`cluster_hop_windows`,
//     the dense aerial backend), resumable from given labels (the caller
//     starts the label array from them).
// The TPU kernels run serpentine Gauss-Seidel sweeps over the blocks in grid
// order, with a frontier skip and an MXU intra-row closure. Blocks run in
// parallel and in no order on this card, so the port computes the same
// FIXPOINT another way: one round
// is a hop (each valid query takes the minimum label among its block's
// candidates within r2, lowering its own label AND its old label's root by
// atomicMin -- Shiloach-Vishkin hooking) followed by two pointer-jump
// passes. Labels only ever decrease and always name a member of the same
// component, so a round that changes nothing proves every valid row holds
// the smallest sorted position of its component. The caller repeats rounds
// until one reports no change (a host read of `counter`), up to its cap.
//
// Bound on Hopper: per-pair d2 work of the hop (cap*128 candidates per
// query with a row list; up to 9 * wr * 128 = 13,824 with the aerial
// windows, wr 12), each staged row reused by the block's 128 queries. The
// aerial obstacle cloud percolates (long chains of r = 2.0 links); hooking
// at the roots and the jumps merge whole label trees per round instead of
// moving a label one link. The jumps are tiny gathers. Concurrent label
// reads may see older or newer values; either is a valid upper bound, which
// is all the fixpoint argument needs.
#include "topk.cuh"

namespace {

// pts: [nr + 1, 4, 128], invalid coordinates pre-masked to 1e9, pad row nr
// all-masked. rowlist: [nb, cap + 2]. labels: int32 over all planar rows.
__global__ void cluster_hop(const float* __restrict__ pts,
                            const int* __restrict__ rowlist, int* labels,
                            int* __restrict__ changed, int* counter, int cap,
                            float r2) {
  __shared__ float sh[kRowFloats];
  __shared__ int shl[kLanes];
  const int b = blockIdx.x;
  const int l = threadIdx.x;
  const long long qi = (long long)b * kLanes + l;
  const int* rl = rowlist + (long long)b * (cap + 2);
  const float* q = pts + (long long)b * kRowFloats;
  float qx = q[l], qy = q[kLanes + l], qz = q[2 * kLanes + l];
  bool qv = q[3 * kLanes + l] > 0.5f;
  int lab = __ldcg(labels + qi);
  int best = lab;
  int nrows = rl[cap] != 0 ? min(rl[cap + 1], cap) : 0;
  for (int t = 0; t < nrows; ++t) {
    long long row = rl[t];
    __syncthreads();
    const float* src = pts + row * kRowFloats;
    sh[l] = src[l];
    sh[kLanes + l] = src[kLanes + l];
    sh[2 * kLanes + l] = src[2 * kLanes + l];
    sh[3 * kLanes + l] = src[3 * kLanes + l];
    shl[l] = __ldcg(labels + row * kLanes + l);
    __syncthreads();
    if (qv) {
      for (int j = 0; j < kLanes; ++j) {
        float d2 = d2_rn(qx, qy, qz, sh[j], sh[kLanes + j], sh[2 * kLanes + j]);
        if (sh[3 * kLanes + j] > 0.5f && d2 <= r2) best = min(best, shl[j]);
      }
    }
  }
  int ch = 0;
  if (qv && best < lab) {
    atomicMin(labels + qi, best);
    atomicMin(labels + lab, best);  // hook the old root
    ch = 1;
    atomicAdd(counter, 1);
  }
  changed[qi] = ch;
}

// The hop over the starts pack's windows. starts: [nb, 28].
__global__ void cluster_hop_windows(const float* __restrict__ pts,
                                    const int* __restrict__ starts,
                                    int* labels, int* __restrict__ changed,
                                    int* counter, float r2) {
  __shared__ float sh[kRowFloats];
  __shared__ int shl[kLanes];
  const int b = blockIdx.x;
  const int l = threadIdx.x;
  const long long qi = (long long)b * kLanes + l;
  const int* ss = starts + (long long)b * kStartsCols;
  const float* q = pts + (long long)b * kRowFloats;
  float qx = q[l], qy = q[kLanes + l], qz = q[2 * kLanes + l];
  bool qv = q[3 * kLanes + l] > 0.5f;
  int lab = __ldcg(labels + qi);
  int best = lab;
  if (ss[3 * kShifts] != 0) {
    for (int j = 0; j < kShifts; ++j) {
      const int st = ss[j], ln = ss[2 * kShifts + j];
      for (int r = ss[kShifts + j]; r < ln; ++r) {
        long long row = st + r;
        __syncthreads();
        const float* src = pts + row * kRowFloats;
        sh[l] = src[l];
        sh[kLanes + l] = src[kLanes + l];
        sh[2 * kLanes + l] = src[2 * kLanes + l];
        sh[3 * kLanes + l] = src[3 * kLanes + l];
        shl[l] = __ldcg(labels + row * kLanes + l);
        __syncthreads();
        if (qv) {
          for (int c = 0; c < kLanes; ++c) {
            float d2 =
                d2_rn(qx, qy, qz, sh[c], sh[kLanes + c], sh[2 * kLanes + c]);
            if (sh[3 * kLanes + c] > 0.5f && d2 <= r2) best = min(best, shl[c]);
          }
        }
      }
    }
  }
  int ch = 0;
  if (qv && best < lab) {
    atomicMin(labels + qi, best);
    atomicMin(labels + lab, best);  // hook the old root
    ch = 1;
    atomicAdd(counter, 1);
  }
  changed[qi] = ch;
}

__global__ void cluster_jump(int* labels, int* __restrict__ changed,
                             int* counter, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  int l = __ldcg(labels + i);
  int ll = __ldcg(labels + l);
  if (ll < l) {
    atomicMin(labels + i, ll);
    changed[i] = 1;
    atomicAdd(counter, 1);
  }
}

}  // namespace

// Two pointer-jump passes over the first nb*128 labels.
static int jumps(int* labels, int* changed, int* counter, int nb, cudaStream_t s) {
  cudaError_t err;
  long long n = (long long)nb * kLanes;
  unsigned blocks = (unsigned)((n + 255) / 256);
  for (int j = 0; j < 2; ++j) {
    cluster_jump<<<blocks, 256, 0, s>>>(labels, changed, counter, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// One propagation round: hop + two pointer jumps over the first nb*128
// labels. `counter` (one int) is zeroed here and counts label changes.
extern "C" int pc_cluster_round(const float* pts, const int* rowlist,
                                int* labels, int* changed, int* counter,
                                int nb, int cap, float r2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (nb == 0) return 0;
  cluster_hop<<<nb, kLanes, 0, s>>>(pts, rowlist, labels, changed, counter,
                                    cap, r2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return jumps(labels, changed, counter, nb, s);
}

// The same round over the windows of the starts pack [nb, 28].
extern "C" int pc_cluster_round_windows(const float* pts, const int* starts,
                                        int* labels, int* changed,
                                        int* counter, int nb, float r2,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (nb == 0) return 0;
  cluster_hop_windows<<<nb, kLanes, 0, s>>>(pts, starts, labels, changed,
                                            counter, r2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return jumps(labels, changed, counter, nb, s);
}
