// Euclidean-cluster labels by min-label propagation over per-block row lists
// or over the nine sorted windows.
//
// Replaces, in pointclouds_tpu/spatial/pallas_kernels.py:
//   * cluster_multisweep (kernel body _cluster_multisweep_kernel): rounds
//     over each block's flat candidate row list (`cluster_hop`);
//   * cluster_multisweep_windows (body _cluster_multisweep_windows_kernel):
//     the same rounds over the block's nine deduplicated windows
//     [start + skip, start + length), with no row cap (`window_round`, the
//     dense aerial backend), resumable from given labels (the caller
//     starts the label array from them).
// The TPU kernels run serpentine Gauss-Seidel sweeps over the blocks in grid
// order, with a frontier skip and an MXU intra-row closure. Blocks run in
// parallel and in no order on this card, so the port computes the same
// FIXPOINT another way: one round
// is a hop (each valid query takes the minimum label among its block's
// candidates within r2, lowering its own label AND its old label's root by
// atomicMin -- Shiloach-Vishkin hooking) and pointer jumps (a label takes
// its label's label). Labels only ever decrease and always name a member of
// the same component, so a round that changes nothing proves every valid
// row holds the smallest sorted position of its component.
//
// Bound on Hopper: per-pair d2 work of the hop (cap*128 candidates per
// query with a row list; up to 9 * wr * 128 = 13,824 with the aerial
// windows, wr 12), each staged row reused by the block's 128 queries. The
// aerial obstacle cloud percolates (long chains of r = 2.0 links); hooking
// at the roots and the jumps merge whole label trees per round instead of
// moving a label one link. The jumps are tiny gathers. Concurrent label
// reads may see older or newer values; either is a valid upper bound, which
// is all the fixpoint argument needs.
//
// The row-list rounds (`cluster_hop`, `pc_cluster_round`: a hop, then two
// jump passes) reset a change counter that the host reads after each
// round. The window rounds are one launch each (`window_round`): the
// block's own labels jump up to kWinJumps steps toward their roots (the
// last round's jumps), then the frontier test, then the hop on the
// min-label walk of minlabel.cuh; their state stays on the device:
//   * counts[k] counts the label writes of round k (1-based) that lowered a
//     label; counts[0] the query-rows the hops walked (pairs / 128). Round
//     k > 1 returns at once when counts[k - 1] is 0: the rounds after the
//     first that changed nothing write nothing, so the host launches them
//     in batches and reads `counts` once a batch.
//   * The frontier: stamp[row] is the last round that lowered a label of
//     that row (0: none), written by every write that lowers one -- a
//     query's own label by its hop or its jump, and the hook into its old
//     root's row (another row: that row is stamped, not the writer's).
//     Round k > 1 skips a block unless its jump lowered a label or its own
//     row or a window row has a stamp >= k - 1. Exact: stamps only grow,
//     and every write of round k - 1 is visible in round k, so a block
//     skips only when no label it reads (its rows' labels; its queries' and
//     candidates' coordinates never change) changed since its last hop,
//     which then changed nothing (that would have stamped its own row); the
//     same inputs give the same minima, so its hop would change nothing
//     now. A stamp read as k (written by this round) only adds work. One
//     stamp array with ">= k - 1" replaces a pair of double-buffered flags,
//     which would need a clear between rounds.
//   * last[q] is the last round that lowered query q's label: the call's
//     changed flags are last == rounds run (all zero at a fixpoint).
#include "minlabel.cuh"

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


// ── The window rounds (kernel 8) ──

namespace {

using Count = unsigned long long;

// Round k stamps the row and the query whose label one of its writes
// lowered.
__device__ __forceinline__ void lowered(long long i, int* stamp, int* last,
                                        int k) {
  stamp[i / kLanes] = k;
  last[i] = k;
}

// Lane 0 of each warp adds the warp's `n` to `*count`.
__device__ __forceinline__ void count_warp(int n, Count* count) {
  n = __reduce_add_sync(kFullMask, n);
  if ((threadIdx.x & 31) == 0 && n > 0) atomicAdd(count, (Count)n);
}

// Whether the round before round k changed nothing (block-uniform).
__device__ __forceinline__ bool converged(const Count* counts, int k) {
  return k > 1 && __ldcg(counts + k - 1) == 0;
}

// The state of a call: labels [nlab] from labels0 [nq] (or own positions
// where null) and own positions past nq; stamp [nr], last [nq] and counts
// [ncounts] zero.
__global__ void window_init(const int* __restrict__ labels0, int* labels,
                            int* stamp, int* last, Count* counts,
                            long long nlab, long long nq, int nr,
                            int ncounts) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < nlab) labels[i] = labels0 != nullptr && i < nq ? labels0[i] : (int)i;
  if (i < nr) stamp[i] = 0;
  if (i < nq) last[i] = 0;
  if (i < ncounts) counts[i] = 0;
}

// Round k over the windows of the starts pack [nb, 28]: a CTA of W warps a
// block, Q queries a lane. First the block's own labels jump up to J steps
// toward their roots (the pointer jumps of the round before, done here so
// that a round is one launch), then the frontier test, then the hop and
// its hooks. pts [nr, 4, 128] and labels [nr * 128] 16-byte aligned.
template <int W, int Q, int J>
__global__ void __launch_bounds__(W * 32, 3)
    window_round(const float* __restrict__ pts,
                 const int* __restrict__ starts, int* labels, int* stamp,
                 int* last, Count* counts, float r2, int k) {
  extern __shared__ __align__(16) float sh[];  // kMlSmem bytes
  if (converged(counts, k)) return;
  const int b = blockIdx.x;
  const int* ss = starts + (long long)b * kStartsCols;
  if (ss[3 * kShifts] == 0) return;  // no valid query
  const long long q0 = (long long)b * kLanes;
  int n = 0;  // this thread's writes that lowered a label
  if (threadIdx.x < kLanes) {
    const long long i = q0 + threadIdx.x;
    const int l0 = __ldcg(labels + i);
    int l = l0;
    for (int step = 0; step < J; ++step) {
      const int ll = __ldcg(labels + l);
      if (ll >= l) break;
      l = ll;
    }
    if (l < l0 && l < atomicMin(labels + i, l)) {
      lowered(i, stamp, last, k);
      n = 1;
    }
  }
  int* tail = ml_tail(sh);
  const float* q = pts + (long long)b * kRowFloats;
  if (threadIdx.x == 0)
    WindowRows::fill<true>(ss, tail + kMlPreInt, tail + kMlBaseInt);
  __syncthreads();
  const WindowRows rows{tail + kMlPreInt, tail + kMlBaseInt};
  const int nrows = rows.pre[kShifts];
  if (k > 1) {  // the frontier
    bool hot = n > 0 || (threadIdx.x == 0 && __ldcg(stamp + b) >= k - 1);
    for (int t = threadIdx.x; t < nrows; t += W * 32)
      hot |= __ldcg(stamp + rows(t)) >= k - 1;
    if (!__syncthreads_or(hot)) return;  // no thread lowered a label
  }
  const int* start = start_labels(sh, q, labels + q0);
  __syncthreads();
  int visits;
  const int* m =
      minlabel_hop<W, Q>(pts, labels, q, start, rows, nrows, r2, sh, visits);
  for (int j = threadIdx.x; j < kLanes; j += W * 32) {
    const int lab = start[j];  // INT_MIN where the query is invalid
    if (m[j] < lab) {
      if (m[j] < atomicMin(labels + q0 + j, m[j])) {
        lowered(q0 + j, stamp, last, k);
        ++n;
      }
      if (m[j] < atomicMin(labels + lab, m[j])) {  // hook the old root
        lowered(lab, stamp, last, k);
        ++n;
      }
    }
  }
  count_warp(n, counts + k);
  count_warp(visits * Q, counts);  // visits is the same on every lane
}

// Measured on the H100 at the aerial bench frame (PERF.md): 2 queries a
// lane (two row prunes a block, 64 queries each) walked ~9% fewer pairs
// than 4 and ran ~3% faster; 8 warps and 4 tie; 4 jump steps a round take
// 6 rounds and 0.32 ms of device time, 2 take 7 and 0.37-0.38, 16 take 6
// and 0.31-0.32.
constexpr int kWinWarps = 8;
constexpr int kWinQ = 2;
constexpr int kWinJumps = 4;

}  // namespace

// Rounds first .. first + count - 1 (1-based) over the windows of the
// starts pack [nb, 28], one launch each, no host synchronisation; with
// first == 1 the state is set up first (window_init). labels [nr * 128]
// (the queries' first, from labels0 [nb * 128] unless null), stamp [nr],
// last [nb * 128] and counts [ncounts] as above.
extern "C" int pc_cluster_rounds_windows(const float* pts, const int* starts,
                                         const int* labels0, int* labels,
                                         int* stamp, int* last, Count* counts,
                                         int nb, int nr, int ncounts, float r2,
                                         int first, int count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (first == 1) {
    const long long nlab = (long long)nr * kLanes;
    const long long n = nlab > ncounts ? nlab : ncounts;
    window_init<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        labels0, labels, stamp, last, counts, nlab, (long long)nb * kLanes,
        nr, ncounts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (nb == 0) return 0;
  auto round = window_round<kWinWarps, kWinQ, kWinJumps>;
  err = cudaFuncSetAttribute(
      round, cudaFuncAttributeMaxDynamicSharedMemorySize, kMlSmem);
  if (err != cudaSuccess) return (int)err;
  for (int k = first; k < first + count; ++k) {
    round<<<nb, kWinWarps * 32, kMlSmem, s>>>(
        pts, starts, labels, stamp, last, counts, r2, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
