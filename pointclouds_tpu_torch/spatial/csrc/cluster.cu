// Euclidean-cluster labels by min-label propagation over per-block row lists
// or over the nine sorted windows.
//
// Replaces, in pointclouds_tpu/spatial/pallas_kernels.py:
//   * cluster_multisweep (kernel body _cluster_multisweep_kernel): rounds
//     over each block's flat candidate row list (at most `cap` rows; the
//     list rounds);
//   * cluster_multisweep_windows (body _cluster_multisweep_windows_kernel):
//     the same rounds over the block's nine deduplicated windows
//     [start + skip, start + length), with no row cap (the window rounds,
//     the dense aerial backend), resumable from given labels (the caller
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
// Bound on Hopper: per-pair d2 work of the hop (up to cap*128 candidates per
// query with a row list; up to 9 * wr * 128 = 13,824 with the aerial
// windows, wr 12), each staged row reused by the block's 128 queries. The
// aerial obstacle cloud percolates (long chains of r = 2.0 links); hooking
// at the roots and the jumps merge whole label trees per round instead of
// moving a label one link. Concurrent label reads may see older or newer
// values; either is a valid upper bound, which is all the fixpoint argument
// needs.
//
// Both kinds of round are one launch each (`label_round`, on a row source:
// the row list or the windows): the block's own labels jump up to J steps
// toward their roots (the last round's jumps), then the frontier test, then
// the hop on the min-label walk of minlabel.cuh; their state stays on the
// device:
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
//     row or a listed row has a stamp >= k - 1. Exact: stamps only grow,
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
__global__ void rounds_init(const int* __restrict__ labels0, int* labels,
                            int* stamp, int* last, Count* counts,
                            long long nlab, long long nq, int nr,
                            int ncounts) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < nlab) labels[i] = labels0 != nullptr && i < nq ? labels0[i] : (int)i;
  if (i < nr) stamp[i] = 0;
  if (i < nq) last[i] = 0;
  if (i < ncounts) counts[i] = 0;
}

// A round's row sources. Each gives, for block b: whether it has a valid
// query (`live`, block-uniform); `prepare`, called by one thread before a
// barrier, which may write past the ring's tail; then its rows (a RowAt of
// minlabel.cuh) and their count.

// The block's nine windows of the starts pack [nb, 28] (kernel 8): their
// prefix sums and bases past the ring (WindowRows).
struct WindowSource {
  const int* starts;

  __device__ const int* pack(int b) const {
    return starts + (long long)b * kStartsCols;
  }
  __device__ bool live(int b) const { return pack(b)[3 * kShifts] != 0; }
  __device__ void prepare(int b, int* tail) const {
    WindowRows::fill<true>(pack(b), tail + kMlPreInt, tail + kMlBaseInt);
  }
  __device__ WindowRows rows(int, int* tail) const {
    return WindowRows{tail + kMlPreInt, tail + kMlBaseInt};
  }
  __device__ int count(int, const int* tail) const {
    return tail[kMlPreInt + kShifts];
  }
};

// Rows rl[t] of a block's row list rl [cap + 2] (ids, the block-valid flag,
// the row count; kernel 4): only the first min(count, cap) are read.
struct ListRows {
  const int* rl;
  __device__ long long operator()(int t) const { return __ldg(rl + t); }
};

struct ListSource {
  const int* rowlist;  // [nb, cap + 2]
  int cap;

  __device__ const int* list(int b) const {
    return rowlist + (long long)b * (cap + 2);
  }
  __device__ bool live(int b) const { return list(b)[cap] != 0; }
  __device__ void prepare(int, int*) const {}
  __device__ ListRows rows(int b, int*) const { return ListRows{list(b)}; }
  __device__ int count(int b, const int*) const {
    return min(list(b)[cap + 1], cap);
  }
};

// Round k over the blocks of `src`: P CTAs of W warps a block, Q queries a
// lane; CTA p of block b walks the p-th of P near-equal shares of the
// block's rows and hooks from its partial minima (a minimum merges exactly
// under any split: the labels end the same). First the block's own labels
// jump up to J steps toward their roots (the pointer jumps of the round
// before, done here so that a round is one launch; CTA 0 of the block),
// then the frontier test, then the hop and its hooks. pts [nr, 4, 128] and
// labels [nr * 128] 16-byte aligned.
template <int W, int Q, int J, int P, class Source>
__global__ void __launch_bounds__(W * 32, 3)
    label_round(const float* __restrict__ pts, Source src, int* labels,
                int* stamp, int* last, Count* counts, float r2, int k) {
  extern __shared__ __align__(16) float sh[];  // kMlSmem bytes
  if (converged(counts, k)) return;
  const int b = blockIdx.x / P, part = blockIdx.x % P;
  if (!src.live(b)) return;  // no valid query
  const long long q0 = (long long)b * kLanes;
  int n = 0;  // this thread's writes that lowered a label
  if (part == 0 && threadIdx.x < kLanes) {
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
  if (threadIdx.x == 0) src.prepare(b, tail);
  __syncthreads();
  auto rows = src.rows(b, tail);
  const int nrows = src.count(b, tail);
  if (k > 1) {  // the frontier
    bool hot = n > 0 || (threadIdx.x == 0 && __ldcg(stamp + b) >= k - 1);
    for (int t = threadIdx.x; t < nrows; t += W * 32)
      hot |= __ldcg(stamp + rows(t)) >= k - 1;
    if (!__syncthreads_or(hot)) return;  // no thread lowered a label
  }
  const int lo = nrows * part / P, hi = nrows * (part + 1) / P;
  const int* start = start_labels(sh, q, labels + q0);
  __syncthreads();
  int visits;
  const int* m = minlabel_hop<W, Q>(pts, labels, q, start,
                                    RowsFrom<decltype(rows)>{rows, lo},
                                    hi - lo, r2, sh, visits);
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

// Rounds first .. first + count - 1 of `src` over nb blocks, one launch
// each, no host synchronisation; with first == 1 the state is set up first
// (rounds_init).
template <int W, int Q, int J, int P, class Source>
int launch_rounds(const float* pts, Source src, const int* labels0,
                  int* labels, int* stamp, int* last, Count* counts, int nb,
                  int nr, int ncounts, float r2, int first, int count,
                  cudaStream_t s) {
  cudaError_t err;
  if (first == 1) {
    const long long nlab = (long long)nr * kLanes;
    const long long n = nlab > ncounts ? nlab : ncounts;
    rounds_init<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        labels0, labels, stamp, last, counts, nlab, (long long)nb * kLanes,
        nr, ncounts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (nb == 0) return 0;
  auto round = label_round<W, Q, J, P, Source>;
  err = cudaFuncSetAttribute(
      round, cudaFuncAttributeMaxDynamicSharedMemorySize, kMlSmem);
  if (err != cudaSuccess) return (int)err;
  for (int k = first; k < first + count; ++k) {
    round<<<nb * P, W * 32, kMlSmem, s>>>(pts, src, labels, stamp, last,
                                          counts, r2, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The window rounds, measured on the H100 at the aerial bench frame
// (PERF.md): 2 queries a lane (two row prunes a block, 64 queries each)
// walked ~9% fewer pairs than 4 and ran ~3% faster; 8 warps and 4 tie; 4
// jump steps a round take 6 rounds and 0.32 ms of device time, 2 take 7 and
// 0.37-0.38, 16 take 6 and 0.31-0.32.
constexpr int kWinWarps = 8;
constexpr int kWinQ = 2;
constexpr int kWinJumps = 4;

// The list rounds, measured on the H100 at the KITTI bench frame's and the
// slab `euclidean_cluster` op's inputs (PERF.md): kernel 8's constants;
// batches of 4 rounds beat 2 (KITTI takes 4 rounds: one host read, not
// two). A block's list split over 2 CTAs took 28% less device time at the
// KITTI frame (64 blocks: a CTA a block leaves half the SMs idle) and 12%
// more at the slab (782 blocks, several waves: the split only repeats
// each block's jumps, frontier and start labels), so a call splits when
// its CTAs still fit on the card at once (`list_split`).
constexpr int kListWarps = 8;
constexpr int kListQ = 2;
constexpr int kListJumps = 4;

// CTAs a block for nb blocks: 2 while 2 * nb CTAs are resident at once on
// the current device, else 1. Sets the 2-CTA round's shared memory limit.
int list_split(int nb, int& split) {
  auto round = label_round<kListWarps, kListQ, kListJumps, 2, ListSource>;
  int dev = 0, sms = 0, per = 0;
  cudaError_t err = cudaFuncSetAttribute(
      round, cudaFuncAttributeMaxDynamicSharedMemorySize, kMlSmem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, round, kListWarps * 32, kMlSmem);
  split = 2 * (long long)nb <= (long long)sms * per ? 2 : 1;
  return (int)err;
}

}  // namespace

// Rounds first .. first + count - 1 (1-based) over the windows of the
// starts pack [nb, 28]; with first == 1 the state is set up first. labels
// [nr * 128] (the queries' first, from labels0 [nb * 128] unless null),
// stamp [nr], last [nb * 128] and counts [ncounts] as above.
extern "C" int pc_cluster_rounds_windows(const float* pts, const int* starts,
                                         const int* labels0, int* labels,
                                         int* stamp, int* last, Count* counts,
                                         int nb, int nr, int ncounts, float r2,
                                         int first, int count, void* stream) {
  return launch_rounds<kWinWarps, kWinQ, kWinJumps, 1>(
      pts, WindowSource{starts}, labels0, labels, stamp, last, counts, nb, nr,
      ncounts, r2, first, count, static_cast<cudaStream_t>(stream));
}

// The same rounds over the row lists [nb, cap + 2], from own positions.
extern "C" int pc_cluster_rounds_lists(const float* pts, const int* rowlist,
                                       int* labels, int* stamp, int* last,
                                       Count* counts, int nb, int nr, int cap,
                                       int ncounts, float r2, int first,
                                       int count, void* stream) {
  int split;
  const int err = list_split(nb, split);
  if (err != 0) return err;
  const ListSource src{rowlist, cap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split == 2)
    return launch_rounds<kListWarps, kListQ, kListJumps, 2>(
        pts, src, nullptr, labels, stamp, last, counts, nb, nr, ncounts, r2,
        first, count, s);
  return launch_rounds<kListWarps, kListQ, kListJumps, 1>(
      pts, src, nullptr, labels, stamp, last, counts, nb, nr, ncounts, r2,
      first, count, s);
}
