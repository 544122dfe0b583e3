// One min-label hop of the cluster hop loop over the nine sorted windows.
//
// Replaces pointclouds_tpu/spatial/pallas_kernels.py cluster_propagate
// (kernel body _cluster_propagate_kernel): the hop that
// sweep.sweep_cluster_labels iterates, with a scatter-min hook, two pointer
// jumps and a frontier of active blocks in torch, for clouds above the
// reference's residency gate (CLUSTER_RESIDENT_BYTES: more than 2^20 rows).
//
// A block without a valid query or not active (no window row changed in
// the last iteration) passes its labels through with changed = 0.
// Otherwise each valid query takes the smallest label among its own and
// those of the valid candidates of rows [start, start + length) of its
// nine windows with d2 <= r2 (inclusive; d2 pinned as the reference
// computes it on the CPU). Labels are int32, the reference's exact-integer
// f32 labels; an invalid query of a running block gets 2^25, as there. The
// hop reads the labels and writes a separate output (a Jacobi step, as the
// reference).
//
// Bound on Hopper: the d2 + compare of every query of the running blocks
// against its windows' rows (operations). Design: the min-label walk of
// minlabel.cuh (cp.async ring of rows and labels, Q queries a lane, exact
// row prune by label), a CTA of kPropWarps warps a block, each warp holding
// all 128 queries (kPropQ = 4 a lane) and a slice of the rows.
#include "minlabel.cuh"

namespace {

constexpr int kHopCols = kStartsCols + 1;  // the window pack + ACTIVE
constexpr int kBigLab = 1 << 25;

template <int W, int Q>
__global__ void __launch_bounds__(W * 32, 3)
    cluster_propagate_kernel(const float* __restrict__ pts,
                             const int* __restrict__ labels,
                             const int* __restrict__ starts,
                             int* __restrict__ out, int nb, float r2) {
  extern __shared__ __align__(16) float sh[];  // kMlSmem bytes
  const int b = blockIdx.x;
  const long long q0 = (long long)b * kLanes;
  const long long nq = (long long)nb * kLanes;
  const int* ss = starts + (long long)b * kHopCols;
  if (ss[3 * kShifts] == 0 || ss[3 * kShifts + 1] == 0) {  // block-uniform
    for (int j = threadIdx.x; j < kLanes; j += W * 32) {
      out[q0 + j] = labels[q0 + j];
      out[nq + q0 + j] = 0;
    }
    return;
  }
  int* tail = ml_tail(sh);
  const float* q = pts + (long long)b * kRowFloats;
  if (threadIdx.x == 0)
    WindowRows::fill<false>(ss, tail + kMlPreInt, tail + kMlBaseInt);
  const int* start = start_labels(sh, q, labels + q0);
  __syncthreads();
  const WindowRows rows{tail + kMlPreInt, tail + kMlBaseInt};
  int visits;
  const int* m = minlabel_hop<W, Q>(pts, labels, q, start, rows,
                                    rows.pre[kShifts], r2, sh, visits);
  for (int j = threadIdx.x; j < kLanes; j += W * 32) {
    const bool valid = start[j] != INT_MIN;
    out[q0 + j] = valid ? m[j] : kBigLab;
    out[nq + q0 + j] = valid && m[j] < start[j];
  }
}

// Measured on the H100 at the 1.2M-point cloud's first hop (PERF.md): 4
// queries a lane beat 2 (0.588 against 0.611 ms), 8 warps and 4 tie.
constexpr int kPropWarps = 8;
constexpr int kPropQ = 4;

}  // namespace

// pts [nr, 4, 128] and labels [nr * 128], both 16-byte aligned; starts
// [nb, 29]; out [2, nb * 128] (labels, changed).
extern "C" int pc_cluster_propagate(const float* pts, const int* labels,
                                    const int* starts, int* out, int nb,
                                    float r2, void* stream) {
  if (nb == 0) return 0;
  auto kernel = cluster_propagate_kernel<kPropWarps, kPropQ>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMlSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nb, kPropWarps * 32, kMlSmem, static_cast<cudaStream_t>(stream)>>>(
      pts, labels, starts, out, nb, r2);
  return (int)cudaGetLastError();
}
