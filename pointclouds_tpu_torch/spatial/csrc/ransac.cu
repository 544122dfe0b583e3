// RANSAC inlier counts: for each plane hypothesis (n, d, threshold), the
// number of valid points with |n.p + d| <= threshold over the whole cloud.
//
// Replaces pointclouds_tpu/spatial/pallas_kernels.py::ransac_score_counts
// (kernel body _ransac_score_kernel). The TPU kernel walks the planar cloud
// one 128-point row per grid step and carries a [128, NH] f32 hit tile in
// VMEM across the sequential grid.
//
// The distance form is pinned: |fma(z, nz, fma(x, nx, y*ny)) + d|, the
// contraction XLA's CPU backend compiles the TPU kernel's
// `qx*nx + qy*ny + qz*nz + dd` to in interpret mode, so points lying on the
// threshold fall on the same side as in the JAX reference and in the plain
// torch version (which emulates the same fmas exactly). Tensor cores stay
// out: a TF32 or wgmma product would move points across the threshold.
//
// Design: one launch of the register-tiled pair walk (countwalk.cuh) with
// hypotheses where the radius counts have queries: a warp holds a tile of
// 128 hypotheses, four a lane, nx, ny, nz in the x, y, z slots and d, the
// threshold and the count in its state (WithinPlane), and the points
// stream through the cp.async ring in 8-row tiles. A pair is the pinned
// distance, the compare and a predicated add: 6 issued instructions; a
// point with w <= 0.5 gets x = NaN once (no compare of it holds), and a
// pad slot has threshold -1 (no distance is below it). As in kernel 14,
// a CTA's W warps all hold the tile and split each staged 8-row tile's
// rows, and C CTAs share a hypothesis tile, CTA s walking its contiguous
// share of the rows (C from the SM count and the rows, walk_split); their
// counts meet in a scratch by integer atomics (exact in any order), and
// the tile's last CTA to arrive writes them out as f32 and leaves the
// scratch zero (count_block): no memset, no conversion kernel. Bound on
// Hopper: operations (each staged row is reused by 128 hypotheses).
#include "countwalk.cuh"

namespace {

// The planes of a hypothesis tile: a point counts iff it is valid (w >
// 0.5) and |fma(z, nz, fma(x, nx, y*ny)) + d| <= the threshold.
struct WithinPlane {
  struct State {
    float d, th;
    int n;
  };
  // d and the threshold, rows 3 and 4 of the column (row stride n).
  __device__ static bool init_column(State& s, const float* c, int n) {
    s.d = c[0];
    s.th = c[n];
    s.n = 0;
    return s.th >= 0.0f;
  }
  __device__ static float mask(float cx, float cw) {
    return cw > 0.5f ? cx : kNaN;  // masked: the distance NaN
  }
  __device__ static float measure(const State& s, float nx, float ny,
                                  float nz, float cx, float cy, float cz) {
    return fabsf(__fadd_rn(
        __fmaf_rn(cz, nz, __fmaf_rn(cx, nx, __fmul_rn(cy, ny))), s.d));
  }
  __device__ static void pair(State& s, float dist, float, int) {
    add_within(s.n, dist, s.th);
  }
};

// hyp: [5, nh] (nx, ny, nz, d, threshold; pad slots carry threshold -1);
// pts: [nr, 4, 128] (w = validity); out: f32 [nh]; counts: int [nh] and
// arrived: [nh / 128], zero at the call and left zero. CTA i = g * C + s
// serves hypothesis tile g.
template <int W>
__global__ void __launch_bounds__(W * 32)
    ransac_kernel(const float* __restrict__ hyp,
                  const float* __restrict__ pts, float* __restrict__ out,
                  int nh, int nr, int C, int* counts, unsigned* arrived) {
  __shared__ __align__(16) float sh[kStages * kTileFloats];
  const int g = blockIdx.x / C;
  QueryTile<WithinPlane> planes;
  const bool live =
      planes.load_columns(hyp, nh, g * kLanes, threadIdx.x & 31);
  count_block<W>(planes, live, pts, EveryRow{}, nr, blockIdx.x % C, C,
                 out + (long long)g * kLanes, counts + (long long)g * kLanes,
                 arrived + g, sh);
}

// Warps per CTA, CTAs a hypothesis tile at most and rows a CTA at least
// (walk_split), measured on the H100 at the KITTI frame's full scoring (512
// slots, 768 rows) and the 10K RANSAC op's (512 slots, 128 rows; PERF.md): at
// KITTI, W 4 at 128 to 512 CTAs and W 2 and 8 came within 11% of each other (W
// 8 at 512 CTAs lost 21%); at 10K, 128 CTAs of 4 rows beat 64 of 8 and 256 of 2
// by 1.4x. The other layout, each warp of a CTA holding its own tile (4 tiles a
// CTA, every staged row serving all 512 hypotheses), lost at both, 3-86% at
// KITTI and 1.5-4x at 10K: each warp then walks every row of its CTA's share; 2
// tiles a CTA of 2 warps each tied at KITTI and lost 1.5x at 10K. A two-tile
// ring came within 3%.
constexpr int kRansacWarps = 4;
constexpr int kRansacMaxSplit = 128;
constexpr int kRansacMinRows = 4;

}  // namespace

// nh a multiple of 128; out: f32 [nh]; counts: int [nh] and arrived:
// [nh / 128], zeroed once by the caller and left zero by every call. pts
// 16-byte aligned.
extern "C" int pc_ransac_score_counts(const float* hyp, const float* pts,
                                      float* out, int nh, int nr, int* counts,
                                      unsigned* arrived, void* stream) {
  if (nh == 0) return 0;
  const int tiles = nh / kLanes;
  const int most = nr / kRansacMinRows;
  int split = 1;
  const int err = walk_split(
      tiles, most < kRansacMaxSplit ? most : kRansacMaxSplit, split);
  if (err != 0) return err;
  ransac_kernel<kRansacWarps><<<tiles * split, kRansacWarps * 32, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      hyp, pts, out, nh, nr, split, counts, arrived);
  return (int)cudaGetLastError();
}
