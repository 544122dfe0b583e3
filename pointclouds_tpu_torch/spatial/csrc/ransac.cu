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
//
// Plane hypotheses (pc_ransac_hypotheses, below) replace no Pallas kernel:
// the JAX package draws them in XLA (`ops/segmentation.py::
// ransac_plane_masked`: jax.random.bits, the distinct triple, the gather,
// jnp.cross and the norm), which the port's torch version replays in ~380
// short operations (threefry's 20 rounds as masked int64 ops). Here one
// thread makes one hypothesis: the three threefry-2x32 draws of its flat
// counters r * iterations + t, the shrinking-range modulo and the shifts
// past the chosen positions, the position -> row map, the gather of three
// points and the plane in the pinned forms (cross as fma(a_j, b_k,
// -(a_k*b_j)), norm and offset as fma(z, z, fma(y, y, x*x)), every
// rounding explicit), bitwise the torch version and the JAX reference on
// the CPU. The valid count is read on the device, so no host read. Bound on
// Hopper: at 300-500 hypotheses (a few blocks of 128 threads) neither bytes
// nor operations; the one launch's latency is the cost, against the ~360
// launches of the torch version.
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

namespace {

__device__ __forceinline__ unsigned rotl32(unsigned x, int d) {
  return (x << d) | (x >> (32 - d));
}

// jax.random.bits' 64 bits at flat counter i under the key (k0, k1):
// Threefry-2x32 (20 rounds) of (i >> 32, i & 0xFFFFFFFF), high word first
// (utils/threefry.py::random_bits64).
__device__ __forceinline__ unsigned long long threefry_bits(
    unsigned k0, unsigned k1, unsigned long long i) {
  const unsigned ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  unsigned x0 = (unsigned)(i >> 32) + ks[0];
  unsigned x1 = (unsigned)i + ks[1];
#pragma unroll
  for (int r = 0; r < 5; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[r & 1][j]) ^ x0;
    }
    x0 += ks[(r + 1) % 3];
    x1 += ks[(r + 2) % 3] + (unsigned)(r + 1);
  }
  return ((unsigned long long)x0 << 32) | x1;
}

constexpr int kHypThreads = 128;

// xyz: f32 [n, 3]; cnt: the int64 valid count (clamped to 3 here); order:
// int64 position -> row map, or null (position p is row p). out: f32
// normal [I, 3], then d [I], then the degenerate flags as bytes (bool [I]).
__global__ void __launch_bounds__(kHypThreads)
    ransac_hypotheses_kernel(const float* __restrict__ xyz,
                             const long long* __restrict__ cnt_p,
                             const long long* __restrict__ order,
                             float* __restrict__ out, int iterations,
                             unsigned k0, unsigned k1) {
  const int t = blockIdx.x * kHypThreads + threadIdx.x;
  if (t >= iterations) return;
  const long long n_valid = *cnt_p;
  const unsigned long long cnt =
      n_valid < 3 ? 3ull : (unsigned long long)n_valid;
  const unsigned long long it = (unsigned long long)iterations;
  const long long a = (long long)(threefry_bits(k0, k1, t) % cnt);
  long long b = (long long)(threefry_bits(k0, k1, it + t) % (cnt - 1));
  b += b >= a;
  const long long lo = a < b ? a : b;
  const long long hi = a < b ? b : a;
  long long c = (long long)(threefry_bits(k0, k1, 2 * it + t) % (cnt - 2));
  c += c >= lo;
  c += c >= hi;
  const float* p0 = xyz + 3 * (order ? order[a] : a);
  const float* p1 = xyz + 3 * (order ? order[b] : b);
  const float* p2 = xyz + 3 * (order ? order[c] : c);
  const float v1x = __fsub_rn(p1[0], p0[0]), v1y = __fsub_rn(p1[1], p0[1]),
              v1z = __fsub_rn(p1[2], p0[2]);
  const float v2x = __fsub_rn(p2[0], p0[0]), v2y = __fsub_rn(p2[1], p0[1]),
              v2z = __fsub_rn(p2[2], p0[2]);
  const float n0 = __fmaf_rn(v1y, v2z, -__fmul_rn(v1z, v2y));
  const float n1 = __fmaf_rn(v1z, v2x, -__fmul_rn(v1x, v2z));
  const float n2 = __fmaf_rn(v1x, v2y, -__fmul_rn(v1y, v2x));
  const float len =
      __fsqrt_rn(__fmaf_rn(n2, n2, __fmaf_rn(n1, n1, __fmul_rn(n0, n0))));
  const bool degenerate = len < 1e-10f;
  const float safe = degenerate ? 1.0f : len;
  const float nx = __fdiv_rn(n0, safe), ny = __fdiv_rn(n1, safe),
              nz = __fdiv_rn(n2, safe);
  float* normal = out + 3LL * t;
  normal[0] = nx;
  normal[1] = ny;
  normal[2] = nz;
  out[3LL * iterations + t] =
      -__fmaf_rn(nz, p0[2], __fmaf_rn(ny, p0[1], __fmul_rn(nx, p0[0])));
  reinterpret_cast<unsigned char*>(out + 4LL * iterations)[t] = degenerate;
}

}  // namespace

// order may be null; out: f32 [4 * iterations + ceil(iterations / 4)].
extern "C" int pc_ransac_hypotheses(const float* xyz, const long long* cnt,
                                    const long long* order, float* out,
                                    int iterations, unsigned k0, unsigned k1,
                                    void* stream) {
  if (iterations == 0) return 0;
  const int blocks = (iterations + kHypThreads - 1) / kHypThreads;
  ransac_hypotheses_kernel<<<blocks, kHypThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      xyz, cnt, order, out, iterations, k0, k1);
  return (int)cudaGetLastError();
}
