// Native build-once / query-many host cell index.
//
// C++ twin of spatial/hostindex.HostCellIndex (same grid construction,
// same exact-f64 distance checks, same ring-expansion coverage bound and
// tie order), serving the single-point KD-tree-style API surface
// (radius_search / knn_indices / small-batch knn) at reference speed:
// the reference amortizes a KD-tree build to ~1.5 us per KNN query
// (ref: crates/spatial/src/kdtree.rs:25-44, BENCHMARKS.md:43-48); the
// pure-numpy index pays ~100-300 us of interpreter overhead per query.
//
// Exactness contract (mirrors the numpy class): candidate coverage by
// construction (ring r covers every point within (r-1)*cell), exact f64
// distances, inclusive radius boundary, distance ties resolved in
// cell-sorted candidate order (a per-candidate sequence number makes the
// (d2, seq) order total — identical to numpy's stable argsort).
//
// Queries iterate cell RUNS in place (no gathered index vector) and keep
// the k best in a bounded max-heap (O(n log k), no full sort). All query
// state is stack-local: ctypes releases the GIL around foreign calls, so
// concurrent queries on one index MUST NOT share scratch (a shared
// vector race corrupts the heap).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

struct Cand {
    double d2;
    int64_t pos;  // position in the sorted arrays
};

// Tie order: ascending sorted position among equal distances. Identical
// to the numpy twin's stable argsort over cell-gathered candidates —
// every scan there visits cells in ascending linear-id order, so its
// stable tie order IS ascending sorted position. Position-based ordering
// makes that explicit and lets the scan below visit cells in ANY order.
inline bool cand_less(const Cand& a, const Cand& b) {
    return a.d2 < b.d2 || (a.d2 == b.d2 && a.pos < b.pos);
}

struct Index {
    int64_t n = 0;         // input rows (padded capacity)
    int64_t n_valid = 0;   // finite+valid points indexed
    double cell = 1.0;
    double mn[3] = {0, 0, 0};
    int64_t extent[3] = {1, 1, 1};
    std::vector<int64_t> slin;  // sorted cell ids
    // Sorted coords in SoA layout: cell runs are contiguous, so the
    // per-run distance pass vectorizes (the interleaved [pos*3] layout
    // defeated autovectorization and cost ~2x on the scan). Stored as
    // f32 — the inputs ARE f32, so converting to f64 at scan time is
    // exact (bit-identical to the numpy twin's f64-from-f32 arrays)
    // and halves the memory traffic of the random-query workload,
    // which is bandwidth-bound at 1M points.
    std::vector<float> sx, sy, sz;
    std::vector<int64_t> srows;  // sorted -> original row
    // Dense cell -> first sorted row table (built when the grid is small
    // enough; empty => fall back to binary search over slin). starts[c]
    // .. starts[c+1] is cell c's run.
    std::vector<int64_t> starts;
};

constexpr int64_t kDenseTableMax = 8 * 1024 * 1024;

inline int64_t lower_bound_lin(const std::vector<int64_t>& v, int64_t key) {
    return std::lower_bound(v.begin(), v.end(), key) - v.begin();
}

inline double d2_at(const Index& ix, int64_t pos, const double q[3]) {
    const double dx = (double)ix.sx[pos] - q[0];
    const double dy = (double)ix.sy[pos] - q[1];
    const double dz = (double)ix.sz[pos] - q[2];
    return dx * dx + dy * dy + dz * dz;
}

// Vectorizable distance pass over a contiguous sorted run [s, e):
// fills d2buf[0 .. e-s). Caller sizes d2buf. All arithmetic in f64
// (the f32 loads convert exactly).
inline void d2_run(const Index& ix, int64_t s, int64_t e, const double q[3],
                   double* d2buf) {
    const float* X = ix.sx.data() + s;
    const float* Y = ix.sy.data() + s;
    const float* Z = ix.sz.data() + s;
    const int64_t len = e - s;
    for (int64_t i = 0; i < len; ++i) {
        const double dx = (double)X[i] - q[0];
        const double dy = (double)Y[i] - q[1];
        const double dz = (double)Z[i] - q[2];
        d2buf[i] = dx * dx + dy * dy + dz * dz;
    }
}

}  // namespace

extern "C" {

void* pcidx_build(const float* xyz, const uint8_t* valid, int64_t n) {
    auto* ix = new Index();
    ix->n = n;
    std::vector<int64_t> rows;
    rows.reserve(n);
    for (int64_t i = 0; i < n; ++i) {
        const float x = xyz[i * 3], y = xyz[i * 3 + 1], z = xyz[i * 3 + 2];
        if (valid[i] && std::isfinite(x) && std::isfinite(y) &&
            std::isfinite(z))
            rows.push_back(i);
    }
    ix->n_valid = (int64_t)rows.size();
    if (ix->n_valid == 0) return ix;

    std::vector<double> pts(ix->n_valid * 3);
    double mn[3] = {1e300, 1e300, 1e300}, mx[3] = {-1e300, -1e300, -1e300};
    for (int64_t j = 0; j < ix->n_valid; ++j) {
        for (int a = 0; a < 3; ++a) {
            const double v = (double)xyz[rows[j] * 3 + a];
            pts[j * 3 + a] = v;
            mn[a] = std::min(mn[a], v);
            mx[a] = std::max(mx[a], v);
        }
    }
    double span[3], vol = 1.0, span_max = 0.0;
    for (int a = 0; a < 3; ++a) {
        span[a] = std::max(mx[a] - mn[a], 1e-12);
        vol *= span[a];
        span_max = std::max(span_max, span[a]);
        ix->mn[a] = mn[a];
    }
    // Same sizing as the numpy class: ~2 points per cell (A/B'd over
    // {2,4,8,16} on both the reference's fixed-query Criterion workload
    // and a 2000-random-query workload — 2 wins KNN at 100K and 1M),
    // BLENDED over 3D / planar / linear density so degenerate clouds
    // (flat planes, collinear scans) never explode the cell count
    // (identical arithmetic to the numpy twin: pow, not cbrt — they
    // differ by ulps and the parity contract is bit-exact).
    double sspan[3] = {span[0], span[1], span[2]};
    std::sort(sspan, sspan + 3);
    const double nv = (double)std::max<int64_t>(ix->n_valid, 1);
    const double c3 = std::pow(vol * 2.0 / nv, 1.0 / 3.0);
    const double c2 = std::sqrt(sspan[1] * sspan[2] * 2.0 / nv);
    const double c1 = sspan[2] * 2.0 / nv;
    const double cell = std::max(c3, std::max(c2, c1));
    ix->cell = std::min(std::max(cell, 1e-9), span_max);

    std::vector<int64_t> lin(ix->n_valid);
    int64_t cmax[3] = {0, 0, 0};
    std::vector<int64_t> c(ix->n_valid * 3);
    for (int64_t j = 0; j < ix->n_valid; ++j) {
        for (int a = 0; a < 3; ++a) {
            int64_t cc =
                (int64_t)std::floor((pts[j * 3 + a] - mn[a]) / ix->cell);
            c[j * 3 + a] = cc;
            cmax[a] = std::max(cmax[a], cc);
        }
    }
    for (int a = 0; a < 3; ++a) ix->extent[a] = cmax[a] + 1;
    for (int64_t j = 0; j < ix->n_valid; ++j)
        lin[j] = (c[j * 3] * ix->extent[1] + c[j * 3 + 1]) * ix->extent[2] +
                 c[j * 3 + 2];

    // (lin, j) pair sort: unique second components make std::sort stable
    // in effect, and the contiguous pair layout sorts ~3x faster than a
    // stable_sort over indices with a gather comparator.
    std::vector<std::pair<int64_t, int64_t>> kv(ix->n_valid);
    for (int64_t j = 0; j < ix->n_valid; ++j) kv[j] = {lin[j], j};
    std::sort(kv.begin(), kv.end());
    ix->slin.resize(ix->n_valid);
    ix->sx.resize(ix->n_valid);
    ix->sy.resize(ix->n_valid);
    ix->sz.resize(ix->n_valid);
    ix->srows.resize(ix->n_valid);
    for (int64_t j = 0; j < ix->n_valid; ++j) {
        const int64_t o = kv[j].second;
        ix->slin[j] = kv[j].first;
        ix->srows[j] = rows[o];
        ix->sx[j] = pts[o * 3];
        ix->sy[j] = pts[o * 3 + 1];
        ix->sz[j] = pts[o * 3 + 2];
    }
    const int64_t ncells =
        ix->extent[0] * ix->extent[1] * ix->extent[2];
    if (ncells <= kDenseTableMax) {
        // Dense run table: two array reads per cell column instead of two
        // binary searches — the searches dominated query time.
        ix->starts.assign(ncells + 1, 0);
        int64_t j = 0;
        for (int64_t c = 0; c < ncells; ++c) {
            ix->starts[c] = j;
            while (j < ix->n_valid && ix->slin[j] == c) ++j;
        }
        ix->starts[ncells] = ix->n_valid;
    }
    return ix;
}

int64_t pcidx_nvalid(void* h) { return ((Index*)h)->n_valid; }

void pcidx_free(void* h) { delete (Index*)h; }

// k nearest of q (ascending distance; ties in cell-sorted candidate
// order, matching numpy's stable argsort). Fills out_rows/out_dists
// (caller sizes them to k); returns the count actually found.
int64_t pcidx_knn(void* h, const double* q, int64_t k, int64_t* out_rows,
                  double* out_dists) {
    Index& ix = *(Index*)h;
    if (ix.n_valid == 0 || k <= 0) return 0;
    // Non-finite query: the radius-doubling certificate below can never
    // terminate (NaN comparisons are all-false), so bail out empty —
    // matching the reference KdTree::knn's NaN-query behavior
    // (crates/spatial/src/kdtree.rs:64-80).
    if (!std::isfinite(q[0]) || !std::isfinite(q[1]) ||
        !std::isfinite(q[2]))
        return 0;

    const int64_t want = std::min<int64_t>(k, ix.n_valid);
    // thread_local: reused capacity across calls with no malloc, still
    // race-free when concurrent GIL-released queries share one index.
    thread_local std::vector<Cand> heap;
    heap.clear();
    heap.reserve((size_t)k);

    // Shell-ordered scan: visit cells by ascending Chebyshev ring around
    // the query's cell, pruning each z-column by its exact planar gap and
    // stopping as soon as the kth distance is provably inside the scanned
    // rings (a ring-(t+1) cell lies >= t*cell from anywhere in the query's
    // cell). No restart, no candidate superset beyond the pruned shells —
    // the expanding-radius rescan this replaces re-visited every candidate
    // on each doubling and scanned the full AABB of the certified ball.
    const int64_t ey = ix.extent[1], ez = ix.extent[2];
    const bool dense = !ix.starts.empty();

    int64_t cq[3];
    for (int a = 0; a < 3; ++a)
        cq[a] = (int64_t)std::floor((q[a] - ix.mn[a]) / ix.cell);

    // kth2: current kth squared distance once the heap is full (else inf).
    double kth2 = 1e300;
    auto consider = [&](double d2, int64_t pos) {
        const Cand c{d2, pos};
        if ((int64_t)heap.size() < k) {
            heap.push_back(c);
            std::push_heap(heap.begin(), heap.end(), cand_less);
            if ((int64_t)heap.size() == k) kth2 = heap.front().d2;
        } else if (cand_less(c, heap.front())) {
            std::pop_heap(heap.begin(), heap.end(), cand_less);
            heap.back() = c;
            std::push_heap(heap.begin(), heap.end(), cand_less);
            kth2 = heap.front().d2;
        }
    };

    // Exact gap from q to a cell's slab along one axis.
    auto axis_gap = [&](double qa, int64_t c, int a) {
        const double lo = ix.mn[a] + (double)c * ix.cell;
        return qa < lo ? lo - qa
                       : (qa > lo + ix.cell ? qa - lo - ix.cell : 0.0);
    };

    // Scan a contiguous z-run of cells in column (x, y). Prunes on the
    // planar gap alone (ties at kth2 must be KEPT: equal-d2 candidates
    // with smaller pos displace larger-pos incumbents, so only strictly
    // farther cells may be skipped). Two-phase: a vectorized distance
    // pass into a stack buffer, then a scalar threshold scan whose branch
    // is almost always not-taken once the heap warms up.
    double d2buf[256];
    auto scan_run = [&](int64_t x, int64_t y, int64_t z0, int64_t z1,
                        double pl2) {
        z0 = std::max<int64_t>(z0, 0);
        z1 = std::min<int64_t>(z1, ez - 1);
        if (z1 < z0 || pl2 > kth2) return;
        const int64_t base = (x * ey + y) * ez;
        int64_t s, e;
        if (dense) {
            s = ix.starts[base + z0];
            e = ix.starts[base + z1 + 1];
        } else {
            s = lower_bound_lin(ix.slin, base + z0);
            e = lower_bound_lin(ix.slin, base + z1 + 1);
        }
        for (int64_t cs = s; cs < e; cs += 256) {
            const int64_t ce = std::min<int64_t>(cs + 256, e);
            d2_run(ix, cs, ce, q, d2buf);
            for (int64_t i = 0; i < ce - cs; ++i)
                if (d2buf[i] <= kth2) consider(d2buf[i], cs + i);
        }
    };

    // Ring range: t_min = Chebyshev distance from cq to the nearest
    // in-grid cell (smaller rings are entirely outside the grid); at
    // t_max the ring's cube covers the whole grid.
    int64_t t_min = 0, t_max = 0;
    for (int a = 0; a < 3; ++a) {
        const int64_t under = cq[a] < 0 ? -cq[a] : 0;
        const int64_t over =
            cq[a] > ix.extent[a] - 1 ? cq[a] - (ix.extent[a] - 1) : 0;
        t_min = std::max(t_min, std::max(under, over));
        t_max = std::max(
            t_max, std::max(std::abs(cq[a]),
                            std::abs(ix.extent[a] - 1 - cq[a])));
    }

    for (int64_t t = t_min;; ++t) {
        const int64_t xlo = std::max<int64_t>(cq[0] - t, 0);
        const int64_t xhi = std::min<int64_t>(cq[0] + t, ix.extent[0] - 1);
        for (int64_t x = xlo; x <= xhi; ++x) {
            const double gx = axis_gap(q[0], x, 0);
            const double gx2 = gx * gx;
            if (gx2 > kth2) continue;
            const bool xface = (x == cq[0] - t) || (x == cq[0] + t);
            const int64_t ylo = std::max<int64_t>(cq[1] - t, 0);
            const int64_t yhi =
                std::min<int64_t>(cq[1] + t, ix.extent[1] - 1);
            for (int64_t y = ylo; y <= yhi; ++y) {
                const double gy = axis_gap(q[1], y, 1);
                const double pl2 = gx2 + gy * gy;
                if (pl2 > kth2) continue;
                const bool yface = (y == cq[1] - t) || (y == cq[1] + t);
                if (t == 0 || xface || yface) {
                    // Side column: the whole z-run belongs to ring t.
                    scan_run(x, y, cq[2] - t, cq[2] + t, pl2);
                } else {
                    // Interior column: only the two z-faces are new.
                    const double gz0 = axis_gap(q[2], cq[2] - t, 2);
                    if (pl2 + gz0 * gz0 <= kth2)
                        scan_run(x, y, cq[2] - t, cq[2] - t, pl2);
                    const double gz1 = axis_gap(q[2], cq[2] + t, 2);
                    if (pl2 + gz1 * gz1 <= kth2)
                        scan_run(x, y, cq[2] + t, cq[2] + t, pl2);
                }
            }
        }
        if (t >= t_max) break;  // every grid cell scanned
        if ((int64_t)heap.size() >= want) {
            // Ring t+1 cells lie >= t*cell away; strict < keeps exact tie
            // order (an equal-distance point there could displace a
            // larger-pos incumbent).
            const double bound = (double)t * ix.cell;
            if (kth2 < bound * bound) break;
        }
    }
    std::sort_heap(heap.begin(), heap.end(), cand_less);
    const int64_t kk = (int64_t)heap.size();
    for (int64_t j = 0; j < kk; ++j) {
        out_rows[j] = ix.srows[heap[j].pos];
        out_dists[j] = std::sqrt(heap[j].d2);
    }
    return kk;
}

// Rows within `radius` (inclusive) of q, ascending original order.
// Returns the total hit count; fills out_rows up to cap (caller retries
// with a larger buffer when count > cap).
int64_t pcidx_radius(void* h, const double* q, double radius,
                     int64_t* out_rows, int64_t cap) {
    Index& ix = *(Index*)h;
    if (ix.n_valid == 0) return 0;
    // Non-finite query or radius: floor(NaN)->int64 below is UB and no
    // point can certify a distance to a NaN center — return empty, like
    // the reference KdTree's NaN-query behavior.
    if (!std::isfinite(q[0]) || !std::isfinite(q[1]) ||
        !std::isfinite(q[2]) || !std::isfinite(radius))
        return 0;
    const double r2 = radius * radius;
    // thread_local: capacity persists across calls (no per-call malloc),
    // still race-free for concurrent GIL-released queries.
    thread_local std::vector<int64_t> hits;
    hits.clear();

    // Exact per-axis window of the ball's AABB (a strictly smaller
    // superset of the true hit set than the numpy path's cubic
    // ceil(r/cell)+1 ring — the exact d2 filter makes results identical),
    // plus per-column planar pruning.
    const int64_t ey = ix.extent[1], ez = ix.extent[2];
    int64_t lo[3], hi[3];
    for (int a = 0; a < 3; ++a) {
        lo[a] = std::max<int64_t>(
            (int64_t)std::floor((q[a] - radius - ix.mn[a]) / ix.cell), 0);
        hi[a] = std::min<int64_t>(
            (int64_t)std::floor((q[a] + radius - ix.mn[a]) / ix.cell),
            ix.extent[a] - 1);
        if (hi[a] < lo[a]) return 0;
    }
    const bool dense = !ix.starts.empty();
    double d2buf[256];
    for (int64_t x = lo[0]; x <= hi[0]; ++x) {
        // Min distance from q to the column's x-slab.
        const double xlo = ix.mn[0] + (double)x * ix.cell;
        const double dx =
            q[0] < xlo ? xlo - q[0]
                       : (q[0] > xlo + ix.cell ? q[0] - xlo - ix.cell : 0.0);
        for (int64_t y = lo[1]; y <= hi[1]; ++y) {
            const double ylo = ix.mn[1] + (double)y * ix.cell;
            const double dy =
                q[1] < ylo
                    ? ylo - q[1]
                    : (q[1] > ylo + ix.cell ? q[1] - ylo - ix.cell : 0.0);
            if (dx * dx + dy * dy > r2) continue;
            const int64_t base = (x * ey + y) * ez;
            int64_t s, e;
            if (dense) {
                s = ix.starts[base + lo[2]];
                e = ix.starts[base + hi[2] + 1];
            } else {
                s = lower_bound_lin(ix.slin, base + lo[2]);
                e = lower_bound_lin(ix.slin, base + hi[2] + 1);
            }
            for (int64_t cs = s; cs < e; cs += 256) {
                const int64_t ce = std::min<int64_t>(cs + 256, e);
                d2_run(ix, cs, ce, q, d2buf);
                for (int64_t i = 0; i < ce - cs; ++i)
                    if (d2buf[i] <= r2) hits.push_back(ix.srows[cs + i]);
            }
        }
    }
    std::sort(hits.begin(), hits.end());
    const int64_t cnt = (int64_t)hits.size();
    for (int64_t j = 0; j < std::min(cnt, cap); ++j) out_rows[j] = hits[j];
    return cnt;
}

}  // extern "C"

extern "C" {

// Batched KNN: nq queries in one call (the Python per-query loop costs
// ~40 us/call of interpreter overhead). out_rows/out_dists are [nq * k];
// out_counts[i] = results found for query i (rows beyond it untouched).
void pcidx_knn_batch(void* h, const double* qs, int64_t nq, int64_t k,
                     int64_t* out_rows, double* out_dists,
                     int64_t* out_counts) {
    for (int64_t i = 0; i < nq; ++i)
        out_counts[i] =
            pcidx_knn(h, qs + i * 3, k, out_rows + i * k, out_dists + i * k);
}

}  // extern "C"

extern "C" {

// Cluster epilogue: group rows by component label into the reference's
// canonical order (size desc, then lexicographic — the first member IS
// the label, since labels are component-minimum row ids and members are
// emitted ascending; ref: crates/segmentation/src/euclidean_cluster.rs:
// 169-186). Replaces the Python np.argsort + per-segment list build,
// which dominated the euclidean_cluster API wall time (~37 ms at 131K).
//
// labels: [n] component label per row, each in [0, n).
// out_order: [n] row ids grouped by cluster, ascending within a cluster.
// out_starts: [n + 1] capacity; start offset of cluster c in out_order.
// Returns the number of clusters k passing min_size <= size <= max_size
// (out_starts[0..k] valid, segment c ends at out_starts[c + 1]).
int64_t pcidx_cluster_epilogue(const int32_t* labels, int64_t n,
                               int64_t min_size, int64_t max_size,
                               int32_t* out_order, int64_t* out_starts) {
    std::vector<int64_t> count(n, 0);
    for (int64_t i = 0; i < n; ++i) count[labels[i]]++;
    // Surviving cluster labels, canonical order: size desc, label asc.
    std::vector<int32_t> keep;
    keep.reserve(1024);
    for (int64_t l = 0; l < n; ++l) {
        const int64_t c = count[l];
        if (c >= min_size && c <= max_size && c > 0) keep.push_back((int32_t)l);
    }
    std::sort(keep.begin(), keep.end(), [&](int32_t a, int32_t b) {
        if (count[a] != count[b]) return count[a] > count[b];
        return a < b;
    });
    // Per-label write cursor into out_order (n sentinel = dropped).
    std::vector<int64_t> cursor(n, -1);
    int64_t off = 0;
    const int64_t k = (int64_t)keep.size();
    for (int64_t c = 0; c < k; ++c) {
        out_starts[c] = off;
        cursor[keep[c]] = off;
        off += count[keep[c]];
    }
    out_starts[k] = off;
    // Rows visited ascending: members land ascending within each cluster.
    for (int64_t i = 0; i < n; ++i) {
        int64_t& cur = cursor[labels[i]];
        if (cur >= 0) out_order[cur++] = (int32_t)i;
    }
    return k;
}

}  // extern "C"
