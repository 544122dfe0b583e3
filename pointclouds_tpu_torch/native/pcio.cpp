// Native I/O runtime for pointclouds_tpu_torch.
//
// TPU-native counterpart of the reference's Rust I/O crate
// (ref: crates/io/src/{pcd,ply,las}.rs): the compute path is JAX/XLA, but
// file parsing is host-side runtime work, so it is implemented natively and
// multithreaded. Exposed via a C ABI consumed with ctypes (no pybind11 in
// the environment).
//
// Built at first use by pointclouds_tpu_torch/native/__init__.py (g++).
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <thread>
#include <vector>
#include <algorithm>

extern "C" {

// Decode LAS point records: scaled int32 xyz -> float32, intensity u16.
// Layout per LAS 1.4 spec: x,y,z int32 at offset 0; intensity u16 at 12.
// Returns 1 if any intensity is non-zero (ref: crates/io/src/las.rs:28-36).
int pcio_decode_las(const uint8_t* buf, int64_t n, int32_t stride,
                    double sx, double sy, double sz,
                    double ox, double oy, double oz,
                    float* out_xyz, float* out_intensity) {
    int nthreads = (int)std::min<int64_t>(std::max<int64_t>(n / 65536, 1), 16);
    std::vector<std::thread> threads;
    std::vector<int> any_int(nthreads, 0);
    int64_t chunk = (n + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; t++) {
        threads.emplace_back([=, &any_int]() {
            int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
            int local_any = 0;
            for (int64_t i = lo; i < hi; i++) {
                const uint8_t* p = buf + i * stride;
                int32_t xi, yi, zi; uint16_t inten;
                std::memcpy(&xi, p, 4);
                std::memcpy(&yi, p + 4, 4);
                std::memcpy(&zi, p + 8, 4);
                std::memcpy(&inten, p + 12, 2);
                out_xyz[i * 3 + 0] = (float)(xi * sx + ox);
                out_xyz[i * 3 + 1] = (float)(yi * sy + oy);
                out_xyz[i * 3 + 2] = (float)(zi * sz + oz);
                out_intensity[i] = (float)inten;
                local_any |= (inten != 0);
            }
            any_int[t] = local_any;
        });
    }
    for (auto& th : threads) th.join();
    int any = 0;
    for (int v : any_int) any |= v;
    return any;
}

// Parse whitespace-separated ASCII float triples (first 3 columns per line);
// unparsable fields read as 0.0 and short lines are skipped, matching the
// reference ASCII PCD reader (ref: crates/io/src/pcd.rs:202-234).
// Returns number of points parsed (capacity max_points).
int64_t pcio_parse_ascii_xyz(const char* text, int64_t len,
                             float* out_xyz, int64_t max_points) {
    int64_t count = 0;
    const char* p = text;
    const char* end = text + len;
    while (p < end && count < max_points) {
        // find end of line
        const char* eol = (const char*)memchr(p, '\n', end - p);
        if (!eol) eol = end;
        // skip blank / comment lines
        const char* q = p;
        while (q < eol && (*q == ' ' || *q == '\t' || *q == '\r')) q++;
        if (q < eol && *q != '#') {
            float vals[3];
            int got = 0;
            while (got < 3 && q < eol) {
                while (q < eol && (*q == ' ' || *q == '\t' || *q == '\r')) q++;
                if (q >= eol) break;
                char* next = nullptr;
                float v = strtof(q, &next);
                if (next == q) {  // unparsable token -> 0.0, skip the token
                    v = 0.0f;
                    while (q < eol && *q != ' ' && *q != '\t' && *q != '\r') q++;
                    next = (char*)q;
                } else if (next > eol) {
                    v = 0.0f;
                    next = (char*)eol;
                }
                vals[got++] = v;
                q = next;
            }
            if (got == 3) {
                out_xyz[count * 3 + 0] = vals[0];
                out_xyz[count * 3 + 1] = vals[1];
                out_xyz[count * 3 + 2] = vals[2];
                count++;
            }
        }
        p = eol + 1;
    }
    return count;
}

// Gather strided float32 fields out of a packed binary record block into a
// contiguous [n, 3] array (binary PCD/PLY body extraction), multithreaded.
void pcio_gather_xyz_f32(const uint8_t* buf, int64_t n, int32_t stride,
                         int32_t off_x, int32_t off_y, int32_t off_z,
                         float* out_xyz) {
    int nthreads = (int)std::min<int64_t>(std::max<int64_t>(n / 131072, 1), 16);
    std::vector<std::thread> threads;
    int64_t chunk = (n + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; t++) {
        threads.emplace_back([=]() {
            int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
            for (int64_t i = lo; i < hi; i++) {
                const uint8_t* p = buf + i * stride;
                std::memcpy(&out_xyz[i * 3 + 0], p + off_x, 4);
                std::memcpy(&out_xyz[i * 3 + 1], p + off_y, 4);
                std::memcpy(&out_xyz[i * 3 + 2], p + off_z, 4);
            }
        });
    }
    for (auto& th : threads) th.join();
}

}  // extern "C"
