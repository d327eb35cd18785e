// Native data-path kernels: tissue filtering and tile gathering on the host.
//
// The reference's cache-build hot loop runs per-tile PIL/cv2 Python
// (reference: RoiBuilder.py:156-171). This library evaluates the same rule
// (R-channel population stddev > 5 AND >1000 pixels with PIL-HSV h > 120,
// 50 < v < 210) directly over the slide array, in parallel across tiles,
// and gathers the surviving tiles with row memcpys — keeping the host side
// of the input pipeline off the Python interpreter while the accelerator
// runs the model.
//
// Built on demand with g++ by data/native.py into the package's _build/
// directory and loaded via ctypes. This is the PyTorch port's own copy of
// the JAX package's native/tissue_filter.cpp, with the same rule. One
// difference: the loops run on std::thread workers that are joined before
// each call returns, instead of OpenMP, so a serving process that builds a
// cache keeps no idle worker pool beside PyTorch's and the library needs no
// OpenMP runtime.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <system_error>
#include <thread>
#include <vector>

namespace {

// body(t) for every t in [0, n), tiles handed out one at a time to up to
// hardware_concurrency() threads (the calling thread is one of them); all
// workers are joined before this returns.
template <class Body>
void parallel_for(int64_t n, Body body) {
    const unsigned hw = std::thread::hardware_concurrency();
    const int64_t workers = std::min<int64_t>(n, hw ? hw : 1);
    std::atomic<int64_t> next(0);
    auto run = [&]() {
        for (int64_t t = next.fetch_add(1); t < n; t = next.fetch_add(1))
            body(t);
    };
    std::vector<std::thread> pool;
    for (int64_t w = 1; w < workers; ++w) {
        try {
            pool.emplace_back(run);
        } catch (const std::system_error&) {
            break;  // fewer threads: the others take the remaining tiles
        }
    }
    run();
    for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Evaluate the tissue rule for n_coords tiles of size roi x roi at (row,
// col) positions inside an H x W x 3 uint8 image. keep[i] = 1 if tissue.
void tissue_mask(const uint8_t* img, int64_t H, int64_t W,
                 const int64_t* coords, int64_t n_coords, int64_t roi,
                 double stddev_min, double hue_min, double val_min,
                 double val_max, int64_t min_pixels, uint8_t* keep) {
    parallel_for(n_coords, [&](int64_t t) {
        const int64_t r0 = coords[2 * t];
        const int64_t c0 = coords[2 * t + 1];
        // clamp to the image like numpy slicing (the Python fallback
        // degrades to a short tile at the border; reading past the
        // buffer here would be UB/garbage keep flags)
        if (r0 < 0 || c0 < 0 || r0 >= H || c0 >= W) { keep[t] = 0; return; }
        const int64_t rows = (r0 + roi <= H) ? roi : (H - r0);
        const int64_t cols = (c0 + roi <= W) ? roi : (W - c0);
        double sum_r = 0.0, sum_r2 = 0.0;
        int64_t n_pass = 0;
        for (int64_t r = 0; r < rows; ++r) {
            const uint8_t* row = img + ((r0 + r) * W + c0) * 3;
            for (int64_t c = 0; c < cols; ++c) {
                const double rr = row[3 * c];
                const double gg = row[3 * c + 1];
                const double bb = row[3 * c + 2];
                sum_r += rr;
                sum_r2 += rr * rr;
                // PIL 0..255 'HSV': v = max; h = 255 * hue fraction
                const double maxc = rr > gg ? (rr > bb ? rr : bb)
                                            : (gg > bb ? gg : bb);
                const double minc = rr < gg ? (rr < bb ? rr : bb)
                                            : (gg < bb ? gg : bb);
                if (maxc <= val_min || maxc >= val_max) continue;
                const double delta = maxc - minc;
                double h;
                if (delta == 0.0) {
                    h = 0.0;
                } else {
                    double hf;
                    if (rr == maxc)      hf = (maxc - bb) / delta - (maxc - gg) / delta;
                    else if (gg == maxc) hf = 2.0 + (maxc - rr) / delta - (maxc - bb) / delta;
                    else                 hf = 4.0 + (maxc - gg) / delta - (maxc - rr) / delta;
                    hf = hf / 6.0;
                    hf -= std::floor(hf);  // mod 1
                    h = std::floor(hf * 255.0);
                }
                if (h > hue_min) ++n_pass;
            }
        }
        // population stats over the pixels actually read (short border
        // tiles match the Python fallback's numpy-slice semantics)
        const double n = static_cast<double>(rows * cols);
        const double var = sum_r2 / n - (sum_r / n) * (sum_r / n);
        const double stddev = var > 0.0 ? std::sqrt(var) : 0.0;
        keep[t] = (stddev > stddev_min && n_pass > min_pixels) ? 1 : 0;
    });
}

// Gather tiles at (row, col) coords into a contiguous [n, roi, roi, 3]
// uint8 output buffer.
void gather_tiles(const uint8_t* img, int64_t H, int64_t W,
                  const int64_t* coords, int64_t n_coords, int64_t roi,
                  uint8_t* out) {
    const int64_t tile_bytes = roi * 3;
    parallel_for(n_coords, [&](int64_t t) {
        const int64_t r0 = coords[2 * t];
        const int64_t c0 = coords[2 * t + 1];
        uint8_t* dst = out + t * roi * roi * 3;
        // out-of-range regions zero-fill instead of reading past the
        // image buffer (border tiles / bad coords)
        if (r0 < 0 || c0 < 0 || r0 >= H || c0 >= W) {
            std::memset(dst, 0, roi * roi * 3);
            return;
        }
        const int64_t rows = (r0 + roi <= H) ? roi : (H - r0);
        const int64_t cols = (c0 + roi <= W) ? roi : (W - c0);
        const int64_t row_bytes = cols * 3;
        for (int64_t r = 0; r < rows; ++r) {
            const uint8_t* src = img + ((r0 + r) * W + c0) * 3;
            std::memcpy(dst + r * tile_bytes, src, row_bytes);
            if (row_bytes < tile_bytes)
                std::memset(dst + r * tile_bytes + row_bytes, 0,
                            tile_bytes - row_bytes);
        }
        for (int64_t r = rows; r < roi; ++r)
            std::memset(dst + r * tile_bytes, 0, tile_bytes);
    });
}

}  // extern "C"
