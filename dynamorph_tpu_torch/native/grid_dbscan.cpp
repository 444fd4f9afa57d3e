// Exact DBSCAN for points on an integer pixel grid.
//
// Native backend for dynamorph_tpu_torch.track.clustering: the reference
// clusters foreground pixels with sklearn's DBSCAN(eps=10, min_samples=250)
// (reference SingleCellPatch/instance_clustering.py:95), the documented CPU
// bottleneck of the instance-segmentation stage (SURVEY.md §3.2). On a pixel
// grid, eps-neighborhoods are a fixed disk stencil, so neighbor counting is
// an O(|disk|) occupancy-grid lookup instead of a kd-tree query.
//
// Produces labels IDENTICAL to sklearn's: clusters are connected components
// of core points (count of grid points within Euclidean distance eps >=
// min_samples, point itself included), numbered by smallest member index;
// border points take the label of the first (lowest-numbered) cluster that
// reaches them; noise = -1. These outputs are order-independent (a border
// point contested between clusters is always claimed by the lower-numbered
// cluster because clusters are grown to completion in index order).
//
// C ABI for ctypes:
//   int grid_dbscan(const int32_t* pos, int64_t n, int32_t height,
//                   int32_t width, double eps, int32_t min_samples,
//                   int32_t* labels_out)
//   int grid_dbscan_mt(..., int32_t n_threads, int32_t* labels_out)
// pos is (n, 2) row-major (y, x). Returns 0 on success.
//
// The core test (count eps-neighbors per point) is per-point independent,
// so grid_dbscan_mt splits it over n_threads; the component-growing DFS
// stays serial, preserving sklearn's exact cluster numbering and border
// assignment. Labels are bit-identical for any thread count. The core test
// and the DFS each touch every (point, stencil-offset) pair once, so the
// parallel fraction is roughly the core test's share (~half at frame
// scale) — threads buy up to ~2x; frame-level parallelism on top comes
// from the callers (ctypes releases the GIL during this call).
//
// Built by dynamorph_tpu_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC -pthread -o build/native/libgrid_dbscan-<hash>.so

#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

int grid_dbscan_mt(const int32_t* pos, int64_t n, int32_t height,
                   int32_t width, double eps, int32_t min_samples,
                   int32_t n_threads, int32_t* labels_out) {
    if (n <= 0 || height <= 0 || width <= 0) return 1;

    // disk stencil offsets (dy, dx) with dy^2 + dx^2 <= eps^2
    const int r = (int)std::floor(eps);
    const double eps2 = eps * eps;
    std::vector<int32_t> offs;
    offs.reserve((2 * r + 1) * (2 * r + 1) * 2);
    for (int dy = -r; dy <= r; ++dy)
        for (int dx = -r; dx <= r; ++dx)
            if ((double)dy * dy + (double)dx * dx <= eps2) {
                offs.push_back(dy);
                offs.push_back(dx);
            }
    const int n_offs = (int)(offs.size() / 2);

    // occupancy grid: index+1 of the point at each pixel (0 = empty)
    std::vector<int64_t> grid((size_t)height * width, 0);
    for (int64_t i = 0; i < n; ++i) {
        int32_t y = pos[2 * i], x = pos[2 * i + 1];
        if (y < 0 || y >= height || x < 0 || x >= width) return 2;
        grid[(size_t)y * width + x] = i + 1;
    }

    // core test: neighbors within eps (incl. self) >= min_samples.
    // Per-point independent -> contiguous ranges per thread; the shared
    // grid/offs are read-only here, is_core writes are disjoint.
    std::vector<uint8_t> is_core(n, 0);
    auto core_range = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            int32_t y = pos[2 * i], x = pos[2 * i + 1];
            int count = 0;
            for (int k = 0; k < n_offs; ++k) {
                int32_t yy = y + offs[2 * k], xx = x + offs[2 * k + 1];
                if (yy < 0 || yy >= height || xx < 0 || xx >= width) continue;
                if (grid[(size_t)yy * width + xx]) ++count;
            }
            if (count >= min_samples) is_core[i] = 1;
        }
    };
    int nt = n_threads < 1 ? 1 : (n_threads > 64 ? 64 : n_threads);
    if ((int64_t)nt > n) nt = (int)n;
    if (nt <= 1 || n < 8192) {
        core_range(0, n);
    } else {
        std::vector<std::thread> pool;
        pool.reserve(nt);
        const int64_t chunk = (n + nt - 1) / nt;
        for (int t = 0; t < nt; ++t) {
            int64_t lo = (int64_t)t * chunk;
            int64_t hi = lo + chunk < n ? lo + chunk : n;
            if (lo >= hi) break;
            pool.emplace_back(core_range, lo, hi);
        }
        for (auto& th : pool) th.join();
    }

    // sklearn dbscan_inner: DFS from each unlabeled core point in order
    for (int64_t i = 0; i < n; ++i) labels_out[i] = -1;
    std::vector<int64_t> stack;
    int32_t label_num = 0;
    for (int64_t seed = 0; seed < n; ++seed) {
        if (labels_out[seed] != -1 || !is_core[seed]) continue;
        int64_t i = seed;
        while (true) {
            if (labels_out[i] == -1) {
                labels_out[i] = label_num;
                if (is_core[i]) {
                    int32_t y = pos[2 * i], x = pos[2 * i + 1];
                    for (int k = 0; k < n_offs; ++k) {
                        int32_t yy = y + offs[2 * k];
                        int32_t xx = x + offs[2 * k + 1];
                        if (yy < 0 || yy >= height || xx < 0 || xx >= width)
                            continue;
                        int64_t j = grid[(size_t)yy * width + xx];
                        if (j && labels_out[j - 1] == -1)
                            stack.push_back(j - 1);
                    }
                }
            }
            if (stack.empty()) break;
            i = stack.back();
            stack.pop_back();
        }
        ++label_num;
    }
    return 0;
}

int grid_dbscan(const int32_t* pos, int64_t n, int32_t height, int32_t width,
                double eps, int32_t min_samples, int32_t* labels_out) {
    return grid_dbscan_mt(pos, n, height, width, eps, min_samples, 1,
                          labels_out);
}

}  // extern "C"
