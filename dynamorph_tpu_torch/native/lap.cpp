// Jonker-Volgenant linear assignment solver (dense, square, double costs).
//
// Native backend for dynamorph_tpu_torch.track.matching.solve_lap: the
// tracking stage solves one (n1+n2)^2 assignment per frame pair (reference
// SingleCellPatch/generate_trajectories.py:63) plus one 2Nx2N gap-closing
// problem per site (:254). JV is O(n^3) like Hungarian but with much lower
// constants on dense matrices.
//
// Exposed as a C ABI for ctypes:
//   int lapjv(int n, const double* cost, int* row_to_col, double* out_total)
// Returns 0 on success. row_to_col[i] = assigned column of row i.
//
// Built by dynamorph_tpu_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC -pthread -o build/native/liblap-<hash>.so
//
// Algorithm follows R. Jonker & A. Volgenant, "A Shortest Augmenting Path
// Algorithm for Dense and Sparse Linear Assignment Problems", Computing 38
// (1987): column reduction, reduction transfer, augmenting row reduction,
// then shortest augmenting paths.

#include <cfloat>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

int lapjv(int n, const double* cost, int* row_to_col, double* out_total) {
    if (n <= 0) return 1;
    // non-finite costs poison the reduced-cost arithmetic (inf - inf =
    // NaN breaks every comparison, corrupting index bookkeeping): refuse
    // up front (the caller sends such instances to scipy). O(n^2) scan
    // vs O(n^3) solve.
    for (int k = 0; k < n * n; ++k)
        if (!std::isfinite(cost[k])) return 3;
    std::vector<int> x(n, -1);        // row -> col
    std::vector<int> y(n, -1);        // col -> row
    std::vector<double> v(n, 0.0);    // column potentials
    std::vector<int> free_rows(n);
    int n_free = 0;

    // --- column reduction (scan columns right-to-left) ---
    {
        std::vector<int> matches(n, 0);
        for (int j = n - 1; j >= 0; --j) {
            double mn = cost[0 * n + j];
            int imin = 0;
            for (int i = 1; i < n; ++i) {
                double c = cost[i * n + j];
                if (c < mn) { mn = c; imin = i; }
            }
            v[j] = mn;
            if (++matches[imin] == 1) {
                x[imin] = j;
                y[j] = imin;
            } else {
                y[j] = -1;
            }
        }
        // x[i] is only assigned on a row's FIRST match (matches[i]==1
        // branch), so multiply-matched rows already hold exactly one
        // consistent assignment (x[i]=j with y[j]=i) — canonical LAPJV.
        // (An earlier x[i]=-1 reset here created phantom columns whose
        // y[j] pointed at an unassigned row: incomplete assignments on
        // most inputs and out-of-bounds pred[-1] during augmentation.)
        for (int i = 0; i < n; ++i)
            if (matches[i] == 0) free_rows[n_free++] = i;
    }

    // --- augmenting row reduction (two passes) ---
    for (int pass = 0; pass < 2; ++pass) {
        int k = 0;
        int prev_n_free = n_free;
        n_free = 0;
        while (k < prev_n_free) {
            int i = free_rows[k++];
            double v1 = DBL_MAX, v2 = DBL_MAX;  // smallest & second smallest
            int j1 = -1, j2 = -1;
            for (int j = 0; j < n; ++j) {
                double c = cost[i * n + j] - v[j];
                if (c < v2) {
                    if (c >= v1) { v2 = c; j2 = j; }
                    else { v2 = v1; j2 = j1; v1 = c; j1 = j; }
                }
            }
            if (j1 < 0) return 3;  // defensive: unreachable for finite costs
            int i0 = y[j1];
            if (v1 < v2) {
                v[j1] -= v2 - v1;
            } else if (i0 >= 0 && j2 >= 0) {
                j1 = j2;
                i0 = y[j2];
            }
            if (i0 >= 0) {
                if (v1 < v2) {
                    free_rows[--k] = i0;  // re-process displaced row now
                } else {
                    free_rows[n_free++] = i0;  // defer to next pass
                }
            }
            x[i] = j1;
            y[j1] = i;
        }
    }

    // --- shortest augmenting paths for remaining free rows ---
    std::vector<double> d(n);
    std::vector<int> pred(n);
    std::vector<int> cols(n);
    for (int f = 0; f < n_free; ++f) {
        int i_free = free_rows[f];
        for (int j = 0; j < n; ++j) {
            d[j] = cost[i_free * n + j] - v[j];
            pred[j] = i_free;
            cols[j] = j;
        }
        int lo = 0, hi = 0, n_ready = 0;
        double mind = 0.0;
        int j_final = -1;
        while (j_final < 0) {
            if (lo == hi) {
                if (lo >= n) return 3;  // TODO set exhausted: no augmenting
                                        // path (non-finite costs) — let the
                                        // caller fall back instead of
                                        // reading cols[n]/spinning forever
                n_ready = lo;
                mind = d[cols[lo]];
                hi = lo + 1;
                for (int k = hi; k < n; ++k) {
                    int j = cols[k];
                    if (d[j] <= mind) {
                        if (d[j] < mind) { hi = lo; mind = d[j]; }
                        cols[k] = cols[hi];
                        cols[hi++] = j;
                    }
                }
                for (int k = lo; k < hi; ++k) {
                    int j = cols[k];
                    if (y[j] < 0) { j_final = j; break; }
                }
            }
            if (j_final < 0) {
                int j1 = cols[lo++];
                int i = y[j1];
                double u1 = cost[i * n + j1] - v[j1] - mind;
                for (int k = hi; k < n; ++k) {
                    int j = cols[k];
                    double c = cost[i * n + j] - v[j] - u1;
                    if (c < d[j]) {
                        d[j] = c;
                        pred[j] = i;
                        if (c == mind) {
                            if (y[j] < 0) { j_final = j; break; }
                            cols[k] = cols[hi];
                            cols[hi++] = j;
                        }
                    }
                }
            }
        }
        for (int k = 0; k < n_ready; ++k) {
            int j = cols[k];
            v[j] += d[j] - mind;
        }
        // augment along the alternating path back to i_free
        int j = j_final;
        while (true) {
            int i = pred[j];
            y[j] = i;
            int tmp = x[i];
            x[i] = j;
            if (i == i_free) break;
            j = tmp;
        }
    }

    double total = 0.0;
    for (int i = 0; i < n; ++i) {
        if (x[i] < 0) return 2;  // should not happen
        row_to_col[i] = x[i];
        total += cost[i * n + x[i]];
    }
    if (out_total) *out_total = total;
    return 0;
}

}  // extern "C"
