// Fused multiply-add over float64 arrays: out[i] = a[i] * b[i] + c[i] with
// one rounding (std::fma), which numpy cannot express. Built without
// -ffast-math, so the compiler neither splits nor reorders it.
#include <cmath>
#include <cstdint>

extern "C" void fma_f64(const double* a, const double* b, const double* c,
                        double* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) out[i] = std::fma(a[i], b[i], c[i]);
}
