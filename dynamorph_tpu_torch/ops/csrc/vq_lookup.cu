// Nearest-codebook search for the VQ-VAE, for Hopper (sm_90a): two kernels
// that share one distance loop.
//
// vq_lookup_kernel replaces the TPU kernel
// dynamorph_tpu/ops/vq.py::_vq_kernel (launched by _vq_pallas), used by the
// encode path and the eval steps. vq_indices_kernel replaces
// dynamorph_tpu/ops/vq.py::_vq_kernel_idx (built by _make_vq_kernel_idx,
// launched by _vq_pallas_idx, body :152-164), used once per training step.
// For each latent row z of D floats both find
//     idx = argmin_k ( ||E_k||^2 - 2 z . E_k )
// in IEEE fp32 (FMAs on the CUDA cores, no TF32), the first minimum winning
// as in torch.argmin and jnp.argmin. vq_lookup also writes q = E[idx],
// copied bit for bit from the codebook; vq_indices writes idx only (the
// training path re-gathers the rows differentiably). ||z||^2 is constant
// along a row and cannot change the argmin, so it is dropped, as in the TPU
// kernels. Every precision string of the JAX package ("default", "high",
// "highest") maps to this fp32 arithmetic, at least as exact as HIGHEST.
//
// What bounds them on an H100 SXM (3.35 TB/s; 67 TFLOP/s fp32 outside the
// tensor cores):
//   vq_lookup, z16 encode at batch 512 (N = 131072, D = 16, K = 64): it
//   moves 17.3 MB (z in, q out, idx out) for 0.27 GFLOP, so bytes bound it,
//   at ~5 us. z32 encode at batch 512 (N = 524288, D = 64, K = 512): 34
//   GFLOP against 0.27 GB, so the fp32 FMA rate bounds it, at ~0.5 ms.
//   vq_indices, z32 training at batch 768 (N = 786432, D = 64, K = 512): it
//   moves 4 (N D + K D + N) = 204.6 MB, 0.061 ms at 3.35 TB/s, for
//   2 N K D = 51.5 GFLOP, 0.769 ms at 67 TFLOP/s: operations bound it.
//
// Design, simple first: one thread owns one z row, held in registers. Each
// block stages the codebook in shared memory, kChunk codes at a time, with
// their squared norms, and every thread walks the codes in index order. All
// threads of a warp read the same code at once (a shared-memory broadcast)
// and keep a running minimum with a strict '<', which gives ties to the
// lowest index. The ragged end of N is masked. Both kernels run the same
// loop, so the encode and training paths assign every row alike. They
// launch on the caller's stream, allocate nothing and do not synchronise.
//
// Plain C interface, loaded with ctypes (see ops/_build.py and ops/vq.py).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // rows per block
constexpr int kChunk = 64;     // codes staged in shared memory at a time

// kChunk * D floats: 16 KB at D = 64, inside the 48 KB of static shared
// memory a block may use without an opt-in.
template <int D>
struct Staging {
  float4 code[kChunk * (D / 4)];
  float norm[kChunk];
};

template <int D>
__device__ __forceinline__ void load_row(const float* __restrict__ z,
                                         int64_t row, bool live,
                                         float (&zr)[D]) {
  static_assert(D % 4 == 0, "D must be a multiple of 4");
  if (live) {
    const float4* zp = reinterpret_cast<const float4*>(z + row * D);
#pragma unroll
    for (int j = 0; j < D / 4; ++j) {
      const float4 v = zp[j];
      zr[4 * j + 0] = v.x;
      zr[4 * j + 1] = v.y;
      zr[4 * j + 2] = v.z;
      zr[4 * j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < D; ++j) zr[j] = 0.0f;
  }
}

// The index of the nearest code to zr. Every thread of the block must call
// it (it synchronises the block), live or not.
template <int D>
__device__ __forceinline__ int nearest_code(const float (&zr)[D],
                                            const float* __restrict__ codebook,
                                            int k, Staging<D>& s) {
  constexpr int V = D / 4;  // float4 per row
  float best = __int_as_float(0x7f800000);  // +inf
  int best_k = 0;
  for (int k0 = 0; k0 < k; k0 += kChunk) {
    const int kc = min(kChunk, k - k0);
    __syncthreads();  // every thread is done with the previous chunk
    const float4* src =
        reinterpret_cast<const float4*>(codebook + static_cast<int64_t>(k0) * D);
    for (int i = threadIdx.x; i < kc * V; i += kThreads) s.code[i] = src[i];
    __syncthreads();
    for (int c = threadIdx.x; c < kc; c += kThreads) {
      float sq = 0.0f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float4 e = s.code[c * V + j];
        sq = fmaf(e.x, e.x, sq);
        sq = fmaf(e.y, e.y, sq);
        sq = fmaf(e.z, e.z, sq);
        sq = fmaf(e.w, e.w, sq);
      }
      s.norm[c] = sq;
    }
    __syncthreads();
    for (int c = 0; c < kc; ++c) {
      float dot = 0.0f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float4 e = s.code[c * V + j];
        dot = fmaf(zr[4 * j + 0], e.x, dot);
        dot = fmaf(zr[4 * j + 1], e.y, dot);
        dot = fmaf(zr[4 * j + 2], e.z, dot);
        dot = fmaf(zr[4 * j + 3], e.w, dot);
      }
      const float dist = s.norm[c] - 2.0f * dot;
      if (dist < best) {
        best = dist;
        best_k = k0 + c;
      }
    }
  }
  return best_k;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
vq_lookup_kernel(const float* __restrict__ z,
                 const float* __restrict__ codebook,
                 float* __restrict__ q, int32_t* __restrict__ idx,
                 int n, int k) {
  __shared__ Staging<D> s;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const bool live = row < n;
  float zr[D];
  load_row<D>(z, row, live, zr);
  const int best_k = nearest_code<D>(zr, codebook, k, s);
  if (live) {
    idx[row] = best_k;
    const float4* e = reinterpret_cast<const float4*>(
        codebook + static_cast<int64_t>(best_k) * D);
    float4* qp = reinterpret_cast<float4*>(q + row * D);
#pragma unroll
    for (int j = 0; j < D / 4; ++j) qp[j] = e[j];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
vq_indices_kernel(const float* __restrict__ z,
                  const float* __restrict__ codebook,
                  int32_t* __restrict__ idx, int n, int k) {
  __shared__ Staging<D> s;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const bool live = row < n;
  float zr[D];
  load_row<D>(z, row, live, zr);
  const int best_k = nearest_code<D>(zr, codebook, k, s);
  if (live) idx[row] = best_k;
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

template <int D>
int launch_lookup(const float* z, const float* codebook, float* q,
                  int32_t* idx, int n, int k, cudaStream_t stream) {
  vq_lookup_kernel<D><<<blocks_for(n), kThreads, 0, stream>>>(
      z, codebook, q, idx, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_indices(const float* z, const float* codebook, int32_t* idx,
                   int n, int k, cudaStream_t stream) {
  vq_indices_kernel<D><<<blocks_for(n), kThreads, 0, stream>>>(
      z, codebook, idx, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// z (n, d) and codebook (k, d) fp32, row-major and 16-byte aligned; q (n, d)
// fp32 and idx (n,) int32 are written. d must be 16 (z16) or 64 (z32), the
// latent widths of the models (ops/vq.py checks this). Returns the
// cudaError_t of the launch.
extern "C" int vq_lookup_f32(const void* z, const void* codebook, void* q,
                             void* idx, int n, int d, int k, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* zf = static_cast<const float*>(z);
  const float* ef = static_cast<const float*>(codebook);
  float* qf = static_cast<float*>(q);
  int32_t* ip = static_cast<int32_t*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_lookup<16>(zf, ef, qf, ip, n, k, s);
    case 64: return launch_lookup<64>(zf, ef, qf, ip, n, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As vq_lookup_f32, without q: only idx (n,) int32 is written.
extern "C" int vq_indices_f32(const void* z, const void* codebook, void* idx,
                              int n, int d, int k, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* zf = static_cast<const float*>(z);
  const float* ef = static_cast<const float*>(codebook);
  int32_t* ip = static_cast<int32_t*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_indices<16>(zf, ef, ip, n, k, s);
    case 64: return launch_indices<64>(zf, ef, ip, n, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
