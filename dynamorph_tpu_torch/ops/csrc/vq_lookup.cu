// Nearest-codebook lookup for the VQ-VAE encode path, for Hopper (sm_90a).
//
// Replaces the TPU kernel dynamorph_tpu/ops/vq.py::_vq_kernel (launched by
// _vq_pallas). For each latent row z of D floats it finds
//     idx = argmin_k ( ||E_k||^2 - 2 z . E_k )
// in IEEE fp32 (FMAs on the CUDA cores, no TF32), the first minimum winning
// as in torch.argmin and jnp.argmin, and writes idx and q = E[idx], copied
// bit for bit from the codebook. ||z||^2 is constant along a row and cannot
// change the argmin, so it is dropped, as in the TPU kernel.
//
// What bounds it on an H100 SXM (3.35 TB/s; 67 TFLOP/s fp32 outside the
// tensor cores):
//   z16 encode at batch 512 (N = 131072, D = 16, K = 64): it moves 17.3 MB
//   (z in, q out, idx out) for 0.27 GFLOP, so bytes bound it, at ~5 us.
//   z32 encode at batch 512 (N = 524288, D = 64, K = 512): 34 GFLOP against
//   0.27 GB, so the fp32 FMA rate bounds it, at ~0.5 ms.
//
// Design, simple first: one thread owns one z row, held in registers. Each
// block stages the codebook in shared memory, kChunk codes at a time, with
// their squared norms, and every thread walks the codes in index order. All
// threads of a warp read the same code at once (a shared-memory broadcast)
// and keep a running minimum with a strict '<', which gives ties to the
// lowest index. The ragged end of N is masked. The kernel launches on the
// caller's stream, allocates nothing and does not synchronise.
//
// Plain C interface, loaded with ctypes (see ops/_build.py and ops/vq.py).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // rows per block
constexpr int kChunk = 64;     // codes staged in shared memory at a time

template <int D>
__global__ void __launch_bounds__(kThreads)
vq_lookup_kernel(const float* __restrict__ z,
                 const float* __restrict__ codebook,
                 float* __restrict__ q, int32_t* __restrict__ idx,
                 int n, int k) {
  static_assert(D % 4 == 0, "D must be a multiple of 4");
  constexpr int V = D / 4;  // float4 per row
  // kChunk * D floats: 16 KB at D = 64, inside the 48 KB of static
  // shared memory a block may use without an opt-in.
  __shared__ float4 s_code[kChunk * V];
  __shared__ float s_norm[kChunk];

  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const bool live = row < n;

  float zr[D];
  if (live) {
    const float4* zp = reinterpret_cast<const float4*>(z + row * D);
#pragma unroll
    for (int j = 0; j < V; ++j) {
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

  float best = __int_as_float(0x7f800000);  // +inf
  int best_k = 0;
  for (int k0 = 0; k0 < k; k0 += kChunk) {
    const int kc = min(kChunk, k - k0);
    __syncthreads();  // every thread is done with the previous chunk
    const float4* src =
        reinterpret_cast<const float4*>(codebook + static_cast<int64_t>(k0) * D);
    for (int i = threadIdx.x; i < kc * V; i += kThreads) s_code[i] = src[i];
    __syncthreads();
    for (int c = threadIdx.x; c < kc; c += kThreads) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float4 e = s_code[c * V + j];
        s = fmaf(e.x, e.x, s);
        s = fmaf(e.y, e.y, s);
        s = fmaf(e.z, e.z, s);
        s = fmaf(e.w, e.w, s);
      }
      s_norm[c] = s;
    }
    __syncthreads();
    for (int c = 0; c < kc; ++c) {
      float dot = 0.0f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float4 e = s_code[c * V + j];
        dot = fmaf(zr[4 * j + 0], e.x, dot);
        dot = fmaf(zr[4 * j + 1], e.y, dot);
        dot = fmaf(zr[4 * j + 2], e.z, dot);
        dot = fmaf(zr[4 * j + 3], e.w, dot);
      }
      const float dist = s_norm[c] - 2.0f * dot;
      if (dist < best) {
        best = dist;
        best_k = k0 + c;
      }
    }
  }

  if (live) {
    idx[row] = best_k;
    const float4* e = reinterpret_cast<const float4*>(
        codebook + static_cast<int64_t>(best_k) * D);
    float4* qp = reinterpret_cast<float4*>(q + row * D);
#pragma unroll
    for (int j = 0; j < V; ++j) qp[j] = e[j];
  }
}

template <int D>
int launch(const float* z, const float* codebook, float* q, int32_t* idx,
           int n, int k, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  vq_lookup_kernel<D><<<blocks, kThreads, 0, stream>>>(z, codebook, q, idx,
                                                       n, k);
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
    case 16: return launch<16>(zf, ef, qf, ip, n, k, s);
    case 64: return launch<64>(zf, ef, qf, ip, n, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
