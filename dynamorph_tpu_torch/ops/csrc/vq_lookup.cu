// Nearest-codebook search for the VQ-VAE, for Hopper (sm_90a): two kernels
// that compute the same distances and pick the same codes, with two designs.
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
// vq_lookup_kernel, the simple design: one thread owns one z row, held in
// registers. Each block stages the codebook in shared memory, kChunk codes
// at a time, with their squared norms, and every thread walks the codes in
// index order. All threads of a warp read the same code at once (a
// shared-memory broadcast) and keep a running minimum with a strict '<',
// which gives ties to the lowest index. Each thread runs one dependent FMA
// chain, and every 4 FMAs cost one shared-memory load, so it reaches about
// a third of the fp32 rate.
//
// vq_indices_kernel, register-tiled like a small SGEMM with an argmin
// epilogue: a block of kTileThreads threads takes kTileRows z rows, and each
// thread owns a micro-tile of kRowsPerThread rows x kCodesPerThread codes,
// 32 independent accumulators, so each float4 read from shared memory feeds
// 4 to 8 FMAs and the FMA latency is hidden within the thread. The z tile
// stays in shared memory for the whole search; the codebook streams through
// a double buffer of kTileCodes-code chunks. Both arrive by cp.async (16 B a
// thread, neighbouring threads on neighbouring addresses), so the next
// chunk loads while this one is searched. Rows are padded by kPad floats,
// so that the 8 threads of a quarter warp read 8 codes on distinct banks.
//
// Why the two kernels pick the same codes, bit for bit, by construction:
//   - every (row, code) dot product is the same chain in both: acc = 0.0f,
//     then acc = fmaf(z[d], e[d], acc) for d = 0, 1, ..., D - 1 in order;
//   - every code norm is the same chain: sq = fmaf(e[d], e[d], sq) in order;
//   - the distance is the same expression, norm - 2.0f * dot: 2 dot is
//     exact, so contracting it into an FMA changes nothing below overflow;
//   - vq_lookup takes codes in index order with a strict '<'. A vq_indices
//     thread takes its own codes in index order with a strict '<' from
//     (+inf, 0), and the threads that share a row merge their (dist, k)
//     pairs by the lexicographic minimum: the first minimum again. A row
//     whose distances are all NaN or +inf keeps index 0 in both;
//   - ops/_build.NVCC_FLAGS holds no --use_fast_math, -ftz=true or -prec-*
//     flag (tests/test_torch_vq.py checks it).
// Both kernels mask the ragged ends of N and K, launch on the caller's
// stream, allocate nothing and do not synchronise.
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

// ---- vq_indices: the register-tiled search

constexpr int kTileThreads = 256;
constexpr int kRowsPerThread = 8;
constexpr int kCodesPerThread = 4;
// The threads that share rows, one per code group, are neighbouring lanes
// of one warp: 16, a half warp.
constexpr int kCodeGroups = 16;
constexpr int kRowGroups = kTileThreads / kCodeGroups;
constexpr int kTileRows = kRowGroups * kRowsPerThread;     // 128 z rows
constexpr int kTileCodes = kCodeGroups * kCodesPerThread;  // 64 codes a chunk
constexpr int kPad = 4;             // floats after each row in shared memory
constexpr int kMinBlocks = 2;       // resident blocks an SM: <= 128 registers
static_assert(32 % kCodeGroups == 0, "the row merge shuffles within a warp");
static_assert(kTileCodes <= kTileThreads, "one thread per code norm");

// Dynamic shared memory: the z tile, two code chunks and one chunk's norms,
// row-major with kPad floats after each row. 69,888 bytes at D = 64.
template <int D>
struct Tile {
  static constexpr int kStride = D + kPad;
  static constexpr int kZ = kTileRows * kStride;
  static constexpr int kCodes = kTileCodes * kStride;
  static constexpr int kBytes =
      (kZ + 2 * kCodes + kTileCodes) * static_cast<int>(sizeof(float));
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start the copy of codes [k0, k0 + kTileCodes) into dst; codes at or past
// k are not copied (the search masks them).
template <int D>
__device__ __forceinline__ void load_codes(float* dst,
                                           const float* __restrict__ codebook,
                                           int k0, int k) {
  constexpr int V = D / 4;
  for (int f = threadIdx.x; f < kTileCodes * V; f += kTileThreads) {
    const int c = f / V, q = f % V;
    if (k0 + c < k)
      cp_async16(dst + c * Tile<D>::kStride + 4 * q,
                 codebook + static_cast<int64_t>(k0 + c) * D + 4 * q);
  }
}

template <int D>
__global__ void __launch_bounds__(kTileThreads, kMinBlocks)
vq_indices_kernel(const float* __restrict__ z,
                  const float* __restrict__ codebook,
                  int32_t* __restrict__ idx, int n, int k) {
  static_assert(D % 4 == 0, "D must be a multiple of 4");
  using T = Tile<D>;
  constexpr int V = D / 4;
  extern __shared__ float4 smem4[];
  float* zs = reinterpret_cast<float*>(smem4);
  float* codes = zs + T::kZ;          // two buffers of T::kCodes floats
  float* norm = codes + 2 * T::kCodes;

  // this thread's codes of a chunk are cg + kCodeGroups j, and its rows of
  // the tile rg + kRowGroups i: the lanes of a warp read neighbouring rows
  // and codes, kPad floats apart in banks, so no two collide
  const int cg = threadIdx.x % kCodeGroups;
  const int rg = threadIdx.x / kCodeGroups;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTileRows;
  const int64_t left = static_cast<int64_t>(n) - row0;
  const int rows = left < kTileRows ? static_cast<int>(left) : kTileRows;

  for (int f = threadIdx.x; f < kTileRows * V; f += kTileThreads) {
    const int r = f / V, q = f % V;
    if (r < rows)
      cp_async16(zs + r * T::kStride + 4 * q, z + (row0 + r) * D + 4 * q);
  }
  load_codes<D>(codes, codebook, 0, k);
  cp_async_commit();

  float best[kRowsPerThread];
  int best_k[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    best[i] = __int_as_float(0x7f800000);  // +inf
    best_k[i] = 0;
  }

  const int chunks = (k + kTileCodes - 1) / kTileCodes;
  for (int c = 0; c < chunks; ++c) {
    const int k0 = c * kTileCodes;
    const float* e = codes + (c & 1) * T::kCodes;
    // chunk c (and, at c = 0, the z tile) has landed, and every thread is
    // done with chunk c - 1: its buffer and the norms may be overwritten
    cp_async_wait_all();
    __syncthreads();
    if (c + 1 < chunks)
      load_codes<D>(codes + ((c + 1) & 1) * T::kCodes, codebook,
                    k0 + kTileCodes, k);
    cp_async_commit();

    if (threadIdx.x < kTileCodes) {
      const float* ec = e + threadIdx.x * T::kStride;
      float sq = 0.0f;
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(ec + 4 * q);
        sq = fmaf(v.x, v.x, sq);
        sq = fmaf(v.y, v.y, sq);
        sq = fmaf(v.z, v.z, sq);
        sq = fmaf(v.w, v.w, sq);
      }
      norm[threadIdx.x] = sq;
    }

    float acc[kRowsPerThread][kCodesPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kCodesPerThread; ++j) acc[i][j] = 0.0f;
#pragma unroll
    for (int q = 0; q < V; ++q) {
      float4 ev[kCodesPerThread];
#pragma unroll
      for (int j = 0; j < kCodesPerThread; ++j)
        ev[j] = *reinterpret_cast<const float4*>(
            e + (cg + kCodeGroups * j) * T::kStride + 4 * q);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float4 zv = *reinterpret_cast<const float4*>(
            zs + (rg + kRowGroups * i) * T::kStride + 4 * q);
#pragma unroll
        for (int j = 0; j < kCodesPerThread; ++j) {
          acc[i][j] = fmaf(zv.x, ev[j].x, acc[i][j]);
          acc[i][j] = fmaf(zv.y, ev[j].y, acc[i][j]);
          acc[i][j] = fmaf(zv.z, ev[j].z, acc[i][j]);
          acc[i][j] = fmaf(zv.w, ev[j].w, acc[i][j]);
        }
      }
    }
    __syncthreads();  // the norms are written

    // this thread's codes in increasing index order, strict '<'
#pragma unroll
    for (int j = 0; j < kCodesPerThread; ++j) {
      const int c_local = cg + kCodeGroups * j;
      if (k0 + c_local < k) {
        const float sq = norm[c_local];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const float dist = sq - 2.0f * acc[i][j];
          if (dist < best[i]) {
            best[i] = dist;
            best_k[i] = k0 + c_local;
          }
        }
      }
    }
  }

  // The kCodeGroups lanes that share rows merge their first minima by the
  // lexicographic minimum of (dist, k). Each lane ends with every row's
  // result, and lane cg writes the rows i with i % kCodeGroups == cg.
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
    for (int off = kCodeGroups / 2; off > 0; off >>= 1) {
      const float other = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int other_k = __shfl_xor_sync(0xffffffffu, best_k[i], off);
      if (other < best[i] || (other == best[i] && other_k < best_k[i])) {
        best[i] = other;
        best_k[i] = other_k;
      }
    }
    const int r = rg + kRowGroups * i;
    if (cg == i % kCodeGroups && r < rows) idx[row0 + r] = best_k[i];
  }
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
  constexpr int bytes = Tile<D>::kBytes;
  // above 48 KB only after an opt-in, which is per device: set it at every
  // launch (a host-side attribute write, no device work)
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        vq_indices_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = static_cast<int>(
      (static_cast<int64_t>(n) + kTileRows - 1) / kTileRows);
  vq_indices_kernel<D><<<blocks, kTileThreads, bytes, stream>>>(
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

// The dynamic shared memory of one vq_indices block at latent width d, in
// bytes (0 for a width the kernel is not built for).
extern "C" int vq_indices_smem_bytes(int d) {
  switch (d) {
    case 16: return Tile<16>::kBytes;
    case 64: return Tile<64>::kBytes;
    default: return 0;
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
