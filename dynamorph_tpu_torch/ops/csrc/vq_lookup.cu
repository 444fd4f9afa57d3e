// Nearest-codebook search for the VQ-VAE, for Hopper (sm_90a): three
// kernels that compute the same distances and pick the same codes.
//
// What each replaces:
//   vq_lookup_kernel (entry vq_lookup_f32) replaces the TPU kernel
//   dynamorph_tpu/ops/vq.py::_vq_kernel (launched by _vq_pallas), used by the
//   encode path and the eval steps: indices and q = E[idx].
//   vq_indices_kernel (entry vq_indices_f32) replaces
//   dynamorph_tpu/ops/vq.py::_vq_kernel_idx (built by _make_vq_kernel_idx,
//   launched by _vq_pallas_idx, body :152-164), used once per training step:
//   indices only (the training path re-gathers the rows differentiably).
//   vq_lookup_rowwise_kernel (entry vq_lookup_rowwise_f32) is a test oracle
//   and replaces nothing: the first, one-thread-a-row design of the lookup,
//   off every path of the package, kept as the independent check that the
//   tiled lookup's codes and q are right bit for bit, and as its before-time.
// For each latent row z of D floats all three find
//     idx = argmin_k ( ||E_k||^2 - 2 z . E_k )
// in IEEE fp32 (FMAs on the CUDA cores, no TF32), the first minimum winning
// as in torch.argmin and jnp.argmin. The lookups also write q = E[idx],
// copied bit for bit from the codebook. ||z||^2 is constant along a row and
// cannot change the argmin, so it is dropped, as in the TPU kernels. Every
// precision string of the JAX package ("default", "high", "highest") maps to
// this fp32 arithmetic, at least as exact as HIGHEST.
//
// What bounds them on an H100 SXM (3.35 TB/s; 67 TFLOP/s fp32 outside the
// tensor cores):
//   vq_lookup, z16 encode at batch 512 (N = 131072, D = 16, K = 64): it
//   moves 4 (2 N D + K D + N) = 17.3 MB (z in, q and idx out), 0.005166 ms,
//   for 2 N K D = 0.27 GFLOP, 0.004 ms: bytes bound it, and the FMAs alone
//   need three quarters of that time, so both have to run near their peaks.
//   vq_lookup, z32 encode at batch 512 (N = 524288, D = 64, K = 512): 34.4
//   GFLOP, 0.512833 ms, against 0.27 GB, 0.08 ms: operations bound it.
//   vq_indices, z32 training at batch 768 (N = 786432, D = 64, K = 512): it
//   moves 4 (N D + K D + N) = 204.6 MB, 0.061 ms, for 51.5 GFLOP, 0.769 ms:
//   operations bound it.
//
// The tiled search (vq_lookup_kernel and vq_indices_kernel share it,
// tiled_search below), register-tiled like a small SGEMM with an argmin
// epilogue: a block of T::kThreads threads takes T::kTileRows z rows, and
// each thread owns a micro-tile of T::kRowsPerThread rows x
// T::kCodesPerThread codes, independent accumulators, so each float4 read
// from shared memory feeds 4 to 8 FMAs and the FMA latency is hidden within
// the thread: this is what the fp32 bound at z32 asks for. The z tile stays
// in shared memory for the whole search; the codebook streams through a
// double buffer of T::kTileCodes-code chunks. Both arrive by cp.async (16 B
// a thread, neighbouring threads on neighbouring addresses), so the next
// chunk loads while this one is searched. Rows are padded by kPad floats, so
// that the 8 threads of a quarter warp read 8 codes on distinct banks.
//
// The lookup's q epilogue, coalesced, for the byte bound at z16: after the
// row merge the block's winning indices go to shared memory (over the z
// tile, free once the search ends), idx is stored from there as one
// contiguous run of the block's rows, and then all threads copy the q tile,
// codebook[idx[r]] for the block's rows, with 16-byte loads through the
// read-only path (the codebook, at most 128 KB, stays in L2) and 16-byte
// stores, neighbouring threads on neighbouring addresses of q. So z is read
// and q and idx written in full 16-byte pieces, coalesced, where the
// row-wise design strides each access by the row width.
//
// The z16 instance takes its own constants (kZ16*). At D = 16 a (row, code)
// pair is only 16 FMAs, and the argmin (4 instructions a pair) and the row
// merge (shuffle rounds) cost about as much again as the FMAs with the
// shared tile (16 lanes a row): on an H100 SXM at 700 W, cutting the search
// out of the z16 lookup takes it from 0.018 to 0.007 ms, cutting the z load
// or the q copy 0.001 ms each (ops/vq_tile_sweep.py --lookup, whose
// ablations do just that). So a thread there takes 4 rows x 16 codes and
// 4 lanes share a row (2 shuffle rounds, not 4), and the grid is persistent
// (persistent_lookup): 2 blocks an SM walk the tiles, the next z tile
// loading while this one is searched, the single 64-code chunk and its
// norms loaded once a block.
//
// Why the three kernels pick the same codes, bit for bit, by construction:
//   - every (row, code) dot product is the same chain in all: acc = 0.0f,
//     then acc = fmaf(z[d], e[d], acc) for d = 0, 1, ..., D - 1 in order;
//   - every code norm is the same chain: sq = fmaf(e[d], e[d], sq) in order;
//   - the distance is the same expression, norm - 2.0f * dot: 2 dot is
//     exact, so contracting it into an FMA changes nothing below overflow;
//   - the row-wise kernel takes codes in index order with a strict '<'. A
//     tiled thread takes its own codes in index order with a strict '<' from
//     (+inf, 0), and the threads that share a row merge their (dist, k)
//     pairs by the lexicographic minimum: the first minimum again, for any
//     tile shape. A row whose distances are all NaN or +inf keeps index 0;
//   - ops/_build.NVCC_FLAGS holds no --use_fast_math, -ftz=true or -prec-*
//     flag (tests/test_torch_vq.py checks it).
// All kernels mask the ragged ends of N and K, launch on the caller's
// stream, allocate nothing and do not synchronise.
//
// Plain C interface, loaded with ctypes (see ops/_build.py and ops/vq.py).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ---- vq_lookup_rowwise: the test oracle, one thread a row

constexpr int kRowwiseThreads = 128;  // rows per block
constexpr int kChunk = 64;            // codes staged in shared memory at a time

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
    for (int i = threadIdx.x; i < kc * V; i += kRowwiseThreads)
      s.code[i] = src[i];
    __syncthreads();
    for (int c = threadIdx.x; c < kc; c += kRowwiseThreads) {
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
__global__ void __launch_bounds__(kRowwiseThreads)
vq_lookup_rowwise_kernel(const float* __restrict__ z,
                         const float* __restrict__ codebook,
                         float* __restrict__ q, int32_t* __restrict__ idx,
                         int n, int k) {
  __shared__ Staging<D> s;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowwiseThreads +
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

// ---- the tiled search of vq_indices and vq_lookup

// vq_indices at both widths, and vq_lookup at D = 64
constexpr int kTileThreads = 256;
constexpr int kRowsPerThread = 8;
constexpr int kCodesPerThread = 4;
// The threads that share rows, one per code group, are neighbouring lanes
// of one warp: 16, a half warp.
constexpr int kCodeGroups = 16;
constexpr int kMinBlocks = 2;       // resident blocks an SM: <= 128 registers
// vq_lookup at D = 64: 1 for a persistent grid (see persistent_lookup)
constexpr int kZ32Persistent = 0;
// vq_lookup at D = 16 (z16: K = 64, a single chunk): 4 lanes share a row,
// so the row merge is 2 shuffle rounds where 16 lanes take 4
constexpr int kZ16Threads = 256;
constexpr int kZ16RowsPerThread = 4;
constexpr int kZ16CodesPerThread = 16;
constexpr int kZ16CodeGroups = 4;
constexpr int kZ16MinBlocks = 2;
constexpr int kZ16Persistent = 1;
constexpr int kPad = 4;             // floats after each row in shared memory

// One tile shape at latent width D. Dynamic shared memory: the z tile (two
// for a persistent grid), two code chunks and one chunk's norms, row-major
// with kPad floats after each row (69,888 bytes for vq_indices at D = 64).
template <int Dim, int Threads, int Rows, int Codes, int Groups, int Blocks,
          int Persistent = 0>
struct Tiling {
  static constexpr int D = Dim;
  static constexpr int kThreads = Threads;
  static constexpr int kRowsPerThread = Rows;
  static constexpr int kCodesPerThread = Codes;
  static constexpr int kCodeGroups = Groups;
  static constexpr int kMinBlocks = Blocks;
  static constexpr bool kPersistent = Persistent != 0;
  static constexpr int kRowGroups = kThreads / kCodeGroups;
  static constexpr int kTileRows = kRowGroups * kRowsPerThread;
  static constexpr int kTileCodes = kCodeGroups * kCodesPerThread;
  static constexpr int kStride = D + kPad;
  static constexpr int kZ = kTileRows * kStride;
  static constexpr int kCodes = kTileCodes * kStride;
  static constexpr int kBytes =
      ((kPersistent ? 2 : 1) * kZ + 2 * kCodes + kTileCodes) *
      static_cast<int>(sizeof(float));
  static_assert(D % 4 == 0, "D must be a multiple of 4");
  static_assert(32 % kCodeGroups == 0, "the row merge shuffles within a warp");
  static_assert(kThreads % 32 == 0, "whole warps");
  static_assert(kTileCodes <= kThreads, "one thread per code norm");
};

template <int D>
using Tile = Tiling<D, kTileThreads, kRowsPerThread, kCodesPerThread,
                    kCodeGroups, kMinBlocks>;

template <int D>
struct LookupTiling {
  using T = Tiling<D, kTileThreads, kRowsPerThread, kCodesPerThread,
                   kCodeGroups, kMinBlocks, kZ32Persistent>;
};
template <>
struct LookupTiling<16> {
  using T = Tiling<16, kZ16Threads, kZ16RowsPerThread, kZ16CodesPerThread,
                   kZ16CodeGroups, kZ16MinBlocks, kZ16Persistent>;
};
template <int D>
using LookupTile = typename LookupTiling<D>::T;

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

// Start the copy of z rows [row0, row0 + rows) into the tile zs; the rows
// past them are not copied (the epilogue never stores them).
template <class T>
__device__ __forceinline__ void load_z(float* zs, const float* __restrict__ z,
                                       int64_t row0, int rows) {
  constexpr int V = T::D / 4;
  for (int f = threadIdx.x; f < T::kTileRows * V; f += T::kThreads) {
    const int r = f / V, q = f % V;
    if (r < rows)
      cp_async16(zs + r * T::kStride + 4 * q, z + (row0 + r) * T::D + 4 * q);
  }
}

// Start the copy of codes [k0, k0 + T::kTileCodes) into dst; codes at or
// past k are not copied (the search masks them).
template <class T>
__device__ __forceinline__ void load_codes(float* dst,
                                           const float* __restrict__ codebook,
                                           int k0, int k) {
  constexpr int V = T::D / 4;
  for (int f = threadIdx.x; f < T::kTileCodes * V; f += T::kThreads) {
    const int c = f / V, q = f % V;
    if (k0 + c < k)
      cp_async16(dst + c * T::kStride + 4 * q,
                 codebook + static_cast<int64_t>(k0 + c) * T::D + 4 * q);
  }
}

// The rows of the tile that starts at row0: T::kTileRows, fewer at the end.
template <class T>
__device__ __forceinline__ int tile_rows(int n, int64_t row0) {
  const int64_t left = static_cast<int64_t>(n) - row0;
  return left < T::kTileRows ? static_cast<int>(left) : T::kTileRows;
}

// The squared norms of the chunk's codes e, by the first T::kTileCodes
// threads, into norm.
template <class T>
__device__ __forceinline__ void chunk_norms(const float* e, float* norm) {
  constexpr int V = T::D / 4;
  if (threadIdx.x < T::kTileCodes) {
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
}

// One chunk of codes e (codes k0 ...) against this thread's rows of the z
// tile zs: the dot products, a barrier (after which the chunk's norms,
// written before the call, may be read), and the running first minimum of
// each row over this thread's codes in increasing index order, strict '<'.
template <class T>
__device__ __forceinline__ void search_chunk(const float* zs, const float* e,
                                             const float* norm, int k0, int k,
                                             int cg, int rg,
                                             float (&best)[T::kRowsPerThread],
                                             int (&best_k)[T::kRowsPerThread]) {
  constexpr int V = T::D / 4;
  float acc[T::kRowsPerThread][T::kCodesPerThread];
#pragma unroll
  for (int i = 0; i < T::kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < T::kCodesPerThread; ++j) acc[i][j] = 0.0f;
#pragma unroll
  for (int q = 0; q < V; ++q) {
    float4 ev[T::kCodesPerThread];
#pragma unroll
    for (int j = 0; j < T::kCodesPerThread; ++j)
      ev[j] = *reinterpret_cast<const float4*>(
          e + (cg + T::kCodeGroups * j) * T::kStride + 4 * q);
#pragma unroll
    for (int i = 0; i < T::kRowsPerThread; ++i) {
      const float4 zv = *reinterpret_cast<const float4*>(
          zs + (rg + T::kRowGroups * i) * T::kStride + 4 * q);
#pragma unroll
      for (int j = 0; j < T::kCodesPerThread; ++j) {
        acc[i][j] = fmaf(zv.x, ev[j].x, acc[i][j]);
        acc[i][j] = fmaf(zv.y, ev[j].y, acc[i][j]);
        acc[i][j] = fmaf(zv.z, ev[j].z, acc[i][j]);
        acc[i][j] = fmaf(zv.w, ev[j].w, acc[i][j]);
      }
    }
  }
  __syncthreads();  // the norms are written

#pragma unroll
  for (int j = 0; j < T::kCodesPerThread; ++j) {
    const int c_local = cg + T::kCodeGroups * j;
    if (k0 + c_local < k) {
      const float sq = norm[c_local];
#pragma unroll
      for (int i = 0; i < T::kRowsPerThread; ++i) {
        const float dist = sq - 2.0f * acc[i][j];
        if (dist < best[i]) {
          best[i] = dist;
          best_k[i] = k0 + c_local;
        }
      }
    }
  }
}

// The kCodeGroups lanes that share row i merge their first minima by the
// lexicographic minimum of (dist, k); every lane ends with the row's result.
template <class T>
__device__ __forceinline__ void merge_row(float (&best)[T::kRowsPerThread],
                                          int (&best_k)[T::kRowsPerThread],
                                          int i) {
#pragma unroll
  for (int off = T::kCodeGroups / 2; off > 0; off >>= 1) {
    const float other = __shfl_xor_sync(0xffffffffu, best[i], off);
    const int other_k = __shfl_xor_sync(0xffffffffu, best_k[i], off);
    if (other < best[i] || (other == best[i] && other_k < best_k[i])) {
      best[i] = other;
      best_k[i] = other_k;
    }
  }
}

// Merge every row and put its index in sidx (shared memory), lane cg the
// rows i with i % kCodeGroups == cg; then, after a barrier, store idx from
// sidx as one contiguous run and copy the q tile: q rows row0 .. row0 +
// rows - 1 are one run of rows * V float4, and thread f copies float4 f,
// part c of row r, from codebook[sidx[r]] through the read-only path.
template <class T>
__device__ __forceinline__ void store_lookup(
    int* sidx, float (&best)[T::kRowsPerThread],
    int (&best_k)[T::kRowsPerThread], int cg, int rg,
    const float* __restrict__ codebook, float* __restrict__ q_out,
    int32_t* __restrict__ idx, int64_t row0, int rows) {
  constexpr int V = T::D / 4;
#pragma unroll
  for (int i = 0; i < T::kRowsPerThread; ++i) {
    merge_row<T>(best, best_k, i);
    const int r = rg + T::kRowGroups * i;
    if (cg == i % T::kCodeGroups && r < rows) sidx[r] = best_k[i];
  }
  __syncthreads();  // the block's indices are in sidx
  for (int r = threadIdx.x; r < rows; r += T::kThreads)
    idx[row0 + r] = sidx[r];
  const float4* cb4 = reinterpret_cast<const float4*>(codebook);
  float4* q4 = reinterpret_cast<float4*>(q_out + row0 * T::D);
  for (int f = threadIdx.x; f < rows * V; f += T::kThreads) {
    const int r = f / V, c = f % V;
    q4[f] = __ldg(cb4 + static_cast<int64_t>(sidx[r]) * V + c);
  }
}

template <class T>
__device__ __forceinline__ void reset(float (&best)[T::kRowsPerThread],
                                      int (&best_k)[T::kRowsPerThread]) {
#pragma unroll
  for (int i = 0; i < T::kRowsPerThread; ++i) {
    best[i] = __int_as_float(0x7f800000);  // +inf
    best_k[i] = 0;
  }
}

// The search of one block of T::kTileRows rows, then its epilogue: idx only
// (kWriteQ false, vq_indices), or idx and q (vq_lookup), with the indices
// in shared memory over the z tile (every thread passed the chunk loop's
// last barrier after its last read of zs).
template <class T, bool kWriteQ>
__device__ __forceinline__ void tiled_search(
    const float* __restrict__ z, const float* __restrict__ codebook,
    float* __restrict__ q_out, int32_t* __restrict__ idx, int n, int k) {
  extern __shared__ float4 smem4[];
  float* zs = reinterpret_cast<float*>(smem4);
  float* codes = zs + T::kZ;          // two buffers of T::kCodes floats
  float* norm = codes + 2 * T::kCodes;

  // this thread's codes of a chunk are cg + kCodeGroups j, and its rows of
  // the tile rg + kRowGroups i: the lanes of a warp read neighbouring rows
  // and codes, kPad floats apart in banks, so no two collide
  const int cg = threadIdx.x % T::kCodeGroups;
  const int rg = threadIdx.x / T::kCodeGroups;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * T::kTileRows;
  const int rows = tile_rows<T>(n, row0);

  load_z<T>(zs, z, row0, rows);
  load_codes<T>(codes, codebook, 0, k);
  cp_async_commit();

  float best[T::kRowsPerThread];
  int best_k[T::kRowsPerThread];
  reset<T>(best, best_k);

  const int chunks = (k + T::kTileCodes - 1) / T::kTileCodes;
  for (int c = 0; c < chunks; ++c) {
    const int k0 = c * T::kTileCodes;
    const float* e = codes + (c & 1) * T::kCodes;
    // chunk c (and, at c = 0, the z tile) has landed, and every thread is
    // done with chunk c - 1: its buffer and the norms may be overwritten
    cp_async_wait_all();
    __syncthreads();
    if (c + 1 < chunks)
      load_codes<T>(codes + ((c + 1) & 1) * T::kCodes, codebook,
                    k0 + T::kTileCodes, k);
    cp_async_commit();
    chunk_norms<T>(e, norm);
    search_chunk<T>(zs, e, norm, k0, k, cg, rg, best, best_k);
  }

  if constexpr (kWriteQ) {
    store_lookup<T>(reinterpret_cast<int*>(zs), best, best_k, cg, rg,
                    codebook, q_out, idx, row0, rows);
  } else {
    // lane cg stores the rows i with i % kCodeGroups == cg
#pragma unroll
    for (int i = 0; i < T::kRowsPerThread; ++i) {
      merge_row<T>(best, best_k, i);
      const int r = rg + T::kRowGroups * i;
      if (cg == i % T::kCodeGroups && r < rows) idx[row0 + r] = best_k[i];
    }
  }
}

// The lookup on a persistent grid: block b takes the tiles b, b + gridDim.x,
// ..., with two z tiles in shared memory, so that the next tile's rows load
// while this one is searched and its q stored. Where the codebook is one
// chunk (k <= T::kTileCodes, as at z16) it is copied, and its norms
// computed, once per block; otherwise its chunks stream as in tiled_search,
// the first chunk of the next tile loading with its rows. The indices go to
// shared memory over the tile just searched: the next tile's rows go to the
// other buffer, and the tile after that is copied only after the next
// tile's first barrier, which every thread reaches after its q copy.
template <class T>
__device__ __forceinline__ void persistent_lookup(
    const float* __restrict__ z, const float* __restrict__ codebook,
    float* __restrict__ q_out, int32_t* __restrict__ idx, int n, int k) {
  extern __shared__ float4 smem4[];
  float* zbuf = reinterpret_cast<float*>(smem4);  // two tiles of T::kZ floats
  float* codes = zbuf + 2 * T::kZ;    // two buffers of T::kCodes floats
  float* norm = codes + 2 * T::kCodes;

  const int cg = threadIdx.x % T::kCodeGroups;
  const int rg = threadIdx.x / T::kCodeGroups;
  const int tiles = static_cast<int>(
      (static_cast<int64_t>(n) + T::kTileRows - 1) / T::kTileRows);
  const int chunks = (k + T::kTileCodes - 1) / T::kTileCodes;
  const bool resident = chunks == 1;

  int tile = blockIdx.x;
  load_z<T>(zbuf, z, static_cast<int64_t>(tile) * T::kTileRows,
            tile_rows<T>(n, static_cast<int64_t>(tile) * T::kTileRows));
  load_codes<T>(codes, codebook, 0, k);
  cp_async_commit();

  float best[T::kRowsPerThread];
  int best_k[T::kRowsPerThread];
  int buf = 0;       // this tile's z buffer
  int chunk_buf = 0;  // this chunk's code buffer
  for (bool first = true; tile < tiles; first = false) {
    const int64_t row0 = static_cast<int64_t>(tile) * T::kTileRows;
    const int rows = tile_rows<T>(n, row0);
    const int next = tile + gridDim.x;
    float* zs = zbuf + buf * T::kZ;
    reset<T>(best, best_k);
    for (int c = 0; c < chunks; ++c) {
      const int k0 = c * T::kTileCodes;
      const float* e = codes + chunk_buf * T::kCodes;
      // this tile's rows and chunk c have landed, and every thread is done
      // with the previous chunk and the previous tile's q copy
      cp_async_wait_all();
      __syncthreads();
      if (c + 1 < chunks) {
        load_codes<T>(codes + (chunk_buf ^ 1) * T::kCodes, codebook,
                      k0 + T::kTileCodes, k);
      } else if (next < tiles) {
        const int64_t next0 = static_cast<int64_t>(next) * T::kTileRows;
        load_z<T>(zbuf + (buf ^ 1) * T::kZ, z, next0, tile_rows<T>(n, next0));
        if (!resident)
          load_codes<T>(codes + (chunk_buf ^ 1) * T::kCodes, codebook, 0, k);
      }
      cp_async_commit();
      if (!resident || first) chunk_norms<T>(e, norm);
      search_chunk<T>(zs, e, norm, k0, k, cg, rg, best, best_k);
      if (!resident) chunk_buf ^= 1;
    }
    store_lookup<T>(reinterpret_cast<int*>(zs), best, best_k, cg, rg,
                    codebook, q_out, idx, row0, rows);
    tile = next;
    buf ^= 1;
  }
}

template <int D>
__global__ void __launch_bounds__(kTileThreads, kMinBlocks)
vq_indices_kernel(const float* __restrict__ z,
                  const float* __restrict__ codebook,
                  int32_t* __restrict__ idx, int n, int k) {
  tiled_search<Tile<D>, false>(z, codebook, nullptr, idx, n, k);
}

template <int D>
__global__ void __launch_bounds__(LookupTile<D>::kThreads,
                                  LookupTile<D>::kMinBlocks)
vq_lookup_kernel(const float* __restrict__ z,
                 const float* __restrict__ codebook,
                 float* __restrict__ q, int32_t* __restrict__ idx,
                 int n, int k) {
  if constexpr (LookupTile<D>::kPersistent)
    persistent_lookup<LookupTile<D>>(z, codebook, q, idx, n, k);
  else
    tiled_search<LookupTile<D>, true>(z, codebook, q, idx, n, k);
}

// Dynamic shared memory above 48 KB needs an opt-in, which is per device:
// set it at every launch (a host-side attribute write, no device work).
template <class T, class Kernel>
cudaError_t opt_in(Kernel kernel) {
  if (T::kBytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kBytes);
}

template <class T>
int tiled_blocks(int n) {
  return static_cast<int>((static_cast<int64_t>(n) + T::kTileRows - 1) /
                          T::kTileRows);
}

template <int D>
int launch_rowwise(const float* z, const float* codebook, float* q,
                   int32_t* idx, int n, int k, cudaStream_t stream) {
  const int blocks = (n + kRowwiseThreads - 1) / kRowwiseThreads;
  vq_lookup_rowwise_kernel<D><<<blocks, kRowwiseThreads, 0, stream>>>(
      z, codebook, q, idx, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_lookup(const float* z, const float* codebook, float* q,
                  int32_t* idx, int n, int k, cudaStream_t stream) {
  using T = LookupTile<D>;
  cudaError_t err = opt_in<T>(vq_lookup_kernel<D>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = tiled_blocks<T>(n);
  if (T::kPersistent) {
    // kMinBlocks blocks on each SM of the current device, at most one a tile
    int device = 0, sms = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks > T::kMinBlocks * sms) blocks = T::kMinBlocks * sms;
  }
  vq_lookup_kernel<D><<<blocks, T::kThreads, T::kBytes, stream>>>(
      z, codebook, q, idx, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_indices(const float* z, const float* codebook, int32_t* idx,
                   int n, int k, cudaStream_t stream) {
  using T = Tile<D>;
  const cudaError_t err = opt_in<T>(vq_indices_kernel<D>);
  if (err != cudaSuccess) return static_cast<int>(err);
  vq_indices_kernel<D><<<tiled_blocks<T>(n), T::kThreads, T::kBytes,
                         stream>>>(z, codebook, idx, n, k);
  return static_cast<int>(cudaGetLastError());
}

typedef int (*LookupLaunch)(const float*, const float*, float*, int32_t*,
                            int, int, cudaStream_t);

int lookup_entry(LookupLaunch at16, LookupLaunch at64, const void* z,
                 const void* codebook, void* q, void* idx, int n, int d,
                 int k, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const LookupLaunch launch = d == 16 ? at16 : d == 64 ? at64 : nullptr;
  if (launch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(static_cast<const float*>(z),
                static_cast<const float*>(codebook), static_cast<float*>(q),
                static_cast<int32_t*>(idx), n, k,
                static_cast<cudaStream_t>(stream));
}

}  // namespace

// z (n, d) and codebook (k, d) fp32, row-major and 16-byte aligned; q (n, d)
// fp32 and idx (n,) int32 are written. d must be 16 (z16) or 64 (z32), the
// latent widths of the models (ops/vq.py checks this). Returns the
// cudaError_t of the launch.
extern "C" int vq_lookup_f32(const void* z, const void* codebook, void* q,
                             void* idx, int n, int d, int k, void* stream) {
  return lookup_entry(launch_lookup<16>, launch_lookup<64>, z, codebook, q,
                      idx, n, d, k, stream);
}

// As vq_lookup_f32, by the row-wise test oracle (one thread a row).
extern "C" int vq_lookup_rowwise_f32(const void* z, const void* codebook,
                                     void* q, void* idx, int n, int d, int k,
                                     void* stream) {
  return lookup_entry(launch_rowwise<16>, launch_rowwise<64>, z, codebook, q,
                      idx, n, d, k, stream);
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

// The same for one vq_lookup block.
extern "C" int vq_lookup_smem_bytes(int d) {
  switch (d) {
    case 16: return LookupTile<16>::kBytes;
    case 64: return LookupTile<64>::kBytes;
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
