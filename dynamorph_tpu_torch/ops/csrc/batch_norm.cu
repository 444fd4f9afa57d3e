// Training-mode batch norm of NCHW float32 activations, with an optional
// ReLU folded in, for Hopper (sm_90a): one kernel for the forward and one
// for the backward.
//
// What they replace: no TPU kernel. The JAX package leaves batch norm to
// XLA, which fuses it on the TPU (dynamorph_tpu/nn/functional.py); the
// port's first version ran torch's BatchNorm2d, i.e. cuDNN's NCHW
// per-channel kernels (bn_fw_tr_1C11, bn_bw_1C11), each followed by a
// separate ReLU (and its threshold_backward). Those spread 32-64 channels of
// 0.8-3.1 M elements over too few blocks and reached about a quarter of the
// card's bandwidth at the VQ-VAE's shapes.
//
//   batch_norm_fwd_kernel / batch_norm_relu_fwd_kernel (entry
//   batch_norm_fwd_f32): per channel c of x (n, c, h*w), the batch mean mu
//   and biased variance var over the n*h*w values; then
//       y = gamma[c] * (x - mu) * invstd + beta[c],  invstd = 1/sqrt(var+eps)
//   (the ReLU kernel writes max(y, 0), NaN passing as in torch.relu). It
//   writes mu and invstd (c floats each, saved for the backward) and updates
//   the running buffers as torch does: r_mean = (1 - m) r_mean + m mu,
//   r_var = (1 - m) r_var + m var n/(n-1), n the count a channel.
//   batch_norm_bwd_kernel / batch_norm_relu_bwd_kernel (entry
//   batch_norm_bwd_f32): from x, dy and the saved statistics,
//       dy' = dy, or 0 where the folded ReLU was off (rebuilt from x: the
//             same fp32 expression as the forward's, so the same bits),
//       dbeta = sum dy',  dgamma = sum dy' xhat,  xhat = (x - mu) invstd,
//       dx = gamma invstd (dy' - dbeta/M - xhat dgamma/M),  M = n h w.
//
// What bounds them on an H100 SXM (3.35 TB/s): bytes. A stats-then-apply
// forward reads x twice and writes y, 3 S for a tensor of S bytes; the
// backward reads x and dy twice and writes dx, 5 S. At the z32 training
// shapes (768, 32, 64, 64) and (768, 64, 32, 32) that is 1.21 GB and 0.60
// GB a forward, 2.01 GB and 1.01 GB a backward. The arithmetic is a few
// operations an element, far under the card's ~140 instructions for each
// 16 bytes it can read. The folded ReLU moves no bytes of its own: the
// separate ReLU read and wrote y, and its backward read y and dy and wrote a
// gradient, 5 S a ReLU'd batch norm that no longer moves.
//
// Design. Each kernel is one cooperative launch of a persistent grid: as
// many blocks of kThreads as fit on the card at once, with one grid-wide
// sync between its two passes, so a batch norm costs one launch each way.
// The n*c planes (h*w contiguous floats each) are taken channel-major and
// cut into one contiguous, equal run of planes a block; a run covers parts
// of one or a few channels ("segments"), so every channel is spread over
// many blocks along n and every block has the same bytes. Threads read
// 16-byte vectors (where h*w is a multiple of 4 and the tensors 16-byte
// aligned; one float at a time otherwise), kUnroll of them in flight a
// thread, neighbouring threads on neighbouring addresses. The second pass
// walks the run backwards, so it starts on the bytes the first pass read
// last, which are still in the 50 MB L2.
//
// Statistics. No one-pass E[x^2] - E[x]^2, which cancels when |mean| >>
// std. Each thread keeps Welford moments (count, mean, M2) in fp32,
// updated a 4-vector at a time by Chan's formula; a block combines its
// threads' moments in float64 (a fixed shuffle tree, then its warps in
// order) and writes one partial a segment. After the grid sync every block
// that needs a channel's statistics combines that channel's partials in
// float64 in the same fixed order (the blocks' order, a lane each, then a
// fixed shuffle tree), so all blocks get the same bits. The backward's sums
// are accumulated in float64 from the start and combined the same way. No
// float atomics anywhere: two runs on the same input are bit-equal.
//
// Plain C interface, loaded with ctypes (see ops/_build.py and
// ops/batch_norm.py). The kernels launch on the caller's stream, allocate
// nothing (the workspace comes from the caller) and do not synchronise.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;      // units (vectors or floats) in flight a thread
// Blocks an SM the registers must allow: 3 (85 registers a thread). At 4
// (64 registers) the kernels spilled and were 6% slower at z32's shapes on
// an H100 SXM.
constexpr int kMinBlocks = 3;

// x is (n, c, hw) contiguous; the grid's blocks share its planes
struct Layout {
  int n, c, hw;
  int planes;   // n * c
  int blocks;   // the grid's size, at most planes
};

struct FwdArgs {
  const float* x;
  const float* gamma;
  const float* beta;
  float* y;
  float* save_mean;
  float* save_invstd;
  float* running_mean;
  float* running_var;
  double* ws;   // 3 doubles a (block, channel) segment: (blocks + c) * 3
  Layout L;
  double momentum, eps;
};

struct BwdArgs {
  const float* x;
  const float* dy;
  const float* save_mean;
  const float* save_invstd;
  const float* gamma;
  const float* beta;
  float* dx;
  float* dgamma;
  float* dbeta;
  double* ws;   // 2 doubles a segment: (blocks + c) * 2
  Layout L;
};

// Block b takes the planes [first_plane(b), first_plane(b + 1)) of the
// channel-major order q = channel * n + sample.
__device__ __forceinline__ int first_plane(const Layout& L, int b) {
  return static_cast<int>(static_cast<int64_t>(b) * L.planes / L.blocks);
}

// The block whose run holds plane q: the largest b with first_plane(b) <= q.
__device__ __forceinline__ int block_of(const Layout& L, int q) {
  return static_cast<int>(((static_cast<int64_t>(q) + 1) * L.blocks +
                           L.planes - 1) / L.planes) - 1;
}

// The part of channel ch inside this block's run: samples [lo, hi).
struct Segment {
  int ch, lo, hi;
};

__device__ __forceinline__ Segment segment(const Layout& L, int q0, int q1,
                                           int ch) {
  const int base = ch * L.n;
  return {ch, max(q0 - base, 0), min(q1 - base, L.n)};
}

// Partial slot of (block b, channel ch). For blocks b1 < b2 the channels of
// b2 start where b1's end, so b + ch is one slot a pair: at most
// blocks + c - 1 slots.
__device__ __forceinline__ int slot(int b, int ch) { return b + ch; }

template <int V>
__device__ __forceinline__ void load(const float* __restrict__ p,
                                     float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store(float* __restrict__ p,
                                      const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// Calls visit(offsets, live) for this thread's units of a segment, kUnroll
// at a time, first to last or (kReverse) last to first. Unit j of the
// segment is V floats at plane lo + j / U, position (j % U) * V; a thread
// takes the units threadIdx.x + k * kThreads. ``offsets`` are in floats from
// the tensor's start.
template <int V, bool kReverse, class Visit>
__device__ __forceinline__ void for_units(const Layout& L, const Segment& s,
                                          Visit&& visit) {
  const int U = L.hw / V;
  const int units = (s.hi - s.lo) * U;
  const int t = threadIdx.x;
  const int count = units > t ? (units - t - 1) / kThreads + 1 : 0;
  const int batches = (count + kUnroll - 1) / kUnroll;
  const int64_t stride_n = static_cast<int64_t>(L.c) * L.hw;
  const int64_t base = static_cast<int64_t>(s.ch) * L.hw;
  for (int i = 0; i < batches; ++i) {
    const int m = kReverse ? batches - 1 - i : i;
    int64_t off[kUnroll];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = m * kUnroll + u;
      live[u] = k < count;
      const int j = live[u] ? t + k * kThreads : 0;
      const int p = j / U;
      off[u] = (s.lo + p) * stride_n + base +
               static_cast<int64_t>(j - p * U) * V;
    }
    visit(off, live);
  }
}

// ---- moments

struct Moments {
  double n, mean, m2;
};

// Chan's combination of two sets of moments (an empty side leaves the
// other).
__device__ __forceinline__ Moments chan(const Moments& a, const Moments& b) {
  if (b.n == 0.0) return a;
  if (a.n == 0.0) return b;
  const double n = a.n + b.n;
  const double d = b.mean - a.mean;
  const double r = b.n / n;
  return {n, a.mean + d * r, a.m2 + b.m2 + d * d * a.n * r};
}

// Welford in fp32: V more values into (cnt, mean, m2), as one set of V
// moments combined by Chan's formula (exact for an empty start).
template <int V>
__device__ __forceinline__ void welford(const float (&v)[V], float& cnt,
                                        float& mean, float& m2) {
  float vm, vm2 = 0.0f;
  if constexpr (V == 4) {
    vm = ((v[0] + v[1]) + (v[2] + v[3])) * 0.25f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float d = v[i] - vm;
      vm2 = fmaf(d, d, vm2);
    }
  } else {
    vm = v[0];
  }
  const float n = cnt + static_cast<float>(V);
  const float d = vm - mean;
  const float r = static_cast<float>(V) / n;
  mean = fmaf(d, r, mean);
  m2 += vm2 + d * d * cnt * r;
  cnt = n;
}

__device__ __forceinline__ Moments shfl_down(const Moments& m, int off) {
  return {__shfl_down_sync(0xffffffffu, m.n, off),
          __shfl_down_sync(0xffffffffu, m.mean, off),
          __shfl_down_sync(0xffffffffu, m.m2, off)};
}

// A fixed tree over the warp's lanes; lane 0 holds the result.
__device__ __forceinline__ Moments warp_chan(Moments m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = chan(m, shfl_down(m, off));
  return m;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The block's moments, in thread 0. Every thread calls it.
__device__ __forceinline__ Moments block_chan(Moments m,
                                              Moments (&red)[kWarps]) {
  m = warp_chan(m);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = m;
  __syncthreads();
  Moments out = red[0];
  if (threadIdx.x == 0)
    for (int w = 1; w < kWarps; ++w) out = chan(out, red[w]);
  __syncthreads();   // red is free again
  return out;
}

// The block's sums (s1, s2), in thread 0. Every thread calls it.
__device__ __forceinline__ void block_sums(double& s1, double& s2,
                                           double (&red)[2][kWarps]) {
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s1 = red[0][0];
    s2 = red[1][0];
    for (int w = 1; w < kWarps; ++w) {
      s1 += red[0][w];
      s2 += red[1][w];
    }
  }
  __syncthreads();
}

// A channel's moments from its blocks' partials, in lane 0 of the calling
// warp: the same order, so the same bits, in every block.
__device__ __forceinline__ Moments channel_moments(const double* ws,
                                                   const Layout& L, int ch) {
  const int lane = threadIdx.x & 31;
  const int b_lo = block_of(L, ch * L.n);
  const int b_hi = block_of(L, ch * L.n + L.n - 1);
  Moments acc = {0.0, 0.0, 0.0};
  for (int b = b_lo + lane; b <= b_hi; b += 32) {
    const double* p = ws + 3 * static_cast<int64_t>(slot(b, ch));
    acc = chan(acc, Moments{p[0], p[1], p[2]});
  }
  return warp_chan(acc);
}

// A channel's sums, likewise.
__device__ __forceinline__ void channel_sums(const double* ws,
                                             const Layout& L, int ch,
                                             double& s1, double& s2) {
  const int lane = threadIdx.x & 31;
  const int b_lo = block_of(L, ch * L.n);
  const int b_hi = block_of(L, ch * L.n + L.n - 1);
  s1 = 0.0;
  s2 = 0.0;
  for (int b = b_lo + lane; b <= b_hi; b += 32) {
    const double* p = ws + 2 * static_cast<int64_t>(slot(b, ch));
    s1 += p[0];
    s2 += p[1];
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
}

// The forward's and the backward's arithmetic a value, shared so that the
// backward's ReLU mask is the forward's bit for bit.
__device__ __forceinline__ float normalized(float x, float mean,
                                            float invstd) {
  return __fmul_rn(__fsub_rn(x, mean), invstd);
}

__device__ __forceinline__ float affine(float xhat, float gamma, float beta) {
  return __fmaf_rn(xhat, gamma, beta);
}

// torch.relu's mask: off at or below 0, on above it and for NaN
__device__ __forceinline__ bool relu_off(float pre) { return pre <= 0.0f; }

// ---- forward

template <int V, bool kRelu>
__device__ __forceinline__ void forward(const FwdArgs& a) {
  __shared__ Moments red[kWarps];
  __shared__ float coef[4];
  const Layout& L = a.L;
  const int b = blockIdx.x;
  const int q0 = first_plane(L, b), q1 = first_plane(L, b + 1);
  const int c_first = q0 / L.n, c_last = (q1 - 1) / L.n;

  // pass 1: a partial of moments for each of the block's segments
  for (int ch = c_first; ch <= c_last; ++ch) {
    const Segment s = segment(L, q0, q1, ch);
    float cnt = 0.0f, mean = 0.0f, m2 = 0.0f;
    for_units<V, false>(L, s, [&](const int64_t (&off)[kUnroll],
                                  const bool (&live)[kUnroll]) {
      float v[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (live[u]) load<V>(a.x + off[u], v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (live[u]) welford<V>(v[u], cnt, mean, m2);
    });
    const Moments m = block_chan(Moments{cnt, mean, m2}, red);
    if (threadIdx.x == 0) {
      double* p = a.ws + 3 * static_cast<int64_t>(slot(b, ch));
      p[0] = m.n;
      p[1] = m.mean;
      p[2] = m.m2;
    }
  }

  cg::this_grid().sync();

  // pass 2, last segment first: the statistics, then y
  for (int ch = c_last; ch >= c_first; --ch) {
    const Segment s = segment(L, q0, q1, ch);
    if (threadIdx.x < 32) {
      const Moments m = channel_moments(a.ws, L, ch);
      if (threadIdx.x == 0) {
        const float mean = static_cast<float>(m.mean);
        const float invstd =
            static_cast<float>(1.0 / sqrt(m.m2 / m.n + a.eps));
        coef[0] = mean;
        coef[1] = invstd;
        coef[2] = a.gamma[ch];
        coef[3] = a.beta[ch];
        if (s.lo == 0) {   // the block holding the channel's first plane
          a.save_mean[ch] = mean;
          a.save_invstd[ch] = invstd;
          const double mo = a.momentum;
          a.running_mean[ch] = static_cast<float>(
              (1.0 - mo) * a.running_mean[ch] + mo * m.mean);
          a.running_var[ch] = static_cast<float>(
              (1.0 - mo) * a.running_var[ch] + mo * (m.m2 / (m.n - 1.0)));
        }
      }
    }
    __syncthreads();
    const float mean = coef[0], invstd = coef[1], g = coef[2], be = coef[3];
    for_units<V, true>(L, s, [&](const int64_t (&off)[kUnroll],
                                 const bool (&live)[kUnroll]) {
      float v[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (live[u]) load<V>(a.x + off[u], v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!live[u]) continue;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float pre = affine(normalized(v[u][i], mean, invstd), g, be);
          v[u][i] = kRelu && relu_off(pre) ? 0.0f : pre;
        }
        store<V>(a.y + off[u], v[u]);
      }
    });
    __syncthreads();   // coef is free again
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
batch_norm_fwd_kernel(const FwdArgs a) {
  forward<V, false>(a);
}

template <int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
batch_norm_relu_fwd_kernel(const FwdArgs a) {
  forward<V, true>(a);
}

// ---- backward

template <int V, bool kRelu>
__device__ __forceinline__ void backward(const BwdArgs& a) {
  __shared__ double red[2][kWarps];
  __shared__ float coef[6];
  const Layout& L = a.L;
  const int b = blockIdx.x;
  const int q0 = first_plane(L, b), q1 = first_plane(L, b + 1);
  const int c_first = q0 / L.n, c_last = (q1 - 1) / L.n;

  // pass 1: partial sums of dy' and dy' xhat for each segment
  for (int ch = c_first; ch <= c_last; ++ch) {
    const Segment s = segment(L, q0, q1, ch);
    const float mean = a.save_mean[ch], invstd = a.save_invstd[ch];
    const float g = a.gamma[ch], be = a.beta[ch];
    double s1 = 0.0, s2 = 0.0;
    for_units<V, false>(L, s, [&](const int64_t (&off)[kUnroll],
                                  const bool (&live)[kUnroll]) {
      float v[kUnroll][V], d[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!live[u]) continue;
        load<V>(a.x + off[u], v[u]);
        load<V>(a.dy + off[u], d[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!live[u]) continue;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xhat = normalized(v[u][i], mean, invstd);
          const float dd =
              kRelu && relu_off(affine(xhat, g, be)) ? 0.0f : d[u][i];
          s1 += static_cast<double>(dd);
          s2 = fma(static_cast<double>(dd), static_cast<double>(xhat), s2);
        }
      }
    });
    block_sums(s1, s2, red);
    if (threadIdx.x == 0) {
      double* p = a.ws + 2 * static_cast<int64_t>(slot(b, ch));
      p[0] = s1;
      p[1] = s2;
    }
  }

  cg::this_grid().sync();

  // pass 2, last segment first: the channel's sums, then dx
  for (int ch = c_last; ch >= c_first; --ch) {
    const Segment s = segment(L, q0, q1, ch);
    if (threadIdx.x < 32) {
      double s1, s2;
      channel_sums(a.ws, L, ch, s1, s2);
      if (threadIdx.x == 0) {
        const double count = static_cast<double>(L.n) * L.hw;
        const float mean = a.save_mean[ch], invstd = a.save_invstd[ch];
        const float g = a.gamma[ch];
        coef[0] = mean;
        coef[1] = invstd;
        coef[2] = g;
        coef[3] = a.beta[ch];
        coef[4] = static_cast<float>(s1 / count);
        coef[5] = static_cast<float>(s2 / count);
        if (s.lo == 0) {
          a.dbeta[ch] = static_cast<float>(s1);
          a.dgamma[ch] = static_cast<float>(s2);
        }
      }
    }
    __syncthreads();
    const float mean = coef[0], invstd = coef[1], g = coef[2], be = coef[3];
    const float k1 = coef[4], k2 = coef[5];
    const float scale = g * invstd;
    for_units<V, true>(L, s, [&](const int64_t (&off)[kUnroll],
                                 const bool (&live)[kUnroll]) {
      float v[kUnroll][V], d[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!live[u]) continue;
        load<V>(a.x + off[u], v[u]);
        load<V>(a.dy + off[u], d[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!live[u]) continue;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xhat = normalized(v[u][i], mean, invstd);
          const float dd =
              kRelu && relu_off(affine(xhat, g, be)) ? 0.0f : d[u][i];
          v[u][i] = fmaf(-xhat, k2, dd - k1) * scale;
        }
        store<V>(a.dx + off[u], v[u]);
      }
    });
    __syncthreads();
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
batch_norm_bwd_kernel(const BwdArgs a) {
  backward<V, false>(a);
}

template <int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
batch_norm_relu_bwd_kernel(const BwdArgs a) {
  backward<V, true>(a);
}

// ---- launch

template <class Args>
int launch(void (*kernel)(Args), Args args, cudaStream_t stream) {
  void* params[] = {&args};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(args.L.blocks),
      dim3(kThreads), params, 0, stream));
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int check_layout(const Layout& L) {
  if (L.n <= 0 || L.c <= 0 || L.hw <= 0 || L.blocks <= 0 ||
      L.blocks > L.planes)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaSuccess);
}

template <class K>
cudaError_t fewest_blocks(K kernel, int& least) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, kThreads, 0);
  if (err == cudaSuccess && blocks < least) least = blocks;
  return err;
}

}  // namespace

// The most blocks a cooperative launch of any of the kernels may hold on
// the current device (blocks an SM times SMs), into *blocks. Returns the
// cudaError_t.
extern "C" int batch_norm_max_blocks(int* blocks) {
  int device = 0, sms = 0, least = 1 << 30;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  void (*fwd[])(FwdArgs) = {batch_norm_fwd_kernel<1>, batch_norm_fwd_kernel<4>,
                            batch_norm_relu_fwd_kernel<1>,
                            batch_norm_relu_fwd_kernel<4>};
  void (*bwd[])(BwdArgs) = {batch_norm_bwd_kernel<1>, batch_norm_bwd_kernel<4>,
                            batch_norm_relu_bwd_kernel<1>,
                            batch_norm_relu_bwd_kernel<4>};
  for (auto k : fwd)
    if (err == cudaSuccess) err = fewest_blocks(k, least);
  for (auto k : bwd)
    if (err == cudaSuccess) err = fewest_blocks(k, least);
  *blocks = err == cudaSuccess ? least * sms : 0;
  return static_cast<int>(err);
}

// The forward. x, y (n, c, hw) fp32 contiguous; gamma, beta, save_mean,
// save_invstd, running_mean, running_var (c,) fp32; workspace (blocks + c) *
// 3 doubles, written before it is read. blocks is at most the planes n * c
// and batch_norm_max_blocks. relu folds max(y, 0) in. Returns the
// cudaError_t of the launch.
extern "C" int batch_norm_fwd_f32(const void* x, const void* gamma,
                                  const void* beta, void* y, void* save_mean,
                                  void* save_invstd, void* running_mean,
                                  void* running_var, void* workspace, int n,
                                  int c, int hw, int blocks, double momentum,
                                  double eps, int relu, void* stream) {
  const Layout L = {n, c, hw, n * c, blocks};
  if (const int err = check_layout(L)) return err;
  const FwdArgs a = {static_cast<const float*>(x),
                     static_cast<const float*>(gamma),
                     static_cast<const float*>(beta),
                     static_cast<float*>(y),
                     static_cast<float*>(save_mean),
                     static_cast<float*>(save_invstd),
                     static_cast<float*>(running_mean),
                     static_cast<float*>(running_var),
                     static_cast<double*>(workspace),
                     L, momentum, eps};
  const bool vec = hw % 4 == 0 && aligned(x) && aligned(y);
  void (*kernel)(FwdArgs) =
      relu ? (vec ? &batch_norm_relu_fwd_kernel<4>
                  : &batch_norm_relu_fwd_kernel<1>)
           : (vec ? &batch_norm_fwd_kernel<4> : &batch_norm_fwd_kernel<1>);
  return launch(kernel, a, static_cast<cudaStream_t>(stream));
}

// The backward. x, dy, dx (n, c, hw) fp32 contiguous; save_mean,
// save_invstd (the forward's), gamma, beta, dgamma, dbeta (c,) fp32;
// workspace (blocks + c) * 2 doubles. relu as in the forward.
extern "C" int batch_norm_bwd_f32(const void* x, const void* dy,
                                  const void* save_mean,
                                  const void* save_invstd, const void* gamma,
                                  const void* beta, void* dx, void* dgamma,
                                  void* dbeta, void* workspace, int n, int c,
                                  int hw, int blocks, int relu,
                                  void* stream) {
  const Layout L = {n, c, hw, n * c, blocks};
  if (const int err = check_layout(L)) return err;
  const BwdArgs a = {static_cast<const float*>(x),
                     static_cast<const float*>(dy),
                     static_cast<const float*>(save_mean),
                     static_cast<const float*>(save_invstd),
                     static_cast<const float*>(gamma),
                     static_cast<const float*>(beta),
                     static_cast<float*>(dx),
                     static_cast<float*>(dgamma),
                     static_cast<float*>(dbeta),
                     static_cast<double*>(workspace),
                     L};
  const bool vec = hw % 4 == 0 && aligned(x) && aligned(dy) && aligned(dx);
  void (*kernel)(BwdArgs) =
      relu ? (vec ? &batch_norm_relu_bwd_kernel<4>
                  : &batch_norm_relu_bwd_kernel<1>)
           : (vec ? &batch_norm_bwd_kernel<4> : &batch_norm_bwd_kernel<1>);
  return launch(kernel, a, static_cast<cudaStream_t>(stream));
}
