// Layer norm over the last axis for Hopper (sm_90a): bf16 in and out, float32
// statistics and affine, and deep SpecAugment's keep-vectors in the epilogue.
//
// Replaces no TPU kernel: JAX's layer_norm (whisper_finetune_tpu/models/
// whisper.py) is plain jnp code that XLA fuses with its casts. In the port's
// eager PyTorch the same math was three kernels forward (a cast of x to
// float32, F.layer_norm in float32, a cast back) and four backward, plus two
// broadcast multiplies each way where deep SpecAugment masks the first norm
// of an encoder block. This library does it in one kernel forward and one
// pass (two small kernels) backward, with the math of that composite:
// statistics and affine in float32, one rounding to bf16, then the keep-
// vectors applied to the rounded value as the composite's bf16 multiplies do
// (time_keep (T,) by row % T first, then feat_keep (d,) by column).
//
// What bounds it on an H100: bytes. It does some ten float32 operations an
// element against the 295 a byte where compute would bound it. The forward
// needs x read and y written, 4 B an element (8 B a row for mean and rstd);
// the backward x and dy read and dx written, 6 B an element, plus the
// (blocks, 2, d) float32 partial sums of dgamma and dbeta. The design keeps
// every element in registers between its one read and its one write:
//
// - Forward (wft_layer_norm_fwd): one warp a row, d / 8 16-byte vectors of
//   the row spread over the lanes (C = ceil(d / 256) a lane, a template
//   argument), mean and variance in two passes over the registers (no
//   running update), then gamma and beta (float32, from L1) and 16-byte
//   stores. Four rows a block of 128 threads.
// - Backward (wft_layer_norm_bwd): a persistent grid, as many blocks of four
//   warps as fit on the card at once (at most one for every four rows).
//   Each warp walks rows r, r + 4 * blocks, ...; its lanes hold the row's x
//   and (masked) dy as bf16 in registers, with the next row's loads already
//   in flight (on an H100 158 against 181 us at 48,000 x 1,280 without),
//   take the two row sums, write dx, and add g * xhat and g into dgamma and
//   dbeta accumulators in registers. The four warps of a block then sum
//   their accumulators in shared memory in warp order and the block writes
//   one (2, d) partial. A second kernel (wft_layer_norm_bwd_sum) adds the
//   partials in block order. No atomics: two runs on one card give the same
//   bits.
//
// Layout: x, y, dy and dx (n, d) bf16, contiguous, 16-byte aligned, d a
// multiple of 8 up to 2048 (every Whisper width; instances for C = 9 to 16,
// which nothing runs, took nvcc from 11 to 30 s for this file); gamma
// and beta (d,) float32; mean and rstd (n,) float32; time_keep (t,) and
// feat_keep (d,) bf16 or null. Everything runs on the caller's stream,
// allocates nothing and never synchronises, so a CUDA graph can capture it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int VEC = 8;          // bf16 elements a 16-byte vector
constexpr int WARPS = 4;        // warps a block: rows at a time
constexpr int THREADS = WARPS * 32;
constexpr int MAX_C = 8;        // vectors a lane: d <= 8 * 32 * 8 = 2048
constexpr int SUM_COLS = 32;    // columns a block of the partials' sum
constexpr int SUM_ROWS = 8;     // its lanes down the partials

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void unpack(const uint4& raw, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < VEC / 2; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack(const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < VEC / 2; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  return raw;
}

// One bf16 multiply, as PyTorch's: the float32 product rounded to bf16.
__device__ __forceinline__ float bf16_mul(float a, float b) {
  return __bfloat162float(__float2bfloat16_rn(a * b));
}

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

template <int C>
__global__ void __launch_bounds__(THREADS)
wft_layer_norm_fwd(const bf16* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const bf16* __restrict__ time_keep,
                   const bf16* __restrict__ feat_keep, bf16* __restrict__ y,
                   float* __restrict__ mean_out, float* __restrict__ rstd_out,
                   long long n, int d, int t, float eps) {
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warps leave: the sums are per warp
  const int lane = threadIdx.x & 31;
  const int nvec = d / VEC;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);

  float v[C][VEC];
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = c * 32 + lane;
    if (i < nvec) {
      unpack(__ldg(xr + i), v[c]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) s += v[c][j];
    }
  }
  const float mean = warp_sum(s) / (float)d;
  float q = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (c * 32 + lane < nvec) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float dv = v[c][j] - mean;
        q += dv * dv;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / (float)d + eps);
  const float kt = time_keep ? __bfloat162float(time_keep[row % t]) : 1.f;

  uint4* yr = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = c * 32 + lane;
    if (i >= nvec) continue;
    float g[VEC], b[VEC], o[VEC];
    load8(gamma + i * VEC, g);
    load8(beta + i * VEC, b);
#pragma unroll
    for (int j = 0; j < VEC; ++j) o[j] = (v[c][j] - mean) * rstd * g[j] + b[j];
    uint4 out = pack(o);
    if (time_keep || feat_keep) {
      float kf[VEC];
      if (feat_keep) {
        unpack(__ldg(reinterpret_cast<const uint4*>(feat_keep) + i), kf);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) kf[j] = 1.f;
      }
      unpack(out, o);
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = bf16_mul(bf16_mul(o[j], kt), kf[j]);
      out = pack(o);
    }
    yr[i] = out;
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS)
wft_layer_norm_bwd(const bf16* __restrict__ dy, const bf16* __restrict__ x,
                   const float* __restrict__ mean, const float* __restrict__ rstd,
                   const float* __restrict__ gamma, const bf16* __restrict__ time_keep,
                   const bf16* __restrict__ feat_keep, bf16* __restrict__ dx,
                   float* __restrict__ partial, long long n, int d, int t) {
  extern __shared__ float red[];  // 2 * d: dgamma, then dbeta
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = d / VEC;
  const float inv_d = 1.f / (float)d;

  float dg[C][VEC], db[C][VEC];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int j = 0; j < VEC; ++j) dg[c][j] = db[c][j] = 0.f;

  const long long step = (long long)gridDim.x * WARPS;
  uint4 xnext[C], gnext[C];
  long long row = (long long)blockIdx.x * WARPS + warp;
  if (row < n) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = c * 32 + lane;
      if (i >= nvec) continue;
      xnext[c] = __ldg(reinterpret_cast<const uint4*>(x + row * d) + i);
      gnext[c] = __ldg(reinterpret_cast<const uint4*>(dy + row * d) + i);
    }
  }
  for (; row < n; row += step) {
    const float mu = mean[row], rs = rstd[row];
    const float kt = time_keep ? __bfloat162float(time_keep[row % t]) : 1.f;
    uint4 xraw[C], graw[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      xraw[c] = xnext[c];
      graw[c] = gnext[c];
    }
    if (row + step < n) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int i = c * 32 + lane;
        if (i >= nvec) continue;
        xnext[c] = __ldg(reinterpret_cast<const uint4*>(x + (row + step) * d) + i);
        gnext[c] = __ldg(reinterpret_cast<const uint4*>(dy + (row + step) * d) + i);
      }
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = c * 32 + lane;
      if (i >= nvec) continue;
      float g[VEC], xv[VEC], w[VEC];
      unpack(graw[c], g);
      if (time_keep || feat_keep) {
        // The composite's backward: dy * feat_keep, then * time_keep, in bf16.
        float kf[VEC];
        if (feat_keep) {
          unpack(__ldg(reinterpret_cast<const uint4*>(feat_keep) + i), kf);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) kf[j] = 1.f;
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) g[j] = bf16_mul(bf16_mul(g[j], kf[j]), kt);
        graw[c] = pack(g);
      }
      unpack(xraw[c], xv);
      load8(gamma + i * VEC, w);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xh = (xv[j] - mu) * rs;
        const float gw = g[j] * w[j];
        s1 += gw;
        s2 += gw * xh;
        dg[c][j] += g[j] * xh;
        db[c][j] += g[j];
      }
    }
    s1 = warp_sum(s1) * inv_d;
    s2 = warp_sum(s2) * inv_d;
    uint4* dxr = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = c * 32 + lane;
      if (i >= nvec) continue;
      float g[VEC], xv[VEC], w[VEC], o[VEC];
      unpack(graw[c], g);
      unpack(xraw[c], xv);
      load8(gamma + i * VEC, w);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xh = (xv[j] - mu) * rs;
        o[j] = (g[j] * w[j] - s1 - xh * s2) * rs;
      }
      dxr[i] = pack(o);
    }
  }

  // The block's partial: its warps' accumulators summed in warp order.
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int i = c * 32 + lane;
        if (i >= nvec) continue;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const int col = i * VEC + j;
          red[col] = w == 0 ? dg[c][j] : red[col] + dg[c][j];
          red[d + col] = w == 0 ? db[c][j] : red[d + col] + db[c][j];
        }
      }
    }
    __syncthreads();
  }
  float* out = partial + (long long)blockIdx.x * 2 * d;
  for (int i = threadIdx.x; i < 2 * d; i += THREADS) out[i] = red[i];
}

// dgamma and dbeta: the (blocks, 2 * d) partials summed down in block order.
// A block takes SUM_COLS columns; its SUM_ROWS rows of lanes sum every
// SUM_ROWS-th partial, then add up their sums in row order.
__global__ void __launch_bounds__(SUM_COLS * SUM_ROWS)
wft_layer_norm_bwd_sum(const float* __restrict__ partial, float* __restrict__ dgamma,
                       float* __restrict__ dbeta, int blocks, int d) {
  __shared__ float acc[SUM_ROWS][SUM_COLS];
  const int col = blockIdx.x * SUM_COLS + threadIdx.x;
  float s = 0.f;
  if (col < 2 * d) {
    for (int b = threadIdx.y; b < blocks; b += SUM_ROWS) s += partial[(long long)b * 2 * d + col];
  }
  acc[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < 2 * d) {
    float total = acc[0][threadIdx.x];
#pragma unroll
    for (int r = 1; r < SUM_ROWS; ++r) total += acc[r][threadIdx.x];
    if (col < d)
      dgamma[col] = total;
    else
      dbeta[col - d] = total;
  }
}

int chunks(int d) { return (d / VEC + 31) / 32; }

template <int C>
cudaError_t launch_fwd(const void* x, const void* gamma, const void* beta, const void* tk,
                       const void* fk, void* y, void* mean, void* rstd, long long n,
                       int d, int t, float eps, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>((n + WARPS - 1) / WARPS);
  wft_layer_norm_fwd<C><<<grid, THREADS, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(tk),
      static_cast<const bf16*>(fk), static_cast<bf16*>(y), static_cast<float*>(mean),
      static_cast<float*>(rstd), n, d, t, eps);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_bwd(const void* dy, const void* x, const void* mean, const void* rstd,
                       const void* gamma, const void* tk, const void* fk, void* dx,
                       void* partial, void* dgamma, void* dbeta, long long n, int d,
                       int t, int blocks, cudaStream_t s) {
  wft_layer_norm_bwd<C><<<blocks, THREADS, 2 * d * sizeof(float), s>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(x),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<const float*>(gamma), static_cast<const bf16*>(tk),
      static_cast<const bf16*>(fk), static_cast<bf16*>(dx), static_cast<float*>(partial),
      n, d, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((2 * d + SUM_COLS - 1) / SUM_COLS), block(SUM_COLS, SUM_ROWS);
  wft_layer_norm_bwd_sum<<<grid, block, 0, s>>>(static_cast<const float*>(partial),
                                                static_cast<float*>(dgamma),
                                                static_cast<float*>(dbeta), blocks, d);
  return cudaGetLastError();
}

template <int C>
cudaError_t bwd_blocks_per_sm(int d, int* out) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, wft_layer_norm_bwd<C>, THREADS,
                                                        2 * d * sizeof(float));
}

// Returns CALL(C) for the C of d (1 to MAX_C).
#define WFT_LN_DISPATCH(d, CALL)                                                  \
  switch (chunks(d)) {                                                            \
    case 1: return CALL(1); case 2: return CALL(2); case 3: return CALL(3);       \
    case 4: return CALL(4); case 5: return CALL(5); case 6: return CALL(6);       \
    case 7: return CALL(7); case 8: return CALL(8);                              \
    default: return cudaErrorInvalidValue;                                        \
  }

bool bad_width(int d) { return d < VEC || d % VEC != 0 || chunks(d) > MAX_C; }

}  // namespace

extern "C" int wft_layer_norm_fwd_launch(const void* x, const void* gamma, const void* beta,
                                         const void* time_keep, const void* feat_keep,
                                         void* y, void* mean, void* rstd, long long n,
                                         int d, int t, float eps, void* stream) {
  if (bad_width(d) || n < 1 || (time_keep && t < 1)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&]() -> cudaError_t {
#define WFT_LN_FWD(C) \
  launch_fwd<C>(x, gamma, beta, time_keep, feat_keep, y, mean, rstd, n, d, t, eps, s)
    WFT_LN_DISPATCH(d, WFT_LN_FWD)
#undef WFT_LN_FWD
  };
  return static_cast<int>(run());
}

// The backward's largest grid for width d on the current device: the blocks
// that fit on the card at once. The caller takes at most one block for every
// WARPS rows, and allocates the (blocks, 2, d) float32 partials.
extern "C" int wft_layer_norm_bwd_blocks(int d, int* blocks) {
  if (bad_width(d)) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = [&]() -> cudaError_t {
#define WFT_LN_OCC(C) bwd_blocks_per_sm<C>(d, &per_sm)
      WFT_LN_DISPATCH(d, WFT_LN_OCC)
#undef WFT_LN_OCC
    }();
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  return 0;
}

extern "C" int wft_layer_norm_bwd_launch(const void* dy, const void* x, const void* mean,
                                         const void* rstd, const void* gamma,
                                         const void* time_keep, const void* feat_keep,
                                         void* dx, void* partial, void* dgamma, void* dbeta,
                                         long long n, int d, int t, int blocks,
                                         void* stream) {
  if (bad_width(d) || n < 1 || blocks < 1 || (time_keep && t < 1))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&]() -> cudaError_t {
#define WFT_LN_BWD(C)                                                                 \
  launch_bwd<C>(dy, x, mean, rstd, gamma, time_keep, feat_keep, dx, partial, dgamma, dbeta, \
                n, d, t, blocks, s)
    WFT_LN_DISPATCH(d, WFT_LN_BWD)
#undef WFT_LN_BWD
  };
  return static_cast<int>(run());
}
