// Fused blockwise 8-bit AdamW update for Hopper (sm_90a).
//
// Replaces the TPU kernel whisper_finetune_tpu/ops/fused_adamw8.py:
// fused_adamw8_leaf (pallas_call over _kernel3d / _kernel2d, body
// _update_math). One pass over a leaf viewed as (NB, 256) quantization blocks:
// dequantize the int8 first moment (absmax / 127) and the uint8 log-codebook
// second moment, scale the gradient by g_scale (mean divisor times clip
// factor), update both moments, apply the bias corrections by division by c1
// and c2, decoupled weight decay and the learning rate, write p, and
// re-quantize both moments with fresh per-block scales.
//
// The operations and their order follow _update_math (exp(x*ln10) for the
// codebook, log(x)/ln10 back, division by c1 and c2). The library builds with
// -fmad=false so no multiply-add contracts into an FMA, and the port's plain
// version, run on the same card, gives the same numbers.
//
// What bounds it on an H100: bytes. It moves about 14 bytes an element (p
// read and written as float32, g read as bf16, one code byte each way for
// each moment, the scales) and does some 40 scalar operations an element,
// far below the 295 operations a byte where compute would bound it. The
// design: one warp owns one 256-element block (8 elements a lane, read as
// 16-byte vectors, so a warp reads each array in one contiguous sweep), the
// two block maxima (|m| and nu) are warp-shuffle reductions in registers, and
// everything is updated in place, so each byte crosses the memory bus once
// each way. Eight blocks a thread block of 256 threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BLOCK = 256;        // elements a quantization block
constexpr int WARPS = 8;          // quantization blocks a thread block
constexpr float LN10 = 2.302585092994046f;
constexpr float LOG_DECADES = 6.0f;
constexpr float LOG_LEVELS = 254.0f;
constexpr float LOG_FLOOR = 1e-6f;  // 10 ** -LOG_DECADES

struct Hyper {
  float lr, c1, c2, b1, omb1, b2, omb2, eps, wd;
};

__device__ __forceinline__ void load_grad(const __nv_bfloat16* g, long long i,
                                          float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(g + i);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = __bfloat162float(h[j]);
}

__device__ __forceinline__ void load_grad(const float* g, long long i, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(g + i);
  const float4 b = *reinterpret_cast<const float4*>(g + i + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

template <typename G>
__global__ void __launch_bounds__(WARPS * 32)
fused_adamw8_kernel(float* __restrict__ p, const G* __restrict__ g,
                    int8_t* __restrict__ m_codes, float* __restrict__ m_scale,
                    uint8_t* __restrict__ n_codes, float* __restrict__ n_scale,
                    long long nb, const float* __restrict__ g_scale, Hyper hp) {
  const long long blk = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (blk >= nb) return;  // whole warps leave: the reductions are per warp
  const int lane = threadIdx.x & 31;
  const long long i0 = blk * BLOCK + lane * 8;
  const float gs = *g_scale;

  float pv[8], gv[8], m[8], nu[8];
  {
    const float4 a = *reinterpret_cast<const float4*>(p + i0);
    const float4 b = *reinterpret_cast<const float4*>(p + i0 + 4);
    pv[0] = a.x; pv[1] = a.y; pv[2] = a.z; pv[3] = a.w;
    pv[4] = b.x; pv[5] = b.y; pv[6] = b.z; pv[7] = b.w;
  }
  load_grad(g, i0, gv);
  const uint2 mraw = *reinterpret_cast<const uint2*>(m_codes + i0);
  const uint2 nraw = *reinterpret_cast<const uint2*>(n_codes + i0);
  const int8_t* mc = reinterpret_cast<const int8_t*>(&mraw);
  const uint8_t* nc = reinterpret_cast<const uint8_t*>(&nraw);
  const float ms = m_scale[blk], ns = n_scale[blk];

  float amax = 0.f, nmax = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float gg = gv[j] * gs;
    m[j] = hp.b1 * ((float)mc[j] * ms) + hp.omb1 * gg;
    const float qf = (float)nc[j];
    const float r = expf(((qf - 1.0f) / LOG_LEVELS * LOG_DECADES - LOG_DECADES) * LN10);
    const float nu_prev = (qf == 0.0f ? 0.0f : r) * ns;
    nu[j] = hp.b2 * nu_prev + hp.omb2 * gg * gg;
    const float upd = (m[j] / hp.c1) / (sqrtf(nu[j] / hp.c2) + hp.eps);
    pv[j] = pv[j] - hp.lr * (upd + hp.wd * pv[j]);
    amax = fmaxf(amax, fabsf(m[j]));
    nmax = fmaxf(nmax, nu[j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    nmax = fmaxf(nmax, __shfl_xor_sync(0xffffffffu, nmax, off));
  }

  const float ms_new = amax / 127.0f;
  const float ms_safe = ms_new == 0.0f ? 1.0f : ms_new;
  const float ns_safe = nmax == 0.0f ? 1.0f : nmax;
  uint2 mout, nout;
  int8_t* mo = reinterpret_cast<int8_t*>(&mout);
  uint8_t* no = reinterpret_cast<uint8_t*>(&nout);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mo[j] = (int8_t)fminf(fmaxf(rintf(m[j] / ms_safe), -127.0f), 127.0f);
    const float rq = fminf(fmaxf(nu[j] / ns_safe, 0.0f), 1.0f);
    const float logr = logf(fmaxf(rq, LOG_FLOOR)) / LN10;
    const float code = 1.0f + rintf((logr + LOG_DECADES) / LOG_DECADES * LOG_LEVELS);
    no[j] = rq == 0.0f ? (uint8_t)0 : (uint8_t)code;
  }
  *reinterpret_cast<float4*>(p + i0) = make_float4(pv[0], pv[1], pv[2], pv[3]);
  *reinterpret_cast<float4*>(p + i0 + 4) = make_float4(pv[4], pv[5], pv[6], pv[7]);
  *reinterpret_cast<uint2*>(m_codes + i0) = mout;
  *reinterpret_cast<uint2*>(n_codes + i0) = nout;
  if (lane == 0) {
    m_scale[blk] = ms_new;
    n_scale[blk] = nmax;
  }
}

}  // namespace

// grad_is_bf16: 1 for a bfloat16 gradient, 0 for float32. Everything is
// updated in place: p, both code arrays and both scale arrays.
extern "C" int wft_fused_adamw8(void* p, const void* g, int grad_is_bf16,
                                void* m_codes, void* m_scale, void* n_codes,
                                void* n_scale, long long nb, const void* g_scale,
                                float lr, float c1, float c2, float b1,
                                float omb1, float b2, float omb2, float eps,
                                float wd, void* stream) {
  const Hyper hp{lr, c1, c2, b1, omb1, b2, omb2, eps, wd};
  const dim3 grid((unsigned)((nb + WARPS - 1) / WARPS));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grad_is_bf16)
    fused_adamw8_kernel<__nv_bfloat16><<<grid, WARPS * 32, 0, s>>>(
        static_cast<float*>(p), static_cast<const __nv_bfloat16*>(g),
        static_cast<int8_t*>(m_codes), static_cast<float*>(m_scale),
        static_cast<uint8_t*>(n_codes), static_cast<float*>(n_scale), nb,
        static_cast<const float*>(g_scale), hp);
  else
    fused_adamw8_kernel<float><<<grid, WARPS * 32, 0, s>>>(
        static_cast<float*>(p), static_cast<const float*>(g),
        static_cast<int8_t*>(m_codes), static_cast<float*>(m_scale),
        static_cast<uint8_t*>(n_codes), static_cast<float*>(n_scale), nb,
        static_cast<const float*>(g_scale), hp);
  return static_cast<int>(cudaGetLastError());
}
