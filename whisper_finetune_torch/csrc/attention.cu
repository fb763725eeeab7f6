// Flash-style attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Replaces the TPU's splash attention (whisper_finetune_tpu/ops/attention.py:
// splash_mha, kernel built by _splash_kernel, variant fused_bwd) and its
// flash attention (same file: flash_mha, and flash_fwd_xla_bwd, which keeps
// only the forward). Same math in all of them: scores scaled by sm_scale
// (splash pre-scales q by D**-0.5 = 0.125, exact in bf16, flash scales the
// scores inside; here the float32 scores are scaled, which is the same
// number), online softmax with float32 statistics, bf16 in and out, float32
// accumulators. The forward comes in two instances: with the per-row
// log-sum-exp the backward kernels read, and without it (kWriteLse = false)
// for flash_fwd_xla_bwd, whose backward is plain and which, like the TPU
// forward under save_residuals=False, writes no row statistics.
//
// Layout: q, o, do share one stride set (B, H, T, 64) with the head dim
// contiguous; k, v, dk, dv share another. lse and delta are (B, H, Tq)
// float32, contiguous. Tq and Tk are masked inside the kernels: rows past the
// end load as zeros and are never written, keys past the end get probability
// 0, so 1500 and 448 need no padding and there are no garbage rows.
//
// What bounds them on an H100: tensor-core operations, 4*B*H*Tq*Tk*64 FLOP
// forward, 6x and 8x B*H*Tq*Tk*64 for the dQ and dK/dV kernels (each rebuilds
// P from the saved log-sum-exp), against 989 TFLOP/s bf16; the bytes (q, k, v,
// o and gradients, 128 B a row) are a few percent of that. The design keeps
// every (64 x 64) score tile in registers, so nothing of size Tq*Tk touches
// device memory in either direction. The products are mma.sync m16n8k16 bf16
// with float32 accumulators, fed from padded shared memory, with no software
// pipelining: simple first. wgmma, TMA and warp specialisation come later.
//
// Block shape: 4 warps, 64 rows a block, 16 rows a warp; key/query tiles of
// 64. No atomics anywhere, so every result is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 64;          // head dim
constexpr int BM = 64;         // rows of a tile
constexpr int LDS = D + 8;     // padded shared-memory row, in bf16 (144 B)
constexpr int NT = 128;        // threads a block
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Dims {
  int B, H, Tq, Tk;
  long long sqb, sqh, sqt;  // q / o / do strides, in elements
  long long skb, skh, skt;  // k / v / dk / dv strides
  float scale;
  int causal;
};

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment (16 x 16, row-major) of rows r0.., columns kk*16.. of a tile.
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* s, int r0,
                                       int kk, int g, int t) {
  const bf16* p = s + (r0 + g) * LDS + kk * 16 + t * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LDS);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LDS + 8);
}

// B fragment (16 x 8) with B[k][n] = M[n0 + n][kk*16 + k]: M's rows are n.
__device__ __forceinline__ void frag_b_rows(uint32_t* b, const bf16* s, int n0,
                                            int kk, int g, int t) {
  const bf16* p = s + (n0 + g) * LDS + kk * 16 + t * 2;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// B fragment (16 x 8) with B[k][n] = M[kk*16 + k][n0 + n]: M's rows are k.
__device__ __forceinline__ void frag_b_cols(uint32_t* b, const bf16* s, int n0,
                                            int kk, int g, int t) {
  const unsigned short* u = reinterpret_cast<const unsigned short*>(s);
  const int k = kk * 16 + t * 2, n = n0 + g;
  b[0] = (uint32_t)u[k * LDS + n] | ((uint32_t)u[(k + 1) * LDS + n] << 16);
  b[1] = (uint32_t)u[(k + 8) * LDS + n] | ((uint32_t)u[(k + 9) * LDS + n] << 16);
}

// A fragment for k-step kk from a 16 x 64 float accumulator held as eight
// C fragments (the C layout of n-tiles 2kk, 2kk+1 is the A layout of kk).
__device__ __forceinline__ void acc_to_a(uint32_t* a, float (*c)[4], int kk) {
  a[0] = pack_f2(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_f2(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_f2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_f2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// 64 rows x 64 bf16 from global (row stride st) into padded shared memory;
// rows at or past T load as zeros.
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* base,
                                          long long st, int row0, int T) {
  for (int i = threadIdx.x; i < BM * (D / 8); i += NT) {
    const int r = i >> 3, c = i & 7;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T)
      v = *reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * st + c * 8);
    *reinterpret_cast<uint4*>(sm + r * LDS + c * 8) = v;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// S (16 x 64) = A-rows of sa (rows r0..) times the rows of sb, transposed.
__device__ __forceinline__ void tile_qkT(float (*s)[4], const bf16* sa, int r0,
                                         const bf16* sb, int g, int t) {
  uint32_t a[4], b[2];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    frag_a(a, sa, r0, kk, g, t);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      frag_b_rows(b, sb, nt * 8, kk, g, t);
      mma16816(s[nt], a, b);
    }
  }
}

// acc (16 x 64) += P (16 x 64, float accumulators) times the tile sb.
__device__ __forceinline__ void tile_pv(float (*acc)[4], float (*p)[4],
                                        const bf16* sb, int g, int t) {
  uint32_t a[4], b[2];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    acc_to_a(a, p, kk);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      frag_b_cols(b, sb, nt * 8, kk, g, t);
      mma16816(acc[nt], a, b);
    }
  }
}

// Column (key or query) of accumulator entry (nt, j) relative to the tile.
__device__ __forceinline__ int acc_col(int nt, int j, int t) {
  return nt * 8 + t * 2 + (j & 1);
}

template <bool kWriteLse>
__global__ void __launch_bounds__(NT)
attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o,
                float* __restrict__ lse, Dims d) {
  __shared__ __align__(16) bf16 sQ[BM * LDS];
  __shared__ __align__(16) bf16 sK[BM * LDS];
  __shared__ __align__(16) bf16 sV[BM * LDS];
  const int bh = blockIdx.y, b = bh / d.H, h = bh % d.H;
  const int q0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qb = q + b * d.sqb + h * d.sqh;
  const bf16* kb = k + b * d.skb + h * d.skh;
  const bf16* vb = v + b * d.skb + h * d.skh;

  load_tile(sQ, qb, d.sqt, q0, d.Tq);
  const float sl2 = d.scale * LOG2E;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  const int k_end = d.causal ? min(d.Tk, q0 + BM) : d.Tk;
  for (int k0 = 0; k0 < k_end; k0 += BM) {
    __syncthreads();  // the previous tile is consumed (and sQ is loaded)
    load_tile(sK, kb, d.skt, k0, d.Tk);
    load_tile(sV, vb, d.skt, k0, d.Tk);
    __syncthreads();

    float s[8][4];
    tile_qkT(s, sQ, warp * 16, sK, g, t);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + acc_col(nt, j, t);
        const bool ok = col < d.Tk && (!d.causal || col <= row[j >> 1]);
        s[nt][j] = ok ? s[nt][j] * sl2 : -INFINITY;
      }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = quad_max(mx);
      const float m_new = fmaxf(m_r[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m_r[r] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float p0 = exp2f(s[nt][2 * r] - m_use);
        const float p1 = exp2f(s[nt][2 * r + 1] - m_use);
        s[nt][2 * r] = p0;
        s[nt][2 * r + 1] = p1;
        sum += p0 + p1;
        acc[nt][2 * r] *= alpha;
        acc[nt][2 * r + 1] *= alpha;
      }
      l_r[r] = l_r[r] * alpha + quad_sum(sum);
      m_r[r] = m_new;
    }
    tile_pv(acc, s, sV, g, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= d.Tq) continue;
    const float inv = l_r[r] > 0.f ? 1.f / l_r[r] : 0.f;
    bf16* orow = o + b * d.sqb + h * d.sqh + (long long)row[r] * d.sqt;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint32_t val = pack_f2(acc[nt][2 * r] * inv, acc[nt][2 * r + 1] * inv);
      *reinterpret_cast<uint32_t*>(orow + nt * 8 + t * 2) = val;
    }
    if (kWriteLse && t == 0)
      lse[(long long)bh * d.Tq + row[r]] =
          l_r[r] > 0.f ? (m_r[r] + log2f(l_r[r])) * LN2 : INFINITY;
  }
}

// dQ for one (batch*head, 64-row q tile). First computes
// delta = rowsum(dO * O) for its rows and writes it for the dK/dV kernel.
__global__ void __launch_bounds__(NT)
attn_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ o,
                   const bf16* __restrict__ dout, const float* __restrict__ lse,
                   float* __restrict__ delta, bf16* __restrict__ dq, Dims d) {
  __shared__ __align__(16) bf16 sQ[BM * LDS];
  __shared__ __align__(16) bf16 sDO[BM * LDS];
  __shared__ __align__(16) bf16 sK[BM * LDS];
  __shared__ __align__(16) bf16 sV[BM * LDS];
  __shared__ float sLse[BM], sDelta[BM];
  const int bh = blockIdx.y, b = bh / d.H, h = bh % d.H;
  const int q0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long qoff = b * d.sqb + h * d.sqh;
  const bf16* kb = k + b * d.skb + h * d.skh;
  const bf16* vb = v + b * d.skb + h * d.skh;

  load_tile(sQ, q + qoff, d.sqt, q0, d.Tq);
  load_tile(sDO, dout + qoff, d.sqt, q0, d.Tq);
  load_tile(sK, o + qoff, d.sqt, q0, d.Tq);  // O, borrowed for delta
  __syncthreads();
  {
    // two threads a row, 32 columns each
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    float acc = 0.f;
    for (int c = half * 32; c < half * 32 + 32; ++c)
      acc += __bfloat162float(sDO[r * LDS + c]) * __bfloat162float(sK[r * LDS + c]);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      const bool valid = q0 + r < d.Tq;
      sDelta[r] = valid ? acc : 0.f;
      sLse[r] = valid ? lse[(long long)bh * d.Tq + q0 + r] * LOG2E : INFINITY;
      if (valid) delta[(long long)bh * d.Tq + q0 + r] = acc;
    }
  }

  const float sl2 = d.scale * LOG2E;
  const int lr0 = warp * 16 + g;
  const int row[2] = {q0 + lr0, q0 + lr0 + 8};
  float dq_acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    dq_acc[nt][0] = dq_acc[nt][1] = dq_acc[nt][2] = dq_acc[nt][3] = 0.f;

  const int k_end = d.causal ? min(d.Tk, q0 + BM) : d.Tk;
  for (int k0 = 0; k0 < k_end; k0 += BM) {
    __syncthreads();
    load_tile(sK, kb, d.skt, k0, d.Tk);
    load_tile(sV, vb, d.skt, k0, d.Tk);
    __syncthreads();
    const float lse2[2] = {sLse[lr0], sLse[lr0 + 8]};
    const float dl[2] = {sDelta[lr0], sDelta[lr0 + 8]};

    float p[8][4], dp[8][4];
    tile_qkT(p, sQ, warp * 16, sK, g, t);
    tile_qkT(dp, sDO, warp * 16, sV, g, t);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + acc_col(nt, j, t);
        const bool ok = col < d.Tk && (!d.causal || col <= row[j >> 1]);
        const float pr = ok ? exp2f(p[nt][j] * sl2 - lse2[j >> 1]) : 0.f;
        p[nt][j] = pr * (dp[nt][j] - dl[j >> 1]);  // dS
      }
    tile_pv(dq_acc, p, sK, g, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= d.Tq) continue;
    bf16* out = dq + qoff + (long long)row[r] * d.sqt;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<uint32_t*>(out + nt * 8 + t * 2) =
          pack_f2(dq_acc[nt][2 * r] * d.scale, dq_acc[nt][2 * r + 1] * d.scale);
  }
}

// dK and dV for one (batch*head, 64-key tile): loops over the q tiles,
// rebuilding P^T from the saved log-sum-exp. Reads delta from the dQ kernel.
__global__ void __launch_bounds__(NT)
attn_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, Dims d) {
  __shared__ __align__(16) bf16 sK[BM * LDS];
  __shared__ __align__(16) bf16 sV[BM * LDS];
  __shared__ __align__(16) bf16 sQ[BM * LDS];
  __shared__ __align__(16) bf16 sDO[BM * LDS];
  __shared__ float sLse[BM], sDelta[BM];
  const int bh = blockIdx.y, b = bh / d.H, h = bh % d.H;
  const int k0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long qoff = b * d.sqb + h * d.sqh;
  const long long koff = b * d.skb + h * d.skh;

  load_tile(sK, k + koff, d.skt, k0, d.Tk);
  load_tile(sV, v + koff, d.skt, k0, d.Tk);
  const float sl2 = d.scale * LOG2E;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[nt][j] = dv_acc[nt][j] = 0.f;

  // causal: only queries >= key matter, and the first such tile starts at k0
  const int q_begin = d.causal ? k0 : 0;
  for (int q0 = q_begin; q0 < d.Tq; q0 += BM) {
    __syncthreads();
    load_tile(sQ, q + qoff, d.sqt, q0, d.Tq);
    load_tile(sDO, dout + qoff, d.sqt, q0, d.Tq);
    if (threadIdx.x < BM) {
      const int qi = q0 + threadIdx.x;
      const bool valid = qi < d.Tq;
      sLse[threadIdx.x] = valid ? lse[(long long)bh * d.Tq + qi] * LOG2E : INFINITY;
      sDelta[threadIdx.x] = valid ? delta[(long long)bh * d.Tq + qi] : 0.f;
    }
    __syncthreads();

    float p[8][4], dp[8][4];
    tile_qkT(p, sK, warp * 16, sQ, g, t);   // S^T: keys x queries
    tile_qkT(dp, sV, warp * 16, sDO, g, t); // dP^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = acc_col(nt, j, t);
        const int qi = q0 + c;
        const int kj = key[j >> 1];
        const bool ok = qi < d.Tq && kj < d.Tk && (!d.causal || kj <= qi);
        p[nt][j] = ok ? exp2f(p[nt][j] * sl2 - sLse[c]) : 0.f;
        dp[nt][j] = p[nt][j] * (dp[nt][j] - sDelta[c]);  // dS^T
      }
    tile_pv(dv_acc, p, sDO, g, t);
    tile_pv(dk_acc, dp, sQ, g, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= d.Tk) continue;
    bf16* dkrow = dk + koff + (long long)key[r] * d.skt;
    bf16* dvrow = dv + koff + (long long)key[r] * d.skt;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      *reinterpret_cast<uint32_t*>(dkrow + nt * 8 + t * 2) =
          pack_f2(dk_acc[nt][2 * r] * d.scale, dk_acc[nt][2 * r + 1] * d.scale);
      *reinterpret_cast<uint32_t*>(dvrow + nt * 8 + t * 2) =
          pack_f2(dv_acc[nt][2 * r], dv_acc[nt][2 * r + 1]);
    }
  }
}

Dims make_dims(int B, int H, int Tq, int Tk, long long sqb, long long sqh,
               long long sqt, long long skb, long long skh, long long skt,
               float scale, int causal) {
  Dims d;
  d.B = B; d.H = H; d.Tq = Tq; d.Tk = Tk;
  d.sqb = sqb; d.sqh = sqh; d.sqt = sqt;
  d.skb = skb; d.skh = skh; d.skt = skt;
  d.scale = scale; d.causal = causal;
  return d;
}

}  // namespace

#define WFT_DIMS_ARGS                                                        \
  int B, int H, int Tq, int Tk, long long sqb, long long sqh, long long sqt, \
      long long skb, long long skh, long long skt, float scale, int causal,  \
      void *stream
#define WFT_DIMS make_dims(B, H, Tq, Tk, sqb, sqh, sqt, skb, skh, skt, scale, causal)

// lse may be null: the forward then writes no log-sum-exp.
extern "C" int wft_attn_fwd(const void* q, const void* k, const void* v, void* o,
                            void* lse, WFT_DIMS_ARGS) {
  const dim3 grid((Tq + BM - 1) / BM, B * H);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lse != nullptr)
    attn_fwd_kernel<true><<<grid, NT, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o),
        static_cast<float*>(lse), WFT_DIMS);
  else
    attn_fwd_kernel<false><<<grid, NT, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), nullptr, WFT_DIMS);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wft_attn_bwd_dq(const void* q, const void* k, const void* v,
                               const void* o, const void* dout, const void* lse,
                               void* delta, void* dq, WFT_DIMS_ARGS) {
  const dim3 grid((Tq + BM - 1) / BM, B * H);
  attn_bwd_dq_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<bf16*>(dq), WFT_DIMS);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wft_attn_bwd_dkdv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 WFT_DIMS_ARGS) {
  const dim3 grid((Tk + BM - 1) / BM, B * H);
  attn_bwd_dkdv_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), WFT_DIMS);
  return static_cast<int>(cudaGetLastError());
}
