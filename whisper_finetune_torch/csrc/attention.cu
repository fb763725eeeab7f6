// Flash-style attention for Hopper (sm_90a): the forward kernel and the fused
// backward (one pass that gives dQ, dK and dV).
//
// Replaces the TPU's splash attention (whisper_finetune_tpu/ops/attention.py:
// splash_mha, kernel built by _splash_kernel, variant fused_bwd) and its
// flash attention (same file: flash_mha, and flash_fwd_xla_bwd, which keeps
// only the forward). Same math in all of them: scores scaled by sm_scale
// (splash pre-scales q by D**-0.5 = 0.125, exact in bf16, flash scales the
// scores inside; here the float32 scores are scaled, which is the same
// number), online softmax with float32 statistics, bf16 in and out, float32
// accumulators. The forward comes in two instances: with the per-row
// log-sum-exp the backward reads, and without it (kWriteLse = false) for
// flash_fwd_xla_bwd, whose backward is plain and which, like the TPU forward
// under save_residuals=False, writes no row statistics.
//
// Layout: q, o, do, dq share one stride set (B, H, T, 64) with the head dim
// contiguous; k, v, dk, dv share another. lse and delta are (B, H, Tq)
// float32, contiguous. Tq and Tk are masked inside the kernels: rows past the
// end load as zeros and are never written, keys past the end get probability
// 0, so 1500 and 448 need no padding and there are no garbage rows.
//
// What bounds them on an H100 depends on the shape. With F = B*H*Tq*Tk*64
// (under a causal mask only the tiles at or below the diagonal) the forward
// does 4F FLOP and the backward 10F (S = QK^T, dP = dO V^T, dV, dK, dQ once
// each) against 989 TFLOP/s bf16; the bytes are q, k, v, o, do and the
// gradients once each, 128 B a row, against 3.35 TB/s. At the encoder's
// 1500 x 1500 and the cross-attention's 448 x 1500 the operations are the
// larger time (the bytes are a quarter to a half of it); at the decoder's
// causal 448 x 448 the bytes are, by a factor of two. Nothing of size Tq*Tk
// touches device memory in either direction: every score tile lives in
// registers.
//
// Forward: 4 warps, 64 query rows a block, key tiles of 64, mma.sync m16n8k16
// from padded shared memory, no software pipelining (it is the next kernel to
// be rebuilt on the helpers of attention_common.cuh).
//
// Backward (wft_attn_bwd: three launches on one stream):
//   attn_bwd_prep_kernel        lse * log2(e) and delta = rowsum(dO * O) in
//                               float32, and the zeroing of the float32 dQ
//                               accumulator (bytes);
//   attn_bwd_kernel             one block of one warpgroup (4 warps) per
//                               (batch*head, 64-key tile), three blocks an SM
//                               (168 registers, 74 KB), which run out of step
//                               and fill each other's waits. K and V of the
//                               tile stay in shared memory for the block's
//                               life; (Q, dO, lse, delta) tiles of 64 queries
//                               arrive through a ring of cp.async stages
//                               filled one tile ahead of the products, all in
//                               the 128-byte swizzle wgmma descriptors read.
//                               Per tile pair, all products by wgmma m64n64k16
//                               with float32 accumulators in registers:
//                               S^T = K Q^T and dP^T = V dO^T once (two groups
//                               in flight, the first's softmax under the
//                               second), P = exp2(S^T*scale*log2e - lse*log2e)
//                               once by the special-function unit,
//                               dV += P^T dO and dK += dS^T Q with the A
//                               operand straight from the accumulator
//                               registers, dS once to shared memory in bf16,
//                               and the tile's share of dQ = dS K to shared
//                               memory in float32, from where one thread adds
//                               its 16 KB to the accumulator in device memory
//                               with one bulk reduction (cp.reduce.async.bulk
//                               add.f32) that runs under the next tile.
//                               Causal: query tiles before the key tile are
//                               skipped, masks are applied only in tiles that
//                               touch the diagonal or an edge;
//   attn_bwd_dq_convert_kernel  dq = bf16(accumulator * sm_scale) (bytes).
// dK and dV are sums in a fixed order in registers and leave them once:
// deterministic. dQ is a float32 sum over the key tiles in the order the
// hardware schedules their reductions, so two runs may differ in the last
// float32 bits before the one rounding to bf16.
//
// What holds the backward (measured on an H100, PERF.md): the reductions.
// With 64 keys a block the accumulator is added to Tk/64 times, 1.5 GB at the
// encoder's shape, and the L2's float32 add rate bounds the kernel there; 128
// keys a block would halve that but needs two warpgroups in step on one dS
// tile, which measured slower than three independent blocks an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "common.cuh"

namespace {

using namespace wft;

constexpr int BM = 64;         // forward: rows of a tile
constexpr int LDS = D + 8;     // forward: padded shared-memory row, in bf16 (144 B)
constexpr int NT = 128;        // forward: threads a block

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

constexpr int BWD_BN = 64;      // keys a block
constexpr int BWD_BM = 64;      // queries a ring stage
constexpr int BWD_NT = 128;     // one warpgroup; three blocks share an SM
constexpr int BWD_STAGES = 2;   // ring depth: one tile in use, one in flight
constexpr int KV_BYTES = BWD_BN * 128;
constexpr int Q_BYTES = BWD_BM * 128;
constexpr int DQ_BYTES = BWD_BM * D * 4;
// Shared memory of attn_bwd_kernel, in bytes from a 1024-byte aligned base.
constexpr int OFF_K = 0;
constexpr int OFF_V = OFF_K + KV_BYTES;
constexpr int OFF_DS = OFF_V + KV_BYTES;  // dS^T, bf16, 64 keys x 64 queries
constexpr int OFF_DQ = OFF_DS + KV_BYTES;  // the tile's share of dQ, float32, 64 x 64
constexpr int OFF_Q = OFF_DQ + DQ_BYTES;
constexpr int OFF_DO = OFF_Q + BWD_STAGES * Q_BYTES;
constexpr int OFF_LSE = OFF_DO + BWD_STAGES * Q_BYTES;
constexpr int OFF_DELTA = OFF_LSE + BWD_STAGES * BWD_BM * 4;
constexpr int BWD_SMEM = OFF_DELTA + BWD_STAGES * BWD_BM * 4 + 1024;  // + alignment slack
// Three blocks an SM need 75 KB of shared memory or less and 168 registers a thread.
static_assert(BWD_SMEM <= 75 * 1024, "attn_bwd_kernel: shared memory for three blocks an SM");

// The float32 dQ accumulator: (B*H, Tq, 64), so that a tile of 64 queries is
// 16 KB in one piece, which one bulk reduction adds to (fewer rows at the end
// of q). The eight 32-byte chunks of row r are stored at chunk ^ (r & 7): the
// layout in which the fused kernel's accumulator fragments reach shared
// memory without bank conflicts.

// One thread per 16 bytes of a (batch, head, query) row of O and dO: eight
// threads a row. stats[0] = lse * log2(e) and stats[1] = delta =
// rowsum(dO * O), each (B, H, Tq); the row's dQ accumulator is set to zero.
__global__ void __launch_bounds__(256)
attn_bwd_prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, float* __restrict__ stats,
                     float* __restrict__ dq_acc, Dims d) {
  const long long idx = blockIdx.x * 256LL + threadIdx.x;
  const long long row = idx >> 3, n_rows = (long long)d.B * d.H * d.Tq;
  const int c = idx & 7;
  float acc = 0.f;
  if (row < n_rows) {
    const int bh = row / d.Tq, qi = row % d.Tq;
    const long long off = (bh / d.H) * d.sqb + (bh % d.H) * d.sqh + qi * d.sqt + c * 8;
    const uint4 vo = *reinterpret_cast<const uint4*>(o + off);
    const uint4 vd = *reinterpret_cast<const uint4*>(dout + off);
    const __nv_bfloat162* po = reinterpret_cast<const __nv_bfloat162*>(&vo);
    const __nv_bfloat162* pd = reinterpret_cast<const __nv_bfloat162*>(&vd);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(po[i]), b = __bfloat1622float2(pd[i]);
      acc += a.x * b.x + a.y * b.y;
    }
    float4* z = reinterpret_cast<float4*>(dq_acc + row * D + c * 8);
    z[0] = z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (row < n_rows && c == 0) {
    stats[row] = lse[row] * LOG2E;
    stats[n_rows + row] = acc;
  }
}

// dq = bf16(accumulator * sm_scale), eight values a thread, in q's strides.
__global__ void __launch_bounds__(256)
attn_bwd_dq_convert_kernel(const float* __restrict__ dq_acc, bf16* __restrict__ dq,
                           Dims d) {
  const long long idx = blockIdx.x * 256LL + threadIdx.x;
  const long long row = idx >> 3;
  const int c = idx & 7;
  if (row >= (long long)d.B * d.H * d.Tq) return;
  const int bh = row / d.Tq, qi = row % d.Tq;
  const float4* src = reinterpret_cast<const float4*>(dq_acc + row * D + (c ^ (qi & 7)) * 8);
  const float4 a = src[0], b = src[1];
  uint4 out;
  out.x = pack_f2(a.x * d.scale, a.y * d.scale);
  out.y = pack_f2(a.z * d.scale, a.w * d.scale);
  out.z = pack_f2(b.x * d.scale, b.y * d.scale);
  out.w = pack_f2(b.z * d.scale, b.w * d.scale);
  *reinterpret_cast<uint4*>(dq + (bh / d.H) * d.sqb + (bh % d.H) * d.sqh + qi * d.sqt + c * 8) = out;
}

// P^T = exp2(S^T * scale*log2e - lse*log2e) in place, for this thread's
// entries of a (64 keys x 64 queries) accumulator; lse2 holds the tile's 64
// pre-scaled log-sum-exps. kEdge: mask queries >= Tq, keys >= Tk and, under
// the causal mask, keys after the query.
template <bool kEdge>
__device__ __forceinline__ void probabilities(float (&p)[8][4], const float2* lse2, float sl2,
                                              int q0, int key0, int t, const Dims& d) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float2 l = lse2[nt * 4 + t];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float pr = fast_exp2(p[nt][j] * sl2 - ((j & 1) ? l.y : l.x));
      if (kEdge) {
        const int qi = q0 + acc_col(nt, j, t), kj = key0 + 8 * (j >> 1);
        pr = (qi < d.Tq && kj < d.Tk && (!d.causal || kj <= qi)) ? pr : 0.f;
      }
      p[nt][j] = pr;
    }
  }
}

__global__ void __launch_bounds__(BWD_NT, 3)
attn_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ stats, float* __restrict__ dq_acc,
                bf16* __restrict__ dk, bf16* __restrict__ dv, Dims d) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / d.H, h = bh % d.H;
  const int k0 = blockIdx.x * BWD_BN;
  const int krow = warp * 16;  // this warp's 16 keys within the tile
  const long long koff = b * d.skb + h * d.skh;
  const bf16* qb = q + b * d.sqb + h * d.sqh;
  const bf16* dob = dout + b * d.sqb + h * d.sqh;
  const float* lse_b = stats + (long long)bh * d.Tq;
  const float* delta_b = lse_b + (long long)d.B * d.H * d.Tq;
  float* acc_b = dq_acc + (long long)bh * d.Tq * D;
  const uint32_t sK = base + OFF_K, sV = base + OFF_V;

  // causal: only queries >= key matter, and the first such tile starts at k0
  const int q_begin = d.causal ? k0 : 0;
  const int n_tiles = q_begin < d.Tq ? (d.Tq - q_begin + BWD_BM - 1) / BWD_BM : 0;
  // Every key tile walks the query tiles in the same order: the blocks of one
  // (batch, head) run side by side and add to the same rows of the dQ
  // accumulator at about the same time, which keeps those rows in L2 (starting
  // each block at another tile was measured slower).
  auto tile_q0 = [&](int it) { return q_begin + it * BWD_BM; };

  // A ring stage: thread tid brings chunk tid%8 of rows tid/8 + 16 i (i < 4)
  // of Q and of dO, and one of the 64 lse or 64 delta.
  const int ld_row = tid >> 3;
  const long long ld_off = (long long)ld_row * d.sqt + (tid & 7) * 8;
  const uint32_t ld_dst = swz(ld_row, tid & 7);
  auto load_stage = [&](int s, int q0) {
    const long long off = (long long)q0 * d.sqt + ld_off;
#pragma unroll
    for (int i = 0; i < BWD_BM * 8 / BWD_NT; ++i) {
      const int step = i * (BWD_NT / 8);  // rows between this thread's chunks
      const bool valid = q0 + ld_row + step < d.Tq;
      const long long o2 = valid ? off + step * d.sqt : 0;
      const uint32_t dst = s * Q_BYTES + ld_dst + step * 128;
      cp_async16(base + OFF_Q + dst, qb + o2, valid);
      cp_async16(base + OFF_DO + dst, dob + o2, valid);
    }
    {
      const int r = tid & (BWD_BM - 1);
      const bool is_delta = tid >= BWD_BM, valid = q0 + r < d.Tq;
      const float* src = (is_delta ? delta_b : lse_b) + (valid ? q0 + r : 0);
      cp_async4(base + (is_delta ? OFF_DELTA : OFF_LSE) + (s * BWD_BM + r) * 4, src, valid);
    }
  };

  tile_cp_async(sK, k + koff, d.skt, k0, d.Tk, BWD_BN, tid, BWD_NT);
  tile_cp_async(sV, v + koff, d.skt, k0, d.Tk, BWD_BN, tid, BWD_NT);
#pragma unroll
  for (int s = 0; s < BWD_STAGES; ++s) {  // one group a stage; K and V ride in the first
    if (s < n_tiles) load_stage(s, tile_q0(s));
    cp_async_commit();
  }

  const float sl2 = d.scale * LOG2E;
  // K and V as A operands (rows = keys); K is also the B operand of
  // dQ = dS K, read down its rows (the keys are the summed dim)
  const uint64_t dK_wg = wg_desc(sK), dV_wg = wg_desc(sV);
  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[nt][j] = dv_acc[nt][j] = 0.f;

  // The tile's share of dQ (64 queries x 64) = dS (64 x 64 keys) K, each warp
  // 16 queries; dS^T and K are both read down their rows (the keys are the
  // summed dim).
  float dq[8][4];
  auto issue_dq = [&]() {
    const uint64_t ds = wg_desc(base + OFF_DS);
    wgmma_ss_n64_first<1, 1>(dq, ds, dK_wg);
#pragma unroll
    for (int kk = 1; kk < BWD_BN / 16; ++kk)
      wgmma_ss_n64<1, 1>(dq, ds + kk * WG_MN_STEP, dK_wg + kk * WG_MN_STEP);
    wg_commit();
  };
  // dq's fragments to shared memory, in the accumulator's chunk layout
  // (row & 7 is g for every row of this thread).
  auto store_dq = [&]() {
    wg_acc_fence(dq);
    unsigned char* buf = smem + OFF_DQ;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        *reinterpret_cast<float2*>(buf + (krow + g + 8 * r) * (D * 4) +
                                   ((nt ^ g) * 8 + t * 2) * 4) =
            make_float2(dq[nt][2 * r], dq[nt][2 * r + 1]);
  };
  auto reduce_dq = [&](int tile) {  // one thread, after a barrier that follows store_dq
    const int q0 = tile_q0(tile);
    bulk_reduce_add_f32(acc_b + (long long)q0 * D, base + OFF_DQ,
                        min(BWD_BM, d.Tq - q0) * D * 4);
    bulk_commit();
  };

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % BWD_STAGES, q0 = tile_q0(it);
    cp_async_wait<BWD_STAGES - 1>();  // this tile's group has landed
    fence_async_smem();
    __syncthreads();                  // ... for every thread; the last tile's dQ is whole
    if (it > 0 && tid == 0) reduce_dq(it - 1);  // runs under this tile's products
    const uint32_t sQ = base + OFF_Q + s * Q_BYTES, sDO = base + OFF_DO + s * Q_BYTES;
    const float2* lse_s = reinterpret_cast<const float2*>(smem + OFF_LSE) + s * (BWD_BM / 2);
    const float2* delta_s = reinterpret_cast<const float2*>(smem + OFF_DELTA) + s * (BWD_BM / 2);

    // S^T = K Q^T and dP^T = V dO^T as two groups in flight: the softmax of
    // the first overlaps the second.
    float p[8][4], dp[8][4];
    wg_fence();
    wgmma_ss_n64_first<0, 0>(p, dK_wg, wg_desc(sQ));
#pragma unroll
    for (int kk = 1; kk < 4; ++kk)
      wgmma_ss_n64<0, 0>(p, dK_wg + kk * WG_K_STEP, wg_desc(sQ) + kk * WG_K_STEP);
    wg_commit();
    wgmma_ss_n64_first<0, 0>(dp, dV_wg, wg_desc(sDO));
#pragma unroll
    for (int kk = 1; kk < 4; ++kk)
      wgmma_ss_n64<0, 0>(dp, dV_wg + kk * WG_K_STEP, wg_desc(sDO) + kk * WG_K_STEP);
    wg_commit();

    // Masks only where the tile touches the end of q, the end of k or the diagonal.
    const bool edge = q0 + BWD_BM > d.Tq || k0 + BWD_BN > d.Tk ||
                      (d.causal && q0 < k0 + BWD_BN - 1);
    wg_wait<1>();
    wg_acc_fence(p);
    if (edge) probabilities<true>(p, lse_s, sl2, q0, k0 + krow + g, t, d);
    else probabilities<false>(p, lse_s, sl2, q0, k0 + krow + g, t, d);
    wg_wait<0>();
    wg_acc_fence(dp);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 dl = delta_s[nt * 4 + t];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dp[nt][j] = p[nt][j] * (dp[nt][j] - ((j & 1) ? dl.y : dl.x));  // dS^T
    }
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      acc_to_a(pa[kk], p, kk);
      acc_to_a(dsa[kk], dp, kk);
    }
    // dV += P^T dO and dK += dS^T Q: A from the registers, B the stage's
    // tiles read down their rows (the queries are the summed dim).
    wg_acc_fence(dv_acc);
    wg_acc_fence(dk_acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n64<1>(dv_acc, pa[kk], wg_desc(sDO) + kk * WG_MN_STEP);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n64<1>(dk_acc, dsa[kk], wg_desc(sQ) + kk * WG_MN_STEP);
    wg_commit();
    // Meanwhile dS^T goes to shared memory (fragment i of k-step kk is row
    // g + 8*(i&1), query chunk 2kk + (i>>1), queries 2t, 2t+1 of the chunk).
    unsigned char* ds_buf = smem + OFF_DS;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<uint32_t*>(ds_buf + swz(krow + g + 8 * (i & 1), 2 * kk + (i >> 1)) +
                                     t * 4) = dsa[kk][i];
    wg_wait<0>();
    if (tid == 0) bulk_wait_read<0>();  // the last tile's reduction has read the dQ buffer
    // after the wait: ptxas 12.9 crashes on a proxy fence inside an open wgmma group
    fence_async_smem();
    wg_acc_fence(dv_acc);
    wg_acc_fence(dk_acc);
    __syncthreads();  // dS is whole; the stage's Q and dO and the dQ buffer are free
    if (it + BWD_STAGES < n_tiles) load_stage(s, tile_q0(it + BWD_STAGES));
    cp_async_commit();
    wg_fence();
    issue_dq();
    wg_wait<0>();
    store_dq();
  }
  cp_async_wait<0>();
  if (n_tiles > 0) {  // the last tile's dQ
    fence_async_smem();
    __syncthreads();
    if (tid == 0) reduce_dq(n_tiles - 1);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + krow + g + 8 * r;
    if (key >= d.Tk) continue;
    bf16* dkrow = dk + koff + (long long)key * d.skt;
    bf16* dvrow = dv + koff + (long long)key * d.skt;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      *reinterpret_cast<uint32_t*>(dkrow + nt * 8 + t * 2) =
          pack_f2(dk_acc[nt][2 * r] * d.scale, dk_acc[nt][2 * r + 1] * d.scale);
      *reinterpret_cast<uint32_t*>(dvrow + nt * 8 + t * 2) =
          pack_f2(dv_acc[nt][2 * r], dv_acc[nt][2 * r + 1]);
    }
  }
  // The block ends only when its last reduction has read shared memory and
  // written the accumulator: the convert kernel that follows on the stream
  // then needs nothing but the order of kernels.
  if (tid == 0) bulk_wait<0>();
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

// The whole backward on one stream: the row statistics and the zeroed float32
// dQ accumulator, the fused kernel, the conversion of dQ. The caller provides
// the float32 scratch: stats (2, B, H, Tq) and dq_acc (B, H, Tq, 64).
extern "C" int wft_attn_bwd(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* stats, void* dq_acc, void* dq, void* dk,
                            void* dv, WFT_DIMS_ARGS) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dims d = WFT_DIMS;
  // The fused kernel's shared memory is above the 48 KB a kernel gets unasked:
  // the limit is raised once for each device, at that device's first call (not
  // once a launch: a training step makes dozens, some under graph capture).
  static bool smem_raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64 || !smem_raised[dev]) {
    err = cudaFuncSetAttribute(attn_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 0 && dev < 64) smem_raised[dev] = true;
  }
  const unsigned row_blocks =
      static_cast<unsigned>(((long long)B * H * Tq * 8 + 255) / 256);
  attn_bwd_prep_kernel<<<row_blocks, 256, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(stats),
      static_cast<float*>(dq_acc), d);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  attn_bwd_kernel<<<dim3((Tk + BWD_BN - 1) / BWD_BN, B * H), BWD_NT, BWD_SMEM, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(stats), static_cast<float*>(dq_acc),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), d);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dq_convert_kernel<<<row_blocks, 256, 0, s>>>(
      static_cast<const float*>(dq_acc), static_cast<bf16*>(dq), d);
  return static_cast<int>(cudaGetLastError());
}
