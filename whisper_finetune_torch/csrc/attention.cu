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
// Forward (attn_fwd_kernel): one block of one warpgroup (4 warps) per
// (batch*head, 64-query tile), three blocks an SM (168 registers, 73 KB),
// which run out of step and fill each other's waits. One thread asks TMA
// for the Q tile once and for the K and V tiles of 128 keys into a ring of
// two slots, one tile ahead, each slot with an mbarrier that counts its
// bytes; the tiles land in the 128-byte swizzle wgmma reads, rows past the
// end as zeros. Q moves into registers as the A operand of S = Q K^T (wgmma
// m64n128k16), so the products read only K and V from shared memory. The
// online softmax runs in the accumulator registers (scale and running
// maximum in one FMA, exp2 by the special-function unit, masks only in the
// tiles at the end of k or on the diagonal), P becomes bf16 A fragments
// without leaving the registers, and O += P V is wgmma with the V tile read
// down its rows. Under the causal mask the heads' query tiles with the most
// keys start first.
//
// What bounds the forward: at the encoder's and the cross-attention's shapes
// the operations, and among them the exponentials as much as the products.
// It does 256 tensor FLOP and one exp2 a score, and an SM does 4096 bf16
// FLOP but 16 exp2 a clock, so at D = 64 the exponentials alone take as long
// as the products (0.093 ms at the encoder's shape), with about four float32
// operations a score on top. Measured on an H100 (PERF.md), no one unit
// holds it: without the exp2 it is 10% faster, without P V 17%, without
// the K/V loads 7%; the rest is the latency of one warpgroup's chain of
// product, softmax and product, which three blocks an SM only partly hide
// (overlapping a block's own softmax with its products measured slower:
// registers). At the decoder's causal 448 x 448 the bytes bound it, and the
// launch's few, short blocks.
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

#include <cuda.h>  // CUtensorMap and its enums (the encoder comes from the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "common.cuh"

namespace {

using namespace wft;

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

constexpr int FWD_BM = 64;       // queries a block
constexpr int FWD_BN = 128;      // keys a tile
constexpr int FWD_NT = 128;      // one warpgroup; three blocks share an SM
constexpr int FWD_STAGES = 2;    // ring slots of (K, V) tiles: one in use, one in flight
constexpr int FWD_Q_BYTES = FWD_BM * 128;
constexpr int FWD_KV_BYTES = FWD_BN * 128;
// Shared memory of attn_fwd_kernel, in bytes from a 1024-byte aligned base.
constexpr int FWD_OFF_Q = 0;
constexpr int FWD_OFF_K = FWD_OFF_Q + FWD_Q_BYTES;
constexpr int FWD_OFF_V = FWD_OFF_K + FWD_STAGES * FWD_KV_BYTES;
constexpr int FWD_SMEM = FWD_OFF_V + FWD_STAGES * FWD_KV_BYTES + 1024;  // + alignment slack
// (the SM's 228 KB less 1 KB the system keeps for each block)
static_assert(3 * (FWD_SMEM + 1024) <= 228 * 1024, "attn_fwd_kernel: shared memory for three blocks an SM");

// One key tile of the online softmax for this thread's two rows (row and
// row + 8): s holds the scores Q K^T of the tile and becomes the
// probabilities exp2(s * sl2 - m), with m the rows' running maxima in log2
// units (scale and maximum in one FMA); l is this thread's share of the rows'
// running sums (its quad adds them up once, at the end) and alpha the factor
// by which the rows of O shrink. kEdge: keys at or past Tk and, under the
// causal mask, keys after the query score -inf first.
template <bool kEdge, int NT>
__device__ __forceinline__ void softmax_tile(float (&s)[NT][4], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float sl2, int row, int key0,
                                             int t, const Dims& d) {
  if (kEdge) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = key0 + acc_col(nt, j, t);
        if (!(col < d.Tk && (!d.causal || col <= row + 8 * (j >> 1)))) s[nt][j] = -INFINITY;
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx0 = -INFINITY, mx1 = -INFINITY;  // two chains
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt + 1][2 * r], s[nt + 1][2 * r + 1]));
    }
    const float m_new = fmaxf(m[r], quad_max(fmaxf(mx0, mx1)) * sl2);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
    alpha[r] = fast_exp2(m[r] - m_use);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p0 = fast_exp2(fmaf(s[nt][2 * r], sl2, -m_use));
      const float p1 = fast_exp2(fmaf(s[nt][2 * r + 1], sl2, -m_use));
      s[nt][2 * r] = p0;
      s[nt][2 * r + 1] = p1;
      sum0 += p0;
      sum1 += p1;
    }
    l[r] = l[r] * alpha[r] + (sum0 + sum1);
    m[r] = m_new;
  }
}

// One block per (batch*head, 64-query tile). Under the causal mask the grid
// is (B*H, query tiles) and a head's tiles run from the one with the most
// keys to the one with the fewest; otherwise (query tiles, B*H), so that the
// blocks of one head run side by side and share its K and V in L2. q, k, v
// come as TMA maps of boxes of 64 (q) and FWD_BN (k, v) rows.
template <bool kWriteLse>
__global__ void __launch_bounds__(FWD_NT, 3)
attn_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
                float* __restrict__ lse, Dims d) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[FWD_STAGES + 1];  // a slot's tile has landed; [FWD_STAGES]: Q
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = d.causal ? blockIdx.x : blockIdx.y;
  const int q0 = (d.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.x) * FWD_BM;
  const int b = bh / d.H, h = bh % d.H;
  const int k_end = d.causal ? min(d.Tk, q0 + FWD_BM) : d.Tk;
  const int n = (k_end + FWD_BN - 1) / FWD_BN;  // key tiles
  const uint32_t sQ = base + FWD_OFF_Q, bar = smem_u32(full);
  auto sK = [&](int j) { return base + FWD_OFF_K + (j % FWD_STAGES) * FWD_KV_BYTES; };
  auto sV = [&](int j) { return base + FWD_OFF_V + (j % FWD_STAGES) * FWD_KV_BYTES; };
  auto slot_bar = [&](int j) { return bar + 8 * (j % FWD_STAGES); };
  auto load_kv = [&](int j) {  // by thread 0
    if (j < n) {
      mbar_expect_tx(slot_bar(j), 2 * FWD_KV_BYTES);
      tma_load_4d(sK(j), &k_map, slot_bar(j), 0, j * FWD_BN, h, b);
      tma_load_4d(sV(j), &v_map, slot_bar(j), 0, j * FWD_BN, h, b);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= FWD_STAGES; ++i) mbar_init(bar + 8 * i, 1);
    fence_mbar_init();
    mbar_expect_tx(bar + 8 * FWD_STAGES, FWD_Q_BYTES);
    tma_load_4d(sQ, &q_map, bar + 8 * FWD_STAGES, 0, q0, h, b);
#pragma unroll
    for (int i = 0; i < FWD_STAGES - 1; ++i) load_kv(i);
  }
  __syncthreads();  // the barriers are initialised

  const float sl2 = d.scale * LOG2E;
  const int row = q0 + warp * 16 + g;  // and row + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;
  // Q as the A operand of S = Q K^T, in registers for the block's life.
  uint32_t qa[D / 16][4];
  mbar_wait(bar + 8 * FWD_STAGES, 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) tile_to_a(qa[kk], sQ, warp, g, t, kk);

  for (int j = 0; j < n; ++j) {
    if (j > 0) __syncthreads();  // every warp is done with tile j-1: its slot is free
    if (tid == 0) load_kv(j + FWD_STAGES - 1);
    mbar_wait(slot_bar(j), (j / FWD_STAGES) & 1);  // tile j has landed
    // S = Q K^T: Q from the registers, the K tile K-major (rows = keys, the
    // head dim summed along them).
    float s[FWD_BN / 8][4];
    const uint64_t dK = wg_desc(sK(j));
    wg_fence();
    wgmma_rs_n128_first<0>(s, qa[0], dK);
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk) wgmma_rs_n128<0>(s, qa[kk], dK + kk * WG_K_STEP);
    wg_commit();
    wg_wait<0>();
    wg_acc_fence(s);
    const int key0 = j * FWD_BN;
    // Masks only where the tile touches the end of k or the diagonal.
    if (key0 + FWD_BN > d.Tk || (d.causal && key0 + FWD_BN - 1 > q0))
      softmax_tile<true>(s, m, l, alpha, sl2, row, key0, t, d);
    else
      softmax_tile<false>(s, m, l, alpha, sl2, row, key0, t, d);
    uint32_t pa[FWD_BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < FWD_BN / 16; ++kk) acc_to_a(pa[kk], s, kk);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[nt][jj] *= alpha[jj >> 1];
    // O += P V_j: P from the registers, the V tile read down its rows (the
    // keys are the summed dim).
    wg_acc_fence(acc);
    wg_fence();
    const uint64_t dV = wg_desc(sV(j));
#pragma unroll
    for (int kk = 0; kk < FWD_BN / 16; ++kk) wgmma_rs_n64<1>(acc, pa[kk], dV + kk * WG_MN_STEP);
    wg_commit();
    wg_wait<0>();
    wg_acc_fence(acc);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_row = quad_sum(l[r]);  // every lane of the quad takes part
    if (row + 8 * r >= d.Tq) continue;
    const float inv = l_row > 0.f ? 1.f / l_row : 0.f;
    bf16* orow = o + b * d.sqb + h * d.sqh + (long long)(row + 8 * r) * d.sqt;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<uint32_t*>(orow + nt * 8 + t * 2) =
          pack_f2(acc[nt][2 * r] * inv, acc[nt][2 * r + 1] * inv);
    if (kWriteLse && t == 0)
      lse[(long long)bh * d.Tq + row + 8 * r] =
          l_row > 0.f ? (m[r] + log2f(l_row)) * LN2 : INFINITY;
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

// Both kernels take more shared memory than the 48 KB a kernel gets unasked:
// the limit is raised once for each device, at that device's first call (not
// once a launch: a training step makes dozens, some under graph capture).
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, int bytes, bool (&raised)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev >= 0 && dev < 64 && raised[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev >= 0 && dev < 64) raised[dev] = true;
  return err;
}

// cuTensorMapEncodeTiled, found through the runtime (nothing links libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The TMA map of a (B, H, T, 64) bf16 tensor with strides (sb, sh, st)
// elements: boxes of `rows` rows x 64, 128-byte swizzled, rows past T read
// as zeros.
cudaError_t tensor_map(CUtensorMap* map, const void* base, int B, int H, int T, long long sb,
                       long long sh, long long st, int rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[4] = {64, (cuuint64_t)T, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1}, unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t allow_fwd_smem(bool with_lse) {
  static bool raised_lse[64] = {}, raised_nolse[64] = {};
  return with_lse ? allow_smem(attn_fwd_kernel<true>, FWD_SMEM, raised_lse)
                  : allow_smem(attn_fwd_kernel<false>, FWD_SMEM, raised_nolse);
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
  const bool with_lse = lse != nullptr;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = allow_fwd_smem(with_lse);
  if (err == cudaSuccess) err = tensor_map(&q_map, q, B, H, Tq, sqb, sqh, sqt, FWD_BM);
  if (err == cudaSuccess) err = tensor_map(&k_map, k, B, H, Tk, skb, skh, skt, FWD_BN);
  if (err == cudaSuccess) err = tensor_map(&v_map, v, B, H, Tk, skb, skh, skt, FWD_BN);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned q_tiles = (Tq + FWD_BM - 1) / FWD_BM, bh = B * H;
  const dim3 grid = causal ? dim3(bh, q_tiles) : dim3(q_tiles, bh);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (with_lse)
    attn_fwd_kernel<true><<<grid, FWD_NT, FWD_SMEM, s>>>(
        q_map, k_map, v_map, static_cast<bf16*>(o), static_cast<float*>(lse), WFT_DIMS);
  else
    attn_fwd_kernel<false><<<grid, FWD_NT, FWD_SMEM, s>>>(
        q_map, k_map, v_map, static_cast<bf16*>(o), nullptr, WFT_DIMS);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the forward (the instance with the log-sum-exp if with_lse) that
// fit on one SM at once, by the occupancy calculator, and the dynamic shared
// memory a block asks for.
extern "C" int wft_attn_fwd_occupancy(int with_lse, int* blocks, int* smem_bytes) {
  cudaError_t err = allow_fwd_smem(with_lse);
  if (err == cudaSuccess)
    err = with_lse ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, attn_fwd_kernel<true>,
                                                                    FWD_NT, FWD_SMEM)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, attn_fwd_kernel<false>,
                                                                    FWD_NT, FWD_SMEM);
  *smem_bytes = FWD_SMEM;
  return static_cast<int>(err);
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
  static bool raised[64] = {};
  cudaError_t err = allow_smem(attn_bwd_kernel, BWD_SMEM, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
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
