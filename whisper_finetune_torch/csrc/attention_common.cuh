// Device helpers shared by the attention kernels: the launch geometry, the
// accumulator's register layout and its packing into bf16 A fragments, and
// the pieces of an asynchronous pipeline on Hopper: cp.async copies with zero
// fill into 128-byte-swizzled tiles, TMA tile loads counted on mbarriers,
// wgmma products on such tiles (A from shared memory or registers), bulk
// reductions from shared to device memory, and the special-function unit's
// exp2. The forward is built on the TMA loads, the fused backward on
// cp.async; both on the rest.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wft {

typedef __nv_bfloat16 bf16;

constexpr int D = 64;  // head dim: one row is 128 bytes of bf16
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Dims {
  int B, H, Tq, Tk;
  long long sqb, sqh, sqt;  // q / o / do / dq strides, in elements
  long long skb, skh, skt;  // k / v / dk / dv strides
  float scale;
  int causal;
};

// ---------------------------------------------------------------------------
// The accumulator's register layout (that of an mma.sync m16n8k16 C fragment,
// which wgmma keeps: see below) and its A fragments
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment for k-step kk from a 16 x N float accumulator held as N/8 C
// fragments (the C layout of n-tiles 2kk, 2kk+1 is the A layout of kk).
__device__ __forceinline__ void acc_to_a(uint32_t* a, float (*c)[4], int kk) {
  a[0] = pack_f2(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_f2(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_f2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_f2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Column (key or query) of accumulator entry (nt, j) relative to the tile;
// its row is g (j < 2) or g + 8, with g = lane / 4 and t = lane % 4.
__device__ __forceinline__ int acc_col(int nt, int j, int t) {
  return nt * 8 + t * 2 + (j & 1);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// Swizzled tiles: rows of 64 bf16 (128 bytes, eight 16-byte chunks); chunk c
// of row r lives at chunk c ^ (r & 7). A tile's base is 1024-byte aligned, so
// this is the 128-byte swizzle wgmma descriptors and TMA use; eight rows of
// one chunk, like eight chunks of a row, touch every bank once.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (src must
// still be an address inside the tensor).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// `rows` rows x 64 bf16 from global (row stride st elements, first row row0)
// into a swizzled tile, by all `nthreads` threads; rows at or past T arrive
// as zeros.
__device__ __forceinline__ void tile_cp_async(uint32_t tile, const bf16* base,
                                              long long st, int row0, int T,
                                              int rows, int tid, int nthreads) {
  for (int i = tid; i < rows * 8; i += nthreads) {
    const int r = i >> 3, c = i & 7;
    const bool valid = row0 + r < T;
    const bf16* src = base + (long long)(valid ? row0 + r : 0) * st + c * 8;
    cp_async16(tile + swz(r, c), src, valid);
  }
}

// ---------------------------------------------------------------------------
// wgmma (sm_90a): a warpgroup (four warps) multiplies a 64-row A by a B tile
// from shared memory into float32 accumulators in registers, asynchronously.
// The accumulator of m64nN is laid out like N/8 mma.sync C fragments a warp
// (warp w of the group owns rows 16w..16w+15), and an A operand in registers
// like the mma.sync A fragment, so acc_to_a and acc_col serve both.
//
// Shared-memory operands are 128-byte-swizzled tiles of 128-byte rows (see
// swz) named by a 64-bit descriptor: start address, a leading-dim offset that
// these single-atom shapes do not use, 1024 bytes from one 8-row group to the
// next, swizzle mode 1 (128 B). A tile serves two ways:
//   "K-major" (transpose flag 0): the tile's rows are the M (or N) index and
//   the 64 values of a row the summed dim; one k16 step is 32 bytes further
//   along the row;
//   "MN-major" (transpose flag 1): the tile's rows are the summed dim and a
//   row holds up to 64 M (or N) values; one k16 step is 16 rows (2048 bytes)
//   further down.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  const uint64_t enc_addr = (addr & 0x3FFFFu) >> 4;
  return enc_addr | (uint64_t(16 >> 4) << 16) | (uint64_t(1024 >> 4) << 32) | (1ull << 62);
}

// One k16 step further: 32 bytes along a K-major tile, 2048 down an MN-major one.
constexpr uint64_t WG_K_STEP = 32 >> 4;
constexpr uint64_t WG_MN_STEP = 2048 >> 4;

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Writes to shared memory by ordinary stores or cp.async become visible to
// wgmma (which reads through the asynchronous proxy) after this fence and a
// barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#define WFT_ACC4(d, n) "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3])
#define WFT_ACC16(d, n) WFT_ACC4(d, n), WFT_ACC4(d, n + 1), WFT_ACC4(d, n + 2), WFT_ACC4(d, n + 3)
#define WFT_ACC32(d) WFT_ACC16(d, 0), WFT_ACC16(d, 4)

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it.
template <int NT>
__device__ __forceinline__ void wg_acc_fence(float (&d)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
    asm volatile("" : "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3]) :: "memory");
}

#define WFT_OUT4(d, n) "=f"(d[n][0]), "=f"(d[n][1]), "=f"(d[n][2]), "=f"(d[n][3])
#define WFT_OUT16(d, n) WFT_OUT4(d, n), WFT_OUT4(d, n + 1), WFT_OUT4(d, n + 2), WFT_OUT4(d, n + 3)
#define WFT_OUT32(d) WFT_OUT16(d, 0), WFT_OUT16(d, 4)

#define WFT_D32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64) = A (descriptor a) * B (descriptor b), one k16 step that
// overwrites d (no need to zero it first). TA / TB: 0 for a K-major tile, 1
// for an MN-major one.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64_first(float (&d)[8][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WFT_D32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : WFT_OUT32(d)
      : "l"(a), "l"(b), "r"(0), "n"(TA), "n"(TB));
}

// d (64 x 64) += A (descriptor a) * B (descriptor b), one k16 step.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WFT_D32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : WFT_ACC32(d)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 64) += A (registers: this thread's A fragment of the k16 step) * B
// (descriptor b; TB as above).
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4], const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WFT_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : WFT_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
}

#define WFT_ACC64(d) WFT_ACC16(d, 0), WFT_ACC16(d, 4), WFT_ACC16(d, 8), WFT_ACC16(d, 12)
#define WFT_OUT64(d) WFT_OUT16(d, 0), WFT_OUT16(d, 4), WFT_OUT16(d, 8), WFT_OUT16(d, 12)
#define WFT_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128) = A (registers) * B (descriptor b; TB as above), one k16 step
// that overwrites d.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n128_first(float (&d)[16][4], const uint32_t* a,
                                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WFT_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : WFT_OUT64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0), "n"(TB));
}

// d (64 x 128) += A (registers) * B (descriptor b), one k16 step.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WFT_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : WFT_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
}

// This thread's A fragment (16 x 16 of its warp's rows, as acc_to_a gives
// it) of k16 step kk from a swizzled tile of 64 rows: rows 16w + g and
// 16w + g + 8, columns 16kk + 2t, +1 and 16kk + 8 + 2t, +1.
__device__ __forceinline__ void tile_to_a(uint32_t* a, uint32_t tile, int warp, int g, int t,
                                          int kk) {
  const int r = warp * 16 + g;
  const uint32_t lo = tile + 4 * t;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    asm volatile("ld.shared.b32 %0, [%1];\n"
                 : "=r"(a[i]) : "r"(lo + swz(r + 8 * (i & 1), 2 * kk + (i >> 1))) : "memory");
}

// ---------------------------------------------------------------------------
// TMA: one thread asks the copy engine for a whole tile of a tensor described
// by a tensor map (built on the host, passed as a __grid_constant__ kernel
// parameter), written into shared memory in the map's swizzle, rows past the
// tensor's end as zeros. Completion is counted in bytes on an mbarrier, which
// the consumers wait on; the copy writes through the asynchronous proxy, so
// wgmma reads the tile without a proxy fence.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

// After the mbarriers are initialised, before any thread or copy uses them.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of copies to come.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Until the phase with this parity has completed. A phase that never
// completes is a fault (a copy that cannot land), so after about 2**26 polls
// the kernel traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// The box of a 4-D map at coordinates (c0 innermost .. c3) into shared memory
// at dst, counted on bar.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map, uint32_t bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------------
// Bulk reduction shared -> global: the copy engine adds `bytes` of float32
// from shared memory onto device memory (element-wise atomic adds); issued by
// one thread, tracked by bulk groups. The source must stay untouched until
// bulk_wait_read lets it go.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void bulk_reduce_add_f32(float* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
               :: "l"(dst), "r"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until at most N of this thread's bulk groups still read their source.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// Until at most N of this thread's bulk groups are still under way at all:
// their reads of shared memory and their writes to device memory are done.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}

// 2**x by the special-function unit alone (relative error 2**-22; exp2f adds
// range handling the softmax does not need: its arguments are <= 0 up to
// rounding, and a flushed denormal is a probability of 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace wft
