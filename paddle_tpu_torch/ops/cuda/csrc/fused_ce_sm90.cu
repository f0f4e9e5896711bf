// The 16-bit (bf16 or f16) fused cross-entropy for Hopper (sm_90a): the
// forward, and dh, dW and db from ONE recompute of the logits, every
// product on register-resident tensor-core tiles.
//
// Replaces, on its bf16 / f16 path (H a multiple of 64, at most 1024), the
// three TPU Pallas kernels of paddle_tpu/ops/pallas/fused_ce.py:
//   _ce_fwd_kernel    (:41) -> ce_sm90_fwd_kernel (+ ce_sm90_fwd_combine_
//                              kernel, the merge of the vocab ranges)
//   _ce_bwd_dh_kernel (:145) and _ce_bwd_dw_kernel (:173)
//       -> ce_sm90_chunk_kernel (its ds pass: the shared recompute, ds and
//          db's partial sums; its dh pass + ce_sm90_dh_reduce_kernel: dh;
//          its dW pass: dW and db), after ce_sm90_gather_kernel
// f32 and other H keep the kernels of fused_ce.cu, which also holds the
// valid-row list (fused_ce_valid_rows) the backward reads.
//
// Contract (as fused_ce.cu): for hidden h [n, H], weight W [V, H], optional
// bias b [V], labels y [n], the saved lse [n] and the upstream g [n]:
// in T (bf16 or f16: every kernel is a template on it, and only wgmma's
// type string and the rounding of f32 values to T differ):
//   s_iv = h_i . W_v + b_v (f32 products, T bias); columns >= V masked
//   forward  lse_i = m + log(max(l, 1e-30)) over s_i (every row, ignored
//            ones too), loss_i = lse_i - s_{i, y_i}, 0 where y_i == ignore
//   ds_iv = (exp(s_iv - lse_i) - [v == y_i]) * g_i
//   dh = ds . W, dW = ds^T . h (ds rounded to T for both, as the TPU
//   kernel and the plain version round it), db = sum_i ds_i (f32, unrounded)
// Ignored rows (not in the valid-row list) have ds = 0; a label outside
// [0, V) matches no column (its loss is lse). Products accumulate in f32;
// outputs are rounded once to T. No atomics: every output element has
// one writer and every sum a fixed order, so two launches give the same
// bits.
//
// What bounds it: operations. At GPT-2's head (n 4096 valid rows, H 768,
// V 50304) each product is 2 n H V = 316.5 GFLOP, 0.320 ms at the H100
// SXM's 989 TFLOP/s dense bf16: the forward needs one, dh + dW three (the
// recompute, ds . W, ds^T . h): 0.960 ms. The bytes (h, W, b, y, lse, g
// once, dh, dW, db once) are ~170 MB, 0.05 ms at 3.35 TB/s. fused_ce.cu
// ran 64 x 64 WMMA logits tiles through shared memory, recomputed the
// logits in each of its two backward kernels (four products), kept its
// accumulators in shared memory and reread W and h per 32-row block. Here:
//   * the forward runs the GEMM main loop below over K = H for each
//     128 x 128 tile of logits and folds the tile into a running max, sum
//     and label logit per row in registers (ce_sm90_fwd_kernel): a block
//     owns a row tile and a range of vocab tiles, the ranges sized so that
//     the row tiles fill the SMs in one wave, and the partials of the
//     ranges are merged in order. The epilogue is kept lean, since the SM
//     does it between products: the label is looked for only in the tile
//     and thread that hold it, the ragged mask only on the last tile, one
//     FFMA and one ex2 per element. On the H100 (PERF.md) a first epilogue
//     that tested every element for the label and the mask was slower, and
//     the GEMM with a bare epilogue (a sum of the tile) takes most of the
//     forward's time: the main loop, not the epilogue, bounds it now;
//   * the backward gathers the valid rows of h, lse, g and y into compact
//     arrays once (ce_sm90_gather_kernel): every operand below is dense;
//   * the vocab is walked in chunks of Vc columns (the wrapper's schedule),
//     with three passes of ONE GEMM main loop and three epilogues:
//       ds pass  S = h_c . W[chunk]^T over K = H; the epilogue forms ds in
//                f32 from lse, g, y and b, writes it rounded to bf16 into a
//                [n, Vc] scratch and the unrounded column sums of each
//                128-row tile into dbp;
//       dh pass  part[slot] += ds . W[chunk] over K = Vc, f32 partial sums
//                read and written by the epilogue, chunks in order; few
//                valid rows split K over `slot`s (fixed order, chosen on the
//                card from the count) to keep the SMs busy;
//       dW pass  dW[chunk] = ds^T . h_c over K = the valid rows (count read
//                on the card), written once in bf16; its first column of
//                blocks also sums dbp into db for the chunk;
//     the [n, V] logits never exist, only two chunks of ds do;
//   * the chunks are pipelined: launch c runs the dh and dW passes of chunk
//     c - 1 (long, first in the grid) and the ds pass of chunk c (short
//     blocks that fill the tail), on two ds buffers. Apart, each chunk's dh
//     and dW passes were 192 blocks for 132 SMs' 264 slots;
//   * the main loop: 128 x 128 block tiles, two warpgroups of 64 rows each,
//     f32 accumulators in registers, products by wgmma (m64 n128 k16, bf16
//     in, f32 accumulate) with both operands read from shared memory by
//     descriptor. K comes in steps of 64 through a three-stage cp.async ring
//     (16-byte copies, zero-fill past every edge: ragged n, V, chunk), one
//     barrier per step. Tiles are stored in the 128-byte swizzled layout
//     wgmma reads: K-major tiles as [rows][64], MN-major ones as 64-column
//     halves [64][64]. The transposed operands (ds read as A^T for dW, W and
//     h_c read row-major as B for dh and dW) are wgmma's MN-major operands:
//     nothing is transposed in memory;
//   * 97 KB of shared memory and 256 threads a block: two blocks per SM,
//     so one block's barrier and epilogue overlap the other's products.
//     Measured on the H100 (PERF.md), each slower than this: 128 x 256
//     tiles (m64 n256 products, one block per SM; 3 or 4 stages), and
//     keeping a step's products in flight across the next barrier.
// TMA and a warp-specialized, persistent schedule are later work (PERF.md).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int kBM = 128;                 // block tile rows
constexpr int kBN = 128;                 // block tile columns
constexpr int kBK = 64;                  // K per pipeline step
constexpr int kStages = 3;               // cp.async ring depth
constexpr int kThreads = 256;            // 2 warpgroups x 64 rows
constexpr int kTile = kBM * kBK;         // elements of one operand tile
constexpr int kMaxSplit = 8;             // dh pass: most K slots per chunk
constexpr int kMaxH = 1024;
// the ring, and 1 KB to align it to the 1024-byte swizzle atom
constexpr size_t kSmem = (size_t)kStages * 2 * kTile * 2 + 1024;   // 16-bit
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kBM == kBN, "one tile shape serves all three passes");

enum Pass { kDs = 0, kDh = 1, kDw = 2 };

// one vocab chunk as a pass sees it; T: the 16-bit element type of h, W,
// b, ds and the gradients (bf16 or f16)
template <typename T>
struct Chunk {
  T* ds;               // [n, Vc] its ds
  float* dbp;          // [row tiles of n, Vc] column sums of its ds, or null
  int v0, vc;          // first vocab column and width (vc 0: no chunk)
  int accumulate;      // dh pass: add to the partial sums (chunks after 0)
};

template <typename T>
struct Args {
  const T* h;          // [n, H] as given (gather)
  const T* w;          // [V, H]
  const T* bias;       // [V] or null
  const int* y;        // [n] labels (gather)
  const float* lse;    // [n] saved lse (gather)
  const float* g;      // [n] upstream gradient (gather)
  const int* rows;     // [n + 1] valid rows in order, their count last
  const int* pos;      // [n] row -> list position or -1
  T* hc;               // [n, H] listed rows of h; zero at and past count
  float* lse_c;        // [n] listed rows' lse (0 past count)
  float* g_c;          // [n] listed rows' g (0 past count)
  int* y_c;            // [n] listed rows' labels (-1 past count)
  float* part;         // dh partial sums [slots][R * kBM][H], or null
  T* dh;               // [n, H] or null
  T* dw;               // [V, H] or null
  T* db;               // [V] or null
  int n, H, V, Vc;     // Vc: a ds buffer's row stride, a multiple of kBN
  Chunk<T> fresh;      // the chunk whose ds pass this launch runs
  Chunk<T> done;       // the chunk whose dh and dW passes this launch runs
  int n_dh, n_dw;      // this launch's dh and dW blocks (then the ds ones)
  // the forward
  float* loss;         // [n]
  float* lse_out;      // [n]
  float* fpart;        // [3, splits, n] partial m (log2 units), l, t
  int ignore, splits;
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// K slots of the dh pass for `count` valid rows: as many as keep the
// block count near that of all n rows valid (so slots x row tiles of the
// count never exceed the row tiles of n: `part` holds them all)
__host__ __device__ __forceinline__ int dh_slots(int count, int n) {
  const int r = cdiv(count, kBM);
  if (r == 0) return 1;
  const int s = cdiv(n, kBM) / r;
  return s < 1 ? 1 : (s > kMaxSplit ? kMaxSplit : s);
}

// ---------------------------------------------------------------------------
// PTX: cp.async, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when !valid (nothing is read then)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 2^x by the SFU (flushes subnormal results to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A . B for one warpgroup: m64 n128 k16, TY (".bf16.bf16" or
// ".f16.f16") in, f32 accumulate,
// A and B from shared memory by descriptor; TA / TB: the operand is
// MN-major (1) or K-major (0)
#define CE_WGMMA(TY, TA, TB)                                                  \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32" TY " {"                   \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                              \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                              \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                              \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                              \
      "%56, %57, %58, %59, %60, %61, %62, %63"                                \
      "}, %64, %65, p, 1, 1, " #TA ", " #TB ";\n}\n"                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                   \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                   \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                   \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                   \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                   \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                   \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                   \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                   \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                    \
      : "l"(da), "l"(db), "r"(scale_d))                                       

template <typename T, int P>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da,
                                      uint64_t db) {
  const int scale_d = 1;
  if constexpr (std::is_same_v<T, f16>) {
    if constexpr (P == kDs)
      CE_WGMMA(".f16.f16", 0, 0);
    else if constexpr (P == kDh)
      CE_WGMMA(".f16.f16", 0, 1);
    else
      CE_WGMMA(".f16.f16", 1, 1);
  } else {
    if constexpr (P == kDs)
      CE_WGMMA(".bf16.bf16", 0, 0);
    else if constexpr (P == kDh)
      CE_WGMMA(".bf16.bf16", 0, 1);
    else
      CE_WGMMA(".bf16.bf16", 1, 1);
  }
}

// two f32 rounded to T, lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  if constexpr (std::is_same_v<T, f16>) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
}

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(f16 x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ f16 from_f32<f16>(float x) {
  return __float2half(x);
}

// ---------------------------------------------------------------------------
// shared-memory tiles in wgmma's 128-byte swizzled layout: a tile of R rows
// is stored as 64-column halves [R][64] (one half for a 64-column tile),
// rows of 128 bytes, the 16-byte chunk c of row r at chunk c ^ (r & 7), so
// the cp.async writes and the tensor cores' reads are free of bank
// conflicts. Every half starts on a 1024-byte boundary.
// ---------------------------------------------------------------------------

template <int R>
__device__ __forceinline__ int lay(int r, int c) {   // c: 16-byte chunk
  return (c >> 3) * (R * 64) + r * 64 + (((c & 7) ^ (r & 7)) << 3);
}

// rows r0 .. r0+R, columns c0 .. c0+C of a row-major matrix (row stride
// ld) into a tile laid out by lay<R>; rows at and past r_end and 8-column
// chunks at and past c_end are zeros
template <int R, int C, typename T>
__device__ __forceinline__ void tile_async(T* dst, const T* src,
                                           int64_t ld, int r0, int r_end,
                                           int c0, int c_end) {
  constexpr int CPR = C / 8;
  static_assert(R * CPR % kThreads == 0, "tile split");
#pragma unroll
  for (int i = 0; i < R * CPR / kThreads; ++i) {
    const int u = threadIdx.x + i * kThreads;
    const int r = u / CPR, c = u % CPR;
    const bool ok = r0 + r < r_end && c0 + c * 8 < c_end;
    cp_async16(smem_addr(dst + lay<R>(r, c)),
               ok ? src + (int64_t)(r0 + r) * ld + c0 + c * 8 : src, ok);
  }
}

// wgmma's shared-memory matrix descriptor, 128-byte swizzle: start address,
// the leading-dimension byte offset (MN-major: between 64-column halves;
// unused K-major) and the stride byte offset (between 8-row groups)
template <typename T>
__device__ __forceinline__ uint64_t desc(const T* p, uint32_t lbo) {
  const uint32_t a = smem_addr(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// ---------------------------------------------------------------------------
// the GEMM main loop, shared by the three passes: C[128 x 128] = A . B over
// K steps kt0 .. kt1 (of kBK), into per-warpgroup 64 x 128 register tiles
// ---------------------------------------------------------------------------

// One K step's operand tiles into a ring stage. A: [kBM][kBK] K-major
// (ds pass: h_c; dh pass: ds) or [kBK][kBM] M-major (dW pass: ds read as
// A^T). B: [kBN][kBK] K-major (ds pass: W rows) or [kBK][kBN] N-major (dh
// pass: W rows; dW pass: h_c).
template <typename T, int P>
__device__ __forceinline__ void load_stage(const Args<T>& a, const Chunk<T>& ch,
                                           T* a_s, T* b_s, int m0,
                                           int n0, int k0) {
  const T* wc = a.w + (int64_t)ch.v0 * a.H;
  if constexpr (P == kDs) {
    tile_async<kBM, kBK>(a_s, a.hc, a.H, m0, a.n, k0, a.H);
    tile_async<kBN, kBK>(b_s, wc, a.H, n0, ch.vc, k0, a.H);
  } else if constexpr (P == kDh) {
    tile_async<kBM, kBK>(a_s, ch.ds, a.Vc, m0, a.n, k0, a.Vc);
    tile_async<kBK, kBN>(b_s, wc, a.H, k0, ch.vc, n0, a.H);
  } else {
    tile_async<kBK, kBM>(a_s, ch.ds, a.Vc, k0, a.n, m0, a.Vc);
    tile_async<kBK, kBN>(b_s, a.hc, a.H, k0, a.n, n0, a.H);
  }
}

// the four k16 products of one K step for warpgroup wg (tile rows 64 wg ..
// 64 wg + 64): the descriptors step 32 bytes along a K-major row, or 16
// rows (2048 bytes) down an MN-major half
template <typename T, int P>
__device__ __forceinline__ void mma_step(float (&acc)[64], const T* a_s,
                                         const T* b_s, int wg) {
  constexpr uint32_t kHalf = kBK * 64 * sizeof(T);   // MN-major halves
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t da =
        P == kDw ? desc(a_s + wg * kBK * 64 + kk * 16 * 64, kHalf)
                 : desc(a_s + wg * 64 * kBK + kk * 16, 16);
    const uint64_t db = P == kDs ? desc(b_s + kk * 16, 16)
                                 : desc(b_s + kk * 16 * 64, kHalf);
    wgmma<T, P>(acc, da, db);
  }
}

template <typename T, int P>
__device__ __forceinline__ void main_loop(const Args<T>& a, const Chunk<T>& ch,
                                          float (&acc)[64], T* smem,
                                          int m0, int n0, int kt0, int kt1) {
  const int wg = threadIdx.x >> 7;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const int nk = kt1 - kt0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_stage<T, P>(a, ch, smem + 2 * s * kTile, smem + (2 * s + 1) * kTile,
                    m0, n0, (kt0 + s) * kBK);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();   // this thread's copies, visible to the products
    __syncthreads();       // step t landed; every product of t - 1 is done
    const int nx = t + kStages - 1;
    if (nx < nk) {         // into the stage step t - 1 used
      const int st = nx % kStages;
      load_stage<T, P>(a, ch, smem + 2 * st * kTile,
                    smem + (2 * st + 1) * kTile, m0, n0, (kt0 + nx) * kBK);
    }
    cp_async_commit();
    const int st = t % kStages;
    wgmma_fence();
    mma_step<T, P>(acc, smem + 2 * st * kTile, smem + (2 * st + 1) * kTile, wg);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc);
  }
  cp_async_wait<0>();
  __syncthreads();         // the ring is free for the epilogue
}

// ---------------------------------------------------------------------------
// the three passes, each one block's 128 x 128 tile. Accumulator element
// acc[4 j + e] of thread t is tile row 64 (t / 128) + 16 (t / 32 % 4) +
// (t % 32) / 4 + 8 (e / 2), column 8 j + 2 (t % 4) + e % 2 (wgmma's m64
// layout, j = 0 .. 15).
// ---------------------------------------------------------------------------

// block b of the ds pass of chunk ch: listed rows x chunk columns, K = H
template <typename T>
__device__ __forceinline__ void ds_pass(const Args<T>& a,
                                        const Chunk<T>& ch, int b,
                                        int count, T* smem) {
  const int col_tiles = cdiv(ch.vc, kBN);
  const int rt = b / col_tiles;
  const int m0 = rt * kBM, n0 = b % col_tiles * kBN;
  if (m0 >= count) return;   // past the listed rows
  float acc[64];
  main_loop<T, kDs>(a, ch, acc, smem, m0, n0, 0, a.H / kBK);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = m0 + 16 * warp + (lane >> 2);
  const int col0 = n0 + 2 * (lane & 3);
  float lse2[2], g[2];
  int label[2];
  bool live[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row0 + 8 * hf;
    live[hf] = r < count;
    lse2[hf] = live[hf] ? a.lse_c[r] * kLog2e : 0.f;
    g[hf] = live[hf] ? a.g_c[r] : 0.f;
    label[hf] = live[hf] ? a.y_c[r] : -1;
  }
  float* red = reinterpret_cast<float*>(smem);   // [8 warps][kBN]
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = col0 + 8 * j;      // chunk column of e % 2 == 0
    float bv[2], csum[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e)
      bv[e] = a.bias != nullptr && c + e < ch.vc
                  ? to_f32(a.bias[ch.v0 + c + e]) : 0.f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row0 + 8 * hf;
      float d2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = ch.v0 + c + e;
        float v = 0.f;
        if (live[hf] && c + e < ch.vc) {
          const float p = exp2f(
              fmaf(acc[4 * j + 2 * hf + e] + bv[e], kLog2e, -lse2[hf]));
          v = (p - (col == label[hf] ? 1.f : 0.f)) * g[hf];
        }
        d2[e] = v;
        csum[e] += v;
      }
      if (r < a.n)   // rounded to T, as the TPU kernel rounds ds
        *reinterpret_cast<uint32_t*>(ch.ds + (int64_t)r * a.Vc + c) =
            pack<T>(d2[0], d2[1]);
    }
    if (ch.dbp != nullptr) {
      // the warp's column sums over its 16 rows (the 8 row groups by
      // shuffles), for a fixed-order sum over the warps below
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = csum[e];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (lane < 4) red[warp * kBN + 8 * j + 2 * lane + e] = s;
      }
    }
  }
  if (ch.dbp != nullptr) {
    __syncthreads();
    if (threadIdx.x < kBN) {
      float s = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) s += red[w * kBN + threadIdx.x];
      ch.dbp[(int64_t)rt * a.Vc + n0 + threadIdx.x] = s;
    }
  }
}

// unit b of the dh pass of chunk ch: listed rows x H, K = the chunk, split
// in slots
template <typename T>
__device__ __forceinline__ void dh_pass(const Args<T>& a,
                                        const Chunk<T>& ch, int b,
                                        int count, T* smem) {
  const int R = cdiv(count, kBM);
  const int slots = dh_slots(count, a.n);
  const int ht = cdiv(a.H, kBN);
  if (b >= R * ht * slots) return;
  const int n0 = b % ht * kBN, m0 = b / ht % R * kBM, slot = b / (ht * R);
  const int nk = cdiv(ch.vc, kBK);
  float acc[64];
  main_loop<T, kDh>(a, ch, acc, smem, m0, n0, slot * nk / slots,
                 (slot + 1) * nk / slots);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = m0 + 16 * warp + (lane >> 2);
  const int col0 = n0 + 2 * (lane & 3);
  float* out = a.part + (int64_t)slot * R * kBM * a.H;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float* row = out + (int64_t)(row0 + 8 * hf) * a.H;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = col0 + 8 * j;
      if (c < a.H) {
        float2* p = reinterpret_cast<float2*>(row + c);
        float2 v = make_float2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
        if (ch.accumulate) {
          const float2 o = *p;
          v.x += o.x;
          v.y += o.y;
        }
        *p = v;
      }
    }
  }
}

// block b of the dW pass of chunk ch: chunk rows x H, K = the listed rows
template <typename T>
__device__ __forceinline__ void dw_pass(const Args<T>& a,
                                        const Chunk<T>& ch, int b,
                                        int count, T* smem) {
  const int ht = cdiv(a.H, kBN);
  const int n0 = b % ht * kBN, m0 = b / ht * kBM;
  int kt1;
  kt1 = (count + kBK - 1) / kBK;   // dW: K = the listed rows
  float acc[64];
  main_loop<T, kDw>(a, ch, acc, smem, m0, n0, 0, kt1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = m0 + 16 * warp + (lane >> 2);
  const int col0 = n0 + 2 * (lane & 3);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row0 + 8 * hf;     // chunk row
    if (r < ch.vc) {
      T* out = a.dw + (int64_t)(ch.v0 + r) * a.H;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = col0 + 8 * j;
        if (c < a.H)
          *reinterpret_cast<uint32_t*>(out + c) =
              pack<T>(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
      }
    }
  }
  // db of the chunk's rows m0 .. m0+128: the ds pass's row-tile sums, in
  // order (the blocks of the first H tile do it)
  if (a.db != nullptr && n0 == 0 && threadIdx.x < kBM) {
    const int r = m0 + threadIdx.x;
    if (r < ch.vc) {
      const int tiles = cdiv(count, kBM);
      float s = 0.f;
      for (int t = 0; t < tiles; ++t) s += ch.dbp[(int64_t)t * a.Vc + r];
      a.db[ch.v0 + r] = from_f32<T>(s);
    }
  }
}

// one launch of the chunk pipeline: blocks [0, n_dh) the dh pass and
// [n_dh, n_dh + n_dw) the dW pass of chunk `done`, the rest the ds pass of
// chunk `fresh`
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    ce_sm90_chunk_kernel(const Args<T> a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  const int count = a.rows[a.n];
  int b = blockIdx.x;
  if (b < a.n_dh) {
    dh_pass<T>(a, a.done, b, count, smem);
    return;
  }
  b -= a.n_dh;
  if (b < a.n_dw) {
    dw_pass<T>(a, a.done, b, count, smem);
    return;
  }
  ds_pass<T>(a, a.fresh, b - a.n_dw, count, smem);
}

// ---------------------------------------------------------------------------
// the forward: per-token lse and loss with an online-softmax epilogue on the
// ds pass's GEMM (S = h . W^T over K = H); the logits are never written
// ---------------------------------------------------------------------------

// Block b: row tile b % R (R row tiles of 128) and vocab range b / R of
// `splits` near-equal ranges of 128-column tiles. The row tiles of one range
// are neighbours in the grid, so they run together and read each W tile
// from L2 at about the same time: W is read from device memory about once.
// The block walks its vocab tiles as one stream of K steps through the
// ring, so the next tile's first loads are in flight during a tile's
// epilogue. Per tile, each thread folds its 2 rows x 32 columns of the
// accumulator into a running (m, l, t) in registers: m the row max in log2
// units (shared by the row's quad after shuffles), l this thread's part of
// the sum of exp2(s - m), t the label logit (added by the thread whose
// column is the label). The quad sums l and t at the end; the partials go
// to fpart, merged in split order by ce_sm90_fwd_combine_kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    ce_sm90_fwd_kernel(const Args<T> a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  const int R = cdiv(a.n, kBM);
  const int rt = blockIdx.x % R, split = blockIdx.x / R;
  const int nvt = cdiv(a.V, kBN);
  const int vt0 = (int)((int64_t)split * nvt / a.splits);
  const int vt1 = (int)((int64_t)(split + 1) * nvt / a.splits);
  const int m0 = rt * kBM;
  Chunk<T> all{};         // the whole vocab: W rows at and past V read as zeros
  all.vc = a.V;
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = m0 + 16 * warp + (lane >> 2);
  int label[2];          // -1: no column (ignored, outside [0, V), no row)
  float m[2], l[2], t[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row0 + 8 * hf;
    const int y = r < a.n ? a.y[r] : -1;
    label[hf] = y >= 0 && y < a.V ? y : -1;
    m[hf] = -CUDART_INF_F;
    l[hf] = t[hf] = 0.f;
  }
  const int nk = a.H / kBK;
  const int total = (vt1 - vt0) * nk;   // K steps over all the block's tiles
  // the step that the next load fills: tile lv, K step lk
  int lv = vt0, lk = 0;
  auto load_next = [&](int stage) {
    load_stage<T, kDs>(a, all, smem + 2 * stage * kTile,
                    smem + (2 * stage + 1) * kTile, m0, lv * kBN, lk * kBK);
    if (++lk == nk) {
      lk = 0;
      ++lv;
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_next(s);
    cp_async_commit();
  }
  float acc[64];
  int vt = vt0, kt = 0;
  for (int u = 0; u < total; ++u) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();   // this thread's copies, visible to the products
    __syncthreads();       // step u landed; every product of u - 1 is done
    if (u + kStages - 1 < total) load_next((u + kStages - 1) % kStages);
    cp_async_commit();
    if (kt == 0) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    }
    const int st = u % kStages;
    wgmma_fence();
    mma_step<T, kDs>(acc, smem + 2 * st * kTile, smem + (2 * st + 1) * kTile,
                  wg);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc);
    if (++kt < nk) continue;
    // epilogue of vocab tile vt: + bias, the label logit, columns at and
    // past V out, then the running max (log2 units) and sum
    kt = 0;
    const int n0 = vt++ * kBN;
    const int col0 = n0 + 2 * (lane & 3);   // this thread's columns: col0 +
                                            // 8 j + e, j < 16, e < 2
    if (a.bias != nullptr) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + 8 * j + e;
          const float bv =
              col < a.V ? to_f32(a.bias[col]) : 0.f;
          acc[4 * j + e] += bv;
          acc[4 * j + 2 + e] += bv;
        }
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      // the label logit, from the one thread whose columns hold it
      const int lc = label[hf] - col0;
      if (lc >= 0 && lc < 8 * 16 && (lc & 7) < 2) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (lc == 8 * j + e) t[hf] += acc[4 * j + 2 * hf + e];
      }
    }
    if (n0 + kBN > a.V) {   // the ragged last tile
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (col0 + 8 * j + e >= a.V)
            acc[4 * j + e] = acc[4 * j + 2 + e] = -CUDART_INF_F;
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        mx = fmaxf(mx, fmaxf(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m2 = fmaxf(m[hf], mx * kLog2e);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        ps += ex2(fmaf(acc[4 * j + 2 * hf], kLog2e, -m2)) +
              ex2(fmaf(acc[4 * j + 2 * hf + 1], kLog2e, -m2));
      l[hf] = l[hf] * ex2(m[hf] - m2) + ps;
      m[hf] = m2;
    }
  }
  cp_async_wait<0>();
  const int64_t sn = (int64_t)a.splits * a.n;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float ls = l[hf], ts = t[hf];
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    ts += __shfl_xor_sync(0xffffffffu, ts, 1);
    ts += __shfl_xor_sync(0xffffffffu, ts, 2);
    const int r = row0 + 8 * hf;
    if ((lane & 3) == 0 && r < a.n) {
      const int64_t at = (int64_t)split * a.n + r;
      a.fpart[at] = m[hf];
      a.fpart[sn + at] = ls;
      a.fpart[2 * sn + at] = ts;
    }
  }
}

// lse and loss of each row from the vocab ranges' partial (m, l, t), merged
// in range order: lse = M + log(max(l, 1e-30)), loss 0 where y == ignore
template <typename T>
__global__ void __launch_bounds__(256)
    ce_sm90_fwd_combine_kernel(const Args<T> a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.n) return;
  const int64_t sn = (int64_t)a.splits * a.n;
  float M = -CUDART_INF_F;
  for (int s = 0; s < a.splits; ++s)
    M = fmaxf(M, a.fpart[(int64_t)s * a.n + r]);
  float l = 0.f, t = 0.f;
  for (int s = 0; s < a.splits; ++s) {
    const int64_t at = (int64_t)s * a.n + r;
    l += a.fpart[sn + at] * exp2f(a.fpart[at] - M);
    t += a.fpart[2 * sn + at];
  }
  const float lse = M * kLn2 + logf(fmaxf(l, 1e-30f));
  a.lse_out[r] = lse;
  a.loss[r] = a.y[r] != a.ignore ? lse - t : 0.f;
}

// h_c, lse_c, g_c, y_c: the listed rows in list order, then zeros (-1 for
// labels) up to n. One thread per 8 columns of a row.
template <typename T>
__global__ void __launch_bounds__(256)
    ce_sm90_gather_kernel(const Args<T> a) {
  const int cpr = a.H / 8;
  const int64_t u = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= (int64_t)a.n * cpr) return;
  const int p = (int)(u / cpr);
  const int c = (int)(u - (int64_t)p * cpr) * 8;
  const int count = a.rows[a.n];
  const int row = p < count ? a.rows[p] : -1;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row >= 0)
    v = *reinterpret_cast<const uint4*>(a.h + (int64_t)row * a.H + c);
  *reinterpret_cast<uint4*>(a.hc + (int64_t)p * a.H + c) = v;
  if (c == 0) {
    a.lse_c[p] = row >= 0 ? a.lse[row] : 0.f;
    a.g_c[p] = row >= 0 ? a.g[row] : 0.f;
    a.y_c[p] = row >= 0 ? a.y[row] : -1;
  }
}

// dh[i] = the sum over the slots, in order, of row i's partial sums (zero
// for an ignored row), rounded once to T
template <typename T>
__global__ void __launch_bounds__(256)
    ce_sm90_dh_reduce_kernel(const Args<T> a) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)a.n * a.H) return;
  const int i = (int)(e / a.H);
  const int c = (int)(e - (int64_t)i * a.H);
  const int count = a.rows[a.n];
  const int slots = dh_slots(count, a.n);
  const int64_t stride = (int64_t)cdiv(count, kBM) * kBM * a.H;
  const int p = a.pos[i];
  float v = 0.f;
  if (p >= 0)
    for (int s = 0; s < slots; ++s)
      v += a.part[s * stride + (int64_t)p * a.H + c];
  a.dh[e] = from_f32<T>(v);
}

template <typename T>
int run_fwd(const void* h, const void* w, const void* b, const int* y,
            float* loss, float* lse, float* part, int n, int H, int V,
            int ignore, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args<T> a{};
  a.hc = static_cast<T*>(const_cast<void*>(h));   // read only
  a.w = static_cast<const T*>(w);
  a.bias = static_cast<const T*>(b);
  a.y = y;
  a.loss = loss;
  a.lse_out = lse;
  a.fpart = part;
  a.n = n;
  a.H = H;
  a.V = V;
  a.ignore = ignore;
  a.splits = splits;
  int err = (int)cudaFuncSetAttribute(
      ce_sm90_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != 0) return err;
  ce_sm90_fwd_kernel<T><<<cdiv(n, kBM) * splits, kThreads, kSmem, st>>>(a);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  ce_sm90_fwd_combine_kernel<T><<<cdiv(n, 256), 256, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int run_bwd(const void* h, const void* w, const void* b, const int* y,
            const float* lse, const float* g, const int* rows, const int* pos,
            void* hc, float* lse_c, float* g_c, int* y_c, void* ds,
            float* dbp, float* part, void* dh, void* dw, void* db,
            const int* chunk_v0, const int* chunk_len, int n_chunks, int n,
            int H, int V, int Vc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args<T> a{};
  a.h = static_cast<const T*>(h);
  a.w = static_cast<const T*>(w);
  a.bias = static_cast<const T*>(b);
  a.y = y;
  a.lse = lse;
  a.g = g;
  a.rows = rows;
  a.pos = pos;
  a.hc = static_cast<T*>(hc);
  a.lse_c = lse_c;
  a.g_c = g_c;
  a.y_c = y_c;
  a.part = part;
  a.dh = static_cast<T*>(dh);
  a.dw = static_cast<T*>(dw);
  a.db = static_cast<T*>(db);
  a.n = n;
  a.H = H;
  a.V = V;
  a.Vc = Vc;
  int err = (int)cudaFuncSetAttribute(
      ce_sm90_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != 0) return err;
  const int64_t units = (int64_t)n * (H / 8);
  ce_sm90_gather_kernel<T>
      <<<(unsigned)((units + 255) / 256), 256, 0, st>>>(a);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const int row_tiles = cdiv(n, kBM), h_tiles = cdiv(H, kBN);
  // chunk c's ds buffers: c % 2
  auto chunk = [&](int c) {
    Chunk<T> ch{};
    if (c < 0 || c >= n_chunks) return ch;   // vc 0: none
    ch.ds = static_cast<T*>(ds) + (int64_t)(c % 2) * n * Vc;
    ch.dbp = db != nullptr ? dbp + (int64_t)(c % 2) * row_tiles * Vc : nullptr;
    ch.v0 = chunk_v0[c];
    ch.vc = chunk_len[c];
    ch.accumulate = c > 0;
    return ch;
  };
  // launch c: the ds pass of chunk c, the dh and dW passes of chunk c - 1
  for (int c = 0; c <= n_chunks; ++c) {
    a.fresh = chunk(c);
    a.done = chunk(c - 1);
    a.n_dh = dh != nullptr && c > 0 ? row_tiles * h_tiles : 0;
    a.n_dw = dw != nullptr && c > 0 ? h_tiles * cdiv(a.done.vc, kBM) : 0;
    const int blocks = a.n_dh + a.n_dw + row_tiles * cdiv(a.fresh.vc, kBN);
    if (blocks == 0) continue;   // nothing asked of this launch
    ce_sm90_chunk_kernel<T><<<blocks, kThreads, kSmem, st>>>(a);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  if (dh != nullptr) {
    const int64_t total = (int64_t)n * H;
    ce_sm90_dh_reduce_kernel<T>
        <<<(unsigned)((total + 255) / 256), 256, 0, st>>>(a);
    err = (int)cudaGetLastError();
  }
  return err;
}

}  // namespace

extern "C" {

// The entries take a dtype code: 1 bf16, 2 f16 (h, W, b, the gradients and
// the ds and hc scratch alike; the codes of fused_ce.cu, where 0 is f32).

// Per-token loss and lse [n] f32 of h [n, H] . W[V, H]^T + b (b may be
// null) against labels y [n] (loss 0 where y == ignore), the vocab split in
// `splits` ranges (at most ceil(V / 128)). Scratch: part f32 [3, splits,
// n]. Returns the cudaError_t of the launches.
int fused_ce_sm90_fwd(const void* h, const void* w, const void* b,
                      const int* y, float* loss, float* lse, float* part,
                      int n, int H, int V, int ignore, int splits, int dtype,
                      void* stream) {
  if (n < 1 || V < 1 || H < kBK || H % kBK != 0 || splits < 1 ||
      splits > cdiv(V, kBN))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return run_fwd<bf16>(h, w, b, y, loss, lse, part, n, H, V, ignore,
                         splits, stream);
  if (dtype == 2)
    return run_fwd<f16>(h, w, b, y, loss, lse, part, n, H, V, ignore,
                        splits, stream);
  return (int)cudaErrorInvalidValue;
}

// dh [n, H], dW [V, H] and db [V] (each null when not asked for; db needs
// dW) in the input dtype from the saved lse and the upstream g [n], over
// the list of fused_ce_valid_rows (rows [n + 1], pos [n]). The vocab is
// walked in the n_chunks chunks chunk_v0[c] .. chunk_v0[c] + chunk_len[c]
// (host arrays, in order, each at most Vc wide). Scratch, all from the
// caller: hc [n, H] in the input dtype; lse_c, g_c f32 [n]; y_c int32 [n];
// ds [2, n, Vc] in the input dtype (one buffer for one chunk); dbp f32 [2,
// ceil(n / 128), Vc] (with db); part f32 [ceil(n / 128) * 128, H] (with
// dh). Returns the cudaError_t of the launches.
int fused_ce_sm90_bwd(const void* h, const void* w, const void* b,
                      const int* y, const float* lse, const float* g,
                      const int* rows, const int* pos, void* hc, float* lse_c,
                      float* g_c, int* y_c, void* ds, float* dbp, float* part,
                      void* dh, void* dw, void* db, const int* chunk_v0,
                      const int* chunk_len, int n_chunks, int n, int H, int V,
                      int Vc, int dtype, void* stream) {
  if (n < 1 || V < 1 || H < 64 || H > kMaxH || H % 64 != 0 || Vc < kBN ||
      Vc % kBN != 0 || n_chunks < 1 || (dh == nullptr && dw == nullptr) ||
      (db != nullptr && (dw == nullptr || dbp == nullptr)) ||
      (dh != nullptr && part == nullptr))
    return (int)cudaErrorInvalidValue;
  for (int c = 0; c < n_chunks; ++c)
    if (chunk_len[c] < 1 || chunk_len[c] > Vc || chunk_v0[c] < 0 ||
        chunk_v0[c] + chunk_len[c] > V)
      return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return run_bwd<bf16>(h, w, b, y, lse, g, rows, pos, hc, lse_c, g_c, y_c,
                         ds, dbp, part, dh, dw, db, chunk_v0, chunk_len,
                         n_chunks, n, H, V, Vc, stream);
  if (dtype == 2)
    return run_bwd<f16>(h, w, b, y, lse, g, rows, pos, hc, lse_c, g_c, y_c,
                        ds, dbp, part, dh, dw, db, chunk_v0, chunk_len,
                        n_chunks, n, H, V, Vc, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
