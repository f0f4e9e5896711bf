// Fused linear + softmax cross-entropy, for Hopper (sm_90a).
//
// Replaces the three TPU Pallas kernels of the training loss head:
//   paddle_tpu/ops/pallas/fused_ce.py:_ce_fwd_kernel     -> ce_fwd_kernel
//       (+ ce_fwd_combine_kernel, the merge of the vocab split)
//   paddle_tpu/ops/pallas/fused_ce.py:_ce_bwd_dh_kernel  -> ce_bwd_dh_kernel
//       (+ ce_dh_reduce_kernel)
//   paddle_tpu/ops/pallas/fused_ce.py:_ce_bwd_dw_kernel  -> ce_bwd_dw_kernel
// and compact_rows_kernel, which lists the valid rows for both backward
// kernels (its own entry point, so one backward builds the list once).
//
// What it computes, for hidden h [n, H], weight W [V, H], optional bias
// b [V] and labels y [n] (int32):
//   forward   lse_i  = m + log(max(l, 1e-30)) over s_iv = h_i . W_v + b_v
//             loss_i = lse_i - s_{i, y_i}   (0 where y_i == ignore)
//   backward  ds_iv  = (exp(s_iv - lse_i) - [v == y_i]) * g_i  (0 ignored)
//             dh = ds . W,  dW = ds^T . h,  db = sum_i ds_i
// without ever writing the [n, V] logits to device memory. Columns >= V
// never enter the softmax; W rows >= V are never read (ragged vocab
// tiles are masked in-kernel: no padded copy of W, no slice of dW). A
// label outside [0, V) that is not `ignore` matches no column, so its
// loss is lse and its ds row is the softmax itself; nothing gathers W[y].
//
// What bounds it: operations. At BERT-base's head (n = 4096, H = 768,
// V = 30522) the forward does 2 n H V = 192 GFLOP, about 0.194 ms at the
// H100 SXM's 989 TFLOP/s dense bf16; dh and dW each do two such products
// (recompute of the logits tile + the gradient product), about 0.388 ms
// each over all rows. The bytes (h, W, b, y once, outputs once) are
// ~53 MB, 0.016 ms at 3.35 TB/s. So the design keeps the products on the
// tensor cores and the logits out of device memory, and does no product
// whose result is known to be zero:
//   * bf16 and f16 inputs: WMMA (mma.sync) 16x16x16 products, 16-bit in, f32
//     accumulate; f32 inputs: f32 FMA (no TF32), so f32 holds an f32
//     tolerance;
//   * operand chunks (64 columns of H) go global -> registers -> shared
//     memory, and the next chunk's loads are issued before the current
//     chunk's products, so device-memory latency overlaps the math;
//   * forward: a block owns a 64-token tile and loops over 64-column
//     vocab tiles itself, with the running max / sum / label logit in
//     f32 registers (4 threads per row). The TPU kernel's sequential
//     "arbitrary" vocab axis becomes that loop. At n = 4096 there are only
//     64 token tiles for 132 SMs, so the vocab is split over gridDim.y
//     (chosen by the wrapper from the SM count) and a second small kernel
//     merges the partial (m, l, t) of each row. Every row gets its lse;
//   * backward, rows: an ignored row's ds is zero, so it adds nothing to
//     dW or db and its dh is zero. compact_rows_kernel lists the valid
//     rows in order (one block, ballot + scan, on the device: no host
//     sync) once per backward, and both gradient kernels run over that
//     list only. At BERT's 15% mask rate that is 6.7x less work than the
//     TPU kernels do;
//   * dh: a block owns 32 listed rows and a range of vocab tiles (the
//     vocab is split over gridDim.y, so the few listed rows still fill
//     the card), with the f32 dh accumulator [32, H] in SHARED memory (up
//     to 128 KB at H = 1024; 96 KB at 768): a register accumulator of that
//     size does not fit, and tiling H instead would recompute the logits
//     H/64 times. Each vocab tile recomputes its logits from h and W,
//     forms ds from the saved lse (rounded to the input dtype, as the TPU
//     kernel does), and adds ds . W_tile into the accumulator chunk by
//     chunk. Partial sums go to f32 scratch [splits, n, H] and
//     ce_dh_reduce_kernel adds them in a fixed order (zero for ignored
//     rows);
//   * dW/db: a block owns 32 vocab rows and loops over the listed rows in
//     tiles of 64, with the f32 dW accumulator [32, H] in shared memory and
//     db in registers. No atomics: every output element has one writer and
//     every sum a fixed order, so the results are deterministic;
//   * any n (bounds masks; no multiple-of-8 rule), any H that is a
//     multiple of 8 up to 1024, any V >= 1.
// Occupancy: the backward kernels use ~160-180 KB of shared memory, so one
// block (8 warps) per SM; dW has ceil(V / 32) blocks.
// bf16 and f16 with H a multiple of 64 run the forward and the backward of
// fused_ce_sm90.cu instead (wgmma tiles, register accumulators); these
// kernels keep f32 and the other H, and list the valid rows for both.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;          // 8 warps per block
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;                // H columns per operand chunk
constexpr int kLdK = kBK + 8;          // padded row stride of a chunk
constexpr int kMaxH = 1024;
constexpr float kNegInf = -1e9f;       // finite mask fill, as the reference

// tile shapes: tokens x vocab columns of one logits tile
constexpr int kFwdTM = 64, kFwdTV = 64;
constexpr int kDhTM = 32, kDhTV = 64;
constexpr int kDwTM = 64, kDwTV = 32;
constexpr int kAccRows = 32;           // rows of the dh / dW accumulator
constexpr int kCompactThreads = 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(f16 x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ f16 from_f32<f16>(float x) {
  return __float2half(x);
}

// 8 consecutive elements: 16 bytes of bf16 or f16, or 32 bytes of f32
template <typename T> struct Vec8 { uint4 v; };
template <> struct Vec8<float> { float4 a, b; };

template <typename T>
__device__ __forceinline__ void load8(Vec8<T>& d, const T* s) {
  d.v = *reinterpret_cast<const uint4*>(s);
}
__device__ __forceinline__ void load8(Vec8<float>& d, const float* s) {
  d.a = reinterpret_cast<const float4*>(s)[0];
  d.b = reinterpret_cast<const float4*>(s)[1];
}
template <typename T>
__device__ __forceinline__ void zero8(Vec8<T>& d) {
  d.v = make_uint4(0u, 0u, 0u, 0u);
}
__device__ __forceinline__ void zero8(Vec8<float>& d) {
  d.a = d.b = make_float4(0.f, 0.f, 0.f, 0.f);
}
template <typename T>
__device__ __forceinline__ void store8(T* d, const Vec8<T>& s) {
  *reinterpret_cast<uint4*>(d) = s.v;
}
__device__ __forceinline__ void store8(float* d, const Vec8<float>& s) {
  reinterpret_cast<float4*>(d)[0] = s.a;
  reinterpret_cast<float4*>(d)[1] = s.b;
}

// One ROWS x COLS operand chunk in flight: fetch() issues the global loads
// into registers, commit() writes them to shared memory (row stride ldd).
// Row r of the chunk is source row rmap[r] (a shared-memory row list,
// -1 = none) or, without a list, row0 + r (none at and past row_end).
// Missing rows and columns >= col_end (= H, a multiple of 8, so each
// 8-wide unit is wholly in or out) are zeros.
template <int ROWS, int COLS, typename T>
struct Chunk {
  static constexpr int kUnitsPerRow = COLS / 8;
  static constexpr int kUnits = ROWS * kUnitsPerRow;
  static constexpr int kPer = kUnits / kThreads;
  static_assert(kPer * kThreads == kUnits, "chunk split");
  Vec8<T> v[kPer];

  __device__ __forceinline__ void fetch(const T* src, int64_t lds,
                                        const int* rmap, int row0,
                                        int row_end, int col0, int col_end) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int u = threadIdx.x + i * kThreads;
      const int r = u / kUnitsPerRow;
      const int c = (u - r * kUnitsPerRow) * 8;
      const int row = rmap != nullptr ? rmap[r]
                                      : (row0 + r < row_end ? row0 + r : -1);
      if (row >= 0 && col0 + c < col_end)
        load8(v[i], src + (int64_t)row * lds + col0 + c);
      else
        zero8(v[i]);
    }
  }

  __device__ __forceinline__ void commit(T* dst, int ldd) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int u = threadIdx.x + i * kThreads;
      const int r = u / kUnitsPerRow;
      store8(dst + r * ldd + (u - r * kUnitsPerRow) * 8, v[i]);
    }
  }
};

// ---------------------------------------------------------------------------
// S[TM][TV + 4] (f32, shared) = h[rows] . W[v0 .. v0+TV)^T over H, through
// K chunks of 64 staged in a_s [TM][kLdK] and b_s [TV][kLdK]. The h rows
// are hmap[0 .. TM) or, without a map, r0 .. r0+TM (zero at and past n);
// W rows >= V are zero. Ends with a barrier: S is complete.
// ---------------------------------------------------------------------------

template <int TM, int TV, typename E>
__device__ void logits_tile(float* S, E* a_s, E* b_s, const E* h,
                            const int* hmap, int r0, int n, const E* w,
                            int v0, int V, int H) {
  constexpr int kPer = (TM / 16) * (TV / 16) / kWarps;   // tiles per warp
  static_assert(kPer * kWarps == (TM / 16) * (TV / 16), "tile split");
  const int warp = threadIdx.x / 32;
  Chunk<TM, kBK, E> ca;
  Chunk<TV, kBK, E> cb;
  ca.fetch(h, H, hmap, r0, n, 0, H);
  cb.fetch(w, H, nullptr, v0, V, 0, H);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) wmma::fill_fragment(acc[i], 0.f);
  for (int k0 = 0; k0 < H; k0 += kBK) {
    __syncthreads();   // the previous readers of a_s / b_s are done
    ca.commit(a_s, kLdK);
    cb.commit(b_s, kLdK);
    __syncthreads();
    if (k0 + kBK < H) {          // next chunk's loads overlap these products
      ca.fetch(h, H, hmap, r0, n, k0 + kBK, H);
      cb.fetch(w, H, nullptr, v0, V, k0 + kBK, H);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int tile = warp + i * kWarps;
      const int ti = tile / (TV / 16), tj = tile % (TV / 16);
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, E, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, E, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, a_s + ti * 16 * kLdK + kk, kLdK);
        wmma::load_matrix_sync(fb, b_s + tj * 16 * kLdK + kk, kLdK);
        wmma::mma_sync(acc[i], fa, fb, acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int tile = warp + i * kWarps;
    const int ti = tile / (TV / 16), tj = tile % (TV / 16);
    wmma::store_matrix_sync(S + ti * 16 * (TV + 4) + tj * 16, acc[i], TV + 4,
                            wmma::mem_row_major);
  }
  __syncthreads();
}

template <int TM, int TV>
__device__ void logits_tile(float* S, float* a_s, float* b_s, const float* h,
                            const int* hmap, int r0, int n, const float* w,
                            int v0, int V, int H) {
  constexpr int RN = 4;                 // columns per thread
  constexpr int CT = TV / RN;           // threads across columns
  constexpr int RT = kThreads / CT;     // threads across rows
  constexpr int RM = TM / RT;           // rows per thread
  static_assert(RM * RT == TM, "tile split");
  const int tx = threadIdx.x % CT, ty = threadIdx.x / CT;
  Chunk<TM, kBK, float> ca;
  Chunk<TV, kBK, float> cb;
  ca.fetch(h, H, hmap, r0, n, 0, H);
  cb.fetch(w, H, nullptr, v0, V, 0, H);
  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < H; k0 += kBK) {
    __syncthreads();
    ca.commit(a_s, kLdK);
    cb.commit(b_s, kLdK);
    __syncthreads();
    if (k0 + kBK < H) {
      ca.fetch(h, H, hmap, r0, n, k0 + kBK, H);
      cb.fetch(w, H, nullptr, v0, V, k0 + kBK, H);
    }
    for (int k = 0; k < kBK; ++k) {
      float av[RM], bv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) av[i] = a_s[(ty + i * RT) * kLdK + k];
#pragma unroll
      for (int j = 0; j < RN; ++j) bv[j] = b_s[(tx + j * CT) * kLdK + k];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j)
      S[(ty + i * RT) * (TV + 4) + tx + j * CT] = acc[i][j];
  __syncthreads();
}

// ---------------------------------------------------------------------------
// acc[32][ld_acc] (f32, shared) += A . B, chunk by chunk over H's columns:
//   A [32 x 64] in shared memory, row-major (a(i,k) = a_op[i*lda + k]) or,
//   with A_COL, column-major (a(i,k) = a_op[k*lda + i]);
//   B [64 x H] = rows of src: bmap[0 .. 64) or, without a map,
//   brow0 .. brow0+64 (zero at and past brow_end), staged 64 columns at a
//   time in b_s [64][kLdK].
// Every thread (warp) owns fixed accumulator cells, so no barrier is
// needed on acc between calls.
// ---------------------------------------------------------------------------

template <bool A_COL, typename E>
__device__ void accumulate_rows(float* acc, int ld_acc, const E* a_op,
                                int lda, E* b_s, const E* src,
                                const int* bmap, int brow0, int brow_end,
                                int H) {
  using ALayout =
      typename std::conditional<A_COL, wmma::col_major, wmma::row_major>::type;
  const int warp = threadIdx.x / 32;
  const int ti = warp / 4, tj = warp % 4;   // 2 x 4 tiles of a 32 x 64 chunk
  Chunk<64, kBK, E> cb;
  cb.fetch(src, H, bmap, brow0, brow_end, 0, H);
  for (int c0 = 0; c0 < H; c0 += kBK) {
    __syncthreads();
    cb.commit(b_s, kLdK);
    __syncthreads();
    if (c0 + kBK < H) cb.fetch(src, H, bmap, brow0, brow_end, c0 + kBK, H);
    float* cp = acc + ti * 16 * ld_acc + c0 + tj * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::load_matrix_sync(c, cp, ld_acc, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < 64; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, E, ALayout> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, E, wmma::row_major> fb;
      const E* ap = A_COL ? a_op + kk * lda + ti * 16
                             : a_op + ti * 16 * lda + kk;
      wmma::load_matrix_sync(fa, ap, lda);
      wmma::load_matrix_sync(fb, b_s + kk * kLdK + tj * 16, kLdK);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(cp, c, ld_acc, wmma::mem_row_major);
  }
}

template <bool A_COL>
__device__ void accumulate_rows(float* acc, int ld_acc, const float* a_op,
                                int lda, float* b_s, const float* src,
                                const int* bmap, int brow0, int brow_end,
                                int H) {
  const int tx = threadIdx.x % 64, ty = threadIdx.x / 64;   // 4 row groups
  Chunk<64, kBK, float> cb;
  cb.fetch(src, H, bmap, brow0, brow_end, 0, H);
  for (int c0 = 0; c0 < H; c0 += kBK) {
    __syncthreads();
    cb.commit(b_s, kLdK);
    __syncthreads();
    if (c0 + kBK < H) cb.fetch(src, H, bmap, brow0, brow_end, c0 + kBK, H);
    float c[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) c[i] = acc[(ty + 4 * i) * ld_acc + c0 + tx];
    for (int k = 0; k < 64; ++k) {
      const float bv = b_s[k * kLdK + tx];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = ty + 4 * i;
        const float av = A_COL ? a_op[k * lda + row] : a_op[row * lda + k];
        c[i] = fmaf(av, bv, c[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[(ty + 4 * i) * ld_acc + c0 + tx] = c[i];
  }
}

// ---------------------------------------------------------------------------
// shared-memory layout, the same on the host (launch size) and the device
// ---------------------------------------------------------------------------

__host__ __device__ constexpr size_t align_up(size_t x) {
  return (x + 127) & ~size_t(127);
}

struct Layout {
  size_t a, b, s, ds, acc, rows, red, total;
};

// tm x tv logits tiles; a_s [tm][kLdK], b_s [tv][kLdK], S [tm][tv + 4] f32,
// ds [tm][ld_ds], acc [acc_rows][ld_acc] f32, per-row lse / g / label /
// source row [tm], and a kThreads f32 reduction buffer.
__host__ __device__ inline Layout make_layout(int esize, int tm, int tv,
                                              int ld_ds, int acc_rows,
                                              int ld_acc) {
  Layout L{};
  size_t o = 0;
  L.a = o;    o = align_up(o + (size_t)tm * kLdK * esize);
  L.b = o;    o = align_up(o + (size_t)tv * kLdK * esize);
  L.s = o;    o = align_up(o + (size_t)tm * (tv + 4) * sizeof(float));
  L.ds = o;   o = align_up(o + (size_t)tm * ld_ds * esize);
  L.acc = o;  o = align_up(o + (size_t)acc_rows * ld_acc * sizeof(float));
  L.rows = o; o = align_up(o + (size_t)4 * tm * sizeof(float));
  L.red = o;  o = align_up(o + (size_t)kThreads * sizeof(float));
  L.total = o;
  return L;
}

// accumulator row stride: H rounded up to whole 64-column chunks, + 4
// (a multiple of 4 floats keeps WMMA's 32-byte fragment alignment)
__host__ __device__ inline int acc_ld(int H) {
  return (H + kBK - 1) / kBK * kBK + 4;
}

struct Args {
  const void* h;        // [n, H]
  const void* w;        // [V, H]
  const void* b;        // [V] or null
  const int* y;         // [n]
  const float* lse;     // [n] (backward)
  const float* g;       // [n] upstream grad of the per-token loss
  float* loss;          // [n] (forward)
  float* lse_out;       // [n] (forward)
  float* part;          // forward: [3, splits, n] partial m, l, t;
                        // dh: [splits, n, H] partial sums
  void* dh;             // [n, H]
  void* dw;             // [V, H]
  void* db;             // [V] or null
  int* rows;            // backward: [n + 1] listed valid rows, count last
  int* pos;             // backward: [n] row -> list position or -1
  int n, H, V, ignore, splits;
};

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) ce_fwd_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(sizeof(T), kFwdTM, kFwdTV, 0, 0, 0);
  T* a_s = reinterpret_cast<T*>(smem + L.a);
  T* b_s = reinterpret_cast<T*>(smem + L.b);
  float* S = reinterpret_cast<float*>(smem + L.s);
  constexpr int ldS = kFwdTV + 4;
  const T* h = static_cast<const T*>(a.h);
  const T* w = static_cast<const T*>(a.w);
  const T* bias = static_cast<const T*>(a.b);

  const int r0 = blockIdx.x * kFwdTM;
  const int nvt = (a.V + kFwdTV - 1) / kFwdTV;
  const int vt_begin = (int)((int64_t)blockIdx.y * nvt / a.splits);
  const int vt_end = (int)((int64_t)(blockIdx.y + 1) * nvt / a.splits);
  const int row = threadIdx.x / 4;     // 4 threads per row ...
  const int q = threadIdx.x % 4;       // ... 16 columns each
  const int label = r0 + row < a.n ? a.y[r0 + row] : a.ignore;
  float m = kNegInf, l = 0.f, t = 0.f;

  for (int vt = vt_begin; vt < vt_end; ++vt) {
    const int v0 = vt * kFwdTV;
    logits_tile<kFwdTM, kFwdTV>(S, a_s, b_s, h, nullptr, r0, a.n, w, v0,
                                a.V, a.H);
    float x[16];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = q * 16 + j;
      const int col = v0 + c;
      float s = kNegInf;                 // ragged vocab tile: masked
      if (col < a.V) {
        s = S[row * ldS + c];
        if (bias != nullptr) s += to_f32(bias[col]);
        if (col == label) t += s;
      }
      x[j] = s;
      tmax = fmaxf(tmax, s);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) psum += expf(x[j] - m_new);
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * expf(m - m_new) + psum;
    m = m_new;
  }
  t += __shfl_xor_sync(0xffffffffu, t, 1);
  t += __shfl_xor_sync(0xffffffffu, t, 2);
  const int r = r0 + row;
  if (q == 0 && r < a.n) {
    const int64_t sn = (int64_t)a.splits * a.n;
    const int64_t at = (int64_t)blockIdx.y * a.n + r;
    a.part[at] = m;
    a.part[sn + at] = l;
    a.part[2 * sn + at] = t;
  }
}

// merge the vocab split's partial (m, l, t) of each row into loss and lse
__global__ void __launch_bounds__(256) ce_fwd_combine_kernel(const Args a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.n) return;
  const int64_t sn = (int64_t)a.splits * a.n;
  float M = kNegInf;
  for (int s = 0; s < a.splits; ++s)
    M = fmaxf(M, a.part[(int64_t)s * a.n + r]);
  float l = 0.f, t = 0.f;
  for (int s = 0; s < a.splits; ++s) {
    const int64_t at = (int64_t)s * a.n + r;
    l += a.part[sn + at] * expf(a.part[at] - M);
    t += a.part[2 * sn + at];
  }
  const float lse = M + logf(fmaxf(l, 1e-30f));
  a.lse_out[r] = lse;
  a.loss[r] = a.y[r] != a.ignore ? lse - t : 0.f;
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// The valid rows (y != ignore) in ascending order: rows[p] is the p-th,
// rows[n] their count, pos[i] row i's place in the list or -1. One block
// walks n in chunks of 1024 with a warp ballot and a scan of the warp
// counts, so the list is deterministic and needs no host round trip.
__global__ void __launch_bounds__(kCompactThreads)
compact_rows_kernel(const Args a) {
  __shared__ int warp_base[kCompactThreads / 32];
  __shared__ int chunk_total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = 0;
  for (int c0 = 0; c0 < a.n; c0 += kCompactThreads) {
    const int i = c0 + threadIdx.x;
    const bool valid = i < a.n && a.y[i] != a.ignore;
    const unsigned m = __ballot_sync(0xffffffffu, valid);
    if (lane == 0) warp_base[warp] = __popc(m);
    __syncthreads();
    if (warp == 0) {
      const int cnt = warp_base[lane];
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      warp_base[lane] = incl - cnt;
      if (lane == 31) chunk_total = incl;
    }
    __syncthreads();
    if (i < a.n) {
      const int p = valid
          ? base + warp_base[warp] + __popc(m & ((1u << lane) - 1u)) : -1;
      a.pos[i] = p;
      if (valid) a.rows[p] = i;
    }
    base += chunk_total;
    __syncthreads();   // warp_base and chunk_total are rewritten next chunk
  }
  if (threadIdx.x == 0) a.rows[a.n] = base;
}

// listed rows p0 .. p0+tm into shared memory: source row (-1 past the
// list), lse, label and g
__device__ __forceinline__ void load_rows(const Args& a, int count, int p0,
                                          int tm, int* src_s, float* lse_s,
                                          float* g_s, int* y_s) {
  for (int i = threadIdx.x; i < tm; i += kThreads) {
    const int row = p0 + i < count ? a.rows[p0 + i] : -1;
    src_s[i] = row;
    y_s[i] = row >= 0 ? a.y[row] : a.ignore;
    lse_s[i] = row >= 0 ? a.lse[row] : 0.f;
    g_s[i] = row >= 0 ? a.g[row] : 0.f;
  }
}

// ds for the logit s (+ bias) at vocab column col (< V)
template <typename T>
__device__ __forceinline__ float ds_value(float s, const T* bias, int col,
                                          float lse, int label, float g) {
  if (bias != nullptr) s += to_f32(bias[col]);
  const float p = expf(s - lse);
  return (p - (col == label ? 1.f : 0.f)) * g;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ce_bwd_dh_kernel(const Args a) {
  const int count = a.rows[a.n];
  const int p0 = blockIdx.x * kDhTM;
  if (p0 >= count) return;             // past the listed rows
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ldds = kDhTV + 8;
  constexpr int ldS = kDhTV + 4;
  const int ld_acc = acc_ld(a.H);
  const Layout L = make_layout(sizeof(T), kDhTM, kDhTV, ldds, kAccRows,
                               ld_acc);
  T* a_s = reinterpret_cast<T*>(smem + L.a);
  T* b_s = reinterpret_cast<T*>(smem + L.b);
  float* S = reinterpret_cast<float*>(smem + L.s);
  T* ds_s = reinterpret_cast<T*>(smem + L.ds);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  int* src_s = reinterpret_cast<int*>(smem + L.rows);
  float* lse_s = reinterpret_cast<float*>(src_s + kDhTM);
  float* g_s = lse_s + kDhTM;
  int* y_s = reinterpret_cast<int*>(g_s + kDhTM);
  const T* h = static_cast<const T*>(a.h);
  const T* w = static_cast<const T*>(a.w);
  const T* bias = static_cast<const T*>(a.b);
  const int nvt = (a.V + kDhTV - 1) / kDhTV;
  const int vt_begin = (int)((int64_t)blockIdx.y * nvt / a.splits);
  const int vt_end = (int)((int64_t)(blockIdx.y + 1) * nvt / a.splits);

  for (int i = threadIdx.x; i < kAccRows * ld_acc; i += kThreads) acc[i] = 0.f;
  load_rows(a, count, p0, kDhTM, src_s, lse_s, g_s, y_s);
  __syncthreads();

  for (int vt = vt_begin; vt < vt_end; ++vt) {
    const int v0 = vt * kDhTV;
    logits_tile<kDhTM, kDhTV>(S, a_s, b_s, h, src_s, 0, 0, w, v0, a.V, a.H);
    for (int e = threadIdx.x; e < kDhTM * kDhTV; e += kThreads) {
      const int r = e / kDhTV, c = e % kDhTV;
      const int col = v0 + c;
      const float d = col < a.V ? ds_value(S[r * ldS + c], bias, col,
                                           lse_s[r], y_s[r], g_s[r])
                                : 0.f;
      ds_s[r * ldds + c] = from_f32<T>(d);   // rounded as the TPU kernel
    }
    // dh[32, H] += ds[32, 64] . W[v0 .. v0+64, H] (rows >= V are zero)
    accumulate_rows<false>(acc, ld_acc, ds_s, ldds, b_s, w, nullptr, v0, a.V,
                           a.H);
  }
  __syncthreads();
  // partial sums of this vocab range at the rows' list positions
  float* part = a.part + (int64_t)blockIdx.y * a.n * a.H;
  for (int e = threadIdx.x; e < kDhTM * a.H; e += kThreads) {
    const int r = e / a.H, c = e - r * a.H;
    if (p0 + r < count)
      part[(int64_t)(p0 + r) * a.H + c] = acc[r * ld_acc + c];
  }
}

// dh[i] = sum over the vocab splits, in order, of row i's partial sums
// (zero for an ignored row), rounded once to the input dtype
template <typename T>
__global__ void __launch_bounds__(256) ce_dh_reduce_kernel(const Args a) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)a.n * a.H) return;
  const int i = (int)(e / a.H);
  const int c = (int)(e - (int64_t)i * a.H);
  const int p = a.pos[i];
  float v = 0.f;
  if (p >= 0)
    for (int s = 0; s < a.splits; ++s)
      v += a.part[((int64_t)s * a.n + p) * a.H + c];
  static_cast<T*>(a.dh)[e] = from_f32<T>(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ce_bwd_dw_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ldds = kDwTV + 8;
  constexpr int ldS = kDwTV + 4;
  const int ld_acc = acc_ld(a.H);
  const Layout L = make_layout(sizeof(T), kDwTM, kDwTV, ldds, kAccRows,
                               ld_acc);
  T* a_s = reinterpret_cast<T*>(smem + L.a);
  T* b_s = reinterpret_cast<T*>(smem + L.b);
  float* S = reinterpret_cast<float*>(smem + L.s);
  T* ds_s = reinterpret_cast<T*>(smem + L.ds);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  int* src_s = reinterpret_cast<int*>(smem + L.rows);
  float* lse_s = reinterpret_cast<float*>(src_s + kDwTM);
  float* g_s = lse_s + kDwTM;
  int* y_s = reinterpret_cast<int*>(g_s + kDwTM);
  float* red = reinterpret_cast<float*>(smem + L.red);
  const T* h = static_cast<const T*>(a.h);
  const T* w = static_cast<const T*>(a.w);
  const T* bias = static_cast<const T*>(a.b);
  const int count = a.rows[a.n];
  const int v0 = blockIdx.x * kDwTV;
  // ds element (r = ty + 8 i, c) of each token tile; c is fixed per thread,
  // so db's column sum stays in one register for the whole loop
  const int c = threadIdx.x % kDwTV;
  const int ty = threadIdx.x / kDwTV;          // 0 .. 7
  const int col = v0 + c;
  float db = 0.f;

  for (int i = threadIdx.x; i < kAccRows * ld_acc; i += kThreads) acc[i] = 0.f;

  for (int p0 = 0; p0 < count; p0 += kDwTM) {
    // the previous tile's readers of the rows passed accumulate_rows'
    // barriers, so the rows can be overwritten here
    load_rows(a, count, p0, kDwTM, src_s, lse_s, g_s, y_s);
    __syncthreads();
    logits_tile<kDwTM, kDwTV>(S, a_s, b_s, h, src_s, 0, 0, w, v0, a.V, a.H);
#pragma unroll
    for (int i = 0; i < kDwTM / 8; ++i) {
      const int r = ty + 8 * i;
      const float d = col < a.V ? ds_value(S[r * ldS + c], bias, col,
                                           lse_s[r], y_s[r], g_s[r])
                                : 0.f;
      db += d;                               // f32, as the TPU kernel
      ds_s[r * ldds + c] = from_f32<T>(d);
    }
    // dW[32, H] += ds^T[32, 64] . h[listed rows, H] (missing rows zero)
    accumulate_rows<true>(acc, ld_acc, ds_s, ldds, a_s, h, src_s, 0, 0,
                          a.H);
    __syncthreads();   // src_s is rewritten by the next tile
  }
  red[threadIdx.x] = db;
  __syncthreads();
  if (a.db != nullptr && threadIdx.x < kDwTV && v0 + threadIdx.x < a.V) {
    float s = 0.f;
    for (int j = 0; j < kThreads / kDwTV; ++j) s += red[threadIdx.x + j * kDwTV];
    static_cast<T*>(a.db)[v0 + threadIdx.x] = from_f32<T>(s);
  }
  T* dw = static_cast<T*>(a.dw);
  for (int e = threadIdx.x; e < kAccRows * a.H; e += kThreads) {
    const int r = e / a.H, cc = e - r * a.H;
    if (v0 + r < a.V)
      dw[(int64_t)(v0 + r) * a.H + cc] = from_f32<T>(acc[r * ld_acc + cc]);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

bool valid_shape(const Args& a) {
  return a.n >= 1 && a.V >= 1 && a.H >= 8 && a.H <= kMaxH && a.H % 8 == 0 &&
         a.splits >= 1;
}

template <typename K>
int launch_kernel(K kernel, dim3 grid, size_t smem, const Args& a,
                  cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const Args& a, cudaStream_t st) {
  const Layout L = make_layout(sizeof(T), kFwdTM, kFwdTV, 0, 0, 0);
  dim3 grid((a.n + kFwdTM - 1) / kFwdTM, a.splits);
  int err = launch_kernel(ce_fwd_kernel<T>, grid, L.total, a, st);
  if (err != 0) return err;
  ce_fwd_combine_kernel<<<(a.n + 255) / 256, 256, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const Args& a, cudaStream_t st) {
  const Layout L = make_layout(sizeof(T), kDhTM, kDhTV, kDhTV + 8, kAccRows,
                               acc_ld(a.H));
  dim3 grid((a.n + kDhTM - 1) / kDhTM, a.splits);
  int err = launch_kernel(ce_bwd_dh_kernel<T>, grid, L.total, a, st);
  if (err != 0) return err;
  const int64_t total = (int64_t)a.n * a.H;
  ce_dh_reduce_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dw(const Args& a, cudaStream_t st) {
  const Layout L = make_layout(sizeof(T), kDwTM, kDwTV, kDwTV + 8, kAccRows,
                               acc_ld(a.H));
  dim3 grid((a.V + kDwTV - 1) / kDwTV);
  return launch_kernel(ce_bwd_dw_kernel<T>, grid, L.total, a, st);
}

enum Kind { kFwd = 0, kDh = 1, kDw = 2 };

template <typename T>
int launch(int kind, const Args& a, cudaStream_t st) {
  return kind == kFwd  ? launch_fwd<T>(a, st)
         : kind == kDh ? launch_dh<T>(a, st)
                       : launch_dw<T>(a, st);
}

// dtype codes of the entries: 0 f32, 1 bf16, 2 f16 (h, W, b and the
// gradients alike)
int run(int kind, const Args& a, int dtype, void* stream) {
  if (!valid_shape(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(kind, a, st);
  if (dtype == 1) return launch<bf16>(kind, a, st);
  if (dtype == 2) return launch<f16>(kind, a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Per-token loss and lse [n] (f32). part: f32 scratch [3, splits, n].
// Returns the cudaError_t of the launches.
int fused_ce_fwd(const void* h, const void* w, const void* b, const int* y,
                 float* loss, float* lse, float* part, int n, int H, int V,
                 int ignore, int splits, int dtype, void* stream) {
  Args a{h, w, b, y, nullptr, nullptr, loss, lse, part, nullptr, nullptr,
         nullptr, nullptr, nullptr, n, H, V, ignore, splits};
  return run(kFwd, a, dtype, stream);
}

// The valid rows (y != ignore) of the backward kernels: rows int32
// [n + 1] (the count last) and each row's place in the list, pos int32 [n].
int fused_ce_valid_rows(const int* y, int* rows, int* pos, int n, int ignore,
                        void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  Args a{nullptr, nullptr, nullptr, y, nullptr, nullptr, nullptr, nullptr,
         nullptr, nullptr, nullptr, nullptr, rows, pos, n, 0, 0, ignore, 1};
  compact_rows_kernel<<<1, kCompactThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// dh [n, H] in the input dtype from the saved lse and the upstream g [n],
// over the list of fused_ce_valid_rows. Scratch: part f32 [splits, n, H].
int fused_ce_bwd_dh(const void* h, const void* w, const void* b, const int* y,
                    const float* lse, const float* g, void* dh, int* rows,
                    int* pos, float* part, int n, int H, int V, int ignore,
                    int splits, int dtype, void* stream) {
  Args a{h, w, b, y, lse, g, nullptr, nullptr, part, dh, nullptr, nullptr,
         rows, pos, n, H, V, ignore, splits};
  return run(kDh, a, dtype, stream);
}

// dW [V, H] and (when db is not null) db [V], in the input dtype, over the
// list of fused_ce_valid_rows.
int fused_ce_bwd_dw(const void* h, const void* w, const void* b, const int* y,
                    const float* lse, const float* g, void* dw, void* db,
                    int* rows, int* pos, int n, int H, int V, int ignore,
                    int dtype, void* stream) {
  Args a{h, w, b, y, lse, g, nullptr, nullptr, nullptr, nullptr, dw, db,
         rows, pos, n, H, V, ignore, 1};
  return run(kDw, a, dtype, stream);
}

}  // extern "C"
