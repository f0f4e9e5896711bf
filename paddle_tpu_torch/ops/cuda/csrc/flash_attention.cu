// Flash attention for Hopper (sm_90a): the forward and both backward kernels.
//
// Replaces the three TPU Pallas kernels of paddle_tpu/ops/pallas/
// flash_attention.py:
//   _flash_fwd_kernel      (:103) -> flash_fwd_kernel
//   _flash_bwd_dq_kernel   (:234) -> flash_bwd_dq_kernel
//   _flash_bwd_dkv_kernel  (:272) -> flash_bwd_dkv_kernel
//
// What it computes, for q [BH, Sq, D], k and v [BH, Sk, D] (one dtype,
// f32, bf16 or f16), an optional f32 key bias [B, Sk] (head bh reads row
// bh / H) and a causal flag:
//   s   = (q . k^T) * scale  (f32)  + bias[col]  ; causal: NEG_INF where
//         col > row + (Sk - Sq), the mask aligned bottom-right
//   fwd   m, l over the keys online (m starts at NEG_INF, as the TPU
//         kernel's), P = exp(s - m) rounded to v's dtype for P . V,
//         o = acc / max(l, 1e-30) in the input dtype,
//         lse = m + log(max(l, 1e-30)) in f32
//   bwd   p = exp(s - lse), dp = dO . V^T, ds = p * (dp - delta) * scale
//         (delta = rowsum(dO * O), computed by the caller)
//         dq = ds . K (ds rounded to K's dtype), dk = ds^T . Q (rounded to
//         Q's dtype), dv = p^T . dO (p rounded to dO's dtype)
// Every product accumulates in f32. Masked entries are the finite -1e9
// (NEG_INF), never -inf. Keys at and past Sk take no part (p = 0) and rows
// at and past Sq write nothing and add nothing to dk / dv: ragged lengths
// are masked here, with no padded copy of any input.
//
// What bounds it: operations. At GPT-2 small's long-sequence shape (BH 12,
// S 4096, D 64, causal) the forward does 4 BH S^2 D / 2 = 25.8 GFLOP (26 us
// at the H100 SXM's 989 TFLOP/s dense bf16), dq 1.5x and dk/dv 2x that; the
// bytes (q, k, v, o once: 25 MB) take 7.5 us at 3.35 TB/s. So the design
// keeps the [S, S] scores out of device memory and the products on the
// tensor cores:
//   * one block (8 warps) per (head, 64-row tile): the forward and dq own a
//     query tile and loop over key tiles; dk/dv own a key tile and loop over
//     query tiles. The TPU grid's sequential "arbitrary" axis becomes that
//     loop, and the split of the backward into dq (key tiles inner) and
//     dk/dv (query tiles inner) is kept: no atomics, so every result has one
//     writer and a fixed order of sums and is bitwise repeatable;
//   * under causal, tiles wholly above the diagonal are skipped: the
//     forward and dq stop after the last live key tile, dk/dv start at the
//     first live query tile (_causal_live, :88);
//   * q / k / v / dO tiles are staged in shared memory with the head dim
//     padded with zeros to a multiple of 16 (any D <= 256); the score
//     tiles S and dP are f32 in shared memory; the accumulators (o, dq,
//     dk, dv) are f32 [tile][D] in shared memory, rescaled in place by the
//     online softmax's alpha. At D <= 64 a 64-row tile fits several blocks
//     per SM; where 64 rows do not fit the 227 KB of shared memory (bf16
//     dk/dv from D 161, dq from D 225; f32 dk/dv from D 97, dq from D 129,
//     the forward from D 177), the tile is 32 rows;
//   * bf16 and f16 inputs: WMMA (mma.sync) 16x16x16 products, 16-bit in,
//     f32 accumulate; f32 inputs: f32 FMA from shared memory, never TF32, so
//     f32 holds an f32 tolerance.
// bf16 and f16 at head dim 64 or 128 with aligned inputs run the three
// kernels of flash_attention_sm90.cu instead (register-resident mma.sync
// tiles); these kernels keep f32, the other head dims and unaligned inputs.

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
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e9f;       // finite mask fill, as the reference
constexpr size_t kMaxSmem = 232448;    // 227 KB: a block's most on H100

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

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

// Row padding (elements) of a shared-memory tile of T: keeps WMMA's ldm a
// multiple of 8 (bf16, f16) / 4 (f32), 16-byte vector stores aligned, and
// staggers consecutive rows over the banks.
template <typename T> __host__ __device__ constexpr int pad_of();
template <> __host__ __device__ constexpr int pad_of<bf16>() { return 8; }
template <> __host__ __device__ constexpr int pad_of<f16>() { return 8; }
template <> __host__ __device__ constexpr int pad_of<float>() { return 4; }

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

struct Args {
  const void* q;        // [BH, Sq, D]
  const void* k;        // [BH, Sk, D]
  const void* v;        // [BH, Sk, D]
  const float* bias;    // [B, Sk] or null; head bh reads row bh / H
  const void* dout;     // [BH, Sq, D] (backward)
  float* lse;           // [BH, Sq]: written by the forward, read backward
  const float* delta;   // [BH, Sq] rowsum(dO * O) (backward)
  void* out;            // forward: o; dq kernel: dq; dk/dv kernel: dk
  void* out2;           // dk/dv kernel: dv
  int BH, H, Sq, Sk, D, Dp;   // Dp: D rounded up to a multiple of 16
  float scale;
  int causal;
  int vec;              // D % 8 == 0 and 16-byte aligned inputs
};

// ---------------------------------------------------------------------------
// shared-memory layout, the same on the host (launch size) and the device
// ---------------------------------------------------------------------------

__host__ __device__ constexpr size_t align_up(size_t x) {
  return (x + 127) & ~size_t(127);
}

struct Layout {
  size_t q, k, v, dout, s, dp, p, ds, acc, acc2, rows, total;
};

// bt x Dp tiles of T (q, k, v and, backward, dO) with row stride
// Dp + pad; f32 score tiles [bt][bt + 4] (S; backward also dP); T tiles
// [bt][bt + pad] (forward P, dq dS, dk/dv P and dS); f32 accumulators
// [bt][Dp + 4] (o or dq; dk and dv); four f32 values per row.
template <typename T>
__host__ __device__ Layout make_layout(int kind, int bt, int Dp) {
  const size_t tile = (size_t)bt * (Dp + pad_of<T>()) * sizeof(T);
  const size_t score = (size_t)bt * (bt + 4) * sizeof(float);
  const size_t ptile = (size_t)bt * (bt + pad_of<T>()) * sizeof(T);
  const size_t acc = (size_t)bt * (Dp + 4) * sizeof(float);
  Layout L{};
  size_t o = 0;
  L.q = o;    o = align_up(o + tile);
  L.k = o;    o = align_up(o + tile);
  L.v = o;    o = align_up(o + tile);
  if (kind != kFwd) { L.dout = o; o = align_up(o + tile); }
  L.s = o;    o = align_up(o + score);
  if (kind != kFwd) { L.dp = o; o = align_up(o + score); }
  L.p = o;    o = align_up(o + ptile);
  if (kind == kDkv) { L.ds = o; o = align_up(o + ptile); }
  L.acc = o;  o = align_up(o + acc);
  if (kind == kDkv) { L.acc2 = o; o = align_up(o + acc); }
  L.rows = o; o = align_up(o + 4 * (size_t)bt * sizeof(float));
  L.total = o;
  return L;
}

// ---------------------------------------------------------------------------
// tiles and products
// ---------------------------------------------------------------------------

// rows r0 .. r0+BT of a [S, D] matrix into dst [BT][ld]: rows at and past
// S and columns D .. Dp are zeros
template <typename T, int BT>
__device__ void load_tile(T* dst, int ld, const T* src, int r0, int S,
                          int D, int Dp, bool vec) {
  if (vec) {
    const int upr = Dp / 8;                  // 8-element units per row
    for (int u = threadIdx.x; u < BT * upr; u += kThreads) {
      const int r = u / upr, c = (u - r * upr) * 8;
      Vec8<T> x;
      if (r0 + r < S && c < D)
        load8(x, src + (int64_t)(r0 + r) * D + c);
      else
        zero8(x);
      store8(dst + r * ld + c, x);
    }
  } else {
    for (int e = threadIdx.x; e < BT * Dp; e += kThreads) {
      const int r = e / Dp, c = e - r * Dp;
      dst[r * ld + c] = (r0 + r < S && c < D)
                            ? src[(int64_t)(r0 + r) * D + c]
                            : from_f32<T>(0.f);
    }
  }
}

// C [M][N] (f32, ldc) = A [M][K] . B [N][K]^T, A and B row-major in shared
// memory, K a multiple of 16. No barrier.
template <int M, int N, typename E>
__device__ void mm_nt(float* C, int ldc, const E* A, int lda,
                      const E* B, int ldb, int K) {
  constexpr int kTiles = (M / 16) * (N / 16);
  const int warp = threadIdx.x / 32;
  for (int t = warp; t < kTiles; t += kWarps) {
    const int ti = t / (N / 16), tj = t % (N / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::fill_fragment(c, 0.f);
    for (int kk = 0; kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, E, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, E, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, A + ti * 16 * lda + kk, lda);
      wmma::load_matrix_sync(fb, B + tj * 16 * ldb + kk, ldb);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(C + ti * 16 * ldc + tj * 16, c, ldc,
                            wmma::mem_row_major);
  }
}

template <int M, int N>
__device__ void mm_nt(float* C, int ldc, const float* A, int lda,
                      const float* B, int ldb, int K) {
  constexpr int CT = 16;                     // threads across columns
  constexpr int RT = kThreads / CT;          // threads across rows
  constexpr int RN = N / CT, RM = M / RT;    // cells per thread
  static_assert(RN * CT == N && RM * RT == M, "tile split");
  const int tx = threadIdx.x % CT, ty = threadIdx.x / CT;
  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < K; ++k) {
    float av[RM], bv[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) av[i] = A[(ty + i * RT) * lda + k];
#pragma unroll
    for (int j = 0; j < RN; ++j) bv[j] = B[(tx + j * CT) * ldb + k];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j)
      C[(ty + i * RT) * ldc + tx + j * CT] = acc[i][j];
}

// C [M][N] (f32, ldc) += op(A) . B over K: op(A) is A [M][K] row-major or,
// with A_T, the transpose of A [K][M] row-major; B [K][N] row-major; N
// and K multiples of 16. With row_scale, C's row r is first multiplied by
// row_scale[r] (the online softmax's rescale). Every warp (f32: thread)
// owns the same cells of C at every call, so calls need no barrier on C.
template <int M, bool A_T, typename E>
__device__ void mm_acc(float* C, int ldc, const E* A, int lda,
                       const E* B, int ldb, int N, int K,
                       const float* row_scale) {
  using ALayout =
      typename std::conditional<A_T, wmma::col_major, wmma::row_major>::type;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ntj = N / 16;
  const int tiles = (M / 16) * ntj;
  for (int t = warp; t < tiles; t += kWarps) {
    const int ti = t / ntj, tj = t % ntj;
    float* cp = C + ti * 16 * ldc + tj * 16;
    if (row_scale != nullptr) {
      for (int e = lane; e < 256; e += 32) {
        const int r = e / 16;
        cp[r * ldc + e % 16] *= row_scale[ti * 16 + r];
      }
      __syncwarp();
    }
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::load_matrix_sync(c, cp, ldc, wmma::mem_row_major);
    for (int kk = 0; kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, E, ALayout> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, E, wmma::row_major> fb;
      const E* ap = A_T ? A + kk * lda + ti * 16 : A + ti * 16 * lda + kk;
      wmma::load_matrix_sync(fa, ap, lda);
      wmma::load_matrix_sync(fb, B + kk * ldb + tj * 16, ldb);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(cp, c, ldc, wmma::mem_row_major);
    __syncwarp();
  }
}

template <int M, bool A_T>
__device__ void mm_acc(float* C, int ldc, const float* A, int lda,
                       const float* B, int ldb, int N, int K,
                       const float* row_scale) {
  constexpr int RM = M / 4;                  // rows ty, ty + 4, ...
  const int tx = threadIdx.x % 64, ty = threadIdx.x / 64;
  for (int c0 = 0; c0 < N; c0 += 64) {
    const int col = c0 + tx;
    if (col >= N) break;
    float acc[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + 4 * i;
      acc[i] = C[r * ldc + col] * (row_scale != nullptr ? row_scale[r] : 1.f);
    }
    for (int k = 0; k < K; ++k) {
      const float b = B[k * ldb + col];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = ty + 4 * i;
        acc[i] = fmaf(A_T ? A[k * lda + r] : A[r * lda + k], b, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) C[(ty + 4 * i) * ldc + col] = acc[i];
  }
}

// s of one score: scaled, biased, causally masked (the TPU kernel's order)
__device__ __forceinline__ float score(float dot, const Args& a,
                                       const float* bias, int row, int col,
                                       int off) {
  float s = dot * a.scale;
  if (bias != nullptr) s += bias[col];
  if (a.causal && col > row + off) s = kNegInf;
  return s;
}

// key tiles [0, end) a query tile q0 .. q0+BT must visit (causal: up to the
// last one holding a column <= its last real row + off)
__device__ __forceinline__ int key_tiles_end(const Args& a, int q0, int bt) {
  const int nk = (a.Sk + bt - 1) / bt;
  if (!a.causal) return nk;
  const int last = min(q0 + bt, a.Sq) - 1 + (a.Sk - a.Sq);
  return last < 0 ? 0 : min(nk, last / bt + 1);
}

// first query tile that sees any column of the key tile k0 .. k0+BT
__device__ __forceinline__ int query_tiles_begin(const Args& a, int k0,
                                                 int bt) {
  if (!a.causal) return 0;
  const int x = k0 - (a.Sk - a.Sq) - bt + 1;
  return x <= 0 ? 0 : (x + bt - 1) / bt;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int BT>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout<T>(kFwd, BT, a.Dp);
  T* q_s = reinterpret_cast<T*>(smem + L.q);
  T* k_s = reinterpret_cast<T*>(smem + L.k);
  T* v_s = reinterpret_cast<T*>(smem + L.v);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  T* p_s = reinterpret_cast<T*>(smem + L.p);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* alpha_s = reinterpret_cast<float*>(smem + L.rows);
  float* m_s = alpha_s + BT;
  float* l_s = m_s + BT;
  const int ldt = a.Dp + pad_of<T>(), ldp = BT + pad_of<T>();
  const int lda = a.Dp + 4;
  constexpr int lds = BT + 4;
  const int bh = blockIdx.y, q0 = blockIdx.x * BT;
  const int64_t qoff = (int64_t)bh * a.Sq * a.D;
  const int64_t koff = (int64_t)bh * a.Sk * a.D;
  const T* k = static_cast<const T*>(a.k) + koff;
  const T* v = static_cast<const T*>(a.v) + koff;
  const float* bias =
      a.bias != nullptr ? a.bias + (int64_t)(bh / a.H) * a.Sk : nullptr;
  const int off = a.Sk - a.Sq;
  const int kt_end = key_tiles_end(a, q0, BT);

  load_tile<T, BT>(q_s, ldt, static_cast<const T*>(a.q) + qoff, q0, a.Sq,
                   a.D, a.Dp, a.vec);
  for (int e = threadIdx.x; e < BT * lda; e += kThreads) acc[e] = 0.f;
  // the online softmax: TPR threads per row, columns part, part + TPR, ...
  constexpr int TPR = kThreads / BT;
  constexpr int CPT = BT / TPR;
  const int row = threadIdx.x / TPR, part = threadIdx.x % TPR;
  float m = kNegInf, l = 0.f;

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();   // the last tile's readers of k_s, v_s, p_s are done
    load_tile<T, BT>(k_s, ldt, k, k0, a.Sk, a.D, a.Dp, a.vec);
    load_tile<T, BT>(v_s, ldt, v, k0, a.Sk, a.D, a.Dp, a.vec);
    __syncthreads();
    mm_nt<BT, BT>(s_s, lds, q_s, ldt, k_s, ldt, a.Dp);
    __syncthreads();
    float x[CPT];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = part + j * TPR;
      x[j] = k0 + c < a.Sk
                 ? score(s_s[row * lds + c], a, bias, q0 + row, k0 + c, off)
                 : kNegInf;
      tmax = fmaxf(tmax, x[j]);
    }
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
    const float m_new = fmaxf(m, tmax);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = part + j * TPR;
      const float p = k0 + c < a.Sk ? expf(x[j] - m_new) : 0.f;
      psum += p;
      p_s[row * ldp + c] = from_f32<T>(p);   // rounded to v's dtype
    }
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    const float alpha = expf(m - m_new);
    l = l * alpha + psum;
    m = m_new;
    if (part == 0) alpha_s[row] = alpha;
    __syncthreads();
    // acc = acc * alpha + P . V
    mm_acc<BT, false>(acc, lda, p_s, ldp, v_s, ldt, a.Dp, BT, alpha_s);
  }
  if (part == 0) {
    m_s[row] = m;
    l_s[row] = l;
  }
  __syncthreads();
  T* o = static_cast<T*>(a.out) + qoff;
  for (int e = threadIdx.x; e < BT * a.D; e += kThreads) {
    const int r = e / a.D, c = e - r * a.D;
    if (q0 + r < a.Sq)
      o[(int64_t)(q0 + r) * a.D + c] =
          from_f32<T>(acc[r * lda + c] / fmaxf(l_s[r], 1e-30f));
  }
  if (threadIdx.x < BT && q0 + (int)threadIdx.x < a.Sq)
    a.lse[(int64_t)bh * a.Sq + q0 + threadIdx.x] =
        m_s[threadIdx.x] + logf(fmaxf(l_s[threadIdx.x], 1e-30f));
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// lse and delta of rows q0 .. q0+BT (0 past Sq)
template <int BT>
__device__ __forceinline__ void load_rows(const Args& a, int bh, int q0,
                                          float* lse_s, float* delta_s) {
  for (int r = threadIdx.x; r < BT; r += kThreads) {
    const bool ok = q0 + r < a.Sq;
    const int64_t at = (int64_t)bh * a.Sq + q0 + r;
    lse_s[r] = ok ? a.lse[at] : 0.f;
    delta_s[r] = ok ? a.delta[at] : 0.f;
  }
}

// p and ds of score cell (r, c) of the query tile q0 and key tile k0 from
// S and dP in shared memory; 0 for rows past Sq and keys past Sk
__device__ __forceinline__ void p_ds(const Args& a, const float* bias,
                                     const float* s_s, const float* dp_s,
                                     int lds, const float* lse_s,
                                     const float* delta_s, int q0, int k0,
                                     int r, int c, float& p, float& ds) {
  p = ds = 0.f;
  if (q0 + r < a.Sq && k0 + c < a.Sk) {
    const float s =
        score(s_s[r * lds + c], a, bias, q0 + r, k0 + c, a.Sk - a.Sq);
    p = expf(s - lse_s[r]);
    ds = p * (dp_s[r * lds + c] - delta_s[r]) * a.scale;
  }
}

template <typename T, int BT>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout<T>(kDq, BT, a.Dp);
  T* q_s = reinterpret_cast<T*>(smem + L.q);
  T* k_s = reinterpret_cast<T*>(smem + L.k);
  T* v_s = reinterpret_cast<T*>(smem + L.v);
  T* do_s = reinterpret_cast<T*>(smem + L.dout);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* dp_s = reinterpret_cast<float*>(smem + L.dp);
  T* ds_s = reinterpret_cast<T*>(smem + L.p);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* lse_s = reinterpret_cast<float*>(smem + L.rows);
  float* delta_s = lse_s + BT;
  const int ldt = a.Dp + pad_of<T>(), ldp = BT + pad_of<T>();
  const int lda = a.Dp + 4;
  constexpr int lds = BT + 4;
  const int bh = blockIdx.y, q0 = blockIdx.x * BT;
  const int64_t qoff = (int64_t)bh * a.Sq * a.D;
  const int64_t koff = (int64_t)bh * a.Sk * a.D;
  const T* k = static_cast<const T*>(a.k) + koff;
  const T* v = static_cast<const T*>(a.v) + koff;
  const float* bias =
      a.bias != nullptr ? a.bias + (int64_t)(bh / a.H) * a.Sk : nullptr;
  const int kt_end = key_tiles_end(a, q0, BT);

  load_tile<T, BT>(q_s, ldt, static_cast<const T*>(a.q) + qoff, q0, a.Sq,
                   a.D, a.Dp, a.vec);
  load_tile<T, BT>(do_s, ldt, static_cast<const T*>(a.dout) + qoff, q0,
                   a.Sq, a.D, a.Dp, a.vec);
  load_rows<BT>(a, bh, q0, lse_s, delta_s);
  for (int e = threadIdx.x; e < BT * lda; e += kThreads) acc[e] = 0.f;

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();   // the last tile's readers of k_s and ds_s are done
    load_tile<T, BT>(k_s, ldt, k, k0, a.Sk, a.D, a.Dp, a.vec);
    load_tile<T, BT>(v_s, ldt, v, k0, a.Sk, a.D, a.Dp, a.vec);
    __syncthreads();
    mm_nt<BT, BT>(s_s, lds, q_s, ldt, k_s, ldt, a.Dp);
    mm_nt<BT, BT>(dp_s, lds, do_s, ldt, v_s, ldt, a.Dp);
    __syncthreads();
    for (int e = threadIdx.x; e < BT * BT; e += kThreads) {
      const int r = e / BT, c = e % BT;
      float p, ds;
      p_ds(a, bias, s_s, dp_s, lds, lse_s, delta_s, q0, k0, r, c, p, ds);
      ds_s[r * ldp + c] = from_f32<T>(ds);   // rounded to k's dtype
    }
    __syncthreads();
    // dq += dS . K
    mm_acc<BT, false>(acc, lda, ds_s, ldp, k_s, ldt, a.Dp, BT, nullptr);
  }
  __syncthreads();
  T* dq = static_cast<T*>(a.out) + qoff;
  for (int e = threadIdx.x; e < BT * a.D; e += kThreads) {
    const int r = e / a.D, c = e - r * a.D;
    if (q0 + r < a.Sq)
      dq[(int64_t)(q0 + r) * a.D + c] = from_f32<T>(acc[r * lda + c]);
  }
}

template <typename T, int BT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout<T>(kDkv, BT, a.Dp);
  T* q_s = reinterpret_cast<T*>(smem + L.q);
  T* k_s = reinterpret_cast<T*>(smem + L.k);
  T* v_s = reinterpret_cast<T*>(smem + L.v);
  T* do_s = reinterpret_cast<T*>(smem + L.dout);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* dp_s = reinterpret_cast<float*>(smem + L.dp);
  T* p_s = reinterpret_cast<T*>(smem + L.p);
  T* ds_s = reinterpret_cast<T*>(smem + L.ds);
  float* dk_acc = reinterpret_cast<float*>(smem + L.acc);
  float* dv_acc = reinterpret_cast<float*>(smem + L.acc2);
  float* lse_s = reinterpret_cast<float*>(smem + L.rows);
  float* delta_s = lse_s + BT;
  const int ldt = a.Dp + pad_of<T>(), ldp = BT + pad_of<T>();
  const int lda = a.Dp + 4;
  constexpr int lds = BT + 4;
  const int bh = blockIdx.y, k0 = blockIdx.x * BT;
  const int64_t qoff = (int64_t)bh * a.Sq * a.D;
  const int64_t koff = (int64_t)bh * a.Sk * a.D;
  const T* q = static_cast<const T*>(a.q) + qoff;
  const T* dout = static_cast<const T*>(a.dout) + qoff;
  const float* bias =
      a.bias != nullptr ? a.bias + (int64_t)(bh / a.H) * a.Sk : nullptr;
  const int nq = (a.Sq + BT - 1) / BT;

  load_tile<T, BT>(k_s, ldt, static_cast<const T*>(a.k) + koff, k0, a.Sk,
                   a.D, a.Dp, a.vec);
  load_tile<T, BT>(v_s, ldt, static_cast<const T*>(a.v) + koff, k0, a.Sk,
                   a.D, a.Dp, a.vec);
  for (int e = threadIdx.x; e < BT * lda; e += kThreads)
    dk_acc[e] = dv_acc[e] = 0.f;

  for (int qt = query_tiles_begin(a, k0, BT); qt < nq; ++qt) {
    const int q0 = qt * BT;
    __syncthreads();   // the last tile's readers of q_s, do_s, p_s, ds_s
    load_tile<T, BT>(q_s, ldt, q, q0, a.Sq, a.D, a.Dp, a.vec);
    load_tile<T, BT>(do_s, ldt, dout, q0, a.Sq, a.D, a.Dp, a.vec);
    load_rows<BT>(a, bh, q0, lse_s, delta_s);
    __syncthreads();
    mm_nt<BT, BT>(s_s, lds, q_s, ldt, k_s, ldt, a.Dp);
    mm_nt<BT, BT>(dp_s, lds, do_s, ldt, v_s, ldt, a.Dp);
    __syncthreads();
    for (int e = threadIdx.x; e < BT * BT; e += kThreads) {
      const int r = e / BT, c = e % BT;
      float p, ds;
      p_ds(a, bias, s_s, dp_s, lds, lse_s, delta_s, q0, k0, r, c, p, ds);
      p_s[r * ldp + c] = from_f32<T>(p);     // rounded to dO's dtype
      ds_s[r * ldp + c] = from_f32<T>(ds);   // rounded to q's dtype
    }
    __syncthreads();
    // dv += P^T . dO, dk += dS^T . Q
    mm_acc<BT, true>(dv_acc, lda, p_s, ldp, do_s, ldt, a.Dp, BT, nullptr);
    mm_acc<BT, true>(dk_acc, lda, ds_s, ldp, q_s, ldt, a.Dp, BT, nullptr);
  }
  __syncthreads();
  T* dk = static_cast<T*>(a.out) + koff;
  T* dv = static_cast<T*>(a.out2) + koff;
  for (int e = threadIdx.x; e < BT * a.D; e += kThreads) {
    const int r = e / a.D, c = e - r * a.D;
    if (k0 + r < a.Sk) {
      dk[(int64_t)(k0 + r) * a.D + c] = from_f32<T>(dk_acc[r * lda + c]);
      dv[(int64_t)(k0 + r) * a.D + c] = from_f32<T>(dv_acc[r * lda + c]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

bool valid_shape(const Args& a) {
  return a.BH >= 1 && a.H >= 1 && a.Sq >= 1 && a.Sk >= 1 && a.D >= 1 &&
         a.D <= kMaxD;
}

template <typename T, int BT>
int launch_tile(int kind, const Args& a, cudaStream_t st) {
  const size_t smem = make_layout<T>(kind, BT, a.Dp).total;
  const int rows = kind == kDkv ? a.Sk : a.Sq;
  const dim3 grid((rows + BT - 1) / BT, a.BH);
  void (*kernel)(const Args) =
      kind == kFwd ? flash_fwd_kernel<T, BT>
                   : (kind == kDq ? flash_bwd_dq_kernel<T, BT>
                                  : flash_bwd_dkv_kernel<T, BT>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// 64-row tiles where they fit in shared memory, else 32 (which fit for
// every D <= 256: 219 KB at f32 D = 256, dk/dv)
template <typename T>
int launch(int kind, Args a, cudaStream_t st) {
  a.Dp = (a.D + 15) / 16 * 16;
  if (make_layout<T>(kind, 64, a.Dp).total <= kMaxSmem)
    return launch_tile<T, 64>(kind, a, st);
  return launch_tile<T, 32>(kind, a, st);
}

// dtype codes of the entries (and of flash_attention_sm90.cu): 0 f32,
// 1 bf16, 2 f16
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

// o [BH, Sq, D] in the input dtype and lse [BH, Sq] f32. Returns the
// cudaError_t of the launch.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const float* bias, void* out, float* lse, int BH,
                        int H, int Sq, int Sk, int D, float scale, int causal,
                        int vec, int dtype, void* stream) {
  Args a{q, k, v, bias, nullptr, lse, nullptr, out, nullptr,
         BH, H, Sq, Sk, D, 0, scale, causal, vec};
  return run(kFwd, a, dtype, stream);
}

// dq [BH, Sq, D] from the saved lse and delta = rowsum(dO * O).
int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const float* bias, const void* dout,
                           const float* lse, const float* delta, void* dq,
                           int BH, int H, int Sq, int Sk, int D, float scale,
                           int causal, int vec, int dtype, void* stream) {
  Args a{q, k, v, bias, dout, const_cast<float*>(lse), delta, dq, nullptr,
         BH, H, Sq, Sk, D, 0, scale, causal, vec};
  return run(kDq, a, dtype, stream);
}

// dk and dv [BH, Sk, D] from the saved lse and delta.
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                            const float* bias, const void* dout,
                            const float* lse, const float* delta, void* dk,
                            void* dv, int BH, int H, int Sq, int Sk, int D,
                            float scale, int causal, int vec, int dtype,
                            void* stream) {
  Args a{q, k, v, bias, dout, const_cast<float*>(lse), delta, dk, dv,
         BH, H, Sq, Sk, D, 0, scale, causal, vec};
  return run(kDkv, a, dtype, stream);
}

}  // extern "C"
