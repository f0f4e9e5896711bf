// Decode attention over a KV cache, for Hopper (sm_90a): split-K
// flash-decoding with 16-byte vector loads for single-token steps, and
// mma.sync query tiles for bf16 and f16 chunks. Every kernel is a template
// on the types: f32, bf16 and f16 for q and for the cache, in any pair.
//
// Replaces the two TPU Pallas kernels of the serving path:
//   paddle_tpu/ops/pallas/decode_attention.py:_decode_attn_kernel
//       (contiguous cache [b, h, L, d]; GPT.generate's StaticKVCache)
//   paddle_tpu/ops/pallas/decode_attention.py:_paged_decode_attn_kernel
//       (shared arena [n_blocks + 1, h, bs, d] through block tables
//        [b, nb]; the ServeLoop's paged pool)
//
// What it computes: row r of the query chunk q [b, h, s, d] of batch row
// i attends to cache columns c <= fill_i + r, where fill_i is the number
// of tokens in the cache before the chunk (a scalar or a per-row [b]
// vector). Masked scores are -1e9 (finite, as in the reference) and the
// softmax denominator is clamped at 1e-30. q is cast to the cache dtype
// on load; the output is written in q's dtype.
//
// What bounds it: device-memory bytes of the LIVE K/V columns for a decode
// step (s = 1: 4 * live * d flops for 2 * live * d * sizeof(T) bytes, far
// below the card's flop/byte balance); the tensor cores for a long chunk
// (a 1024-token prefill does 4 * d flops per live (row, column) pair).
// Three kernels and a combine, one path per call, chosen by the wrapper
// from dtype, shape and alignment before the launch (never as a fallback):
//
//   decode_split_kernel (s = 1, any dtype pair, d * sizeof(cache) a multiple
//   of 16 bytes, 16-byte aligned cache):
//     * one block of 4 warps per (batch row, head, split). A key's row is
//       read as 16-byte vectors (ld.global.nc) by LPK lanes (d 64 bf16: 8
//       lanes, so one warp load takes 4 keys, 512 contiguous bytes); the
//       loads of the next step sit in a register double buffer while the
//       current step computes;
//     * q sits in registers, already rounded to the cache dtype; a key's
//       dot product is reduced by shuffles across its LPK lanes; the
//       softmax is online in log2 units (exp2f);
//     * each lane group keeps its own (m, l, acc) over the keys it reads;
//       the groups of a warp merge by shuffles and the 4 warps through
//       shared memory, in fixed order;
//     * the block walks 64-column tiles (warp w takes columns 16w..16w+15
//       of each), stops at the row's last live tile and reads no column
//       past the live length; paged: each warp reads the block-table
//       entries under its 16 columns once per step (bs % 8 == 0, so at
//       most two pool blocks), not per element;
//   split-K over the cache (flash-decoding): the wrapper's planner
//     (`_kv_splits`) cuts the CAPACITY columns (L, or nb * bs) into splits
//     of whole 64-column tiles from the shapes alone, never from the live
//     lengths (those live on the card). A split that starts past a row's
//     live length writes an empty partial. With several splits the kernels
//     write f32 partials (m, l, acc[d]) to the wrapper's scratch and
//     decode_combine_kernel merges them in split order (no atomics); with
//     one split the kernel writes the output itself;
//   decode_mma_kernel (s > 1, q and cache both bf16 or both f16, d 64 or
//   128, 16-byte aligned): the FA2 forward of flash_attention_sm90.cu over the cache:
//     64-row query tiles of 4 warps, 64-column K/V tiles gathered through
//     the cache's addressing into a three-stage cp.async ring (swizzled,
//     ldmatrix / ldmatrix.trans), S and P in mma.sync m16n8k16 fragments,
//     the mask col <= fill + row applied on the fragments, the loop bounded
//     by the last live tile of the tile's last row, P rounded to the
//     16-bit type as the A operand of P . V (the TPU kernel rounds it too,
//     :81);
//   decode_attn_kernel (everything else: f32 or mixed-type chunks, other
//   head dims, unaligned caches): the first, scalar kernel of this port,
//   one split, K/V tiles as f32 in shared memory.
// Contiguous and paged walk the same logical tiles with the same split
// boundaries and the same arithmetic, so on equal K/V values they give
// bitwise the same output; every path gives the same bits on every launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int kTileK = 32;           // scalar kernel: KV columns per tile
constexpr int kTile = 64;            // split-K tile: columns, and split unit
constexpr float kNegInf = -1e9f;     // finite mask fill, as the reference
constexpr int kMaxD = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf2 = kNegInf * kLog2e;   // the fill in log2 units
constexpr unsigned kFull = 0xffffffffu;

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
  return __float2half_rn(x);
}

// Round an f32 value through the cache dtype (q is cast to it on load).
template <typename TC> __device__ __forceinline__ float through(float x) {
  return to_f32(from_f32<TC>(x));
}

struct Args {
  const void* q;             // [b, h, s, d], q dtype
  const void* k;             // contiguous [b, h, L, d] / arena [n, h, bs, d]
  const void* v;
  void* out;                 // [b, h, s, d], q dtype
  const int* fills;          // [b] fill before the chunk, or null
  int fill_scalar;           // used when fills is null
  const int* block_tables;   // [b, nb] (paged) or null (contiguous)
  int b, h, s, d;
  int len;                   // contiguous: L; paged: block size bs
  int nb;                    // paged: logical blocks per row
  float scale;
  int splits;                // split-K: number of splits (1: none)
  int span;                  // columns per split, a multiple of kTile
  float* part;               // splits > 1: [splits, rows, 2] (m, l) then
                             // [splits, rows, d] acc, rows = b * h * s
  uint32_t len_mul, len_shift;   // n / len as a multiply (set_fast_div)
};

// n / a.len for 0 <= n < 2^31 without a division instruction: the
// multiply-high by a magic number that set_fast_div computes once
__device__ __forceinline__ int div_bs(const Args& a, int n) {
  return (int)((__umulhi((uint32_t)n, a.len_mul) + (uint32_t)n) >>
               a.len_shift);
}

void set_fast_div(Args& a) {
  uint32_t shift = 0;
  while ((1u << shift) < (uint32_t)a.len) ++shift;
  a.len_shift = shift;
  a.len_mul = (uint32_t)((((uint64_t)1 << 32) * (((uint64_t)1 << shift) -
                                                  (uint64_t)a.len)) /
                             (uint64_t)a.len + 1);
}

__device__ __forceinline__ int row_fill(const Args& a, int ib) {
  return a.fills != nullptr ? a.fills[ib] : a.fill_scalar;
}

__host__ __device__ __forceinline__ int capacity(const Args& a) {
  return a.block_tables != nullptr ? a.nb * a.len : a.len;
}

// ---------------------------------------------------------------------------
// the scalar kernel: f32 / mixed-type chunks, other head dims
// ---------------------------------------------------------------------------

// TPR threads own one query row; a block holds ROWS rows (ROWS * TPR
// threads). DMAX bounds d so the accumulator is a fixed register array.
template <typename TQ, typename TC, int TPR, int ROWS, int DMAX>
__global__ void __launch_bounds__(TPR * ROWS)
decode_attn_kernel(const Args a) {
  constexpr int kThreads = TPR * ROWS;
  constexpr int kCols = DMAX / TPR;        // accumulator columns / thread
  constexpr int kKeys = kTileK / TPR;      // scores / thread / tile
  extern __shared__ float smem[];
  const int d = a.d;
  const int ds = d + 1;                    // padded shared row stride
  float* q_s = smem;                       // ROWS x ds
  float* k_s = q_s + ROWS * ds;            // kTileK x ds
  float* v_s = k_s + kTileK * ds;          // kTileK x ds
  float* p_s = v_s + kTileK * ds;          // ROWS x kTileK

  const int tid = threadIdx.x;
  const int r = tid / TPR;                 // row within the tile
  const int j = tid % TPR;                 // lane within the row group
  const int ib = blockIdx.z;
  const int ih = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const int rows_here = min(ROWS, a.s - row0);
  const int row = row0 + r;
  const int fill = row_fill(a, ib);
  const bool paged = a.block_tables != nullptr;
  const int cols = capacity(a);                     // logical columns
  // the last column the LAST row of this tile attends to bounds the loop
  const int last_col = min(fill + row0 + rows_here - 1, cols - 1);
  const int n_tiles = last_col / kTileK + 1;
  const int row_last = min(fill + row, cols - 1);   // this row's last col

  const TQ* q = static_cast<const TQ*>(a.q) +
                ((int64_t)(ib * a.h + ih) * a.s + row0) * d;
  for (int i = tid; i < ROWS * d; i += kThreads) {
    const int rr = i / d;
    const int e = i - rr * d;
    q_s[rr * ds + e] =
        rr < rows_here ? through<TC>(to_f32(q[(int64_t)rr * d + e])) : 0.f;
  }

  const TC* kp = static_cast<const TC*>(a.k);
  const TC* vp = static_cast<const TC*>(a.v);
  const int* bt_row =
      paged ? a.block_tables + (int64_t)ib * a.nb : nullptr;
  const int64_t contig_base = (int64_t)(ib * a.h + ih) * a.len;

  float m = kNegInf;
  float l = 0.f;
  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * kTileK;
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < kTileK * d; i += kThreads) {
      const int kk = i / d;
      const int e = i - kk * d;
      const int c = c0 + kk;
      float kv = 0.f, vv = 0.f;
      if (c <= last_col) {
        int64_t off;
        if (paged) {
          const int blk = c / a.len;
          const int64_t phys = bt_row[blk];
          off = ((phys * a.h + ih) * a.len + (c - blk * a.len)) * d + e;
        } else {
          off = (contig_base + c) * d + e;
        }
        kv = to_f32(kp[off]);
        vv = to_f32(vp[off]);
      }
      k_s[kk * ds + e] = kv;
      v_s[kk * ds + e] = vv;
    }
    __syncthreads();

    float sc[kKeys];
    float tmax = kNegInf;
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      const int kk = j + i * TPR;
      const float* qr = q_s + r * ds;
      const float* kr = k_s + kk * ds;
      float dot = 0.f;
      for (int e = 0; e < d; ++e) dot = fmaf(qr[e], kr[e], dot);
      float x = dot * a.scale;
      if (c0 + kk > row_last) x = kNegInf;
      sc[i] = x;
      tmax = fmaxf(tmax, x);
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, o));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      const float p = expf(sc[i] - m_new);
      psum += p;
      p_s[r * kTileK + j + i * TPR] = p;
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      psum += __shfl_xor_sync(kFull, psum, o);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();      // a row group lies inside one warp
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[i] *= alpha;
    for (int kk = 0; kk < kTileK; ++kk) {
      const float p = p_s[r * kTileK + kk];
      const float* vr = v_s + kk * ds;
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int e = j + i * TPR;
        if (e < d) acc[i] = fmaf(p, vr[e], acc[i]);
      }
    }
  }

  if (r < rows_here) {
    const float den = fmaxf(l, 1e-30f);
    TQ* o = static_cast<TQ*>(a.out) +
            ((int64_t)(ib * a.h + ih) * a.s + row) * d;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int e = j + i * TPR;
      if (e < d) o[e] = from_f32<TQ>(acc[i] / den);
    }
  }
}

// ---------------------------------------------------------------------------
// split-K partials: (m, l) in log2 units and acc, merged in split order
// ---------------------------------------------------------------------------

// weight of a partial with running max m in a merge whose max is m_tot;
// an empty partial (m = -inf) weighs nothing
__device__ __forceinline__ float split_weight(float m, float m_tot) {
  return m == -CUDART_INF_F ? 0.f : exp2f(m - m_tot);
}

__host__ __device__ __forceinline__ int64_t part_rows(const Args& a) {
  return (int64_t)a.b * a.h * a.s;
}

// out[row] = sum_i w_i acc_i / max(sum_i w_i l_i, 1e-30) over the splits in
// order; one warp per row of [b * h * s]
template <typename TQ>
__global__ void __launch_bounds__(128) decode_combine_kernel(const Args a) {
  const int64_t rows = part_rows(a);
  const int64_t row = (int64_t)blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* ml = a.part;
  const float* acc = a.part + 2 * a.splits * rows;
  float m_tot = -CUDART_INF_F;
  for (int i = 0; i < a.splits; ++i)
    m_tot = fmaxf(m_tot, ml[((int64_t)i * rows + row) * 2]);
  auto weight = [&](int i) {
    return split_weight(ml[((int64_t)i * rows + row) * 2], m_tot);
  };
  float l = 0.f;
  for (int i = 0; i < a.splits; ++i)
    l = fmaf(ml[((int64_t)i * rows + row) * 2 + 1], weight(i), l);
  const float den = fmaxf(l, 1e-30f);
  TQ* out = static_cast<TQ*>(a.out) + row * a.d;
  for (int e = lane; e < a.d; e += 32) {
    float x = 0.f;
    for (int i = 0; i < a.splits; ++i)
      x = fmaf(acc[((int64_t)i * rows + row) * a.d + e], weight(i), x);
    out[e] = from_f32<TQ>(x / den);
  }
}

// ---------------------------------------------------------------------------
// s = 1: split-K decode with 16-byte vector loads
// ---------------------------------------------------------------------------

// one 16-byte chunk of the cache as f32
template <typename TC> struct Chunk;
template <> struct Chunk<bf16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void unpack(const uint4& u,
                                                float (&f)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Chunk<f16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void unpack(const uint4& u,
                                                float (&f)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};
template <> struct Chunk<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void unpack(const uint4& u,
                                                float (&f)[4]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

// LPK lanes read one key's row (V 16-byte chunks each); KPW = 32 / LPK
// keys per warp load. Warp w takes columns 16w .. 16w + 15 of every
// 64-column tile: KPL keys per lane per tile, in NS steps of KS keys.
template <typename TQ, typename TC, int LPK, int V>
__global__ void __launch_bounds__(128) decode_split_kernel(const Args a) {
  constexpr int EPC = Chunk<TC>::kN;       // elements per chunk
  constexpr int NE = V * EPC;              // elements a lane holds
  constexpr int KPW = 32 / LPK;
  constexpr int KPL = 16 / KPW;
  constexpr int KS = KPL < 4 / V ? KPL : 4 / V;
  constexpr int NS = KPL / KS;
  static_assert(KPW <= 8 && KPL % KS == 0, "lane layout");
  __shared__ float m_s[4], l_s[4];
  __shared__ float acc_s[4][kMaxD];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane / LPK;                // this lane's key in a warp load
  const int cl = lane % LPK;               // its chunk (plus v * LPK)
  const int split = blockIdx.x % a.splits;
  const int bh = blockIdx.x / a.splits;
  const int ib = bh / a.h, ih = bh - ib * a.h;
  const int d = a.d;
  const bool paged = a.block_tables != nullptr;
  const int fill = row_fill(a, ib);
  const int c_begin = split * a.span;
  const int c_end = min(c_begin + a.span, capacity(a));
  // s = 1: the row's last live column, clipped to this split
  const int lim = min(fill, c_end - 1);
  const int n_tiles = lim < c_begin ? 0 : (lim - c_begin) / kTile + 1;
  const int n_steps = n_tiles * NS;

  // q in registers, rounded to the cache dtype
  const TQ* q = static_cast<const TQ*>(a.q) + (int64_t)bh * d;
  float qf[NE];
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int e = 0; e < EPC; ++e) {
      const int i = (cl + v * LPK) * EPC + e;
      qf[v * EPC + e] = i < d ? through<TC>(to_f32(q[i])) : 0.f;
    }

  const TC* kp = static_cast<const TC*>(a.k);
  const TC* vp = static_cast<const TC*>(a.v);
  const int* bt_row = paged ? a.block_tables + (int64_t)ib * a.nb : nullptr;
  const int64_t contig_base = (int64_t)bh * a.len;   // contiguous: row bh

  // the K and V chunks of step j's KS keys (zeros for dead columns);
  // paged, the pool blocks under the warp's 16 columns of the step's tile
  // (at most two, bs % 8 == 0) come from one table read each
  auto load_step = [&](int j, uint4 (&kb)[KS][V], uint4 (&vb)[KS][V]) {
    const int t = j / NS, n = j - t * NS;
    const int col0 = c_begin + t * kTile + 16 * warp;   // the warp's columns
    int phys0 = 0, phys1 = 0, off0 = 0;
    if (paged && col0 <= lim) {
      const int blk0 = div_bs(a, col0);
      off0 = col0 - blk0 * a.len;
      phys0 = __ldg(bt_row + blk0);
      if (off0 + 16 > a.len && col0 + a.len - off0 <= lim)
        phys1 = __ldg(bt_row + blk0 + 1);
    }
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const int jc = (n * KS + k) * KPW + g;             // 0 .. 15
      const bool live = col0 + jc <= lim;
      int64_t row;
      if (paged) {
        const int o = off0 + jc;
        const bool first = o < a.len;
        row = (((int64_t)(first ? phys0 : phys1) * a.h + ih) * a.len +
               (first ? o : o - a.len)) * d;
      } else {
        row = (contig_base + col0 + jc) * d;
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int e = (cl + v * LPK) * EPC;
        const bool ok = live && e < d;
        kb[k][v] = ok ? __ldg(reinterpret_cast<const uint4*>(kp + row + e))
                      : make_uint4(0u, 0u, 0u, 0u);
        vb[k][v] = ok ? __ldg(reinterpret_cast<const uint4*>(vp + row + e))
                      : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  const float sl = a.scale * kLog2e;
  float m = -CUDART_INF_F, l = 0.f;
  float acc[NE];
#pragma unroll
  for (int i = 0; i < NE; ++i) acc[i] = 0.f;

  // online softmax over step j's keys, in log2 units
  auto compute = [&](const uint4 (&kb)[KS][V], const uint4 (&vb)[KS][V],
                     int j) {
    const int t = j / NS, n = j - t * NS;
    const int col0 = c_begin + t * kTile + 16 * warp;
    float x[KS];
    float smax = -CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      float dot = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float f[EPC];
        Chunk<TC>::unpack(kb[k][v], f);
#pragma unroll
        for (int e = 0; e < EPC; ++e) dot = fmaf(qf[v * EPC + e], f[e], dot);
      }
#pragma unroll
      for (int o = LPK / 2; o > 0; o >>= 1)
        dot += __shfl_xor_sync(kFull, dot, o);
      const bool live = col0 + (n * KS + k) * KPW + g <= lim;
      x[k] = live ? dot * sl : -CUDART_INF_F;
      smax = fmaxf(smax, x[k]);
    }
    const float m_new = fmaxf(m, smax);
    if (m_new == -CUDART_INF_F) return;     // no live key for this group yet
    const float alpha = exp2f(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < NE; ++i) acc[i] *= alpha;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const float p = exp2f(x[k] - m_new);
      l += p;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float f[EPC];
        Chunk<TC>::unpack(vb[k][v], f);
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          acc[v * EPC + e] = fmaf(p, f[e], acc[v * EPC + e]);
      }
    }
    m = m_new;
  };

  // register double buffer: step j + 1's loads in flight while j computes
  uint4 kb0[KS][V], vb0[KS][V], kb1[KS][V], vb1[KS][V];
  if (n_steps > 0) load_step(0, kb0, vb0);
  for (int j = 0; j < n_steps; j += 2) {
    if (j + 1 < n_steps) load_step(j + 1, kb1, vb1);
    compute(kb0, vb0, j);
    if (j + 1 < n_steps) {
      if (j + 2 < n_steps) load_step(j + 2, kb0, vb0);
      compute(kb1, vb1, j + 1);
    }
  }

  // the warp's key groups merge by shuffles (lanes of one chunk position)
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
    const float mo = __shfl_xor_sync(kFull, m, o);
    const float lo = __shfl_xor_sync(kFull, l, o);
    const float mn = fmaxf(m, mo);
    const float wa = split_weight(m, mn), wb = split_weight(mo, mn);
    l = l * wa + lo * wb;
#pragma unroll
    for (int i = 0; i < NE; ++i)
      acc[i] = acc[i] * wa + __shfl_xor_sync(kFull, acc[i], o) * wb;
    m = mn;
  }
  if (lane < LPK) {
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        const int i = (lane + v * LPK) * EPC + e;
        if (i < d) acc_s[warp][i] = acc[v * EPC + e];
      }
    if (lane == 0) {
      m_s[warp] = m;
      l_s[warp] = l;
    }
  }
  __syncthreads();

  // the 4 warps merge in order
  float m_tot = fmaxf(fmaxf(m_s[0], m_s[1]), fmaxf(m_s[2], m_s[3]));
  float wgt[4];
  float l_tot = 0.f;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    wgt[w] = split_weight(m_s[w], m_tot);
    l_tot = fmaf(l_s[w], wgt[w], l_tot);
  }
  const int64_t rows = part_rows(a);
  for (int e = threadIdx.x; e < d; e += 128) {
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) x = fmaf(acc_s[w][e], wgt[w], x);
    if (a.splits == 1)
      static_cast<TQ*>(a.out)[(int64_t)bh * d + e] =
          from_f32<TQ>(x / fmaxf(l_tot, 1e-30f));
    else
      a.part[2 * a.splits * rows + ((int64_t)split * rows + bh) * d + e] = x;
  }
  if (a.splits > 1 && threadIdx.x == 0) {
    a.part[((int64_t)split * rows + bh) * 2] = m_tot;
    a.part[((int64_t)split * rows + bh) * 2 + 1] = l_tot;
  }
}

// ---------------------------------------------------------------------------
// s > 1, bf16 or f16 (q and cache alike), d 64 / 128: mma.sync query
// tiles (flash_attention_sm90.cu's forward, its PTX helpers copied so the
// two sources stay independent)
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// all but the newest committed group have landed
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The 16-bit type's tensor-core op: d += a . b, a 16x16 (row), b 16x8
// (col), d 16x8 f32 (f16 has the same m16n8k16 shape as bf16), and two
// f32 rounded to the type, lo in the low half (the fragments' k order).
template <typename T> struct Mma;
template <> struct Mma<bf16> {
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};
template <> struct Mma<f16> {
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

// [rows][D] 16-bit tiles, the 16-byte chunk c of row r stored at chunk
// c ^ (r & 7): the 8 rows one ldmatrix matrix reads hit all 32 banks
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
}

// A operand: the 16 x 16 block at rows r0, k-chunks kc, kc + 1
template <int D, typename T>
__device__ __forceinline__ uint32_t a_addr(const T* t, int r0, int kc,
                                           int lane) {
  return smem_addr(t + swz<D>(r0 + (lane & 15), kc + (lane >> 4)));
}

// B operands of two n8 blocks (n0, n0 + 8) over k-chunks kc, kc + 1 from a
// [n][k] tile
template <int D, typename T>
__device__ __forceinline__ uint32_t bn_addr(const T* t, int n0, int kc,
                                            int lane) {
  const int m = lane >> 3;
  return smem_addr(t + swz<D>(n0 + ((m >> 1) << 3) + (lane & 7), kc + (m & 1)));
}

// the same from a [k][n] tile through ldmatrix.trans
template <int D, typename T>
__device__ __forceinline__ uint32_t bt_addr(const T* t, int k0, int nc,
                                            int lane) {
  const int m = lane >> 3;
  return smem_addr(t + swz<D>(k0 + ((m & 1) << 3) + (lane & 7), nc + (m >> 1)));
}

constexpr int kStages = 3;   // the mma kernel's K/V ring

template <typename T, int D>
__global__ void __launch_bounds__(128) decode_mma_kernel(const Args a) {
  constexpr int BM = 64, BN = kTile, NT = 128, ST = kStages;
  constexpr int KD = D / 16, NB = BN / 8, DB = D / 8, CPR = D / 8;
  extern __shared__ __align__(128) unsigned char tiles[];
  T* q_s = reinterpret_cast<T*>(tiles);        // [BM][D]
  T* k_s = q_s + BM * D;                       // ST x [BN][D]
  T* v_s = k_s + ST * BN * D;                  // ST x [BN][D]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_qt = (a.s + BM - 1) / BM;
  const int per = a.b * a.h * a.splits;
  const int qt = n_qt - 1 - (int)blockIdx.x / per;   // longest tiles first
  const int rest = (int)blockIdx.x % per;
  const int split = rest % a.splits, bh = rest / a.splits;
  const int ib = bh / a.h, ih = bh - ib * a.h;
  const int q0 = qt * BM, rows_here = min(BM, a.s - q0);
  const int fill = row_fill(a, ib);
  const bool paged = a.block_tables != nullptr;
  // the last column the tile's last row attends to bounds the loop
  const int last_q = fill + q0 + rows_here - 1;
  const int c_begin = split * a.span;
  const int c_end = min(c_begin + a.span, capacity(a));
  const int kt0 = c_begin / BN;
  const int kt_end = last_q < c_begin ? kt0 : min(last_q, c_end - 1) / BN + 1;
  const T* q = static_cast<const T*>(a.q) + (int64_t)bh * a.s * D;
  const T* kg = static_cast<const T*>(a.k);
  const T* vg = static_cast<const T*>(a.v);
  const int* bt_row = paged ? a.block_tables + (int64_t)ib * a.nb : nullptr;

  // the query tile (zeros past s)
#pragma unroll
  for (int i = 0; i < BM * CPR / NT; ++i) {
    const int u = threadIdx.x + i * NT;
    const int r = u / CPR, c = u % CPR;
    const bool ok = q0 + r < a.s;
    cp_async16(smem_addr(q_s + swz<D>(r, c)),
               ok ? q + (int64_t)(q0 + r) * D + c * 8 : q, ok);
  }
  // the K and V rows of columns kt * BN .. through the cache's addressing
  // (zeros past the tile's last live column: nothing there is read). A
  // thread copies RPT rows; paged, their physical rows come from the block
  // table a tile ahead (fetch), so no copy waits on a table read
  constexpr int RPT = BN * CPR / NT;
  int phys[RPT];
  auto fetch = [&](int kt) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int col = kt * BN + (threadIdx.x + i * NT) / CPR;
      phys[i] = paged && col <= last_q ? __ldg(bt_row + div_bs(a, col)) : 0;
    }
  };
  auto load_kv = [&](int st, int kt) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int u = threadIdx.x + i * NT;
      const int r = u / CPR, c = u % CPR;
      const int col = kt * BN + r;
      const bool ok = col <= last_q;
      int64_t row = 0;
      if (ok) {
        if (paged)
          row = (((int64_t)phys[i] * a.h + ih) * a.len +
                 (col - div_bs(a, col) * a.len)) * D;
        else
          row = ((int64_t)bh * a.len + col) * D;
      }
      const int dst = st * BN * D + swz<D>(r, c);
      cp_async16(smem_addr(k_s + dst), kg + row + c * 8, ok);
      cp_async16(smem_addr(v_s + dst), vg + row + c * 8, ok);
    }
  };
  if (kt0 < kt_end) {
    fetch(kt0);
    load_kv(0, kt0);
  }
  cp_async_commit();
  if (kt0 + 1 < kt_end) {
    fetch(kt0 + 1);
    load_kv(1, kt0 + 1);
  }
  cp_async_commit();
  if (kt0 + 2 < kt_end) fetch(kt0 + 2);

  const int wrow = q0 + warp * 16;             // the warp's first row
  const int row0 = wrow + (lane >> 2);         // this lane's rows: row0, +8
  const float sl = a.scale * kLog2e;
  uint32_t qf[KD][4];
  float o[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = kNegInf2, m1 = kNegInf2;          // running max (log2 units)
  float l0 = 0.f, l1 = 0.f;                    // this lane's part of the sum

  for (int kt = kt0; kt < kt_end; ++kt) {
    const int st = (kt - kt0) % ST;
    cp_async_wait_1();
    __syncthreads();   // tile kt landed; every warp is done with kt - 1
    if (kt == kt0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(qf[kk], a_addr<D>(q_s, warp * 16, 2 * kk, lane));
    }
    // tile kt + 2 into the stage tile kt - 1 left
    if (kt + 2 < kt_end) {
      load_kv((kt - kt0 + 2) % ST, kt + 2);
      if (kt + 3 < kt_end) fetch(kt + 3);
    }
    cp_async_commit();
    const T* ks = k_s + st * BN * D;
    const T* vs = v_s + st * BN * D;

    // S = Q . K^T
    float s[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int p = 0; p < NB / 2; ++p) {
        uint32_t b[4];
        ldsm_x4(b, bn_addr<D>(ks, p * 16, 2 * kk, lane));
        Mma<T>::run(s[2 * p], qf[kk], b[0], b[1]);
        Mma<T>::run(s[2 * p + 1], qf[kk], b[2], b[3]);
      }
    }

    // scale and mask (col <= fill + row) in log2 units; the row max
    const int k0 = kt * BN;
    const bool edge = k0 + BN - 1 > fill + wrow;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int col = k0 + j * 8 + (lane & 3) * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= sl;
        if (edge) {
          const int c = col + (e & 1), r = row0 + (e >> 1) * 8;
          if (c > fill + r) s[j][e] = kNegInf2;
        }
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
    const float al0 = exp2f(m0 - mx0), al1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      s[j][0] = exp2f(s[j][0] - mx0);
      s[j][1] = exp2f(s[j][1] - mx0);
      s[j][2] = exp2f(s[j][2] - mx1);
      s[j][3] = exp2f(s[j][3] - mx1);
      ps0 += s[j][0] + s[j][1];
      ps1 += s[j][2] + s[j][3];
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int j = 0; j < DB; ++j) {
      o[j][0] *= al0;
      o[j][1] *= al0;
      o[j][2] *= al1;
      o[j][3] *= al1;
    }

    // O += P . V, P rounded to the 16-bit type in the A fragment
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {
          Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]),
          Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]),
          Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int p = 0; p < D / 16; ++p) {
        uint32_t b[4];
        ldsm_x4_t(b, bt_addr<D>(vs, kk * 16, 2 * p, lane));
        Mma<T>::run(o[2 * p], pa, b[0], b[1]);
        Mma<T>::run(o[2 * p + 1], pa, b[2], b[3]);
      }
    }
  }

  cp_async_wait_all();
  __syncthreads();
  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);
  if (a.splits > 1) {
    // partials: this split's (m, l) and acc of the rows below s
    const int64_t rows = part_rows(a);
    const int64_t r0 = (int64_t)split * rows + (int64_t)bh * a.s;
    float* acc = a.part + 2 * a.splits * rows;
#pragma unroll
    for (int j = 0; j < DB; ++j) {
      const int e = j * 8 + (lane & 3) * 2;
      if (row0 < a.s)
        *reinterpret_cast<float2*>(acc + (r0 + row0) * D + e) =
            make_float2(o[j][0], o[j][1]);
      if (row0 + 8 < a.s)
        *reinterpret_cast<float2*>(acc + (r0 + row0 + 8) * D + e) =
            make_float2(o[j][2], o[j][3]);
    }
    if ((lane & 3) == 0) {
      if (row0 < a.s) {
        a.part[(r0 + row0) * 2] = m0;
        a.part[(r0 + row0) * 2 + 1] = l0;
      }
      if (row0 + 8 < a.s) {
        a.part[(r0 + row0 + 8) * 2] = m1;
        a.part[(r0 + row0 + 8) * 2 + 1] = l1;
      }
    }
    return;
  }
  // one split: o / l through the warp's own rows of q_s, 16-byte stores
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const int r_lo = warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < DB; ++j) {
    const int e = (lane & 3) * 2;
    *reinterpret_cast<uint32_t*>(q_s + swz<D>(r_lo, j) + e) =
        Mma<T>::pack(o[j][0] / d0, o[j][1] / d0);
    *reinterpret_cast<uint32_t*>(q_s + swz<D>(r_lo + 8, j) + e) =
        Mma<T>::pack(o[j][2] / d1, o[j][3] / d1);
  }
  __syncwarp();
  T* out = static_cast<T*>(a.out) + (int64_t)bh * a.s * D;
  for (int u = lane; u < 16 * DB; u += 32) {
    const int r = warp * 16 + u / DB, c = u % DB;
    if (q0 + r < a.s)
      *reinterpret_cast<uint4*>(out + (int64_t)(q0 + r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(q_s + swz<D>(r, c));
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

enum Path { kScalar = 0, kSplit = 1, kMma = 2 };

int last_error() { return (int)cudaGetLastError(); }

template <typename TQ, typename TC, int TPR, int ROWS, int DMAX>
int launch_shape(const Args& a, cudaStream_t stream) {
  auto kernel = decode_attn_kernel<TQ, TC, TPR, ROWS, DMAX>;
  const int ds = a.d + 1;
  const size_t smem =
      sizeof(float) * (ROWS * ds + 2 * kTileK * ds + ROWS * kTileK);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((a.s + ROWS - 1) / ROWS, a.h, a.b);
  kernel<<<grid, TPR * ROWS, smem, stream>>>(a);
  return last_error();
}

template <typename TQ, typename TC>
int launch_scalar(const Args& a, cudaStream_t stream) {
  // one row per warp-sized block for single-token decode; 16 rows of 8
  // threads for a chunk, so a prefill tile reads each K/V tile once
  if (a.s == 1) {
    if (a.d <= 64) return launch_shape<TQ, TC, 32, 1, 64>(a, stream);
    return launch_shape<TQ, TC, 32, 1, kMaxD>(a, stream);
  }
  if (a.d <= 64) return launch_shape<TQ, TC, 8, 16, 64>(a, stream);
  return launch_shape<TQ, TC, 8, 16, kMaxD>(a, stream);
}

template <typename TQ, typename TC>
int launch_split(const Args& a, cudaStream_t st) {
  const int chunks = a.d * (int)sizeof(TC) / 16;   // 16-byte chunks a row
  const int blocks = a.b * a.h * a.splits;
  if (chunks <= 4)
    decode_split_kernel<TQ, TC, 4, 1><<<blocks, 128, 0, st>>>(a);
  else if (chunks <= 8)
    decode_split_kernel<TQ, TC, 8, 1><<<blocks, 128, 0, st>>>(a);
  else if (chunks <= 16)
    decode_split_kernel<TQ, TC, 16, 1><<<blocks, 128, 0, st>>>(a);
  else if (chunks <= 32)
    decode_split_kernel<TQ, TC, 32, 1><<<blocks, 128, 0, st>>>(a);
  else
    decode_split_kernel<TQ, TC, 32, 2><<<blocks, 128, 0, st>>>(a);
  return last_error();
}

template <typename T, int D>
int launch_mma(const Args& a, cudaStream_t st) {
  auto kernel = decode_mma_kernel<T, D>;
  const size_t smem = (size_t)(64 + 2 * kStages * kTile) * D * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.s + 63) / 64 * a.b * a.h * a.splits;
  kernel<<<blocks, 128, smem, st>>>(a);
  return last_error();
}

template <typename TQ>
int launch_combine(const Args& a, cudaStream_t st) {
  const int64_t rows = part_rows(a);
  decode_combine_kernel<TQ><<<(unsigned)((rows + 3) / 4), 128, 0, st>>>(a);
  return last_error();
}

template <typename TQ, typename TC>
int launch_typed(const Args& a, int path, cudaStream_t st) {
  int err;
  if (path == kScalar) return launch_scalar<TQ, TC>(a, st);
  if (path == kSplit) {
    err = launch_split<TQ, TC>(a, st);
  } else if constexpr (std::is_same<TQ, TC>::value && sizeof(TC) == 2) {
    if (a.d == 64) err = launch_mma<TC, 64>(a, st);
    else err = launch_mma<TC, 128>(a, st);
  } else {
    return (int)cudaErrorInvalidValue;   // path_ok admits no such call
  }
  if (err != 0 || a.splits == 1) return err;
  return launch_combine<TQ>(a, st);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// dtype codes of the C entries: 0 f32, 1 bf16, 2 f16
enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2 };

// is the path legal for these arguments? (the wrapper chooses it)
bool path_ok(const Args& a, int path, int q_dt, int cache_dt) {
  if (path == kScalar) return a.splits == 1;
  const int cols = capacity(a);
  if (a.splits < 1 || a.span < kTile || a.span % kTile != 0 ||
      (int64_t)a.splits * a.span < cols ||
      (int64_t)(a.splits - 1) * a.span >= cols ||
      (a.splits > 1 && a.part == nullptr) || !aligned16(a.k) ||
      !aligned16(a.v))
    return false;
  const int el = cache_dt == kF32 ? 4 : 2;
  if (path == kSplit) return a.s == 1 && (a.d * el) % 16 == 0;
  return path == kMma && q_dt == cache_dt && cache_dt != kF32 &&
         (a.d == 64 || a.d == 128) && aligned16(a.q) && aligned16(a.out);
}

template <typename TQ>
int launch_cache(Args& a, int cache_dt, int path, cudaStream_t st) {
  if (cache_dt == kBF16) return launch_typed<TQ, bf16>(a, path, st);
  if (cache_dt == kF16) return launch_typed<TQ, f16>(a, path, st);
  return launch_typed<TQ, float>(a, path, st);
}

int launch(Args& a, int q_dt, int cache_dt, int path, void* stream) {
  if (a.d < 1 || a.d > kMaxD || a.s < 1 || a.b < 1 || a.h < 1 ||
      a.len < 1 || q_dt < kF32 || q_dt > kF16 || cache_dt < kF32 ||
      cache_dt > kF16 || !path_ok(a, path, q_dt, cache_dt))
    return (int)cudaErrorInvalidValue;
  set_fast_div(a);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dt == kBF16) return launch_cache<bf16>(a, cache_dt, path, st);
  if (q_dt == kF16) return launch_cache<f16>(a, cache_dt, path, st);
  return launch_cache<float>(a, cache_dt, path, st);
}

}  // namespace

extern "C" {

// Contiguous cache [b, h, L, d]. q_dtype / cache_dtype: 0 f32, 1 bf16,
// 2 f16. path: 0 scalar, 1 split-K decode (s = 1), 2 mma chunk; splits x
// span columns cover [0, L); part: f32 scratch of
// splits * b * h * s * (d + 2) when splits > 1. Returns the cudaError_t of
// the launches.
int decode_attention_contiguous(const void* q, const void* k, const void* v,
                                void* out, const int* fills,
                                int fill_scalar, int b, int h, int s, int d,
                                int L, float scale, int q_dtype,
                                int cache_dtype, int path, int splits,
                                int span, float* part, void* stream) {
  Args a{q, k, v, out, fills, fill_scalar, nullptr, b, h, s, d, L, 0,
         scale, splits, span, part, 0, 0};
  return launch(a, q_dtype, cache_dtype, path, stream);
}

// Paged arena [n_blocks + 1, h, bs, d] through block tables [b, nb]; the
// rest as above, over the nb * bs logical columns. Returns the cudaError_t
// of the launches.
int decode_attention_paged(const void* q, const void* k, const void* v,
                           void* out, const int* fills,
                           const int* block_tables, int b, int h, int s,
                           int d, int bs, int nb, float scale, int q_dtype,
                           int cache_dtype, int path, int splits, int span,
                           float* part, void* stream) {
  if (block_tables == nullptr || nb < 1) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, out, fills, 0, block_tables, b, h, s, d, bs, nb, scale,
         splits, span, part, 0, 0};
  return launch(a, q_dtype, cache_dtype, path, stream);
}

}  // extern "C"
