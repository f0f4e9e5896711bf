// Decode attention over a KV cache, for Hopper (sm_90a).
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
// What bounds it: device-memory bytes of the LIVE K/V columns. A decode
// step (s = 1) does 4 * live * d flops for 2 * live * d * sizeof(T)
// bytes, far below the card's flop/byte balance. So the design reads
// only live columns, reads each once per query tile, and does the math
// in f32 registers:
//   * one CUDA block per (query tile, head, batch row) loops over KV
//     tiles itself (the TPU kernel's sequential grid axis becomes this
//     loop); it stops at the last live tile of its LAST row, so dead
//     cache columns and unallocated blocks are never read;
//   * paged addressing: each block reads its own block-table entries;
//     logical column c lives at arena row block_tables[i, c / bs],
//     offset c % bs. The KV tile order over logical columns is the same
//     as the contiguous path, so both give bitwise the same result on
//     the same K/V values;
//   * the K/V tile sits in shared memory as f32 (row stride d + 1 to
//     keep banks apart); the running max, sum and accumulator stay in f32
//     registers (online softmax);
//   * any chunk length s: the grid tiles s, so a 1024-row prefill runs
//     here as well as a 1-row decode step.
// Plain scalar FMAs: a first kernel that is right. Split-K over the cache
// (flash-decoding), mma/wgmma and TMA loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileK = 32;           // KV columns per shared-memory tile
constexpr float kNegInf = -1e9f;     // finite mask fill, as the reference
constexpr int kMaxD = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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
};

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
  const int fill = a.fills != nullptr ? a.fills[ib] : a.fill_scalar;
  const bool paged = a.block_tables != nullptr;
  const int cols = paged ? a.nb * a.len : a.len;    // logical columns
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
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
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
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
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
  return (int)cudaGetLastError();
}

template <typename TQ, typename TC>
int launch_typed(const Args& a, cudaStream_t stream) {
  // one row per warp-sized block for single-token decode; 16 rows of 8
  // threads for a chunk, so a prefill tile reads each K/V tile once
  if (a.s == 1) {
    if (a.d <= 64) return launch_shape<TQ, TC, 32, 1, 64>(a, stream);
    return launch_shape<TQ, TC, 32, 1, kMaxD>(a, stream);
  }
  if (a.d <= 64) return launch_shape<TQ, TC, 8, 16, 64>(a, stream);
  return launch_shape<TQ, TC, 8, 16, kMaxD>(a, stream);
}

int launch(const Args& a, int q_bf16, int cache_bf16, void* stream) {
  if (a.d < 1 || a.d > kMaxD || a.s < 1 || a.b < 1 || a.h < 1 ||
      a.len < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16 && cache_bf16)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(a, st);
  if (q_bf16) return launch_typed<__nv_bfloat16, float>(a, st);
  if (cache_bf16) return launch_typed<float, __nv_bfloat16>(a, st);
  return launch_typed<float, float>(a, st);
}

}  // namespace

extern "C" {

// Contiguous cache [b, h, L, d]. Returns the cudaError_t of the launch.
int decode_attention_contiguous(const void* q, const void* k, const void* v,
                                void* out, const int* fills,
                                int fill_scalar, int b, int h, int s, int d,
                                int L, float scale, int q_bf16,
                                int cache_bf16, void* stream) {
  Args a{q, k, v, out, fills, fill_scalar, nullptr, b, h, s, d, L, 0,
         scale};
  return launch(a, q_bf16, cache_bf16, stream);
}

// Paged arena [n_blocks + 1, h, bs, d] through block tables [b, nb].
// Returns the cudaError_t of the launch.
int decode_attention_paged(const void* q, const void* k, const void* v,
                           void* out, const int* fills,
                           const int* block_tables, int b, int h, int s,
                           int d, int bs, int nb, float scale, int q_bf16,
                           int cache_bf16, void* stream) {
  if (block_tables == nullptr || nb < 1) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, out, fills, 0, block_tables, b, h, s, d, bs, nb, scale};
  return launch(a, q_bf16, cache_bf16, stream);
}

}  // extern "C"
