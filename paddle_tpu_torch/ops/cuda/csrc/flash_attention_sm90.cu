// Flash attention for Hopper (sm_90a), bf16 or f16 at head dim 64 or 128:
// the forward and both backward kernels with register-resident tiles.
//
// Replaces, on their bf16 / f16 d 64 / d 128 path, the three TPU Pallas
// kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   _flash_fwd_kernel      (:103) -> flash_fwd_sm90_kernel
//   _flash_bwd_dq_kernel   (:234) -> flash_bwd_dq_sm90_kernel
//   _flash_bwd_dkv_kernel  (:272) -> flash_bwd_dkv_sm90_kernel
// f32, other head dims and unaligned inputs keep the kernels of
// flash_attention.cu.
//
// Contract (as flash_attention.cu): for q [BH, Sq, D], k and v [BH, Sk, D]
// in T (bf16 or f16; every kernel is a template on it, and only the mma's
// type string and the rounding of f32 values to T differ), an optional f32
// key bias [B, Sk] (head bh reads row bh / H):
//   s = (q . k^T) * scale (f32) + bias[col]; causal: NEG_INF (-1e9, finite)
//       where col > row + (Sk - Sq)
//   fwd  running max m from NEG_INF, P = exp(s - m) rounded to T for
//        P . V, o = acc / max(l, 1e-30) in T, lse = m + log(max(l,
//        1e-30)) in f32 (natural log)
//   bwd  p = exp(s - lse), dp = dO . V^T, ds = p * (dp - delta) * scale;
//        dq = ds . K and dk = ds^T . Q (ds rounded to T), dv = p^T . dO
//        (p rounded to T)
// Every product accumulates in f32. Keys at and past Sk take no part, rows
// at and past Sq write nothing and add nothing: ragged lengths are masked
// here, with no padded copy. Each output element has one writer and a fixed
// order of sums (no atomics), so results are bitwise repeatable.
//
// What bounds it: operations. At GPT-2 small's long-sequence shape (BH 12,
// S 4096, D 64, causal) the live (row, key) pairs take 25.8 GFLOP in the
// forward (two products), 38.7 GFLOP in dq (three) and 51.6 GFLOP in dk/dv
// (four): 26, 39 and 52 us at the H100 SXM's 989 TFLOP/s dense bf16; the
// bytes (q, k, v, o, dO, dq, dk, dv once) take under 20 us at 3.35 TB/s. So
// the design keeps every intermediate on chip and the tensor cores fed:
//   * scores, P, dP, dS and the O / dq / dk / dv accumulators stay in
//     registers as mma.sync m16n8k16 fragments (T in, f32 accumulate). A
//     score fragment is scaled, biased and masked where it lies (each thread
//     knows its (row, col) from the fragment layout), rounded to T and
//     reused as the A operand of the next product: no trip through shared
//     memory. The online softmax's row max and sum are quad shuffles, with
//     log2(e) folded into the scale (exp2f);
//   * one warp owns 16 rows (forward and dq: queries; dk/dv: keys). The
//     forward and dq blocks have BM / 16 warps over a BM-row query tile and
//     walk 64-key tiles (dq reads its Q and dO fragments from shared memory
//     per tile: 166 registers at d 64, three blocks an SM); dk/dv's block
//     has BN / 16 warps over BN keys (K and V resident in shared memory)
//     and walks query tiles from the first live one. dq and dk/dv stay two
//     kernels, so neither needs atomics;
//   * the walked tiles (K and V; Q, dO, lse and delta) come through a
//     two-stage cp.async ring (16-byte copies, zero-fill past the end): the
//     copy of tile j + 1 is in flight while tile j computes, with one
//     barrier per tile. Tiles are XOR-swizzled by 16-byte chunk, so the
//     ldmatrix / ldmatrix.trans reads that make the fragments are free of
//     bank conflicts;
//   * the causal mask is applied only on tiles that cross the diagonal and
//     dead tiles are skipped; the forward and dq launch their longest query
//     tiles first (dk/dv: the key tiles that see the most queries), so the
//     last wave is short tiles;
//   * shared memory: the forward 40 KB (d 64, BM 64: three blocks of 4
//     warps per SM, by registers); dq 48 KB at d 64 (Q and dO tiles, a
//     two-stage K / V ring; three blocks per SM); dk/dv 66.5 KB at d 64 and
//     128 keys (8 warps, which load each Q / dO tile once for 128 keys; 64
//     keys, 49 KB and two blocks of 4 warps per SM, was slower). The tile
//     sizes are fixed below (kFwdRows, kDqRows, kDkvKeys).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr float kNegInf = -1e9f;          // finite mask fill, as the reference
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf2 = kNegInf * kLog2e;   // the fill in log2 units

// T: the 16-bit element type of q, k, v, dO and the outputs (bf16 or f16)
template <typename T>
struct Args {
  const T* q;           // [BH, Sq, D]
  const T* k;           // [BH, Sk, D]
  const T* v;           // [BH, Sk, D]
  const float* bias;    // [B, Sk] or null
  const T* dout;        // [BH, Sq, D] (backward)
  float* lse;           // [BH, Sq]: written forward, read backward
  const float* delta;   // [BH, Sq] rowsum(dO * O) (backward)
  T* out;               // forward: o; dk/dv: dk
  T* out2;              // dk/dv: dv
  int BH, H, Sq, Sk;
  float scale;
  int causal;
};

// ---------------------------------------------------------------------------
// PTX: cp.async, ldmatrix, mma.sync
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

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
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

// d += a . b: a 16x16 T (row), b 16x8 T (col), d 16x8 f32
template <typename T>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same_v<T, f16>)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to T, lo in the low half (the fragments' k order)
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

// ---------------------------------------------------------------------------
// swizzled tiles: [rows][D] T, the 16-byte chunk c of row r stored at
// chunk c ^ (r & 7), so the 8 rows one ldmatrix matrix reads hit 8
// different chunks (all 32 banks)
// ---------------------------------------------------------------------------

template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
}

// rows r0 .. r0+R of a [S, D] matrix into a swizzled tile (zeros past S)
template <int R, int D, int NT, typename T>
__device__ __forceinline__ void tile_async(T* dst, const T* src, int r0,
                                           int S) {
  constexpr int CPR = D / 8;
  static_assert(R * CPR % NT == 0, "tile split");
#pragma unroll
  for (int i = 0; i < R * CPR / NT; ++i) {
    const int u = threadIdx.x + i * NT;
    const int r = u / CPR, c = u % CPR;
    const bool ok = r0 + r < S;
    cp_async16(smem_addr(dst + swz<D>(r, c)),
               ok ? src + (int64_t)(r0 + r) * D + c * 8 : src, ok);
  }
}

// R f32 values src[r0 ..] into dst (zeros past S)
template <int R, int NT>
__device__ __forceinline__ void rows_async(float* dst, const float* src,
                                           int r0, int S) {
  for (int u = threadIdx.x; u < R; u += NT) {
    const bool ok = r0 + u < S;
    cp_async4(smem_addr(dst + u), ok ? src + r0 + u : src, ok);
  }
}

// ldmatrix.x4 addresses of one lane. A operand: the 16 x 16 block at rows
// r0, k-chunks kc, kc + 1 of a [rows][k] tile (regs a0..a3).
template <int D, typename T>
__device__ __forceinline__ uint32_t a_addr(const T* t, int r0, int kc,
                                           int lane) {
  return smem_addr(t + swz<D>(r0 + (lane & 15), kc + (lane >> 4)));
}

// B operands of two n8 blocks (n0, n0 + 8) over k-chunks kc, kc + 1 from a
// [n][k] tile (regs: b0, b1 of n0, then b0, b1 of n0 + 8)
template <int D, typename T>
__device__ __forceinline__ uint32_t bn_addr(const T* t, int n0, int kc,
                                            int lane) {
  const int m = lane >> 3;
  return smem_addr(t + swz<D>(n0 + ((m >> 1) << 3) + (lane & 7), kc + (m & 1)));
}

// the same from a [k][n] tile through ldmatrix.trans: k rows k0 .. k0+16,
// n-chunks nc, nc + 1
template <int D, typename T>
__device__ __forceinline__ uint32_t bt_addr(const T* t, int k0, int nc,
                                            int lane) {
  const int m = lane >> 3;
  return smem_addr(t + swz<D>(k0 + ((m & 1) << 3) + (lane & 7), nc + (m >> 1)));
}

// A warp's 16 x D f32 accumulator fragments, rows divided by d0 (the
// lane's first row) and d1 (its row + 8), rounded to T and stored to
// rows g0 + 16 warp .. of out [S, D] (none at and past S) through the
// warp's own 16 rows of the swizzled tile t, in 16-byte stores
template <int D, typename T>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4],
                                           float d0, float d1, T* t,
                                           T* out, int g0, int S,
                                           int warp, int lane) {
  constexpr int DB = D / 8;
  const int r_lo = warp * 16 + (lane >> 2), e = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < DB; ++j) {
    *reinterpret_cast<uint32_t*>(t + swz<D>(r_lo, j) + e) =
        pack<T>(acc[j][0] / d0, acc[j][1] / d0);
    *reinterpret_cast<uint32_t*>(t + swz<D>(r_lo + 8, j) + e) =
        pack<T>(acc[j][2] / d1, acc[j][3] / d1);
  }
  __syncwarp();
  for (int u = lane; u < 16 * DB; u += 32) {
    const int r = warp * 16 + u / DB, c = u % DB;
    if (g0 + r < S)
      *reinterpret_cast<uint4*>(out + (int64_t)(g0 + r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(t + swz<D>(r, c));
  }
}

// key tiles [0, end) a query tile q0 .. q0+bm must visit (causal: up to the
// last one holding a column <= its last real row + Sk - Sq)
template <typename A>
__device__ __forceinline__ int fwd_key_tiles(const A& a, int q0, int bm,
                                             int bn) {
  const int n = (a.Sk + bn - 1) / bn;
  if (!a.causal) return n;
  const int last = min(q0 + bm, a.Sq) - 1 + (a.Sk - a.Sq);
  return last < 0 ? 0 : min(n, last / bn + 1);
}

// ---------------------------------------------------------------------------
// forward: one warp per 16 query rows, BM / 16 warps, 64-key tiles
// ---------------------------------------------------------------------------

template <typename T, int D, int BM, int BN>
__global__ void __launch_bounds__(BM * 2)
    flash_fwd_sm90_kernel(const Args<T> a) {
  constexpr int NT = BM * 2;
  constexpr int KD = D / 16, NB = BN / 8, DB = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);   // [BM][D]
  T* k_s = q_s + BM * D;                    // 2 x [BN][D]
  T* v_s = k_s + 2 * BN * D;                // 2 x [BN][D]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_qt = (a.Sq + BM - 1) / BM;
  const int bh = blockIdx.x % a.BH;
  const int q0 = (n_qt - 1 - (int)blockIdx.x / a.BH) * BM;  // longest first
  const T* q = a.q + (int64_t)bh * a.Sq * D;
  const T* k = a.k + (int64_t)bh * a.Sk * D;
  const T* v = a.v + (int64_t)bh * a.Sk * D;
  const float* bias =
      a.bias != nullptr ? a.bias + (int64_t)(bh / a.H) * a.Sk : nullptr;
  const int off = a.Sk - a.Sq;
  const int kt_end = fwd_key_tiles(a, q0, BM, BN);

  tile_async<BM, D, NT>(q_s, q, q0, a.Sq);
  if (kt_end > 0) {
    tile_async<BN, D, NT>(k_s, k, 0, a.Sk);
    tile_async<BN, D, NT>(v_s, v, 0, a.Sk);
  }
  cp_async_commit();

  const int wrow = q0 + warp * 16;             // the warp's first row
  const int row0 = wrow + (lane >> 2);         // this lane's rows: row0, +8
  const float sl = a.scale * kLog2e;
  uint32_t qf[KD][4];
  float o[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = kNegInf2, m1 = kNegInf2;          // running max (log2 units)
  float l0 = 0.f, l1 = 0.f;                    // this lane's part of the sum

  for (int kt = 0; kt < kt_end; ++kt) {
    cp_async_wait_all();
    __syncthreads();   // tile kt landed; every warp is done with kt - 1
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(qf[kk], a_addr<D>(q_s, warp * 16, 2 * kk, lane));
    }
    if (kt + 1 < kt_end) {
      const int st = (kt + 1) & 1;
      tile_async<BN, D, NT>(k_s + st * BN * D, k, (kt + 1) * BN, a.Sk);
      tile_async<BN, D, NT>(v_s + st * BN * D, v, (kt + 1) * BN, a.Sk);
    }
    cp_async_commit();
    const T* ks = k_s + (kt & 1) * BN * D;
    const T* vs = v_s + (kt & 1) * BN * D;

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
        mma<T>(s[2 * p], qf[kk], b[0], b[1]);
        mma<T>(s[2 * p + 1], qf[kk], b[2], b[3]);
      }
    }

    // scale, bias and mask in log2 units; the row max
    const int k0 = kt * BN;
    const bool edge =
        k0 + BN > a.Sk || (a.causal && k0 + BN - 1 > wrow + off);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int col = k0 + j * 8 + (lane & 3) * 2;
      float b0 = 0.f, b1 = 0.f;
      if (bias != nullptr) {
        if (col < a.Sk) b0 = __ldg(bias + col) * kLog2e;
        if (col + 1 < a.Sk) b1 = __ldg(bias + col + 1) * kLog2e;
      }
      s[j][0] = fmaf(s[j][0], sl, b0);
      s[j][1] = fmaf(s[j][1], sl, b1);
      s[j][2] = fmaf(s[j][2], sl, b0);
      s[j][3] = fmaf(s[j][3], sl, b1);
      if (edge) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = col + (e & 1), r = row0 + (e >> 1) * 8;
          if (c >= a.Sk)
            s[j][e] = -CUDART_INF_F;              // no key: p = 0
          else if (a.causal && c > r + off)
            s[j][e] = kNegInf2;
        }
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
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

    // O += P . V, P rounded to T in the A fragment
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {pack<T>(s[2 * kk][0], s[2 * kk][1]),
                              pack<T>(s[2 * kk][2], s[2 * kk][3]),
                              pack<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int p = 0; p < D / 16; ++p) {
        uint32_t b[4];
        ldsm_x4_t(b, bt_addr<D>(vs, kk * 16, 2 * p, lane));
        mma<T>(o[2 * p], pa, b[0], b[1]);
        mma<T>(o[2 * p + 1], pa, b[2], b[3]);
      }
    }
  }

  // epilogue: o / l through the warp's own rows of q_s, 16-byte stores
  cp_async_wait_all();
  __syncthreads();
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  store_rows<D>(o, d0, d1, q_s, a.out + (int64_t)bh * a.Sq * D, q0, a.Sq,
                warp, lane);
  if ((lane & 3) == 0) {
    float* lse = a.lse + (int64_t)bh * a.Sq;
    if (row0 < a.Sq) lse[row0] = m0 * kLn2 + logf(d0);
    if (row0 + 8 < a.Sq) lse[row0 + 8] = m1 * kLn2 + logf(d1);
  }
}

// ---------------------------------------------------------------------------
// dq: the forward's shape. One warp per 16 query rows, BM / 16 warps, BN-key
// tiles; dq = ds . K with ds rounded to T in the A fragment
// ---------------------------------------------------------------------------

template <typename T, int D, int BM, int BN>
__global__ void __launch_bounds__(BM * 2)
    flash_bwd_dq_sm90_kernel(const Args<T> a) {
  constexpr int NT = BM * 2;
  constexpr int KD = D / 16, NB = BN / 8, DB = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);   // [BM][D]
  T* do_s = q_s + BM * D;                   // [BM][D]
  T* k_s = do_s + BM * D;                   // 2 x [BN][D]
  T* v_s = k_s + 2 * BN * D;                // 2 x [BN][D]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_qt = (a.Sq + BM - 1) / BM;
  const int bh = blockIdx.x % a.BH;
  const int q0 = (n_qt - 1 - (int)blockIdx.x / a.BH) * BM;  // longest first
  const int64_t qoff = (int64_t)bh * a.Sq;
  const T* k = a.k + (int64_t)bh * a.Sk * D;
  const T* v = a.v + (int64_t)bh * a.Sk * D;
  const float* bias =
      a.bias != nullptr ? a.bias + (int64_t)(bh / a.H) * a.Sk : nullptr;
  const int off = a.Sk - a.Sq;
  const int kt_end = fwd_key_tiles(a, q0, BM, BN);

  tile_async<BM, D, NT>(q_s, a.q + qoff * D, q0, a.Sq);
  tile_async<BM, D, NT>(do_s, a.dout + qoff * D, q0, a.Sq);
  if (kt_end > 0) {
    tile_async<BN, D, NT>(k_s, k, 0, a.Sk);
    tile_async<BN, D, NT>(v_s, v, 0, a.Sk);
  }
  cp_async_commit();

  const int wrow = q0 + warp * 16;             // the warp's first row
  const int row0 = wrow + (lane >> 2);         // this lane's rows: row0, +8
  const float sl = a.scale * kLog2e;
  float lse2[2], dl[2];                        // lse in log2 units, delta
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row0 + 8 * hf;
    lse2[hf] = r < a.Sq ? a.lse[qoff + r] * kLog2e : 0.f;
    dl[hf] = r < a.Sq ? a.delta[qoff + r] : 0.f;
  }
  float dq[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int kt = 0; kt < kt_end; ++kt) {
    cp_async_wait_all();
    __syncthreads();   // tile kt landed; every warp is done with kt - 1
    if (kt + 1 < kt_end) {
      const int st = (kt + 1) & 1;
      tile_async<BN, D, NT>(k_s + st * BN * D, k, (kt + 1) * BN, a.Sk);
      tile_async<BN, D, NT>(v_s + st * BN * D, v, (kt + 1) * BN, a.Sk);
    }
    cp_async_commit();
    const T* ks = k_s + (kt & 1) * BN * D;
    const T* vs = v_s + (kt & 1) * BN * D;

    // S = Q . K^T and dP = dO . V^T; the Q and dO fragments are read from
    // shared memory per tile (held in registers for the whole walk they
    // took the d 64 kernel from 166 to 217 registers, 3 blocks an SM to 2,
    // and were slower on the H100)
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], da[4];
      ldsm_x4(qa, a_addr<D>(q_s, warp * 16, 2 * kk, lane));
      ldsm_x4(da, a_addr<D>(do_s, warp * 16, 2 * kk, lane));
#pragma unroll
      for (int p = 0; p < NB / 2; ++p) {
        uint32_t b[4];
        ldsm_x4(b, bn_addr<D>(ks, p * 16, 2 * kk, lane));
        mma<T>(s[2 * p], qa, b[0], b[1]);
        mma<T>(s[2 * p + 1], qa, b[2], b[3]);
        ldsm_x4(b, bn_addr<D>(vs, p * 16, 2 * kk, lane));
        mma<T>(dp[2 * p], da, b[0], b[1]);
        mma<T>(dp[2 * p + 1], da, b[2], b[3]);
      }
    }

    // P = exp(s - lse), dS = P (dP - delta) scale, on the fragments (dp
    // holds dS after this); masked and missing keys give P = 0
    const int k0 = kt * BN;
    const bool edge =
        k0 + BN > a.Sk || (a.causal && k0 + BN - 1 > wrow + off);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int col = k0 + j * 8 + (lane & 3) * 2;
      float b0 = 0.f, b1 = 0.f;
      if (bias != nullptr) {
        if (col < a.Sk) b0 = __ldg(bias + col) * kLog2e;
        if (col + 1 < a.Sk) b1 = __ldg(bias + col + 1) * kLog2e;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[j][e], sl, (e & 1) ? b1 : b0) - lse2[e >> 1]);
        if (edge) {
          const int c = col + (e & 1), r = row0 + (e >> 1) * 8;
          if (c >= a.Sk || (a.causal && c > r + off)) p = 0.f;
        }
        dp[j][e] = p * (dp[j][e] - dl[e >> 1]) * a.scale;
      }
    }

    // dq += dS . K, dS rounded to T in the A fragment, K through
    // ldmatrix.trans as the forward reads V
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t da[4] = {pack<T>(dp[2 * kk][0], dp[2 * kk][1]),
                              pack<T>(dp[2 * kk][2], dp[2 * kk][3]),
                              pack<T>(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack<T>(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int p = 0; p < D / 16; ++p) {
        uint32_t b[4];
        ldsm_x4_t(b, bt_addr<D>(ks, kk * 16, 2 * p, lane));
        mma<T>(dq[2 * p], da, b[0], b[1]);
        mma<T>(dq[2 * p + 1], da, b[2], b[3]);
      }
    }
  }

  // epilogue: dq through the warp's own rows of q_s
  cp_async_wait_all();
  __syncthreads();
  store_rows<D>(dq, 1.f, 1.f, q_s, a.out + qoff * D, q0, a.Sq, warp, lane);
}

// ---------------------------------------------------------------------------
// dk/dv: one warp per 16 keys, BN / 16 warps, BQ-query tiles
// ---------------------------------------------------------------------------

template <typename T, int D, int BN, int BQ>
__global__ void __launch_bounds__(BN * 2)
    flash_bwd_dkv_sm90_kernel(const Args<T> a) {
  constexpr int NT = BN * 2;
  constexpr int KD = D / 16, NQ = BQ / 8, DB = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);   // [BN][D]
  T* v_s = k_s + BN * D;                    // [BN][D]
  T* q_s = v_s + BN * D;                    // 2 x [BQ][D]
  T* do_s = q_s + 2 * BQ * D;               // 2 x [BQ][D]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * BQ * D);   // 2 x [BQ]
  float* dl_s = lse_s + 2 * BQ;                                 // 2 x [BQ]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x % a.BH;
  const int k0 = ((int)blockIdx.x / a.BH) * BN;   // most-seen keys first
  const int off = a.Sk - a.Sq;
  const int nq = (a.Sq + BQ - 1) / BQ;
  const int qt0 = a.causal ? max(0, k0 - off) / BQ : 0;   // first live tile
  const int64_t qoff = (int64_t)bh * a.Sq;
  const T* q = a.q + qoff * D;
  const T* dout = a.dout + qoff * D;
  const float* lse = a.lse + qoff;
  const float* delta = a.delta + qoff;
  const int64_t koff = (int64_t)bh * a.Sk * D;

  auto load_queries = [&](int st, int qt) {
    tile_async<BQ, D, NT>(q_s + st * BQ * D, q, qt * BQ, a.Sq);
    tile_async<BQ, D, NT>(do_s + st * BQ * D, dout, qt * BQ, a.Sq);
    rows_async<BQ, NT>(lse_s + st * BQ, lse, qt * BQ, a.Sq);
    rows_async<BQ, NT>(dl_s + st * BQ, delta, qt * BQ, a.Sq);
  };
  tile_async<BN, D, NT>(k_s, a.k + koff, k0, a.Sk);
  tile_async<BN, D, NT>(v_s, a.v + koff, k0, a.Sk);
  if (qt0 < nq) load_queries(0, qt0);
  cp_async_commit();

  const int wkey = k0 + warp * 16;             // the warp's first key
  const int kr0 = wkey + (lane >> 2);          // this lane's keys: kr0, +8
  float bb0 = 0.f, bb1 = 0.f;                  // their bias, log2 units
  if (a.bias != nullptr) {
    const float* bias = a.bias + (int64_t)(bh / a.H) * a.Sk;
    if (kr0 < a.Sk) bb0 = __ldg(bias + kr0) * kLog2e;
    if (kr0 + 8 < a.Sk) bb1 = __ldg(bias + kr0 + 8) * kLog2e;
  }
  const float sl = a.scale * kLog2e;
  float dk[DB][4], dv[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int qt = qt0; qt < nq; ++qt) {
    const int st = (qt - qt0) & 1;
    cp_async_wait_all();
    __syncthreads();   // tile qt landed; every warp is done with qt - 1
    if (qt + 1 < nq) load_queries(st ^ 1, qt + 1);
    cp_async_commit();
    const T* qs = q_s + st * BQ * D;
    const T* dos = do_s + st * BQ * D;
    const float* ls = lse_s + st * BQ;
    const float* dls = dl_s + st * BQ;

    // S^T = K . Q^T and dP^T = V . dO^T
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, a_addr<D>(k_s, warp * 16, 2 * kk, lane));
      ldsm_x4(va, a_addr<D>(v_s, warp * 16, 2 * kk, lane));
#pragma unroll
      for (int p = 0; p < NQ / 2; ++p) {
        uint32_t b[4];
        ldsm_x4(b, bn_addr<D>(qs, p * 16, 2 * kk, lane));
        mma<T>(s[2 * p], ka, b[0], b[1]);
        mma<T>(s[2 * p + 1], ka, b[2], b[3]);
        ldsm_x4(b, bn_addr<D>(dos, p * 16, 2 * kk, lane));
        mma<T>(dp[2 * p], va, b[0], b[1]);
        mma<T>(dp[2 * p + 1], va, b[2], b[3]);
      }
    }

    // P^T = exp(s - lse), dS^T = P^T (dP^T - delta) scale, on the fragments
    const int q0 = qt * BQ;
    const bool edge =
        q0 + BQ > a.Sq || (a.causal && wkey + 15 > q0 + off);
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int cl = j * 8 + (lane & 3) * 2;   // the tile's query column
      const float2 l2 = *reinterpret_cast<const float2*>(ls + cl);
      const float2 d2 = *reinterpret_cast<const float2*>(dls + cl);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ln = (e & 1) ? l2.y : l2.x;
        const float dl = (e & 1) ? d2.y : d2.x;
        float p = exp2f(fmaf(s[j][e], sl, (e >> 1) ? bb1 : bb0) - ln * kLog2e);
        if (edge) {
          const int c = q0 + cl + (e & 1), r = kr0 + (e >> 1) * 8;
          if (c >= a.Sq || (a.causal && r > c + off)) p = 0.f;
        }
        const float dpv = dp[j][e];
        const float ds = p * (dpv - dl) * a.scale;
        s[j][e] = p;
        dp[j][e] = ds;
      }
    }

    // dv += P^T . dO, dk += dS^T . Q (A fragments rounded to T)
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t pa[4] = {pack<T>(s[2 * kk][0], s[2 * kk][1]),
                              pack<T>(s[2 * kk][2], s[2 * kk][3]),
                              pack<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint32_t da[4] = {pack<T>(dp[2 * kk][0], dp[2 * kk][1]),
                              pack<T>(dp[2 * kk][2], dp[2 * kk][3]),
                              pack<T>(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack<T>(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int p = 0; p < D / 16; ++p) {
        uint32_t b[4];
        ldsm_x4_t(b, bt_addr<D>(dos, kk * 16, 2 * p, lane));
        mma<T>(dv[2 * p], pa, b[0], b[1]);
        mma<T>(dv[2 * p + 1], pa, b[2], b[3]);
        ldsm_x4_t(b, bt_addr<D>(qs, kk * 16, 2 * p, lane));
        mma<T>(dk[2 * p], da, b[0], b[1]);
        mma<T>(dk[2 * p + 1], da, b[2], b[3]);
      }
    }
  }

  // epilogue: dk and dv through the warp's own rows of k_s / v_s
  cp_async_wait_all();
  __syncthreads();
  store_rows<D>(dk, 1.f, 1.f, k_s, a.out + koff, k0, a.Sk, warp, lane);
  store_rows<D>(dv, 1.f, 1.f, v_s, a.out2 + koff, k0, a.Sk, warp, lane);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename Kernel, typename A>
int launch(Kernel kernel, int blocks, int threads, size_t smem,
           cudaStream_t st, const A& a) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// Tile sizes, the faster of 64 and 128 each at b1 h12 s4096 d64 causal on
// the H100 (PERF.md): the forward's query rows and keys per tile, dk/dv's
// keys per block
constexpr int kFwdRows = 64;
constexpr int kFwdKeys = 64;
constexpr int kDkvKeys = 128;
// dq's query rows and keys per tile: the forward's (on the H100, 128 rows,
// 32 keys and a three-stage ring were each slower at b1 h12 s4096 d64
// causal)
constexpr int kDqRows = 64;
constexpr int kDqKeys = 64;

template <typename T, int D>
int launch_fwd(const Args<T>& a, cudaStream_t st) {
  constexpr int BM = kFwdRows;
  const size_t smem = (size_t)(BM + 4 * kFwdKeys) * D * sizeof(T);
  const int n_qt = (a.Sq + BM - 1) / BM;
  return launch(flash_fwd_sm90_kernel<T, D, BM, kFwdKeys>, n_qt * a.BH, BM * 2,
                smem, st, a);
}

template <typename T, int D>
int launch_dq(const Args<T>& a, cudaStream_t st) {
  constexpr int BM = kDqRows;
  const size_t smem = (size_t)(2 * BM + 4 * kDqKeys) * D * sizeof(T);
  const int n_qt = (a.Sq + BM - 1) / BM;
  return launch(flash_bwd_dq_sm90_kernel<T, D, BM, kDqKeys>, n_qt * a.BH,
                BM * 2, smem, st, a);
}

template <typename T, int D>
int launch_dkv(const Args<T>& a, cudaStream_t st) {
  constexpr int BN = kDkvKeys;
  constexpr int BQ = D == 64 ? 64 : 32;        // queries per tile
  const size_t smem = (size_t)(2 * BN + 4 * BQ) * D * sizeof(T) +
                      4 * BQ * sizeof(float);
  const int n_kt = (a.Sk + BN - 1) / BN;
  return launch(flash_bwd_dkv_sm90_kernel<T, D, BN, BQ>, n_kt * a.BH, BN * 2,
                smem, st, a);
}

template <typename A>
bool valid_shape(const A& a) {
  return a.BH >= 1 && a.H >= 1 && a.Sq >= 1 && a.Sk >= 1;
}

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T>
int run(int kind, const Args<T>& a, int D, cudaStream_t st) {
  if (!valid_shape(a)) return (int)cudaErrorInvalidValue;
  if (D == 64)
    return kind == kFwd  ? launch_fwd<T, 64>(a, st)
           : kind == kDq ? launch_dq<T, 64>(a, st)
                         : launch_dkv<T, 64>(a, st);
  if (D == 128)
    return kind == kFwd  ? launch_fwd<T, 128>(a, st)
           : kind == kDq ? launch_dq<T, 128>(a, st)
                         : launch_dkv<T, 128>(a, st);
  return (int)cudaErrorInvalidValue;
}

// one entry's launch for the element type of dtype code `dtype` (1 bf16,
// 2 f16; the codes of flash_attention.cu, where 0 is f32)
int dispatch(int kind, int dtype, const void* q, const void* k,
             const void* v, const float* bias, const void* dout, float* lse,
             const float* delta, void* out, void* out2, int BH, int H, int Sq,
             int Sk, int D, float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    Args<bf16> a{static_cast<const bf16*>(q),    static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v),    bias,
                 static_cast<const bf16*>(dout), lse,
                 delta,                          static_cast<bf16*>(out),
                 static_cast<bf16*>(out2),       BH, H, Sq, Sk, scale, causal};
    return run(kind, a, D, st);
  }
  if (dtype == 2) {
    Args<f16> a{static_cast<const f16*>(q),    static_cast<const f16*>(k),
                static_cast<const f16*>(v),    bias,
                static_cast<const f16*>(dout), lse,
                delta,                         static_cast<f16*>(out),
                static_cast<f16*>(out2),       BH, H, Sq, Sk, scale, causal};
    return run(kind, a, D, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The entries take a dtype code: 1 bf16, 2 f16 (q, k, v, dO and the
// outputs alike); bias, lse and delta are f32. Each returns the
// cudaError_t of its launch.

// o [BH, Sq, D] and lse [BH, Sq] f32; D in {64, 128}.
int flash_sm90_fwd(const void* q, const void* k, const void* v,
                   const float* bias, void* out, float* lse, int BH, int H,
                   int Sq, int Sk, int D, float scale, int causal, int dtype,
                   void* stream) {
  return dispatch(kFwd, dtype, q, k, v, bias, nullptr, lse, nullptr, out,
                  nullptr, BH, H, Sq, Sk, D, scale, causal, stream);
}

// dq [BH, Sq, D] from the saved lse and delta; D in {64, 128}.
int flash_sm90_bwd_dq(const void* q, const void* k, const void* v,
                      const float* bias, const void* dout, const float* lse,
                      const float* delta, void* dq, int BH, int H, int Sq,
                      int Sk, int D, float scale, int causal, int dtype,
                      void* stream) {
  return dispatch(kDq, dtype, q, k, v, bias, dout, const_cast<float*>(lse),
                  delta, dq, nullptr, BH, H, Sq, Sk, D, scale, causal,
                  stream);
}

// dk and dv [BH, Sk, D] from the saved lse and delta; D in {64, 128}.
int flash_sm90_bwd_dkv(const void* q, const void* k, const void* v,
                       const float* bias, const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int BH, int H,
                       int Sq, int Sk, int D, float scale, int causal,
                       int dtype, void* stream) {
  return dispatch(kDkv, dtype, q, k, v, bias, dout, const_cast<float*>(lse),
                  delta, dk, dv, BH, H, Sq, Sk, D, scale, causal, stream);
}

}  // extern "C"
