// Device code shared by the attention backward kernels: K3 and K4
// (flash_bwd.cu), K5 (folded_bwd.cu) and the K9 backward (short_bwd.cu).
//
// All of them compute, for q already multiplied by the logit scale,
//   P = exp(q k^T - lse),  dV = P^T dO,  dP = dO V^T,
//   dS = P * (dP - delta),  dQ = dS K,  dK = dS^T q,
// with delta = rowsum(dO * O). The rounding order is the TPU kernels': P and
// dS in f32, P rounded to dO's dtype for dV, dS to q's dtype for dQ and dK,
// f32 sums, outputs in the input dtype. Ragged query rows and keys are
// masked here (P = 0), so no padded copy is made in device memory.
//
// Tensors are read as (batch, S, heads * 64) with a batch stride and a row
// stride in elements; head h starts at column h * 64. The flash layout
// (B*H, S, 64) is heads = 1. lse and delta are f32 (batch, S, heads) with
// their own strides. Outputs are contiguous (batch, S, heads * 64).
//
// bf16: mma.sync m16n8k16 with f32 accumulation, as in the forward.
//  - dkv kernel: one block of 4 warps per (batch, head, 64-key tile); each
//    warp keeps its 16 keys' K and V as A fragments and their dK / dV sums
//    in f32 registers, and loops over 64-query tiles. It works on S^T, so
//    every product takes its A operand from registers. With kDq, the block
//    also writes its dS tile to shared memory and adds dS K into an f32 dQ
//    workspace with atomicAdd (K3, K5); the order of those additions varies
//    from run to run.
//  - dq kernel: one block of 4 warps per (batch, head, 64-query tile), each
//    warp holding its 16 rows' q and dO as A fragments and their dQ in f32
//    registers, looping over 64-key tiles (the first pass of K4 and K9; no
//    atomics). K9 computes delta in it from O (kDeltaFromO), K4 reads it.
// f32: scalar FMA on 32 x 32 tiles in shared memory, the same structure;
// a checking path, not a fast one.

#pragma once

#include "attention_common.cuh"

namespace m324 {

struct BwdArgs {
  const void* q;      // pre-scaled q
  const void* k;
  const void* v;
  const void* o;      // read only when delta is computed in the kernel
  const void* dout;
  const float* lse;
  const float* delta;  // unused when delta is computed in the kernel
  float* dq_acc;       // f32 dQ workspace summed into with atomics (kDq)
  void* dq;            // dQ written directly (dq kernel)
  void* dk;
  void* dv;
  int sq, sk, heads;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, do_bs, do_rs;
  long long l_bs, l_rs;  // lse / delta: batch and row stride, head h at +h
};

constexpr int kBwdWarps = 4;
constexpr int kBwdTile = 64;   // keys per dkv block, queries per dq block

__device__ __forceinline__ void load_frags(uint32_t f[4][4], const bf16* s,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int c = ks * 16 + 2 * t;
    f[ks][0] = ld_u32(s + g * kRow + c);
    f[ks][1] = ld_u32(s + (g + 8) * kRow + c);
    f[ks][2] = ld_u32(s + g * kRow + c + 8);
    f[ks][3] = ld_u32(s + (g + 8) * kRow + c + 8);
  }
}

// acc (16 x 64) += A (16 x 64, fragments) . X^T where X is 64 rows x 64 cols
// in shared memory: acc[r][n] = sum_d A[r][d] X[n][d].
__device__ __forceinline__ void mma_abt(float acc[8][4], const uint32_t a[4][4],
                                        const bf16* x_s, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bf16* xr = x_s + (8 * j + g) * kRow + ks * 16 + 2 * t;
      uint32_t b[2] = {ld_u32(xr), ld_u32(xr + 8)};
      mma_bf16_16816(acc[j], a[ks], b);
    }
  }
}

// acc (16 x 64) += C (16 x 64, f32 accumulator layout, rounded to bf16) . X
// where X is 64 rows x 64 cols in shared memory: acc[r][n] = sum_i C[r][i]
// X[i][n].
__device__ __forceinline__ void mma_cx(float acc[8][4], const float c[8][4],
                                       const bf16* x_s, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4] = {pack_bf16(c[2 * kk][0], c[2 * kk][1]),
                     pack_bf16(c[2 * kk][2], c[2 * kk][3]),
                     pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]),
                     pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3])};
    const bf16* xr = x_s + (16 * kk + 2 * t) * kRow;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + g;
      uint32_t b[2] = {pack_u16(xr + col, xr + kRow + col),
                       pack_u16(xr + 8 * kRow + col, xr + 9 * kRow + col)};
      mma_bf16_16816(acc[j], a, b);
    }
  }
}

// Store a 16 x 64 f32 accumulator (rows row0 + {g, g + 8} below `valid`) to
// a row-major output with row stride `rs`.
template <typename OutT>
__device__ __forceinline__ void store_tile(OutT* out, long long rs,
                                           const float acc[8][4], int row0,
                                           int valid, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (row0 + g < valid)
      WarpAttn::store2(out + (long long)(row0 + g) * rs + c, acc[j][0], acc[j][1]);
    if (row0 + g + 8 < valid)
      WarpAttn::store2(out + (long long)(row0 + g + 8) * rs + c, acc[j][2], acc[j][3]);
  }
}

// delta for `rows` rows starting at q0: rowsum(dO * O) in f32, dO from shared
// memory (bf16, row stride kRow, or f32, row stride kScalarRow), O from
// device memory. `per` threads share a row.
template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 x) { return __bfloat162float(x); }
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <typename T, int kRows, int kPer, int kStride>
__device__ __forceinline__ void delta_from_o(float* delta_s, const T* do_s,
                                             const T* ob, long long o_rs,
                                             int q0, int sq, int tid) {
  const int r = tid / kPer, part = tid % kPer;
  constexpr int kCols = kD / kPer;
  float acc = 0.f;
  if (r < kRows && q0 + r < sq) {
    const T* orow = ob + (long long)(q0 + r) * o_rs + part * kCols;
    const T* drow = do_s + r * kStride + part * kCols;
#pragma unroll 8
    for (int c = 0; c < kCols; ++c) acc = fmaf(to_f32(drow[c]), to_f32(orow[c]), acc);
  }
#pragma unroll
  for (int off = 1; off < kPer; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < kRows && part == 0) delta_s[r] = acc;
}

// ---------------------------------------------------------------- bf16
template <bool kDq, bool kDeltaFromO>
__global__ void __launch_bounds__(kBwdWarps * 32) bwd_dkv_bf16(BwdArgs p) {
  __shared__ uint4 smem_raw[5 * kBwdTile * kRow * sizeof(bf16) / 16];
  __shared__ float lse_s[kBwdTile], delta_s[kBwdTile];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + kBwdTile * kRow;
  bf16* k_s = do_s + kBwdTile * kRow;
  bf16* v_s = k_s + kBwdTile * kRow;
  bf16* ds_s = v_s + kBwdTile * kRow;   // dS as [query][key], for dQ
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = blockIdx.x * kBwdTile, h = blockIdx.y;
  const long long b = blockIdx.z;
  const int nthreads = kBwdWarps * 32;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_bs + h * kD;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_bs + h * kD;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_bs + h * kD;
  const bf16* ob = static_cast<const bf16*>(p.o) + b * p.o_bs + h * kD;
  const bf16* dob = static_cast<const bf16*>(p.dout) + b * p.do_bs + h * kD;
  const float* lb = p.lse + b * p.l_bs + h;
  const float* db = p.delta + b * p.l_bs + h;
  const long long c_out = (long long)p.heads * kD;   // output row stride

  load_rows_bf16(k_s, kb, p.k_rs, key0, kBwdTile, p.sk, 1.0f, tid, nthreads);
  load_rows_bf16(v_s, vb, p.v_rs, key0, kBwdTile, p.sk, 1.0f, tid, nthreads);
  __syncthreads();
  uint32_t kf[4][4], vf[4][4];
  load_frags(kf, k_s + warp * 16 * kRow, lane);
  load_frags(vf, v_s + warp * 16 * kRow, lane);
  const int kw = key0 + warp * 16;    // this warp's first key
  const bool key_ok0 = kw + g < p.sk, key_ok1 = kw + g + 8 < p.sk;

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int q0 = 0; q0 < p.sq; q0 += kBwdTile) {
    __syncthreads();   // the previous tile's q_s / do_s / ds_s are read
    load_rows_bf16(q_s, qb, p.q_rs, q0, kBwdTile, p.sq, 1.0f, tid, nthreads);
    load_rows_bf16(do_s, dob, p.do_rs, q0, kBwdTile, p.sq, 1.0f, tid, nthreads);
    if (tid < kBwdTile) {
      const bool ok = q0 + tid < p.sq;
      lse_s[tid] = ok ? lb[(long long)(q0 + tid) * p.l_rs] : 0.f;
      if (!kDeltaFromO) delta_s[tid] = ok ? db[(long long)(q0 + tid) * p.l_rs] : 0.f;
    }
    __syncthreads();
    if constexpr (kDeltaFromO) {
      delta_from_o<bf16, kBwdTile, 2, kRow>(delta_s, do_s, ob, p.o_rs, q0, p.sq, tid);
      __syncthreads();
    }

    // S^T (this warp's 16 keys x 64 queries) and P^T = exp(S^T - lse)
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_abt(s, kf, q_s, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qa = 8 * j + 2 * t;
      const bool q_ok0 = q0 + qa < p.sq, q_ok1 = q0 + qa + 1 < p.sq;
      const float l0 = lse_s[qa], l1 = lse_s[qa + 1];
      s[j][0] = (key_ok0 && q_ok0) ? expf(s[j][0] - l0) : 0.f;
      s[j][1] = (key_ok0 && q_ok1) ? expf(s[j][1] - l1) : 0.f;
      s[j][2] = (key_ok1 && q_ok0) ? expf(s[j][2] - l0) : 0.f;
      s[j][3] = (key_ok1 && q_ok1) ? expf(s[j][3] - l1) : 0.f;
    }
    mma_cx(dv, s, do_s, lane);              // dV += P^T dO

    float dp[8][4];                          // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    mma_abt(dp, vf, do_s, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {           // dS^T = P^T (dP^T - delta), in s
      const int qa = 8 * j + 2 * t;
      const float d0 = delta_s[qa], d1 = delta_s[qa + 1];
      s[j][0] *= dp[j][0] - d0;
      s[j][1] *= dp[j][1] - d1;
      s[j][2] *= dp[j][2] - d0;
      s[j][3] *= dp[j][3] - d1;
    }
    mma_cx(dk, s, q_s, lane);               // dK += dS^T q

    if constexpr (kDq) {
      const int kl = warp * 16 + g;         // key within the block's tile
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qa = 8 * j + 2 * t;
        ds_s[qa * kRow + kl] = __float2bfloat16_rn(s[j][0]);
        ds_s[(qa + 1) * kRow + kl] = __float2bfloat16_rn(s[j][1]);
        ds_s[qa * kRow + kl + 8] = __float2bfloat16_rn(s[j][2]);
        ds_s[(qa + 1) * kRow + kl + 8] = __float2bfloat16_rn(s[j][3]);
      }
      __syncthreads();
      // this warp's 16 queries: dQ += dS (16 x 64 keys) K (64 keys x 64)
      uint32_t af[4][4];
      load_frags(af, ds_s + warp * 16 * kRow, lane);
      float dq[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const bf16* kr = k_s + (16 * kk + 2 * t) * kRow;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + g;
          uint32_t bb[2] = {pack_u16(kr + col, kr + kRow + col),
                            pack_u16(kr + 8 * kRow + col, kr + 9 * kRow + col)};
          mma_bf16_16816(dq[j], af[kk], bb);
        }
      }
      const int r0 = q0 + warp * 16 + g;
      float* dqb = p.dq_acc + b * (long long)p.sq * c_out + h * kD;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;
        if (r0 < p.sq) {
          atomicAdd(dqb + (long long)r0 * c_out + c, dq[j][0]);
          atomicAdd(dqb + (long long)r0 * c_out + c + 1, dq[j][1]);
        }
        if (r0 + 8 < p.sq) {
          atomicAdd(dqb + (long long)(r0 + 8) * c_out + c, dq[j][2]);
          atomicAdd(dqb + (long long)(r0 + 8) * c_out + c + 1, dq[j][3]);
        }
      }
    }
  }
  const long long o_b = b * (long long)p.sk * c_out + h * kD;
  store_tile(static_cast<bf16*>(p.dk) + o_b, c_out, dk, kw, p.sk, lane);
  store_tile(static_cast<bf16*>(p.dv) + o_b, c_out, dv, kw, p.sk, lane);
}

// The dQ pass of K4 and K9: no atomics, one block per 64-query tile. With
// kDeltaFromO (K9) delta is computed here from O and dO, else read.
template <bool kDeltaFromO>
__global__ void __launch_bounds__(kBwdWarps * 32) bwd_dq_bf16(BwdArgs p) {
  __shared__ uint4 smem_raw[4 * kBwdTile * kRow * sizeof(bf16) / 16];
  __shared__ float delta_s[kBwdTile];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + kBwdTile * kRow;
  bf16* k_s = do_s + kBwdTile * kRow;
  bf16* v_s = k_s + kBwdTile * kRow;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kBwdTile, h = blockIdx.y;
  const long long b = blockIdx.z;
  const int nthreads = kBwdWarps * 32;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_bs + h * kD;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_bs + h * kD;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_bs + h * kD;
  const bf16* dob = static_cast<const bf16*>(p.dout) + b * p.do_bs + h * kD;
  const float* lb = p.lse + b * p.l_bs + h;
  const float* db = p.delta + b * p.l_bs + h;
  const long long c_out = (long long)p.heads * kD;

  load_rows_bf16(q_s, qb, p.q_rs, row0, kBwdTile, p.sq, 1.0f, tid, nthreads);
  load_rows_bf16(do_s, dob, p.do_rs, row0, kBwdTile, p.sq, 1.0f, tid, nthreads);
  __syncthreads();
  if constexpr (kDeltaFromO) {
    const bf16* ob = static_cast<const bf16*>(p.o) + b * p.o_bs + h * kD;
    delta_from_o<bf16, kBwdTile, 2, kRow>(delta_s, do_s, ob, p.o_rs, row0, p.sq, tid);
    __syncthreads();
  }
  uint32_t qf[4][4], dof[4][4];
  load_frags(qf, q_s + warp * 16 * kRow, lane);
  load_frags(dof, do_s + warp * 16 * kRow, lane);
  const int r0 = row0 + warp * 16 + g;
  const float l0 = r0 < p.sq ? lb[(long long)r0 * p.l_rs] : 0.f;
  const float l1 = r0 + 8 < p.sq ? lb[(long long)(r0 + 8) * p.l_rs] : 0.f;
  float d0, d1;
  if constexpr (kDeltaFromO) {
    d0 = delta_s[warp * 16 + g];
    d1 = delta_s[warp * 16 + g + 8];
  } else {
    d0 = r0 < p.sq ? db[(long long)r0 * p.l_rs] : 0.f;
    d1 = r0 + 8 < p.sq ? db[(long long)(r0 + 8) * p.l_rs] : 0.f;
  }

  float dq[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
  for (int kv0 = 0; kv0 < p.sk; kv0 += kBwdTile) {
    __syncthreads();
    load_rows_bf16(k_s, kb, p.k_rs, kv0, kBwdTile, p.sk, 1.0f, tid, nthreads);
    load_rows_bf16(v_s, vb, p.v_rs, kv0, kBwdTile, p.sk, 1.0f, tid, nthreads);
    __syncthreads();
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_abt(s, qf, k_s, lane);               // S = q K^T
    mma_abt(dp, dof, v_s, lane);             // dP = dO V^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = kv0 + 8 * j + 2 * t;
      const bool ok0 = key < p.sk, ok1 = key + 1 < p.sk;
      s[j][0] = ok0 ? expf(s[j][0] - l0) * (dp[j][0] - d0) : 0.f;
      s[j][1] = ok1 ? expf(s[j][1] - l0) * (dp[j][1] - d0) : 0.f;
      s[j][2] = ok0 ? expf(s[j][2] - l1) * (dp[j][2] - d1) : 0.f;
      s[j][3] = ok1 ? expf(s[j][3] - l1) * (dp[j][3] - d1) : 0.f;
    }
    mma_cx(dq, s, k_s, lane);                // dQ += dS K
  }
  store_tile(static_cast<bf16*>(p.dq) + b * (long long)p.sq * c_out + h * kD,
             c_out, dq, row0 + warp * 16, p.sq, lane);
}

// ---------------------------------------------------------------- f32
constexpr int kST = 32;                 // f32 tile: 32 queries x 32 keys
constexpr int kSP = kST + 1;            // padded row of the P / dS tiles
constexpr int kSThreads = 128;

// P and dS of a 32 x 32 tile from q, dO (rows) and K, V (columns) in shared
// memory; entries past `nq` rows or `nk` keys are 0.
__device__ __forceinline__ void tile_p_ds_f32(
    const float* q_s, const float* do_s, const float* k_s, const float* v_s,
    const float* lse_s, const float* delta_s, float* p_s, float* ds_s, int nq,
    int nk, int tid) {
#pragma unroll
  for (int i = 0; i < kST * kST / kSThreads; ++i) {
    const int idx = tid + kSThreads * i;
    const int r = idx / kST, c = idx % kST;
    float s = 0.f, dp = 0.f;
#pragma unroll 16
    for (int d = 0; d < kD; ++d) {
      s = fmaf(q_s[r * kScalarRow + d], k_s[c * kScalarRow + d], s);
      dp = fmaf(do_s[r * kScalarRow + d], v_s[c * kScalarRow + d], dp);
    }
    const float pr = (r < nq && c < nk) ? expf(s - lse_s[r]) : 0.f;
    p_s[r * kSP + c] = pr;
    ds_s[r * kSP + c] = pr * (dp - delta_s[r]);
  }
}

__device__ __forceinline__ void load_rows_f32(float* smem, const float* g,
                                              long long rs, int row0, int valid,
                                              int tid) {
  for (int idx = tid; idx < kST * kD; idx += kSThreads) {
    const int r = idx / kD, c = idx % kD;
    smem[r * kScalarRow + c] = row0 + r < valid ? g[(long long)(row0 + r) * rs + c] : 0.f;
  }
}

template <bool kDq, bool kDeltaFromO>
__global__ void __launch_bounds__(kSThreads) bwd_dkv_f32(BwdArgs p) {
  __shared__ float k_s[kST * kScalarRow], v_s[kST * kScalarRow];
  __shared__ float q_s[kST * kScalarRow], do_s[kST * kScalarRow];
  __shared__ float p_s[kST * kSP], ds_s[kST * kSP];
  __shared__ float lse_s[kST], delta_s[kST];
  const int tid = threadIdx.x;
  const int key0 = blockIdx.x * kST, h = blockIdx.y;
  const long long b = blockIdx.z;
  const float* qb = static_cast<const float*>(p.q) + b * p.q_bs + h * kD;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_bs + h * kD;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_bs + h * kD;
  const float* ob = static_cast<const float*>(p.o) + b * p.o_bs + h * kD;
  const float* dob = static_cast<const float*>(p.dout) + b * p.do_bs + h * kD;
  const float* lb = p.lse + b * p.l_bs + h;
  const float* db = p.delta + b * p.l_bs + h;
  const long long c_out = (long long)p.heads * kD;
  const int nk = min(kST, p.sk - key0);

  load_rows_f32(k_s, kb, p.k_rs, key0, p.sk, tid);
  load_rows_f32(v_s, vb, p.v_rs, key0, p.sk, tid);
  // this thread's (key, column) pairs: key = tid / 64 + 2 i, column tid % 64
  constexpr int kPairs = kST * kD / kSThreads;
  const int col = tid % kD, krow = tid / kD;
  float dk[kPairs], dv[kPairs];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) dk[i] = dv[i] = 0.f;

  for (int q0 = 0; q0 < p.sq; q0 += kST) {
    __syncthreads();
    load_rows_f32(q_s, qb, p.q_rs, q0, p.sq, tid);
    load_rows_f32(do_s, dob, p.do_rs, q0, p.sq, tid);
    if (tid < kST) {
      const bool ok = q0 + tid < p.sq;
      lse_s[tid] = ok ? lb[(long long)(q0 + tid) * p.l_rs] : 0.f;
      if (!kDeltaFromO) delta_s[tid] = ok ? db[(long long)(q0 + tid) * p.l_rs] : 0.f;
    }
    __syncthreads();
    if constexpr (kDeltaFromO) {
      delta_from_o<float, kST, 4, kScalarRow>(delta_s, do_s, ob, p.o_rs, q0, p.sq, tid);
      __syncthreads();
    }
    tile_p_ds_f32(q_s, do_s, k_s, v_s, lse_s, delta_s, p_s, ds_s,
                  min(kST, p.sq - q0), nk, tid);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int key = krow + 2 * i;
      float a = dv[i], c = dk[i];
#pragma unroll 8
      for (int r = 0; r < kST; ++r) {
        a = fmaf(p_s[r * kSP + key], do_s[r * kScalarRow + col], a);
        c = fmaf(ds_s[r * kSP + key], q_s[r * kScalarRow + col], c);
      }
      dv[i] = a;
      dk[i] = c;
    }
    if constexpr (kDq) {
      float* dqb = p.dq_acc + b * (long long)p.sq * c_out + h * kD;
#pragma unroll 4
      for (int i = 0; i < kPairs; ++i) {
        const int r = krow + 2 * i;
        if (q0 + r >= p.sq) continue;
        float a = 0.f;
#pragma unroll 8
        for (int c = 0; c < kST; ++c)
          a = fmaf(ds_s[r * kSP + c], k_s[c * kScalarRow + col], a);
        atomicAdd(dqb + (long long)(q0 + r) * c_out + col, a);
      }
    }
  }
  float* dkb = static_cast<float*>(p.dk) + b * (long long)p.sk * c_out + h * kD;
  float* dvb = static_cast<float*>(p.dv) + b * (long long)p.sk * c_out + h * kD;
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int key = key0 + krow + 2 * i;
    if (key < p.sk) {
      dkb[(long long)key * c_out + col] = dk[i];
      dvb[(long long)key * c_out + col] = dv[i];
    }
  }
}

template <bool kDeltaFromO>
__global__ void __launch_bounds__(kSThreads) bwd_dq_f32(BwdArgs p) {
  __shared__ float k_s[kST * kScalarRow], v_s[kST * kScalarRow];
  __shared__ float q_s[kST * kScalarRow], do_s[kST * kScalarRow];
  __shared__ float p_s[kST * kSP], ds_s[kST * kSP];
  __shared__ float lse_s[kST], delta_s[kST];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kST, h = blockIdx.y;
  const long long b = blockIdx.z;
  const float* qb = static_cast<const float*>(p.q) + b * p.q_bs + h * kD;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_bs + h * kD;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_bs + h * kD;
  const float* dob = static_cast<const float*>(p.dout) + b * p.do_bs + h * kD;
  const float* lb = p.lse + b * p.l_bs + h;
  const float* db = p.delta + b * p.l_bs + h;
  const long long c_out = (long long)p.heads * kD;
  const int nq = min(kST, p.sq - row0);

  load_rows_f32(q_s, qb, p.q_rs, row0, p.sq, tid);
  load_rows_f32(do_s, dob, p.do_rs, row0, p.sq, tid);
  if (tid < kST) {
    const bool ok = row0 + tid < p.sq;
    lse_s[tid] = ok ? lb[(long long)(row0 + tid) * p.l_rs] : 0.f;
    if (!kDeltaFromO) delta_s[tid] = ok ? db[(long long)(row0 + tid) * p.l_rs] : 0.f;
  }
  if constexpr (kDeltaFromO) {
    const float* ob = static_cast<const float*>(p.o) + b * p.o_bs + h * kD;
    __syncthreads();
    delta_from_o<float, kST, 4, kScalarRow>(delta_s, do_s, ob, p.o_rs, row0, p.sq, tid);
  }
  constexpr int kPairs = kST * kD / kSThreads;
  const int col = tid % kD, qrow = tid / kD;
  float dq[kPairs];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) dq[i] = 0.f;
  for (int kv0 = 0; kv0 < p.sk; kv0 += kST) {
    __syncthreads();
    load_rows_f32(k_s, kb, p.k_rs, kv0, p.sk, tid);
    load_rows_f32(v_s, vb, p.v_rs, kv0, p.sk, tid);
    __syncthreads();
    tile_p_ds_f32(q_s, do_s, k_s, v_s, lse_s, delta_s, p_s, ds_s, nq,
                  min(kST, p.sk - kv0), tid);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int r = qrow + 2 * i;
      float a = dq[i];
#pragma unroll 8
      for (int c = 0; c < kST; ++c)
        a = fmaf(ds_s[r * kSP + c], k_s[c * kScalarRow + col], a);
      dq[i] = a;
    }
  }
  float* dqb = static_cast<float*>(p.dq) + b * (long long)p.sq * c_out + h * kD;
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int r = row0 + qrow + 2 * i;
    if (r < p.sq) dqb[(long long)r * c_out + col] = dq[i];
  }
}

// dQ workspace (f32) -> dq in bf16.
__global__ void f32_to_bf16(const float* __restrict__ in, bf16* __restrict__ out,
                            long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = __float2bfloat16_rn(in[i]);
}

// Launch the dkv kernel (with dQ atomics when kDq) and, for bf16 with kDq,
// the conversion of the dQ workspace into dq. For f32 with kDq, dq_acc is
// dq itself. Returns the first CUDA error.
template <bool kDq, bool kDeltaFromO>
inline int launch_dkv(const BwdArgs& a, int batch, int dtype, cudaStream_t s) {
  if (dtype == 1) {
    dim3 grid((a.sk + kBwdTile - 1) / kBwdTile, a.heads, batch);
    bwd_dkv_bf16<kDq, kDeltaFromO><<<grid, kBwdWarps * 32, 0, s>>>(a);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || !kDq) return static_cast<int>(e);
    const long long n = (long long)batch * a.sq * a.heads * kD;
    const long long blocks = (n + 255) / 256;
    f32_to_bf16<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
        a.dq_acc, static_cast<bf16*>(a.dq), n);
  } else {
    dim3 grid((a.sk + kST - 1) / kST, a.heads, batch);
    bwd_dkv_f32<kDq, kDeltaFromO><<<grid, kSThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace m324
