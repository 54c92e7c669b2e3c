// Device code shared by the attention kernels: the scalar f32 checking
// paths (here, attention_bwd.cuh, hopper_fwd.cuh, flash_single_kv.cu,
// masked_flash.cu), and the constants and bf16 packing that the Hopper
// kernels (hopper.cuh) use.
//
// f32: scalar FMA, one warp per query row at a time, one key per lane.
//
// Head dim is fixed at 64. Masked (padded) keys get a logit of -1e30, as in
// the TPU kernels. When asked for it, each forward also writes the row's
// log-sum-exp m + log(l) in f32, the residual that the backward kernels
// read.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace m324 {

constexpr int kD = 64;            // head dim
constexpr float kNegInf = -1e30f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// f32 path: a block of kScalarWarps warps, each warp owning kScalarRows query
// rows; keys stream through shared memory 32 at a time (one key per lane for
// the logits, two head-dim columns per lane for the output).
constexpr int kScalarWarps = 4;
constexpr int kScalarRows = 8;
constexpr int kScalarQ = kScalarWarps * kScalarRows;   // query rows per block
constexpr int kScalarRow = kD + 1;                     // padded f32 row stride
constexpr int kScalarSmemFloats = kScalarQ * kD + 2 * 32 * kScalarRow;

// The default key mask of scalar_attend: every key of every row is kept.
struct ScalarNoMask {
  __device__ __forceinline__ bool operator()(int, int) const { return true; }
};

// q, k, v, out point at row 0 of one (batch, head); strides in elements.
// `lse` (may be null) points at row 0 of this (batch, head) with row stride
// `l_rs`. `keep(row, key)` may mask a (query row, key) pair; it is asked
// only for keys below sk, and also for rows at or past sq.
template <typename Mask = ScalarNoMask>
__device__ __forceinline__ void scalar_attend(
    const float* q, const float* k, const float* v, float* out, float* lse,
    long long q_rs, long long k_rs, long long v_rs, long long o_rs,
    long long l_rs, int sq, int sk, int row0, float scale, float* smem,
    const Mask& keep = Mask()) {
  float* q_s = smem;
  float* k_s = q_s + kScalarQ * kD;
  float* v_s = k_s + 32 * kScalarRow;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = kScalarWarps * 32;
  for (int idx = tid; idx < kScalarQ * kD; idx += nthreads) {
    const int r = idx / kD, c = idx % kD;
    q_s[idx] = (row0 + r < sq) ? q[(long long)(row0 + r) * q_rs + c] * scale : 0.f;
  }
  float m[kScalarRows], l[kScalarRows], acc0[kScalarRows], acc1[kScalarRows];
#pragma unroll
  for (int i = 0; i < kScalarRows; ++i) {
    m[i] = kNegInf; l[i] = 0.f; acc0[i] = 0.f; acc1[i] = 0.f;
  }
  for (int kv0 = 0; kv0 < sk; kv0 += 32) {
    __syncthreads();
    for (int idx = tid; idx < 32 * kD; idx += nthreads) {
      const int r = idx / kD, c = idx % kD;
      const bool ok = kv0 + r < sk;
      k_s[r * kScalarRow + c] = ok ? k[(long long)(kv0 + r) * k_rs + c] : 0.f;
      v_s[r * kScalarRow + c] = ok ? v[(long long)(kv0 + r) * v_rs + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kScalarRows; ++i) {
      const float* qr = q_s + (warp * kScalarRows + i) * kD;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < kD; ++d) s = fmaf(qr[d], k_s[lane * kScalarRow + d], s);
      if (kv0 + lane >= sk || !keep(row0 + warp * kScalarRows + i, kv0 + lane))
        s = kNegInf;
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      const float p = expf(s - mn);
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
      float a0 = acc0[i] * alpha, a1 = acc1[i] * alpha;
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        a0 = fmaf(pj, v_s[j * kScalarRow + lane], a0);
        a1 = fmaf(pj, v_s[j * kScalarRow + lane + 32], a1);
      }
      acc0[i] = a0;
      acc1[i] = a1;
      m[i] = mn;
    }
  }
#pragma unroll
  for (int i = 0; i < kScalarRows; ++i) {
    const int r = row0 + warp * kScalarRows + i;
    if (r < sq) {
      out[(long long)r * o_rs + lane] = acc0[i] / l[i];
      out[(long long)r * o_rs + lane + 32] = acc1[i] / l[i];
      // m and l are the same in every lane (reduced over the warp)
      if (lse != nullptr && lane == 0) lse[(long long)r * l_rs] = m[i] + logf(l[i]);
    }
  }
}

}  // namespace m324
