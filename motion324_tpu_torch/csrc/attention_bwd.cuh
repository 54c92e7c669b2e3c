// The f32 checking kernels of the attention backwards: K3 / K4
// (flash_bwd.cu), K5 (folded_bwd.cu) and the K9 backward (short_bwd.cu),
// whose bf16 kernels are the Hopper passes of hopper_bwd.cuh.
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
// Scalar FMA on 32 x 32 tiles in shared memory: one kernel per key tile for
// dK / dV (and for K3, dQ added with f32 atomics), one per query tile for
// dQ (K4, K5, K9). They compute delta from O (kDeltaFromO: K5, K9) or read
// it (K3, K4). A checking path, not a fast one.

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
  float* dq_acc;       // f32 dQ summed into with atomics (K3)
  void* dq;            // dQ written directly (f32 dq kernel)
  void* dk;
  void* dv;
  int sq, sk, heads;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, do_bs, do_rs;
  long long l_bs, l_rs;  // lse / delta: batch and row stride, head h at +h
};

// delta for `kRows` rows starting at q0: rowsum(dO * O) in f32, dO from
// shared memory (row stride kScalarRow), O from device memory. `kPer`
// threads share a row.
template <int kRows, int kPer>
__device__ __forceinline__ void delta_from_o(float* delta_s, const float* do_s,
                                             const float* ob, long long o_rs,
                                             int q0, int sq, int tid) {
  const int r = tid / kPer, part = tid % kPer;
  constexpr int kCols = kD / kPer;
  float acc = 0.f;
  if (r < kRows && q0 + r < sq) {
    const float* orow = ob + (long long)(q0 + r) * o_rs + part * kCols;
    const float* drow = do_s + r * kScalarRow + part * kCols;
#pragma unroll 8
    for (int c = 0; c < kCols; ++c) acc = fmaf(drow[c], orow[c], acc);
  }
#pragma unroll
  for (int off = 1; off < kPer; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < kRows && part == 0) delta_s[r] = acc;
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
      delta_from_o<kST, 4>(delta_s, do_s, ob, p.o_rs, q0, p.sq, tid);
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
    delta_from_o<kST, 4>(delta_s, do_s, ob, p.o_rs, row0, p.sq, tid);
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

}  // namespace m324
