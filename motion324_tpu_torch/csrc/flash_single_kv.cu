// K6: single-KV attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_single_kv_kernel` in
// motion324_tpu/ops/flash_attention.py (reached through `_fwd_single_kv` and
// `_fwd` when the padded KV fits one block of at most 1 024 keys): exact
// attention over (B, H, S, 64) in which the whole KV of a head is one block.
// Its arithmetic, which this kernel keeps: f32 logits s = q_scaled k^T, one
// row max m over ALL keys before any exp, p = exp(s - m) unnormalised, l =
// sum p in f32, o = (p rounded to v's dtype) v / l with one division at the
// end, padded keys masked to -1e30. There is no online rescale, so P is
// rounded against the row's final max, as in the plain version
// (`attention_reference`), and not against a running max as in K1. With the
// LSE output it also writes the f32 m + log(l) of each row, (B*H, Sq).
//
// What bounds it on the H100: at its call site, the ShapeVAE volume query
// (16 heads, 8 192 points x 512 latents), it moves 35.7 MB (q, o and k/v),
// 0.0107 ms at 3.35 TB/s, for 17.2 GFLOP in its two products, 0.0174 ms at
// the bf16 tensor-core peak: the tensor work bounds it, if only just.
//
// What the design does about that: the whole KV of one head does not fit in
// shared memory at 1 024 keys (K and V in bf16 are 256 KB, a block has 227
// KB), and a warp's registers hold one 16 x 64 logit tile, not a 16 x 1 024
// row block. So one block of 4 warps per (batch*head, 64-query tile) makes
// two sweeps over 64-key tiles: the first computes S = Q K^T and keeps only
// the exact row max; the second computes S again, exp(s - m), the row sums
// and P V. Both products run on the tensor cores (mma.sync bf16, f32
// accumulation). The second Q K^T costs 50% more tensor work than one pass;
// all query tiles of a head read the same K/V tiles, which stay in the 50 MB
// L2. Not yet done: wgmma/TMA, keeping K and V resident across query tiles
// (512 keys fit) so that one sweep does.
//
// The f32 variant runs scalar FMA in the same two sweeps and is a checking
// path, not a fast one.

#include "attention_common.cuh"

using namespace m324;

namespace {

constexpr int kWarps = 4;
constexpr int kBlockQ = 16 * kWarps;

// S = Q K^T of the warp's 16 rows against one chunk of kKeys keys in shared
// memory; keys at or past `nvalid` get the masked logit.
__device__ __forceinline__ void chunk_scores(const uint32_t qf[4][4],
                                             const bf16* k_s, int nvalid,
                                             int lane, float s[8][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bf16* kr = k_s + (8 * j + g) * kRow + ks * 16 + 2 * t;
      uint32_t b[2] = {ld_u32(kr), ld_u32(kr + 8)};
      mma_bf16_16816(s[j], qf[ks], b);
    }
  }
  if (nvalid < kKeys) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = 8 * j + 2 * t;
      if (key >= nvalid) { s[j][0] = kNegInf; s[j][2] = kNegInf; }
      if (key + 1 >= nvalid) { s[j][1] = kNegInf; s[j][3] = kNegInf; }
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
single_kv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o,
               float* __restrict__ lse, int sq, int sk, float scale) {
  __shared__ uint4 smem_raw[(kBlockQ + 2 * kKeys) * kRow * sizeof(bf16) / 16];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kBlockQ * kRow;
  bf16* v_s = k_s + kKeys * kRow;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kBlockQ;
  const long long bh = blockIdx.y;
  const bf16* kb = k + bh * sk * kD;
  const bf16* vb = v + bh * sk * kD;

  load_rows_bf16(q_s, q + bh * sq * kD, kD, row0, kBlockQ, sq, scale, tid,
                 kWarps * 32);
  __syncthreads();
  uint32_t qf[4][4];
  const bf16* qw = q_s + warp * 16 * kRow;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int c = ks * 16 + 2 * t;
    qf[ks][0] = ld_u32(qw + g * kRow + c);
    qf[ks][1] = ld_u32(qw + (g + 8) * kRow + c);
    qf[ks][2] = ld_u32(qw + g * kRow + c + 8);
    qf[ks][3] = ld_u32(qw + (g + 8) * kRow + c + 8);
  }

  // sweep 1: the exact max of rows g and g + 8 over all keys
  float s[8][4];
  float m0 = kNegInf, m1 = kNegInf;
  for (int kv0 = 0; kv0 < sk; kv0 += kKeys) {
    __syncthreads();
    load_rows_bf16(k_s, kb, kD, kv0, kKeys, sk, 1.0f, tid, kWarps * 32);
    __syncthreads();
    chunk_scores(qf, k_s, min(kKeys, sk - kv0), lane, s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
      m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }

  // sweep 2: p = exp(s - m) against that max, l = sum p, acc = bf16(p) V
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  for (int kv0 = 0; kv0 < sk; kv0 += kKeys) {
    __syncthreads();
    load_rows_bf16(k_s, kb, kD, kv0, kKeys, sk, 1.0f, tid, kWarps * 32);
    load_rows_bf16(v_s, vb, kD, kv0, kKeys, sk, 1.0f, tid, kWarps * 32);
    __syncthreads();
    chunk_scores(qf, k_s, min(kKeys, sk - kv0), lane, s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = expf(s[j][0] - m0);
      s[j][1] = expf(s[j][1] - m0);
      s[j][2] = expf(s[j][2] - m1);
      s[j][3] = expf(s[j][3] - m1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                       pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                       pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                       pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const bf16* vr = v_s + (16 * kk + 2 * t) * kRow;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + g;
        uint32_t b[2] = {pack_u16(vr + c, vr + kRow + c),
                         pack_u16(vr + 8 * kRow + c, vr + 9 * kRow + c)};
        mma_bf16_16816(acc[j], a, b);
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }

  const int r0 = row0 + warp * 16 + g, r1 = r0 + 8;
  if (lse != nullptr && t == 0) {
    if (r0 < sq) lse[bh * sq + r0] = m0 + logf(l0);
    if (r1 < sq) lse[bh * sq + r1] = m1 + logf(l1);
  }
  bf16* ob = o + bh * sq * kD;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (r0 < sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r0 * kD + c) =
          __floats2bfloat162_rn(acc[j][0] / l0, acc[j][1] / l0);
    if (r1 < sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r1 * kD + c) =
          __floats2bfloat162_rn(acc[j][2] / l1, acc[j][3] / l1);
  }
}

// f32: a block of kScalarWarps warps, each owning kScalarRows query rows,
// keys through shared memory 32 at a time (one key per lane for the logits,
// two head-dim columns per lane for the output), in the same two sweeps.
__global__ void __launch_bounds__(kScalarWarps * 32)
single_kv_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int sq, int sk, float scale) {
  __shared__ float smem[kScalarSmemFloats];
  float* q_s = smem;
  float* k_s = q_s + kScalarQ * kD;
  float* v_s = k_s + 32 * kScalarRow;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = kScalarWarps * 32;
  const int row0 = blockIdx.x * kScalarQ;
  const long long bh = blockIdx.y;
  const float* qb = q + bh * sq * kD;
  const float* kb = k + bh * sk * kD;
  const float* vb = v + bh * sk * kD;

  for (int idx = tid; idx < kScalarQ * kD; idx += nthreads) {
    const int r = idx / kD, c = idx % kD;
    q_s[idx] = (row0 + r < sq) ? qb[(long long)(row0 + r) * kD + c] * scale : 0.f;
  }
  float m[kScalarRows], l[kScalarRows], acc0[kScalarRows], acc1[kScalarRows];
#pragma unroll
  for (int i = 0; i < kScalarRows; ++i) {
    m[i] = kNegInf; l[i] = 0.f; acc0[i] = 0.f; acc1[i] = 0.f;
  }
  // sweep 1: each lane's max over its keys, then over the warp
  for (int kv0 = 0; kv0 < sk; kv0 += 32) {
    __syncthreads();
    for (int idx = tid; idx < 32 * kD; idx += nthreads) {
      const int r = idx / kD, c = idx % kD;
      k_s[r * kScalarRow + c] = (kv0 + r < sk) ? kb[(long long)(kv0 + r) * kD + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kScalarRows; ++i) {
      const float* qr = q_s + (warp * kScalarRows + i) * kD;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < kD; ++d) s = fmaf(qr[d], k_s[lane * kScalarRow + d], s);
      if (kv0 + lane < sk) m[i] = fmaxf(m[i], s);
    }
  }
#pragma unroll
  for (int i = 0; i < kScalarRows; ++i)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], off));
  // sweep 2
  for (int kv0 = 0; kv0 < sk; kv0 += 32) {
    __syncthreads();
    for (int idx = tid; idx < 32 * kD; idx += nthreads) {
      const int r = idx / kD, c = idx % kD;
      const bool ok = kv0 + r < sk;
      k_s[r * kScalarRow + c] = ok ? kb[(long long)(kv0 + r) * kD + c] : 0.f;
      v_s[r * kScalarRow + c] = ok ? vb[(long long)(kv0 + r) * kD + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kScalarRows; ++i) {
      const float* qr = q_s + (warp * kScalarRows + i) * kD;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < kD; ++d) s = fmaf(qr[d], k_s[lane * kScalarRow + d], s);
      const float p = (kv0 + lane < sk) ? expf(s - m[i]) : 0.f;
      l[i] += p;
      float a0 = acc0[i], a1 = acc1[i];
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        a0 = fmaf(pj, v_s[j * kScalarRow + lane], a0);
        a1 = fmaf(pj, v_s[j * kScalarRow + lane + 32], a1);
      }
      acc0[i] = a0;
      acc1[i] = a1;
    }
  }
#pragma unroll
  for (int i = 0; i < kScalarRows; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      li += __shfl_xor_sync(0xffffffffu, li, off);
    const int r = row0 + warp * kScalarRows + i;
    if (r < sq) {
      float* orow = o + (bh * sq + r) * kD;
      orow[lane] = acc0[i] / li;
      orow[lane + 32] = acc1[i] / li;
      if (lse != nullptr && lane == 0) lse[bh * sq + r] = m[i] + logf(li);
    }
  }
}

}  // namespace

// q, o: (B*H, sq, 64); k, v: (B*H, sk, 64); all contiguous, 16-byte aligned.
// lse: null, or f32 (B*H, sq) that receives each row's log-sum-exp.
// dtype: 0 = float32, 1 = bfloat16. Any sk >= 1 gives the right result; the
// caller takes this kernel for the KV lengths of the TPU kernel's route
// (at most 1 024). Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError() after the launch.
extern "C" int m324_flash_single_kv(const void* q, const void* k, const void* v,
                                    void* o, float* lse, int bh, int sq, int sk,
                                    float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    dim3 grid((sq + kBlockQ - 1) / kBlockQ, bh);
    single_kv_bf16<<<grid, kWarps * 32, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, sq, sk, scale);
  } else {
    dim3 grid((sq + kScalarQ - 1) / kScalarQ, bh);
    single_kv_f32<<<grid, kScalarWarps * 32, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, sq, sk,
        scale);
  }
  return static_cast<int>(cudaGetLastError());
}
