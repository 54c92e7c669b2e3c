// Device code shared by the attention kernels (flash_fwd.cu, folded_fwd.cu,
// and through attention_bwd.cuh the backward kernels).
//
// bf16: one warp owns 16 query rows. Q stays in registers as mma.sync A
// fragments; keys arrive in 64-key chunks in shared memory; S = Q K^T and
// O += P V run on the tensor cores (mma.sync m16n8k16, f32 accumulation).
// The softmax is kept online over the chunks: running row max m, running
// row sum l and the output accumulator, all f32. P is rounded to bf16 only
// as the A operand of P V, as the TPU kernels do (p.astype(v.dtype)).
//
// f32: scalar FMA, one warp per query row at a time, one key per lane.
//
// Head dim is fixed at 64. Masked (padded) keys get a logit of -1e30, as in
// the TPU kernels; their V rows are zero-filled so that 0 * V stays finite.
// When asked for it, each forward also writes the row's log-sum-exp
// m + log(l) in f32, the residual that the backward kernels read.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace m324 {

constexpr int kD = 64;            // head dim
constexpr int kKeys = 64;         // keys per chunk (bf16 path)
constexpr int kRow = kD + 8;      // bf16 row stride in shared memory: 144 B,
                                  // keeps fragment reads free of bank conflicts
constexpr float kNegInf = -1e30f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_u16(const bf16* lo, const bf16* hi) {
  uint32_t a = *reinterpret_cast<const uint16_t*>(lo);
  uint32_t b = *reinterpret_cast<const uint16_t*>(hi);
  return a | (b << 16);
}

// Copy rows [row0, row0 + rows) of a (S, 64) bf16 matrix with row stride
// `rstride` (elements) into shared memory (row stride kRow). Rows at or past
// `valid` are zero-filled. With `scale != 1` each value is multiplied in f32
// and rounded back to bf16, which is how the logit scale is folded into q.
__device__ __forceinline__ void load_rows_bf16(bf16* smem, const bf16* g,
                                               long long rstride, int row0,
                                               int rows, int valid, float scale,
                                               int tid, int nthreads) {
  for (int idx = tid; idx < rows * 8; idx += nthreads) {
    const int r = idx >> 3;
    const int c = (idx & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < valid) {
      val = *reinterpret_cast<const uint4*>(g + (long long)(row0 + r) * rstride + c);
      if (scale != 1.0f) {
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float2 f = __bfloat1622float2(h[i]);
          h[i] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
        }
      }
    }
    *reinterpret_cast<uint4*>(smem + r * kRow + c) = val;
  }
}

// Per-warp state of the bf16 online softmax over 16 query rows.
struct WarpAttn {
  uint32_t qf[4][4];  // Q A-fragments, one per 16-wide slice of the head dim
  float o[8][4];      // output accumulator, 8 n-tiles of 8 head-dim columns
  float m[2];         // running max of rows g and g + 8
  float l[2];         // this thread's share of the running row sums

  // q_s: the warp's 16 rows of (pre-scaled) Q in shared memory.
  __device__ __forceinline__ void init(const bf16* q_s, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int c = ks * 16 + 2 * t;
      qf[ks][0] = ld_u32(q_s + g * kRow + c);
      qf[ks][1] = ld_u32(q_s + (g + 8) * kRow + c);
      qf[ks][2] = ld_u32(q_s + g * kRow + c + 8);
      qf[ks][3] = ld_u32(q_s + (g + 8) * kRow + c + 8);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
  }

  // One chunk of kKeys keys: k_s / v_s are (kKeys, kRow) in shared memory,
  // keys at or past `nvalid` are masked.
  __device__ __forceinline__ void step(const bf16* k_s, const bf16* v_s,
                                       int nvalid, int lane) {
    const int g = lane >> 2, t = lane & 3;
    float s[8][4];
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
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
    const float a0 = expf(m[0] - mn0), a1 = expf(m[1] - mn1);
    m[0] = mn0;
    m[1] = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = expf(s[j][0] - mn0);
      s[j][1] = expf(s[j][1] - mn0);
      s[j][2] = expf(s[j][2] - mn1);
      s[j][3] = expf(s[j][3] - mn1);
      ls0 += s[j][0] + s[j][1];
      ls1 += s[j][2] + s[j][3];
      o[j][0] *= a0; o[j][1] *= a0;
      o[j][2] *= a1; o[j][3] *= a1;
    }
    l[0] = l[0] * a0 + ls0;
    l[1] = l[1] * a1 + ls1;
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
        mma_bf16_16816(o[j], a, b);
      }
    }
  }

  // Normalise and store rows row0 + {g, g + 8} that lie below `valid`.
  // `out` points at row 0 of this (batch, head); `ostride` is its row stride.
  // With `lse` set (row 0 of this (batch, head), row stride `lstride`), also
  // store each row's log-sum-exp.
  template <typename OutT>
  __device__ __forceinline__ void store(OutT* out, long long ostride, int row0,
                                        int valid, int lane, float* lse,
                                        long long lstride) {
    const int g = lane >> 2, t = lane & 3;
    float l0 = l[0], l1 = l[1];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    // m is the same in the 4 threads of a row (reduced over the quad)
    if (lse != nullptr && t == 0) {
      if (row0 + g < valid) lse[(long long)(row0 + g) * lstride] = m[0] + logf(l0);
      if (row0 + g + 8 < valid)
        lse[(long long)(row0 + g + 8) * lstride] = m[1] + logf(l1);
    }
    const float r0 = 1.f / l0, r1 = 1.f / l1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t;
      if (row0 + g < valid)
        store2(out + (long long)(row0 + g) * ostride + c, o[j][0] * r0, o[j][1] * r0);
      if (row0 + g + 8 < valid)
        store2(out + (long long)(row0 + g + 8) * ostride + c, o[j][2] * r1, o[j][3] * r1);
    }
  }

  __device__ __forceinline__ static void store2(bf16* p, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  }
  __device__ __forceinline__ static void store2(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
};

// f32 path: a block of kScalarWarps warps, each warp owning kScalarRows query
// rows; keys stream through shared memory 32 at a time (one key per lane for
// the logits, two head-dim columns per lane for the output).
constexpr int kScalarWarps = 4;
constexpr int kScalarRows = 8;
constexpr int kScalarQ = kScalarWarps * kScalarRows;   // query rows per block
constexpr int kScalarRow = kD + 1;                     // padded f32 row stride
constexpr int kScalarSmemFloats = kScalarQ * kD + 2 * 32 * kScalarRow;

// q, k, v, out point at row 0 of one (batch, head); strides in elements.
// `lse` (may be null) points at row 0 of this (batch, head) with row stride
// `l_rs`.
__device__ __forceinline__ void scalar_attend(
    const float* q, const float* k, const float* v, float* out, float* lse,
    long long q_rs, long long k_rs, long long v_rs, long long o_rs,
    long long l_rs, int sq, int sk, int row0, float scale, float* smem) {
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
      if (kv0 + lane >= sk) s = kNegInf;
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
