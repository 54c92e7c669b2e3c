// K1: flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` in motion324_tpu/ops/flash_attention.py
// (reached through `_fwd` and `flash_attention`): exact attention over
// (B, H, S, 64) with an online softmax over KV tiles, the logit scale folded
// into q, padded keys masked to -1e30, m / l / acc in f32 and the output in
// q's dtype. When the call is differentiated it also writes the f32
// log-sum-exp of each row, 2-D (B*H, Sq), the residual that K3 / K4
// (flash_bwd.cu) read; a forward-only call passes no lse and writes none.
//
// What bounds it on the H100: at the global-attention shape (12 heads x 3 888
// tokens) it is compute bound (4*S^2*D flops against ~24 MB of traffic); at
// the shape-encoder shape (64 queries x 16 384 keys) it is memory bound and
// also starved of parallelism: 12 blocks for 132 SMs.
//
// What the design does about that: one block of 4 warps per (batch*head,
// 64-query tile); each warp keeps its 16 query rows in registers and both
// products of a 64-key tile run on the tensor cores (mma.sync bf16, f32
// accumulation). Each K/V tile is read from device memory once per query
// tile and shared by the 4 warps through shared memory. The ragged KV tail
// is masked in the kernel (no padded copy in device memory) and ragged query
// rows are masked on store. Not yet done: wgmma/TMA, cp.async double
// buffering, split-KV for the short-query call.
//
// The f32 variant runs scalar FMA (attention_common.cuh) and is a checking
// path, not a fast one.

#include "attention_common.cuh"

using namespace m324;

namespace {

constexpr int kWarps = 4;
constexpr int kBlockQ = 16 * kWarps;

__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o,
               float* __restrict__ lse, int sq, int sk, float scale) {
  // raw 16-byte words: bf16 has a constructor, __shared__ arrays may not
  __shared__ uint4 smem_raw[(kBlockQ + 2 * kKeys) * kRow * sizeof(bf16) / 16];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kBlockQ * kRow;
  bf16* v_s = k_s + kKeys * kRow;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kBlockQ;
  const long long bh = blockIdx.y;
  const bf16* qb = q + bh * sq * kD;
  const bf16* kb = k + bh * sk * kD;
  const bf16* vb = v + bh * sk * kD;

  load_rows_bf16(q_s, qb, kD, row0, kBlockQ, sq, scale, tid, kWarps * 32);
  __syncthreads();
  WarpAttn st;
  st.init(q_s + warp * 16 * kRow, lane);

  for (int kv0 = 0; kv0 < sk; kv0 += kKeys) {
    __syncthreads();
    load_rows_bf16(k_s, kb, kD, kv0, kKeys, sk, 1.0f, tid, kWarps * 32);
    load_rows_bf16(v_s, vb, kD, kv0, kKeys, sk, 1.0f, tid, kWarps * 32);
    __syncthreads();
    st.step(k_s, v_s, min(kKeys, sk - kv0), lane);
  }
  st.store(o + bh * sq * kD, kD, row0 + warp * 16, sq, lane,
           lse == nullptr ? nullptr : lse + bh * sq, 1);
}

__global__ void __launch_bounds__(kScalarWarps * 32)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int sq, int sk, float scale) {
  __shared__ float smem[kScalarSmemFloats];
  const long long bh = blockIdx.y;
  scalar_attend(q + bh * sq * kD, k + bh * sk * kD, v + bh * sk * kD,
                o + bh * sq * kD, lse == nullptr ? nullptr : lse + bh * sq,
                kD, kD, kD, kD, 1, sq, sk, blockIdx.x * kScalarQ, scale, smem);
}

}  // namespace

// q, o: (B*H, sq, 64); k, v: (B*H, sk, 64); all contiguous, 16-byte aligned.
// lse: null, or f32 (B*H, sq) that receives each row's log-sum-exp.
// dtype: 0 = float32, 1 = bfloat16. Launches on `stream`, allocates nothing,
// does not synchronise; returns cudaGetLastError() after the launch.
extern "C" int m324_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, float* lse, int bh, int sq, int sk,
                              float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    dim3 grid((sq + kBlockQ - 1) / kBlockQ, bh);
    flash_fwd_bf16<<<grid, kWarps * 32, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, sq, sk, scale);
  } else {
    dim3 grid((sq + kScalarQ - 1) / kScalarQ, bh);
    flash_fwd_f32<<<grid, kScalarWarps * 32, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, sq, sk,
        scale);
  }
  return static_cast<int>(cudaGetLastError());
}
