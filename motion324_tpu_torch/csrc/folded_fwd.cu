// K2: head-folded short attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` in motion324_tpu/ops/folded_attention.py
// (reached through `_call_fwd` and `folded_attention`): attention for short
// sequences read straight from the model-native (B, S, H*64) layout, with no
// transpose on either side, the whole KV of a head resident on chip, padded
// keys masked and the logit scale folded into q.
//
// What bounds it on the H100: at its two call sites (local frame attention,
// 324 tokens; DINOv2, 257 tokens; 12 heads, 12 images) the work is small,
// 2.4-3.9 GFLOP against 19-24 MB of q/k/v/o, so it is memory bound; the
// rest is latency: a few hundred blocks of short loops.
//
// What the design does about that: one block of 8 warps per (image, head,
// 128-query tile). q, k and v are read through their row strides, so the
// q/k/v views of a fused QKV projection go in without a copy, and the output
// is written in (B, S, H*64). The head's K and V for up to 384 keys are
// loaded into shared memory once (2 x 384 x 144 B = 108 KB, above the 48 KB
// static limit, hence the dynamic shared-memory attribute) and shared by the
// 8 warps; longer KV is processed in resident segments of 384 keys. Each
// warp walks the resident keys in 64-key chunks with a running max, since
// its registers hold one 16 x 64 logit tile, not the whole 16 x 384 row
// block that the TPU kernel's single-pass softmax keeps in VMEM; the result
// is the same softmax. Both products run on the tensor cores (mma.sync bf16,
// f32 accumulation). Not yet done: wgmma/TMA, sharing one K/V load across
// the query tiles of a head.
//
// The f32 variant runs scalar FMA (attention_common.cuh), streaming keys from
// device memory, and is a checking path, not a fast one.

#include "attention_common.cuh"

using namespace m324;

namespace {

constexpr int kWarps = 8;
constexpr int kBlockQ = 16 * kWarps;
constexpr int kResident = 384;  // keys of one head kept in shared memory

__global__ void __launch_bounds__(kWarps * 32)
folded_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int sq,
                int sk, int heads, long long q_bs, long long q_rs,
                long long k_bs, long long k_rs, long long v_bs, long long v_rs,
                float scale, int cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kBlockQ * kRow;
  bf16* v_s = k_s + cap * kRow;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const bf16* qb = q + b * q_bs + h * kD;
  const bf16* kb = k + b * k_bs + h * kD;
  const bf16* vb = v + b * v_bs + h * kD;

  load_rows_bf16(q_s, qb, q_rs, row0, kBlockQ, sq, scale, tid, kWarps * 32);
  __syncthreads();
  WarpAttn st;
  st.init(q_s + warp * 16 * kRow, lane);

  for (int seg = 0; seg < sk; seg += cap) {
    const int n = min(cap, sk - seg);
    const int rows = (n + kKeys - 1) / kKeys * kKeys;
    __syncthreads();
    load_rows_bf16(k_s, kb, k_rs, seg, rows, sk, 1.0f, tid, kWarps * 32);
    load_rows_bf16(v_s, vb, v_rs, seg, rows, sk, 1.0f, tid, kWarps * 32);
    __syncthreads();
    for (int c = 0; c < rows; c += kKeys)
      st.step(k_s + c * kRow, v_s + c * kRow, min(kKeys, n - c), lane);
  }
  const long long o_rs = (long long)heads * kD;
  st.store(o + b * sq * o_rs + h * kD, o_rs, row0 + warp * 16, sq, lane);
}

__global__ void __launch_bounds__(kScalarWarps * 32)
folded_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int sq,
               int sk, int heads, long long q_bs, long long q_rs,
               long long k_bs, long long k_rs, long long v_bs, long long v_rs,
               float scale) {
  __shared__ float smem[kScalarSmemFloats];
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long o_rs = (long long)heads * kD;
  scalar_attend(q + b * q_bs + h * kD, k + b * k_bs + h * kD,
                v + b * v_bs + h * kD, o + b * sq * o_rs + h * kD,
                q_rs, k_rs, v_rs, o_rs, sq, sk, blockIdx.x * kScalarQ, scale,
                smem);
}

size_t smem_bytes(int cap) {
  return sizeof(bf16) * (size_t)kRow * (kBlockQ + 2 * cap);
}

}  // namespace

// q: (B, sq, H*64) and k, v: (B, sk, H*64), each with its own batch stride
// (*_bs) and row stride (*_rs) in elements, unit stride within a row, and
// rows 16-byte aligned. o: contiguous (B, sq, H*64). dtype: 0 = float32,
// 1 = bfloat16. Launches on `stream`, allocates nothing, does not
// synchronise; returns the first CUDA error seen (attribute set or launch).
extern "C" int m324_folded_fwd(const void* q, const void* k, const void* v,
                               void* o, int batch, int heads, int sq, int sk,
                               long long q_bs, long long q_rs, long long k_bs,
                               long long k_rs, long long v_bs, long long v_rs,
                               float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const int padded = (sk + kKeys - 1) / kKeys * kKeys;
    const int cap = padded < kResident ? padded : kResident;
    // set on every call: the attribute belongs to the current device
    cudaError_t e = cudaFuncSetAttribute(
        folded_fwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(cap));
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((sq + kBlockQ - 1) / kBlockQ, heads, batch);
    folded_fwd_bf16<<<grid, kWarps * 32, smem_bytes(cap), s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), sq, sk, heads,
        q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale, cap);
  } else {
    dim3 grid((sq + kScalarQ - 1) / kScalarQ, heads, batch);
    folded_fwd_f32<<<grid, kScalarWarps * 32, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), sq, sk, heads,
        q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
