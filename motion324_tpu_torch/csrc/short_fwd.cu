// K9 forward: short attention over (B*H, S, 64) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` in motion324_tpu/ops/short_attention.py
// (reached through `_call_fwd` and `short_attention`, the "short_legacy"
// attention backend): exact attention over (B*H, S, 64) slices, the logit
// scale folded into q (q * scale rounded to q's dtype), keys past the KV
// length masked to -1e30, P rounded to v's dtype before P V, the division
// last, and, when the call is differentiated, the f32 log-sum-exp of each
// row. The TPU kernel writes that LSE 8-lane replicated, (B*H, Sq, 8); here
// it is compact, (B*H, Sq), the residual that the K9 backward
// (short_bwd.cu) reads.
//
// The TPU kernel keeps the whole (Sq, Sk) logit tile of several slices in
// VMEM and takes the softmax in one pass. Under the legacy route the motion
// model sends calls here whose tile no block of 227 KB can hold: global
// attention over 3 888 keys (82 944 at a 256-frame window), the shape
// encoder's 64 queries x 16 384 keys. So the keys stream: resident segments
// of 256 keys in shared memory, walked by each warp in 64-key chunks with a
// running max (attention_common.cuh, WarpAttn); it is the same softmax,
// with P rounded against the running max instead of the final one.
//
// What bounds it on the H100: at the local shape (144 slices x 324^2) and
// the decoder's (144 slices x 162 queries x 64 keys) the bytes of q, k, v
// and o; at the global shape (12 x 3 888^2) the tensor cores; the shape
// encoder (12 slices x 64 queries) is short of parallelism, 12 blocks for
// 132 SMs.
//
// What the design does about that: one block of 4 warps per (slice,
// 64-query tile), so the decoder's 162 queries waste 30 rows, not 94, and
// the shape encoder's 64 queries fill every warp. q, k and v are read
// through a slice stride and a row stride (a (B, H, S, 64) view whose B*H
// flattens goes in without a copy); o is contiguous. Both products run on
// the tensor cores (mma.sync bf16, f32 accumulation). A segment of 256 keys
// is 73.7 KB with the q tile (dynamic shared memory), so two blocks fit an
// SM. Not yet done: wgmma/TMA, cp.async double buffering of the segments,
// split-KV for the shape encoder.
//
// The f32 variant runs scalar FMA (attention_common.cuh) and is a checking
// path, not a fast one.

#include "attention_common.cuh"

using namespace m324;

namespace {

constexpr int kWarps = 4;
constexpr int kBlockQ = 16 * kWarps;
constexpr int kResident = 256;  // keys of a slice kept in shared memory

__global__ void __launch_bounds__(kWarps * 32)
short_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o,
               float* __restrict__ lse, int sq, int sk, long long q_bs,
               long long q_rs, long long k_bs, long long k_rs, long long v_bs,
               long long v_rs, float scale, int cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kBlockQ * kRow;
  bf16* v_s = k_s + cap * kRow;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kBlockQ;
  const long long bh = blockIdx.y;
  const bf16* kb = k + bh * k_bs;
  const bf16* vb = v + bh * v_bs;

  load_rows_bf16(q_s, q + bh * q_bs, q_rs, row0, kBlockQ, sq, scale, tid,
                 kWarps * 32);
  __syncthreads();
  WarpAttn st;
  st.init(q_s + warp * 16 * kRow, lane);

  for (int seg = 0; seg < sk; seg += cap) {
    const int n = min(cap, sk - seg);
    const int rows = (n + kKeys - 1) / kKeys * kKeys;
    __syncthreads();   // the previous segment has been read by every warp
    load_rows_bf16(k_s, kb, k_rs, seg, rows, sk, 1.0f, tid, kWarps * 32);
    load_rows_bf16(v_s, vb, v_rs, seg, rows, sk, 1.0f, tid, kWarps * 32);
    __syncthreads();
    for (int c = 0; c < rows; c += kKeys)
      st.step(k_s + c * kRow, v_s + c * kRow, min(kKeys, n - c), lane);
  }
  st.store(o + bh * sq * kD, kD, row0 + warp * 16, sq, lane,
           lse == nullptr ? nullptr : lse + bh * sq, 1);
}

__global__ void __launch_bounds__(kScalarWarps * 32)
short_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int sq, int sk, long long q_bs,
              long long q_rs, long long k_bs, long long k_rs, long long v_bs,
              long long v_rs, float scale) {
  __shared__ float smem[kScalarSmemFloats];
  const long long bh = blockIdx.y;
  scalar_attend(q + bh * q_bs, k + bh * k_bs, v + bh * v_bs, o + bh * sq * kD,
                lse == nullptr ? nullptr : lse + bh * sq, q_rs, k_rs, v_rs, kD,
                1, sq, sk, blockIdx.x * kScalarQ, scale, smem);
}

size_t smem_bytes(int cap) {
  return sizeof(bf16) * (size_t)kRow * (kBlockQ + 2 * cap);
}

}  // namespace

// q: (bh, sq, 64) and k, v: (bh, sk, 64), each with its own slice stride
// (*_bs) and row stride (*_rs) in elements, unit stride within a row, rows
// 16-byte aligned. o: contiguous (bh, sq, 64). lse: null, or f32 (bh, sq)
// that receives the log-sum-exp of each row. scale is applied to q in f32
// and rounded back to q's dtype. dtype: 0 = float32, 1 = bfloat16. Launches
// on `stream`, allocates nothing, does not synchronise; returns the first
// CUDA error seen (attribute set or launch).
extern "C" int m324_short_fwd(const void* q, const void* k, const void* v,
                              void* o, float* lse, int bh, int sq, int sk,
                              long long q_bs, long long q_rs, long long k_bs,
                              long long k_rs, long long v_bs, long long v_rs,
                              float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const int padded = (sk + kKeys - 1) / kKeys * kKeys;
    const int cap = padded < kResident ? padded : kResident;
    // set on every call: the attribute belongs to the current device
    cudaError_t e = cudaFuncSetAttribute(
        short_fwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(cap));
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((sq + kBlockQ - 1) / kBlockQ, bh);
    short_fwd_bf16<<<grid, kWarps * 32, smem_bytes(cap), s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, sq, sk, q_bs,
        q_rs, k_bs, k_rs, v_bs, v_rs, scale, cap);
  } else {
    dim3 grid((sq + kScalarQ - 1) / kScalarQ, bh);
    short_fwd_f32<<<grid, kScalarWarps * 32, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, sq, sk,
        q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
