// K1: flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` in motion324_tpu/ops/flash_attention.py
// (reached through `_fwd` and `flash_attention`): exact attention over
// (B, H, S, 64), and in bf16 without the LSE over (B, H, S, 128) (the
// Hunyuan3D-2.1 DiT's heads), with an online softmax over KV tiles, the
// logit scale folded into q in q's dtype, padded keys masked to -1e30,
// m / l / acc in f32, P rounded to v's dtype before P V and the output in
// q's dtype. When the call is differentiated it also writes the f32
// natural-log log-sum-exp of each row, 2-D (B*H, Sq), the residual that
// K3 / K4 (flash_bwd.cu) read.
//
// What bounds it on the H100: at the global-attention shape (12 heads x 3 888
// tokens) and the other long self-attention rows it is compute bound (4 S^2 D
// flops against a few MB of traffic); at the shape-encoder shape (64 queries x
// 16 384 keys) it is bound by the bytes of K and V, and the grid of one
// 64-query tile per (batch, head) would give 12 blocks for 132 SMs.
//
// What the design does about that: the warp-specialised TMA + wgmma kernel
// of hopper_fwd.cuh, with the keys of calls with few query tiles split
// across blocks and added in split order (split_count in
// ops/flash_attention.py), instantiated here under K1's own tag. The K9
// forward (short_fwd.cu), K2 (folded_fwd.cu) and K7 (masked_flash.cu)
// instantiate the same kernel under their own.

#include "hopper_fwd.cuh"

namespace {
struct k1_flash_fwd {};   // K1's kernels in a profile: fwd_*<..., k1_flash_fwd>
// K1 at head dim 128 (bf16, no LSE): fwd_bf16<..., k1_flash_fwd_d128>
struct k1_flash_fwd_d128 {
  static constexpr int kHeadDim = 128;
};
}  // namespace

// The contract of m324::fwd::fwd_entry (hopper_fwd.cuh): q, k, v, o through
// (batch, head, row) strides, the optional f32 LSE through strides[12..14]
// (the wrapper passes the compact (b*h, sq)), bf16 split-KV with its
// workspace and tickets; returns 0, a CUDA error, or 900 / 901 / 902 /
// 1000 + the tensor-map encoder's error.
extern "C" int m324_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, float* lse, float* part_o,
                              float* part_lse, int* tickets, int n_tickets,
                              int b, int h, int sq, int sk,
                              const long long* strides, int n_split,
                              float scale, int dtype, void* stream) {
  return m324::fwd::fwd_entry<k1_flash_fwd>(q, k, v, o, lse, part_o, part_lse,
                                            tickets, n_tickets, b, h, sq, sk,
                                            strides, n_split, scale, dtype,
                                            stream);
}

// K1 over (B, H, S, 128): the contract of m324_flash_fwd, bf16 without the
// LSE (lse null), else 901.
extern "C" int m324_flash_fwd_d128(const void* q, const void* k, const void* v,
                                   void* o, float* lse, float* part_o,
                                   float* part_lse, int* tickets,
                                   int n_tickets, int b, int h, int sq, int sk,
                                   const long long* strides, int n_split,
                                   float scale, int dtype, void* stream) {
  return m324::fwd::fwd_entry<k1_flash_fwd_d128>(
      q, k, v, o, lse, part_o, part_lse, tickets, n_tickets, b, h, sq, sk,
      strides, n_split, scale, dtype, stream);
}
