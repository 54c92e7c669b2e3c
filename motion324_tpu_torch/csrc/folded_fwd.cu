// K2: head-folded short attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` in motion324_tpu/ops/folded_attention.py
// (reached through `_call_fwd` and `folded_attention`): attention for short
// sequences read straight from the model-native (B, S, H*64) layout, with no
// transpose on either side, padded keys masked and the logit scale folded
// into q. When the call is differentiated it also writes the f32
// log-sum-exp per row and head, (B, Sq, H), the residual that K5
// (folded_bwd.cu) reads; the DINOv2 calls, which run without gradients,
// pass no lse and write none.
//
// What bounds it on the H100: at its call sites (local frame attention, 324
// tokens; DINOv2, 257; the ShapeVAE's 512 latents; the paint UNet's 256 and
// 384) the work is small, 0.2-3.9 GFLOP against 2-24 MB of q/k/v/o, so it
// is memory bound; the rest is latency: a few hundred blocks of short
// loops.
//
// What the design does about that: K1's kernel (hopper_fwd.cuh: a TMA
// producer warp feeding 128-key tiles to wgmma consumer warpgroups),
// instantiated under K2's own tag, so a profile tells its launches from
// K1's and K9's. q, k and v go in as (B, H, S, 64) views of their
// (B, S, H*64) layout (head stride 64, row stride the view's: 3 H 64 on the
// slices of a fused QKV projection), so no copy is made; the wrapper hands
// an output laid out heads-last, which is the contiguous (B, S, H*64), and
// the LSE's (B, Sq, H) strides (batch Sq H, head 1, row H). The keys of a
// call of one query tile are split by K9's rule (short_split_count in
// ops/short_attention.py), a function of (Sq, Sk) alone: the call sites'
// rows stay unsplit, and a slice's bits do not depend on the batch.
//
// The f32 variant runs scalar FMA (attention_common.cuh) and is a checking
// path, not a fast one; it is never split.

#include "hopper_fwd.cuh"

namespace {
struct k2_folded_fwd {};   // K2's kernels in a profile: fwd_*<..., k2_folded_fwd>
}  // namespace

// The contract of m324::fwd::fwd_entry (hopper_fwd.cuh): q, k, v, o
// (b, h, s, 64) through (batch, head, row) strides, lse null or f32
// through strides[12..14], bf16 split-KV with its workspace and tickets;
// returns 0, a CUDA error, or 900 / 901 / 902 / 1000 + the tensor-map
// encoder's error.
extern "C" int m324_folded_fwd(const void* q, const void* k, const void* v,
                               void* o, float* lse, float* part_o,
                               float* part_lse, int* tickets, int n_tickets,
                               int b, int h, int sq, int sk,
                               const long long* strides, int n_split,
                               float scale, int dtype, void* stream) {
  return m324::fwd::fwd_entry<k2_folded_fwd>(q, k, v, o, lse, part_o,
                                             part_lse, tickets, n_tickets, b,
                                             h, sq, sk, strides, n_split,
                                             scale, dtype, stream);
}
