// K9 forward: short attention over (B, H, S, 64) for Hopper (sm_90a).
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
// encoder's 64 queries x 16 384 keys. So the keys stream through K1's
// online softmax over 128-key tiles: the same function, with P rounded
// against the running max instead of the final one.
//
// What bounds it on the H100: at the local shape (144 slices x 324^2) and
// the decoder's (144 slices x 162 queries x 64 keys) the bytes of q, k, v
// and o; at the global shape (12 x 3 888^2) the tensor cores; at the shape
// encoder (12 slices x 64 queries x 16 384 keys) the bytes of k and v, with
// one query tile per slice.
//
// What the design does about that: K1's kernel (hopper_fwd.cuh: a TMA
// producer warp feeding 128-key tiles to wgmma consumer warpgroups, q, k,
// v and o through (batch, head, row) strides, so the legacy route's
// (B, S, H, 64) views go in without a copy), instantiated under K9's own
// tag, so a profile tells its launches from K1's. The keys of calls of one
// query tile are split across blocks by K9's rule (short_split_count in
// ops/short_attention.py: the shape encoder's 16 384 keys in 16 ranges) and
// added in split order by the tile's last block; the local rows stay
// unsplit.
//
// The f32 variant runs scalar FMA (attention_common.cuh) and is a checking
// path, not a fast one; it is never split.

#include "hopper_fwd.cuh"

namespace {
struct k9_short_fwd {};   // K9's kernels in a profile: fwd_*<..., k9_short_fwd>
}  // namespace

// The contract of m324::fwd::fwd_entry (hopper_fwd.cuh): q, k, v, o
// (b, h, s, 64) through (batch, head, row) strides, lse null or f32
// through strides[12..14] (the wrapper passes the compact (b*h, sq)), bf16
// split-KV with its workspace and tickets; returns 0, a CUDA error, or
// 900 / 901 / 902 / 1000 + the tensor-map encoder's error.
extern "C" int m324_short_fwd(const void* q, const void* k, const void* v,
                              void* o, float* lse, float* part_o,
                              float* part_lse, int* tickets, int n_tickets,
                              int b, int h, int sq, int sk,
                              const long long* strides, int n_split,
                              float scale, int dtype, void* stream) {
  return m324::fwd::fwd_entry<k9_short_fwd>(q, k, v, o, lse, part_o, part_lse,
                                            tickets, n_tickets, b, h, sq, sk,
                                            strides, n_split, scale, dtype,
                                            stream);
}
