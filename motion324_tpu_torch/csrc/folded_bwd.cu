// K5: head-folded short attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` in motion324_tpu/ops/folded_attention.py
// (called from `_folded_core_bwd`): per head, dq, dk and dv of attention over
// the model-native (B, S, H*64) layout from the per-head f32 lse (B, Sq, H)
// saved by the forward (folded_fwd.cu). Unlike K3, delta = rowsum(dO * O) is
// computed inside the kernel from O, as the TPU kernel does.
//
// q, k, v, o and dO are read through their batch and row strides, so the
// q/k/v views of the fused QKV projection go in without a copy; dq, dk and
// dv are written as contiguous (B, S, H*64) tensors.
//
// What bounds it on the H100: at the local-attention shape (24 images x 12
// heads x 324^2) the work is about 9 GFLOP against about 60 MB of q, k, v,
// o, dO, dq, dk, dv, so memory.
// What the design does about that: one block of 4 warps per (image, head,
// 64-key tile) keeps that tile's K and V as register fragments and its dk/dv
// sums in f32 registers, and walks the head's queries in 64-row tiles
// through shared memory (attention_bwd.cuh, the kernel K3 uses, with the
// strides and the in-kernel delta); dq is summed over the key tiles with
// f32 atomicAdd into a workspace and rounded to bf16 by a second launch. The
// TPU kernel keeps the whole KV of a head resident instead; with 6 key
// tiles per head here, each query tile is read 6 times, mostly from L2.
//
// The f32 variant runs scalar FMA and is a checking path, not a fast one.

#include "attention_bwd.cuh"

using namespace m324;

// q (B, sq, H*64), k, v (B, sk, H*64), o and dout (B, sq, H*64): each with its
// own batch stride (*_bs) and row stride (*_rs) in elements, unit stride
// within a row, rows 16-byte aligned. lse: f32 (B, sq, H) contiguous.
// dq_acc: f32 (B, sq, H*64) set to zero (for float32 pass dq itself). dq
// (B, sq, H*64) and dk, dv (B, sk, H*64): contiguous, input dtype. dtype:
// 0 = float32, 1 = bfloat16. Launches on `stream`, allocates nothing, does
// not synchronise; returns the first CUDA error seen.
extern "C" int m324_folded_bwd(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const float* lse, float* dq_acc, void* dq,
                               void* dk, void* dv, int batch, int heads,
                               int sq, int sk, long long q_bs, long long q_rs,
                               long long k_bs, long long k_rs, long long v_bs,
                               long long v_rs, long long o_bs, long long o_rs,
                               long long do_bs, long long do_rs, int dtype,
                               void* stream) {
  BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.lse = lse; a.delta = nullptr; a.dq_acc = dq_acc; a.dq = dq; a.dk = dk;
  a.dv = dv; a.sq = sq; a.sk = sk; a.heads = heads;
  a.q_bs = q_bs; a.q_rs = q_rs; a.k_bs = k_bs; a.k_rs = k_rs;
  a.v_bs = v_bs; a.v_rs = v_rs; a.o_bs = o_bs; a.o_rs = o_rs;
  a.do_bs = do_bs; a.do_rs = do_rs;
  a.l_bs = (long long)sq * heads; a.l_rs = heads;
  return launch_dkv(a, batch, dtype, static_cast<cudaStream_t>(stream));
}
