// K9 backward: short attention backward over (B*H, S, 64) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` in motion324_tpu/ops/short_attention.py
// (called from `_short_core_bwd`): dq, dk and dv of the K9 forward
// (short_fwd.cu) for q already multiplied by the logit scale, from the
// compact f32 LSE (B*H, Sq) the forward saved:
//   P = exp(q k^T - lse) in f32,  dV = P^T dO with P rounded to dO's dtype,
//   delta = rowsum(dO * O) in f32 (computed here from O, as the TPU kernel
//   does),  dS = P * (dO V^T - delta) rounded to q's dtype,
//   dQ = dS K,  dK = dS^T q.
// Keys past the KV length and query rows past Sq are masked (P = 0), so no
// padded copy is made in device memory.
//
// The TPU kernel computes dq, dk and dv of whole slices in one grid step,
// with the (Sq, Sk) tiles resident in VMEM and no atomics. No Hopper block
// holds those tiles at the legacy route's shapes (3 888^2, 64 x 16 384), so
// the work is split as K4 splits it (attention_bwd.cuh), in two launches and
// still without atomics:
//  - a dq pass: one block of 4 warps per (slice, 64-query tile) holds its
//    rows' q and dO as register fragments, computes their delta from O, and
//    walks the keys in 64-key tiles, summing dQ in f32 registers;
//  - a dk/dv pass: one block per (slice, 64-key tile) holds its keys' K and
//    V as fragments and their dK / dV sums in f32 registers, and walks the
//    queries in 64-row tiles (delta again from O).
// Chosen over K3/K5's single launch with an f32 atomicAdd dQ workspace:
// every gradient is summed in a fixed order, so a training step is
// repeatable bit for bit, as it is on the TPU; no workspace is allocated
// and no cast launch follows. The cost is that S and dP are computed twice.
//
// What bounds it on the H100: at the global shape (24 x 3 888^2 in
// training) about 2.5 x the forward's 4 S^2 D flops on the tensor cores; at
// the local (288 x 324^2), shape-encoder and decoder shapes the bytes of q,
// k, v, o, dO and the three gradients. Every product runs on the tensor
// cores (mma.sync bf16, f32 accumulation) with its A operand in registers.
// Not yet done: wgmma/TMA, double buffering, one launch for short KV.
//
// The f32 variants run scalar FMA on 32 x 32 tiles and are checking paths,
// not fast ones.

#include "attention_bwd.cuh"

using namespace m324;

// q, o, dout: (bh, sq, 64); k, v: (bh, sk, 64); each with its own slice
// stride (*_bs) and row stride (*_rs) in elements, unit stride within a row,
// rows 16-byte aligned. lse: f32 (bh, sq) contiguous. dq (bh, sq, 64) and
// dk, dv (bh, sk, 64): contiguous, input dtype. dtype: 0 = float32,
// 1 = bfloat16. Launches on `stream`, allocates nothing, does not
// synchronise; returns the first CUDA error seen.
extern "C" int m324_short_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const float* lse, void* dq, void* dk, void* dv,
                              int bh, int sq, int sk, long long q_bs,
                              long long q_rs, long long k_bs, long long k_rs,
                              long long v_bs, long long v_rs, long long o_bs,
                              long long o_rs, long long do_bs, long long do_rs,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.lse = lse; a.delta = nullptr; a.dq_acc = nullptr; a.dq = dq; a.dk = dk;
  a.dv = dv; a.sq = sq; a.sk = sk; a.heads = 1;
  a.q_bs = q_bs; a.q_rs = q_rs; a.k_bs = k_bs; a.k_rs = k_rs;
  a.v_bs = v_bs; a.v_rs = v_rs; a.o_bs = o_bs; a.o_rs = o_rs;
  a.do_bs = do_bs; a.do_rs = do_rs;
  a.l_bs = sq; a.l_rs = 1;
  if (dtype == 1) {
    dim3 grid((sq + kBwdTile - 1) / kBwdTile, 1, bh);
    bwd_dq_bf16<<<grid, kBwdWarps * 32, 0, s>>>(a);
  } else {
    dim3 grid((sq + kST - 1) / kST, 1, bh);
    bwd_dq_f32<true><<<grid, kSThreads, 0, s>>>(a);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_dkv<false>(a, bh, dtype, s);
}
