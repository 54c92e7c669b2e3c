// K3 and K4: flash attention backward for Hopper (sm_90a).
//
// Replace the TPU kernels of motion324_tpu/ops/flash_attention.py:
//  - K3, `_bwd_fused_kernel` (called from `_bwd_fused`): dq, dk and dv in
//    one sweep, taken for KV <= 4096. The TPU kernel carries a full-KV f32
//    dk/dv scratch across a sequential grid. Blocks on Hopper run in
//    parallel and carry nothing, so here one block per (b*h, 64-key tile)
//    holds its keys' dk/dv in f32 registers while it loops over the query
//    tiles, and adds dS K into an f32 dq workspace with atomicAdd; a second
//    launch rounds the workspace to bf16. The atomics sum in an order that
//    changes from run to run.
//  - K4, `_bwd_dq_kernel` + `_bwd_dkv_kernel` (called from `_bwd`): the
//    two-pass backward for KV > 4096: a dq pass (one block per 64-query
//    tile, looping over keys) and a dk/dv pass (one block per 64-key tile,
//    looping over queries), with no atomics.
// Both read q already multiplied by the logit scale (the scale multiply
// stays outside, in q's dtype), the f32 (B*H, Sq) lse saved by the forward
// (flash_fwd.cu) and delta = rowsum(dO * O), computed once outside in f32.
// Ragged query and key tails are masked in the kernels.
//
// What bounds them on the H100: at the training shape (24 x 3 888^2) about
// 2.5 x the forward's 4 S^2 D flops on the tensor cores, so operations; at
// the shape encoder's 64 queries x 4 096 keys, the bytes of k, v, dk, dv.
// What the design does about that: every product runs on the tensor cores
// (mma.sync bf16, f32 accumulation) with its A operand in registers; each
// query tile is read once per key tile through shared memory. Not yet done:
// wgmma/TMA, double buffering, a dq reduction without atomics.
//
// The f32 variants run scalar FMA (attention_bwd.cuh) and are checking
// paths, not fast ones.

#include "attention_bwd.cuh"

using namespace m324;

// q, dout: (B*H, sq, 64); k, v: (B*H, sk, 64); lse, delta: f32 (B*H, sq);
// all contiguous, 16-byte aligned. Outputs dq (B*H, sq, 64), dk, dv
// (B*H, sk, 64) in the input dtype. fused = 1 runs K3 and needs dq_acc, an
// f32 (B*H, sq, 64) workspace set to zero (for float32 pass dq itself);
// fused = 0 runs K4. dtype: 0 = float32, 1 = bfloat16. Launches on
// `stream`, allocates nothing, does not synchronise; returns the first CUDA
// error seen.
extern "C" int m324_flash_bwd(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, float* dq_acc, void* dq,
                              void* dk, void* dv, int bh, int sq, int sk,
                              int dtype, int fused, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.o = nullptr; a.dout = dout;
  a.lse = lse; a.delta = delta; a.dq_acc = dq_acc; a.dq = dq; a.dk = dk;
  a.dv = dv; a.sq = sq; a.sk = sk; a.heads = 1;
  a.q_bs = a.do_bs = (long long)sq * kD;
  a.k_bs = a.v_bs = (long long)sk * kD;
  a.q_rs = a.k_rs = a.v_rs = a.do_rs = kD;
  a.l_bs = sq; a.l_rs = 1;
  if (fused) return launch_dkv<true, false>(a, bh, dtype, s);
  if (dtype == 1) {
    dim3 grid((sq + kBwdTile - 1) / kBwdTile, 1, bh);
    bwd_dq_bf16<<<grid, kBwdWarps * 32, 0, s>>>(a);
  } else {
    dim3 grid((sq + kST - 1) / kST, 1, bh);
    bwd_dq_f32<<<grid, kSThreads, 0, s>>>(a);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_dkv<false, false>(a, bh, dtype, s);
}
