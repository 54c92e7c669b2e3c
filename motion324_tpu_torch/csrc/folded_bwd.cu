// K5: head-folded short attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` in motion324_tpu/ops/folded_attention.py
// (called from `_folded_core_bwd`): per head, dq, dk and dv of attention over
// the model-native (B, S, H*64) layout from the per-head f32 lse (B, Sq, H)
// saved by the forward (folded_fwd.cu), for q already multiplied by the
// logit scale:
//   P = exp(q k^T - lse) in f32,  dV = P^T dO with P rounded to dO's dtype,
//   delta = rowsum(dO * O) in f32 (computed here from O, as the TPU kernel
//   does),  dS = P * (dO V^T - delta) rounded to q's dtype,
//   dQ = dS K,  dK = dS^T q.
//
// What bounds it on the H100: at the local-attention shape (24 images x 12
// heads x 324^2, the same work as the K9 backward's local row) about 9 GFLOP
// against about 60 MB of q, k, v, o, dO, dq, dk and dv: the bytes.
//
// What the design does about that (bf16): K4's two-pass route of
// hopper_bwd.cuh, instantiated under K5's own tag, as the K9 backward
// (short_bwd.cu) instantiates it: the preprocessing launch (delta from O and
// dO, lse * log2(e) read through the (B, Sq, H) lse's strides), the TMA +
// wgmma dq pass and the TMA + wgmma dk/dv pass, split by K9's rules over
// the B*H slices (folded_bwd_plan in ops/folded_attention.py; the local
// layers run unsplit). q, k, v, o and dO are read through (batch, head,
// row) strides of the folded views (head stride 64, row stride 3 H 64 on
// the fused-QKV slices), and dq, dk, dv are written through the same kind
// of strides straight into contiguous (B, S, H*64), with no permute after.
// No atomics touch the data: a call repeats bit for bit, and a slice's bits
// do not depend on the batch.
//
// The f32 variant runs the scalar checking kernels of attention_bwd.cuh
// (32 x 32 tiles, delta from O, no atomics), not a fast path.

#include "hopper_bwd.cuh"      // the Hopper passes
#include "attention_bwd.cuh"   // the f32 checking kernels

using namespace m324;
using namespace m324::bwd;

namespace {
struct k5_folded_bwd {};   // K5's kernels in a profile
}  // namespace

// q, o, dout: (b, sq, h*64); k, v: (b, sk, h*64); one dtype (0 = float32,
// 1 = bfloat16); q already multiplied by the logit scale. strides[0..26],
// in elements: the (batch, head, row) strides of q, k, v, o, dO (head
// stride 64), of the f32 lse (b, sq, h) and of the outputs dq (b, sq, h*64),
// dk, dv (b, sk, h*64), which the caller allocates; unit stride within a
// row, 16-byte-aligned rows and base. bf16: the dq pass splits the keys
// n_split ways and the dk/dv pass the query tiles dkv_split ways; work
// holds work_floats f32 (two_pass_floats in hopper_bwd.cuh) and tickets
// n_tickets zeroed ints, one per (b*h, tile) of a split pass, which the call
// leaves zeroed. f32: never split, no workspace, outputs contiguous.
// Launches on `stream`, allocates nothing, does not synchronise; returns 0,
// the first CUDA error, 900 when the driver has no cuTensorMapEncodeTiled,
// 901 for an empty split or more than 16 splits, 902 for too few tickets,
// 903 for too small a workspace, or 1000 + the driver's error when a tensor
// map is refused.
extern "C" int m324_folded_bwd(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const float* lse, float* work,
                               long long work_floats, int* tickets,
                               int n_tickets, void* dq, void* dk, void* dv,
                               int b, int h, int sq, int sk,
                               const long long* strides, int n_split,
                               int dkv_split, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* st = strides;
  if (dtype == 1)
    return two_pass_bf16<k5_folded_bwd>(q, k, v, o, dout, lse, work,
                                        work_floats, tickets, n_tickets, dq, dk,
                                        dv, h, sq, sk, Strided{st, b}, n_split,
                                        dkv_split, s);
  BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.lse = lse; a.delta = nullptr; a.dq_acc = nullptr; a.dq = dq; a.dk = dk;
  a.dv = dv; a.sq = sq; a.sk = sk; a.heads = h;
  a.q_bs = st[0]; a.q_rs = st[2]; a.k_bs = st[3]; a.k_rs = st[5];
  a.v_bs = st[6]; a.v_rs = st[8]; a.o_bs = st[9]; a.o_rs = st[11];
  a.do_bs = st[12]; a.do_rs = st[14];
  a.l_bs = (long long)sq * h; a.l_rs = h;
  dim3 grid_q((sq + kST - 1) / kST, h, b);
  bwd_dq_f32<true><<<grid_q, kSThreads, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid_k((sk + kST - 1) / kST, h, b);
  bwd_dkv_f32<false, true><<<grid_k, kSThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
