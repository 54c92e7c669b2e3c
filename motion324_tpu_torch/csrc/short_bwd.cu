// K9 backward: short attention backward over (B, H, S, 64) for Hopper
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
// the work is split as K4 splits it, in passes without atomics on the data,
// so that a training step repeats bit for bit, as it does on the TPU.
//
// What bounds it on the H100: at the global shape (24 x 3 888^2 in
// training) about 2.5 x the forward's 4 S^2 D flops on the tensor cores; at
// the local (288 x 324^2), shape-encoder (24 x 64 x 4 096) and decoder
// (288 x 4 096 x 64) shapes the bytes of q, k, v, o, dO and the three
// gradients.
//
// What the design does about that (bf16): K4's two-pass route of
// hopper_bwd.cuh, instantiated under K9's own tag: the preprocessing launch
// (delta from O and dO, lse * log2(e)), the TMA + wgmma dq pass with its
// keys split by K9's forward rule (short_split_count: the shape encoder's
// 16 ranges) and the TMA + wgmma dk/dv pass, whose query tiles are split by
// short_dkv_split_count (ops/short_attention.py) when many query tiles meet
// few key tiles: the decoder's 4 096 points over 64 mesh tokens give one
// 64-key block per slice, 288 blocks that each walk 64 query tiles, cut
// into 2 ranges of 32 tiles (more ranges cost more in f32 partials than
// they gain in blocks). Both splits add their f32 partials in split order
// by ticket. q, k, v, o and dO are read through (batch, head, row)
// strides, so the legacy route's (B, S, H, 64) views go in without a copy.
// Chosen over K3's single launch, whose dq sums arrive in a varying order.
//
// The f32 variants run scalar FMA on 32 x 32 tiles (attention_bwd.cuh,
// delta from O) and are checking paths, not fast ones.

#include "hopper_bwd.cuh"      // the Hopper passes
#include "attention_bwd.cuh"   // the f32 checking kernels

using namespace m324;
using namespace m324::bwd;

namespace {
struct k9_short_bwd {};   // K9's kernels in a profile
}  // namespace

// q, o, dout: (b, h, sq, 64); k, v: (b, h, sk, 64); each through its
// (batch, head, row) strides in elements (strides[0..14]: q, k, v, o, dO),
// unit stride within a row, 16-byte-aligned rows and base; one dtype
// (0 = float32, 1 = bfloat16); q already multiplied by the logit scale.
// lse: f32 (b*h, sq) contiguous. Outputs dq (b*h, sq, 64), dk, dv
// (b*h, sk, 64), contiguous, in the input dtype.
// bf16: the dq pass splits the keys n_split ways (whole 128-key tiles) and
// the dk/dv pass the query tiles dkv_split ways (whole 64-row tiles); work
// holds work_floats f32 (two_pass_floats in hopper_bwd.cuh) and tickets
// n_tickets zeroed ints, one per (b*h, tile) of a split pass, which the
// call leaves zeroed. f32: never split, no workspace; b must be 1 (the
// slices flattened into heads).
// Launches on `stream`, allocates nothing, does not synchronise; returns 0,
// the first CUDA error, 900 when the driver has no cuTensorMapEncodeTiled,
// 901 for an empty split or more than 16 splits, 902 for too few tickets,
// 903 for too small a workspace, 904 for an f32 call with b > 1, or 1000 +
// the driver's error when a tensor map is refused.
extern "C" int m324_short_bwd(const void* q, const void* k, const void* v,
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
    return two_pass_bf16<k9_short_bwd>(q, k, v, o, dout, lse, work, work_floats,
                                       tickets, n_tickets, dq, dk, dv, h, sq,
                                       sk, Strided{st, b}, n_split, dkv_split,
                                       s);
  if (b != 1) return 904;
  BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.lse = lse; a.delta = nullptr; a.dq_acc = nullptr; a.dq = dq; a.dk = dk;
  a.dv = dv; a.sq = sq; a.sk = sk; a.heads = 1;
  a.q_bs = st[1]; a.q_rs = st[2]; a.k_bs = st[4]; a.k_rs = st[5];
  a.v_bs = st[7]; a.v_rs = st[8]; a.o_bs = st[10]; a.o_rs = st[11];
  a.do_bs = st[13]; a.do_rs = st[14];
  a.l_bs = sq; a.l_rs = 1;
  dim3 grid_q((sq + kST - 1) / kST, 1, h);
  bwd_dq_f32<true><<<grid_q, kSThreads, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid_k((sk + kST - 1) / kST, 1, h);
  bwd_dkv_f32<false, true><<<grid_k, kSThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
