// K3 and K4: flash attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of motion324_tpu/ops/flash_attention.py:
//  - K3, `_bwd_fused_kernel` (:285, called through `_bwd_fused` at :356):
//    dq, dk and dv in one sweep, taken for KV <= 4096. The TPU kernel
//    carries a full-KV f32 dk/dv scratch across a sequential grid; here
//    blocks run in parallel, so each block owns a key tile and adds its dq
//    partials into an f32 workspace.
//  - K4, `_bwd_dq_kernel` (:221, called at :397) and `_bwd_dkv_kernel`
//    (:252, called at :413): the two-pass backward for KV > 4096, a dq pass
//    over key tiles and a dk/dv pass over query tiles, without atomics.
// All compute, for q already multiplied by the logit scale,
//   P = exp(q k^T - lse), dV = P^T dO, dP = dO V^T, dS = P * (dP - delta),
//   dQ = dS K, dK = dS^T q, delta = rowsum(dO * O),
// with the TPU kernels' rounding: P and dS in f32, P rounded to dO's dtype
// for dV, dS to q's dtype for dQ and dK, f32 sums, outputs in the input
// dtype. exp is taken as exp2 with log2(e) folded into the logits and lse.
//
// What bounds them on the H100: at the training rows (24 x 3 888^2 for K3,
// 12 x 5 184^2 for K4) the tensor cores, 2.5 x the forward's 4 S^2 D flops
// against a few tens of MB; at the shape encoder's rows (64 queries x 4 096
// or 16 384 keys) the bytes of k, v, dk and dv, and with one 64-query tile
// per (batch, head) a dq pass has too few blocks to fill 132 SMs.
//
// What the design does about that (bf16): the passes of hopper_bwd.cuh,
// instantiated under K3 / K4's own tag (the K9 backward, short_bwd.cu,
// instantiates them under its own):
// - K3: the preprocessing launch (delta, lse * log2(e), the f32 dq workspace
//   zeroed), the dk/dv kernel with dQ = dS K added per warp into the
//   workspace by bulk reduce-adds, and a small pass that rounds the
//   workspace to dq in bf16. The order of those sums varies from run to run.
// - K4: the preprocessing launch, the dq pass with its keys split by K1's
//   rule (split_count(Sq, Sk), never B*H) and the partials added in split
//   order by ticket, and the dk/dv pass. No atomics: K4 repeats bit for
//   bit, and a slice's bits do not depend on the batch.
//
// The f32 variants run the scalar kernels of attention_bwd.cuh (delta from
// the same preprocessing kernel) and are checking paths, not fast ones.

#include "hopper_bwd.cuh"      // the Hopper passes
#include "attention_bwd.cuh"   // the f32 checking kernels

using namespace m324;
using namespace m324::bwd;

namespace {

struct k34_flash_bwd {};   // K3 / K4's kernels in a profile

// K3's f32 dq workspace (64 x 64 tiles, each value f of thread t of the
// accumulator at (t / 32, f, t % 32)) -> dq in bf16
__global__ void __launch_bounds__(128)
dq_from_acc(const float* __restrict__ acc, bf16* __restrict__ dq, int sq,
            int sq_pad) {
  const int bh = blockIdx.y, t = threadIdx.x;
  const float* src = acc + ((long long)bh * (sq_pad / 64) + blockIdx.x) * (64 * kD)
                     + (t >> 5) * 1024 + (t & 31);
  float d[32];
#pragma unroll
  for (int f = 0; f < 32; ++f) d[f] = src[f * 32];
  store_acc_bf16(dq + (long long)bh * sq * kD, d, blockIdx.x * 64, sq, t);
}

}  // namespace

// q, o, dout: (bh, sq, 64); k, v: (bh, sk, 64); all contiguous, 16-byte
// aligned, in one dtype (0 = float32, 1 = bfloat16); q already multiplied by
// the logit scale. lse: f32 (bh, sq) from the forward. Outputs dq (bh, sq,
// 64), dk, dv (bh, sk, 64) in the input dtype. fused = 1 runs K3, 0 runs K4.
// work: an f32 workspace of work_floats floats, at least
//   bf16: 2 bh sq_pad + (K3: bh sq_pad 64; K4 split: n_split bh sq_pad 64),
//         sq_pad = sq rounded up to 128;
//   f32:  bh sq.
// bf16 K4 cuts its keys into n_split ranges of whole 128-key tiles (the dq
// pass; 1 for K3 and f32) and then needs n_tickets zeroed ints, at least one
// per (b*h, query tile of 128 rows, 64 when sq <= 64), which it leaves
// zeroed. Launches on `stream`, allocates nothing, does not synchronise;
// returns the first CUDA error, 900 when the driver has no
// cuTensorMapEncodeTiled, 901 for an empty split or more than 16 splits,
// 902 for too few tickets, 903 for too small a workspace, or 1000 + the
// driver's error when a tensor map is refused.
extern "C" int m324_flash_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout, const float* lse,
                              float* work, long long work_floats, int* tickets,
                              int n_tickets, void* dq, void* dk, void* dv,
                              int bh, int sq, int sk, int n_split, int dtype,
                              int fused, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // contiguous (bh, S, 64) inputs as batch 1 of bh heads
  const long long sq_s = (long long)sq * kD, sk_s = (long long)sk * kD;
  const long long st[15] = {bh * sq_s, sq_s, kD, bh * sk_s, sk_s, kD,
                            bh * sk_s, sk_s, kD, bh * sq_s, sq_s, kD,
                            bh * sq_s, sq_s, kD};
  const Strided x{st, 1};
  if (dtype != 1) {
    if (work_floats < (long long)bh * sq) return 903;
    BwdArgs a{};
    a.q = q; a.k = k; a.v = v; a.o = nullptr; a.dout = dout;
    a.lse = lse; a.delta = work; a.dq_acc = fused ? static_cast<float*>(dq) : nullptr;
    a.dq = dq; a.dk = dk; a.dv = dv; a.sq = sq; a.sk = sk; a.heads = 1;
    a.q_bs = a.do_bs = (long long)sq * kD;
    a.k_bs = a.v_bs = (long long)sk * kD;
    a.q_rs = a.k_rs = a.v_rs = a.do_rs = kD;
    a.l_bs = sq; a.l_rs = 1;
    int rc = launch_prep<k34_flash_bwd>(o, dout, lse, nullptr, work, a.dq_acc,
                                        sq, sq, bh, bh, x, 0, s);
    if (rc != 0) return rc;
    if (!fused) {
      dim3 grid((sq + kST - 1) / kST, 1, bh);
      bwd_dq_f32<false><<<grid, kSThreads, 0, s>>>(a);
      rc = static_cast<int>(cudaGetLastError());
      if (rc != 0) return rc;
    }
    dim3 grid((sk + kST - 1) / kST, 1, bh);
    if (fused)
      bwd_dkv_f32<true, false><<<grid, kSThreads, 0, s>>>(a);
    else
      bwd_dkv_f32<false, false><<<grid, kSThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }

  if (!fused)
    return two_pass_bf16<k34_flash_bwd>(q, k, v, o, dout, lse, work, work_floats,
                                        tickets, n_tickets, dq, dk, dv, bh, sq,
                                        sk, x, n_split, 1, s);
  const int sq_pad = (sq + kPadRows - 1) / kPadRows * kPadRows;
  const long long rows = (long long)bh * sq_pad;
  if (work_floats < 2 * rows + rows * kD) return 903;
  BwdHArgs a{};
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.lse2 = work;
  a.delta = work + rows;
  a.dq_acc = work + 2 * rows;
  a.h = bh;
  a.bh = bh;
  a.sq = sq;
  a.sk = sk;
  a.sq_pad = sq_pad;
  a.n_split = 1;
  a.tiles_per_split = (sq + 63) / 64;
  a.dkv_split = 1;
  int rc = launch_prep<k34_flash_bwd>(o, dout, lse, work, work + rows, a.dq_acc,
                                      sq, sq_pad, bh, bh, x, 1, s);
  if (rc != 0) return rc;
  rc = sq <= 64 ? launch_dkv_h<1, true, k34_flash_bwd>(q, k, v, dout, x, a, s)
                : launch_dkv_h<2, true, k34_flash_bwd>(q, k, v, dout, x, a, s);
  if (rc != 0) return rc;
  dim3 grid((sq + 63) / 64, bh);
  dq_from_acc<<<grid, 128, 0, s>>>(a.dq_acc, a.dq, sq, sq_pad);
  return static_cast<int>(cudaGetLastError());
}
