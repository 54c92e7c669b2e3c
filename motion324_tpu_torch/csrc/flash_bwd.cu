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
// What the design does about that (bf16):
// - A preprocessing kernel computes delta in f32 and copies lse * log2(e)
//   into rows padded to 128 (padding: lse +inf, delta 0, so padded query
//   rows get P = 0 with no test in the loops), and for K3 zeroes the f32 dq
//   workspace, all in one launch.
// - The dk/dv kernel (K3, and K4's second pass): one block per (b*h, key
//   tile of 64 keys per consumer warpgroup: 128 keys with two consumers,
//   64 with one when Sq <= 64). K and V stay in shared memory; a producer
//   thread streams 64-query tiles of Q and dO (TMA, 128-byte swizzle) with
//   their lse and delta (bulk copies) through a ring of kQStages mbarrier
//   stages. S^T = K Q^T and dP^T = V dO^T run on wgmma with K and V as A
//   operands held in registers for the whole loop and Q, dO read K-major
//   from shared memory; dV += P^T dO and dK += dS^T Q on wgmma with the A
//   operand from registers (the f32 tile rounded to bf16 in place) and dO, Q
//   read MN-major (the transpose flag). K3 also writes dS^T to shared
//   memory and computes dQ = dS K over its 64 keys on wgmma (both operands
//   MN-major); each warp's share of that 64 x 64 f32 partial leaves the
//   block as one 4 KB bulk reduce-add (cp.reduce.async.bulk .add.f32) into
//   the workspace, whose tiles keep the accumulator's register order, from
//   a double buffer, so no barrier couples the warps or the consumers; a
//   small pass rounds the workspace to dq in bf16. The order of those sums
//   varies from run to run.
// - K4's dq pass: one block per (b*h, query tile of 64 rows per consumer,
//   split). Q, dO, lse and delta stay in shared memory; K and V stream
//   through K1's ring of 128-key TMA tiles, taken in two halves of 64 keys:
//   S = Q K^T and dP = dO V^T on wgmma from shared memory, dS rounded to
//   bf16 in registers, dQ += dS K on wgmma with K MN-major. Calls with few
//   query tiles split their keys by K1's rule (split_count(Sq, Sk), never
//   B*H): each split writes an f32 partial dq, the last block of the tile by
//   ticket adds them in split order and resets its ticket. No atomics: K4
//   repeats bit for bit, and a slice's bits do not depend on the batch.
// - Ragged tails: TMA zero-fills rows past the end; keys past Sk are masked
//   (P = 0) in the one ragged tile, query rows past Sq by the padded lse.
//
// The f32 variants run the scalar kernels of attention_bwd.cuh (delta from
// the same preprocessing kernel) and are checking paths, not fast ones.

#include "hopper.cuh"          // mbarriers, TMA, wgmma, tensor maps
#include "attention_bwd.cuh"   // the f32 checking kernels

using namespace m324;

namespace {

constexpr int kPadRows = 128;       // lse / delta rows padded to this
constexpr int kTileB = 64 * kD * 2; // a 64-row bf16 tile: 8 KB
constexpr int kQStages = 3;         // Q/dO tiles in flight (dk/dv kernel)
constexpr int kKvTile = 128;        // keys per K/V stage (dq pass)
constexpr int kMaxSplits = 16;      // the wrapper's rule keeps to it

struct BwdHArgs {
  bf16* dq;
  bf16* dk;
  bf16* dv;
  const float* lse2;   // (bh, sq_pad): lse * log2(e); +inf past sq
  const float* delta;  // (bh, sq_pad): rowsum(dO * O); 0 past sq
  float* dq_acc;       // K3: (bh, sq_pad / 64) tiles of 64 x 64, fragment order
  float* part;         // K4 split: (n_split, bh, q_tiles, consumers * 4096)
  int* tickets;        // one zeroed int per (b*h, query tile) when split
  int bh, sq, sk, sq_pad, keys_per_split, n_split;
};

// ------------------------------------------------------------ preprocessing
// One row of 64 per 8 threads: delta = rowsum(dO * O) in f32 into
// delta[row]; lse2[row] = lse * log2(e) (when lse2 is given); rows at or
// past sq get delta 0 and lse2 +inf. `stride` rows per (b*h); ws, when
// given, gets its 64 floats of each row zeroed.
template <typename T>
__global__ void __launch_bounds__(256)
bwd_prep(const T* __restrict__ o, const T* __restrict__ dout,
         const float* __restrict__ lse, float* __restrict__ lse2,
         float* __restrict__ delta, float* __restrict__ ws, int sq, int stride,
         long long rows) {
  const long long row = (long long)blockIdx.x * 32 + threadIdx.x / 8;
  const int part = threadIdx.x % 8;
  const bool valid = row < rows;
  const long long bh = valid ? row / stride : 0;
  const int r = valid ? static_cast<int>(row % stride) : 0;
  const bool real = valid && r < sq;
  float acc = 0.f;
  if (real) {
    const long long off = (bh * sq + r) * kD + part * 8;
    if constexpr (sizeof(T) == 2) {
      const uint4 x = *reinterpret_cast<const uint4*>(o + off);
      const uint4 y = *reinterpret_cast<const uint4*>(dout + off);
      const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* yh = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = __bfloat1622float2(xh[i]), b = __bfloat1622float2(yh[i]);
        acc = fmaf(b.x, a.x, acc);
        acc = fmaf(b.y, a.y, acc);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = fmaf(to_f32(dout[off + i]), to_f32(o[off + i]), acc);
    }
  }
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (!valid) return;
  if (part == 0) {
    delta[row] = acc;
    if (lse2 != nullptr)
      lse2[row] = real ? lse[bh * sq + r] * kLog2e : __int_as_float(0x7f800000);
  }
  if (ws != nullptr) {
    float4* w = reinterpret_cast<float4*>(ws + row * kD + part * 8);
    w[0] = make_float4(0.f, 0.f, 0.f, 0.f);
    w[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// ------------------------------------------------------------ dk/dv kernel
// dynamic shared memory, byte offsets from a 1024-byte-aligned base
template <int kC, bool kDq>
struct DkvLayout {
  static constexpr int kKeys = 64 * kC;                    // keys per block
  static constexpr int kK = 0;                             // K, kKeys rows
  static constexpr int kV = kK + kC * kTileB;
  static constexpr int kDs = kV + kC * kTileB;             // dS^T per consumer
  static constexpr int kX = kDs + (kDq ? kC * kTileB : 0); // f32 dq, 2 x 16 KB
  static constexpr int kQ = kX + (kDq ? kC * 2 * 64 * kD * 4 : 0);  // a consumer
  static constexpr int kDo = kQ + kQStages * kTileB;
  static constexpr int kLse = kDo + kQStages * kTileB;     // 64 floats a stage
  static constexpr int kDelta = kLse + kQStages * 256;
  static constexpr int kBar = kDelta + kQStages * 256;     // kv, full[], empty[]
  static constexpr int kAlloc = kBar + 8 * (1 + 2 * kQStages) + 1024;
};

// Store a 64 x 64 f32 accumulator of rows row0 + (16w + g, + 8) below
// `valid` as bf16 rows of 64 (a contiguous (rows, 64) output).
__device__ __forceinline__ void store_acc_bf16(bf16* out, const float (&d)[32],
                                               int row0, int valid, int t) {
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, q4 = lane & 3;
  const int r0 = row0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * q4;
    if (r0 < valid)
      *reinterpret_cast<uint32_t*>(out + (long long)r0 * kD + col) = pack_bf16(d[4 * j], d[4 * j + 1]);
    if (r1 < valid)
      *reinterpret_cast<uint32_t*>(out + (long long)r1 * kD + col) = pack_bf16(d[4 * j + 2], d[4 * j + 3]);
  }
}

// bf16 A fragments of a 64 x 64 f32 accumulator (4 k-steps of 16 columns)
__device__ __forceinline__ void acc_to_frags(uint32_t (&f)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    f[kk][0] = pack_bf16(d[8 * kk], d[8 * kk + 1]);
    f[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    f[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    f[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// One block: kKeys keys of one (batch, head) against all its queries.
// Warpgroup 0 produces; consumer c owns keys key0 + 64c .. + 63.
// Named barrier 1 + c: consumer c.
template <int kC, bool kDq>
__global__ void __launch_bounds__((kC + 1) * 128, kC == 1 ? 2 : 1)
bwd_dkv_hopper(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const BwdHArgs a) {
  using L = DkvLayout<kC, kDq>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t kv_bar = base + L::kBar;
  const uint32_t full_bar = kv_bar + 8;                  // + 8 * stage
  const uint32_t empty_bar = full_bar + 8 * kQStages;    // + 8 * stage

  const int key0 = blockIdx.x * L::kKeys;
  const int bh = blockIdx.y;
  const int n_q = (a.sq + 63) / 64;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kC * 4);   // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_bar, 2 * kC * kTileB);
      tma_load(base + L::kK, &tk, kv_bar, key0, bh, 0);
      tma_load(base + L::kV, &tv, kv_bar, key0, bh, 0);
      const float* lse_row = a.lse2 + (long long)bh * a.sq_pad;
      const float* delta_row = a.delta + (long long)bh * a.sq_pad;
      for (int it = 0; it < n_q; ++it) {
        const int stage = it % kQStages;
        mbar_wait(empty_bar + 8 * stage, ((it / kQStages) & 1) ^ 1);
        const uint32_t bar = full_bar + 8 * stage;
        mbar_expect_tx(bar, 2 * kTileB + 2 * 256);
        tma_load(base + L::kQ + stage * kTileB, &tq, bar, it * 64, bh, 0);
        tma_load(base + L::kDo + stage * kTileB, &tdo, bar, it * 64, bh, 0);
        bulk_load(base + L::kLse + stage * 256, lse_row + it * 64, 256, bar);
        bulk_load(base + L::kDelta + stage * 256, delta_row + it * 64, 256, bar);
      }
    }
    return;
  }

  // ---- consumers ----
  if (kC > 1)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, q4 = lane & 3;
  const uint64_t k_desc = sw128_desc(base + L::kK + c * kTileB);
  // this thread's keys (rows of S^T): kr and kr + 8
  const int kr = key0 + c * 64 + warp * 16 + g;
  const bool tail = key0 + c * 64 + 64 > a.sk;
  const bool ok0 = kr < a.sk, ok1 = kr + 8 < a.sk;

  float dk[32], dv[32], dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

  // K and V as bf16 A fragments, kept in registers for the whole loop
  mbar_wait(kv_bar, 0);
  uint32_t kf[4][4], vf[4][4];
  load_a_frags(kf, smem + L::kK + c * kTileB, t);
  load_a_frags(vf, smem + L::kV + c * kTileB, t);
  for (int it = 0; it < n_q; ++it) {
    const int stage = it % kQStages;
    mbar_wait(full_bar + 8 * stage, (it / kQStages) & 1);
    const uint64_t q_desc = sw128_desc(base + L::kQ + stage * kTileB);
    const uint64_t do_desc = sw128_desc(base + L::kDo + stage * kTileB);

    // S^T = K Q^T and dP^T = V dO^T over the head dim, 4 steps of 16 (Q
    // and dO read K-major)
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_rs_n64<0>(st, kf[ks], q_desc + 2 * ks, ks > 0);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_rs_n64<0>(dpt, vf[ks], do_desc + 2 * ks, ks > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // P^T = exp(S^T - lse) into st, dS^T = P^T (dP^T - delta) into dpt; this
    // thread holds queries 8j + 2 q4 (+1) of keys kr (d[4j], d[4j+1]) and
    // kr + 8 (d[4j+2], d[4j+3])
    const float* lse_s = reinterpret_cast<const float*>(smem + L::kLse + stage * 256);
    const float* dl_s = reinterpret_cast<const float*>(smem + L::kDelta + stage * 256);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * q4);
      const float2 dl = *reinterpret_cast<const float2*>(dl_s + 8 * j + 2 * q4);
      float p0 = fast_exp2(fmaf(st[4 * j], kLog2e, -l.x));
      float p1 = fast_exp2(fmaf(st[4 * j + 1], kLog2e, -l.y));
      float p2 = fast_exp2(fmaf(st[4 * j + 2], kLog2e, -l.x));
      float p3 = fast_exp2(fmaf(st[4 * j + 3], kLog2e, -l.y));
      if (tail) {
        if (!ok0) p0 = p1 = 0.f;
        if (!ok1) p2 = p3 = 0.f;
      }
      st[4 * j] = p0;
      st[4 * j + 1] = p1;
      st[4 * j + 2] = p2;
      st[4 * j + 3] = p3;
      dpt[4 * j] = p0 * (dpt[4 * j] - dl.x);
      dpt[4 * j + 1] = p1 * (dpt[4 * j + 1] - dl.y);
      dpt[4 * j + 2] = p2 * (dpt[4 * j + 2] - dl.x);
      dpt[4 * j + 3] = p3 * (dpt[4 * j + 3] - dl.y);
    }
    uint32_t pf[4][4], dsf[4][4];
    acc_to_frags(pf, st);
    acc_to_frags(dsf, dpt);

    if constexpr (kDq) {
      // dS^T as [key][query] rows of 128 bytes in the 128-byte swizzle:
      // query pair 8j + 2 q4 of row r is 4 bytes at chunk j ^ (r % 8)
      unsigned char* ds = smem + L::kDs + c * kTileB;
      const int r0 = warp * 16 + g;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 2 * kk + half;
          const int off = ((j ^ g) << 4) + 4 * q4;
          *reinterpret_cast<uint32_t*>(ds + r0 * 128 + off) = dsf[kk][2 * half];
          *reinterpret_cast<uint32_t*>(ds + (r0 + 8) * 128 + off) = dsf[kk][2 * half + 1];
        }
      }
      fence_proxy_async();
      bar_sync(1 + c, 128);
    }

    // dV += P^T dO, dK += dS^T Q (16 queries a step: +2 048 bytes); K3:
    // dQ = dS K over this consumer's 64 keys
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64(dv, pf[kk], do_desc + 128 * kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64(dk, dsf[kk], q_desc + 128 * kk);
    if constexpr (kDq) {
      const uint64_t ds_desc = sw128_desc(base + L::kDs + c * kTileB);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64<1, 1>(dq, ds_desc + 128 * kk, k_desc + 128 * kk, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv);
    fence_regs(dk);
    if constexpr (kDq) fence_regs(dq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(pf[kk]);
      fence_regs(dsf[kk]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * stage);

    if constexpr (kDq) {
      // this consumer's 64 x 64 dq partial over its 64 keys: each warp adds
      // its 32 values a thread into the workspace tile as one 4 KB bulk
      // reduce-add (tile layout: warp, value, lane), from one of two
      // buffers; the reduce of two steps back has read this step's buffer
      float* xw = reinterpret_cast<float*>(smem + L::kX)
                  + ((c * 2 + (it & 1)) * 4 + warp) * 1024;
      if (lane == 0 && it >= 2) bulk_wait_read_1();
      __syncwarp();
#pragma unroll
      for (int f = 0; f < 32; ++f) xw[f * 32 + lane] = dq[f];
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        bulk_reduce_add_f32(a.dq_acc + ((long long)bh * (a.sq_pad / 64) + it) * (64 * kD)
                                + warp * 1024, smem_u32(xw), 32 * 32 * 4);
        bulk_commit();
      }
    }
  }
  if constexpr (kDq) {
    if (lane == 0) bulk_wait();
  }

  const int row0 = key0 + c * 64;
  store_acc_bf16(a.dk + (long long)bh * a.sk * kD, dk, row0, a.sk, t);
  store_acc_bf16(a.dv + (long long)bh * a.sk * kD, dv, row0, a.sk, t);
}

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

// ------------------------------------------------------------ K4 dq pass
template <int kC>
struct DqLayout {
  static constexpr int kStages = kC == 1 ? 2 : 3;   // K/V tiles in flight
  static constexpr int kKvB = kKvTile * kD * 2;     // one K or V tile: 16 KB
  static constexpr int kQ = 0;                      // kC 64-row tiles
  static constexpr int kDo = kC * kTileB;
  static constexpr int kK = 2 * kC * kTileB;
  static constexpr int kV = kK + kStages * kKvB;
  static constexpr int kLse = kV + kStages * kKvB;  // 64 floats a consumer
  static constexpr int kDelta = kLse + kC * 256;
  static constexpr int kBar = kDelta + kC * 256;    // q, full[], empty[]
  static constexpr int kFlag = kBar + 8 * (1 + 2 * kStages);
  static constexpr int kAlloc = kFlag + 8 + 1024;
};

// One block: 64 * kC query rows of one (batch, head) over one split of the
// keys. Warpgroup 0 produces, consumer c owns rows q0 + 64c .. + 63.
template <int kC>
__global__ void __launch_bounds__((kC + 1) * 128, kC == 1 ? 2 : 1)
bwd_dq_hopper(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const BwdHArgs a) {
  using L = DqLayout<kC>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t q_bar = base + L::kBar;
  const uint32_t full_bar = q_bar + 8;
  const uint32_t empty_bar = full_bar + 8 * kStages;

  const int q0 = blockIdx.x * 64 * kC;
  const int bh = blockIdx.y, split = blockIdx.z;
  const int kv_begin = split * a.keys_per_split;
  const int kv_end = min(a.sk, kv_begin + a.keys_per_split);
  const int n_tiles = (kv_end - kv_begin + kKvTile - 1) / kKvTile;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kC * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, 2 * kC * kTileB + 2 * kC * 256);
      tma_load(base + L::kQ, &tq, q_bar, q0, bh, 0);
      tma_load(base + L::kDo, &tdo, q_bar, q0, bh, 0);
      const long long row = (long long)bh * a.sq_pad + q0;
      bulk_load(base + L::kLse, a.lse2 + row, kC * 256, q_bar);
      bulk_load(base + L::kDelta, a.delta + row, kC * 256, q_bar);
      for (int it = 0; it < n_tiles; ++it) {
        const int stage = it % kStages;
        mbar_wait(empty_bar + 8 * stage, ((it / kStages) & 1) ^ 1);
        const uint32_t bar = full_bar + 8 * stage;
        mbar_expect_tx(bar, 2 * L::kKvB);
        const int kv0 = kv_begin + it * kKvTile;
        tma_load(base + L::kK + stage * L::kKvB, &tk, bar, kv0, bh, 0);
        tma_load(base + L::kV + stage * L::kKvB, &tv, bar, kv0, bh, 0);
      }
    }
    return;
  }

  if (kC > 1)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, q4 = lane & 3;
  const uint64_t q_desc = sw128_desc(base + L::kQ + c * kTileB);
  const uint64_t do_desc = sw128_desc(base + L::kDo + c * kTileB);

  mbar_wait(q_bar, 0);
  const int rl = c * 64 + warp * 16 + g;   // rows rl and rl + 8 of the tile
  const float* lse_s = reinterpret_cast<const float*>(smem + L::kLse);
  const float* dl_s = reinterpret_cast<const float*>(smem + L::kDelta);
  const float l0 = lse_s[rl], l1 = lse_s[rl + 8];
  const float d0 = dl_s[rl], d1 = dl_s[rl + 8];

  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % kStages;
    mbar_wait(full_bar + 8 * stage, (it / kStages) & 1);
    const int nvalid = kv_end - (kv_begin + it * kKvTile);
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      const int nv = nvalid - 64 * h;   // real keys in this half
      if (nv <= 0) break;
      const uint32_t k_half = base + L::kK + stage * L::kKvB + h * kTileB;
      const uint32_t v_half = base + L::kV + stage * L::kKvB + h * kTileB;
      const uint64_t kd = sw128_desc(k_half), vd = sw128_desc(v_half);
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss_n64<0, 0>(s, q_desc + 2 * ks, kd + 2 * ks, ks > 0);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss_n64<0, 0>(dp, do_desc + 2 * ks, vd + 2 * ks, ks > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);
      // dS = P (dP - delta), P = exp(S - lse); this thread holds keys
      // 8j + 2 q4 (+1) of rows rl (d[4j], d[4j+1]) and rl + 8
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p0 = fast_exp2(fmaf(s[4 * j], kLog2e, -l0));
        float p1 = fast_exp2(fmaf(s[4 * j + 1], kLog2e, -l0));
        float p2 = fast_exp2(fmaf(s[4 * j + 2], kLog2e, -l1));
        float p3 = fast_exp2(fmaf(s[4 * j + 3], kLog2e, -l1));
        if (nv < 64) {
          const int key = 8 * j + 2 * q4;
          if (key >= nv) p0 = p2 = 0.f;
          if (key + 1 >= nv) p1 = p3 = 0.f;
        }
        s[4 * j] = p0 * (dp[4 * j] - d0);
        s[4 * j + 1] = p1 * (dp[4 * j + 1] - d0);
        s[4 * j + 2] = p2 * (dp[4 * j + 2] - d1);
        s[4 * j + 3] = p3 * (dp[4 * j + 3] - d1);
      }
      uint32_t dsf[4][4];
      acc_to_frags(dsf, s);
      // dQ += dS K (16 keys a step: +2 048 bytes, K read MN-major)
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64(dq, dsf[kk], kd + 128 * kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(dsf[kk]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * stage);
  }

  bf16* dqb = a.dq + (long long)bh * a.sq * kD;
  if (a.n_split == 1) {
    store_acc_bf16(dqb, dq, q0 + c * 64, a.sq, t);
    return;
  }
  // split: this block's f32 partial in fragment order; the last block of the
  // tile (by ticket) adds the n_split partials in split order
  const int q_tiles = gridDim.x;
  const long long tile_floats = (long long)kC * 64 * kD;
  const long long split_floats = (long long)a.bh * q_tiles * tile_floats;
  const long long mine = ((long long)bh * q_tiles + blockIdx.x) * tile_floats + c * 64 * kD + t;
  float* pb = a.part + split * split_floats + mine;
#pragma unroll
  for (int f = 0; f < 32; ++f) pb[f * 128] = dq[f];
  __threadfence();
  bar_sync(3, kC * 128);
  int* flag = reinterpret_cast<int*>(smem + L::kFlag);
  const int tile = bh * q_tiles + blockIdx.x;
  if (c == 0 && t == 0) *flag = atomicAdd(a.tickets + tile, 1) == a.n_split - 1;
  bar_sync(3, kC * 128);
  if (*flag) {
    __threadfence();
    float sum[32];
#pragma unroll
    for (int f = 0; f < 32; ++f) sum[f] = 0.f;
    for (int i = 0; i < a.n_split; ++i) {
      const float* ps = a.part + i * split_floats + mine;
#pragma unroll
      for (int f = 0; f < 32; ++f) sum[f] += __ldcg(ps + f * 128);
    }
    store_acc_bf16(dqb, sum, q0 + c * 64, a.sq, t);
    if (c == 0 && t == 0) a.tickets[tile] = 0;   // ready for the next call
  }
}

// ------------------------------------------------------------ launches
// (bh, rows, 64) contiguous bf16 as a (64, rows, bh, 1) tensor map
int map_rows(CUtensorMap* m, const void* p, int rows, int bh, int box) {
  const long long rs = kD, hs = (long long)rows * kD;
  return make_map(m, p, rows, bh, 1, hs * bh, hs, rs, box);
}

template <typename K>
int set_smem(K kernel, int bytes, bool& done) {
  if (done) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  done = true;   // once per process (one device)
  return 0;
}

template <int kC, bool kDq>
int launch_dkv_h(const void* q, const void* k, const void* v, const void* dout,
                 const BwdHArgs& a, cudaStream_t s) {
  using L = DkvLayout<kC, kDq>;
  CUtensorMap tq, tdo, tk, tv;
  int rc = map_rows(&tq, q, a.sq, a.bh, 64);
  if (rc == 0) rc = map_rows(&tdo, dout, a.sq, a.bh, 64);
  if (rc == 0) rc = map_rows(&tk, k, a.sk, a.bh, L::kKeys);
  if (rc == 0) rc = map_rows(&tv, v, a.sk, a.bh, L::kKeys);
  static bool smem_set = false;
  if (rc == 0) rc = set_smem(bwd_dkv_hopper<kC, kDq>, L::kAlloc, smem_set);
  if (rc != 0) return rc;
  dim3 grid((a.sk + L::kKeys - 1) / L::kKeys, a.bh);
  bwd_dkv_hopper<kC, kDq><<<grid, (kC + 1) * 128, L::kAlloc, s>>>(tq, tdo, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

template <int kC>
int launch_dq_h(const void* q, const void* k, const void* v, const void* dout,
                const BwdHArgs& a, cudaStream_t s) {
  using L = DqLayout<kC>;
  CUtensorMap tq, tdo, tk, tv;
  int rc = map_rows(&tq, q, a.sq, a.bh, 64 * kC);
  if (rc == 0) rc = map_rows(&tdo, dout, a.sq, a.bh, 64 * kC);
  if (rc == 0) rc = map_rows(&tk, k, a.sk, a.bh, kKvTile);
  if (rc == 0) rc = map_rows(&tv, v, a.sk, a.bh, kKvTile);
  static bool smem_set = false;
  if (rc == 0) rc = set_smem(bwd_dq_hopper<kC>, L::kAlloc, smem_set);
  if (rc != 0) return rc;
  dim3 grid((a.sq + 64 * kC - 1) / (64 * kC), a.bh, a.n_split);
  bwd_dq_hopper<kC><<<grid, (kC + 1) * 128, L::kAlloc, s>>>(tq, tdo, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

int launch_prep(const void* o, const void* dout, const float* lse, float* lse2,
                float* delta, float* ws, int sq, int stride, int bh, int dtype,
                cudaStream_t s) {
  const long long rows = (long long)bh * stride;
  const unsigned blocks = static_cast<unsigned>((rows + 31) / 32);
  if (dtype == 1)
    bwd_prep<bf16><<<blocks, 256, 0, s>>>(static_cast<const bf16*>(o),
        static_cast<const bf16*>(dout), lse, lse2, delta, ws, sq, stride, rows);
  else
    bwd_prep<float><<<blocks, 256, 0, s>>>(static_cast<const float*>(o),
        static_cast<const float*>(dout), lse, lse2, delta, ws, sq, stride, rows);
  return static_cast<int>(cudaGetLastError());
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
    int rc = launch_prep(o, dout, lse, nullptr, work, a.dq_acc, sq, sq, bh, 0, s);
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

  const int sq_pad = (sq + kPadRows - 1) / kPadRows * kPadRows;
  const long long rows = (long long)bh * sq_pad;
  const int kv_tiles = (sk + kKvTile - 1) / kKvTile;
  if (fused) n_split = 1;
  if (n_split < 1 || n_split > kv_tiles || n_split > kMaxSplits) return 901;
  long long need = 2 * rows;
  if (fused) need += rows * kD;
  else if (n_split > 1) need += n_split * rows * kD;
  if (work_floats < need) return 903;
  BwdHArgs a{};
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.lse2 = work;
  a.delta = work + rows;
  a.dq_acc = fused ? work + 2 * rows : nullptr;
  a.part = (!fused && n_split > 1) ? work + 2 * rows : nullptr;
  a.tickets = tickets;
  a.bh = bh;
  a.sq = sq;
  a.sk = sk;
  a.sq_pad = sq_pad;
  a.keys_per_split = (kv_tiles + n_split - 1) / n_split * kKvTile;
  a.n_split = n_split;
  // every split must hold keys: the wrapper's rule guarantees it
  if ((long long)(n_split - 1) * a.keys_per_split >= sk) return 901;
  const int q_rows = sq <= 64 ? 64 : 128;
  if (n_split > 1 && (long long)(sq + q_rows - 1) / q_rows * bh > n_tickets)
    return 902;

  int rc = launch_prep(o, dout, lse, work, work + rows, a.dq_acc, sq, sq_pad,
                       bh, 1, s);
  if (rc != 0) return rc;
  if (fused) {
    rc = sq <= 64 ? launch_dkv_h<1, true>(q, k, v, dout, a, s)
                  : launch_dkv_h<2, true>(q, k, v, dout, a, s);
    if (rc != 0) return rc;
    dim3 grid((sq + 63) / 64, bh);
    dq_from_acc<<<grid, 128, 0, s>>>(a.dq_acc, a.dq, sq, sq_pad);
    return static_cast<int>(cudaGetLastError());
  }
  rc = sq <= 64 ? launch_dq_h<1>(q, k, v, dout, a, s)
                : launch_dq_h<2>(q, k, v, dout, a, s);
  if (rc != 0) return rc;
  return sq <= 64 ? launch_dkv_h<1, false>(q, k, v, dout, a, s)
                  : launch_dkv_h<2, false>(q, k, v, dout, a, s);
}
