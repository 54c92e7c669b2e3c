// The Hopper (sm_90a) attention backward passes shared by K3 / K4
// (flash_bwd.cu), K5 (folded_bwd.cu) and the K9 backward (short_bwd.cu).
// All compute, for q
// already multiplied by the logit scale,
//   P = exp(q k^T - lse), dV = P^T dO, dP = dO V^T, dS = P * (dP - delta),
//   dQ = dS K, dK = dS^T q, delta = rowsum(dO * O),
// with the TPU kernels' rounding: P and dS in f32, P rounded to dO's dtype
// for dV, dS to q's dtype for dQ and dK, f32 sums, outputs in the input
// dtype. exp is taken as exp2 with log2(e) folded into the logits and lse.
// Each library instantiates the kernels with a tag type of its own, so that
// a profile tells K4's launches from K5's and K9's.
//
// The passes (bf16):
// - bwd_prep computes delta in f32 and copies lse * log2(e) into rows padded
//   to 128 (padding: lse +inf, delta 0, so padded query rows get P = 0 with
//   no test in the loops), and for K3 zeroes the f32 dq workspace, all in
//   one launch. It reads O, dO and the LSE through (batch, head, row)
//   strides (the LSE: K3 / K4 / K9's compact (B*H, Sq), K5's (B, Sq, H)).
// - bwd_dkv_hopper: one block per (b*h, key tile of 64 keys per consumer
//   warpgroup: 128 keys with two consumers, 64 with one when Sq <= 64 or
//   Sk <= 64, query split). K and V stay in shared memory; a producer
//   thread streams 64-query tiles of Q and dO (TMA, 128-byte swizzle) with
//   their lse and delta (bulk copies) through a ring of kQStages mbarrier
//   stages. S^T = K Q^T and dP^T = V dO^T run on wgmma with K and V as A
//   operands held in registers for the whole loop and Q, dO read K-major
//   from shared memory; dV += P^T dO and dK += dS^T Q on wgmma with the A
//   operand from registers (the f32 tile rounded to bf16 in place) and dO, Q
//   read MN-major (the transpose flag). K3 (kDq) also writes dS^T to shared
//   memory and computes dQ = dS K over its 64 keys on wgmma (both operands
//   MN-major); each warp's share of that 64 x 64 f32 partial leaves the
//   block as one 4 KB bulk reduce-add (cp.reduce.async.bulk .add.f32) into
//   the workspace, whose tiles keep the accumulator's register order, from
//   a double buffer, so no barrier couples the warps or the consumers. The
//   order of those sums varies from run to run.
//   Query split (dkv_split > 1, never with kDq): calls with many query
//   tiles over few key tiles (the motion decoder's 4 096 points over 64
//   mesh tokens) cut their query tiles into dkv_split contiguous ranges,
//   each a block of its own; each block writes its f32 partial dK and dV in
//   fragment order, and the last block of the key tile, by ticket, adds the
//   partials in split order, rounds, stores and resets its ticket.
// - bwd_dq_hopper: one block per (b*h, query tile of 64 rows per consumer:
//   128 rows with two consumers, 64 with one when Sq <= 64 or Sk <= 64,
//   key split). Q, dO, lse and delta stay in shared memory; K and V stream
//   through K1's ring of 128-key TMA tiles, taken in two halves of 64 keys:
//   S = Q K^T and dP = dO V^T on wgmma from shared memory, dS rounded to
//   bf16 in registers, dQ += dS K on wgmma with K MN-major. Calls with few
//   query tiles split their keys (the wrappers' rules are functions of
//   (Sq, Sk) alone, never of B*H): each split writes an f32 partial dq, the
//   last block of the tile by ticket adds them in split order and resets
//   its ticket.
// Neither split uses atomics on the data: the two-pass route repeats bit
// for bit, and a slice's bits do not depend on the batch.
// - Q, K, V and dO are read through tensor maps built from (batch, head,
//   row) strides; dq, dk and dv are written through (batch, head, row)
//   strides too (K3 / K4 / K9: contiguous (B, H, S, 64); K5: contiguous
//   (B, S, H*64), with no permute afterwards).
// - Ragged tails: TMA zero-fills rows past the end; keys past Sk are masked
//   (P = 0) in the one ragged tile, query rows past Sq by the padded lse.

#pragma once

#include "hopper.cuh"   // mbarriers, TMA, wgmma, tensor maps

namespace m324 {
namespace bwd {

constexpr int kPadRows = 128;       // lse / delta rows padded to this
constexpr int kTileB = 64 * kD * 2; // a 64-row bf16 tile: 8 KB
constexpr int kQStages = 3;         // Q/dO tiles in flight (dk/dv kernel)
constexpr int kKvTile = 128;        // keys per K/V stage (dq pass)
constexpr int kMaxSplits = 16;      // the wrappers' rules keep to it

struct BwdHArgs {
  bf16* dq;            // each through its (batch, head, row) strides
  bf16* dk;
  bf16* dv;
  long long dq_bs, dq_hs, dq_rs, dk_bs, dk_hs, dk_rs, dv_bs, dv_hs, dv_rs;
  const float* lse2;   // (bh, sq_pad): lse * log2(e); +inf past sq
  const float* delta;  // (bh, sq_pad): rowsum(dO * O); 0 past sq
  float* dq_acc;       // K3: (bh, sq_pad / 64) tiles of 64 x 64, fragment order
  float* part;         // dq split: (n_split, bh, q_tiles, consumers * 4096)
  float* part_kv;      // dk/dv split: (dkv_split, bh, key tiles, consumers * 8192)
  int* tickets;        // zeroed ints, one per (b*h, tile) of a split pass
  int h;               // slice bh is (batch bh / h, head bh % h) in the maps
  int bh, sq, sk, sq_pad, keys_per_split, n_split, tiles_per_split, dkv_split;
};

// ------------------------------------------------------------ preprocessing
// One row of 64 per 8 threads: delta = rowsum(dO * O) in f32 into
// delta[row]; lse2[row] = lse * log2(e) (when lse2 is given); rows at or
// past sq get delta 0 and lse2 +inf. `stride` rows per (b*h); ws, when
// given, gets its 64 floats of each row zeroed. O, dO and lse are read
// through their (batch, head, row) strides, slice bh being (bh / h, bh % h).
template <typename T, typename Tag>
__global__ void __launch_bounds__(256)
bwd_prep(const T* __restrict__ o, const T* __restrict__ dout,
         const float* __restrict__ lse, float* __restrict__ lse2,
         float* __restrict__ delta, float* __restrict__ ws, int sq, int stride,
         long long rows, int h, long long o_bs, long long o_hs, long long o_rs,
         long long do_bs, long long do_hs, long long do_rs, long long l_bs,
         long long l_hs, long long l_rs) {
  const long long row = (long long)blockIdx.x * 32 + threadIdx.x / 8;
  const int part = threadIdx.x % 8;
  const bool valid = row < rows;
  const long long bh = valid ? row / stride : 0;
  const int r = valid ? static_cast<int>(row % stride) : 0;
  const bool real = valid && r < sq;
  const long long batch = bh / h, head = bh % h;
  float acc = 0.f;
  if (real) {
    const T* orow = o + batch * o_bs + head * o_hs + r * o_rs + part * 8;
    const T* drow = dout + batch * do_bs + head * do_hs + r * do_rs + part * 8;
    if constexpr (sizeof(T) == 2) {
      const uint4 x = *reinterpret_cast<const uint4*>(orow);
      const uint4 y = *reinterpret_cast<const uint4*>(drow);
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
      for (int i = 0; i < 8; ++i) acc = fmaf(drow[i], orow[i], acc);
    }
  }
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (!valid) return;
  if (part == 0) {
    delta[row] = acc;
    if (lse2 != nullptr)
      lse2[row] = real ? lse[batch * l_bs + head * l_hs + r * l_rs] * kLog2e
                       : __int_as_float(0x7f800000);
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
  static constexpr int kFlag = kBar + 8 * (1 + 2 * kQStages);   // last split?
  static constexpr int kAlloc = kFlag + 8 + 1024;
};

// Store a 64 x 64 f32 accumulator of rows row0 + (16w + g, + 8) below
// `valid` as bf16 rows of 64, `rs` elements apart.
__device__ __forceinline__ void store_acc_bf16(bf16* out, long long rs,
                                               const float (&d)[32], int row0,
                                               int valid, int t) {
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, q4 = lane & 3;
  const int r0 = row0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * q4;
    if (r0 < valid)
      *reinterpret_cast<uint32_t*>(out + r0 * rs + col) = pack_bf16(d[4 * j], d[4 * j + 1]);
    if (r1 < valid)
      *reinterpret_cast<uint32_t*>(out + r1 * rs + col) = pack_bf16(d[4 * j + 2], d[4 * j + 3]);
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

// One block: kKeys keys of one (batch, head) against the query tiles of its
// split (all of them when dkv_split is 1). Warpgroup 0 produces; consumer c
// owns keys key0 + 64c .. + 63. Named barrier 1 + c: consumer c; 3: all
// consumers.
template <int kC, bool kDq, typename Tag>
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
  const int bh = blockIdx.y, batch = bh / a.h, head = bh % a.h;
  const int q_first = blockIdx.z * a.tiles_per_split;   // this split's tiles
  const int n_q = min((a.sq + 63) / 64 - q_first, a.tiles_per_split);

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
      tma_load(base + L::kK, &tk, kv_bar, key0, head, batch);
      tma_load(base + L::kV, &tv, kv_bar, key0, head, batch);
      const long long row = (long long)bh * a.sq_pad + q_first * 64;
      for (int it = 0; it < n_q; ++it) {
        const int stage = it % kQStages;
        mbar_wait(empty_bar + 8 * stage, ((it / kQStages) & 1) ^ 1);
        const uint32_t bar = full_bar + 8 * stage;
        mbar_expect_tx(bar, 2 * kTileB + 2 * 256);
        const int q0 = (q_first + it) * 64;
        tma_load(base + L::kQ + stage * kTileB, &tq, bar, q0, head, batch);
        tma_load(base + L::kDo + stage * kTileB, &tdo, bar, q0, head, batch);
        bulk_load(base + L::kLse + stage * 256, a.lse2 + row + it * 64, 256, bar);
        bulk_load(base + L::kDelta + stage * 256, a.delta + row + it * 64, 256, bar);
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
        bulk_reduce_add_f32(a.dq_acc + ((long long)bh * (a.sq_pad / 64) + q_first + it) * (64 * kD)
                                + warp * 1024, smem_u32(xw), 32 * 32 * 4);
        bulk_commit();
      }
    }
  }
  if constexpr (kDq) {
    if (lane == 0) bulk_wait();
  }

  const int row0 = key0 + c * 64;
  bf16* dkb = a.dk + batch * a.dk_bs + head * a.dk_hs;
  bf16* dvb = a.dv + batch * a.dv_bs + head * a.dv_hs;
  if (a.dkv_split == 1) {
    store_acc_bf16(dkb, a.dk_rs, dk, row0, a.sk, t);
    store_acc_bf16(dvb, a.dv_rs, dv, row0, a.sk, t);
    return;
  }
  // query split: this block's f32 partial dK and dV in fragment order; the
  // last block of the key tile (by ticket) adds the dkv_split partials in
  // split order
  const long long blk_floats = (long long)kC * 2 * 64 * kD;
  const long long split_floats = (long long)a.bh * gridDim.x * blk_floats;
  const long long mine = ((long long)bh * gridDim.x + blockIdx.x) * blk_floats
                         + c * 2 * 64 * kD + t;
  float* pb = a.part_kv + blockIdx.z * split_floats + mine;
#pragma unroll
  for (int f = 0; f < 32; ++f) {
    pb[f * 128] = dk[f];
    pb[64 * kD + f * 128] = dv[f];
  }
  __threadfence();
  bar_sync(3, kC * 128);
  int* flag = reinterpret_cast<int*>(smem + L::kFlag);
  const int tile = bh * gridDim.x + blockIdx.x;
  if (c == 0 && t == 0) *flag = atomicAdd(a.tickets + tile, 1) == a.dkv_split - 1;
  bar_sync(3, kC * 128);
  if (*flag) {
    __threadfence();
#pragma unroll
    for (int f = 0; f < 32; ++f) dk[f] = dv[f] = 0.f;
    for (int i = 0; i < a.dkv_split; ++i) {
      const float* ps = a.part_kv + i * split_floats + mine;
#pragma unroll
      for (int f = 0; f < 32; ++f) {
        dk[f] += __ldcg(ps + f * 128);
        dv[f] += __ldcg(ps + 64 * kD + f * 128);
      }
    }
    store_acc_bf16(dkb, a.dk_rs, dk, row0, a.sk, t);
    store_acc_bf16(dvb, a.dv_rs, dv, row0, a.sk, t);
    if (c == 0 && t == 0) a.tickets[tile] = 0;   // ready for the next call
  }
}

// ------------------------------------------------------------ dq pass
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
template <int kC, typename Tag>
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
  const int bh = blockIdx.y, batch = bh / a.h, head = bh % a.h;
  const int split = blockIdx.z;
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
      tma_load(base + L::kQ, &tq, q_bar, q0, head, batch);
      tma_load(base + L::kDo, &tdo, q_bar, q0, head, batch);
      const long long row = (long long)bh * a.sq_pad + q0;
      bulk_load(base + L::kLse, a.lse2 + row, kC * 256, q_bar);
      bulk_load(base + L::kDelta, a.delta + row, kC * 256, q_bar);
      for (int it = 0; it < n_tiles; ++it) {
        const int stage = it % kStages;
        mbar_wait(empty_bar + 8 * stage, ((it / kStages) & 1) ^ 1);
        const uint32_t bar = full_bar + 8 * stage;
        mbar_expect_tx(bar, 2 * L::kKvB);
        const int kv0 = kv_begin + it * kKvTile;
        tma_load(base + L::kK + stage * L::kKvB, &tk, bar, kv0, head, batch);
        tma_load(base + L::kV + stage * L::kKvB, &tv, bar, kv0, head, batch);
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

  bf16* dqb = a.dq + batch * a.dq_bs + head * a.dq_hs;
  if (a.n_split == 1) {
    store_acc_bf16(dqb, a.dq_rs, dq, q0 + c * 64, a.sq, t);
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
    store_acc_bf16(dqb, a.dq_rs, sum, q0 + c * 64, a.sq, t);
    if (c == 0 && t == 0) a.tickets[tile] = 0;   // ready for the next call
  }
}

// ------------------------------------------------------------ launches
// The (batch, head, row) strides in elements of the five inputs q, k, v, o,
// dO, then of the f32 lse and of the three outputs dq, dk, dv (st[3 i ..
// 3 i + 2] for tensor i of those nine), and the batch b.
struct Strided {
  const long long* st;
  int b;
};

template <typename K>
int set_smem(K kernel, int bytes, bool& done) {
  if (done) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  done = true;   // once per process (one device)
  return 0;
}

// input i of `x` as a (64, rows, h, b) tensor map with a box of `box` rows
inline int map_input(CUtensorMap* m, const void* p, const Strided& x, int i,
                     int rows, int h, int box) {
  const long long* s = x.st + 3 * i;
  return make_map(m, p, rows, h, x.b, s[0], s[1], s[2], box);
}

// The dk/dv kernel over a.dkv_split query ranges (kDq: K3, never split)
template <int kC, bool kDq, typename Tag>
int launch_dkv_h(const void* q, const void* k, const void* v, const void* dout,
                 const Strided& x, const BwdHArgs& a, cudaStream_t s) {
  using L = DkvLayout<kC, kDq>;
  CUtensorMap tq, tdo, tk, tv;
  int rc = map_input(&tq, q, x, 0, a.sq, a.h, 64);
  if (rc == 0) rc = map_input(&tdo, dout, x, 4, a.sq, a.h, 64);
  if (rc == 0) rc = map_input(&tk, k, x, 1, a.sk, a.h, L::kKeys);
  if (rc == 0) rc = map_input(&tv, v, x, 2, a.sk, a.h, L::kKeys);
  static bool smem_set = false;
  if (rc == 0) rc = set_smem(bwd_dkv_hopper<kC, kDq, Tag>, L::kAlloc, smem_set);
  if (rc != 0) return rc;
  dim3 grid((a.sk + L::kKeys - 1) / L::kKeys, a.bh, a.dkv_split);
  bwd_dkv_hopper<kC, kDq, Tag><<<grid, (kC + 1) * 128, L::kAlloc, s>>>(tq, tdo, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

template <int kC, typename Tag>
int launch_dq_h(const void* q, const void* k, const void* v, const void* dout,
                const Strided& x, const BwdHArgs& a, cudaStream_t s) {
  using L = DqLayout<kC>;
  CUtensorMap tq, tdo, tk, tv;
  int rc = map_input(&tq, q, x, 0, a.sq, a.h, 64 * kC);
  if (rc == 0) rc = map_input(&tdo, dout, x, 4, a.sq, a.h, 64 * kC);
  if (rc == 0) rc = map_input(&tk, k, x, 1, a.sk, a.h, kKvTile);
  if (rc == 0) rc = map_input(&tv, v, x, 2, a.sk, a.h, kKvTile);
  static bool smem_set = false;
  if (rc == 0) rc = set_smem(bwd_dq_hopper<kC, Tag>, L::kAlloc, smem_set);
  if (rc != 0) return rc;
  dim3 grid((a.sq + 64 * kC - 1) / (64 * kC), a.bh, a.n_split);
  bwd_dq_hopper<kC, Tag><<<grid, (kC + 1) * 128, L::kAlloc, s>>>(tq, tdo, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

// The preprocessing launch over bh slices of `stride` rows (O, dO and lse
// through x's strides, slice bh being (bh / h, bh % h)).
template <typename Tag>
int launch_prep(const void* o, const void* dout, const float* lse, float* lse2,
                float* delta, float* ws, int sq, int stride, int bh, int h,
                const Strided& x, int dtype, cudaStream_t s) {
  const long long rows = (long long)bh * stride;
  const unsigned blocks = static_cast<unsigned>((rows + 31) / 32);
  const long long* so = x.st + 9;
  const long long* sd = x.st + 12;
  const long long* sl = x.st + 15;
  if (dtype == 1)
    bwd_prep<bf16, Tag><<<blocks, 256, 0, s>>>(static_cast<const bf16*>(o),
        static_cast<const bf16*>(dout), lse, lse2, delta, ws, sq, stride, rows,
        h, so[0], so[1], so[2], sd[0], sd[1], sd[2], sl[0], sl[1], sl[2]);
  else
    bwd_prep<float, Tag><<<blocks, 256, 0, s>>>(static_cast<const float*>(o),
        static_cast<const float*>(dout), lse, lse2, delta, ws, sq, stride, rows,
        h, so[0], so[1], so[2], sd[0], sd[1], sd[2], sl[0], sl[1], sl[2]);
  return static_cast<int>(cudaGetLastError());
}

// Consumer warpgroups of a two-pass call's dk/dv blocks (64 keys each) and
// dq-pass blocks (64 rows each): one when Sq <= 64 or Sk <= 64, else two.
// Over Sk <= 64 a dq-pass block has one K/V tile to overlap with, and one
// consumer lets two blocks share an SM.
inline int consumers(int sq, int sk) { return sq <= 64 || sk <= 64 ? 1 : 2; }

// The f32 floats of a bf16 two-pass call's workspace: lse * log2(e) and
// delta in rows padded to kPadRows, the dq split's partials, the dk/dv
// split's partials (the wrappers' plans compute the same).
inline long long two_pass_floats(int bh, int sq, int sk, int n_split, int dkv_split) {
  const long long rows = (long long)bh * ((sq + kPadRows - 1) / kPadRows * kPadRows);
  long long need = 2 * rows;
  if (n_split > 1) need += n_split * rows * kD;
  if (dkv_split > 1) {
    const int keys = 64 * consumers(sq, sk);
    need += (long long)dkv_split * bh * ((sk + keys - 1) / keys) * keys * 2 * kD;
  }
  return need;
}

// The bf16 two-pass backward (K4; K5; K9): the preprocessing launch, the dq
// pass (keys split n_split ways) and the dk/dv pass (queries split
// dkv_split ways), on the workspace of two_pass_floats. b batches of h
// heads; q, k, v, o, dO, lse, dq, dk and dv through x's strides. Returns 0,
// a CUDA error, 901 for an empty or too large a split, 902 for too few
// tickets, 903 for too small a workspace, or 900 / 1000 + the driver's
// error from a tensor map.
template <typename Tag>
int two_pass_bf16(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* lse, float* work,
                  long long work_floats, int* tickets, int n_tickets, void* dq,
                  void* dk, void* dv, int h, int sq, int sk, const Strided& x,
                  int n_split, int dkv_split, cudaStream_t s) {
  const int bh = x.b * h;
  const int sq_pad = (sq + kPadRows - 1) / kPadRows * kPadRows;
  const long long rows = (long long)bh * sq_pad;
  const int kv_tiles = (sk + kKvTile - 1) / kKvTile;
  const int q_tiles = (sq + 63) / 64;
  if (n_split < 1 || n_split > kv_tiles || n_split > kMaxSplits) return 901;
  if (dkv_split < 1 || dkv_split > q_tiles || dkv_split > kMaxSplits) return 901;
  if (work_floats < two_pass_floats(bh, sq, sk, n_split, dkv_split)) return 903;
  BwdHArgs a{};
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  const long long* so = x.st + 18;
  a.dq_bs = so[0]; a.dq_hs = so[1]; a.dq_rs = so[2];
  a.dk_bs = so[3]; a.dk_hs = so[4]; a.dk_rs = so[5];
  a.dv_bs = so[6]; a.dv_hs = so[7]; a.dv_rs = so[8];
  a.lse2 = work;
  a.delta = work + rows;
  a.dq_acc = nullptr;
  a.part = n_split > 1 ? work + 2 * rows : nullptr;
  a.part_kv = dkv_split > 1 ? work + 2 * rows + (n_split > 1 ? n_split * rows * kD : 0)
                            : nullptr;
  a.tickets = tickets;
  a.h = h;
  a.bh = bh;
  a.sq = sq;
  a.sk = sk;
  a.sq_pad = sq_pad;
  a.keys_per_split = (kv_tiles + n_split - 1) / n_split * kKvTile;
  a.n_split = n_split;
  a.tiles_per_split = (q_tiles + dkv_split - 1) / dkv_split;
  a.dkv_split = dkv_split;
  // every split must hold keys / query tiles: the wrappers' rules guarantee it
  if ((long long)(n_split - 1) * a.keys_per_split >= sk) return 901;
  if ((dkv_split - 1) * a.tiles_per_split >= q_tiles) return 901;
  // one tile rule for both passes: 64 rows / keys a consumer
  const int kc = consumers(sq, sk), tile = 64 * kc;
  if (n_split > 1 && (long long)(sq + tile - 1) / tile * bh > n_tickets) return 902;
  if (dkv_split > 1 && (long long)(sk + tile - 1) / tile * bh > n_tickets) return 902;

  int rc = launch_prep<Tag>(o, dout, lse, work, work + rows, nullptr, sq, sq_pad,
                            bh, h, x, 1, s);
  if (rc != 0) return rc;
  if (kc == 1) {
    rc = launch_dq_h<1, Tag>(q, k, v, dout, x, a, s);
    return rc != 0 ? rc : launch_dkv_h<1, false, Tag>(q, k, v, dout, x, a, s);
  }
  rc = launch_dq_h<2, Tag>(q, k, v, dout, x, a, s);
  return rc != 0 ? rc : launch_dkv_h<2, false, Tag>(q, k, v, dout, x, a, s);
}

}  // namespace bwd
}  // namespace m324
