// The Hopper (sm_90a) attention forward shared by K1 (flash_fwd.cu) and the
// K9 forward (short_fwd.cu): exact attention over (B, H, S, 64) with an
// online softmax over KV tiles, the logit scale folded into q in q's dtype,
// padded keys masked to -1e30, m / l / acc in f32, P rounded to v's dtype
// before P V and the output in q's dtype; optionally the f32 natural-log
// log-sum-exp of each row, 2-D (B*H, Sq), the residual the backward passes
// read. Each library instantiates the kernels with a tag type of its own
// (fwd_entry<Tag>), so that a profile tells K1's launches from K9's.
//
// What the design does (bf16):
// - Warp specialisation: warpgroup 0 is the producer, one thread of which
//   keeps a ring of kStages K/V tiles of 128 keys in flight with TMA
//   (128-byte swizzle, completion on mbarriers);
//   each consumer warpgroup owns 64 query rows (two consumers: a 128-row
//   query tile; one consumer when Sq <= 64 or Sk <= 64).
// - S = Q K^T runs on wgmma m64n128k16 with Q and K in shared memory; O += P V
//   on wgmma m64n64k16 with P from registers (the S accumulator rounded to
//   bf16 in place) and V from shared memory read MN-major (transpose flag).
// - The online softmax uses exp2 with log2(e) applied to the f32 logits; the
//   q-scale rounding stays in bf16 as the TPU kernels have it.
// - Split-KV: the keys are cut into n_split contiguous ranges of whole tiles
//   (the wrapper picks n_split from (Sq, Sk) alone, never from B*H, so a
//   slice's bits do not depend on the batch). Each (query tile, slice, split)
//   block writes its normalised partial output and LSE in f32 to a workspace
//   and takes a ticket; the last block of the tile adds the splits in split
//   order (never in arrival order) and resets the ticket. One launch per
//   call: on the short rows the host's launch cost is part of the time.
// - q, k, v and o are read and written through (batch, head, row) strides:
//   the dispatchers' (B, S, H, 64) views go in without a copy. TMA zero-fills
//   rows past the end (those keys still get -1e30); query rows past Sq are
//   masked on store.
//
// Not done: overlapping a consumer's softmax with its own P V (issuing tile
// j's S together with tile j - 1's P V). Written that way, ptxas serialised
// the wgmma groups (its note C7514) and the kernel ran slower on the H100;
// the two consumer warpgroups overlap each other instead.
//
// The f32 variant runs scalar FMA (attention_common.cuh) and is a checking
// path, not a fast one; it is never split.

#pragma once

#include "hopper.cuh"   // mbarriers, TMA, wgmma, tensor maps

namespace m324 {
namespace fwd {

constexpr int kBlockN = 128;                    // keys per K/V tile
constexpr int kStages = 3;                      // K/V tiles in flight
constexpr int kTileBytes = kBlockN * kD * 2;    // one K or V tile: 16 KB
constexpr int kMaxSplits = 16;                  // the wrapper's rule keeps to it

// dynamic shared memory of a block with `consumers` consumer warpgroups,
// as byte offsets from a 1024-byte-aligned base (the 128-byte swizzle
// repeats every 8 rows of 128 bytes)
template <int kConsumers>
struct Layout {
  static constexpr int kQBytes = kConsumers * 64 * kD * 2;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;  // q, full[], empty[]
  static constexpr int kFlag = kBar + 8 * (1 + 2 * kStages);   // last split?
  static constexpr int kAlloc = kFlag + 8 + 1024;
};

struct FwdArgs {
  bf16* o;            // (B, H, Sq, 64) through o_bs / o_hs / o_rs
  float* lse;         // (B*H, Sq) or null
  float* part_o;      // (n_split, B*H, Sq, 64) f32 when n_split > 1
  float* part_lse;    // (n_split, B*H, Sq) f32 when n_split > 1
  int* tickets;       // one zeroed int per (query tile, slice) when n_split > 1
  long long o_bs, o_hs, o_rs;
  int h, bh, sq, sk, keys_per_split, n_split;
  float scale;
};

// One block: a query tile of 64 * kConsumers rows of one (batch, head) over
// one split of the keys. Warpgroup 0 produces, warpgroups 1.. consume.
// One consumer: two blocks per SM (128 registers a thread at launch, the
// producer's given to the consumer); two consumers: one block per SM.
template <int kConsumers, typename Tag>
__global__ void __launch_bounds__((kConsumers + 1) * 128, kConsumers == 1 ? 2 : 1)
fwd_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const FwdArgs a) {
  using L = Layout<kConsumers>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t q_bar = base + L::kBar;
  const uint32_t full_bar = q_bar + 8;                  // + 8 * stage
  const uint32_t empty_bar = full_bar + 8 * kStages;    // + 8 * stage

  const int q0 = blockIdx.x * 64 * kConsumers;
  const int bh = blockIdx.y, batch = bh / a.h, head = bh % a.h;
  const int split = blockIdx.z;
  const int kv_begin = split * a.keys_per_split;
  const int kv_end = min(a.sk, kv_begin + a.keys_per_split);
  const int n_tiles = (kv_end - kv_begin + kBlockN - 1) / kBlockN;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumers * 4);   // one arrive per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, L::kQBytes);
      tma_load(base, &tq, q_bar, q0, head, batch);
      for (int it = 0; it < n_tiles; ++it) {
        const int stage = it % kStages;
        mbar_wait(empty_bar + 8 * stage, ((it / kStages) & 1) ^ 1);
        const uint32_t bar = full_bar + 8 * stage;
        mbar_expect_tx(bar, 2 * kTileBytes);
        const int kv0 = kv_begin + it * kBlockN;
        tma_load(base + L::kK + stage * kTileBytes, &tk, bar, kv0, head, batch);
        tma_load(base + L::kV + stage * kTileBytes, &tv, bar, kv0, head, batch);
      }
    }
    return;
  }

  // ---- consumers ----
  if (kConsumers > 1)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1;                      // this consumer's 64 query rows
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq4 = lane & 3;
  const uint32_t q_tile = base + c * 64 * kD * 2;

  mbar_wait(q_bar, 0);
  if (a.scale != 1.0f) {
    // fold the logit scale into q, rounded to bf16 (element-wise, so the
    // swizzle does not matter), then hand the tile back to the async proxy
    uint4* qv = reinterpret_cast<uint4*>(smem + c * 64 * kD * 2);
    for (int i = t; i < 64 * kD / 8; i += 128) {
      uint4 val = qv[i];
      __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float2 f = __bfloat1622float2(hv[j]);
        hv[j] = __floats2bfloat162_rn(f.x * a.scale, f.y * a.scale);
      }
      qv[i] = val;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + c) : "memory");
  }
  const uint64_t q_desc = sw128_desc(q_tile);

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;   // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;           // this thread's share of the row sums

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % kStages;
    mbar_wait(full_bar + 8 * stage, (it / kStages) & 1);
    const uint64_t k_desc = sw128_desc(base + L::kK + stage * kTileBytes);
    const uint64_t v_desc = sw128_desc(base + L::kV + stage * kTileBytes);

    // S = Q K^T over the head dim, 4 steps of 16 (32 bytes: +2 in the
    // descriptor's address field)
    float s[64];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_n128(s, q_desc + 2 * ks, k_desc + 2 * ks, ks > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // this thread holds keys 8j + 2 tq4 (+1) of rows g (s[4j], s[4j+1]) and
    // g + 8 (s[4j+2], s[4j+3]), j = 0..15
    const int nvalid = kv_end - (kv_begin + it * kBlockN);
    if (nvalid < kBlockN) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int key = 8 * j + 2 * tq4;
        if (key >= nvalid) { s[4 * j] = kNegInf; s[4 * j + 2] = kNegInf; }
        if (key + 1 >= nvalid) { s[4 * j + 1] = kNegInf; s[4 * j + 3] = kNegInf; }
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float alpha0 = fast_exp2((m0 - mx0) * kLog2e);
    const float alpha1 = fast_exp2((m1 - mx1) * kLog2e);
    m0 = mx0;
    m1 = mx1;
    const float c0 = mx0 * kLog2e, c1 = mx1 * kLog2e;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s[4 * j] = fast_exp2(fmaf(s[4 * j], kLog2e, -c0));
      s[4 * j + 1] = fast_exp2(fmaf(s[4 * j + 1], kLog2e, -c0));
      s[4 * j + 2] = fast_exp2(fmaf(s[4 * j + 2], kLog2e, -c1));
      s[4 * j + 3] = fast_exp2(fmaf(s[4 * j + 3], kLog2e, -c1));
      ls0 += s[4 * j] + s[4 * j + 1];
      ls1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * alpha0 + ls0;
    l1 = l1 * alpha1 + ls1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[4 * j] *= alpha0; o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1; o[4 * j + 3] *= alpha1;
    }

    // O += P V over the 128 keys, 8 steps of 16 (16 V rows: 2 048 bytes,
    // +128 in the descriptor); P's A fragment of keys 16kk.. is this
    // thread's S values of columns 2kk and 2kk + 1, rounded to bf16
    uint32_t p[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_rs_n64(o, p[kk], v_desc + 128 * kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) fence_regs(p[kk]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * stage);
  }

  // ---- epilogue ----
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int r0 = q0 + c * 64 + warp * 16 + g, r1 = r0 + 8;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const float lse0 = m0 + logf(l0), lse1 = m1 + logf(l1);
  if (a.n_split == 1) {
    bf16* ob = a.o + batch * a.o_bs + head * a.o_hs;
    if (a.lse != nullptr && tq4 == 0) {
      if (r0 < a.sq) a.lse[(long long)bh * a.sq + r0] = lse0;
      if (r1 < a.sq) a.lse[(long long)bh * a.sq + r1] = lse1;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * tq4;
      if (r0 < a.sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + r0 * a.o_rs + col) =
            __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (r1 < a.sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + r1 * a.o_rs + col) =
            __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  } else {
    const long long row_base = ((long long)split * a.bh + bh) * a.sq;
    if (tq4 == 0) {
      if (r0 < a.sq) a.part_lse[row_base + r0] = lse0;
      if (r1 < a.sq) a.part_lse[row_base + r1] = lse1;
    }
    float* pb = a.part_o + row_base * kD;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * tq4;
      if (r0 < a.sq)
        *reinterpret_cast<float2*>(pb + (long long)r0 * kD + col) =
            make_float2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (r1 < a.sq)
        *reinterpret_cast<float2*>(pb + (long long)r1 * kD + col) =
            make_float2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    // the last of the tile's n_split blocks to finish adds them up
    __threadfence();
    asm volatile("bar.sync 3, %0;\n" :: "r"(kConsumers * 128) : "memory");
    int* flag = reinterpret_cast<int*>(smem + L::kFlag);
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    if (c == 0 && t == 0)
      *flag = atomicAdd(a.tickets + tile, 1) == a.n_split - 1;
    asm volatile("bar.sync 3, %0;\n" :: "r"(kConsumers * 128) : "memory");
    if (*flag) {
      // add the splits in split order (never in arrival order, so a call
      // repeats bit for bit): lse = log sum_i exp(lse_i), O = sum_i
      // exp(lse_i - lse) O_i. The partials were written by other blocks:
      // read past L1. Every load of a row or chunk is issued at once.
      __threadfence();
      const int n_rows = min(a.sq - q0, 64 * kConsumers);
      const int tc = c * 128 + t;
      const long long rows = (long long)a.bh * a.sq;
      const long long row0 = (long long)bh * a.sq + q0;
      float* w_s = reinterpret_cast<float*>(smem + L::kK);   // K stages: read
      if (tc < n_rows) {
        float l[kMaxSplits];
        float mx = kNegInf;
#pragma unroll
        for (int i = 0; i < kMaxSplits; ++i) {
          l[i] = i < a.n_split ? __ldcg(a.part_lse + i * rows + row0 + tc) : kNegInf;
          mx = fmaxf(mx, l[i]);
        }
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxSplits; ++i)
          if (i < a.n_split) sum += expf(l[i] - mx);
        const float lse = mx + logf(sum);
#pragma unroll
        for (int i = 0; i < kMaxSplits; ++i)
          w_s[tc * kMaxSplits + i] = i < a.n_split ? expf(l[i] - lse) : 0.f;
        if (a.lse != nullptr) a.lse[row0 + tc] = lse;
      }
      asm volatile("bar.sync 3, %0;\n" :: "r"(kConsumers * 128) : "memory");
      bf16* ob = a.o + batch * a.o_bs + head * a.o_hs;
      for (int item = tc; item < n_rows * 8; item += kConsumers * 128) {
        const int r = item >> 3, col = (item & 7) * 8;
        float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < kMaxSplits; ++i) {
          if (i < a.n_split) {
            const float w = w_s[r * kMaxSplits + i];
            const float4* p = reinterpret_cast<const float4*>(
                a.part_o + (i * rows + row0 + r) * kD + col);
            const float4 x = __ldcg(p), y = __ldcg(p + 1);
            acc[0] = fmaf(w, x.x, acc[0]); acc[1] = fmaf(w, x.y, acc[1]);
            acc[2] = fmaf(w, x.z, acc[2]); acc[3] = fmaf(w, x.w, acc[3]);
            acc[4] = fmaf(w, y.x, acc[4]); acc[5] = fmaf(w, y.y, acc[5]);
            acc[6] = fmaf(w, y.z, acc[6]); acc[7] = fmaf(w, y.w, acc[7]);
          }
        }
        uint4 packed = make_uint4(pack_bf16(acc[0], acc[1]), pack_bf16(acc[2], acc[3]),
                                  pack_bf16(acc[4], acc[5]), pack_bf16(acc[6], acc[7]));
        *reinterpret_cast<uint4*>(ob + (long long)(q0 + r) * a.o_rs + col) = packed;
      }
      if (tc == 0) a.tickets[tile] = 0;   // ready for the next call
    }
  }
}

template <typename Tag>
__global__ void __launch_bounds__(kScalarWarps * 32)
fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, float* __restrict__ o,
        float* __restrict__ lse, long long q_bs, long long q_hs, long long q_rs,
        long long k_bs, long long k_hs, long long k_rs, long long v_bs,
        long long v_hs, long long v_rs, long long o_bs, long long o_hs,
        long long o_rs, int h, int sq, int sk, float scale) {
  __shared__ float smem[kScalarSmemFloats];
  const int bh = blockIdx.y, b = bh / h, hh = bh % h;
  scalar_attend(q + b * q_bs + hh * q_hs, k + b * k_bs + hh * k_hs,
                v + b * v_bs + hh * v_hs, o + b * o_bs + hh * o_hs,
                lse == nullptr ? nullptr : lse + (long long)bh * sq, q_rs, k_rs,
                v_rs, o_rs, 1, sq, sk, blockIdx.x * kScalarQ, scale, smem);
}

template <int kConsumers, typename Tag>
int launch_bf16(const void* q, const void* k, const void* v, int b, int h,
                int sq, int sk, const long long* st, const FwdArgs& a,
                cudaStream_t s) {
  using L = Layout<kConsumers>;
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, q, sq, h, b, st[0], st[1], st[2], 64 * kConsumers);
  if (rc == 0) rc = make_map(&tk, k, sk, h, b, st[3], st[4], st[5], kBlockN);
  if (rc == 0) rc = make_map(&tv, v, sk, h, b, st[6], st[7], st[8], kBlockN);
  if (rc != 0) return rc;
  static bool smem_set = false;   // once per process (one device)
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        fwd_bf16<kConsumers, Tag>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::kAlloc);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  dim3 grid((sq + 64 * kConsumers - 1) / (64 * kConsumers), b * h, a.n_split);
  fwd_bf16<kConsumers, Tag><<<grid, (kConsumers + 1) * 128, L::kAlloc, s>>>(
      tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

// q: (b, h, sq, 64), k, v: (b, h, sk, 64), o like q, each through its
// (batch, head, row) strides in elements (strides[0..11]: q, k, v, o), with
// unit stride within a row and 16-byte-aligned rows and base.
// lse: null, or f32 (b*h, sq) that receives each row's log-sum-exp.
// bf16 only: n_split > 1 cuts the keys into n_split ranges of whole
// 128-key tiles; part_o (n_split, b*h, sq, 64) and part_lse (n_split, b*h,
// sq), f32, are the workspace of the partial results, and tickets holds
// n_tickets zeroed ints, at least one per (query tile, slice), which the
// call leaves zeroed (all null when n_split is 1; a ticket array serves one
// stream at a time). dtype: 0 = float32 (never split), 1 = bfloat16.
// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() after the launch, 900 when the driver has no
// cuTensorMapEncodeTiled, 901 for an empty split or more than kMaxSplits
// splits, 902 for too few tickets,
// or 1000 + the driver's error when a tensor map is refused.
template <typename Tag>
int fwd_entry(const void* q, const void* k, const void* v, void* o, float* lse,
              float* part_o, float* part_lse, int* tickets, int n_tickets,
              int b, int h, int sq, int sk, const long long* strides,
              int n_split, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* st = strides;
  if (dtype != 1) {
    dim3 grid((sq + kScalarQ - 1) / kScalarQ, b * h);
    fwd_f32<Tag><<<grid, kScalarWarps * 32, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, st[0], st[1],
        st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
        h, sq, sk, scale);
    return static_cast<int>(cudaGetLastError());
  }
  const int tiles = (sk + kBlockN - 1) / kBlockN;
  if (n_split < 1 || n_split > tiles || n_split > kMaxSplits) return 901;
  FwdArgs a;
  a.o = static_cast<bf16*>(o);
  a.lse = lse;
  a.part_o = part_o;
  a.part_lse = part_lse;
  a.tickets = tickets;
  a.o_bs = st[9];
  a.o_hs = st[10];
  a.o_rs = st[11];
  a.h = h;
  a.bh = b * h;
  a.sq = sq;
  a.sk = sk;
  a.keys_per_split = (tiles + n_split - 1) / n_split * kBlockN;
  a.n_split = n_split;
  a.scale = scale;
  // every split must hold keys: the wrapper's rule guarantees it
  if ((long long)(n_split - 1) * a.keys_per_split >= sk) return 901;
  // one consumer (64-row tiles, two blocks an SM) for Sq <= 64 and for
  // Sk <= 64, where a block's one K/V tile leaves little to overlap
  const bool one = sq <= 64 || sk <= 64;
  const int q_rows = one ? 64 : 128;
  if (n_split > 1 && (long long)(sq + q_rows - 1) / q_rows * b * h > n_tickets)
    return 902;
  return one ? launch_bf16<1, Tag>(q, k, v, b, h, sq, sk, st, a, s)
             : launch_bf16<2, Tag>(q, k, v, b, h, sq, sk, st, a, s);
}

}  // namespace fwd
}  // namespace m324
