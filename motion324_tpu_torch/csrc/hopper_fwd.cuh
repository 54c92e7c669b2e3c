// The Hopper (sm_90a) attention forward shared by K1 (flash_fwd.cu), the
// K9 forward (short_fwd.cu), K2 (folded_fwd.cu) and K7 (masked_flash.cu):
// exact attention over (B, H, S, D) with an online softmax over KV tiles,
// the logit scale folded into q in q's dtype, padded keys masked to -1e30,
// m / l / acc in f32, P rounded to v's dtype before P V and the output in
// q's dtype; optionally the f32 natural-log log-sum-exp of each row through
// (batch, head, row) strides (compact (B*H, Sq) for K1 and K9, (B, Sq, H)
// for K2), the residual the backward passes read. Each library instantiates
// the kernels with a tag type of its own (fwd_entry<Tag>), so that a
// profile tells their launches apart.
//
// The tag also sets the head dim D: 64, or the tag's kHeadDim (128 for
// K1's k1_flash_fwd_d128, bf16 without the LSE). A 128-wide row is two
// 64-column panels, each a TMA box of 128-byte rows in the 128-byte
// swizzle, so every tile convention of hopper.cuh holds panel by panel:
// S = Q K^T adds the two panels' 4 k-steps each, and O is two 64-column
// accumulators, each P V over its panel of V. At D = 128 a K or V tile is
// 32 KB and the ring holds 2 stages (Q 32 KB + 128 KB of K/V); at D = 64
// every constant, and so the code, is what it was before D was a
// parameter.
//
// The tag also sets the tile policy. A tag derived from VoxelTiles (K7)
// visits only the key tiles that its 128-row query tile's flags list (a
// pre-pass wrote them with the mask bits), in ascending order, and sets
// each logit whose mask bit is clear to -1e30 before the online softmax;
// every other tag visits every key tile of its split and masks nothing.
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

#include <type_traits>

#include "hopper.cuh"   // mbarriers, TMA, wgmma, tensor maps

namespace m324 {
namespace fwd {

constexpr int kBlockN = 128;                    // keys per K/V tile
constexpr int kMaxSplits = 16;                  // the wrapper's rule keeps to it
constexpr int kMaskTile = 128;                  // rows and keys of a mask flag
constexpr int kPanelCols = 64;                  // columns of a 128-byte row

// The tile policy: a tag derived from VoxelTiles visits the listed key
// tiles only and applies the mask bits (K7); any other tag is dense.
struct VoxelTiles {};
template <typename Tag>
constexpr bool kTileMasked = std::is_base_of<VoxelTiles, Tag>::value;

// The head dim of a tag's kernels: the tag's kHeadDim, else kD (64)
template <typename Tag, typename = void>
struct HeadDimOf { static constexpr int value = kD; };
template <typename Tag>
struct HeadDimOf<Tag, std::void_t<decltype(Tag::kHeadDim)>> {
  static constexpr int value = Tag::kHeadDim;
};
template <typename Tag>
constexpr int kHeadDim = HeadDimOf<Tag>::value;

// What the head dim sets: 64-column panels of a row, K/V tiles in flight,
// the bytes of one K or V tile (16 KB at 64, 32 KB at 128) and of one of
// its panels
template <int kDim>
struct Dim {
  static_assert(kDim == 64 || kDim == 128, "head dim 64 or 128");
  static constexpr int kPanels = kDim / kPanelCols;
  static constexpr int kStages = kDim == 64 ? 3 : 2;
  static constexpr int kTileBytes = kBlockN * kDim * 2;
  static constexpr int kPanelBytes = kBlockN * kPanelCols * 2;
};

// dynamic shared memory of a block with `consumers` consumer warpgroups,
// as byte offsets from a 1024-byte-aligned base (the 128-byte swizzle
// repeats every 8 rows of 128 bytes); a masked block adds its list of key
// tiles (a count, then one int per key tile: launch_bf16 adds 4 q_tiles
// bytes to kAlloc). Q is kPanels panels of 64 kConsumers rows (panel p at
// p kQPanelBytes, a consumer's 64 rows at 8 KB steps within it); a K or V
// stage is kPanels panels of 128 rows.
template <int kConsumers, bool kMasked = false, int kDim = kD>
struct Layout {
  static constexpr int kStages = Dim<kDim>::kStages;
  static constexpr int kTileBytes = Dim<kDim>::kTileBytes;
  static constexpr int kQPanelBytes = kConsumers * 64 * kPanelCols * 2;
  static constexpr int kQBytes = kConsumers * 64 * kDim * 2;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;  // q, full[], empty[]
  static constexpr int kFlag = kBar + 8 * (1 + 2 * kStages);   // last split?
  static constexpr int kList = kFlag + 8;
  static constexpr int kAlloc = kList + (kMasked ? 8 : 0) + 1024;
};

struct FwdArgs {
  bf16* o;            // (B, H, Sq, D) through o_bs / o_hs / o_rs
  float* lse;         // (B, H, Sq) through l_bs / l_hs / l_rs, or null
  float* part_o;      // (n_split, B*H, Sq, D) f32 when n_split > 1
  float* part_lse;    // (n_split, B*H, Sq) f32 when n_split > 1
  int* tickets;       // one zeroed int per (query tile, slice) when n_split > 1
  long long o_bs, o_hs, o_rs;
  long long l_bs, l_hs, l_rs;
  int h, bh, sq, sk, keys_per_split, n_split;
  float scale;
};

// A masked call's mask, written by its pre-pass (masked_flash.cu) for S
// tokens in q_tiles = ceil(S / 128) tiles of 128: bit e of word w of row r
// of batch b (bits[(b * q_tiles * 128 + r) * words + w]) is set where query
// r keeps key 32 w + e, words = 4 * q_tiles (rows and keys past S clear);
// flags[(b * q_tiles + qt) * q_tiles + kt] is 1 where the 128 x 128 tile
// (qt, kt) holds a kept pair.
struct TileMask {
  const uint32_t* bits;
  const unsigned char* flags;
  int words, q_tiles;
};
struct MaskedFwdArgs : FwdArgs {
  TileMask mask;
};
template <typename Tag>
using FwdArgsOf = std::conditional_t<kTileMasked<Tag>, MaskedFwdArgs, FwdArgs>;

// One block: a query tile of 64 * kConsumers rows of one (batch, head) over
// one split of the keys. Warpgroup 0 produces, warpgroups 1.. consume.
// One consumer: two blocks per SM (128 registers a thread at launch, the
// producer's given to the consumer); two consumers: one block per SM.
template <int kConsumers, typename Tag>
__global__ void __launch_bounds__((kConsumers + 1) * 128, kConsumers == 1 ? 2 : 1)
fwd_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const FwdArgsOf<Tag> a) {
  constexpr bool kMasked = kTileMasked<Tag>;
  constexpr int kDim = kHeadDim<Tag>;
  constexpr int kPanels = Dim<kDim>::kPanels;
  constexpr int kPanelBytes = Dim<kDim>::kPanelBytes;
  using L = Layout<kConsumers, kMasked, kDim>;
  constexpr int kStages = L::kStages;
  constexpr int kTileBytes = L::kTileBytes;
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
  // a masked block (never split) visits the key tiles of its list
  const int* list = reinterpret_cast<const int*>(smem + L::kList + 8);

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumers * 4);   // one arrive per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (kMasked) {
    // warp 1 compacts the query tile's flags into the list, in order
    if (threadIdx.x >= 32 && threadIdx.x < 64) {
      const int lane = threadIdx.x & 31, nk = a.mask.q_tiles;
      const unsigned char* f =
          a.mask.flags + ((long long)batch * nk + q0 / kMaskTile) * nk;
      int* out = reinterpret_cast<int*>(smem + L::kList + 8);
      int n = 0;
      for (int kt = 0; kt < nk; kt += 32) {
        const bool keep = kt + lane < nk && f[kt + lane] != 0;
        const unsigned m = __ballot_sync(0xffffffffu, keep);
        if (keep) out[n + __popc(m & ((1u << lane) - 1))] = kt + lane;
        n += __popc(m);
      }
      if (lane == 0) *reinterpret_cast<int*>(smem + L::kList) = n;
    }
  }
  __syncthreads();
  const int n_tiles = kMasked ? *reinterpret_cast<const int*>(smem + L::kList)
                              : (kv_end - kv_begin + kBlockN - 1) / kBlockN;

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, L::kQBytes);
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
        tma_load(base + p * L::kQPanelBytes, &tq, q_bar, q0, head, batch,
                 p * kPanelCols);
      for (int it = 0; it < n_tiles; ++it) {
        const int stage = it % kStages;
        mbar_wait(empty_bar + 8 * stage, ((it / kStages) & 1) ^ 1);
        const uint32_t bar = full_bar + 8 * stage;
        mbar_expect_tx(bar, 2 * kTileBytes);
        const int kv0 = kMasked ? list[it] * kBlockN : kv_begin + it * kBlockN;
#pragma unroll
        for (int p = 0; p < kPanels; ++p)
          tma_load(base + L::kK + stage * kTileBytes + p * kPanelBytes, &tk,
                   bar, kv0, head, batch, p * kPanelCols);
#pragma unroll
        for (int p = 0; p < kPanels; ++p)
          tma_load(base + L::kV + stage * kTileBytes + p * kPanelBytes, &tv,
                   bar, kv0, head, batch, p * kPanelCols);
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
  // this consumer's 64 rows of Q in panel p: q_tile + p * kQPanelBytes
  const uint32_t q_tile = base + c * 64 * kPanelCols * 2;

  mbar_wait(q_bar, 0);
  if (a.scale != 1.0f) {
    // fold the logit scale into q, rounded to bf16 (element-wise, so the
    // swizzle does not matter), then hand the tile back to the async proxy
    // (one loop over the 16-byte chunks of this consumer's rows of every
    // panel: at D = 64 the loop it always was)
    uint4* qv = reinterpret_cast<uint4*>(smem + c * 64 * kPanelCols * 2);
    for (int i = t; i < kPanels * 64 * kPanelCols / 8; i += 128) {
      // chunk i lies in panel i / 512, a panel's chunks kQPanelBytes apart
      const int at = kPanels == 1 ? i
                                  : i + (i >> 9) * (L::kQPanelBytes / 16 - 512);
      uint4 val = qv[at];
      __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float2 f = __bfloat1622float2(hv[j]);
        hv[j] = __floats2bfloat162_rn(f.x * a.scale, f.y * a.scale);
      }
      qv[at] = val;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + c) : "memory");
  }
  const uint64_t q_desc = sw128_desc(q_tile);

  float o[kPanels][32];   // output columns 64 p + 0..63
#pragma unroll
  for (int p = 0; p < kPanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;   // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;           // this thread's share of the row sums

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % kStages;
    mbar_wait(full_bar + 8 * stage, (it / kStages) & 1);
    const uint64_t k_desc = sw128_desc(base + L::kK + stage * kTileBytes);
    const uint64_t v_desc = sw128_desc(base + L::kV + stage * kTileBytes);
    const int kv0 = kMasked ? list[it] * kBlockN : kv_begin + it * kBlockN;

    // S = Q K^T over the head dim, 4 steps of 16 a panel (32 bytes: +2 in
    // the descriptor's address field; a panel's bytes / 16 more for the next
    // panel)
    float s[64];
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss_n128(s, q_desc + p * (L::kQPanelBytes >> 4) + 2 * ks,
                      k_desc + p * (kPanelBytes >> 4) + 2 * ks, p > 0 || ks > 0);
    wgmma_commit();
    uint4 bits0, bits1;   // the tile's mask words of rows g and g + 8
    if constexpr (kMasked) {
      // loaded while the product runs (L2: the pre-pass just wrote them)
      const long long row = (long long)batch * a.mask.q_tiles * kMaskTile + q0 +
                            c * 64 + warp * 16 + g;
      const uint4* b0 = reinterpret_cast<const uint4*>(
          a.mask.bits + row * a.mask.words) + kv0 / kBlockN;
      bits0 = __ldg(b0);
      bits1 = __ldg(b0 + 2 * a.mask.words);   // 8 rows on
    }
    wgmma_wait_all();
    fence_regs(s);

    // this thread holds keys 8j + 2 tq4 (+1) of rows g (s[4j], s[4j+1]) and
    // g + 8 (s[4j+2], s[4j+3]), j = 0..15
    if constexpr (kMasked) {
      // key 8j + 2 tq4 (+1) is bit 8 (j % 4) + 2 tq4 (+1) of word j / 4;
      // a tile that keeps all of this thread's keys needs no masking
      const int sh = 2 * tq4;
      const uint32_t w0[4] = {bits0.x >> sh, bits0.y >> sh, bits0.z >> sh,
                              bits0.w >> sh};
      const uint32_t w1[4] = {bits1.x >> sh, bits1.y >> sh, bits1.z >> sh,
                              bits1.w >> sh};
      if ((w0[0] & w0[1] & w0[2] & w0[3] & w1[0] & w1[1] & w1[2] & w1[3] &
           0x03030303u) != 0x03030303u) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const uint32_t x0 = w0[j >> 2] >> (8 * (j & 3));
          const uint32_t x1 = w1[j >> 2] >> (8 * (j & 3));
          if (!(x0 & 1u)) s[4 * j] = kNegInf;
          if (!(x0 & 2u)) s[4 * j + 1] = kNegInf;
          if (!(x1 & 1u)) s[4 * j + 2] = kNegInf;
          if (!(x1 & 2u)) s[4 * j + 3] = kNegInf;
        }
      }
    }
    const int nvalid = kv_end - kv0;
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
    float c0 = mx0 * kLog2e, c1 = mx1 * kLog2e;
    if constexpr (kMasked) {
      // a row with no kept key so far: its -1e30 logits get p = 0 (with
      // c = -1e30 log2(e), rounded, fmaf would leave exp2 of the rounding
      // error: 0 or inf)
      if (mx0 == kNegInf) c0 = 0.f;
      if (mx1 == kNegInf) c1 = 0.f;
    }
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
    for (int p = 0; p < kPanels; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[p][4 * j] *= alpha0; o[p][4 * j + 1] *= alpha0;
        o[p][4 * j + 2] *= alpha1; o[p][4 * j + 3] *= alpha1;
      }

    // O += P V over the 128 keys, 8 steps of 16 (16 V rows: 2 048 bytes,
    // +128 in the descriptor), each panel of V into its accumulator; P's A
    // fragment of keys 16kk.. is this thread's S values of columns 2kk and
    // 2kk + 1, rounded to bf16
    uint32_t p[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) fence_regs(o[pn]);
    wgmma_fence();
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_rs_n64(o[pn], p[kk], v_desc + pn * (kPanelBytes >> 4) + 128 * kk);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) fence_regs(o[pn]);
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
      float* lb = a.lse + batch * a.l_bs + head * a.l_hs;
      if (r0 < a.sq) lb[r0 * a.l_rs] = lse0;
      if (r1 < a.sq) lb[r1 * a.l_rs] = lse1;
    }
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = p * kPanelCols + 8 * j + 2 * tq4;
        if (r0 < a.sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + r0 * a.o_rs + col) =
              __floats2bfloat162_rn(o[p][4 * j] * inv0, o[p][4 * j + 1] * inv0);
        if (r1 < a.sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + r1 * a.o_rs + col) =
              __floats2bfloat162_rn(o[p][4 * j + 2] * inv1,
                                    o[p][4 * j + 3] * inv1);
      }
  } else {
    const long long row_base = ((long long)split * a.bh + bh) * a.sq;
    if (tq4 == 0) {
      if (r0 < a.sq) a.part_lse[row_base + r0] = lse0;
      if (r1 < a.sq) a.part_lse[row_base + r1] = lse1;
    }
    float* pb = a.part_o + row_base * kDim;
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = p * kPanelCols + 8 * j + 2 * tq4;
        if (r0 < a.sq)
          *reinterpret_cast<float2*>(pb + (long long)r0 * kDim + col) =
              make_float2(o[p][4 * j] * inv0, o[p][4 * j + 1] * inv0);
        if (r1 < a.sq)
          *reinterpret_cast<float2*>(pb + (long long)r1 * kDim + col) =
              make_float2(o[p][4 * j + 2] * inv1, o[p][4 * j + 3] * inv1);
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
        if (a.lse != nullptr)
          a.lse[batch * a.l_bs + head * a.l_hs + (q0 + tc) * a.l_rs] = lse;
      }
      asm volatile("bar.sync 3, %0;\n" :: "r"(kConsumers * 128) : "memory");
      bf16* ob = a.o + batch * a.o_bs + head * a.o_hs;
      // 8-column chunks of a row: 8 (64 columns) or 16 (128)
      constexpr int kChunkBits = kDim == 64 ? 3 : 4;
      for (int item = tc; item < n_rows << kChunkBits;
           item += kConsumers * 128) {
        const int r = item >> kChunkBits;
        const int col = (item & ((1 << kChunkBits) - 1)) * 8;
        float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < kMaxSplits; ++i) {
          if (i < a.n_split) {
            const float w = w_s[r * kMaxSplits + i];
            const float4* p = reinterpret_cast<const float4*>(
                a.part_o + (i * rows + row0 + r) * kDim + col);
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
        long long o_rs, long long l_bs, long long l_hs, long long l_rs, int h,
        int sq, int sk, float scale) {
  __shared__ float smem[kScalarSmemFloats];
  const int bh = blockIdx.y, b = bh / h, hh = bh % h;
  scalar_attend(q + b * q_bs + hh * q_hs, k + b * k_bs + hh * k_hs,
                v + b * v_bs + hh * v_hs, o + b * o_bs + hh * o_hs,
                lse == nullptr ? nullptr : lse + b * l_bs + hh * l_hs, q_rs,
                k_rs, v_rs, o_rs, l_rs, sq, sk, blockIdx.x * kScalarQ, scale,
                smem);
}

template <int kConsumers, typename Tag>
int launch_bf16(const void* q, const void* k, const void* v, int b, int h,
                int sq, int sk, const long long* st, const FwdArgsOf<Tag>& a,
                cudaStream_t s) {
  constexpr int kDim = kHeadDim<Tag>;
  using L = Layout<kConsumers, kTileMasked<Tag>, kDim>;
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, q, sq, h, b, st[0], st[1], st[2], 64 * kConsumers, kDim);
  if (rc == 0) rc = make_map(&tk, k, sk, h, b, st[3], st[4], st[5], kBlockN, kDim);
  if (rc == 0) rc = make_map(&tv, v, sk, h, b, st[6], st[7], st[8], kBlockN, kDim);
  if (rc != 0) return rc;
  int smem = L::kAlloc;
  if constexpr (kTileMasked<Tag>) smem += 4 * a.mask.q_tiles;
  static int smem_set = 0;   // the most set so far, per process (one device)
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        fwd_bf16<kConsumers, Tag>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  dim3 grid((sq + 64 * kConsumers - 1) / (64 * kConsumers), b * h, a.n_split);
  fwd_bf16<kConsumers, Tag><<<grid, (kConsumers + 1) * 128, smem, s>>>(
      tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

// q: (b, h, sq, D), k, v: (b, h, sk, D), o like q, each through its
// (batch, head, row) strides in elements (strides[0..11]: q, k, v, o), with
// unit stride within a row and 16-byte-aligned rows and base.
// lse: null, or f32 (b, h, sq) through strides[12..14] that receives each
// row's log-sum-exp.
// bf16 only: n_split > 1 cuts the keys into n_split ranges of whole
// 128-key tiles; part_o (n_split, b*h, sq, D) and part_lse (n_split, b*h,
// sq), f32, are the workspace of the partial results, and tickets holds
// n_tickets zeroed ints, at least one per (query tile, slice), which the
// call leaves zeroed (all null when n_split is 1; a ticket array serves one
// stream at a time). dtype: 0 = float32 (never split), 1 = bfloat16.
// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() after the launch, 900 when the driver has no
// cuTensorMapEncodeTiled, 901 for an empty split or more than kMaxSplits
// splits, 902 for too few tickets,
// or 1000 + the driver's error when a tensor map is refused.
// D = 128 (a tag's kHeadDim) takes bf16 without the LSE only; else 901.
// A masked tag (K7) takes bf16 self-attention only (sq == sk), unsplit,
// with its pre-pass's `mask`; else 901. Its block holds a list of 4-byte
// key tiles in shared memory: past about 28 000 tiles (3.6 M tokens, whose
// mask bits alone would take S^2 / 8 bytes) the launch returns the CUDA
// error of cudaFuncSetAttribute.
template <typename Tag>
int fwd_entry(const void* q, const void* k, const void* v, void* o, float* lse,
              float* part_o, float* part_lse, int* tickets, int n_tickets,
              int b, int h, int sq, int sk, const long long* strides,
              int n_split, float scale, int dtype, void* stream,
              const TileMask* mask = nullptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* st = strides;
  FwdArgsOf<Tag> a;
  static_assert(kHeadDim<Tag> == kD || !kTileMasked<Tag>,
                "the masked policy takes head dim 64");
  if constexpr (kHeadDim<Tag> != kD) {
    if (dtype != 1 || lse != nullptr) return 901;
  }
  if constexpr (kTileMasked<Tag>) {
    if (dtype != 1 || n_split != 1 || mask == nullptr || sq != sk ||
        mask->q_tiles != (sq + kMaskTile - 1) / kMaskTile)
      return 901;
    a.mask = *mask;
  } else if constexpr (kHeadDim<Tag> == kD) {
    if (dtype != 1) {
      dim3 grid((sq + kScalarQ - 1) / kScalarQ, b * h);
      fwd_f32<Tag><<<grid, kScalarWarps * 32, 0, s>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(o), lse, st[0],
          st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
          st[11], st[12], st[13], st[14], h, sq, sk, scale);
      return static_cast<int>(cudaGetLastError());
    }
  }
  const int tiles = (sk + kBlockN - 1) / kBlockN;
  if (n_split < 1 || n_split > tiles || n_split > kMaxSplits) return 901;
  a.o = static_cast<bf16*>(o);
  a.lse = lse;
  a.part_o = part_o;
  a.part_lse = part_lse;
  a.tickets = tickets;
  a.o_bs = st[9];
  a.o_hs = st[10];
  a.o_rs = st[11];
  a.l_bs = st[12];
  a.l_hs = st[13];
  a.l_rs = st[14];
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
