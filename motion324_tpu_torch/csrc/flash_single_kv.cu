// K6: single-KV attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_single_kv_kernel` in
// motion324_tpu/ops/flash_attention.py (reached through `_fwd_single_kv` and
// `_fwd` when the padded KV fits one block of at most 1 024 keys): exact
// attention over (B, H, S, 64) in which the whole KV of a head is one block.
// Its arithmetic, which this kernel keeps: f32 logits s = q_scaled k^T, one
// row max m over ALL keys before any exp, p = exp(s - m) unnormalised, l =
// sum p in f32, o = (p rounded to v's dtype) v / l with one division at the
// end, padded keys masked to -1e30. There is no online rescale, so P is
// rounded against the row's final max, as in the plain version
// (`attention_reference`), and not against a running max as in K1. With the
// LSE output it also writes the f32 m + log(l) of each row, (B*H, Sq).
//
// What bounds it on the H100: at its call site, the ShapeVAE volume query
// (16 heads, 8 192 points x 512 latents), it moves 35.7 MB (q, o and k/v),
// 0.0107 ms at 3.35 TB/s. Its two products are 17.2 GFLOP, 0.0174 ms at the
// bf16 tensor-core peak; the exact max costs a second Q K^T, 25.8 GFLOP in
// all, 0.0261 ms: the tensor work bounds it.
//
// What the design does about that (bf16), on hopper.cuh's TMA, mbarrier and
// wgmma helpers:
// - Each block walks several query tiles of ONE (batch, head) slice (the
//   wrapper's single_kv_plan sizes the grid to about one wave of 132 SMs:
//   the volume query's 16 slices x 64 tiles of 128 rows give 128 blocks of
//   8 tiles). The slice's whole K (at most 1 024 x 64 bf16, 128 KB) stays
//   resident in shared memory, loaded once per block; V too up to 512 keys
//   (64 KB more), and above that V streams through a 2-stage ring of
//   128-key tiles in the second sweep (the UNet's 1 024 keys: 192 KB with
//   the Q tiles).
// - Warpgroup 0 is the producer: one thread issues every TMA load (128-byte
//   swizzle, completion on mbarriers), Q double-buffered a tile ahead. Each
//   consumer warpgroup owns 64 query rows (two consumers: 128-row tiles;
//   one when Sq <= 64).
// - Sweep 1: S = Q K^T on wgmma m64n128k16 from shared memory, keeping only
//   the row max. Sweep 2: S again, P = exp2((s - m) log2 e) against that
//   final max, l in f32, P rounded to bf16 in registers as wgmma's A
//   operand, O += P V on wgmma m64n64k16 with V read MN-major. One division
//   at the end; rows past Sq are not stored.
// - q, k, v and o are read and written through (batch, head, row) strides,
//   so the dispatcher's (B, S, H, 64) views go in and the output comes out
//   heads-last without a copy. TMA zero-fills rows past the end; keys past
//   Sk get -1e30 in the one ragged tile.
//
// The f32 variant runs scalar FMA in the same two sweeps and is a checking
// path, not a fast one.

#include "hopper.cuh"   // mbarriers, TMA, wgmma, tensor maps

using namespace m324;

namespace {

struct k6_single_kv {};   // K6's kernels in a profile

constexpr int kTileN = 128;                   // keys per K / V tile
constexpr int kTileBytes = kTileN * kD * 2;   // 16 KB
constexpr int kMaxTiles = 8;                  // 1 024 keys
constexpr int kMaxResidentV = 4;              // V resident up to 512 keys
constexpr int kVStages = 2;                   // the streamed V ring

// dynamic shared memory, byte offsets from a 1024-byte-aligned base: two Q
// stages of kc 64-row tiles, K's kt tiles, V's kt tiles (resident) or ring,
// then the barriers k, v, q_full[2], q_empty[2], v_full[2], v_empty[2]
struct Layout {
  int q, k, v, bar, alloc;
  __host__ __device__ Layout(int kc, int kt, bool v_res) {
    q = 0;
    k = 2 * kc * 64 * kD * 2;
    v = k + kt * kTileBytes;
    bar = v + (v_res ? kt : kVStages) * kTileBytes;
    alloc = bar + 8 * 10 + 1024;
  }
};

struct SkvArgs {
  bf16* o;          // (B, H, Sq, 64) through o_bs / o_hs / o_rs
  float* lse;       // (B*H, Sq) or null
  long long o_bs, o_hs, o_rs;
  int h, sq, sk, q_tiles, tiles_per_block;
  float scale;
};

// S (64 x 128, f32) = Q K^T of one consumer's 64 rows and one K tile, over
// the head dim in 4 steps of 16 (32 bytes: +2 in the descriptor's address)
__device__ __forceinline__ void scores(float (&s)[64], uint64_t q_desc,
                                       uint64_t k_desc) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_ss_n128(s, q_desc + 2 * ks, k_desc + 2 * ks, ks > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
}

// keys at or past `nvalid` of the tile get the masked logit; this thread
// holds keys 8j + 2 tq4 (+1) of rows g (s[4j], s[4j+1]) and g + 8 (s[4j+2],
// s[4j+3]), j = 0..15
__device__ __forceinline__ void mask_tail(float (&s)[64], int nvalid, int tq4) {
  if (nvalid >= kTileN) return;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int key = 8 * j + 2 * tq4;
    if (key >= nvalid) { s[4 * j] = kNegInf; s[4 * j + 2] = kNegInf; }
    if (key + 1 >= nvalid) { s[4 * j + 1] = kNegInf; s[4 * j + 3] = kNegInf; }
  }
}

// One block: query tiles [x * tiles_per_block, ...) of slice blockIdx.y.
// Warpgroup 0 produces, warpgroups 1.. consume (named barrier 1 + c).
template <int kC, bool kVRes, typename Tag>
__global__ void __launch_bounds__((kC + 1) * 128, kC == 1 ? 2 : 1)
single_kv_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const SkvArgs a) {
  constexpr int kQBytes = kC * 64 * kD * 2;
  const int kt = (a.sk + kTileN - 1) / kTileN;
  const Layout L(kC, kt, kVRes);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t k_bar = base + L.bar, v_bar = k_bar + 8;
  const uint32_t q_full = k_bar + 16, q_empty = q_full + 16;   // + 8 * stage
  const uint32_t v_full = q_empty + 16, v_empty = v_full + 16;

  const int bh = blockIdx.y, batch = bh / a.h, head = bh % a.h;
  const int first = blockIdx.x * a.tiles_per_block;
  const int n_q = min(a.q_tiles - first, a.tiles_per_block);

  if (threadIdx.x == 0) {
    mbar_init(k_bar, 1);
    mbar_init(v_bar, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(q_empty + 8 * s, kC * 4);   // one arrive per consumer warp
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, kC * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: Q tile 0, all of K, V (resident), then Q a tile ahead
    // and, when V streams, each query tile's V tiles in the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, kQBytes);
      tma_load(base + L.q, &tq, q_full, first * 64 * kC, head, batch);
      mbar_expect_tx(k_bar, kt * kTileBytes);
      for (int j = 0; j < kt; ++j)
        tma_load(base + L.k + j * kTileBytes, &tk, k_bar, j * kTileN, head, batch);
      if (kVRes) {
        mbar_expect_tx(v_bar, kt * kTileBytes);
        for (int j = 0; j < kt; ++j)
          tma_load(base + L.v + j * kTileBytes, &tv, v_bar, j * kTileN, head, batch);
      }
      int vn = 0;   // V tiles issued
      for (int i = 0; i < n_q; ++i) {
        if (i + 1 < n_q) {
          const int s = (i + 1) & 1;
          mbar_wait(q_empty + 8 * s, (((i + 1) >> 1) & 1) ^ 1);
          mbar_expect_tx(q_full + 8 * s, kQBytes);
          tma_load(base + L.q + s * kQBytes, &tq, q_full + 8 * s,
                   (first + i + 1) * 64 * kC, head, batch);
        }
        if (!kVRes) {
          for (int j = 0; j < kt; ++j, ++vn) {
            const int s = vn & 1;
            mbar_wait(v_empty + 8 * s, ((vn >> 1) & 1) ^ 1);
            mbar_expect_tx(v_full + 8 * s, kTileBytes);
            tma_load(base + L.v + s * kTileBytes, &tv, v_full + 8 * s,
                     j * kTileN, head, batch);
          }
        }
      }
    }
    return;
  }

  // ---- consumers ----
  if (kC > 1)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1;                      // this consumer's 64 query rows
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq4 = lane & 3;
  const int tail = a.sk - (kt - 1) * kTileN;   // real keys in the last tile
  bf16* ob = a.o + batch * a.o_bs + head * a.o_hs;

  mbar_wait(k_bar, 0);
  if (kVRes) mbar_wait(v_bar, 0);
  int vn = 0;   // V tiles consumed
  for (int i = 0; i < n_q; ++i) {
    const int qs = i & 1;
    mbar_wait(q_full + 8 * qs, (i >> 1) & 1);
    unsigned char* q_sm = smem + L.q + qs * kQBytes + c * 64 * kD * 2;
    if (a.scale != 1.0f) {
      // fold the logit scale into q, rounded to bf16 (element-wise, so the
      // swizzle does not matter), then hand the tile back to the async proxy
      uint4* qv = reinterpret_cast<uint4*>(q_sm);
      for (int idx = t; idx < 64 * kD / 8; idx += 128) {
        uint4 val = qv[idx];
        __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float2 f = __bfloat1622float2(hv[j]);
          hv[j] = __floats2bfloat162_rn(f.x * a.scale, f.y * a.scale);
        }
        qv[idx] = val;
      }
      fence_proxy_async();
      bar_sync(1 + c, 128);
    }
    const uint64_t q_desc = sw128_desc(smem_u32(q_sm));

    // sweep 1: the exact max of rows g and g + 8 over all keys
    float s[64];
    float m0 = kNegInf, m1 = kNegInf;
#pragma unroll 1
    for (int j = 0; j < kt; ++j) {
      scores(s, q_desc, sw128_desc(base + L.k + j * kTileBytes));
      mask_tail(s, j == kt - 1 ? tail : kTileN, tq4);
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        m0 = fmaxf(m0, fmaxf(s[4 * jj], s[4 * jj + 1]));
        m1 = fmaxf(m1, fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }
    const float c0 = m0 * kLog2e, c1 = m1 * kLog2e;

    // sweep 2: P = exp(s - m) against that max, l = sum P, O += bf16(P) V
    float o[32];
#pragma unroll
    for (int idx = 0; idx < 32; ++idx) o[idx] = 0.f;
    float l0 = 0.f, l1 = 0.f;
#pragma unroll 1
    for (int j = 0; j < kt; ++j, ++vn) {
      scores(s, q_desc, sw128_desc(base + L.k + j * kTileBytes));
      mask_tail(s, j == kt - 1 ? tail : kTileN, tq4);
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        s[4 * jj] = fast_exp2(fmaf(s[4 * jj], kLog2e, -c0));
        s[4 * jj + 1] = fast_exp2(fmaf(s[4 * jj + 1], kLog2e, -c0));
        s[4 * jj + 2] = fast_exp2(fmaf(s[4 * jj + 2], kLog2e, -c1));
        s[4 * jj + 3] = fast_exp2(fmaf(s[4 * jj + 3], kLog2e, -c1));
        l0 += s[4 * jj] + s[4 * jj + 1];
        l1 += s[4 * jj + 2] + s[4 * jj + 3];
      }
      // P's A fragment of keys 16kk.. is this thread's S values of columns
      // 2kk and 2kk + 1, rounded to bf16; V read MN-major (16 rows a step:
      // +2 048 bytes, +128 in the descriptor)
      uint32_t p[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      const int vs = vn & 1;
      uint32_t v_tile = base + L.v + j * kTileBytes;
      if (!kVRes) {
        mbar_wait(v_full + 8 * vs, (vn >> 1) & 1);
        v_tile = base + L.v + vs * kTileBytes;
      }
      const uint64_t v_desc = sw128_desc(v_tile);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) wgmma_rs_n64(o, p[kk], v_desc + 128 * kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) fence_regs(p[kk]);
      if (!kVRes) {
        __syncwarp();
        if (lane == 0) mbar_arrive(v_empty + 8 * vs);
      }
    }
    // this Q stage is read: the producer may load the tile after next
    __syncwarp();
    if (lane == 0) mbar_arrive(q_empty + 8 * qs);

    // ---- epilogue: one division, rows past Sq not stored ----
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const int r0 = (first + i) * 64 * kC + c * 64 + warp * 16 + g, r1 = r0 + 8;
    if (a.lse != nullptr && tq4 == 0) {
      if (r0 < a.sq) a.lse[(long long)bh * a.sq + r0] = m0 + logf(l0);
      if (r1 < a.sq) a.lse[(long long)bh * a.sq + r1] = m1 + logf(l1);
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = 8 * jj + 2 * tq4;
      if (r0 < a.sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + r0 * a.o_rs + col) =
            __floats2bfloat162_rn(o[4 * jj] / l0, o[4 * jj + 1] / l0);
      if (r1 < a.sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + r1 * a.o_rs + col) =
            __floats2bfloat162_rn(o[4 * jj + 2] / l1, o[4 * jj + 3] / l1);
    }
  }
}

// f32: a block of kScalarWarps warps, each owning kScalarRows query rows,
// keys through shared memory 32 at a time (one key per lane for the logits,
// two head-dim columns per lane for the output), in the same two sweeps.
// q, k, v and o through their (batch, head, row) strides.
template <typename Tag>
__global__ void __launch_bounds__(kScalarWarps * 32)
single_kv_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, long long q_bs, long long q_hs,
              long long q_rs, long long k_bs, long long k_hs, long long k_rs,
              long long v_bs, long long v_hs, long long v_rs, long long o_bs,
              long long o_hs, long long o_rs, int h, int sq, int sk,
              float scale) {
  __shared__ float smem[kScalarSmemFloats];
  float* q_s = smem;
  float* k_s = q_s + kScalarQ * kD;
  float* v_s = k_s + 32 * kScalarRow;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = kScalarWarps * 32;
  const int row0 = blockIdx.x * kScalarQ;
  const long long bh = blockIdx.y, b = bh / h, hh = bh % h;
  const float* qb = q + b * q_bs + hh * q_hs;
  const float* kb = k + b * k_bs + hh * k_hs;
  const float* vb = v + b * v_bs + hh * v_hs;

  for (int idx = tid; idx < kScalarQ * kD; idx += nthreads) {
    const int r = idx / kD, c = idx % kD;
    q_s[idx] = (row0 + r < sq) ? qb[(long long)(row0 + r) * q_rs + c] * scale : 0.f;
  }
  float m[kScalarRows], l[kScalarRows], acc0[kScalarRows], acc1[kScalarRows];
#pragma unroll
  for (int i = 0; i < kScalarRows; ++i) {
    m[i] = kNegInf; l[i] = 0.f; acc0[i] = 0.f; acc1[i] = 0.f;
  }
  // sweep 1: each lane's max over its keys, then over the warp
  for (int kv0 = 0; kv0 < sk; kv0 += 32) {
    __syncthreads();
    for (int idx = tid; idx < 32 * kD; idx += nthreads) {
      const int r = idx / kD, c = idx % kD;
      k_s[r * kScalarRow + c] = (kv0 + r < sk) ? kb[(long long)(kv0 + r) * k_rs + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kScalarRows; ++i) {
      const float* qr = q_s + (warp * kScalarRows + i) * kD;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < kD; ++d) s = fmaf(qr[d], k_s[lane * kScalarRow + d], s);
      if (kv0 + lane < sk) m[i] = fmaxf(m[i], s);
    }
  }
#pragma unroll
  for (int i = 0; i < kScalarRows; ++i)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], off));
  // sweep 2
  for (int kv0 = 0; kv0 < sk; kv0 += 32) {
    __syncthreads();
    for (int idx = tid; idx < 32 * kD; idx += nthreads) {
      const int r = idx / kD, c = idx % kD;
      const bool ok = kv0 + r < sk;
      k_s[r * kScalarRow + c] = ok ? kb[(long long)(kv0 + r) * k_rs + c] : 0.f;
      v_s[r * kScalarRow + c] = ok ? vb[(long long)(kv0 + r) * v_rs + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kScalarRows; ++i) {
      const float* qr = q_s + (warp * kScalarRows + i) * kD;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < kD; ++d) s = fmaf(qr[d], k_s[lane * kScalarRow + d], s);
      const float p = (kv0 + lane < sk) ? expf(s - m[i]) : 0.f;
      l[i] += p;
      float a0 = acc0[i], a1 = acc1[i];
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        a0 = fmaf(pj, v_s[j * kScalarRow + lane], a0);
        a1 = fmaf(pj, v_s[j * kScalarRow + lane + 32], a1);
      }
      acc0[i] = a0;
      acc1[i] = a1;
    }
  }
  float* obase = o + b * o_bs + hh * o_hs;
#pragma unroll
  for (int i = 0; i < kScalarRows; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      li += __shfl_xor_sync(0xffffffffu, li, off);
    const int r = row0 + warp * kScalarRows + i;
    if (r < sq) {
      float* orow = obase + (long long)r * o_rs;
      orow[lane] = acc0[i] / li;
      orow[lane + 32] = acc1[i] / li;
      if (lse != nullptr && lane == 0) lse[bh * sq + r] = m[i] + logf(li);
    }
  }
}

template <int kC, bool kVRes>
int launch_bf16(const void* q, const void* k, const void* v, int b,
                const long long* st, const SkvArgs& a, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, q, a.sq, a.h, b, st[0], st[1], st[2], 64 * kC);
  if (rc == 0) rc = make_map(&tk, k, a.sk, a.h, b, st[3], st[4], st[5], kTileN);
  if (rc == 0) rc = make_map(&tv, v, a.sk, a.h, b, st[6], st[7], st[8], kTileN);
  if (rc != 0) return rc;
  static bool smem_set = false;   // once per process (one device): the most
  if (!smem_set) {                // this instantiation takes
    const Layout most(kC, kVRes ? kMaxResidentV : kMaxTiles, kVRes);
    cudaError_t e = cudaFuncSetAttribute(
        single_kv_bf16<kC, kVRes, k6_single_kv>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        most.alloc);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const Layout L(kC, (a.sk + kTileN - 1) / kTileN, kVRes);
  dim3 grid((a.q_tiles + a.tiles_per_block - 1) / a.tiles_per_block, b * a.h);
  single_kv_bf16<kC, kVRes, k6_single_kv><<<grid, (kC + 1) * 128, L.alloc, s>>>(
      tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: (b, h, sq, 64); k, v: (b, h, sk, 64); each through its (batch, head,
// row) strides in elements (strides[0..11]: q, k, v, o), unit stride within
// a row, 16-byte-aligned rows and base. lse: null, or f32 (b*h, sq) that
// receives each row's log-sum-exp. sk in [1, 1 024] (the caller takes this
// kernel for the KV lengths of the TPU kernel's route). bf16: each block
// walks tiles_per_block query tiles of one slice (128 rows, 64 when
// sq <= 64), with V resident in shared memory when v_resident (sk <= 512)
// and streamed otherwise. dtype: 0 = float32, 1 = bfloat16. Launches on
// `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() after the launch, 900 when the driver has no
// cuTensorMapEncodeTiled, 901 for a plan the kernel does not take, or
// 1000 + the driver's error when a tensor map is refused.
extern "C" int m324_flash_single_kv(const void* q, const void* k, const void* v,
                                    void* o, float* lse, int b, int h, int sq,
                                    int sk, const long long* strides,
                                    int tiles_per_block, int v_resident,
                                    float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* st = strides;
  if (sk < 1 || sk > kMaxTiles * kTileN || sq < 1) return 901;
  if (dtype != 1) {
    dim3 grid((sq + kScalarQ - 1) / kScalarQ, b * h);
    single_kv_f32<k6_single_kv><<<grid, kScalarWarps * 32, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, st[0],
        st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
        st[11], h, sq, sk, scale);
    return static_cast<int>(cudaGetLastError());
  }
  const bool one = sq <= 64;
  SkvArgs a;
  a.o = static_cast<bf16*>(o);
  a.lse = lse;
  a.o_bs = st[9];
  a.o_hs = st[10];
  a.o_rs = st[11];
  a.h = h;
  a.sq = sq;
  a.sk = sk;
  a.q_tiles = (sq + (one ? 63 : 127)) / (one ? 64 : 128);
  a.tiles_per_block = tiles_per_block;
  a.scale = scale;
  if (tiles_per_block < 1 || (v_resident && sk > kMaxResidentV * kTileN)) return 901;
  if (one)
    return v_resident ? launch_bf16<1, true>(q, k, v, b, st, a, s)
                      : launch_bf16<1, false>(q, k, v, b, st, a, s);
  return v_resident ? launch_bf16<2, true>(q, k, v, b, st, a, s)
                    : launch_bf16<2, false>(q, k, v, b, st, a, s);
}
