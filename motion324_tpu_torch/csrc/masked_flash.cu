// K7: voxel-masked flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` in
// motion324_tpu/ops/masked_attention.py (reached through
// `masked_flash_attention`, the turbo multiview attention of the paint
// UNet): exact attention over (B, H, S, 64) in which query i sees key j only
// where their voxel-cell positions lie within the radius,
//
//     d2 = |pq|^2 + |pk|^2 - 2 pq.pk < r^2,
//
// from the (B, S, 3) f32 positions, shared by the heads of a batch. d2 is
// taken in f32 in exactly that order with __fmul_rn / __fadd_rn, so that
// nvcc cannot contract it into FMAs and flip mask bits against the plain
// version. Masked logits are -1e30, as in the TPU kernel; a real row always
// keeps its own key (d2 = 0), so it is never fully masked.
//
// What bounds it on the H100: the work over the key tiles that hold a kept
// pair, 4 x 128 x 128 x 64 flops per listed (query tile, key tile) and
// head, on the tensor cores; the mask test itself, about 10 f32 operations
// per pair, once per batch (not per head).
//
// What the design does about that, in two launches:
// - The pre-pass (mask_bits) evaluates the test for every (query, key)
//   pair of each batch once, shared by its heads: one block per
//   (128-query tile, 128-key tile, batch), one thread per query row. It
//   writes the mask bits, (B, S padded to 128, S / 32 padded to 4) u32,
//   and one flag per tile, set where the tile holds a kept pair: a tile
//   whose cells are all out of reach is never visited. The flags are exact
//   by construction: they are the OR of the bits. The diagonal tile always
//   holds a kept pair.
// - The main loop is K1's kernel (hopper_fwd.cuh: a TMA producer warp
//   feeding 128-key tiles to wgmma consumer warpgroups) under K7's tag,
//   whose tile policy (VoxelTiles) makes each block compact its query
//   tile's flags into an ordered list of key tiles in shared memory, load
//   only those, and set the logits whose bit is clear to -1e30 before the
//   online softmax.
//   Skipping is exact: a skipped tile holds no kept key of any row, so its
//   contribution exp(-1e30 - m) is 0 for every row that has a kept key; a
//   row that has kept no key yet gives its masked logits p = 0 (not the
//   reference's exp(0) over a fully masked row, which no real row is: each
//   keeps its own key, in the diagonal tile). q, k, v and o go through their
//   (batch, head, row) strides, so the UNet's (B, S, H, 64) views need no
//   copy. Never split.
//
// The f32 variant runs scalar FMA with the test per element and is a
// checking path; it needs no pre-pass.

#include "hopper_fwd.cuh"

using namespace m324;

namespace {

struct k7_masked_flash : fwd::VoxelTiles {};   // fwd_bf16<..., k7_masked_flash>

constexpr int kTile = fwd::kMaskTile;

__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// d2 < r2 for one (query, key) pair; q / k hold x, y, z, |p|^2
__device__ __forceinline__ bool within(float4 q, float4 k, float r2) {
  const float cross = __fadd_rn(__fadd_rn(__fmul_rn(q.x, k.x), __fmul_rn(q.y, k.y)),
                                __fmul_rn(q.z, k.z));
  return __fsub_rn(__fadd_rn(q.w, k.w), __fmul_rn(2.0f, cross)) < r2;
}

// The position of token `i` of one batch, with its squared norm; tokens at
// or past `s` (padded query rows) sit at 1e6, out of every radius.
__device__ __forceinline__ float4 position(const float* pos, int i, int s) {
  float x = 1e6f, y = 1e6f, z = 1e6f;
  if (i < s) {
    x = pos[3 * i];
    y = pos[3 * i + 1];
    z = pos[3 * i + 2];
  }
  return make_float4(x, y, z, norm2(x, y, z));
}

// The pre-pass: block (kt, qt, b), thread t owns query row 128 qt + t and
// writes its 4 words over key tile kt (keys past s, and rows past s, clear);
// the block's OR is the tile's flag.
__global__ void __launch_bounds__(kTile)
mask_bits(const float* __restrict__ pos, uint32_t* __restrict__ bits,
          unsigned char* __restrict__ flags, int s, float r2) {
  __shared__ float4 pk[kTile];
  const int t = threadIdx.x, kt = blockIdx.x, qt = blockIdx.y, b = blockIdx.z;
  const int tiles = gridDim.x;
  const float* pb = pos + (long long)b * 3 * s;
  pk[t] = position(pb, kt * kTile + t, s);
  __syncthreads();
  const int row = qt * kTile + t;
  const float4 pq = position(pb, row, s);
  const int n = row < s ? min(kTile, s - kt * kTile) : 0;   // keys to test
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t x = 0;
#pragma unroll
    for (int e = 0; e < 32; ++e)
      if (32 * i + e < n && within(pq, pk[32 * i + e], r2)) x |= 1u << e;
    w[i] = x;
  }
  const long long words = 4LL * tiles;
  *reinterpret_cast<uint4*>(bits + ((long long)b * tiles * kTile + row) * words +
                            4 * kt) = make_uint4(w[0], w[1], w[2], w[3]);
  const int any = __syncthreads_or((w[0] | w[1] | w[2] | w[3]) != 0);
  if (t == 0) flags[((long long)b * tiles + qt) * tiles + kt] = any != 0;
}

int launch_mask_bits(const float* pos, uint32_t* bits, unsigned char* flags,
                     int b, int s, float r2, cudaStream_t st) {
  const int tiles = (s + kTile - 1) / kTile;
  mask_bits<<<dim3(tiles, tiles, b), kTile, 0, st>>>(pos, bits, flags, s, r2);
  return static_cast<int>(cudaGetLastError());
}

struct ScalarVoxelMask {
  const float* pos;
  int s;
  float r2;
  __device__ __forceinline__ bool operator()(int row, int key) const {
    return within(position(pos, row, s), position(pos, key, s), r2);
  }
};

// q, k, v, o: (batch, head, row) strides in elements, in that order
struct Strides {
  long long v[12];
};

__global__ void __launch_bounds__(kScalarWarps * 32)
masked_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ pos,
               float* __restrict__ o, const Strides st, int h, int s,
               float scale, float r2) {
  __shared__ float smem[kScalarSmemFloats];
  const long long b = blockIdx.y / h, hh = blockIdx.y % h;
  const long long* x = st.v;
  const ScalarVoxelMask keep{pos + b * 3 * s, s, r2};
  scalar_attend(q + b * x[0] + hh * x[1], k + b * x[3] + hh * x[4],
                v + b * x[6] + hh * x[7], o + b * x[9] + hh * x[10], nullptr,
                x[2], x[5], x[8], x[11], 1, s, s, blockIdx.x * kScalarQ, scale,
                smem, keep);
}

}  // namespace

// The pre-pass alone: pos (b, s, 3) f32 contiguous; bits (b, T * 128, 4 T)
// u32 and flags (b, T, T) u8, T = ceil(s / 128), written in full (the
// layout of m324::fwd::TileMask). Returns cudaGetLastError() after the
// launch.
extern "C" int m324_masked_bits(const float* pos, uint32_t* bits,
                                unsigned char* flags, int b, int s, float r2,
                                void* stream) {
  return launch_mask_bits(pos, bits, flags, b, s, r2,
                          static_cast<cudaStream_t>(stream));
}

// q, k, v, o: (b, h, s, 64), self-attention, each through its (batch, head,
// row) strides in elements (strides[0..11]: q, k, v, o), unit stride within
// a row, 16-byte-aligned rows and base; pos: (b, s, 3) f32 contiguous, the
// positions of batch i shared by its h heads. r2: the squared radius.
// dtype 1 (bfloat16): the pre-pass writes bits and flags (as for
// m324_masked_bits; the caller's workspace, read by the main loop), then
// the main loop runs; dtype 0 (float32): the scalar kernel alone (bits and
// flags unused, may be null). Launches on `stream`, allocates nothing, does
// not synchronise; returns 0, a CUDA error, 900 without
// cuTensorMapEncodeTiled, or 1000 + the tensor-map
// encoder's error.
extern "C" int m324_masked_flash(const void* q, const void* k, const void* v,
                                 const float* pos, void* o, uint32_t* bits,
                                 unsigned char* flags, int b, int h, int s,
                                 const long long* strides, float scale,
                                 float r2, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 1) {
    Strides x;
    for (int i = 0; i < 12; ++i) x.v[i] = strides[i];
    dim3 grid((s + kScalarQ - 1) / kScalarQ, b * h);
    masked_fwd_f32<<<grid, kScalarWarps * 32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), pos, static_cast<float*>(o), x, h, s,
        scale, r2);
    return static_cast<int>(cudaGetLastError());
  }
  int rc = launch_mask_bits(pos, bits, flags, b, s, r2, st);
  if (rc != 0) return rc;
  const int tiles = (s + kTile - 1) / kTile;
  const fwd::TileMask mask{bits, flags, 4 * tiles, tiles};
  long long st15[15];
  for (int i = 0; i < 12; ++i) st15[i] = strides[i];
  st15[12] = st15[13] = st15[14] = 0;   // no LSE
  return fwd::fwd_entry<k7_masked_flash>(q, k, v, o, nullptr, nullptr, nullptr,
                                         nullptr, 0, b, h, s, s, st15, 1,
                                         scale, 1, stream, &mask);
}
