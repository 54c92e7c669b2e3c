// K7: voxel-masked flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` in
// motion324_tpu/ops/masked_attention.py (reached through
// `masked_flash_attention`, the turbo multiview attention of the paint
// UNet): exact attention over (B*H, S, 64) in which query i sees key j only
// where their voxel-cell positions lie within the radius,
//
//     d2 = |pq|^2 + |pk|^2 - 2 pq.pk < r^2,
//
// the mask rebuilt per tile from the (B, S, 3) f32 positions (shared by the
// heads of a batch) instead of read from an (S, S) array. d2 is taken in f32
// in exactly that order with __fmul_rn / __fadd_rn, so that nvcc cannot
// contract it into FMAs and flip mask bits against the plain version. Masked
// logits are -1e30, as in the TPU kernel; a real row always keeps its own
// key (d2 = 0), so it is never fully masked.
//
// What bounds it on the H100: the dense work, 4 S^2 64 flops per head, on
// the tensor cores (the kernel does not skip masked tiles yet), against
// q, k, v, o and the positions read or written once.
//
// What the design does about that: K1's design (flash_fwd.cu), one block of
// 4 warps per (batch*head, 64-query tile), both products on the tensor cores
// (mma.sync bf16, f32 accumulation), with the key positions of each 64-key
// chunk staged in shared memory beside K and V (x, y, z and |pk|^2) and each
// thread's two query rows' positions in registers. Not yet done: skipping
// the tiles whose cells are all out of reach (most of them at 6 views),
// wgmma/TMA.
//
// The f32 variant runs scalar FMA for the products and is a checking path.

#include "attention_common.cuh"

using namespace m324;

namespace {

constexpr int kWarps = 4;
constexpr int kBlockQ = 16 * kWarps;

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

struct VoxelMask {
  float4 q[2];        // rows g and g + 8
  const float4* pk;   // the chunk's key positions in shared memory
  float r2;
  __device__ __forceinline__ void operator()(float (&s)[8][4], int, int t) const {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 k = pk[8 * j + 2 * t + e];
        if (!within(q[0], k, r2)) s[j][e] = kNegInf;
        if (!within(q[1], k, r2)) s[j][2 + e] = kNegInf;
      }
    }
  }
};

__global__ void __launch_bounds__(kWarps * 32)
masked_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const float* __restrict__ pos,
                bf16* __restrict__ o, int heads, int s, float scale, float r2) {
  __shared__ uint4 smem_raw[(kBlockQ + 2 * kKeys) * kRow * sizeof(bf16) / 16];
  __shared__ float4 pk_s[kKeys];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kBlockQ * kRow;
  bf16* v_s = k_s + kKeys * kRow;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kBlockQ;
  const long long bh = blockIdx.y;
  const float* pb = pos + (bh / heads) * 3LL * s;
  const bf16* qb = q + bh * s * kD;
  const bf16* kb = k + bh * s * kD;
  const bf16* vb = v + bh * s * kD;

  load_rows_bf16(q_s, qb, kD, row0, kBlockQ, s, scale, tid, kWarps * 32);
  __syncthreads();
  WarpAttn st;
  st.init(q_s + warp * 16 * kRow, lane);
  VoxelMask mask;
  const int g = lane >> 2;
  mask.q[0] = position(pb, row0 + warp * 16 + g, s);
  mask.q[1] = position(pb, row0 + warp * 16 + g + 8, s);
  mask.pk = pk_s;
  mask.r2 = r2;

  for (int kv0 = 0; kv0 < s; kv0 += kKeys) {
    __syncthreads();
    load_rows_bf16(k_s, kb, kD, kv0, kKeys, s, 1.0f, tid, kWarps * 32);
    load_rows_bf16(v_s, vb, kD, kv0, kKeys, s, 1.0f, tid, kWarps * 32);
    if (tid < kKeys) pk_s[tid] = position(pb, kv0 + tid, s);
    __syncthreads();
    st.step(k_s, v_s, min(kKeys, s - kv0), lane, mask);
  }
  st.store(o + bh * s * kD, kD, row0 + warp * 16, s, lane, nullptr, 1);
}

struct ScalarVoxelMask {
  const float* pos;
  int s;
  float r2;
  __device__ __forceinline__ bool operator()(int row, int key) const {
    return within(position(pos, row, s), position(pos, key, s), r2);
  }
};

__global__ void __launch_bounds__(kScalarWarps * 32)
masked_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ pos,
               float* __restrict__ o, int heads, int s, float scale, float r2) {
  __shared__ float smem[kScalarSmemFloats];
  const long long bh = blockIdx.y;
  const ScalarVoxelMask keep{pos + (bh / heads) * 3LL * s, s, r2};
  scalar_attend(q + bh * s * kD, k + bh * s * kD, v + bh * s * kD,
                o + bh * s * kD, nullptr, kD, kD, kD, kD, 1, s, s,
                blockIdx.x * kScalarQ, scale, smem, keep);
}

}  // namespace

// q, k, v, o: (B*H, s, 64), self-attention; pos: (B, s, 3) f32, the
// positions of batch b shared by its `heads` heads; all contiguous, 16-byte
// aligned. r2: the squared radius. dtype: 0 = float32, 1 = bfloat16.
// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() after the launch.
extern "C" int m324_masked_flash(const void* q, const void* k, const void* v,
                                 const float* pos, void* o, int bh, int heads,
                                 int s, float scale, float r2, int dtype,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    dim3 grid((s + kBlockQ - 1) / kBlockQ, bh);
    masked_fwd_bf16<<<grid, kWarps * 32, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), pos, static_cast<bf16*>(o), heads, s,
        scale, r2);
  } else {
    dim3 grid((s + kScalarQ - 1) / kScalarQ, bh);
    masked_fwd_f32<<<grid, kScalarWarps * 32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), pos, static_cast<float*>(o), heads, s,
        scale, r2);
  }
  return static_cast<int>(cudaGetLastError());
}
