// K8: the binned triangle rasterizer for Hopper (sm_90a).
//
// Replaces the TPU kernel `_raster_kernel` in motion324_tpu/ops/rasterizer.py
// (reached through `_rasterize_impl` and `rasterize`): for every pixel, the
// minimum over the faces that cover it of (int(depth * 2^18), original face
// id), written as findices = face id + 1, 0 where no face covers the pixel.
// Its inputs are the binned coefficients of ops/rasterizer.py `bin_faces`:
// (11, F_pad) f32 rows [bx, by, b0, gx, gy, g0, z0, z1, z2, valid, face id],
// faces sorted by the bottom of their screen bbox, and one bbox per chunk of
// 256 faces.
//
// What bounds it on the H100: the (pixel, face) inside tests of the chunks
// that overlap each pixel tile, a few tens of f32 operations each, on the
// CUDA cores; the bytes (coefficients read once per tile, 4 B per pixel
// written) are small beside them.
//
// What the design does about that: one block of 256 threads per flat tile of
// 1 024 pixels, the TPU kernel's tile, 4 pixels a thread (consecutive
// threads on consecutive pixels, so the stores coalesce). The block walks
// the chunks in order, skips each chunk whose bbox misses its tile with the
// TPU kernel's test (uniform across the block), and stages the chunk's
// coefficients in shared memory, where every thread reads the same face at
// once (a broadcast). Each thread keeps its pixels' running (z, face) minimum
// in registers: no atomics, and the result does not depend on the order of
// anything. The inside test and the depth are rounded as the plain version
// rounds them: __fmul_rn / __fadd_rn keep nvcc from contracting a*b+c into an
// FMA, which would move pixels on the edges of faces. Not yet done: a
// per-face bbox cull inside a chunk (it would change which sliver faces are
// tested, so it needs the plain version to follow), a tile of 2-D shape.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockPx = 1024;   // pixels per tile (flat, row-major)
constexpr int kBlockF = 256;     // faces per chunk
constexpr int kThreads = 256;
constexpr int kPer = kBlockPx / kThreads;
constexpr int kBigZ = 1 << 30;

__global__ void __launch_bounds__(kThreads)
raster_kernel(const float* __restrict__ coeffs, const float4* __restrict__ bbox,
              int* __restrict__ findices, int width, int n_pix, int n_chunks,
              int f_pad) {
  __shared__ float c_s[11][kBlockF];
  const int tid = threadIdx.x;
  const int start = blockIdx.x * kBlockPx;
  // the TPU kernel's tile extent: full rows in y, the tile's own columns in
  // x when a tile is shorter than a row
  const float ty0 = static_cast<float>(start / width);
  const float ty1 = static_cast<float>((start + kBlockPx - 1) / width) + 1.0f;
  float tx0 = 0.0f, tx1 = static_cast<float>(width);
  if (kBlockPx < width) {
    tx0 = static_cast<float>(start % width);
    tx1 = tx0 + static_cast<float>(kBlockPx);
  }
  float px[kPer], py[kPer];
  int zb[kPer], fb[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int flat = start + i * kThreads + tid;
    px[i] = static_cast<float>(flat % width) + 0.5f;
    py[i] = static_cast<float>(flat / width) + 0.5f;
    zb[i] = kBigZ;
    fb[i] = kBigZ;
  }
  for (int c = 0; c < n_chunks; ++c) {
    const float4 b = bbox[c];   // x_min, x_max, y_min, y_max
    if (!(b.y >= tx0 && b.x <= tx1 && b.w >= ty0 && b.z <= ty1)) continue;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 11; ++r)
      c_s[r][tid] = coeffs[static_cast<long long>(r) * f_pad + c * kBlockF + tid];
    __syncthreads();
    for (int j = 0; j < kBlockF; ++j) {
      if (!(c_s[9][j] > 0.5f)) continue;   // degenerate or padded face
      const float bx = c_s[0][j], by = c_s[1][j], b0 = c_s[2][j];
      const float gx = c_s[3][j], gy = c_s[4][j], g0 = c_s[5][j];
      const float z0 = c_s[6][j], z1 = c_s[7][j], z2 = c_s[8][j];
      const int fid = static_cast<int>(c_s[10][j]);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float beta = __fadd_rn(__fadd_rn(__fmul_rn(bx, px[i]),
                                               __fmul_rn(by, py[i])), b0);
        const float gamma = __fadd_rn(__fadd_rn(__fmul_rn(gx, px[i]),
                                                __fmul_rn(gy, py[i])), g0);
        const float alpha = __fsub_rn(__fsub_rn(1.0f, beta), gamma);
        if (alpha >= 0.0f && alpha <= 1.0f && beta >= 0.0f && beta <= 1.0f &&
            gamma >= 0.0f && gamma <= 1.0f) {
          const float depth = __fadd_rn(
              __fadd_rn(__fmul_rn(alpha, z0), __fmul_rn(beta, z1)),
              __fmul_rn(gamma, z2));
          const int zq = __float2int_rz(__fmul_rn(depth, 262144.0f));
          if (zq < zb[i] || (zq == zb[i] && fid < fb[i])) {
            zb[i] = zq;
            fb[i] = fid;
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int flat = start + i * kThreads + tid;
    if (flat < n_pix) findices[flat] = zb[i] < kBigZ ? fb[i] + 1 : 0;
  }
}

}  // namespace

// coeffs: (11, f_pad) f32, f_pad = n_chunks * 256; bbox: (n_chunks, 4) f32;
// findices: (n_pix,) int32, n_pix = width * height. All contiguous on the
// device. Launches on `stream`, allocates nothing, does not synchronise;
// returns cudaGetLastError() after the launch.
extern "C" int m324_rasterize(const void* coeffs, const void* bbox,
                              void* findices, int width, int n_pix,
                              int n_chunks, int f_pad, void* stream) {
  const int tiles = (n_pix + kBlockPx - 1) / kBlockPx;
  raster_kernel<<<tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coeffs), static_cast<const float4*>(bbox),
      static_cast<int*>(findices), width, n_pix, n_chunks, f_pad);
  return static_cast<int>(cudaGetLastError());
}
