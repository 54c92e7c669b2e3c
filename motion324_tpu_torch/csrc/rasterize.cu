// K8: the binned triangle rasterizer for Hopper (sm_90a).
//
// Replaces the TPU kernel `_raster_kernel` in motion324_tpu/ops/rasterizer.py
// (reached through `_rasterize_impl` and `rasterize`): for every pixel, the
// minimum over the faces that cover it of (int(depth * 2^18), original face
// id), written as findices = face id + 1, 0 where no face covers the pixel.
// Its inputs are the binned coefficients of ops/rasterizer.py `bin_faces`:
// (11, F_pad) f32 rows [bx, by, b0, gx, gy, g0, z0, z1, z2, valid, face id],
// faces sorted by the bottom of their screen bbox, and one bbox per chunk of
// 256 faces. A (pixel, face) pair is tested only where the TPU kernel tests
// it: where the bbox of the face's chunk meets the pixel's flat tile of 1 024
// pixels (the TPU kernel's float test). A sliver face may pass the rounded
// test outside that relation, so nothing outside it is ever tested.
//
// What bounds it on the H100: instruction rate and latency, not bytes. The
// bytes (coefficients and chunk bboxes read once, 4 B of findices a pixel)
// take a few microseconds at 3.35 TB/s. The work is one cull evaluation per
// (128-pixel group, face) of the binned relation, one per (32-pixel run,
// face) the group's cull keeps, and one inside test per (pixel, face) of the
// runs that the run cull keeps, each a few tens of f32 instructions on the
// CUDA cores. The test is rounded as the plain version rounds it (__fmul_rn
// / __fadd_rn keep nvcc from contracting a*b+c into an FMA, which would move
// pixels on the edges of faces), so it runs at most half of the 67
// TFLOP/s f32 peak.
//
// The design: a tile's 1 024 pixels are 8 groups of 128 consecutive flat
// pixels, a group is 4 runs of 32, and a lane holds pixel i of each run i
// (neighbouring lanes on neighbouring pixels: the stores coalesce). A block
// holds kGroupsPer of a tile's groups (the tile over 8 / kGroupsPer blocks)
// and kSlices warps a group: one group of 4 warps a block below 4 096
// groups (so a 512^2 view's 256 tiles fill the 132 SMs), else 4 groups of
// one warp a block (the 2 048^2 atlas), the faster of the two on each call.
// The block tests the chunk bboxes together and compacts the hits into a
// list in shared memory (ballot + popc). For each listed chunk the
// block loads the chunk's 256 faces once into shared memory and culls each
// against each of its groups' rectangles, appending the survivors to the
// group's list; then the group's warps split that list 32 faces at a time,
// cull each face against the 4 runs, and test every survivor on every lane,
// only on the runs it may cover, each lane keeping its pixels' running
// (z, face) minimum in registers. The minimum over the total order (z, face
// id) does not depend on the order of the chunks or faces, so the result
// needs no atomics (the lists are filled through a shared counter, in any
// order); a group's warps take the minimum of their minima at the end.
//
// Why the cull is exact. Round-to-nearest is monotone, so fl(bx * px),
// fl(by * py), their rounded sum and that plus b0 are each monotone in px and
// in py (the signs of bx and by give the direction; a signed zero or an
// infinity gives a constant). Over a rectangle R of pixel centres (a group's
// or a run's) the rounded beta therefore lies between its rounded values at
// two opposite corners, beta_lo and beta_hi; gamma likewise. The rounded
// alpha = fl(fl(1 - beta) - gamma) does not grow with beta or gamma, so it
// lies in [fl(fl(1 - beta_hi) - gamma_hi), fl(fl(1 - beta_lo) - gamma_lo)].
// A face is dropped only when one of these bounds lies outside [0, 1] by an
// ordered comparison, which is false on NaN (a NaN bound never drops a
// face), or when it is invalid: then the rounded test fails at every pixel
// of R, and the result is the plain version's bit for bit, slivers
// included. A run's rectangle lies in its group's, so the run cull drops
// every face the group's cull drops. ops/rasterizer.py `face_cull_reference`
// is the same cull in torch, held sound on the CPU by
// tests/test_torch_raster_cull.py.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockPx = 1024;   // pixels per tile (flat, row-major)
constexpr int kBlockF = 256;     // faces per chunk
constexpr int kGroupPx = 128;    // pixels per group: 4 a lane
constexpr int kGroups = kBlockPx / kGroupPx;   // groups per tile
constexpr int kPer = kGroupPx / 32;            // pixels per lane, runs per group
constexpr int kWindow = 1024;    // chunks listed at once
constexpr int kBigZ = 1 << 30;
constexpr unsigned kAll = 0xffffffffu;

// The centres of `n` consecutive flat pixels from `first`, as (x_lo, x_hi,
// y_lo, y_hi): their columns in their row, or the full width when they
// wrap a row.
__device__ __forceinline__ float4 pixel_rect(int first, int n, int width) {
  const int last = first + n - 1;
  const int r0 = first / width, r1 = last / width;
  const bool one_row = r0 == r1;
  return make_float4(static_cast<float>(one_row ? first % width : 0) + 0.5f,
                     static_cast<float>(one_row ? last % width : width - 1) + 0.5f,
                     static_cast<float>(r0) + 0.5f, static_cast<float>(r1) + 0.5f);
}

__device__ __forceinline__ float affine(float a, float b, float c, float x,
                                        float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

// False only if the rounded inside test of the face with coefficients
// (bx, by, b0, gx, gy, g0) = (a.x, a.y, a.z, a.w, b.x, b.y) fails at every
// pixel centre of the rectangle r (the note at the top says why).
__device__ __forceinline__ bool may_cover(float4 a, float4 b, float4 r) {
  const float bx = a.x, by = a.y, b0 = a.z, gx = a.w, gy = b.x, g0 = b.y;
  const float b_hi = affine(bx, by, b0, bx >= 0.0f ? r.y : r.x,
                            by >= 0.0f ? r.w : r.z);
  const float b_lo = affine(bx, by, b0, bx >= 0.0f ? r.x : r.y,
                            by >= 0.0f ? r.z : r.w);
  const float g_hi = affine(gx, gy, g0, gx >= 0.0f ? r.y : r.x,
                            gy >= 0.0f ? r.w : r.z);
  const float g_lo = affine(gx, gy, g0, gx >= 0.0f ? r.x : r.y,
                            gy >= 0.0f ? r.z : r.w);
  const float a_lo = __fsub_rn(__fsub_rn(1.0f, b_hi), g_hi);
  const float a_hi = __fsub_rn(__fsub_rn(1.0f, b_lo), g_lo);
  return !(b_hi < 0.0f) && !(b_lo > 1.0f) && !(g_hi < 0.0f) &&
         !(g_lo > 1.0f) && !(a_hi < 0.0f) && !(a_lo > 1.0f);
}

// The full test of one face, s0..s2 = [bx, by, b0, gx], [gy, g0, z0, z1],
// [z2, face id], on the lane's pixels whose run is in `runs`, rounded as the
// plain version rounds it; with kOneRow the lane's pixels share one row, so
// fl(by * py) and fl(gy * py) are computed once.
template <bool kOneRow>
__device__ __forceinline__ void test_face(float4 s0, float4 s1, float4 s2,
                                          int runs, const float (&px)[kPer],
                                          const float (&py)[kPer],
                                          int (&zb)[kPer], int (&fb)[kPer]) {
  const float bx = s0.x, by = s0.y, b0 = s0.z, gx = s0.w;
  const float gy = s1.x, g0 = s1.y, z0 = s1.z, z1 = s1.w;
  const float z2 = s2.x;
  const int fid = __float_as_int(s2.y);
  const float byp0 = __fmul_rn(by, py[0]), gyp0 = __fmul_rn(gy, py[0]);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (!(runs >> i & 1)) continue;   // the same for the whole warp
    const float byp = kOneRow ? byp0 : __fmul_rn(by, py[i]);
    const float gyp = kOneRow ? gyp0 : __fmul_rn(gy, py[i]);
    const float beta = __fadd_rn(__fadd_rn(__fmul_rn(bx, px[i]), byp), b0);
    const float gamma = __fadd_rn(__fadd_rn(__fmul_rn(gx, px[i]), gyp), g0);
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

// The chunks of [w0, w1) whose bbox meets the tile (the TPU kernel's test),
// compacted in order into `list`; returns their count. All of the block's
// threads call it; it ends synchronised.
template <int kThreads>
__device__ int list_chunks(const float4* __restrict__ bbox, int w0, int w1,
                           float tx0, float tx1, float ty0, float ty1,
                           int* list, int* warp_hits) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int total = 0;
  for (int base = w0; base < w1; base += kThreads) {
    const int c = base + static_cast<int>(threadIdx.x);
    bool hit = false;
    if (c < w1) {
      const float4 b = bbox[c];   // x_min, x_max, y_min, y_max
      hit = b.y >= tx0 && b.x <= tx1 && b.w >= ty0 && b.z <= ty1;
    }
    const unsigned mask = __ballot_sync(kAll, hit);
    if (lane == 0) warp_hits[warp] = __popc(mask);
    __syncthreads();
    int at = total;
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) {
      if (k < warp) at += warp_hits[k];
      total += warp_hits[k];
    }
    if (hit) list[at + __popc(mask & ((1u << lane) - 1u))] = c;
    __syncthreads();
  }
  return total;
}

// Block-wide: chunk c's faces into `faces` (3 float4 a face), and for each
// of the block's groups the faces that may cover its rectangle appended to
// its list (`n_kept` counts them).
template <int kGroupsPer, int kThreads>
__device__ __forceinline__ void stage_chunk(
    const float* __restrict__ coeffs, int f_pad, int c, float4 (*faces)[3],
    unsigned short (*kept)[kBlockF], int* n_kept, const float4 (*rects)[kPer + 1]) {
  const int lane = threadIdx.x & 31;
  for (int f = threadIdx.x; f < kBlockF; f += kThreads) {
    const int col = c * kBlockF + f;
    float v[11];
#pragma unroll
    for (int r = 0; r < 11; ++r)
      v[r] = __ldg(coeffs + static_cast<long long>(r) * f_pad + col);
    const float4 a = make_float4(v[0], v[1], v[2], v[3]);
    const float4 b = make_float4(v[4], v[5], v[6], v[7]);
    faces[f][0] = a;
    faces[f][1] = b;
    faces[f][2] = make_float4(v[8], __int_as_float(static_cast<int>(v[10])),
                              0.0f, 0.0f);
    const bool valid = v[9] > 0.5f;
#pragma unroll
    for (int g = 0; g < kGroupsPer; ++g) {
      const bool hit = valid && may_cover(a, b, rects[g][kPer]);
      const unsigned mask = __ballot_sync(kAll, hit);
      int at = 0;
      if (lane == 0 && mask) at = atomicAdd(&n_kept[g], __popc(mask));
      at = __shfl_sync(kAll, at, 0);
      if (hit) kept[g][at + __popc(mask & ((1u << lane) - 1u))] = f;
    }
  }
}

// One warp's share of its group's listed faces (entries slice * 32 + lane,
// then kSlices * 32 further): each lane culls its face against the 4 runs
// and every lane tests each survivor on the runs it may cover, the next
// survivor's values read while one is tested.
template <int kSlices, bool kOneRow>
__device__ __forceinline__ void test_group(
    const float4 (*faces)[3], const unsigned short* kept, int n, int slice,
    const float4 (&run_rect)[kPer], const float (&px)[kPer],
    const float (&py)[kPer], int (&zb)[kPer], int (&fb)[kPer]) {
  const int lane = threadIdx.x & 31;
  for (int e0 = slice * 32; e0 < n; e0 += kSlices * 32) {
    int f = 0, runs = 0;
    if (e0 + lane < n) {
      f = kept[e0 + lane];
      const float4 a = faces[f][0], b = faces[f][1];
#pragma unroll
      for (int i = 0; i < kPer; ++i) runs |= may_cover(a, b, run_rect[i]) << i;
    }
    unsigned keep = __ballot_sync(kAll, runs != 0);
    if (keep == 0) continue;
    int j = __ffs(keep) - 1;
    int fj = __shfl_sync(kAll, f, j), rj = __shfl_sync(kAll, runs, j);
    float4 s0 = faces[fj][0], s1 = faces[fj][1], s2 = faces[fj][2];
    for (keep &= keep - 1;; keep &= keep - 1) {
      const float4 t0 = s0, t1 = s1, t2 = s2;
      const int t_runs = rj;
      if (keep) {
        j = __ffs(keep) - 1;
        fj = __shfl_sync(kAll, f, j);
        rj = __shfl_sync(kAll, runs, j);
        s0 = faces[fj][0];
        s1 = faces[fj][1];
        s2 = faces[fj][2];
      }
      test_face<kOneRow>(t0, t1, t2, t_runs, px, py, zb, fb);
      if (!keep) break;
    }
  }
}

// A block holds kGroupsPer of a tile's 8 groups (the tile over 8 /
// kGroupsPer blocks) and kSlices warps a group, which split the group's
// listed faces and merge their minima at the end.
template <int kGroupsPer, int kSlices>
__global__ void __launch_bounds__(kGroupsPer * kSlices * 32)
raster_kernel(const float* __restrict__ coeffs, const float4* __restrict__ bbox,
              int* __restrict__ findices, int width, int n_pix, int n_chunks,
              int f_pad) {
  constexpr int kWarps = kGroupsPer * kSlices;
  constexpr int kThreads = kWarps * 32;
  constexpr int kParts = kGroups / kGroupsPer;   // blocks per tile
  __shared__ int list[kWindow];
  __shared__ int warp_hits[kWarps];
  __shared__ float4 faces[kBlockF][3];
  __shared__ unsigned short kept[kGroupsPer][kBlockF];
  __shared__ int n_kept[2][kGroupsPer];   // by parity of the listed chunk
  __shared__ float4 rects[kGroupsPer][kPer + 1];   // runs, then the group
  __shared__ int merge[kSlices > 1 ? kWarps : 1][2][kGroupPx];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = warp / kSlices, slice = warp % kSlices;
  const int start = (blockIdx.x / kParts) * kBlockPx;
  const int block_first = start + (blockIdx.x % kParts) * kGroupsPer * kGroupPx;
  // the TPU kernel's tile extent: full rows in y, the tile's own columns in
  // x when a tile is shorter than a row
  const float ty0 = static_cast<float>(start / width);
  const float ty1 = static_cast<float>((start + kBlockPx - 1) / width) + 1.0f;
  float tx0 = 0.0f, tx1 = static_cast<float>(width);
  if (kBlockPx < width) {
    tx0 = static_cast<float>(start % width);
    tx1 = tx0 + static_cast<float>(kBlockPx);
  }
  if (threadIdx.x < kGroupsPer * (kPer + 1)) {
    const int g = threadIdx.x / (kPer + 1), k = threadIdx.x % (kPer + 1);
    const int first = block_first + g * kGroupPx;
    rects[g][k] = k < kPer ? pixel_rect(first + k * 32, 32, width)
                           : pixel_rect(first, kGroupPx, width);
  }
  if (threadIdx.x < 2 * kGroupsPer) n_kept[threadIdx.x / kGroupsPer][threadIdx.x % kGroupsPer] = 0;
  __syncthreads();
  float4 run_rect[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) run_rect[i] = rects[group][i];
  const bool one_row = rects[group][kPer].z == rects[group][kPer].w;
  const int first = block_first + group * kGroupPx;
  float px[kPer], py[kPer];
  int zb[kPer], fb[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int flat = first + i * 32 + lane;
    px[i] = static_cast<float>(flat % width) + 0.5f;
    py[i] = static_cast<float>(flat / width) + 0.5f;
    zb[i] = kBigZ;
    fb[i] = kBigZ;
  }
  int parity = 0;
  for (int w0 = 0; w0 < n_chunks; w0 += kWindow) {
    const int n_list = list_chunks<kThreads>(
        bbox, w0, min(n_chunks, w0 + kWindow), tx0, tx1, ty0, ty1, list,
        warp_hits);
    for (int k = 0; k < n_list; ++k, parity ^= 1) {
      // the other parity's counts were read before the last barrier
      if (threadIdx.x < kGroupsPer) n_kept[parity ^ 1][threadIdx.x] = 0;
      stage_chunk<kGroupsPer, kThreads>(coeffs, f_pad, list[k], faces, kept,
                                        n_kept[parity], rects);
      __syncthreads();
      const int n = n_kept[parity][group];
      if (one_row)
        test_group<kSlices, true>(faces, kept[group], n, slice, run_rect, px,
                                  py, zb, fb);
      else
        test_group<kSlices, false>(faces, kept[group], n, slice, run_rect,
                                   px, py, zb, fb);
      __syncthreads();   // the next chunk overwrites the faces and lists
    }
  }
  if (kSlices > 1) {
    // a group's first warp takes the minimum over the group's warps (any
    // order: a total order)
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      merge[warp][0][i * 32 + lane] = zb[i];
      merge[warp][1][i * 32 + lane] = fb[i];
    }
    __syncthreads();
    if (slice != 0) return;
#pragma unroll
    for (int s = 1; s < kSlices; ++s) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int z = merge[warp + s][0][i * 32 + lane];
        const int f = merge[warp + s][1][i * 32 + lane];
        if (z < zb[i] || (z == zb[i] && f < fb[i])) {
          zb[i] = z;
          fb[i] = f;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int flat = first + i * 32 + lane;
    if (flat < n_pix) findices[flat] = zb[i] < kBigZ ? fb[i] + 1 : 0;
  }
}

template <int kGroupsPer, int kSlices>
int launch(const void* coeffs, const void* bbox, void* findices, int width,
           int n_pix, int n_chunks, int f_pad, cudaStream_t stream) {
  const int tiles = (n_pix + kBlockPx - 1) / kBlockPx;
  raster_kernel<kGroupsPer, kSlices>
      <<<tiles * (kGroups / kGroupsPer), kGroupsPer * kSlices * 32, 0, stream>>>(
          static_cast<const float*>(coeffs), static_cast<const float4*>(bbox),
          static_cast<int*>(findices), width, n_pix, n_chunks, f_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// coeffs: (11, f_pad) f32, f_pad = n_chunks * 256; bbox: (n_chunks, 4) f32,
// 16-byte aligned; findices: (n_pix,) int32, n_pix = width * height. All
// contiguous on the device. Launches on `stream`, allocates nothing, does
// not synchronise; returns cudaGetLastError() after the launch.
extern "C" int m324_rasterize(const void* coeffs, const void* bbox,
                              void* findices, int width, int n_pix,
                              int n_chunks, int f_pad, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int groups = (n_pix + kBlockPx - 1) / kBlockPx * kGroups;
  // below 4 096 groups one warp a group would not fill the card (about 32
  // warps an SM); so there a group gets 4 warps
  if (groups < 4096)
    return launch<1, 4>(coeffs, bbox, findices, width, n_pix, n_chunks,
                        f_pad, s);
  return launch<4, 1>(coeffs, bbox, findices, width, n_pix, n_chunks, f_pad,
                      s);
}
