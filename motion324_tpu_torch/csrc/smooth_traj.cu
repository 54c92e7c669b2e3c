// Trajectory smoothing and the Blender remap for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package smooths on the host in numpy
// (motion324_tpu/inference/smoothing.py `smooth_trajectories`, then
// inference/pipeline.py `to_blender_coords`). It was added so that a clip's
// (B, T, N, 3) trajectory field, the model's output on the card, crosses to
// the host once and finished: the host walked the field frame by frame
// three times (the freeze scan, scipy's line-by-line Gaussian, the remap's
// two copies), about half a second a 256-frame clip while the card idled.
//
// The function (ops/smooth_traj.py `smooth_traj_reference` is its plain
// version, and both equal numpy's and scipy's results bit for bit):
// - freeze (`threshold`, `combined`): f[0] = x[0]; f[t] = f[t-1] where the
//   raw step |x[t] - x[t-1]| lies below the threshold, else x[t]. The step
//   is rounded as numpy's norm rounds it, sqrt((dx*dx + dy*dy) + dz*dz) in
//   f32 with every operation rounded on its own (__fsub_rn, __fmul_rn,
//   __fadd_rn, __fsqrt_rn: nvcc contracts nothing into an FMA), so the
//   frozen set is numpy's;
// - Gaussian (`gaussian`, `combined`): scipy's gaussian_filter1d over time
//   with mode "nearest", taps w[0..r] computed on the host in f64 as scipy
//   computes them; as scipy's symmetric correlate1d, in f64:
//   w[0] * f[t], then + (f[t-j] + f[t+j]) * w[j] for j = r down to 1,
//   indices clamped to [0, T-1], rounded to f32 once;
// - store (x, -z, y), the Blender remap.
//
// What bounds it on the H100: bytes. The field is read once and written
// once, 2 * B*T*N*12 bytes: 124 MB at (1, 256, 20 164), 37 us at 3.35 TB/s.
// The f64 taps are 9 products and 16 sums a value at r = 4, far below the
// card's 67 TFLOP/s f64.
//
// The design: one thread per point (b, n) streams its T frames once (the
// freeze scan carries f[t-1] from frame to frame). Neighbouring threads hold
// neighbouring points, so a warp's loads and stores of a frame cover 384
// contiguous bytes. A thread loads kAhead frames at a time, all in flight
// together, since a 20 164-point field gives each SM only about five warps.
// The last 2r+1 frozen frames stay in registers (r is a template parameter,
// 0 to 8; r = 0 stores the frozen frame itself), shifted by one a frame;
// frame t's output is stored once frame t+r has been read, and the last r
// outputs repeat f[T-1] at the end, as mode "nearest" does.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxRadius = 8;
constexpr int kThreads = 64;
constexpr int kAhead = 16;

struct Taps {
  double w[kMaxRadius + 1];
};

struct P3 {
  float x, y, z;
};

__device__ __forceinline__ P3 load(const float* p) {
  return {__ldcs(p), __ldcs(p + 1), __ldcs(p + 2)};
}

// (x, y, z) stored as (x, -z, y)
__device__ __forceinline__ void store_blender(float* p, P3 v) {
  __stcs(p, v.x);
  __stcs(p + 1, -v.z);
  __stcs(p + 2, v.y);
}

// numpy's `norm(a - b) < threshold` in f32, each operation rounded alone
__device__ __forceinline__ bool below(P3 a, P3 b, float threshold) {
  const float dx = __fsub_rn(a.x, b.x);
  const float dy = __fsub_rn(a.y, b.y);
  const float dz = __fsub_rn(a.z, b.z);
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                            __fmul_rn(dz, dz));
  return __fsqrt_rn(s) < threshold;
}

template <int R>
__device__ __forceinline__ float taps_at(const float (&v)[2 * R + 1],
                                         const Taps& taps) {
  double acc = __dmul_rn(static_cast<double>(v[R]), taps.w[0]);
#pragma unroll
  for (int j = R; j >= 1; --j)
    acc = __dadd_rn(acc, __dmul_rn(__dadd_rn(static_cast<double>(v[R - j]),
                                             static_cast<double>(v[R + j])),
                                   taps.w[j]));
  return __double2float_rn(acc);
}

template <int R>
struct Window {
  float x[2 * R + 1], y[2 * R + 1], z[2 * R + 1];

  __device__ __forceinline__ void fill(P3 v) {
#pragma unroll
    for (int i = 0; i <= 2 * R; ++i) {
      x[i] = v.x;
      y[i] = v.y;
      z[i] = v.z;
    }
  }

  __device__ __forceinline__ void push(P3 v) {
#pragma unroll
    for (int i = 0; i < 2 * R; ++i) {
      x[i] = x[i + 1];
      y[i] = y[i + 1];
      z[i] = z[i + 1];
    }
    x[2 * R] = v.x;
    y[2 * R] = v.y;
    z[2 * R] = v.z;
  }

  // the output of the window's centre frame
  __device__ __forceinline__ P3 out(const Taps& taps) const {
    if (R == 0) return {x[0], y[0], z[0]};
    return {taps_at<R>(x, taps), taps_at<R>(y, taps), taps_at<R>(z, taps)};
  }
};

template <int R, bool kFreeze>
__global__ void __launch_bounds__(kThreads)
    smooth_kernel(const float* __restrict__ in, float* __restrict__ out,
                  int frames, int n_points, long long points, float threshold,
                  Taps taps) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (p >= points) return;
  const long long b = p / n_points, n = p % n_points;
  const long long step = 3LL * n_points;              // floats a frame
  const long long first = (b * frames * n_points + n) * 3;
  const float* src = in + first;
  float* dst = out + first;

  P3 raw = load(src), kept = raw;
  Window<R> win;
  win.fill(raw);
  if (R == 0) store_blender(dst, win.out(taps));
  for (int t0 = 1; t0 < frames; t0 += kAhead) {
    P3 ahead[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (t0 + k < frames) ahead[k] = load(src + (t0 + k) * step);
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int t = t0 + k;
      if (t < frames) {
        const P3 next = ahead[k];
        kept = (kFreeze && below(next, raw, threshold)) ? kept : next;
        raw = next;
        win.push(kept);
        if (t >= R) store_blender(dst + (t - R) * step, win.out(taps));
      }
    }
  }
  // frames T .. T+R-1 repeat f[T-1] (mode "nearest"); frame s - R is
  // finished at s
  for (int s = frames; s < frames + R; ++s) {
    win.push(kept);
    if (s >= R) store_blender(dst + (s - R) * step, win.out(taps));
  }
}

template <int R, bool kFreeze>
int launch(const void* in, void* out, int batch, int frames, int n_points,
           float threshold, const Taps& taps, cudaStream_t stream) {
  const long long points = static_cast<long long>(batch) * n_points;
  const unsigned blocks =
      static_cast<unsigned>((points + kThreads - 1) / kThreads);
  smooth_kernel<R, kFreeze><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(in), static_cast<float*>(out), frames,
      n_points, points, threshold, taps);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch_r(int freeze, const void* in, void* out, int batch, int frames,
             int n_points, float threshold, const Taps& taps,
             cudaStream_t stream) {
  return freeze ? launch<R, true>(in, out, batch, frames, n_points, threshold,
                                  taps, stream)
                : launch<R, false>(in, out, batch, frames, n_points,
                                   threshold, taps, stream);
}

}  // namespace

// in, out: (batch, frames, n_points, 3) f32, contiguous on the device, not
// overlapping; batch, frames, n_points >= 1. freeze: 1 for the freeze scan
// at `threshold`. taps: radius + 1 host f64 values w[0..radius] (radius 0
// to 8; radius 0 keeps the frozen frames as they are). Launches on
// `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// radius or size it does not take.
extern "C" int m324_smooth_traj(const void* in, void* out, int batch,
                                int frames, int n_points, int freeze,
                                float threshold, int radius,
                                const double* taps, void* stream) {
  if (batch < 1 || frames < 1 || n_points < 1 || radius < 0 ||
      radius > kMaxRadius)
    return static_cast<int>(cudaErrorInvalidValue);
  Taps t{};
  for (int j = 0; j <= radius; ++j) t.w[j] = taps[j];
  const auto s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 0: return launch_r<0>(freeze, in, out, batch, frames, n_points, threshold, t, s);
    case 1: return launch_r<1>(freeze, in, out, batch, frames, n_points, threshold, t, s);
    case 2: return launch_r<2>(freeze, in, out, batch, frames, n_points, threshold, t, s);
    case 3: return launch_r<3>(freeze, in, out, batch, frames, n_points, threshold, t, s);
    case 4: return launch_r<4>(freeze, in, out, batch, frames, n_points, threshold, t, s);
    case 5: return launch_r<5>(freeze, in, out, batch, frames, n_points, threshold, t, s);
    case 6: return launch_r<6>(freeze, in, out, batch, frames, n_points, threshold, t, s);
    case 7: return launch_r<7>(freeze, in, out, batch, frames, n_points, threshold, t, s);
    default: return launch_r<8>(freeze, in, out, batch, frames, n_points, threshold, t, s);
  }
}
