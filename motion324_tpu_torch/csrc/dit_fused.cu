// The elementwise chains around the Hunyuan3D-2.0 DiT's GEMMs
// (hy3dgen/dit.py), each as one pass, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves these chains to XLA, which
// fuses them. In eager PyTorch each was a row of launches that passed its
// tensor through device memory several times, in f32 where a step cast:
// the QK-RMSNorm eight launches (cast, pow, mean, +eps, rsqrt, multiply,
// cast, scale), the adaLN modulation four, the gated residual two and the
// single block's GELU + concat two. ops/dit_fused.py holds the plain
// versions, which are the parent's expressions as they were.
//
// - dit_rmsnorm: x * rsqrt(mean(x^2) + eps) over the head dim, the
//   statistics in f32, the product rounded to x's dtype, then times the
//   scale in x's dtype. x is (B, L, H, D), read through its (batch, row,
//   head) strides (q or k as a view of the qkv GEMM's output); the output
//   is a contiguous (B, L, H, D).
// - dit_modulate: (1 + scale) * layer_norm(x) + shift over the width C
//   (eps, no affine), the statistics in f32; shift and scale are (B, 1, C)
//   rows read through their batch strides, never expanded. x is (B, L, C)
//   through its (batch, row) strides (the final layer's x is a slice of
//   the merged stream).
// - dit_gate: x + gate * y, gate a (B, 1, C) row.
// - dit_gelu_cat: [attn | gelu_tanh(mlp)] along the last dim, mlp read
//   through the strides of linear1's output.
//
// Each intermediate is rounded to the tensor's dtype where PyTorch's
// composition rounds it: the norms' product before the scale; 1 + scale,
// the product and the sum of the modulation; gate * y before the add. Every
// f32 operation that the composition does in a launch of its own is written
// with the _rn intrinsics, so nvcc contracts none of them into an FMA. The
// GELU is PyTorch's tanh formula as PyTorch's CUDA kernel writes it, in f32,
// built without --use_fast_math (tanhf, not tanh.approx), so the gate and
// the GELU + concat equal PyTorch bit for bit. The norms take their sums in
// another order than PyTorch's reductions (two passes over registers where
// layer_norm runs Welford's), so a norm may differ by one ulp of x's dtype
// (where layer_norm's centering cancels, by the f32 mean's last bit).
//
// What bounds them on the H100: bytes. Each reads its inputs once and
// writes its output once (the (B, 1, C) rows stay in L1 and L2); the GELU's
// tanhf is about 20 f32 operations a value, below the card's rate at
// 3.35 TB/s. The design: 16-byte loads and stores (8 bf16 or 4 f32 a
// thread); the wrappers refuse rows whose pointers, strides or widths do
// not allow them (every DiT the repo builds hands over such rows). The
// two norms give a row to a group of `group` lanes (a power of two up to
// 32, chosen by the host so that each lane holds NV vectors of the row in
// registers: D = 64 in bf16 is 8 lanes of one vector, C = 1 024 a warp of
// 4), sum across the group with shuffles, and write from the registers, so
// a row is read once. The gate and the concat give a vector to a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNV = 8;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back: where PyTorch stores an intermediate tensor
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&f)[V]) {
  const Pack<T, V> pk = load_pack<T, V>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) f[i] = to_f<T>(pk.v[i]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&f)[V]) {
  Pack<T, V> pk;
#pragma unroll
  for (int i = 0; i < V; ++i) pk.v[i] = from_f<T>(f[i]);
  *reinterpret_cast<Pack<T, V>*>(p) = pk;
}

// the sum of `v` over the `group` lanes that share a row (group a power of
// two dividing 32, groups aligned to it); every lane of the warp calls it
__device__ __forceinline__ float group_sum(float v, int group) {
  for (int o = group / 2; o > 0; o /= 2)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The row a lane serves and its place in the row: rows of `len` values,
// each lane NV vectors of V at columns (j * group + lane) * V.
struct RowLane {
  unsigned row;
  int lane;
  bool active;
};

__device__ __forceinline__ RowLane row_lane(unsigned rows, int group) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  return {t / group, static_cast<int>(t % group), t / group < rows};
}

template <typename T, int V, int NV>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   T* __restrict__ out, unsigned rows, unsigned len_l,
                   unsigned heads, int d, long long sb, long long sl,
                   long long sh, int group, float inv_d, float eps) {
  const RowLane rl = row_lane(rows, group);
  const unsigned h = rl.row % heads, bl = rl.row / heads;
  const unsigned l = bl % len_l, b = bl / len_l;
  const T* src = x + b * sb + l * sl + h * sh;
  T* dst = out + static_cast<long long>(rl.row) * d;
  float v[NV][V];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = (j * group + rl.lane) * V;
    if (rl.active && col < d) {
      load<T, V>(src + col, v[j]);
#pragma unroll
      for (int i = 0; i < V; ++i) ss = __fadd_rn(ss, __fmul_rn(v[j][i], v[j][i]));
    }
  }
  ss = group_sum(ss, group);
  const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, inv_d), eps));
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = (j * group + rl.lane) * V;
    if (rl.active && col < d) {
      float w[V], o[V];
      load<T, V>(scale + col, w);
#pragma unroll
      for (int i = 0; i < V; ++i)
        o[i] = __fmul_rn(round_to<T>(__fmul_rn(v[j][i], r)), w[i]);
      store<T, V>(dst + col, o);
    }
  }
}

// The row stays in registers as loaded (8 bf16 a 16-byte vector: half the
// registers of f32 values), so that more rows are in flight on an SM; the
// shift and scale vectors, which every row of a batch shares, come from L1
// or L2 one vector at a time as the row is written.
template <typename T, int V, int NV>
__global__ void __launch_bounds__(kThreads)
    modulate_kernel(const T* __restrict__ x, const T* __restrict__ shift,
                    const T* __restrict__ scale, T* __restrict__ out,
                    unsigned rows, unsigned len_l, int c, long long sxb,
                    long long sxl, long long sshift, long long sscale,
                    int group, float inv_c, float eps) {
  const RowLane rl = row_lane(rows, group);
  const unsigned l = rl.row % len_l, b = rl.row / len_l;
  const T* src = x + b * sxb + l * sxl;
  const T* shift_b = shift + b * sshift;
  const T* scale_b = scale + b * sscale;
  T* dst = out + static_cast<long long>(rl.row) * c;
  Pack<T, V> v[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = (j * group + rl.lane) * V;
    if (rl.active && col < c) v[j] = load_pack<T, V>(src + col);
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = (j * group + rl.lane) * V;
    if (rl.active && col < c) {
#pragma unroll
      for (int i = 0; i < V; ++i) s = __fadd_rn(s, to_f<T>(v[j].v[i]));
    }
  }
  const float mean = __fmul_rn(group_sum(s, group), inv_c);
  float m2 = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = (j * group + rl.lane) * V;
    if (rl.active && col < c) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float e = __fsub_rn(to_f<T>(v[j].v[i]), mean);
        m2 = __fadd_rn(m2, __fmul_rn(e, e));
      }
    }
  }
  const float rstd =
      rsqrtf(__fadd_rn(__fmul_rn(group_sum(m2, group), inv_c), eps));
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = (j * group + rl.lane) * V;
    if (rl.active && col < c) {
      float sh[V], sc[V], o[V];
      load<T, V>(shift_b + col, sh);
      load<T, V>(scale_b + col, sc);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float n = round_to<T>(
            __fmul_rn(rstd, __fsub_rn(to_f<T>(v[j].v[i]), mean)));
        const float p = round_to<T>(__fmul_rn(round_to<T>(__fadd_rn(1.f, sc[i])), n));
        o[i] = __fadd_rn(p, sh[i]);
      }
      store<T, V>(dst + col, o);
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    gate_kernel(const T* __restrict__ x, const T* __restrict__ gate,
                const T* __restrict__ y, T* __restrict__ out, unsigned vecs,
                unsigned row_vecs, unsigned len_l, long long sxb,
                long long sxl, long long syb, long long syl, long long sg) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= vecs) return;
  const unsigned row = t / row_vecs, col = (t % row_vecs) * V;
  const unsigned l = row % len_l, b = row / len_l;
  float xv[V], gv[V], yv[V], o[V];
  load<T, V>(x + b * sxb + l * sxl + col, xv);
  load<T, V>(y + b * syb + l * syl + col, yv);
  load<T, V>(gate + b * sg + col, gv);
#pragma unroll
  for (int i = 0; i < V; ++i)
    o[i] = __fadd_rn(xv[i], round_to<T>(__fmul_rn(gv[i], yv[i])));
  store<T, V>(out + static_cast<long long>(row) * row_vecs * V + col, o);
}

// PyTorch's tanh GELU (ATen/native/cuda/ActivationGeluKernel.cu) as it is
// written there, in f32
__device__ __forceinline__ float gelu_tanh(float x) {
  constexpr float kBeta =
      static_cast<float>(1.41421356237309504880 * 1.12837916709551257390 * 0.5);
  constexpr float kKappa = 0.044715;
  const float x_cube = x * x * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  return 0.5f * x * (1.f + tanhf(inner));
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    gelu_cat_kernel(const T* __restrict__ attn, const T* __restrict__ mlp,
                    T* __restrict__ out, unsigned vecs, unsigned attn_vecs,
                    unsigned row_vecs, unsigned len_l, long long sab,
                    long long sal, long long smb, long long sml) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= vecs) return;
  const unsigned row = t / row_vecs, cv = t % row_vecs;
  const unsigned l = row % len_l, b = row / len_l;
  float v[V];
  if (cv < attn_vecs) {
    load<T, V>(attn + b * sab + l * sal + cv * V, v);
  } else {
    load<T, V>(mlp + b * smb + l * sml + (cv - attn_vecs) * V, v);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = gelu_tanh(v[i]);
  }
  store<T, V>(out + static_cast<long long>(t) * V, v);
}

unsigned blocks_for(unsigned long long threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

// the NV instantiation of a row kernel (1, 2, 4 or 8), or 0
template <template <int> class Launch, typename... Args>
int by_nv(int nv, Args... args) {
  switch (nv) {
    case 1: return Launch<1>::run(args...);
    case 2: return Launch<2>::run(args...);
    case 4: return Launch<4>::run(args...);
    case 8: return Launch<8>::run(args...);
    default: return kInvalid;
  }
}

template <typename T, int V>
struct RmsLaunch {
  template <int NV>
  struct At {
    static int run(const void* x, const void* scale, void* out, unsigned rows,
                   int len_l, int heads, int d, long long sb, long long sl,
                   long long sh, int group, float eps, cudaStream_t s) {
      rmsnorm_kernel<T, V, NV><<<blocks_for(1ull * rows * group), kThreads, 0, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(scale),
          static_cast<T*>(out), rows, len_l, heads, d, sb, sl, sh, group,
          1.f / static_cast<float>(d), eps);
      return static_cast<int>(cudaGetLastError());
    }
  };
};

template <typename T, int V>
struct ModLaunch {
  template <int NV>
  struct At {
    static int run(const void* x, const void* shift, const void* scale,
                   void* out, unsigned rows, int len_l, int c, long long sxb,
                   long long sxl, long long sshift, long long sscale,
                   int group, float eps, cudaStream_t s) {
      modulate_kernel<T, V, NV><<<blocks_for(1ull * rows * group), kThreads, 0, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(shift),
          static_cast<const T*>(scale), static_cast<T*>(out), rows, len_l, c,
          sxb, sxl, sshift, sscale, group, 1.f / static_cast<float>(c), eps);
      return static_cast<int>(cudaGetLastError());
    }
  };
};

// A row's plan: `v` values a vector (16 bytes), `group` lanes a row,
// `nv` vectors a lane; false where a row is too long for the registers.
bool row_plan(int len, int v, int* group, int* nv) {
  const int vecs = len / v;
  int g = 1;
  while (g < 32 && g < vecs) g *= 2;
  int n = 1;
  while (n * g < vecs) n *= 2;
  *group = g;
  *nv = n;
  return n <= kMaxNV;
}

bool rows_fit(long long rows, long long group) {
  return rows >= 1 && rows * group < (1ll << 31);
}

template <typename T, int V>
int gate_launch(const void* x, const void* gate, const void* y, void* out,
                unsigned vecs, int c, int len_l, long long sxb, long long sxl,
                long long syb, long long syl, long long sg, cudaStream_t s) {
  gate_kernel<T, V><<<blocks_for(vecs), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gate),
      static_cast<const T*>(y), static_cast<T*>(out), vecs, c / V, len_l,
      sxb, sxl, syb, syl, sg);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int gelu_cat_launch(const void* attn, const void* mlp, void* out,
                    unsigned vecs, int c, int m, int len_l, long long sab,
                    long long sal, long long smb, long long sml,
                    cudaStream_t s) {
  gelu_cat_kernel<T, V><<<blocks_for(vecs), kThreads, 0, s>>>(
      static_cast<const T*>(attn), static_cast<const T*>(mlp),
      static_cast<T*>(out), vecs, c / V, (c + m) / V, len_l, sab, sal, smb,
      sml);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry point reads its rows in 16-byte vectors (8 bf16 or 4 f32 a
// thread): the caller has checked that every pointer is 16-byte aligned and
// that every stride and the last dim are multiples of 16 bytes. dtype: 0
// f32, 1 bf16. Strides are in elements; the last dim is contiguous. Outputs
// are contiguous and new. Launches on the stream, allocates nothing, does
// not synchronise; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a size it does not take.

// x (batch, len_l, heads, d) through its strides sb, sl, sh -> out (batch,
// len_l, heads, d); scale (d,)
extern "C" int m324_dit_rmsnorm(const void* x, const void* scale, void* out,
                                int batch, int len_l, int heads, int d,
                                long long sb, long long sl, long long sh,
                                float eps, int dtype, cudaStream_t s) {
  const int v = dtype ? 8 : 4;
  int group, nv;
  const long long rows = 1ll * batch * len_l * heads;
  if (d < 1 || d % v || !row_plan(d, v, &group, &nv) || !rows_fit(rows, group))
    return kInvalid;
  const unsigned r = static_cast<unsigned>(rows);
  return dtype
      ? by_nv<RmsLaunch<__nv_bfloat16, 8>::At>(nv, x, scale, out, r, len_l, heads, d, sb, sl, sh, group, eps, s)
      : by_nv<RmsLaunch<float, 4>::At>(nv, x, scale, out, r, len_l, heads, d, sb, sl, sh, group, eps, s);
}

// x (batch, len_l, c) through its strides sxb, sxl; shift and scale (batch,
// 1, c) through their batch strides -> out (batch, len_l, c)
extern "C" int m324_dit_modulate(const void* x, const void* shift,
                                 const void* scale, void* out, int batch,
                                 int len_l, int c, long long sxb,
                                 long long sxl, long long sshift,
                                 long long sscale, float eps, int dtype,
                                 cudaStream_t s) {
  const int v = dtype ? 8 : 4;
  int group, nv;
  const long long rows = 1ll * batch * len_l;
  if (c < 1 || c % v || !row_plan(c, v, &group, &nv) || !rows_fit(rows, group))
    return kInvalid;
  const unsigned r = static_cast<unsigned>(rows);
  return dtype
      ? by_nv<ModLaunch<__nv_bfloat16, 8>::At>(nv, x, shift, scale, out, r, len_l, c, sxb, sxl, sshift, sscale, group, eps, s)
      : by_nv<ModLaunch<float, 4>::At>(nv, x, shift, scale, out, r, len_l, c, sxb, sxl, sshift, sscale, group, eps, s);
}

// x, y (batch, len_l, c) through their strides; gate (batch, 1, c) -> out
// (batch, len_l, c)
extern "C" int m324_dit_gate(const void* x, const void* gate, const void* y,
                             void* out, int batch, int len_l, int c,
                             long long sxb, long long sxl, long long syb,
                             long long syl, long long sg, int dtype,
                             cudaStream_t s) {
  const int v = dtype ? 8 : 4;
  const long long vecs = 1ll * batch * len_l * (c / v);
  if (c < 1 || c % v || vecs < 1 || vecs >= (1ll << 31)) return kInvalid;
  const unsigned n = static_cast<unsigned>(vecs);
  return dtype
      ? gate_launch<__nv_bfloat16, 8>(x, gate, y, out, n, c, len_l, sxb, sxl, syb, syl, sg, s)
      : gate_launch<float, 4>(x, gate, y, out, n, c, len_l, sxb, sxl, syb, syl, sg, s);
}

// attn (batch, len_l, c), mlp (batch, len_l, m) through their strides ->
// out (batch, len_l, c + m)
extern "C" int m324_dit_gelu_cat(const void* attn, const void* mlp, void* out,
                                 int batch, int len_l, int c, int m,
                                 long long sab, long long sal, long long smb,
                                 long long sml, int dtype, cudaStream_t s) {
  const int v = dtype ? 8 : 4;
  const long long vecs = 1ll * batch * len_l * ((c + m) / v);
  if (c < 1 || m < 1 || c % v || m % v || vecs < 1 || vecs >= (1ll << 31))
    return kInvalid;
  const unsigned n = static_cast<unsigned>(vecs);
  return dtype
      ? gelu_cat_launch<__nv_bfloat16, 8>(attn, mlp, out, n, c, m, len_l, sab, sal, smb, sml, s)
      : gelu_cat_launch<float, 4>(attn, mlp, out, n, c, m, len_l, sab, sal, smb, sml, s);
}
