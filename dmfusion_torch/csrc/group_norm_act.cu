// B5: GroupNorm, residual add and activation in one pass, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: dmfusion's flax GroupNorm
// (dmfusion/models/common.py) was left to XLA, which fuses the norm, the
// add and the activation around the convolutions.  Under PyTorch,
// nn.GroupNorm under CUDA autocast casts a channels-last bf16 activation to
// f32, copies it to NCHW (ATen's CUDA group norm takes no channels-last),
// reads it for the moments, writes the f32 affine, casts back to bf16, and
// the residual add, the activation and the next conv's copy back to
// channels-last each read and write it again: 36-42 bytes of traffic a bf16
// element, against the 4-6 the function needs.  For an (N, C, H, W) tensor
// x, in NCHW or channels-last memory, this computes
//   out = act(round(round(gn(x)) + residual))
// with gn the groups' f32 mean and biased variance over C/G x H x W, eps,
// and the f32 affine a = rstd * weight[c], b = beta[c] - a * mean,
// y = a * x + b (the form and FMAs of ATen's GroupNorm kernels); round to
// the input's dtype; the residual optional; act one of none, relu,
// tanh-gelu, silu, tanh, leaky_relu 0.01, in f32 on the rounded value, as
// torch's elementwise kernels compute them, then rounded.  The output is
// written in x's memory format.
//
// What bounds it on this card: bytes.  It reads x, reads the residual and
// writes out once each: gmfnet-w64-p16's 13 norms at a bucket of 4,096
// anchors move 2.72 GB, 0.81 ms at 3.35 TB/s.  A few f32 operations an
// element are far below the card's compute, so the design spends its
// effort on reading each byte once, in 16-byte units, with many loads in
// flight.
//
// The launch plan (body, threads, grid, shared bytes) is computed on the
// host by ops/norm.py::launch_plan and checked here.  Two bodies, chosen
// there by shape:
//
// gn_shared<T, CL> (a sample's slab, with its residual, fits a block's
// 227 KB of shared memory, with whole 16-byte vectors in one channel
// (NCHW: H*W a multiple of the vector) or one pixel (channels-last: C a
// multiple of it); every gmfnet shape): one block a sample.  The block's
// threads copy the slab, and the residual, into shared memory by cp.async
// at once, so the whole slab is in flight, and no thread holds it in
// registers, which would cap the blocks an SM holds (a first design kept
// the slab in registers: 64-122 a thread, one 512-thread block an SM at
// gmfnet's widest slab, each block's loads, barriers and stores in turn:
// 0.9-1.3 TB/s).
// Several blocks an SM (3 with a 32 KB slab and its residual, 5 without)
// overlap one block's reductions with the others' copies.  In
// channels-last memory the block's thread count is a multiple of the
// vectors a pixel, so a thread's vectors all cover the same channels: it
// sums each lane, the block's lane sums meet in shared memory laid out
// [row][C], and a warp a group adds its channels' entries in a fixed
// order, then a butterfly over the warp.  In NCHW a vector lies in one
// channel; its sum goes to shared memory and a group's vectors are one
// contiguous range.  The variance is exact: a second pass over the staged
// slab sums the squared deviations from the group mean, reduced the same
// way.  Then each element is normalised, rounded, added to the residual,
// activated and written by streaming 16-byte stores.
//
// gn_looped<T, CL> (every other shape, e.g. the GAN generator's 128 x 128
// slabs): one block a (sample, group), element by element: a sweep for the
// mean, a second for the exact variance (from L2 where the group fits),
// and the apply sweep.
//
// Both are templated on float and __nv_bfloat16.  Sums run in a fixed order
// for a given plan, so a launch is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 232448;  // 227 KB, a block's most

enum Act { kNone = 0, kRelu = 1, kGelu = 2, kSilu = 3, kTanh = 4, kLeaky = 5 };

// 16-byte vectors of one element type: unpack to f32, round, pack.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ static float to_f(float v) { return v; }
  __device__ static float from_f(float v) { return v; }
  __device__ static float round(float v) { return v; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint32_t pack2(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]),
                      pack2(f[4], f[5]), pack2(f[6], f[7]));
  }
  __device__ static float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 from_f(float v) {
    return __float2bfloat16_rn(v);
  }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// The activation on a rounded value, in f32, as ATen's CUDA kernels write
// it (opmath float); the caller rounds the result.
__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case kRelu:
      return isnan(x) ? x : fmaxf(x, 0.f);
    case kGelu: {
      const float kBeta = 0.7978845608028654f;  // sqrt(2) * 2/sqrt(pi) / 2
      const float kKappa = 0.044715f;
      const float cube = x * x * x;
      const float inner = kBeta * (x + kKappa * cube);
      return 0.5f * x * (1.f + tanhf(inner));
    }
    case kSilu:
      return x / (1.f + expf(-x));
    case kTanh:
      return tanhf(x);
    case kLeaky:
      return x > 0.f ? x : x * 0.01f;
    default:
      return x;
  }
}

// out = act(round(round(y) + r)), before the final rounding.  Without a
// residual, relu and none commute with the rounding (monotone, 0 kept), so
// the final rounding alone gives the same value, at one conversion less
// an element.
template <typename T>
__device__ __forceinline__ float epilogue(float y, float r, bool has_res,
                                          int act) {
  if (has_res || (act != kRelu && act != kNone)) y = Vec<T>::round(y);
  if (has_res) y = Vec<T>::round(y + r);
  return activate(y, act);
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// One group's sum of the block's partials, on every lane of the calling
// warp.  Channels-last: partials are [rows][C]; NCHW: one a vector, the
// group's vpg vectors contiguous.
template <bool CL>
__device__ __forceinline__ float group_sum(const float* part, int g, int C,
                                           int cpg, int rows, int vpg) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  if (CL) {
    const int count = rows * cpg;
    for (int k = lane; k < count; k += 32) {
      s += part[(k / cpg) * C + g * cpg + k % cpg];
    }
  } else {
    for (int k = lane; k < vpg; k += 32) s += part[g * vpg + k];
  }
  return warp_sum(s);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

template <typename T, bool CL>
__global__ void __launch_bounds__(kMaxThreads)
gn_shared(const T* __restrict__ x, const T* __restrict__ res,
          T* __restrict__ out, const float* __restrict__ weight,
          const float* __restrict__ bias, int C, int HW, int G, float eps,
          int act) {
  using Vt = Vec<T>;
  constexpr int V = Vt::N;
  extern __shared__ uint4 smem[];
  const int nt = blockDim.x, t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31, nwarps = nt >> 5;
  const int nvec = C * HW / V;           // vectors a sample
  const int cpg = C / G;
  const int S = cpg * HW;                // elements a group
  const int rows = nt * V / C;           // channels-last partial rows
  const int vpg = S / V;                 // NCHW vectors a group
  const size_t base = static_cast<size_t>(blockIdx.x) * nvec;
  const uint4* xv = reinterpret_cast<const uint4*>(x) + base;
  const uint4* rv = res ? reinterpret_cast<const uint4*>(res) + base : nullptr;
  uint4* ov = reinterpret_cast<uint4*>(out) + base;
  uint4* xs = smem;                                  // the sample's slab
  uint4* rs = smem + nvec;                           // its residual
  float* part = reinterpret_cast<float*>(smem + (rv ? 2 : 1) * nvec);
  float* mean_s = part + (CL ? nt * V : nvec);
  float* rstd_s = mean_s + G;

  for (int v = t; v < nvec; v += nt) cp_async16(xs + v, xv + v);
  if (rv) {
    for (int v = t; v < nvec; v += nt) cp_async16(rs + v, rv + v);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  // Channels-last: the channel of this thread's lane 0, for every vector
  // (the block is a whole number of pixels of vectors).
  const int cb = CL ? (t % (C / V)) * V : 0;

  // Pass 1: the groups' means.
  if (CL) {
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    for (int v = t; v < nvec; v += nt) {
      float f[V];
      Vt::unpack(xs[v], f);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] += f[j];
    }
#pragma unroll
    for (int j = 0; j < V; ++j) part[t * V + j] = acc[j];
  } else {
    for (int v = t; v < nvec; v += nt) {
      float f[V];
      Vt::unpack(xs[v], f);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) s += f[j];
      part[v] = s;
    }
  }
  __syncthreads();
  for (int g = warp; g < G; g += nwarps) {
    const float s = group_sum<CL>(part, g, C, cpg, rows, vpg);
    if (lane == 0) mean_s[g] = s / static_cast<float>(S);
  }
  __syncthreads();

  // Pass 2: the exact variance, from shared memory.
  if (CL) {
    float m[V], acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      m[j] = mean_s[(cb + j) / cpg];
      acc[j] = 0.f;
    }
    for (int v = t; v < nvec; v += nt) {
      float f[V];
      Vt::unpack(xs[v], f);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = f[j] - m[j];
        acc[j] += d * d;
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) part[t * V + j] = acc[j];
  } else {
    for (int v = t; v < nvec; v += nt) {
      float f[V];
      Vt::unpack(xs[v], f);
      const float m = mean_s[v / vpg];
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = f[j] - m;
        s += d * d;
      }
      part[v] = s;
    }
  }
  __syncthreads();
  for (int g = warp; g < G; g += nwarps) {
    const float s = group_sum<CL>(part, g, C, cpg, rows, vpg);
    if (lane == 0) {
      rstd_s[g] = rsqrtf(fmaxf(s / static_cast<float>(S), 0.f) + eps);
    }
  }
  __syncthreads();

  // Apply: affine, round, residual, activation, one store a vector.
  const bool has_res = rv != nullptr;
  float r[V];
#pragma unroll
  for (int j = 0; j < V; ++j) r[j] = 0.f;
  if (CL) {
    float a[V], b[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int g = (cb + j) / cpg;
      a[j] = rstd_s[g] * weight[cb + j];
      b[j] = fmaf(-a[j], mean_s[g], bias[cb + j]);
    }
    for (int v = t; v < nvec; v += nt) {
      float f[V], o[V];
      Vt::unpack(xs[v], f);
      if (has_res) Vt::unpack(rs[v], r);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        o[j] = epilogue<T>(fmaf(a[j], f[j], b[j]), r[j], has_res, act);
      }
      __stcs(ov + v, Vt::pack(o));
    }
  } else {
    for (int v = t; v < nvec; v += nt) {
      const int c = v * V / HW;
      const int g = c / cpg;
      const float a = rstd_s[g] * weight[c];
      const float b = fmaf(-a, mean_s[g], bias[c]);
      float f[V], o[V];
      Vt::unpack(xs[v], f);
      if (has_res) Vt::unpack(rs[v], r);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        o[j] = epilogue<T>(fmaf(a, f[j], b), r[j], has_res, act);
      }
      __stcs(ov + v, Vt::pack(o));
    }
  }
}

// The block's sum of one value a thread, in a fixed order, on every
// thread.  ``red`` holds 33 floats.
__device__ float block_sum(float s, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  s = warp_sum(s);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = warp_sum(lane < nwarps ? red[lane] : 0.f);
    if (lane == 0) red[32] = s;
  }
  __syncthreads();
  s = red[32];
  __syncthreads();
  return s;
}

template <typename T, bool CL>
__global__ void __launch_bounds__(kMaxThreads)
gn_looped(const T* __restrict__ x, const T* __restrict__ res,
          T* __restrict__ out, const float* __restrict__ weight,
          const float* __restrict__ bias, int C, int HW, int G, float eps,
          int act) {
  using Vt = Vec<T>;
  __shared__ float red[33];
  const int g = static_cast<int>(blockIdx.x % G);
  const size_t slab = static_cast<size_t>(blockIdx.x / G) * C * HW;
  const int cpg = C / G;
  const int S = cpg * HW;
  x += slab;
  out += slab;
  if (res) res += slab;
  // A group element's offset in the sample's slab.
  auto at = [=](int i) -> int {
    return CL ? (i / cpg) * C + g * cpg + i % cpg : g * S + i;
  };

  float s = 0.f;
  for (int i = threadIdx.x; i < S; i += blockDim.x) s += Vt::to_f(x[at(i)]);
  const float mean = block_sum(s, red) / static_cast<float>(S);
  float q = 0.f;
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    const float d = Vt::to_f(x[at(i)]) - mean;
    q += d * d;
  }
  const float rstd =
      rsqrtf(fmaxf(block_sum(q, red) / static_cast<float>(S), 0.f) + eps);
  const bool has_res = res != nullptr;
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    const int o = at(i);
    const int c = g * cpg + (CL ? i % cpg : i / HW);
    const float a = rstd * weight[c];
    const float b = fmaf(-a, mean, bias[c]);
    const float r = has_res ? Vt::to_f(res[o]) : 0.f;
    out[o] = Vt::from_f(
        epilogue<T>(fmaf(a, Vt::to_f(x[o]), b), r, has_res, act));
  }
}

struct Plan {
  int body, threads, grid, smem;
};

template <typename T, bool CL>
cudaError_t launch(const void* x, const void* res, void* out,
                   const float* weight, const float* bias, int C, int HW,
                   int G, float eps, int act, const Plan& p,
                   cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  T* ot = static_cast<T*>(out);
  if (p.body == 1) {
    gn_looped<T, CL><<<p.grid, p.threads, 0, s>>>(xt, rt, ot, weight, bias,
                                                  C, HW, G, eps, act);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        gn_shared<T, CL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        p.smem);
    if (err != cudaSuccess) return err;
    gn_shared<T, CL><<<p.grid, p.threads, p.smem, s>>>(
        xt, rt, ot, weight, bias, C, HW, G, eps, act);
  }
  return cudaGetLastError();
}

// Whether the plan is one the kernels run for this shape.
bool plan_ok(const Plan& p, long long n, int C, int HW, int G, int V,
             bool cl, bool has_res) {
  if (p.threads < 32 || p.threads > kMaxThreads || p.threads % 32) {
    return false;
  }
  if (p.body == 1) return p.grid == n * G && p.smem == 0;
  if (p.body != 0 || p.grid != n) return false;
  if (cl ? (C % V || p.threads % (C / V)) : HW % V) return false;
  const int nvec = C * HW / V;
  const long long parts = cl ? p.threads * V : nvec;
  const long long smem = 16ll * nvec * (has_res ? 2 : 1) + 4 * (parts + 2 * G);
  return p.smem == smem && p.smem <= kMaxSmem;
}

}  // namespace

// out = act(round(round(group_norm(x)) + res)) for an (n, c, H, W) tensor
// of hw = H * W pixels, in NCHW (channels_last 0) or channels-last memory;
// res may be null.  weight and bias are f32 (c); elem_bytes 4 (f32) or 2
// (bf16); act: 0 none, 1 relu, 2 tanh-gelu, 3 silu, 4 tanh, 5 leaky_relu
// 0.01.  plan: body (0 shared, 1 looped), threads, grid, dynamic shared
// bytes, from ops/norm.py::launch_plan.  Launches on ``stream`` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments or a plan it
// does not take.
extern "C" int group_norm_act(const void* x, const void* res, void* out,
                              const float* weight, const float* bias,
                              long long n, int c, int hw, int groups,
                              float eps, int act, int elem_bytes,
                              int channels_last, const int* plan,
                              void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan p{plan[0], plan[1], plan[2], plan[3]};
  const bool cl = channels_last != 0;
  if (n < 1 || c < 1 || hw < 1 || groups < 1 || c % groups || act < kNone ||
      act > kLeaky || static_cast<long long>(c) * hw >= (1ll << 31) ||
      (elem_bytes != 2 && elem_bytes != 4) ||
      !plan_ok(p, n, c, hw, groups, 16 / elem_bytes, cl, res != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    err = cl ? launch<float, true>(x, res, out, weight, bias, c, hw, groups,
                                   eps, act, p, s)
             : launch<float, false>(x, res, out, weight, bias, c, hw, groups,
                                    eps, act, p, s);
  } else {
    err = cl ? launch<__nv_bfloat16, true>(x, res, out, weight, bias, c, hw,
                                           groups, eps, act, p, s)
             : launch<__nv_bfloat16, false>(x, res, out, weight, bias, c, hw,
                                            groups, eps, act, p, s);
  }
  return static_cast<int>(err);
}
