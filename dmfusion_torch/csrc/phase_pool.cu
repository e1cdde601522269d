// Phase window-pool for Hopper (sm_90a).
//
// Replaces the TPU kernel dmfusion/ops/pallas_pool.py::phase_pool_fused
// (body _kernel): (H2, W2, 4C) space-to-depth-2 features -> the (ni, nj, 4C)
// space-to-depth-2 packing of the patch x patch window-mean map.  With
// ph = patch / 2 and reads past the feature map taken as zeros:
//   rs[r, j] = f[r, j] + ... + f[r, j+ph-1]          (f32 left fold)
//   t[i, j]  = rs[i, j] + ... + rs[i+ph-1, j]        (f32 left fold)
//   t        rounded to the feature dtype
//   out[i, j, (2a+b)C + k] = sum over (r,u) in (0,0),(0,1),(1,0),(1,1),
//       (c,d) ascending with a&~c == r and b&~d == u, of
//       t[i+r, j+u, (2c+d)C + k] * scale                (f32, cast once)
// in exactly that order, so the result is bit-equal to the plain version
// dmfusion_torch/ops/pool.py::phase_pool_ref.  The multiply and the add are
// __fmul_rn/__fadd_rn so nvcc cannot contract them into an FMA (which would
// change bits for a patch whose 1/patch^2 is not a power of two).
//
// What bounds it on this card: bytes.  At image6, width 32, patch 16 it
// reads (1008, 1058, 128) and writes (1001, 1051, 128) bf16: 542 MB, a
// 0.162 ms bound at 3.35 TB/s, against about 2.3 G f32 adds.  The TPU
// design (a (8+ph, njt+ph) slab DMA, a double buffer, four selection
// matmuls on the MXU, the Mosaic shape gate) is not carried over.  This
// design streams rows:
//   * a block owns TI output rows x TJ output columns x KC channels of each
//     of the four phase blocks (4*KC channels of t), and walks down the
//     TI + ph input rows it needs, one row at a time;
//   * per input row it stages the (TJ + ph)-column segment in shared
//     memory as f32, folds it into one row of column sums rs kept in a
//     ring of ph rows in shared memory, folds the ring into one row of t
//     (two rows kept), and once two t rows exist mixes one output row;
//   * every input element is read from device memory (1 + ph/TI) x
//     (1 + ph/TJ) times, the rest of the reuse comes from shared memory;
//   * consecutive threads take consecutive channels, so loads and stores
//     are coalesced runs of KC channels; the channel group is the fastest
//     grid index, so the blocks reading one pixel's channels run together
//     and share its L2 lines; each thread keeps one channel and steps over
//     columns, so no index is divided in the loops, and the rows of t are
//     padded by KC floats so the mix's reads do not collide in one bank;
//   * templated on float and __nv_bfloat16; 64-bit offsets; any even
//     patch and any 4C divisible by 4.
// It stays well above its bound (PERF.md): each rs value is read ph times
// from the shared ring and every row costs three block barriers.  Keeping
// the ring in registers and blocking columns per thread are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 32;  // TI

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(x);
}
// t rounded to the feature dtype, kept as f32.
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
phase_pool_kernel(const T* __restrict__ f, int64_t h2, int64_t w2, int c4,
                  int ph, int ni, int nj, int tj, int kc, float scale,
                  T* __restrict__ out) {
  extern __shared__ float smem[];
  const int c = c4 / 4;
  const int groups = c / kc;
  const int g4 = 4 * kc;      // channels of t held by this block
  const int tcols = tj + 1;   // t columns j0 .. j0 + tj
  const int segw = tj + ph;   // input columns j0 .. j0 + tj + ph - 1
  const int k0 = (blockIdx.x % groups) * kc;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x / groups) * tj;
  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * kRowsPerBlock;
  const int64_t left = ni - i0;
  const int nout = left < kRowsPerBlock ? static_cast<int>(left)
                                        : kRowsPerBlock;

  const int tpitch = g4 + kc;  // t row pitch: padded against bank conflicts
  float* seg = smem;                     // segw x g4
  float* ring = seg + segw * g4;         // ph x tcols x g4
  float* tbuf = ring + ph * tcols * g4;  // 2 x tcols x tpitch
  const int row_items = tcols * g4;

  // g4 and kc divide kThreads, so each thread keeps one channel of t (g)
  // and one output channel (kk) and steps over columns.
  const int g = threadIdx.x % g4;
  const int col0 = threadIdx.x / g4;
  const int col_step = kThreads / g4;
  const int blk = g / kc;
  const int src_ch = blk * c + k0 + (g - blk * kc);
  const int kk = threadIdx.x % kc;
  const int jj0 = threadIdx.x / kc;
  const int jj_step = kThreads / kc;

  for (int rr = 0; rr < nout + ph; ++rr) {
    // 1. Stage input row i0 + rr, columns j0 .. j0 + segw - 1, as f32.
    const int64_t r = i0 + rr;
    for (int col = col0; col < segw; col += col_step) {
      const int64_t cc = j0 + col;
      float v = 0.f;
      if (r < h2 && cc < w2) v = to_f(f[(r * w2 + cc) * c4 + src_ch]);
      seg[col * g4 + g] = v;
    }
    __syncthreads();

    // 2. Column sums of this row into ring slot rr % ph.
    float* slot = ring + (rr % ph) * row_items;
    for (int col = col0; col < tcols; col += col_step) {
      const float* src = seg + col * g4 + g;
      float s = src[0];
      for (int k = 1; k < ph; ++k) s = __fadd_rn(s, src[k * g4]);
      slot[col * g4 + g] = s;
    }
    __syncthreads();
    if (rr < ph - 1) continue;

    // 3. t row it = rr - ph + 1 from ring rows it .. it + ph - 1.
    const int it = rr - (ph - 1);
    const int first = it % ph;
    float* trow = tbuf + (it & 1) * tcols * tpitch;
    for (int col = col0; col < tcols; col += col_step) {
      const int item = col * g4 + g;
      int sl = first;
      float s = ring[sl * row_items + item];
      for (int k = 1; k < ph; ++k) {
        sl = sl + 1 == ph ? 0 : sl + 1;
        s = __fadd_rn(s, ring[sl * row_items + item]);
      }
      trow[col * tpitch + g] = round_as(s, f);
    }
    __syncthreads();
    if (it == 0) continue;

    // 4. Output row i0 + it - 1 from t rows it - 1 (r = 0) and it (r = 1).
    const float* tr[2] = {tbuf + ((it - 1) & 1) * tcols * tpitch, trow};
    const int64_t i = i0 + it - 1;
    for (int jj = jj0; jj < tj; jj += jj_step) {
      const int64_t j = j0 + jj;
      if (j >= nj) break;
      T* o = out + (i * nj + j) * c4 + k0 + kk;
#pragma unroll
      for (int ob = 0; ob < 4; ++ob) {
        const int a = ob >> 1, b = ob & 1;
        float acc = 0.f;
#pragma unroll
        for (int ru = 0; ru < 4; ++ru) {
          const int rsh = ru >> 1, ush = ru & 1;
#pragma unroll
          for (int ib = 0; ib < 4; ++ib) {
            const int ci = ib >> 1, di = ib & 1;
            if ((a & (1 - ci)) != rsh || (b & (1 - di)) != ush) continue;
            const float v = tr[rsh][(jj + ush) * tpitch + ib * kc + kk];
            acc = __fadd_rn(acc, __fmul_rn(v, scale));
          }
        }
        from_f(acc, o + ob * c);
      }
    }
  }
}

size_t smem_bytes(int tj, int ph, int kc) {
  const size_t g4 = 4 * static_cast<size_t>(kc);
  return sizeof(float) *
         (g4 * ((tj + ph) + static_cast<size_t>(ph) * (tj + 1)) +
          2 * (tj + 1) * (g4 + kc));
}

template <typename T>
cudaError_t launch(const void* feats, int64_t h2, int64_t w2, int c4,
                   int patch, int ni, int nj, float scale, void* out,
                   cudaStream_t stream) {
  const int ph = patch / 2;
  const int c = c4 / 4;
  // KC: the widest of 8, 4, 2, 1 channels per phase block that divides C.
  int kc = 8;
  while (c % kc) kc /= 2;
  // TJ: 32 output columns, fewer where the ph-row ring would not leave
  // room for two blocks per SM.
  int tj = 32;
  while (tj > 4 && smem_bytes(tj, ph, kc) > 100 * 1024) tj /= 2;
  const size_t smem = smem_bytes(tj, ph, kc);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      phase_pool_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t col_tiles = (nj + tj - 1) / tj;
  const int64_t row_tiles = (ni + kRowsPerBlock - 1) / kRowsPerBlock;
  const int64_t gx = col_tiles * (c / kc);
  if (gx > 0x7fffffff || row_tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(row_tiles));
  phase_pool_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(feats), h2, w2, c4, ph, ni, nj, tj, kc, scale,
      static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes.  Returns the cudaError_t of the launch (0 = success).
extern "C" int phase_pool(const void* feats, long long h2, long long w2,
                          int c4, int patch, int ni, int nj, float scale,
                          int elem_bytes, void* out, void* stream,
                          int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (patch < 2 || patch % 2 || c4 < 4 || c4 % 4 || ni < 1 || nj < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 4:
      err = launch<float>(feats, h2, w2, c4, patch, ni, nj, scale, out, s);
      break;
    case 2:
      err = launch<__nv_bfloat16>(feats, h2, w2, c4, patch, ni, nj, scale,
                                  out, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
