// 3x3 SAME convolution, 128 -> 128 channels, bf16 in and out, f32
// accumulation, for Hopper (sm_90a).
//
// Replaces the TPU kernel that tools/conv_kernel_probe.py::make_conv builds
// (bodies _body_shift9, _body_copy3, _body_cat384 under _dma_loop): for an
// (H, W, 128) bf16 input x and HWIO (3, 3, 128, 128) bf16 weights w,
//     out[y, x, o] = bf16( sum_{dy, dx, c} xp[y + dy, x + dx, c] * w[dy, dx, c, o] )
// where xp is x with a one-pixel border of zeros.  The TPU kernel's HALO-8
// canvas, padded output and three decompositions answer Mosaic layout rules
// and are not carried over: the border comes from predicated loads here, so
// there is no padded copy of the input.
//
// What bounds it on this card: operations.  At the dense trunk's
// (1008, 1058, 128) it is 314.5 GFLOP, 0.318 ms at the H100's 989 TFLOP/s
// dense bf16, against 546 MB of input and output, 0.163 ms at 3.35 TB/s.
// The design is a plain implicit GEMM on the tensor cores (nvcuda::wmma,
// bf16 16x16x16, f32 accumulators): M = output pixels, N = 128 output
// channels, K = 9 taps x 128 input channels.
//   * a block owns a tile of 4 rows x 32 columns of output pixels and all
//     128 output channels; it stages its (4+2) x (32+2) input pixels, border
//     included, once in shared memory, 16-byte loads, zeros outside the image;
//   * for each tap (dy, dx) it stages that tap's 128 x 128 weight slice (from
//     L2: the whole weight is 295 KB) and runs 8 k-steps of 16 channels;
//     the A operand of a tap is the staged tile read at a (dy, dx) offset, so
//     the nine shifted operands cost no copies;
//   * 8 warps: 4 along the tile's rows (32 pixels = 2 m-fragments each) x 2
//     along the output channels (64 = 4 n-fragments each), 8 accumulator
//     fragments per warp;
//   * the epilogue stores the fragments to shared memory (reusing the staging
//     buffers), rounds to bf16 and writes each pixel's 128 channels with
//     16-byte stores, masked at the image's right and bottom edge;
//   * shared memory is 95,616 bytes (row pitch 144 bf16 keeps every wmma
//     pointer 32-byte aligned), so two blocks fit on an SM.
// Not done yet (later work): wgmma, TMA, a ring of weight slices so staging
// overlaps the tensor cores, and a persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kC = 128;                 // input = output channels
constexpr int kTH = 4;                  // output tile rows
constexpr int kTW = 32;                 // output tile columns
constexpr int kHH = kTH + 2;            // staged input rows (one-pixel border)
constexpr int kHW = kTW + 2;            // staged input columns
constexpr int kLda = kC + 16;           // bf16 pitch of staged rows (288 B)
constexpr int kLdc = kC + 8;            // f32 pitch of the epilogue (544 B)
constexpr int kThreads = 256;           // 8 warps
constexpr int kVecs = kC / 8;           // 16-byte vectors in a pixel's channels
constexpr int kTileElems = kHH * kHW * kLda;
constexpr int kWElems = kC * kLda;
constexpr size_t kSmemBytes =
    static_cast<size_t>(kTileElems + kWElems) * sizeof(__nv_bfloat16);
static_assert(kTH * kTW * kLdc * sizeof(float) <= kSmemBytes,
              "the epilogue reuses the staging buffers");
static_assert(kTH * 2 == kThreads / 32, "4 x 2 warps");

__global__ void __launch_bounds__(kThreads, 2)
conv3x3_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w,
               __nv_bfloat16* __restrict__ out, int h, int wd) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto* tile = reinterpret_cast<__nv_bfloat16*>(smem);
  auto* wsl = tile + kTileElems;
  const int y0 = blockIdx.y * kTH;
  const int x0 = blockIdx.x * kTW;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1;  // the tile row of this warp's 32 pixels
  const int wn = warp & 1;   // the half of the output channels

  // The input tile: staged pixel (ty, tx) is image pixel (y0+ty-1, x0+tx-1).
  for (int i = tid; i < kHH * kHW * kVecs; i += kThreads) {
    const int p = i / kVecs;
    const int v = i - p * kVecs;
    const int ty = p / kHW;
    const int gy = y0 + ty - 1;
    const int gx = x0 + (p - ty * kHW) - 1;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (gy >= 0 && gy < h && gx >= 0 && gx < wd) {
      val = reinterpret_cast<const uint4*>(
          x + (static_cast<int64_t>(gy) * wd + gx) * kC)[v];
    }
    reinterpret_cast<uint4*>(tile + p * kLda)[v] = val;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) wmma::fill_fragment(acc[j][q], 0.0f);
  }

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3;
    const int dx = tap - dy * 3;
    __syncthreads();  // the tile is staged; the last tap's slice is read
    const uint4* wsrc =
        reinterpret_cast<const uint4*>(w + static_cast<int64_t>(tap) * kC * kC);
    for (int i = tid; i < kC * kVecs; i += kThreads) {
      const int r = i / kVecs;
      reinterpret_cast<uint4*>(wsl + r * kLda)[i - r * kVecs] = wsrc[i];
    }
    __syncthreads();
    // Row m of m-fragment j is output pixel (wm, 16j + m); at tap (dy, dx)
    // it reads staged pixel (wm + dy, 16j + m + dx).
    const __nv_bfloat16* a_base = tile + ((wm + dy) * kHW + dx) * kLda;
#pragma unroll 2
    for (int k0 = 0; k0 < kC; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(a[j], a_base + j * 16 * kLda + k0, kLda);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b;
        wmma::load_matrix_sync(b, wsl + k0 * kLda + wn * 64 + q * 16, kLda);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[j][q], a[j], b, acc[j][q]);
      }
    }
  }

  __syncthreads();  // every warp is done with the tile and the slice
  float* stage = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      wmma::store_matrix_sync(stage + (wm * kTW + j * 16) * kLdc + wn * 64 + q * 16,
                              acc[j][q], kLdc, wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int i = tid; i < kTH * kTW * kVecs; i += kThreads) {
    const int p = i / kVecs;
    const int v = i - p * kVecs;
    const int gy = y0 + p / kTW;
    const int gx = x0 + p % kTW;
    if (gy < h && gx < wd) {
      const float* s = stage + p * kLdc + v * 8;
      uint4 packed;
      auto* o = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int t = 0; t < 4; ++t) o[t] = __floats2bfloat162_rn(s[2 * t], s[2 * t + 1]);
      reinterpret_cast<uint4*>(out + (static_cast<int64_t>(gy) * wd + gx) * kC)[v] =
          packed;
    }
  }
}

}  // namespace

// C entry for ctypes.  Returns the cudaError_t of the launch (0 = success).
extern "C" int conv3x3_bf16(const void* x, const void* w, void* out, int h,
                            int wd, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(conv3x3_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((wd + kTW - 1) / kTW, (h + kTH - 1) / kTH);
  conv3x3_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), h, wd);
  return static_cast<int>(cudaGetLastError());
}
