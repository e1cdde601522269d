// 3x3 SAME convolution, 128 -> 128 channels, bf16 in and out, f32
// accumulation, for Hopper (sm_90a).
//
// Replaces the TPU kernel that tools/conv_kernel_probe.py::make_conv builds
// (bodies _body_shift9, _body_copy3, _body_cat384 under _dma_loop): for an
// (H, W, 128) bf16 input x and HWIO (3, 3, 128, 128) bf16 weights w,
//     out[y, x, o] = bf16( sum_{dy, dx, c} xp[y + dy, x + dx, c] * w[dy, dx, c, o] )
// where xp is x with a one-pixel border of zeros.  The TPU kernel's HALO-8
// canvas, padded output and three decompositions answer Mosaic layout rules
// and are not carried over: the border comes from zero-filled copies here,
// so there is no padded copy of the input.
//
// What bounds it on this card: operations.  At the dense trunk's
// (1008, 1058, 128) it is 314.5 GFLOP, 0.318 ms at the H100's 989 TFLOP/s
// dense bf16, against 546 MB of input and output, 0.163 ms at 3.35 TB/s.
// Only wgmma reaches the tensor cores' full rate, so the design is an
// implicit GEMM on wgmma: M = output pixels, N = 128 output channels,
// K = 9 taps x 128 input channels, in 18 stages of one tap x 64 channels.
//   * A block owns 8 output rows x 32 columns = 256 pixels and all 128
//     output channels: two consumer warpgroups of 128 pixels (4 rows) each.
//     Each k-step of 16 channels issues two
//     wgmma.mma_async.m64n128k16.f32.bf16.bf16 per warpgroup (A from
//     registers, B from shared memory): 2 x 64 f32 accumulators a thread.
//     At (1008, 1058) the grid is 34 x 126; the last column of tiles holds
//     2 of its 32 columns, so 2.8 % of the work is wasted.
//   * The input tile, (8+2) x (32+2) pixels, is staged once with 16-byte
//     cp.async; pixels outside the image get src-size 0, which writes zeros:
//     the border without a padded copy.  The pixel pitch is 136 bf16 (272 B),
//     so the eight row addresses of an ldmatrix fall in distinct banks.
//   * A operand: for tap (dy, dx) and k-step k0 each warp loads its 16 x 16
//     fragments of the 64-pixel tile with ldmatrix.x4; each lane gives the
//     address of staged pixel (row + dy, col + dx) at channel k0, so the nine
//     shifted operands cost no copies and no descriptor arithmetic.
//   * B operand, the weight ring: the wrapper packs the HWIO weights once a
//     call (ops/conv3x3.py::pack_weights) into the 18 stage images that
//     wgmma reads as they are, in the no-swizzle K-major layout of 8 x 8
//     core matrices (8 output channels x 16 bytes of input channels, 128
//     contiguous bytes).  Element w[dy, dx, c, o] lies in stage
//         s = 2 * (3 * dy + dx) + c / 64
//     at byte offset
//         2 * (2048 * (c % 64 / 16) + 128 * (o / 8) + 64 * (c % 16 / 8)
//              + 8 * (o % 8) + c % 8)
//     of that stage's 16,384 bytes.  A k-step's B is then one descriptor:
//     start address, leading byte offset 128 (the two core matrices along K),
//     stride byte offset 256 (the next 8 output channels).
//   * A ring of kRing = 6 stages is filled with one cp.async.bulk each
//     (16,384 contiguous bytes, completing on the stage's "full" mbarrier).
//     Thread 0 issues every copy; no thread copies a weight through
//     registers.  Each warpgroup keeps one stage's wgmma group in flight
//     (wgmma.wait_group 1) while it loads the next stage's A fragments into
//     a second set of registers; once a stage's group has retired, every
//     thread arrives on the stage's "empty" mbarrier.  Thread 0 refills a
//     slot kLag = 2 stages after it was read, when both warpgroups have
//     released it, so a refill has kRing - kLag stages of tensor work to
//     land.  The mbarrier waits loop inside their asm and every thread
//     arrives: with a wait written as a C++ loop, ptxas serialised every
//     wgmma (C7518, "WG.DP in divergent path"); in this form `-Xptxas -v`
//     reports no serialisation.
//   * Epilogue: the accumulators are rounded to bf16 and staged in shared
//     memory over the then dead input tile (pitch 272 B, no bank conflicts),
//     then each pixel's 128 channels are written with 16-byte stores, masked
//     at the image's right and bottom edge.
//   * Shared memory: 6 x 16 KB ring + 92,480 B tile + 96 B of barriers =
//     190,880 B, one block per SM (218 registers a thread).
// Not done yet (later work): persistent blocks that overlap one tile's
// staging and epilogue with the next tile's tensor work, cluster multicast
// of the weight stages, a 128-byte swizzle, and a producer warpgroup with
// setmaxnreg (a producer warp beside the two warpgroups without it makes
// ptxas cap every thread's registers for 288 threads and spill).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 128;                  // input = output channels
constexpr int kTH = 8;                   // output tile rows
constexpr int kTW = 32;                  // output tile columns
constexpr int kHH = kTH + 2;             // staged input rows (one-pixel border)
constexpr int kHW = kTW + 2;             // staged input columns
constexpr int kPitch = kC + 8;           // bf16 pitch of a staged pixel (272 B)
constexpr int kThreads = 256;            // 2 consumer warpgroups
constexpr int kVecs = kC / 8;            // 16-byte vectors in a pixel's channels
constexpr int kStages = 18;              // 9 taps x 2 halves of the channels
constexpr int kStageBytes = 64 * kC * 2; // 16,384
constexpr int kRing = 6;                 // weight stages in shared memory
constexpr int kLag = 2;                  // a stage is refilled kLag stages later
constexpr int kRingBytes = kRing * kStageBytes;
constexpr int kTileBytes = kHH * kHW * kPitch * 2;  // 92,480
constexpr size_t kSmemBytes =
    static_cast<size_t>(kRingBytes + kTileBytes) + 2 * kRing * sizeof(uint64_t);
static_assert(kTH * kTW * kPitch * 2 <= kTileBytes,
              "the epilogue reuses the input tile");
static_assert(kTileBytes % 8 == 0, "the barriers follow the tile");
static_assert(kLag >= 1 && kLag < kRing && kRing <= kStages, "ring shape");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Spins until the barrier's phase of the given parity has completed.  The
// loop lies inside the asm: a loop in C++ is a divergent path to ptxas, which
// then serialises every wgmma in flight across it (C7518).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma that owns them.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// d (64 x 128, f32) += a (64 x 16 bf16, registers) * b (16 x 128 bf16,
// shared memory, K-major, no swizzle, described by desc).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The descriptor of a K-major, unswizzled 16 x 128 B operand at smem_addr:
// start address, leading byte offset 128, stride byte offset 256, all in
// 16-byte units; layout type 0 (no swizzle).
__device__ __forceinline__ uint64_t b_desc(uint32_t smem_addr) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

__global__ void __launch_bounds__(kThreads, 1)
conv3x3_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ wpk,
               __nv_bfloat16* __restrict__ out, int h, int wd) {
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* tile = smem + kRingBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(tile + kTileBytes);
  uint64_t* empty = full + kRing;
  const uint32_t ring_s = smem_u32(ring);
  const uint32_t tile_s = smem_u32(tile);
  const int y0 = blockIdx.y * kTH;
  const int x0 = blockIdx.x * kTW;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = tid >> 7;          // warpgroup: tile rows 4g .. 4g + 3
  const int wg = (tid >> 5) & 3;   // warp in the warpgroup

  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // One bulk copy brings weight stage `stage` into ring slot `slot`.
  auto fill = [&](int slot, int stage) {
    mbar_expect_tx(smem_u32(full + slot), kStageBytes);
    bulk_load(ring_s + slot * kStageBytes,
              reinterpret_cast<const unsigned char*>(wpk) +
                  static_cast<size_t>(stage) * kStageBytes,
              kStageBytes, smem_u32(full + slot));
  };
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) fill(s, s);
  }

  // The input tile: staged pixel (ty, tx) is image pixel (y0+ty-1, x0+tx-1).
  for (int i = tid; i < kHH * kHW * kVecs; i += kThreads) {
    const int p = i / kVecs;
    const int v = i - p * kVecs;
    const int ty = p / kHW;
    const int gy = y0 + ty - 1;
    const int gx = x0 + (p - ty * kHW) - 1;
    const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < wd;
    const __nv_bfloat16* src =
        inside ? x + (static_cast<int64_t>(gy) * wd + gx) * kC + v * 8 : x;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     tile_s + (p * kPitch + v * 8) * 2),
                 "l"(src), "r"(inside ? 16 : 0)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  float acc[2][64];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[j][i] = 0.0f;
  }
  // Row m of this warpgroup's 64-pixel m-tile j is output pixel
  // (4g + 2j + m / 32, m % 32); this warp holds m = 16 wg .. 16 wg + 15, and
  // lane l points ldmatrix at m = 16 wg + l % 16, channels + 8 (l / 16).
  const uint32_t a_base =
      tile_s + (((4 * g + (wg >> 1)) * kHW + 16 * (wg & 1) + (lane & 15)) * kPitch +
                8 * (lane >> 4)) * 2;
  constexpr uint32_t kMTileStep = 2 * kHW * kPitch * 2;  // two tile rows
  // The A fragments of stage s: tap s / 2, input channels 64 (s % 2) on.
  auto load_a = [&](uint32_t (&a)[4][2][4], int s) {
    const int tap = s >> 1;
    const int dy = tap / 3;
    const int dx = tap - 3 * dy;
    const uint32_t at = a_base + ((dy * kHW + dx) * kPitch + 64 * (s & 1)) * 2;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int j = 0; j < 2; ++j) ldmatrix_x4(a[ks][j], at + j * kMTileStep + ks * 32);
    }
  };

  // Stage s: thread 0 refills the slot of stage s - kLag, released one
  // stage ago; every thread waits for stage s's weights, issues its 8 wgmma
  // on the A fragments in `cur` and, while they run, retires stage s - 1
  // (wait_group 1), releases its slot and loads stage s + 1's fragments into
  // `nxt`, the registers stage s - 1 read.
  auto step = [&](int s, uint32_t (&cur)[4][2][4], uint32_t (&nxt)[4][2][4]) {
    const int done = s - kLag;
    if (tid == 0 && done >= 0 && done + kRing < kStages) {
      mbar_wait(smem_u32(empty + done % kRing), (done / kRing) & 1);
      fill(done % kRing, done + kRing);
    }
    __syncwarp();
    const int slot = s % kRing;
    mbar_wait(smem_u32(full + slot), (s / kRing) & 1);
    const uint64_t desc = b_desc(ring_s + slot * kStageBytes);
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wgmma_m64n128k16(acc[j], cur[ks][j], desc + ks * (4096 >> 4));
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    if (s > 0) mbar_arrive(smem_u32(empty + (s - 1) % kRing));
    if (s + 1 < kStages) load_a(nxt, s + 1);
  };
  uint32_t a0[4][2][4], a1[4][2][4];
  load_a(a0, 0);
#pragma unroll 1
  for (int s = 0; s < kStages; s += 2) {
    step(s, a0, a1);
    step(s + 1, a1, a0);
  }
  wgmma_wait<0>();
  fence_acc(acc[0]);
  fence_acc(acc[1]);

  __syncthreads();  // every warp is done reading the input tile
  // Accumulator i of m-tile j: pixel m = 16 wg + lane / 4 + 8 (i / 2 % 2),
  // channel 8 (i / 4) + 2 (lane % 4) + i % 2.
  auto* stage_out = reinterpret_cast<__nv_bfloat16*>(tile);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = 4 * g + 2 * j + (wg >> 1);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = row * kTW + 16 * (wg & 1) + (lane >> 2) + 8 * r;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(stage_out + p * kPitch + 8 * n +
                                           2 * (lane & 3)) =
            __floats2bfloat162_rn(acc[j][4 * n + 2 * r], acc[j][4 * n + 2 * r + 1]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kTH * kTW * kVecs; i += kThreads) {
    const int p = i / kVecs;
    const int v = i - p * kVecs;
    const int gy = y0 + p / kTW;
    const int gx = x0 + p % kTW;
    if (gy < h && gx < wd) {
      reinterpret_cast<uint4*>(out + (static_cast<int64_t>(gy) * wd + gx) * kC)[v] =
          reinterpret_cast<const uint4*>(stage_out + p * kPitch)[v];
    }
  }
}

}  // namespace

// C entry for ctypes: x (h, wd, 128) bf16, wpk the 18 packed weight stages
// (ops/conv3x3.py::pack_weights), out (h, wd, 128) bf16.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int conv3x3_bf16(const void* x, const void* wpk, void* out, int h,
                            int wd, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(conv3x3_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((wd + kTW - 1) / kTW, (h + kTH - 1) / kTH);
  conv3x3_kernel<<<grid, kThreads, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wpk),
      static_cast<__nv_bfloat16*>(out), h, wd);
  return static_cast<int>(cudaGetLastError());
}

