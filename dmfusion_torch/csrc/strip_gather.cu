// Strip gather for Hopper (sm_90a).
//
// Replaces the TPU kernel dmfusion/ops/pallas_strip_gather.py::
// gather_strips_pallas (body _strip_copy_kernel).  For n strips over a
// row-major scene view of shape (rows, row_elems) = (H', W'*C), strip k
// holds `strip` windows, window s starting at row xs[k] and pixel column
// y0s[k] + s*stride:
//     out[k, s, r, :] = view[xs[k] + r, (y0s[k] + s*stride)*C : ... + patch*C]
// for r < patch, in an (n, strip, patch, patch*C) output.  Elements past the
// bottom or the right edge of the view read as zeros, as the TPU kernel's
// zero-padded view gives them.  Starts are non-negative (the wrapper checks).
//
// What bounds it on this card: bytes.  A copy does no arithmetic.  At the
// bench's 98,304 image6 anchors (strip 128, patch 16, f32) it writes 0.40 GB
// of MS and 1.61 GB of PAN windows and needs only the slabs the strips
// cover, so the written windows are almost all of the traffic: about
// 0.6 ms at the H100's 3.35 TB/s.  The TPU design (one aligned DMA per strip
// slab, a one-hot row-selection matmul, lane-group slices) answers TPU
// tiling rules that do not exist here.  This design is the strip idea read
// for Hopper:
//   * one block per (strip, group of window rows, group of windows) stages
//     the slab those windows share once in shared memory, one warp per slab
//     row, consecutive lanes on consecutive elements (coalesced along W'*C),
//     with zero fill past the view;
//   * the block then writes its windows from shared memory, one warp per
//     window row, so every window row is one coalesced run of writes;
//   * the host sizes the groups so a slab fits in 46 KB of shared memory,
//     under the 48 KB a block gets without opting in (the image6 PAN slab of
//     64 rows x 572 f32 is 143 KB whole, so its rows go in four groups of 16);
//   * elements are copied as raw bits through a template on the element size
//     (4 or 2 bytes), so f32 and bf16 scenes share the code, and offsets are
//     64-bit (the image6 PAN output alone holds 0.4 G elements).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kSlabBytes = 46 * 1024;  // SLAB_BYTES in ops/strip_gather.py

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_strips_kernel(const T* __restrict__ scene, int64_t rows,
                     int64_t row_elems, const int32_t* __restrict__ xs,
                     const int32_t* __restrict__ y0s, int strip, int patch,
                     int chans, int stride, int rows_per_block,
                     int wins_per_block, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slab = reinterpret_cast<T*>(smem_raw);
  const int64_t k = blockIdx.x;
  const int r0 = blockIdx.y * rows_per_block;
  const int s0 = blockIdx.z * wins_per_block;
  const int nrows = min(rows_per_block, patch - r0);
  const int nwins = min(wins_per_block, strip - s0);
  const int win = patch * chans;    // elements in one window row
  const int step = stride * chans;  // elements from one window to the next
  const int cols = (nwins - 1) * step + win;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // Stage the slab: rows xs[k] + r0 .., elements from the group's first
  // window on; zeros past the view.
  const int64_t x = static_cast<int64_t>(xs[k]) + r0;
  const int64_t c0 =
      (static_cast<int64_t>(y0s[k]) + static_cast<int64_t>(s0) * stride) *
      chans;
  for (int r = warp; r < nrows; r += kWarps) {
    T* dst = slab + r * cols;
    if (x + r < rows) {
      const T* src = scene + (x + r) * row_elems;
      for (int c = lane; c < cols; c += 32) {
        dst[c] = c0 + c < row_elems ? src[c0 + c] : T(0);
      }
    } else {
      for (int c = lane; c < cols; c += 32) dst[c] = T(0);
    }
  }
  __syncthreads();

  // Write the group's windows: window row (s, r) is slab row r from
  // element s*step on.
  const int n = nwins * nrows;
  for (int i = warp; i < n; i += kWarps) {
    const int s = i / nrows;
    const int r = i - s * nrows;
    const T* src = slab + r * cols + s * step;
    T* dst = out + ((k * strip + s0 + s) * patch + r0 + r) *
                       static_cast<int64_t>(win);
    for (int c = lane; c < win; c += 32) dst[c] = src[c];
  }
}

template <typename T>
cudaError_t launch(const void* scene, int64_t rows, int64_t row_elems,
                   const int32_t* xs, const int32_t* y0s, int n, int strip,
                   int patch, int chans, int stride, void* out,
                   cudaStream_t stream) {
  const int64_t budget = kSlabBytes / static_cast<int64_t>(sizeof(T));
  const int64_t win = static_cast<int64_t>(patch) * chans;
  const int64_t step = static_cast<int64_t>(stride) * chans;
  // Windows per block: the whole strip, halved until one slab row fits.
  int wins = strip;
  while (wins > 1 && (wins - 1) * step + win > budget) wins = (wins + 1) / 2;
  const int64_t cols = (wins - 1) * step + win;
  if (cols > budget) return cudaErrorInvalidValue;
  // Rows per block: as many as fit, balanced over the groups.
  const int64_t fit = budget / cols;
  const int most = static_cast<int>(fit < patch ? fit : patch);
  const int row_groups = (patch + most - 1) / most;
  const int rows_per_block = (patch + row_groups - 1) / row_groups;
  const int win_groups = (strip + wins - 1) / wins;
  if (row_groups > 65535 || win_groups > 65535) return cudaErrorInvalidValue;
  const dim3 grid(n, row_groups, win_groups);
  const size_t smem = static_cast<size_t>(rows_per_block) * cols * sizeof(T);
  gather_strips_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(scene), rows, row_elems, xs, y0s, strip, patch,
      chans, stride, rows_per_block, wins, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes.  Returns the cudaError_t of the launch (0 = success).
extern "C" int gather_strips(const void* scene, long long rows,
                             long long row_elems, const void* xs,
                             const void* y0s, int n, int strip, int patch,
                             int chans, int stride, int elem_bytes, void* out,
                             void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* x = static_cast<const int32_t*>(xs);
  const auto* y = static_cast<const int32_t*>(y0s);
  auto s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 4:
      err = launch<uint32_t>(scene, rows, row_elems, x, y, n, strip, patch,
                             chans, stride, out, s);
      break;
    case 2:
      err = launch<uint16_t>(scene, rows, row_elems, x, y, n, strip, patch,
                             chans, stride, out, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
