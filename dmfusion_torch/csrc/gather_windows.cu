// Batched patch-window gather for Hopper (sm_90a): one launch a family call.
//
// Replaces the TPU kernel dmfusion/ops/pallas_gather.py::gather_windows_pallas
// (body _block_copy_kernel) and the per-stream launches of its wrappers
// (gather_one_fast, gather_dual_fast, gather_tri_fast, gather_quad_fast,
// gather_dual_sharded).  A launch takes up to four streams, each a row-major
// scene (H', W', C) with its own anchor scale (1 at MS geometry, 4 at PAN
// geometry) and window edge win = patch * scale, and one int32 anchor array:
// flat ids, decoded here as x = floor(id / width), y = id - x * width (the
// plain version's floor division, so negative and out-of-range ids give its
// windows), times the stream's scale; or explicit (xs, ys) starts.  Each start
// is then placed as jax.lax.dynamic_slice places it: a negative start counts
// from the end (x + H'), then x is clamped into [0, H' - win] and y into
// [0, W' - win].  For output row j of a stream,
//     out[j, r, :] = scene[x_a + r, y_a*C : (y_a + win)*C],  r < win,
// with a = lo + j for j < hi - lo, and a = 0 past that: a rank's shard of a
// batch, padded with the batch's first anchor as Mesh.shard pads it.  The
// copy is of raw bits, so f32 and bf16 scenes share the code, and offsets
// are 64-bit (the image9 PAN view holds about 0.8 G elements).
//
// What bounds it on this card: bytes.  A copy does no arithmetic; one dual
// bucket reads and writes 2*B*(p^2*C_ms + (4p)^2)*itemsize bytes, about
// 168 MB at B = 4096, p = 16, C_ms = 4 in f32, i.e. about 50 us at the
// H100's 3.35 TB/s.  The design:
//   * the grid is one flat list of work items over all streams of the call,
//     an item being a group of rows of one window (up to 4 rounds of
//     32 * kUnroll copy units, the row count that idles the fewest lanes),
//     walked by the warps of the blocks resident on the SMs;
//   * every unit is 16 bytes where every stream's window row is a multiple
//     of 16 bytes (256 B at patch 16, 752 B at patch 47 in f32): output rows
//     then start 16-byte aligned and every store is 16 bytes.  A source row
//     is 16-byte aligned only where its offset is: always for an f32 MS
//     scene (16 B pixels, a pitch of 8,464 f32), at even y in bf16, and on
//     one row in four of the f32 PAN view (a pitch of 8,467 f32 = 33,868 B).
//     An unaligned unit is read as the two aligned 16-byte words around it
//     and realigned in registers (__funnelshift_r); the second word is the
//     neighbouring lane's first, so DRAM reads each byte once.  Measured in
//     turns on the H100 against loads of the widest width each address
//     allows (8, 4 or 2 bytes) and against an L2 256-byte prefetch hint on
//     the loads, it was as fast or faster, and those ways were dropped;
//   * stores are 16 bytes with the evict-first policy (st.global.cs): the
//     windows of a bucket outgrow L2, and it measured as fast or faster;
//   * other rows (bf16 at patch 47: 376 B PAN rows) copy element-wide;
//   * each lane keeps kUnroll units in flight before it stores.
// TMA is not usable: a tensor map needs global strides that are multiples
// of 16 bytes, and the PAN view's pitch is not; a pitched copy of the 273 MB
// PAN scene is not worth it for a gather that reads each byte once.  Tensor
// cores and shared-memory staging have no part in a pure copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxStreams = 4;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // units a lane has in flight
constexpr int kItemUnits = 32 * kUnroll;

struct StreamDesc {
  const unsigned char* scene;
  unsigned char* out;
  long long rows;       // H'
  long long width;      // W'
  long long pitch;      // bytes of a scene row: W' * C * itemsize
  int pix_bytes;        // C * itemsize
  int scale;            // anchor scale
  int win;              // window edge: patch * scale
  int units;            // copy units in a window row
  int rows_per_item;
  int groups;           // items a window
  unsigned first_item;  // the stream's first item in the flat list
};

struct Params {
  StreamDesc s[kMaxStreams];
  const int32_t* ids;  // flat ids, or explicit row starts when ys is set
  const int32_t* ys;   // explicit column starts, or null
  int id_width;        // the scene width the flat ids count in
  int lo, hi;          // the batch's rows [lo, hi) this call gathers
  int nstreams;
  unsigned items;
};

template <int kBytes> struct Unit;
template <> struct Unit<16> { using T = uint4; };
template <> struct Unit<4> { using T = uint32_t; };
template <> struct Unit<2> { using T = uint16_t; };

// Bytes [m, m + 16) of the 32 bytes lo:hi, m in [1, 15].
__device__ __forceinline__ uint4 realign(uint4 lo, uint4 hi, unsigned m) {
  const unsigned sh = (m & 3u) * 8u;
  uint32_t a0, a1, a2, a3, a4;
  switch (m >> 2) {
    case 0: a0 = lo.x; a1 = lo.y; a2 = lo.z; a3 = lo.w; a4 = hi.x; break;
    case 1: a0 = lo.y; a1 = lo.z; a2 = lo.w; a3 = hi.x; a4 = hi.y; break;
    case 2: a0 = lo.z; a1 = lo.w; a2 = hi.x; a3 = hi.y; a4 = hi.z; break;
    default: a0 = lo.w; a1 = hi.x; a2 = hi.y; a3 = hi.z; a4 = hi.w; break;
  }
  return make_uint4(__funnelshift_r(a0, a1, sh), __funnelshift_r(a1, a2, sh),
                    __funnelshift_r(a2, a3, sh), __funnelshift_r(a3, a4, sh));
}

template <int kBytes>
__device__ __forceinline__ typename Unit<kBytes>::T load_unit(
    const unsigned char* a) {
  using T = typename Unit<kBytes>::T;
  if constexpr (kBytes == 16) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(a);
    const unsigned m = static_cast<unsigned>(addr & 15u);
    const uint4* w = reinterpret_cast<const uint4*>(addr - m);
    if (m == 0) return __ldg(w);
    return realign(__ldg(w), __ldg(w + 1), m);
  } else {
    return __ldg(reinterpret_cast<const T*>(a));
  }
}

// A 16-byte unit is stored with the evict-first (streaming) policy.
template <int kBytes>
__device__ __forceinline__ void store_unit(typename Unit<kBytes>::T* p,
                                           typename Unit<kBytes>::T v) {
  if constexpr (kBytes == 16) {
    asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};"
                 :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                 : "memory");
  } else {
    *p = v;
  }
}

// floor(a / b) for b > 0, as the plain version's `//`.
__device__ __forceinline__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

template <int kBytes>
__global__ void __launch_bounds__(kThreads)
gather_family_kernel(const __grid_constant__ Params p) {
  using T = typename Unit<kBytes>::T;
  const int lane = threadIdx.x & 31;
  const unsigned nwarps = (gridDim.x * kThreads) >> 5;
  for (unsigned t = (blockIdx.x * kThreads + threadIdx.x) >> 5; t < p.items;
       t += nwarps) {
    int si = 0;
#pragma unroll
    for (int k = 1; k < kMaxStreams; ++k)
      if (k < p.nstreams && t >= p.s[k].first_item) si = k;
    const StreamDesc& s = p.s[si];
    const unsigned local = t - s.first_item;
    const int j = static_cast<int>(local / s.groups);
    const int g = static_cast<int>(local - j * s.groups);
    const int a = j < p.hi - p.lo ? p.lo + j : 0;

    long long x, y;
    if (p.ys != nullptr) {
      x = p.ids[a];
      y = p.ys[a];
    } else {
      const long long id = p.ids[a];
      const long long q = floor_div(id, p.id_width);
      x = q * s.scale;
      y = (id - q * p.id_width) * s.scale;
    }
    if (x < 0) x += s.rows;  // dynamic_slice: negative starts count from the end
    if (y < 0) y += s.width;
    x = x < 0 ? 0 : (x > s.rows - s.win ? s.rows - s.win : x);
    y = y < 0 ? 0 : (y > s.width - s.win ? s.width - s.win : y);

    const int r0 = g * s.rows_per_item;
    const int n = min(s.rows_per_item, s.win - r0) * s.units;
    const unsigned char* src = s.scene + (x + r0) * s.pitch + y * s.pix_bytes;
    T* dst = reinterpret_cast<T*>(
        s.out + (static_cast<long long>(j) * s.win + r0) *
                    static_cast<long long>(s.units) * kBytes);
    for (int base = 0; base < n; base += kItemUnits) {
      T v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int i = base + lane + 32 * k;
        if (i < n) {
          const int r = i / s.units;
          v[k] = load_unit<kBytes>(src + r * s.pitch +
                                   (i - r * s.units) * kBytes);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int i = base + lane + 32 * k;
        if (i < n) store_unit<kBytes>(dst + i, v[k]);
      }
    }
  }
}

// Resident blocks an SM times the SMs, per device and unit width.
template <int kBytes>
int grid_cap(int device) {
  static int cap[64] = {};
  int& c = cap[device & 63];
  if (c == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gather_family_kernel<kBytes>, kThreads, 0);
    c = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  return c;
}

template <int kBytes>
cudaError_t launch(const Params& p, cudaStream_t stream, int device) {
  const long long warps_per_block = kThreads / 32;
  long long blocks = (p.items + warps_per_block - 1) / warps_per_block;
  const int cap = grid_cap<kBytes>(device);
  if (blocks > cap) blocks = cap;
  gather_family_kernel<kBytes><<<static_cast<int>(blocks), kThreads, 0,
                                  stream>>>(p);
  return cudaGetLastError();
}

// Rows of a window one work item copies: the count, up to 4 * kItemUnits
// units, that leaves the fewest lanes idle in the item's last round.
int rows_per_item(int units, int win) {
  int best = 1;
  long long best_used = 0, best_slots = 1;
  for (int r = 1; r <= win && (r == 1 || r * units <= 4 * kItemUnits); ++r) {
    const long long used = static_cast<long long>(r) * units;
    const long long slots = (used + kItemUnits - 1) / kItemUnits * kItemUnits;
    if (used * best_slots > best_used * slots) {
      best = r;
      best_used = used;
      best_slots = slots;
    }
  }
  return best;
}

}  // namespace

// C entry for ctypes.  Returns the cudaError_t of the launch (0 = success).
// One array of 64-bit integers (addresses as integers):
//   [0..10]  nstreams, elem_bytes, patch, id_width, lo, hi, per, device,
//            ids, ys (or 0), the CUDA stream;
//   then per stream 6: its scene, its output (the wrapper allocates every
//            output), rows H', width W', channels C, anchor scale.
// The output of a stream holds `per` windows of (win, win, C) elements.
extern "C" int gather_family(const long long* a) {
  const int nstreams = static_cast<int>(a[0]);
  const int elem_bytes = static_cast<int>(a[1]);
  const int patch = static_cast<int>(a[2]);
  const long long per = a[6];
  const int device = static_cast<int>(a[7]);
  if (nstreams < 1 || nstreams > kMaxStreams ||
      (elem_bytes != 2 && elem_bytes != 4) || patch < 1 || per < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  auto addr = [](long long v) {
    return reinterpret_cast<void*>(static_cast<uintptr_t>(v));
  };
  Params p = {};
  p.id_width = static_cast<int>(a[3]);
  p.lo = static_cast<int>(a[4]);
  p.hi = static_cast<int>(a[5]);
  p.nstreams = nstreams;
  p.ids = static_cast<const int32_t*>(addr(a[8]));
  p.ys = static_cast<const int32_t*>(addr(a[9]));
  if (p.ys == nullptr && p.id_width < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte units where every window row is a multiple of 16 bytes and
  // every output starts 16-byte aligned; element-wide units otherwise.
  bool wide = true;
  for (int k = 0; k < nstreams; ++k) {
    const long long* d = a + 11 + 6 * k;
    wide = wide && patch * d[5] * d[4] * elem_bytes % 16 == 0 && d[1] % 16 == 0;
  }
  const int unit = wide ? 16 : elem_bytes;
  long long items = 0;
  for (int k = 0; k < nstreams; ++k) {
    const long long* d = a + 11 + 6 * k;
    StreamDesc& s = p.s[k];
    s.scene = static_cast<const unsigned char*>(addr(d[0]));
    s.out = static_cast<unsigned char*>(addr(d[1]));
    s.rows = d[2];
    s.width = d[3];
    s.pix_bytes = static_cast<int>(d[4]) * elem_bytes;
    s.pitch = d[3] * s.pix_bytes;
    s.scale = static_cast<int>(d[5]);
    s.win = patch * s.scale;
    s.units = s.win * s.pix_bytes / unit;
    s.rows_per_item = rows_per_item(s.units, s.win);
    s.groups = (s.win + s.rows_per_item - 1) / s.rows_per_item;
    s.first_item = static_cast<unsigned>(items);
    items += per * s.groups;
  }
  if (items >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  p.items = static_cast<unsigned>(items);
  if (items == 0) return 0;
  auto stream = static_cast<cudaStream_t>(addr(a[10]));
  switch (unit) {
    case 16: return static_cast<int>(launch<16>(p, stream, device));
    case 4: return static_cast<int>(launch<4>(p, stream, device));
    default: return static_cast<int>(launch<2>(p, stream, device));
  }
}
