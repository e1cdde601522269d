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
//       t[i+r, j+u, (2c+d)C + k] * scale                (f32 from 0, cast once)
// in exactly that order, so the result is bit-equal to the plain version
// dmfusion_torch/ops/pool.py::phase_pool_ref.  The multiply and the add are
// __fmul_rn/__fadd_rn so nvcc cannot contract them into an FMA (which would
// change bits for a patch whose 1/patch^2 is not a power of two).
//
// What bounds it on this card: bytes.  At image6, width 32, patch 16 it
// reads (1008, 1058, 128) and writes (1001, 1051, 128) bf16: 542.3 MB, a
// 0.1619 ms bound at 3.35 TB/s.  The order above costs 2 (ph - 1) f32 adds
// per element of t and 8 f32 operations per output: 1.9 G and 1.1 G at
// that shape, 0.09 ms of the f32 pipes at their peak, before the bf16
// conversions, loads, stores and barriers.  So the SMs' instruction issue
// holds it, above the bytes: the design spends as few instructions,
// barriers and shared-memory bytes per element as it can.
// The TPU design (a slab DMA, four selection matmuls on the MXU) is not
// carried over.
//
// The launch plan (body, column tile, threads, copy width, mix width,
// shared bytes, grid) is computed on the host by ops/pool.py::launch_plan
// and checked here.  Two bodies, chosen there by shape:
//
// phase_pool_kernel<T, PH> (ph <= 16 where 512 threads hold every channel
// of two t columns, and the pointer is 4-byte aligned: every shape the
// port runs), one instantiation per ph so the folds index registers:
//   * whole pixels: a column tile is TJ output columns x all 4C channels;
//     one block per SM takes an equal share of the column tiles' rows laid
//     end to end, as one or two runs down a tile, each run reading its ph
//     rows of halo (3 % at image6; a grid of fixed row tiles left a third
//     wave part-empty and read 9 % of halo);
//   * each input row segment (TJ + ph pixels, contiguous in device memory)
//     is staged in the feature dtype by cp.async (16-byte copies where the
//     pixel allows, 8 or 4 otherwise), zero-filled past (H2, W2), into a
//     ring of kStages rows, so the next rows' copies fly while this one is
//     folded; one block barrier per input row covers the ring, the t rows
//     and the mix;
//   * a thread owns 4 channels of NC consecutive t columns (NC = 2 for
//     ph <= 8, else 1) and keeps, in registers, the ph open partial row
//     folds of t; each starts at rs[i] and adds the later rows in order, so
//     t is the plain left fold (a running sum that adds one row and
//     subtracts another would not be);
//   * a finished t row is rounded to the feature dtype and written to a
//     ring of three t rows in shared memory, at a pixel pitch padded by 64
//     bytes where the pixel is a multiple of 128; the mix of an output row
//     runs one input row later: a thread loads the nine t values that `vo`
//     channels of all four phase blocks read, once each, and adds each
//     block's four terms in phase_terms() order;
//   * per row, nothing is divided and no address is recomputed from its
//     row index: ring positions and pointers advance.
//
// phase_pool_kernel_smem<T> (ph > 16, or 4C too wide for the registers
// body): the row-streaming body of the first port: KC channels of each
// phase block, a ring of ph column-sum rows in shared memory as f32, three
// barriers per input row.  Its order of adds is the same.
//
// Both are templated on float and __nv_bfloat16 and use 64-bit offsets.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;    // registers body
constexpr int kMaxRegPh = 16;       // largest ph with a registers body
constexpr int kSmemThreads = 256;   // shared body
constexpr int kMaxSmem = 232448;    // 227 KB a block
constexpr int kStages = 3;          // input rows in the staging ring

// Raw bits of one element, and the conversions to and from f32.
template <typename T> struct Raw;
template <> struct Raw<float> {
  using type = uint32_t;
  static __device__ __forceinline__ float f(uint32_t b) {
    return __uint_as_float(b);
  }
  static __device__ __forceinline__ uint32_t r(float x) {
    return __float_as_uint(x);
  }
};
template <> struct Raw<__nv_bfloat16> {
  using type = uint16_t;
  static __device__ __forceinline__ float f(uint16_t b) {
    return __uint_as_float(static_cast<uint32_t>(b) << 16);
  }
  static __device__ __forceinline__ uint16_t r(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

template <int BYTES> struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<4> { using type = uint32_t; };
template <> struct Vec<2> { using type = uint16_t; };

// N elements at p (aligned to their size) as f32, in one load.  Pairs of
// bf16 unpack from their 32-bit word: a shift and a mask.
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* p, float (&v)[N]) {
  using V = typename Vec<N * sizeof(T)>::type;
  if constexpr (sizeof(T) == 2 && N % 2 == 0) {
    union { V vec; uint32_t w[N / 2]; } u;
    u.vec = *reinterpret_cast<const V*>(p);
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      v[2 * k] = __uint_as_float(u.w[k] << 16);
      v[2 * k + 1] = __uint_as_float(u.w[k] & 0xffff0000u);
    }
  } else {
    union { V vec; typename Raw<T>::type e[N]; } u;
    u.vec = *reinterpret_cast<const V*>(p);
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = Raw<T>::f(u.e[k]);
  }
}

// N f32 values rounded to T, in one store.
template <typename T, int N>
__device__ __forceinline__ void store_f(T* p, const float (&v)[N]) {
  using R = typename Raw<T>::type;
  union { typename Vec<N * sizeof(T)>::type vec; R e[N]; } u;
#pragma unroll
  for (int k = 0; k < N; ++k) u.e[k] = Raw<T>::r(v[k]);
  *reinterpret_cast<typename Vec<N * sizeof(T)>::type*>(p) = u.vec;
}

// The phase mix's terms (r << 3 | u << 2 | c*2+d), 4 bits each, 16 bits per
// output block a*2+b, in summation order: the rule of the note above.
constexpr uint64_t mix_terms() {
  uint64_t packed = 0;
  for (int ob = 0; ob < 4; ++ob) {
    const int a = ob >> 1, b = ob & 1;
    int n = 0;
    for (int ru = 0; ru < 4; ++ru) {
      for (int ib = 0; ib < 4; ++ib) {
        const int r = ru >> 1, u = ru & 1, ci = ib >> 1, di = ib & 1;
        if ((a & (1 - ci)) == r && (b & (1 - di)) == u) {
          packed |= static_cast<uint64_t>(r << 3 | u << 2 | ib)
                    << (16 * ob + 4 * n);
          ++n;
        }
      }
    }
  }
  return packed;
}
constexpr uint64_t kMixTerms = mix_terms();

// One cp.async of BYTES (16, 8 or 4) bytes; src_bytes 0 fills zeros.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(d), "l"(src), "n"(BYTES), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Stage one input row segment into dst: copy k (this thread's are
// threadIdx.x + m * blockDim.x) reads BYTES at src + k * BYTES when
// k < in_chunks, else fills zeros (rows and columns past the map).  BYTES
// divides the pixel's bytes, so no copy straddles a pixel.
template <int BYTES>
__device__ __forceinline__ void stage_chunks(unsigned char* dst,
                                             const unsigned char* src,
                                             const unsigned char* any_src,
                                             int nchunks, int in_chunks) {
  for (int k = threadIdx.x; k < nchunks; k += blockDim.x) {
    const bool in = k < in_chunks;
    cp_async<BYTES>(dst + k * BYTES, in ? src + k * BYTES : any_src,
                    in ? BYTES : 0);
  }
}

// Stage a row and commit it as one group of this thread's copies.
__device__ __forceinline__ void stage_row(unsigned char* dst,
                                          const unsigned char* src,
                                          const unsigned char* any_src,
                                          int nchunks, int in_chunks,
                                          int chunk) {
  if (chunk == 16) {
    stage_chunks<16>(dst, src, any_src, nchunks, in_chunks);
  } else if (chunk == 8) {
    stage_chunks<8>(dst, src, any_src, nchunks, in_chunks);
  } else {
    stage_chunks<4>(dst, src, any_src, nchunks, in_chunks);
  }
  cp_async_commit();
}

// The t values the mix reads, as a 16-bit mask over the 4-bit term codes:
// nine of the sixteen (r, u, c*2+d).
constexpr uint32_t mix_used() {
  uint32_t used = 0;
  for (int k = 0; k < 16; ++k) used |= 1u << ((kMixTerms >> (4 * k)) & 15);
  return used;
}
constexpr uint32_t kMixUsed = mix_used();

// Output pixel (i, j0 + jj), channels k .. k + MV - 1 of all four phase
// blocks: the nine t values they read are loaded once each (t0 = t row i,
// t1 = t row i + 1, `off` = column jj, channel k of block 0, tpp the t
// pixel pitch), then each block adds its four terms from 0 in kMixTerms'
// order; the codes are compile-time constants in the unrolled loops.
template <typename T, int MV>
__device__ __forceinline__ void mix_pixel(const T* t0, const T* t1, T* dst,
                                          int off, int tpp, int c,
                                          float scale) {
  float v[16][MV];
#pragma unroll
  for (int code = 0; code < 16; ++code) {
    if (kMixUsed >> code & 1) {
      load_f<T, MV>((code & 8 ? t1 : t0) + off + ((code >> 2) & 1) * tpp +
                        (code & 3) * c,
                    v[code]);
    }
  }
#pragma unroll
  for (int ob = 0; ob < 4; ++ob) {
    float acc[MV];
#pragma unroll
    for (int e = 0; e < MV; ++e) acc[e] = 0.f;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int code = (kMixTerms >> (16 * ob + 4 * n)) & 15;
#pragma unroll
      for (int e = 0; e < MV; ++e) {
        acc[e] = __fadd_rn(acc[e], __fmul_rn(v[code][e], scale));
      }
    }
    store_f<T, MV>(dst + ob * c, acc);
  }
}

// A thread's mix work in an output row: pixel column jj, channel group kg
// (MV channels of each phase block), then every (dj, dkg) further.
struct MixStart {
  int jj, kg, dj, dkg;
};

// Output row i0 + o, columns j0 .. j0 + cols - 1, from its t rows.
template <typename T, int MV>
__device__ __forceinline__ void mix_row(const T* t0, const T* t1, T* orow,
                                        int cols, int c4, int tpp,
                                        MixStart m, float scale) {
  const int c = c4 / 4;
  const int ngroups = c / MV;
  while (m.jj < cols) {
    mix_pixel<T, MV>(t0, t1, orow + m.jj * c4 + m.kg * MV,
                     m.jj * tpp + m.kg * MV, tpp, c, scale);
    m.jj += m.dj;
    m.kg += m.dkg;
    if (m.kg >= ngroups) {
      m.kg -= ngroups;
      ++m.jj;
    }
  }
}

__host__ __device__ __forceinline__ int round16(int bytes) {
  return (bytes + 15) & ~15;
}

// Bytes from one t pixel to the next in shared memory: 64 more where the
// pixel is a multiple of 128 bytes, so the pixel columns that one warp's
// mix loads read fall in both halves of the banks.
__host__ __device__ __forceinline__ int t_pitch(int pix) {
  return round16(pix) + (pix % 128 == 0 ? 64 : 0);
}

// Shared bytes of the registers body: a ring of kStages input rows of
// scols pixels, then three t rows of tcols pixels at t_pitch.
__host__ __device__ __forceinline__ int reg_smem_bytes(int tcols, int scols,
                                                       int pix) {
  return kStages * round16(scols * pix) + 3 * round16(tcols * t_pitch(pix));
}

template <typename T, int PH>
__global__ void __launch_bounds__(kMaxThreads, 1)
phase_pool_kernel(const T* __restrict__ f, int64_t h2, int64_t w2, int c4,
                  int ni, int nj, int tj, int chunk, int vo, float scale,
                  T* __restrict__ out) {
  constexpr int NC = PH <= 8 ? 2 : 1;  // t columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  const int groups = c4 / 4;
  const int npairs = (tj + NC) / NC;  // ceil((tj + 1) / NC)
  const int tcols = npairs * NC;
  const int scols = tcols + PH - 1;
  const int es = static_cast<int>(sizeof(T));
  const int pix = c4 * es;
  const int slot_bytes = round16(scols * pix);
  const int tpp = t_pitch(pix) / es;  // t pixel pitch, elements
  const int tslot = round16(tcols * t_pitch(pix)) / es;
  unsigned char* stage = smem;
  T* tbuf = reinterpret_cast<T*>(smem + kStages * slot_bytes);

  const unsigned char* fb = reinterpret_cast<const unsigned char*>(f);
  const int per_pix = pix / chunk;  // copies a staged pixel takes
  const int nchunks = scols * per_pix;
  const int64_t row_bytes = w2 * pix;

  // This thread's fold item: channels 4g .. 4g+3 of t columns q*NC ..
  const int g = threadIdx.x % groups;
  const int q = threadIdx.x / groups;
  const bool folds = q < npairs;
  const int fold_in = q * NC * c4 + g * 4;   // staged row, elements
  const int fold_t = q * NC * tpp + g * 4;   // t row, elements
  const int ngroups = c4 / 4 / vo;
  const int bd = static_cast<int>(blockDim.x);
  const MixStart mix{static_cast<int>(threadIdx.x) / ngroups,
                     static_cast<int>(threadIdx.x) % ngroups, bd / ngroups,
                     bd % ngroups};

  // Open partial folds of t rows not yet begun are never emitted, so acc
  // carries over from one run to the next; it starts at 0 only so that no
  // register is read before it is written.
  float acc[PH][NC][4];
#pragma unroll
  for (int p = 0; p < PH; ++p)
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[p][n][k] = 0.f;

  // The block's share of the output: rows pos .. end - 1 of the column
  // tiles laid end to end (tile-major), an equal share for every block.
  // Each run is a stretch of rows of one column tile: i0 .. i0 + tirows -
  // 1 of columns j0 .. j0 + cols - 1, from input rows i0 .. i0 + tirows +
  // PH - 1.
  const int64_t total = static_cast<int64_t>((nj + tj - 1) / tj) * ni;
  int64_t pos = total * blockIdx.x / gridDim.x;
  const int64_t end = total * (blockIdx.x + 1) / gridDim.x;
  while (pos < end) {
  const int64_t tile = pos / ni;
  const int64_t i0 = pos - tile * ni;
  const int64_t j0 = tile * tj;
  const int tirows = static_cast<int>(end - pos < ni - i0 ? end - pos
                                                            : ni - i0);
  pos += tirows;
  const int cols = nj - j0 < tj ? static_cast<int>(nj - j0) : tj;
  const int nrows = tirows + PH;
  // Staged pixels inside the map's columns, as copies.
  const int64_t in_cols = w2 - j0 < scols ? w2 - j0 : scols;
  const int in_chunks = static_cast<int>(in_cols) * per_pix;

  // The next input row to stage, and where it starts.
  int64_t next_r = i0;
  const unsigned char* next_src = fb + (i0 * w2 + j0) * pix;
  for (int s = 0; s < kStages - 1; ++s, ++next_r, next_src += row_bytes) {
    stage_row(stage + s * slot_bytes, next_src, fb, s < nrows ? nchunks : 0,
              next_r < h2 ? in_chunks : 0, chunk);
  }
  T* orow = out + (i0 * nj + j0) * c4;  // output row i0 + o, for o >= 0

  // Iteration rr folds input row rr (rr < nrows) into t row rr - PH + 1
  // and mixes output row rr - PH - 1, whose t rows earlier iterations
  // finished.  Ring positions advance by one each iteration: cur holds row
  // rr, nxt receives row rr + kStages - 1, tw is t row rr - PH + 1's slot,
  // slot its partial fold's.  Each iteration starts at a block barrier, so
  // the next run's first copies land in ring rows no thread reads any more.
  int cur = 0, nxt = kStages - 1, slot = 0;
  int tw = ((1 - PH) % 3 + 3) % 3;
  for (int rr = 0; rr <= nrows; ++rr) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2) : "memory");
    __syncthreads();
    stage_row(stage + nxt * slot_bytes, next_src, fb,
              rr + kStages - 1 < nrows ? nchunks : 0,
              next_r < h2 ? in_chunks : 0, chunk);
    ++next_r;
    next_src += row_bytes;

    if (rr >= PH + 1) {  // output row o = rr - PH - 1
      const T* t0 = tbuf + (tw == 2 ? 0 : tw + 1) * tslot;  // t row o
      const T* t1 = tbuf + (tw == 0 ? 2 : tw - 1) * tslot;  // t row o + 1
      if (vo == 4) {
        mix_row<T, 4>(t0, t1, orow, cols, c4, tpp, mix, scale);
      } else if (vo == 2) {
        mix_row<T, 2>(t0, t1, orow, cols, c4, tpp, mix, scale);
      } else {
        mix_row<T, 1>(t0, t1, orow, cols, c4, tpp, mix, scale);
      }
      orow += static_cast<int64_t>(nj) * c4;
    }

    if (rr < nrows && folds) {
      // Column sums of this thread's t columns: rs[n] is the left fold of
      // staged pixels q*NC + n .. q*NC + n + PH - 1.
      const T* srow = reinterpret_cast<const T*>(stage + cur * slot_bytes) +
                      fold_in;
      float rs[NC][4];
#pragma unroll
      for (int n = 0; n < NC; ++n) load_f<T, 4>(srow + n * c4, rs[n]);
#pragma unroll
      for (int m = 1; m < PH + NC - 1; ++m) {
        float v[4];
        load_f<T, 4>(srow + m * c4, v);
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          if (m - n >= 1 && m - n < PH) {
#pragma unroll
            for (int k = 0; k < 4; ++k) rs[n][k] = __fadd_rn(rs[n][k], v[k]);
          }
        }
      }

      // Row folds: t row i lives in acc[i % PH] from input row i on.  This
      // row opens t row rr, adds to the PH - 1 open ones, and completes t
      // row rr - PH + 1.  Unrolled over the slot so acc stays in registers.
#pragma unroll
      for (int s = 0; s < PH; ++s) {
        if (s != slot) continue;
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[s][n][k] = rs[n][k];
#pragma unroll
        for (int d = 1; d < PH; ++d)
#pragma unroll
          for (int n = 0; n < NC; ++n)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              acc[(s + d) % PH][n][k] =
                  __fadd_rn(acc[(s + d) % PH][n][k], rs[n][k]);
            }
        if (rr >= PH - 1) {
          T* trow = tbuf + tw * tslot + fold_t;
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            store_f<T, 4>(trow + n * tpp, acc[(s + 1) % PH][n]);
          }
        }
      }
    }
    cur = cur + 1 == kStages ? 0 : cur + 1;
    nxt = nxt + 1 == kStages ? 0 : nxt + 1;
    slot = slot + 1 == PH ? 0 : slot + 1;
    tw = tw == 2 ? 0 : tw + 1;
  }
  }
}

// -- shared body -------------------------------------------------------------

template <typename T>
__device__ __forceinline__ float round_as(float x) {
  return Raw<T>::f(Raw<T>::r(x));
}

template <typename T>
__global__ void __launch_bounds__(kSmemThreads)
phase_pool_kernel_smem(const T* __restrict__ f, int64_t h2, int64_t w2,
                       int c4, int ph, int ni, int nj, int tj, int ti, int kc,
                       float scale, T* __restrict__ out) {
  extern __shared__ float fsmem[];
  using R = typename Raw<T>::type;
  const R* fr = reinterpret_cast<const R*>(f);
  const int c = c4 / 4;
  const int groups = c / kc;
  const int g4 = 4 * kc;      // channels of t held by this block
  const int tcols = tj + 1;   // t columns j0 .. j0 + tj
  const int segw = tj + ph;   // input columns j0 .. j0 + tj + ph - 1
  const int k0 = (blockIdx.x % groups) * kc;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x / groups) * tj;
  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * ti;
  const int nout = ni - i0 < ti ? static_cast<int>(ni - i0) : ti;

  const int tpitch = g4 + kc;  // t row pitch: padded against bank conflicts
  float* seg = fsmem;                    // segw x g4
  float* ring = seg + segw * g4;         // ph x tcols x g4
  float* tbuf = ring + ph * tcols * g4;  // 2 x tcols x tpitch
  const int row_items = tcols * g4;

  const int g = threadIdx.x % g4;
  const int col0 = threadIdx.x / g4;
  const int col_step = kSmemThreads / g4;
  const int blk = g / kc;
  const int src_ch = blk * c + k0 + (g - blk * kc);
  const int kk = threadIdx.x % kc;
  const int jj0 = threadIdx.x / kc;
  const int jj_step = kSmemThreads / kc;

  for (int rr = 0; rr < nout + ph; ++rr) {
    // 1. Stage input row i0 + rr, columns j0 .. j0 + segw - 1, as f32.
    const int64_t r = i0 + rr;
    for (int col = col0; col < segw; col += col_step) {
      const int64_t cc = j0 + col;
      float v = 0.f;
      if (r < h2 && cc < w2) v = Raw<T>::f(fr[(r * w2 + cc) * c4 + src_ch]);
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
      trow[col * tpitch + g] = round_as<T>(s);
    }
    __syncthreads();
    if (it == 0) continue;

    // 4. Output row i0 + it - 1 from t rows it - 1 (r = 0) and it (r = 1).
    const float* tr[2] = {tbuf + ((it - 1) & 1) * tcols * tpitch, trow};
    const int64_t i = i0 + it - 1;
    for (int jj = jj0; jj < tj; jj += jj_step) {
      const int64_t j = j0 + jj;
      if (j >= nj) break;
      R* o = reinterpret_cast<R*>(out) + (i * nj + j) * c4 + k0 + kk;
#pragma unroll
      for (int ob = 0; ob < 4; ++ob) {
        const uint32_t terms = static_cast<uint32_t>(kMixTerms >> (16 * ob));
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int term = (terms >> (4 * n)) & 15;
          const int u = (term >> 2) & 1, ib = term & 3;
          const float v = tr[term >> 3][(jj + u) * tpitch + ib * kc + kk];
          acc = __fadd_rn(acc, __fmul_rn(v, scale));
        }
        o[ob * c] = Raw<T>::r(acc);
      }
    }
  }
}

__host__ __device__ __forceinline__ int smem_body_bytes(int tj, int ph,
                                                        int kc) {
  const int g4 = 4 * kc;
  return static_cast<int>(sizeof(float)) *
         (g4 * ((tj + ph) + ph * (tj + 1)) + 2 * (tj + 1) * (g4 + kc));
}

// -- launch -----------------------------------------------------------------

struct Plan {
  int body;  // 0: registers, 1: shared
  int threads, tj, ti, kc, chunk, vo, smem, gx, gy;
};

template <typename T, int PH>
cudaError_t launch_registers_ph(const void* feats, int64_t h2, int64_t w2,
                                int c4, int ni, int nj, float scale,
                                void* out, const Plan& p,
                                cudaStream_t stream) {
  constexpr int NC = PH <= 8 ? 2 : 1;
  const int pix = c4 * static_cast<int>(sizeof(T));
  const int npairs = (p.tj + NC) / NC;
  const int tcols = npairs * NC;
  if (p.threads < npairs * (c4 / 4) ||
      p.smem < reg_smem_bytes(tcols, tcols + PH - 1, pix)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      phase_pool_kernel<T, PH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      p.smem);
  if (err != cudaSuccess) return err;
  phase_pool_kernel<T, PH><<<p.gx, p.threads, p.smem, stream>>>(
      static_cast<const T*>(feats), h2, w2, c4, ni, nj, p.tj, p.chunk, p.vo,
      scale, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T, int PH = 1>
cudaError_t launch_registers(int ph, const void* feats, int64_t h2,
                             int64_t w2, int c4, int ni, int nj, float scale,
                             void* out, const Plan& p, cudaStream_t stream) {
  if constexpr (PH > kMaxRegPh) {
    return cudaErrorInvalidValue;
  } else {
    if (ph == PH) {
      return launch_registers_ph<T, PH>(feats, h2, w2, c4, ni, nj, scale, out,
                                        p, stream);
    }
    return launch_registers<T, PH + 1>(ph, feats, h2, w2, c4, ni, nj, scale,
                                       out, p, stream);
  }
}

template <typename T>
cudaError_t launch(const void* feats, int64_t h2, int64_t w2, int c4,
                   int patch, int ni, int nj, float scale, void* out,
                   const Plan& p, cudaStream_t stream) {
  const int ph = patch / 2;
  const int es = static_cast<int>(sizeof(T));
  const int c = c4 / 4;
  if (p.tj < 1 || p.smem > kMaxSmem || p.gx < 1) {
    return cudaErrorInvalidValue;
  }
  if (p.body == 0) {
    const bool chunk_ok = (p.chunk == 4 || p.chunk == 8 || p.chunk == 16) &&
                          (c4 * es) % p.chunk == 0 &&
                          reinterpret_cast<uintptr_t>(feats) % p.chunk == 0;
    const bool vo_ok = (p.vo == 1 || p.vo == 2 || p.vo == 4) &&
                       c % p.vo == 0;
    if (ph > kMaxRegPh || !chunk_ok || !vo_ok || p.threads % 32 ||
        p.threads > kMaxThreads || p.gy != 1) {
      return cudaErrorInvalidValue;
    }
    return launch_registers<T>(ph, feats, h2, w2, c4, ni, nj, scale, out, p,
                               stream);
  }
  if (p.body != 1 || p.threads != kSmemThreads || p.kc < 1 || c % p.kc ||
      p.ti < 1 || p.gy > 65535 || static_cast<int64_t>(p.gy) * p.ti < ni ||
      kSmemThreads % (4 * p.kc) || p.smem < smem_body_bytes(p.tj, ph, p.kc) ||
      static_cast<int64_t>(p.gx) != static_cast<int64_t>((nj + p.tj - 1) /
                                                         p.tj) * (c / p.kc)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      phase_pool_kernel_smem<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      p.smem);
  if (err != cudaSuccess) return err;
  phase_pool_kernel_smem<T><<<dim3(p.gx, p.gy), kSmemThreads, p.smem,
                              stream>>>(
      static_cast<const T*>(feats), h2, w2, c4, ph, ni, nj, p.tj, p.ti, p.kc,
      scale, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes.  `plan` holds, in this order: body (0 registers, 1
// shared), threads, tj, ti, kc, chunk, vo, smem, grid x, grid y, as
// ops/pool.py::launch_plan computes them.  Returns the cudaError_t of the
// launch (0 = success); a plan the kernel cannot run is refused.
extern "C" int phase_pool(const void* feats, long long h2, long long w2,
                          int c4, int patch, int ni, int nj, float scale,
                          int elem_bytes, void* out, void* stream,
                          int device, const int* plan) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (patch < 2 || patch % 2 || c4 < 4 || c4 % 4 || ni < 1 || nj < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5],
               plan[6], plan[7], plan[8], plan[9]};
  auto s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 4:
      err = launch<float>(feats, h2, w2, c4, patch, ni, nj, scale, out, p, s);
      break;
    case 2:
      err = launch<__nv_bfloat16>(feats, h2, w2, c4, patch, ni, nj, scale,
                                  out, p, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
