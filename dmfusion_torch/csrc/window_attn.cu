// B6: one Swin block's shifted-window attention core in one pass, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: dmfusion's flax WindowAttention
// (dmfusion/models/swin.py) was left to XLA.  Under PyTorch the core ran as
// a chain of torch kernels: the cyclic shift (torch.roll) and the window
// partition of the block's grid, the qkv permute, a bf16 q k^T, the
// scale's division, the relative bias gathered and added, the mask added,
// a cast to f32, softmax, a cast back, the product with v, a transpose,
// the window reverse and the shift back: each a pass over device memory,
// the (windows, heads, n, n) scores, larger than q, written and read about
// eight times.
//
// For one block of a Swin encoder it is given the fused projection's
// output on the token grid, qkv (B, H, W, 3C) with q, k and v in that
// order and head h at channels h hd .. h hd + hd - 1 of each, the f32
// relative-bias table ((2 ws - 1)^2, heads), an optional f32 mask
// (nW, n, n) of the windows of one image, the window ws (n = ws^2 tokens),
// the shift and the heads; it writes the core's output (B, H, W, C) at the
// tokens' own grid positions.  Window (b, wr, wc) of the shifted frame
// holds token (tr, tc) at grid row (wr ws + tr + shift) mod H and column
// (wc ws + tc + shift) mod W: the kernel reads that token's head slices of
// q, k and v there and writes its output slice to the same place, which is
// what roll(-shift), partition, the core, reverse and roll(+shift) compute.
// The mask is that of window wr (W / ws) + wc, the window's place in the
// shifted frame.  In every (window, head):
//   s = (q k^T) / div + bias[rel(i, j)] (+ mask[i][j])   (f32)
//   p = softmax(s) (f32), rounded to the compute dtype
//   out = p v, f32 sums, rounded to the compute dtype
// with div = sqrt(hd) rounded to the compute dtype, as flax computes it
// (the caller passes it), and rel(i, j) the relative index of query token
// i and key token j, computed here from their coordinates.  The scores,
// the bias and the mask stay in f32 up to the softmax, where the torch
// chain rounded them to bf16.
//
// What bounds it on this card: bytes.  q, k and v are read once and the
// output written once: at Swin-T's widths 22.9 MB an anchor over both
// encoders, 7.0 ms at 3.35 TB/s for a request of 1,024 anchors, against
// about 24 FLOP a byte, far under the card's bf16 ridge of 295.  So the
// design spends its effort on reading each byte once, in 16-byte units,
// with loads in flight while the last head's math runs, and keeps scores
// and probabilities in registers.
//
// wattn_mma<HD> (bf16): one 128-thread block a window; it walks the
// window's heads.  Each head's q, k and v slices (n tokens x hd) are
// copied by 16-byte cp.async into a shared-memory tile of 16 ceil(n / 16)
// rows, its row stride padded by 16 bytes so ldmatrix's eight row
// addresses fall in distinct banks; rows past n and columns past hd are
// zero.  The tiles are double-buffered: the next head's copies are in
// flight while this head's math runs, and several blocks an SM overlap
// each other's.  Each warp takes 16 query rows: S = Q K^T by ldmatrix and
// mma.sync m16n8k16 (bf16 in, f32 sums) in registers; the scale, the bias
// (the head's table column in shared memory) and the mask (the window's
// slab in shared memory, staged once for all heads) in f32; keys past n
// get -inf; row max and sum by quad shuffles; p rounded to bf16 is reused
// in registers as the A fragment of P V (FlashAttention-2's layout), no
// round trip through shared memory.  The warp's output rows go back to
// its own rows of the q tile and leave in 16-byte stores.
//
// wattn_simt (f32): the same core in full f32 on the CUDA cores, one block
// a window, the head's q, k, v, scores and probabilities in shared
// memory; for float32 compute, off the bf16 serving path.
//
// The launch plan (body, head dim, tokens, row tiles, threads, grid,
// dynamic shared bytes) is computed on the host by
// ops/attention.py::launch_plan and checked here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kMaxTokens = 64;
constexpr int kMaxHeadDim = 64;
constexpr int kMaxSmem = 232448;  // 227 KB, a block's most

enum Body { kMma = 0, kSimt = 1 };

struct Plan {
  int body, hd, n, tiles, threads, grid, smem;
};

// One launch's shape.
struct Geom {
  int H, W, C, heads, ws, shift, n;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b for one 16 x 8 tile: bf16 operands, f32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's window: each token's grid pixel (b H + row) W + col, and its
// relative-bias coordinate tr (2 ws - 1) + tc; returns the window's index
// in its image (the mask's).
__device__ __forceinline__ int stage_tokens(const Geom& g, int* pix,
                                            int* crd) {
  const int nwc = g.W / g.ws;
  const int per_image = (g.H / g.ws) * nwc;
  const int wimg = static_cast<int>(blockIdx.x) % per_image;
  const int b = static_cast<int>(blockIdx.x) / per_image;
  const int wr = wimg / nwc, wc = wimg % nwc;
  for (int t = threadIdx.x; t < g.n; t += blockDim.x) {
    const int tr = t / g.ws, tc = t % g.ws;
    int r = wr * g.ws + tr + g.shift;
    int c = wc * g.ws + tc + g.shift;
    if (r >= g.H) r -= g.H;
    if (c >= g.W) c -= g.W;
    pix[t] = (b * g.H + r) * g.W + c;
    crd[t] = tr * (2 * g.ws - 1) + tc;
  }
  return wimg;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 4)
wattn_mma(const __nv_bfloat16* __restrict__ qkv,
          const float* __restrict__ table, const float* __restrict__ mask,
          __nv_bfloat16* __restrict__ out, Geom g, int tiles,
          float inv_div) {
  constexpr int HDK = (HD + 15) / 16 * 16;  // the MMA's k, zero-padded
  constexpr int LD = HDK + 8;               // tile row stride (elements)
  constexpr int CH = HD / 8;                // 16-byte chunks a head slice
  constexpr int NO = (CH + 1) / 2 * 2;      // output tiles, in pairs
  const int NP = 16 * tiles;
  const int R = (2 * g.ws - 1) * (2 * g.ws - 1);
  const int n = g.n;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][3][NP][LD]
  float* bias = reinterpret_cast<float*>(tile + 6 * NP * LD);    // [2][R]
  float* msk = bias + 2 * R;                                     // [n][n]
  int* pix = reinterpret_cast<int*>(msk + (mask ? n * n : 0));   // [n]
  int* crd = pix + kMaxTokens;                                   // [n]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // Rows past n and columns past hd are never copied: zero, they add
  // nothing to Q K^T, and a zero v row times p = 0 gives 0.
  for (int i = tid; i < 12 * NP * LD / 16; i += kThreads) {
    reinterpret_cast<uint4*>(tile)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  const int wimg = stage_tokens(g, pix, crd);
  __syncthreads();

  const long long row3 = 3ll * g.C;
  auto load_head = [&](int h, int st) {
    __nv_bfloat16* dst = tile + st * 3 * NP * LD;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const __nv_bfloat16* src = qkv + s * g.C + h * HD;
      __nv_bfloat16* d = dst + s * NP * LD;
      for (int i = tid; i < n * CH; i += kThreads) {
        const int t = i / CH, c = i % CH;
        cp_async16(d + t * LD + c * 8, src + pix[t] * row3 + c * 8);
      }
    }
    float* bd = bias + st * R;
    for (int i = tid; i < R; i += kThreads) {
      cp_async4(bd + i, table + i * g.heads + h);
    }
  };
  if (mask) {
    const float* m = mask + static_cast<long long>(wimg) * n * n;
    for (int i = tid; i < n * n; i += kThreads) cp_async4(msk + i, m + i);
  }
  load_head(0, 0);
  cp_async_commit();

  // This lane's rows of the warp's 16 (the accumulators' g and g + 8) and
  // the base of their relative indices.
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16 + gq, r1 = r0 + 8;
  const bool in0 = r0 < n, in1 = r1 < n;
  const int off = (g.ws - 1) * 2 * g.ws;

  for (int h = 0; h < g.heads; ++h) {
    const int st = h & 1;
    if (h + 1 < g.heads) {
      load_head(h + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (warp < tiles) {
      __nv_bfloat16* Q = tile + st * 3 * NP * LD;
      const __nv_bfloat16* K = Q + NP * LD;
      const __nv_bfloat16* V = K + NP * LD;
      const float* bh = bias + st * R;

      // S = Q K^T: eight 16 x 8 tiles of keys, as many as the rows hold.
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HDK / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, Q + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                       (lane >> 4) * 8);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (jp < tiles) {
            uint32_t b[4];
            ldsm_x4(b, K + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                           kk * 16 + ((lane >> 3) & 1) * 8);
            mma(s[2 * jp], a, b[0], b[1]);
            mma(s[2 * jp + 1], a, b[2], b[3]);
          }
        }
      }

      // Scale, bias and mask in f32; -inf past the last key; softmax.
      const int c0 = in0 ? crd[r0] + off : 0;
      const int c1 = in1 ? crd[r1] + off : 0;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < 2 * tiles) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = j * 8 + 2 * tq + e;
            float v0 = s[j][e], v1 = s[j][2 + e];
            if (col < n) {
              const int cj = crd[col];
              if (in0) {
                v0 = v0 * inv_div + bh[c0 - cj];
                if (mask) v0 += msk[r0 * n + col];
              }
              if (in1) {
                v1 = v1 * inv_div + bh[c1 - cj];
                if (mask) v1 += msk[r1 * n + col];
              }
            } else {
              v0 = v1 = -INFINITY;
            }
            s[j][e] = v0;
            s[j][2 + e] = v1;
            mx0 = fmaxf(mx0, v0);
            mx1 = fmaxf(mx1, v1);
          }
        }
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < 2 * tiles) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[j][e] = expf(s[j][e] - mx0);
            s[j][2 + e] = expf(s[j][2 + e] - mx1);
            sum0 += s[j][e];
            sum1 += s[j][2 + e];
          }
        }
      }
      const float inv0 = 1.f / quad_sum(sum0);
      const float inv1 = 1.f / quad_sum(sum1);

      // O = P V: P's accumulator tiles are the A fragments, two key tiles
      // a 16-key step.
      float o[NO][4];
#pragma unroll
      for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < tiles) {
          uint32_t a[4];
          a[0] = pack_bf16(s[2 * kk][0] * inv0, s[2 * kk][1] * inv0);
          a[1] = pack_bf16(s[2 * kk][2] * inv1, s[2 * kk][3] * inv1);
          a[2] = pack_bf16(s[2 * kk + 1][0] * inv0, s[2 * kk + 1][1] * inv0);
          a[3] = pack_bf16(s[2 * kk + 1][2] * inv1, s[2 * kk + 1][3] * inv1);
#pragma unroll
          for (int np = 0; np < NO / 2; ++np) {
            uint32_t b[4];
            ldsm_x4_t(b, V + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 LD +
                             np * 16 + (lane >> 4) * 8);
            mma(o[2 * np], a, b[0], b[1]);
            if (2 * np + 1 < CH) mma(o[2 * np + 1], a, b[2], b[3]);
          }
        }
      }

      // The warp's output rows into its own rows of the q tile, then out
      // in 16-byte stores at the tokens' grid positions.
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int col = j * 8 + 2 * tq;
        if (in0) {
          *reinterpret_cast<uint32_t*>(Q + r0 * LD + col) =
              pack_bf16(o[j][0], o[j][1]);
        }
        if (in1) {
          *reinterpret_cast<uint32_t*>(Q + r1 * LD + col) =
              pack_bf16(o[j][2], o[j][3]);
        }
      }
      __syncwarp();
      for (int i = lane; i < 16 * CH; i += 32) {
        const int r = warp * 16 + i / CH, c = i % CH;
        if (r < n) {
          *reinterpret_cast<uint4*>(out + pix[r] * static_cast<long long>(g.C) +
                                    h * HD + c * 8) =
              *reinterpret_cast<const uint4*>(Q + r * LD + c * 8);
        }
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
wattn_simt(const float* __restrict__ qkv, const float* __restrict__ table,
           const float* __restrict__ mask, float* __restrict__ out, Geom g,
           int hd, float div) {
  const int n = g.n, ld = hd + 1, pld = n + 1;
  const int R = (2 * g.ws - 1) * (2 * g.ws - 1);
  extern __shared__ __align__(16) unsigned char smem[];
  float* q = reinterpret_cast<float*>(smem);  // [n][ld]
  float* k = q + n * ld;                      // [n][ld]
  float* v = k + n * ld;                      // [n][ld]
  float* p = v + n * ld;                      // [n][pld]
  float* bias = p + n * pld;                  // [R]
  float* msk = bias + R;                      // [n][n]
  int* pix = reinterpret_cast<int*>(msk + (mask ? n * n : 0));
  int* crd = pix + kMaxTokens;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wimg = stage_tokens(g, pix, crd);
  if (mask) {
    const float* m = mask + static_cast<long long>(wimg) * n * n;
    for (int i = tid; i < n * n; i += kThreads) msk[i] = m[i];
  }
  __syncthreads();
  const int off = (g.ws - 1) * 2 * g.ws;
  const long long row3 = 3ll * g.C;
  for (int h = 0; h < g.heads; ++h) {
    for (int i = tid; i < n * hd; i += kThreads) {
      const int t = i / hd, d = i % hd;
      const float* src = qkv + pix[t] * row3 + h * hd + d;
      q[t * ld + d] = src[0];
      k[t * ld + d] = src[g.C];
      v[t * ld + d] = src[2 * g.C];
    }
    for (int i = tid; i < R; i += kThreads) bias[i] = table[i * g.heads + h];
    __syncthreads();
    for (int i = tid; i < n * n; i += kThreads) {
      const int r = i / n, c = i % n;
      float acc = 0.f;
      for (int d = 0; d < hd; ++d) acc = fmaf(q[r * ld + d], k[c * ld + d], acc);
      float x = acc / div + bias[crd[r] - crd[c] + off];
      if (mask) x += msk[i];
      p[r * pld + c] = x;
    }
    __syncthreads();
    for (int r = warp; r < n; r += kThreads / 32) {
      float* row = p + r * pld;
      const float x0 = lane < n ? row[lane] : -INFINITY;
      const float x1 = lane + 32 < n ? row[lane + 32] : -INFINITY;
      const float m = warp_max(fmaxf(x0, x1));
      const float e0 = lane < n ? expf(x0 - m) : 0.f;
      const float e1 = lane + 32 < n ? expf(x1 - m) : 0.f;
      const float sum = warp_sum(e0 + e1);
      if (lane < n) row[lane] = e0 / sum;
      if (lane + 32 < n) row[lane + 32] = e1 / sum;
    }
    __syncthreads();
    for (int i = tid; i < n * hd; i += kThreads) {
      const int r = i / hd, d = i % hd;
      float acc = 0.f;
      for (int c = 0; c < n; ++c) acc = fmaf(p[r * pld + c], v[c * ld + d], acc);
      out[pix[r] * static_cast<long long>(g.C) + h * hd + d] = acc;
    }
    __syncthreads();
  }
}

// Dynamic shared bytes a plan's body needs; ops/attention.py::launch_plan
// computes the same.
long long smem_bytes(int body, int hd, int n, int tiles, int ws,
                     bool masked) {
  const long long R = (2ll * ws - 1) * (2ll * ws - 1);
  const long long tokens = 2ll * kMaxTokens * 4;  // pix and crd
  const long long m = masked ? 4ll * n * n : 0;
  if (body == kMma) {
    const long long ld = (hd + 15) / 16 * 16 + 8;
    return 12ll * 16 * tiles * ld + 8 * R + m + tokens;
  }
  return 4ll * (3ll * n * (hd + 1) + n * (n + 1) + R) + m + tokens;
}

bool plan_ok(const Plan& p, long long grid, int hd, int n, int ws,
             int elem_bytes, bool masked) {
  if (p.threads != kThreads || p.grid != grid || p.hd != hd || p.n != n ||
      p.tiles != (n + 15) / 16) {
    return false;
  }
  if (p.body != (elem_bytes == 2 ? kMma : kSimt)) return false;
  const long long smem = smem_bytes(p.body, hd, n, p.tiles, ws, masked);
  return p.smem == smem && p.smem <= kMaxSmem;
}

template <int HD>
cudaError_t launch_mma(const void* qkv, const float* table, const float* mask,
                       void* out, const Geom& g, const Plan& p, float div,
                       cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      wattn_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  wattn_mma<HD><<<p.grid, kThreads, p.smem, s>>>(
      static_cast<const __nv_bfloat16*>(qkv), table, mask,
      static_cast<__nv_bfloat16*>(out), g, p.tiles, 1.f / div);
  return cudaGetLastError();
}

}  // namespace

// The attention core of one Swin block on its (b, h, w) grid of c
// channels in heads heads, window ws (ws * ws <= 64 tokens), shift
// 0 <= shift < ws: qkv (b, h, w, 3c) and out (b, h, w, c), both contiguous
// and 16-byte aligned, elem_bytes 2 (bf16) or 4 (f32); table ((2 ws - 1)^2,
// heads) f32; mask (h/ws * w/ws, ws^2, ws^2) f32 or null; div the scores'
// divisor, sqrt(c / heads) in the compute dtype.  plan: body (0 mma for
// bf16, 1 simt for f32), head dim, tokens, 16-row tiles, threads, grid,
// dynamic shared bytes, from ops/attention.py::launch_plan.  Launches on
// ``stream`` and returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments or a plan it does not take.
extern "C" int window_attn(const void* qkv, const float* table,
                           const float* mask, void* out, int b, int h, int w,
                           int c, int heads, int ws, int shift, float div,
                           int elem_bytes, const int* plan, void* stream,
                           int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5], plan[6]};
  if (b < 1 || h < 1 || w < 1 || c < 1 || heads < 1 || ws < 1 || c % heads ||
      h % ws || w % ws || shift < 0 || shift >= ws || ws * ws > kMaxTokens ||
      (elem_bytes != 2 && elem_bytes != 4) ||
      static_cast<long long>(b) * h * w >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hd = c / heads;
  if (hd % 8 || hd > kMaxHeadDim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long grid = static_cast<long long>(b) * (h / ws) * (w / ws);
  if (!plan_ok(p, grid, hd, ws * ws, ws, elem_bytes, mask != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geom g{h, w, c, heads, ws, shift, ws * ws};
  auto s = static_cast<cudaStream_t>(stream);
  if (p.body == kSimt) {
    err = cudaFuncSetAttribute(
        wattn_simt, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    wattn_simt<<<p.grid, kThreads, p.smem, s>>>(
        static_cast<const float*>(qkv), table, mask, static_cast<float*>(out),
        g, hd, div);
    return static_cast<int>(cudaGetLastError());
  }
  switch (hd) {
    case 8: err = launch_mma<8>(qkv, table, mask, out, g, p, div, s); break;
    case 16: err = launch_mma<16>(qkv, table, mask, out, g, p, div, s); break;
    case 24: err = launch_mma<24>(qkv, table, mask, out, g, p, div, s); break;
    case 32: err = launch_mma<32>(qkv, table, mask, out, g, p, div, s); break;
    case 40: err = launch_mma<40>(qkv, table, mask, out, g, p, div, s); break;
    case 48: err = launch_mma<48>(qkv, table, mask, out, g, p, div, s); break;
    case 56: err = launch_mma<56>(qkv, table, mask, out, g, p, div, s); break;
    default: err = launch_mma<64>(qkv, table, mask, out, g, p, div, s); break;
  }
  return static_cast<int>(err);
}
