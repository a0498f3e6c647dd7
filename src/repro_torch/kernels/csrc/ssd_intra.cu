// Mamba2 SSD intra-chunk term, for Hopper (sm_90a), with a plain C interface
// that kernels/ssd_intra.py loads through ctypes.
//
// It replaces the TPU kernel ssd_intra (src/repro/kernels/ssd_intra.py,
// pallas_call :52, _ssd_intra_kernel :31): for x [B, Nc, Lc, H, P], dt and
// a_cs [B, Nc, Lc, H], Bm and Cm [B, Nc, Lc, N], in float32 or bfloat16,
//
//   y[b, c, i, h, :] = sum_{j <= i} (C_i . B_j) exp(a_cs_i - a_cs_j) dt_j x_j
//
// summed in float32 and rounded to x's type. kernels/ref.py:ssd_intra is the
// same computation in torch.
//
// Bound: bytes. Every operand read once and y written once is 110.6 MB at
// mamba2-130m's prefill [4, 16, 128, 24, 64] with N = 128, 0.033 ms at
// 3.35 TB/s; the operations over the causal pairs (2 N for C B^T once per
// chunk, 2 P for W @ x per head) are 1.76 GFLOP, microseconds on the tensor
// cores even three times over.
//
// Design: both products run on the tensor cores, mma.sync m16n8k8 in TF32
// with float32 accumulators, as 3xTF32: a float32 operand v splits into
// hi = tf32(v) (to nearest: an mma fed raw float32 bits would truncate
// them) and lo = v - hi, which the mma reads to its 10 top mantissa bits, and
// a b = a_lo b_hi + a_hi b_lo + a_hi b_hi keeps the sums within float32
// rounding of the plain version (one TF32 product is ~5e-4 of the output's
// scale, beyond the checks' 1e-4). bfloat16 operands are exact in TF32
// (lo = 0): C B^T takes one mma, W @ x two. The three terms of a product go
// to the accumulators in turn, so consecutive mmas are independent.
//
// One block per (head group, chunk, batch): two sets of 8 warps (one set at
// float32 P > 64, where four x buffers do not fit), 128 registers a thread;
// rows are padded to 16-row tiles (Lc <= 128: 8 tiles).
//
//  1. C B^T once per block, only the 16 x 8 tiles that hold a causal entry:
//     C and B come into shared memory whole (or as many state columns at a
//     time as fit) by cp.async; warp w forms the tiles of row tile
//     row_tile(w % 8) whose key tile has the parity w / 8 (skipping groups
//     of four tiles with no causal entry), and writes them over C and B,
//     each lane's four values together.
//  2. Each set works through every other head of the block with two x
//     buffers: the next head's x comes by cp.async while this one computes,
//     issued by the set's four warps with the least work (a warp waits for
//     its own copies to be taken). Warp w owns row tile r = row_tile(w) and
//     its 2 r + 2 key tiles of 8 (tiles r and 7 - r share a scheduler). It
//     forms W = cb exp(a_cs_i - a_cs_j) dt_j from the C B^T tile fragment
//     by fragment, the next tile's while this tile's products run; the
//     difference is taken first and masked to -inf (exp 0) off the causal
//     entries: a_cs falls below -900 over a chunk, and an acausal difference
//     is positive and overflows. The accumulator holds keys (2t, 2t + 1) of
//     each 8 where the A operand wants (t, t + 4), so the key index is
//     permuted: A's k = t and t + 4 are keys 2t and 2t + 1, and the B operand
//     reads x's rows 2t and 2t + 1 to match (a sum does not care about its
//     order). Key tiles above the diagonal are skipped. Each warp writes its
//     y rows from the accumulators; P is covered in passes of 8 NT columns.
//
// The launch takes as many head groups as keep the grid within one wave of
// blocks (mamba2-130m at batch 4, 2048 tokens: 64 chunks, 2 groups of 12
// heads, 128 blocks on 132 SMs). Ragged Lc, P and N are padded with zeros
// in shared memory (cp.async's zero fill). Shared rows are padded to 16 mod
// 64 bytes, so the fragment loads hit 32 different banks. The 16-byte
// copies need x, Bm, Cm and y 16-byte aligned and P and N whole 16-byte
// rows; elsewhere plain loads and stores fill the same layout. Offsets are
// 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using repro::cp_async;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::mma_if;
using repro::sm_count;
using repro::split;

constexpr int kSetThreads = 256;  // a set: 8 warps, one head at a time
constexpr int kMaxLc = 128;       // 8 row tiles of 16
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory a block may use

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Elements of a shared row holding `cols` values: 16 mod 64 bytes, at least
// the data, so that a fragment load's 32 lanes fall in 32 banks.
__host__ __device__ constexpr int row_stride(int cols, int size) {
  return ((cols * size + 47) / 64 * 64 + 16) / size;
}

// Rows [0, rows_pad) x columns [0, cols_pad) of a row-major T matrix (row
// stride ld) into shared memory (row stride sld); entries past (rows, cols)
// are zero. kVec: 16-byte cp.async (cols and src 16-byte granular), left in
// flight; else plain loads and stores.
// Thread `id` of `count` takes every count-th piece.
template <typename T, bool kVec>
__device__ __forceinline__ void load_tile(T* dst, int sld, const T* src,
                                          long long ld, int rows, int cols,
                                          int rows_pad, int cols_pad, int id,
                                          int count) {
  if (kVec) {
    constexpr int E = 16 / sizeof(T);
    const int cpr = cols_pad / E;
    for (int c = id; c < rows_pad * cpr; c += count) {
      const int r = c / cpr, col = (c - r * cpr) * E;
      const bool in = r < rows && col < cols;
      cp_async<16>(dst + r * sld + col, in ? src + r * ld + col : src, in);
    }
  } else {
    for (int c = id; c < rows_pad * cols_pad; c += count) {
      const int r = c / cols_pad, col = c - r * cols_pad;
      dst[r * sld + col] =
          (r < rows && col < cols) ? src[r * ld + col] : zero<T>();
    }
  }
}

// The W fragment of key tile j..j+7 (as the A operand, keys permuted) from
// the C B^T accumulator tile c at rows i0 and i0 + 8: w = cb exp(a_i - a_j)
// dt_j for a causal entry of a real row, else 0.
__device__ __forceinline__ void w_fragment(float4 c, int i0, int j,
                                           int lc, float ai0, float ai1,
                                           float2 aj, float2 dj,
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  // The mask selects the exponent (exp(-inf) = 0): no branch.
  const int i1 = i0 + 8;
  const float inf = __int_as_float(0x7f800000);
  const bool r0 = i0 < lc, r1 = i1 < lc;
  const float w0 = c.x * __expf(j <= i0 && r0 ? ai0 - aj.x : -inf) * dj.x;
  const float w1 = c.y * __expf(j + 1 <= i0 && r0 ? ai0 - aj.y : -inf) * dj.y;
  const float w2 = c.z * __expf(j <= i1 && r1 ? ai1 - aj.x : -inf) * dj.x;
  const float w3 = c.w * __expf(j + 1 <= i1 && r1 ? ai1 - aj.y : -inf) * dj.y;
  // A: a0 (row g, k t) = key 2t, a1 (row g + 8, k t), a2 (row g, k t + 4)
  // = key 2t + 1, a3 (row g + 8, k t + 4)
  split<false>(w0, hi[0], lo[0]);
  split<false>(w2, hi[1], lo[1]);
  split<false>(w1, hi[2], lo[2]);
  split<false>(w3, hi[3], lo[3]);
}

// y tile (16 rows from i0, 8 NT columns from p0) from its accumulators.
template <typename T, int NT, bool kVec>
__device__ __forceinline__ void store_tile(T* y, const float (&acc)[NT][4],
                                           long long row0, int i0, int p0,
                                           int h, int H, int P, int lc) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + 8 * half;
    if (i >= lc) continue;
    T* yr = y + ((row0 + i) * H + h) * P;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int p = p0 + 8 * nt + 2 * t;
      const float v0 = acc[nt][2 * half], v1 = acc[nt][2 * half + 1];
      if (kVec) {
        if (p < P) put2(yr + p, v0, v1);  // P even: p + 1 < P too
      } else {
        if (p < P) put(yr + p, v0);
        if (p + 1 < P) put(yr + p + 1, v1);
      }
    }
  }
}

// Floats of C B^T's causal tiles at lcp rows, and one tile more for a read
// past the last.
__host__ __device__ constexpr int cb_floats(int lcp) {
  return (lcp / 16 * (lcp / 16 + 1) + 1) * 128;
}

// Shared memory of a block of `sets` sets, in bytes: a region R that first
// holds C and B (nks state columns at a time), then C B^T's tiles and the
// sets' second x buffers; the sets' first x buffers (loading while C B^T
// forms); a_cs and dt of two heads a set, with 16 floats of room for a
// read past the last.
struct Layout {
  int lcp, sx, sk;   // rows; row strides of x and of a C or B stage
  size_t xbuf, cb, r, total;
  __host__ __device__ Layout(int lc, int pw, int nks, int sets, int size) {
    lcp = (lc + 15) & ~15;
    sx = row_stride(pw, size);
    sk = row_stride(nks, size);
    xbuf = static_cast<size_t>(lcp) * sx * size;
    cb = sizeof(float) * cb_floats(lcp);
    const size_t stages = 2 * static_cast<size_t>(lcp) * sk * size;
    r = stages > cb + sets * xbuf ? stages : cb + sets * xbuf;
    total = r + sets * xbuf + sizeof(float) * (sets * 4 * lcp + 16);
  }
};

// The row tile of warp w of 8: tiles w and 7 - w share a scheduler (w % 4).
__device__ __forceinline__ int row_tile(int w) { return w < 4 ? w : 11 - w; }

template <typename T, int NT, bool kVec, int kSets>
__global__ void __launch_bounds__(kSets * kSetThreads, 1)
    ssd_intra_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                     const T* __restrict__ acs, const T* __restrict__ bm,
                     const T* __restrict__ cm, T* __restrict__ y, int nc,
                     int lc, int H, int P, int N, int nks,
                     int heads_per_block) {
  constexpr bool kExact = sizeof(T) == 2;  // bfloat16 is exact in TF32
  constexpr int PW = 8 * NT;               // columns of y per pass
  constexpr int kNG = NT < 2 ? NT : 2;     // column tiles per group
  constexpr int kM = 16 / kSets;  // C B^T tiles of a warp: kt = kSets m + s
  extern __shared__ float4 smem4[];
  const int pw = (P + PW - 1) / PW * PW;
  const Layout lay(lc, pw, nks, kSets, sizeof(T));
  const int lcp = lay.lcp, sx = lay.sx, sk = lay.sk;
  char* base = reinterpret_cast<char*>(smem4);
  T* sC = reinterpret_cast<T*>(base);  // [lcp][sk] C, nks columns
  T* sB = sC + lcp * sk;               // [lcp][sk] B
  // C B^T's causal tiles once formed, tile (rt, kt) at rt (rt + 1) + kt,
  // each lane's four values together
  float4* sCB = smem4;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int set = warp >> 3, stid = tid & (kSetThreads - 1);
  const long long row0 =
      (static_cast<long long>(blockIdx.z) * nc + blockIdx.y) * lc;
  const int h_lo = blockIdx.x * heads_per_block;
  const int nhb = min(H, h_lo + heads_per_block) - h_lo;
  const int tiles = lcp / 16;

  // The set's x of two heads (buffer 0 after R, buffer 1 in R after C B^T)
  // and a_cs and dt of two heads; thread stid < lcp carries row stid's
  // a_cs and dt of the next head.
  // (offsets from the shared array itself keep every x access an LDS)
  const auto xs = [&](int buf) {
    return reinterpret_cast<T*>(base + (buf ? lay.cb : lay.r) +
                                set * lay.xbuf);
  };
  float* ads = reinterpret_cast<float*>(base + lay.r + kSets * lay.xbuf) +
               set * 4 * lcp;  // [2][a_cs[lcp], dt[lcp]]
  const long long ldx = static_cast<long long>(H) * P;
  // The set's first four warps (row tiles 0 - 3, the least work) issue the
  // copies of x: a warp waits for its own copies to be taken, so the
  // warps that carry the most products issue none.
  const bool loader = stid < kSetThreads / 2;
  auto load_x = [&](int h, int buf) {
    if (loader) {
      load_tile<T, kVec>(xs(buf), sx, x + (row0 * H + h) * P, ldx, lc, P,
                         lcp, pw, stid, kSetThreads / 2);
    }
  };
  float ar = 0.f, dr = 0.f;
  auto load_ad = [&](int h) {
    ar = dr = 0.f;
    if (stid < lc) {
      ar = widen(acs[(row0 + stid) * H + h]);
      dr = widen(dt[(row0 + stid) * H + h]);
    }
  };
  auto put_ad = [&](int buf) {
    if (stid < lcp) {
      ads[buf * 2 * lcp + stid] = ar;
      ads[buf * 2 * lcp + lcp + stid] = dr;
    }
  };
  // C and B, state columns n0 .. n0 + nks, whole rows where nks covers N
  auto load_cb = [&](int n0) {
    load_tile<T, kVec>(sC, sk, cm + row0 * N + n0, N, lc, N - n0, lcp, nks,
                       tid, blockDim.x);
    load_tile<T, kVec>(sB, sk, bm + row0 * N + n0, N, lc, N - n0, lcp, nks,
                       tid, blockDim.x);
  };

  // The set's first head loads while C B^T forms.
  if (set < nhb) {
    load_x(h_lo + set, 0);
    load_ad(h_lo + set);
  }
  load_cb(0);
  cp_async_commit();

  // 1. C B^T: warp w forms the causal tiles of row tile row_tile(w % 8)
  //    whose key tile is kSets m + w / 8 (m < kM).
  {
    const int r = row_tile(warp & 7), par = warp >> 3;
    const int nk = r < tiles ? 2 * r + 2 : 0;
    float cb[kM][4];
#pragma unroll
    for (int m = 0; m < kM; ++m) {
#pragma unroll
      for (int e = 0; e < 4; ++e) cb[m][e] = 0.f;
    }
    const int rowC0 = min(16 * r + g, lcp - 1) * sk;
    const int rowC1 = min(16 * r + g + 8, lcp - 1) * sk;
    for (int n0 = 0; n0 < N; n0 += nks) {
      if (n0 > 0) {
        __syncthreads();  // the last columns are consumed
        load_cb(n0);
        cp_async_commit();
      }
      cp_async_wait<0>();
      __syncthreads();
      const int k_end = nk > 0 ? min(nks, N - n0) : 0;
      for (int k0 = 0; k0 < k_end; k0 += 8) {
        uint32_t ah[4], al[4];
        const T* pa = sC + k0 + t;
        split<kExact>(widen(pa[rowC0]), ah[0], al[0]);
        split<kExact>(widen(pa[rowC1]), ah[1], al[1]);
        split<kExact>(widen(pa[rowC0 + 4]), ah[2], al[2]);
        split<kExact>(widen(pa[rowC1 + 4]), ah[3], al[3]);
        // Each product predicated on its tile holding a causal entry (rows
        // past the chunk read its last row), four tiles at a time, the
        // three terms in turn: consecutive products go to different
        // accumulators.
#pragma unroll
        for (int m4 = 0; m4 < kM; m4 += 4) {
          if (kSets * m4 + par >= nk) break;  // no causal tile from here
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int kt = kSets * (m4 + u) + par;
            const T* pb = sB + min(8 * kt + g, lcp - 1) * sk + k0 + t;
            split<kExact>(widen(pb[0]), bh[u][0], bl[u][0]);
            split<kExact>(widen(pb[4]), bh[u][1], bl[u][1]);
          }
#pragma unroll
          for (int term = kExact ? 2 : 0; term < 3; ++term) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              // term 0: c_lo b_hi, 1: c_hi b_lo, 2: c_hi b_hi
              mma_if(kSets * (m4 + u) + par < nk, cb[m4 + u],
                     term == 0 ? al : ah, term == 1 ? bl[u][0] : bh[u][0],
                     term == 1 ? bl[u][1] : bh[u][1]);
            }
          }
        }
      }
    }
    __syncthreads();  // C and B are consumed: their room takes the tiles
    float4* out = sCB + r * (r + 1) * 32 + lane;
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const int kt = kSets * m + par;
      if (kt < nk) {
        out[32 * kt] = make_float4(cb[m][0], cb[m][1], cb[m][2], cb[m][3]);
      }
    }
  }
  put_ad(0);
  __syncthreads();

  // 2. Set s takes the block's heads s, s + kSets, ...; warp w of the set
  //    owns row tile r = row_tile(w) and its nk key tiles of 8.
  const int r = row_tile(warp & 7), nk = r < tiles ? 2 * r + 2 : 0;
  const int rs = min(r, tiles - 1);  // rows read, in the chunk
  const int i0 = 16 * rs + g;
  const float4* tile = sCB + rs * (rs + 1) * 32 + lane;  // kt at [32 kt]
  int buf = 0;
  for (int h = h_lo + set; h < h_lo + nhb; h += kSets, buf ^= 1) {
    const bool next = h + kSets < h_lo + nhb;
    if (next) {
      load_x(h + kSets, buf ^ 1);
      cp_async_commit();
      load_ad(h + kSets);
    }
    const T* xb = xs(buf);
    const float* as = ads + buf * 2 * lcp;
    const float* ds = as + lcp;
    const float ai0 = as[i0], ai1 = as[i0 + 8];
    // W of key tile kt, from its C B^T tile; a tile past the warp's last
    // reads values that no product uses (the shared arrays are padded).
    auto form = [&](int kt, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
      const int jj = 8 * kt + 2 * t;
      w_fragment(tile[32 * kt], i0, jj, lc, ai0, ai1,
                 *reinterpret_cast<const float2*>(as + jj),
                 *reinterpret_cast<const float2*>(ds + jj), hi, lo);
    };
    for (int p0 = 0; p0 < pw; p0 += PW) {
      float acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      }
      uint32_t wh[4], wl[4];
      if (nk > 0) form(0, wh, wl);
      for (int kt = 0; kt < nk; ++kt) {
        // the next tile's W forms while this tile's products run
        uint32_t nh[4], nl[4];
        form(kt + 1, nh, nl);
        // kNG column tiles at a time, the three terms in turn (x exact:
        // two), so that consecutive products go to different accumulators
        const T* xp = xb + (8 * kt + 2 * t) * sx + p0 + g;
#pragma unroll
        for (int n0 = 0; n0 < NT; n0 += kNG) {
          uint32_t xh[kNG][2], xl[kNG][2];
#pragma unroll
          for (int u = 0; u < kNG; ++u) {
            split<kExact>(widen(xp[8 * (n0 + u)]), xh[u][0], xl[u][0]);
            split<kExact>(widen(xp[8 * (n0 + u) + sx]), xh[u][1], xl[u][1]);
          }
#pragma unroll
          for (int term = 0; term < 3; ++term) {
            if (kExact && term == 1) continue;  // x_lo = 0
#pragma unroll
            for (int u = 0; u < kNG; ++u) {
              // term 0: w_lo x_hi, 1: w_hi x_lo, 2: w_hi x_hi
              mma_if(true, acc[n0 + u], term == 0 ? wl : wh,
                     term == 1 ? xl[u][0] : xh[u][0],
                     term == 1 ? xl[u][1] : xh[u][1]);
            }
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          wh[e] = nh[e];
          wl[e] = nl[e];
        }
      }
      if (nk > 0) store_tile<T, NT, kVec>(y, acc, row0, i0, p0, h, H, P, lc);
    }
    if (next) {
      cp_async_wait<0>();  // this thread's part of the next x is in
      put_ad(buf ^ 1);
    }
    bar_sync(1 + set, kSetThreads);  // the next head is in, this one done
  }
}

template <typename T, int NT, bool kVec, int kSets>
int launch_sets(const T* x, const T* dt, const T* acs, const T* bm,
                const T* cm, T* y, long long B, int nc, int lc, int H, int P,
                int N, int pw, void* stream) {
  // The most state columns a time (whole rows where they fit).
  int nks = (N + 7) / 8 * 8;
  while (nks > 8 && Layout(lc, pw, nks, kSets, sizeof(T)).total > kMaxSmem) {
    nks -= 8;
  }
  const size_t smem = Layout(lc, pw, nks, kSets, sizeof(T)).total;
  auto kern = ssd_intra_kernel<T, NT, kVec, kSets>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = kSets * kSetThreads;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // As many head groups as keep the grid within one wave: B and C do not
  // depend on the head, so a block with more heads reuses C B^T more.
  const long long chunks = B * nc;
  long long groups = static_cast<long long>(per_sm > 0 ? per_sm : 1) *
                     sm_count() / chunks;
  if (groups > H) groups = H;
  if (groups < 1) groups = 1;
  const int per_block = static_cast<int>((H + groups - 1) / groups);
  groups = (H + per_block - 1) / per_block;
  const dim3 grid(static_cast<unsigned>(groups), static_cast<unsigned>(nc),
                  static_cast<unsigned>(B));
  kern<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, dt, acs, bm, cm, y, nc, lc, H, P, N, nks, per_block);
  return static_cast<int>(cudaGetLastError());
}

// Two sets where their x buffers fit beside eight state columns of C and
// B (one at float32 P > 64).
template <typename T, int NT, bool kVec>
int launch_ssd(const T* x, const T* dt, const T* acs, const T* bm,
               const T* cm, T* y, long long B, int nc, int lc, int H, int P,
               int N, void* stream) {
  const int pw = (P + 8 * NT - 1) / (8 * NT) * 8 * NT;
  if (Layout(lc, pw, 8, 2, sizeof(T)).total <= kMaxSmem) {
    return launch_sets<T, NT, kVec, 2>(x, dt, acs, bm, cm, y, B, nc, lc, H,
                                       P, N, pw, stream);
  }
  if constexpr (NT == 8) {
    return launch_sets<T, NT, kVec, 1>(x, dt, acs, bm, cm, y, B, nc, lc, H,
                                       P, N, pw, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int NT>
int with_vec(const T* x, const T* dt, const T* acs, const T* bm, const T* cm,
             T* y, long long B, int nc, int lc, int H, int P, int N,
             void* stream) {
  const auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = a16(x) && a16(bm) && a16(cm) && a16(y) &&
                   (P * sizeof(T)) % 16 == 0 && (N * sizeof(T)) % 16 == 0;
  if (vec) return launch_ssd<T, NT, true>(x, dt, acs, bm, cm, y, B, nc, lc,
                                          H, P, N, stream);
  return launch_ssd<T, NT, false>(x, dt, acs, bm, cm, y, B, nc, lc, H, P, N,
                                  stream);
}

template <typename T>
int dispatch(const T* x, const T* dt, const T* acs, const T* bm, const T* cm,
             T* y, long long B, int nc, int lc, int H, int P, int N,
             void* stream) {
  if (B == 0 || nc == 0 || H == 0) return 0;
  if (B < 0 || B > 65535 || nc < 0 || nc > 65535 || lc < 1 || lc > kMaxLc ||
      H < 0 || P < 1 || P > 128 || N < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (P <= 16) return with_vec<T, 2>(x, dt, acs, bm, cm, y, B, nc, lc, H, P,
                                     N, stream);
  if (P <= 32) return with_vec<T, 4>(x, dt, acs, bm, cm, y, B, nc, lc, H, P,
                                     N, stream);
  return with_vec<T, 8>(x, dt, acs, bm, cm, y, B, nc, lc, H, P, N, stream);
}

}  // namespace

// Each entry point launches on `stream` (PyTorch's current stream), does
// not synchronise, and returns the CUDA error of its launch (0 on success).
// x, y [B, nc, lc, H, P], dt and acs [B, nc, lc, H], bm and cm
// [B, nc, lc, N], contiguous; 1 <= lc <= 128, 1 <= P <= 128, N >= 1.
extern "C" {

int ssd_intra_f32(const float* x, const float* dt, const float* acs,
                  const float* bm, const float* cm, float* y, long long B,
                  int nc, int lc, int H, int P, int N, void* stream) {
  return dispatch<float>(x, dt, acs, bm, cm, y, B, nc, lc, H, P, N, stream);
}

int ssd_intra_bf16(const __nv_bfloat16* x, const __nv_bfloat16* dt,
                   const __nv_bfloat16* acs, const __nv_bfloat16* bm,
                   const __nv_bfloat16* cm, __nv_bfloat16* y, long long B,
                   int nc, int lc, int H, int P, int N, void* stream) {
  return dispatch<__nv_bfloat16>(x, dt, acs, bm, cm, y, B, nc, lc, H, P, N,
                                 stream);
}

}  // extern "C"
