// Grouped-GQA flash attention, forward, for Hopper (sm_90a), with a plain C
// interface that kernels/flash_attention.py loads through ctypes.
//
// It replaces the TPU kernel flash_attention
// (src/repro/kernels/flash_attention.py, pallas_call :110): for q
// [B, S, Hq, D] and k, v [B, T, Hkv, D] (Hq = G * Hkv; query head h*G + g
// reads KV head h), in float32 or bfloat16,
//
//     s    = (q . k) / sqrt(D)                       in float32
//     s    = allowed(qpos, kpos) ? s : -1e30         causal | sliding |
//                                                    chunked | bidirectional
//     o    = softmax(s) @ v                          online, over kv tiles
//
// with the reference's numerics: running max m, denominator l and
// accumulator acc in float32, l * alpha + sum p, then acc * alpha + p @ v,
// p rounded to v's type before p @ v (bfloat16: __float2bfloat16_rn), and
// o = acc / max(l, 1e-30) rounded to q's type. kernels/ref.py:
// flash_attention is the same computation in torch.
//
// Bound: operations. The work is 4 * D operations per head for each
// ALLOWED (q, k) pair (2 * D for q . k and 2 * D for p @ v, a multiply-add
// counting two). Both products run on the tensor cores: in float32 as
// 3xTF32 (three TF32 products for each float32 one, so the float32 peak is
// 495 / 3 = 165 TFLOP/s), in bfloat16 as one pass (989 TFLOP/s). At
// fedlm-100m's prefill [4, 2048, 10/5, 64], causal, 21.5 GFLOP: 0.130 ms
// in float32; the bytes (q, k, v, o once each, 63 MB) take 0.019 ms. At
// qwen3-1.7b's [1, 8192, 16/8, 128], sliding 4096, 206 GFLOP: 1.250 ms
// (201 MB, 0.060 ms).
//
// Design. A row is one (query position, query head of the group) pair;
// a block owns BR = 16 * NW consecutive rows of the [S * G] row space of
// one KV head, so one K/V tile in shared memory serves all G query heads
// of the group (KV is never repeated to Hq) and any G works. Warp w owns
// rows 16 w .. 16 w + 15 of the block. Per kv tile of BK keys:
//
//  1. K and V tiles come into shared memory by cp.async, in the operand
//     type, through a ring of two buffers: tile t + 1 loads while tile t
//     computes (two barriers a tile). The block's Q tile comes with the
//     first; a warp reads its A fragments from it at every tile (held in
//     registers, Q's hi and lo parts made float32 spill at D 64).
//  2. S = Q K^T on mma.sync: float32 m16n8k8 TF32 as 3xTF32 (each operand
//     split in registers into hi = tf32(v), v to nearest, and lo = v - hi;
//     lo hi + hi lo, then hi hi, into float32 accumulators), bfloat16 one
//     m16n8k16 pass. The head dim is permuted alike in Q and K so that a
//     lane's operands of two k-steps are four consecutive words of a row
//     (one 16-byte load).
//  3. The online softmax runs on the accumulator fragments: the mask from
//     each row's allowed key range [lo, hi] (two integer compares), the
//     row max and sum over the four lanes of a quad by shuffles.
//  4. O = O alpha + P V with P straight from the accumulators, never
//     through shared memory. bfloat16: two n8 accumulator tiles are the A
//     fragment of one k16 step, and V's B fragments come by ldmatrix.trans.
//     float32: the accumulator holds keys (2t, 2t + 1) where A wants (t,
//     t + 4), so A's k = t and t + 4 read keys 2t and 2t + 1 and the B
//     operand reads V's rows 2t and 2t + 1 to match; V's columns are
//     permuted within groups of 4 n8 tiles so that a lane's B operands of
//     the group are one 16-byte load, and its outputs 8 consecutive
//     columns.
//
// Sums through the tensor cores: their float32 sums round toward zero, so
// a running sum that many mma add to drifts (one accumulator for all of O
// read ~7e-6 over 8192 keys, against 8e-7 in the CPU emulation of the same
// products). So each tile's P V is summed from zero and then added as the
// reference adds it, acc * alpha + pv, and in float32 Q K^T is summed from
// zero over every PC chunks of the head dim (64 words) before those sums
// are added (~2.5e-6).
//
// Rows are padded so that every fragment load of a quarter warp (16-byte
// loads) or of a warp (ldmatrix, 4-byte loads) hits distinct banks: Q and K
// rows are 16 mod 32 words long, V rows 4 mod 32.
//
// Kv tiles that the mask rules out for every row of the block are not
// loaded (the block visits keys [k_lo, k_hi] only: causal: k <= its last
// query; sliding: k > its first query - window; chunked: from its first
// query's chunk start), and a warp skips the tiles it rules out for all of
// its rows. That is the reference's result: a tile it visits with every
// score masked adds exp(0) junk to a row whose allowed keys come later, and
// the first allowed tile's alpha = exp(-1e30 - m) = 0 wipes it; a row whose
// allowed keys came earlier gets p = exp(-1e30 - m) = 0. A row with no
// allowed key at all (only where kv_len != S: a chunk that starts at or
// after kv_len, a sliding row with qpos - window >= kv_len - 1) sees -1e30
// in every tile the reference visits, pad keys (zero rows) included, so
// there p = exp(0) = 1 for all nk * kv_blk of its keys (kv_blk = min(256,
// kv_len), nk = ceil(kv_len / kv_blk)) and it returns sum_{t < kv_len} v_t
// / (nk * kv_blk). A block that holds such a row makes one more pass over
// all of V for it and writes that. Row tiles run last first over all (KV
// head, batch) pairs, so the causal mask's longest blocks start first.
// Offsets are 64-bit. There are no
// atomics: a repeat gives the same bits.
//
// Tiles (warps NW, rows BR, keys BK) and dynamic shared memory, float32 /
// bfloat16: D 16 and 32: 4, 64, 64, 22 / 12 KiB and 54 / 22 KiB; D 64: 4,
// 64, 64, 94 / 54 KiB; D 128: 8, 128, 64, 210 / 114 KiB; D 256: 4, 64,
// 32, 201 / 105 KiB. Head dims 16, 32, 64, 128 and 256 are built. Chosen on an
// H100 among 4 or 8 warps and 32 or 64 keys at the serve shapes; K and V
// split into hi and lo once a block in shared memory (which forces 32-key
// tiles) lost to the split in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

using repro::cp_async;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::split;

constexpr float kNegInf = -1e30f;

enum MaskKind { kCausal = 0, kSliding = 1, kChunked = 2, kBidirectional = 3 };

// Geometry of a block, in 32-bit words of the operand type (one float32 or
// two bfloat16 values).
template <typename T, int D>
struct Tile {
  static constexpr int NW = D == 128 ? 8 : 4;  // warps, 16 rows each
  static constexpr int BR = 16 * NW;           // rows per block
  static constexpr int BK = D >= 256 ? 32 : 64;  // keys per kv tile
  static constexpr int NT = BK / 8;            // n8 tiles of S
  static constexpr int NO = D / 8;             // n8 tiles of O
  static constexpr int DW = D * static_cast<int>(sizeof(T)) / 4;  // words
  // words a lane reads from a Q or K row at once (two k-steps; one where a
  // row has only one), and the chunks of 4 * CW words of a row
  static constexpr int CW = DW >= 16 ? 4 : 2;
  static constexpr int NC = DW / (4 * CW);
  static constexpr int LDK = DW <= 16 ? DW : (DW + 15) / 32 * 32 + 16;
  static constexpr int LDV = DW + 4;
  // float32: n8 tiles of O whose B operands a lane reads in one load
  static constexpr int NG = NO < 4 ? NO : 4;
  // float32: chunks of the head dim (4 * CW words each) whose Q K^T
  // products are summed from zero before they are added to the scores
  static constexpr int PC = sizeof(T) == 4 ? 4 : NC;
  static constexpr size_t kSmem =
      sizeof(uint32_t) * (BR * LDK + 2 * BK * (LDK + LDV));
  static_assert(DW % (4 * CW) == 0 && NT % 4 == 0 && NO % NG == 0, "tile");
};

template <int N>
__device__ __forceinline__ void lds(uint32_t (&r)[N], const uint32_t* p) {
  if constexpr (N == 4) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    r[0] = x.x;
    r[1] = x.y;
    r[2] = x.z;
    r[3] = x.w;
  } else {
    static_assert(N == 2, "a load of 2 or 4 words");
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    r[0] = x.x;
    r[1] = x.y;
  }
}

// 2^x (ex2.approx: relative error ~2^-22; 0 below 2^-126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Element d of a shared V row, as float32.
__device__ __forceinline__ float v_at(const uint32_t* row, int d, float*) {
  return __uint_as_float(row[d]);
}
__device__ __forceinline__ float v_at(const uint32_t* row, int d,
                                      __nv_bfloat16*) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(row)[d]);
}

// The keys query qp may attend to, [lo, hi] (lo > hi: none).
__device__ __forceinline__ void key_range(int kind, long long qp,
                                          long long kv_len, int window,
                                          int chunk, long long& lo,
                                          long long& hi) {
  lo = 0;
  hi = kind == kBidirectional ? kv_len - 1 : (qp < kv_len ? qp : kv_len - 1);
  if (kind == kSliding && qp - window + 1 > 0) lo = qp - window + 1;
  if (kind == kChunked) lo = (qp / chunk) * chunk;
}

// The reference kernel's kv tile (kernels/ref.py:flash_attention's kv_blk).
constexpr long long kRefKvBlock = 256;

__device__ __forceinline__ int clamp_key(long long x, int bk) {
  return x < -1 ? -1 : (x > bk ? bk : static_cast<int>(x));
}

template <typename T, int D>
__global__ void __launch_bounds__(Tile<T, D>::NW * 32)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, long long S,
                     long long kv_len, int Hkv, int G, int kind, int window,
                     int chunk, long long n_row_tiles, int n_heads_batch) {
  using C = Tile<T, D>;
  constexpr bool kF32 = std::is_same_v<T, float>;
  constexpr int kThreads = C::NW * 32;
  constexpr int CPR = C::DW / 4;  // 16-byte chunks of a row
  constexpr int NG = C::NG;
  extern __shared__ float4 smem4[];
  uint32_t* sQ = reinterpret_cast<uint32_t*>(smem4);  // [BR][LDK]
  uint32_t* sK = sQ + C::BR * C::LDK;      // [2][BK][LDK]
  uint32_t* sV = sK + 2 * C::BK * C::LDK;  // [2][BK][LDV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // blocks in order of row tile, last first, over every (KV head, batch):
  // the causal mask's longest blocks start first
  const long long tile = n_row_tiles - 1 - blockIdx.x / n_heads_batch;
  const int h = blockIdx.x % n_heads_batch % Hkv;
  const long long b = blockIdx.x % n_heads_batch / Hkv;
  const long long Hq = static_cast<long long>(Hkv) * G;
  const long long rows = S * G;
  const long long r0 = tile * C::BR;

  // The lane's rows 16 warp + g and + 8: their allowed keys, and whether
  // they exist and have none (lo > hi marks both a missing row and one
  // without keys).
  long long lo[2], hi[2];
  bool empty[2];
  // the keys some row of the warp allows [wlo, whi], and those every row
  // allows [flo, fhi] (empty if a row is missing or has none)
  long long wlo = LLONG_MAX, whi = -1, flo = 0, fhi = LLONG_MAX;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long r = r0 + 16 * warp + g + 8 * i;
    lo[i] = 1;
    hi[i] = 0;
    if (r < rows) key_range(kind, r / G, kv_len, window, chunk, lo[i], hi[i]);
    empty[i] = r < rows && lo[i] > hi[i];
    if (lo[i] <= hi[i]) {
      wlo = lo[i] < wlo ? lo[i] : wlo;
      whi = hi[i] > whi ? hi[i] : whi;
    }
    flo = lo[i] > flo ? lo[i] : flo;
    fhi = hi[i] < fhi ? hi[i] : fhi;
  }
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) {
    const long long a = __shfl_xor_sync(0xffffffffu, wlo, w);
    const long long c = __shfl_xor_sync(0xffffffffu, whi, w);
    const long long e = __shfl_xor_sync(0xffffffffu, flo, w);
    const long long f = __shfl_xor_sync(0xffffffffu, fhi, w);
    wlo = a < wlo ? a : wlo;
    whi = c > whi ? c : whi;
    flo = e > flo ? e : flo;
    fhi = f < fhi ? f : fhi;
  }

  // The keys any row of the block may attend to.
  const long long q_lo = r0 / G;
  const long long r_hi = r0 + C::BR - 1 < rows ? r0 + C::BR - 1 : rows - 1;
  const long long q_hi = r_hi / G;
  long long k_lo = 0, k_hi = kv_len - 1;
  if (kind != kBidirectional && q_hi < k_hi) k_hi = q_hi;
  if (kind == kSliding && q_lo - window + 1 > k_lo) k_lo = q_lo - window + 1;
  if (kind == kChunked) k_lo = (q_lo / chunk) * chunk;

  const char* kb = reinterpret_cast<const char*>(k);
  const char* vb = reinterpret_cast<const char*>(v);
  auto load_tile = [&](const char* src, uint32_t* dst, int ld,
                       long long key0) {
    for (int c = tid; c < C::BK * CPR; c += kThreads) {
      const int j = c / CPR, w = (c - j * CPR) * 4;
      const long long key = key0 + j;
      const bool in = key < kv_len;
      const long long off =
          in ? ((b * kv_len + key) * Hkv + h) * D * sizeof(T) + 4 * w : 0;
      cp_async<16>(dst + j * ld + w, src + off, in);
    }
  };
  auto load_kv = [&](long long key0, int buf) {
    load_tile(kb, sK + buf * C::BK * C::LDK, C::LDK, key0);
    load_tile(vb, sV + buf * C::BK * C::LDV, C::LDV, key0);
  };

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[C::NO][4];
#pragma unroll
  for (int u = 0; u < C::NO; ++u) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
  }
  // scores in log2 units: p = 2^(s log2(e) - m), m the running max of
  // s log2(e); a masked score is -1e30 in either unit
  const float scale = 1.44269504088896341f / sqrtf(static_cast<float>(D));

  const long long kt_first = k_lo / C::BK, kt_last = k_hi / C::BK;
  if (k_lo <= k_hi) {
    // Q tile: row j is (query r / G, head h*G + r % G) for r = r0 + j.
    const char* qb = reinterpret_cast<const char*>(q);
    for (int c = tid; c < C::BR * CPR; c += kThreads) {
      const int j = c / CPR, w = (c - j * CPR) * 4;
      const long long r = r0 + j;
      const bool in = r < rows;
      const long long off =
          in ? ((b * S + r / G) * Hq + h * G + r % G) * D * sizeof(T) + 4 * w
             : 0;
      cp_async<16>(sQ + j * C::LDK + w, qb + off, in);
    }
    load_kv(kt_first * C::BK, 0);
    cp_async_commit();
  }

  // A fragments of chunk c, k-step ks: rows g and g + 8, words 2 ks and
  // 2 ks + 1 of the lane's CW (float32: split into hi and lo)
  const uint32_t* q0 = sQ + (16 * warp + g) * C::LDK + C::CW * t;
  const auto q_frags = [&](int c, uint32_t (&ah)[C::CW / 2][4],
                           uint32_t (&al)[C::CW / 2][4]) {
    uint32_t qa[C::CW], qc[C::CW];
    lds(qa, q0 + 4 * C::CW * c);
    lds(qc, q0 + 8 * C::LDK + 4 * C::CW * c);
#pragma unroll
    for (int ks = 0; ks < C::CW / 2; ++ks) {
      const uint32_t a[4] = {qa[2 * ks], qc[2 * ks], qa[2 * ks + 1],
                             qc[2 * ks + 1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kF32) {
          split<false>(__uint_as_float(a[e]), ah[ks][e], al[ks][e]);
        } else {
          ah[ks][e] = a[e];
        }
      }
    }
  };
  int buf = 0;
  for (long long kt = kt_first; k_lo <= k_hi && kt <= kt_last;
       ++kt, buf ^= 1) {
    if (kt < kt_last) {
      load_kv((kt + 1) * C::BK, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt is in for every thread
    const long long key0 = kt * C::BK;
    if (key0 <= whi && key0 + C::BK - 1 >= wlo) {
      // ---------------------------------------------------- S = Q K^T
      float s[C::NT][4];
#pragma unroll
      for (int u = 0; u < C::NT; ++u) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[u][e] = 0.f;
      }
      const uint32_t* kt0 =
          sK + buf * C::BK * C::LDK + g * C::LDK + C::CW * t;
      float tot[C::NT][4];  // the scores of the chunks before the last PC
#pragma unroll
      for (int c = 0; c < C::NC; ++c) {
        if (c > 0 && c % C::PC == 0) {
#pragma unroll
          for (int u = 0; u < C::NT; ++u) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              tot[u][e] = c > C::PC ? tot[u][e] + s[u][e] : s[u][e];
              s[u][e] = 0.f;
            }
          }
        }
        uint32_t ah[C::CW / 2][4], al[C::CW / 2][4];
        q_frags(c, ah, al);
#pragma unroll
        for (int ug = 0; ug < C::NT; ug += 4) {
          uint32_t bw[4][C::CW];
          const uint32_t* pk = kt0 + 8 * ug * C::LDK + 4 * C::CW * c;
          if constexpr (kF32) {
            uint32_t bh[4][C::CW], bl[4][C::CW];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              lds(bw[u], pk + 8 * u * C::LDK);
#pragma unroll
              for (int e = 0; e < C::CW; ++e) {
                split<false>(__uint_as_float(bw[u][e]), bh[u][e], bl[u][e]);
              }
            }
            // term 0: q_lo k_hi, 1: q_hi k_lo, 2: q_hi k_hi; consecutive
            // products go to different accumulators
#pragma unroll
            for (int term = 0; term < 3; ++term) {
#pragma unroll
              for (int ks = 0; ks < C::CW / 2; ++ks) {
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                  repro::mma_tf32(s[ug + u], term == 0 ? al[ks] : ah[ks],
                                  term == 1 ? bl[u][2 * ks] : bh[u][2 * ks],
                                  term == 1 ? bl[u][2 * ks + 1]
                                            : bh[u][2 * ks + 1]);
                }
              }
            }
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u) lds(bw[u], pk + 8 * u * C::LDK);
#pragma unroll
            for (int ks = 0; ks < C::CW / 2; ++ks) {
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                repro::mma_bf16(s[ug + u], ah[ks], bw[u][2 * ks],
                                bw[u][2 * ks + 1]);
              }
            }
          }
        }
      }

      if constexpr (C::NC > C::PC) {
#pragma unroll
        for (int u = 0; u < C::NT; ++u) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[u][e] = tot[u][e] + s[u][e];
        }
      }

      // ------------------------------------------------ online softmax
      if (flo <= key0 && key0 + C::BK - 1 <= fhi) {  // no key masked
#pragma unroll
        for (int u = 0; u < C::NT; ++u) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[u][e] *= scale;
        }
      } else {
        int klo[2], khi[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          klo[i] = clamp_key(lo[i] - key0, C::BK);
          khi[i] = clamp_key(hi[i] - key0, C::BK);
        }
#pragma unroll
        for (int u = 0; u < C::NT; ++u) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1, kk = 8 * u + 2 * t + (e & 1);
            const bool ok = kk >= klo[i] && kk <= khi[i];
            s[u][e] = ok ? s[u][e] * scale : kNegInf;
          }
        }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int u = 0; u < C::NT; ++u) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[u][e]);
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = ex2(m[i] - m_new);
        m[i] = m_new;
      }
#pragma unroll
      for (int u = 0; u < C::NT; ++u) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[u][e] = ex2(s[u][e] - m[e >> 1]);
          sum[e >> 1] += s[u][e];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        l[i] = l[i] * alpha[i] + sum[i];
      }
      // ---------------------------------------- O = O alpha + P V
      // The tile's P V is summed over its keys from zero and then added,
      // acc * alpha + pv, as the reference adds it (see "Sums through the
      // tensor cores" above).
      const uint32_t* vt = sV + buf * C::BK * C::LDV;
      const auto add_tile = [&](float (&a)[4], const float (&pv)[4]) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = a[e] * alpha[e >> 1] + pv[e];
      };
      if constexpr (kF32) {
        // P's A fragment of keys 8j .. 8j + 7, split at each use (fewer
        // registers): A's k = t, t + 4 are keys 2t, 2t + 1
        const uint32_t* v0 = vt + 2 * t * C::LDV + NG * g;
#pragma unroll
        for (int cg = 0; cg < C::NO / NG; ++cg) {
          float pv[NG][4] = {};
#pragma unroll
          for (int j = 0; j < C::NT; ++j) {
            uint32_t pjh[4], pjl[4];
            split<false>(s[j][0], pjh[0], pjl[0]);
            split<false>(s[j][2], pjh[1], pjl[1]);
            split<false>(s[j][1], pjh[2], pjl[2]);
            split<false>(s[j][3], pjh[3], pjl[3]);
            const uint32_t* vj = v0 + 8 * j * C::LDV + 8 * NG * cg;
            uint32_t x0[NG], x1[NG], bh[NG][2], bl[NG][2];
            lds(x0, vj);
            lds(x1, vj + C::LDV);
#pragma unroll
            for (int e = 0; e < NG; ++e) {
              split<false>(__uint_as_float(x0[e]), bh[e][0], bl[e][0]);
              split<false>(__uint_as_float(x1[e]), bh[e][1], bl[e][1]);
            }
            // term 0: p_lo v_hi, 1: p_hi v_lo, 2: p_hi v_hi
#pragma unroll
            for (int term = 0; term < 3; ++term) {
#pragma unroll
              for (int e = 0; e < NG; ++e) {
                repro::mma_tf32(pv[e], term == 0 ? pjl : pjh,
                                term == 1 ? bl[e][0] : bh[e][0],
                                term == 1 ? bl[e][1] : bh[e][1]);
              }
            }
          }
#pragma unroll
          for (int e = 0; e < NG; ++e) add_tile(acc[NG * cg + e], pv[e]);
        }
      } else {
        uint32_t pa[C::NT / 2][4];
#pragma unroll
        for (int jj = 0; jj < C::NT / 2; ++jj) {
          pa[jj][0] = pack_bf16(s[2 * jj][0], s[2 * jj][1]);
          pa[jj][1] = pack_bf16(s[2 * jj][2], s[2 * jj][3]);
          pa[jj][2] = pack_bf16(s[2 * jj + 1][0], s[2 * jj + 1][1]);
          pa[jj][3] = pack_bf16(s[2 * jj + 1][2], s[2 * jj + 1][3]);
        }
        // ldmatrix row of this lane: key 8 ((lane / 8) % 2) + lane % 8,
        // column 8 (lane / 16) of each 16-column pair of n8 tiles
        const uint32_t* vl = vt + (8 * ((lane >> 3) & 1) + (lane & 7)) *
                                      C::LDV + 4 * (lane >> 4);
#pragma unroll
        for (int np = 0; np < C::NO / 2; ++np) {
          float pv[2][4] = {};
#pragma unroll
          for (int jj = 0; jj < C::NT / 2; ++jj) {
            uint32_t bw[4];
            repro::ldmatrix_x4_trans(bw, vl + 16 * jj * C::LDV + 8 * np);
            repro::mma_bf16(pv[0], pa[jj], bw[0], bw[1]);
            repro::mma_bf16(pv[1], pa[jj], bw[2], bw[3]);
          }
          add_tile(acc[2 * np], pv[0]);
          add_tile(acc[2 * np + 1], pv[1]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }

  // The column of O that accumulator (tile u, column n = 2t + e) holds.
  const auto col = [&](int u, int e) {
    const int n = 2 * t + e;
    return kF32 ? 8 * NG * (u / NG) + NG * n + u % NG : 8 * u + n;
  };

  // Rows with no allowed key: sum all of V, over the reference's count.
  if (__syncthreads_or(empty[0] || empty[1])) {
    const long long ref_blk = kv_len < kRefKvBlock ? kv_len : kRefKvBlock;
    const float ref_keys = static_cast<float>(
        (kv_len + ref_blk - 1) / ref_blk * ref_blk);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!empty[i]) continue;
      l[i] = ref_keys;
#pragma unroll
      for (int u = 0; u < C::NO; ++u) acc[u][2 * i] = acc[u][2 * i + 1] = 0.f;
    }
    for (long long key0 = 0; key0 < kv_len; key0 += C::BK) {
      __syncthreads();  // the last tile's V is read
      load_tile(vb, sV, C::LDV, key0);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (!(empty[0] || empty[1])) continue;
      for (int kk = 0; kk < C::BK; ++kk) {
        const uint32_t* row = sV + kk * C::LDV;
#pragma unroll
        for (int u = 0; u < C::NO; ++u) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = v_at(row, col(u, e), static_cast<T*>(nullptr));
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              if (empty[i]) acc[u][2 * i + e] += x;
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long r = r0 + 16 * warp + g + 8 * i;
    if (r >= rows) continue;
    T* dst = o + ((b * S + r / G) * Hq + h * G + r % G) * D;
    const float denom = fmaxf(l[i], 1e-30f);
    if constexpr (kF32) {
      // columns 8 NG cg + 2 NG t + [0, 2 NG): tiles NG cg .. + NG - 1,
      // n = 2t then 2t + 1
#pragma unroll
      for (int cg = 0; cg < C::NO / NG; ++cg) {
        float x[2 * NG];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int u = 0; u < NG; ++u) {
            x[NG * e + u] = acc[NG * cg + u][2 * i + e] / denom;
          }
        }
        float* p = dst + 8 * NG * cg + 2 * NG * t;
#pragma unroll
        for (int w = 0; w < 2 * NG; w += 4) {
          *reinterpret_cast<float4*>(p + w) =
              make_float4(x[w], x[w + 1], x[w + 2], x[w + 3]);
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < C::NO; ++u) {
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * u + 2 * t) =
            __floats2bfloat162_rn(acc[u][2 * i] / denom,
                                  acc[u][2 * i + 1] / denom);
      }
    }
  }
}

template <typename T, int D>
int launch_flash(const T* q, const T* k, const T* v, T* o, long long B,
                 long long S, long long kv_len, int Hkv, int G, int kind,
                 int window, int chunk, void* stream) {
  using C = Tile<T, D>;
  const long long n_row_tiles = (S * G + C::BR - 1) / C::BR;
  if (n_row_tiles * Hkv * B > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kern = flash_fwd_kernel<T, D>;
  // Fixed for an instantiation: raised once, not at every launch.
  static const cudaError_t raised = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (raised != cudaSuccess) return static_cast<int>(raised);
  const unsigned blocks = static_cast<unsigned>(n_row_tiles * Hkv * B);
  kern<<<blocks, C::NW * 32, C::kSmem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, o, S, kv_len, Hkv, G, kind, window, chunk, n_row_tiles,
      static_cast<int>(Hkv * B));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, T* o, long long B,
             long long S, long long kv_len, int Hkv, int G, int D, int kind,
             int window, int chunk, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (kv_len < 1 || Hkv < 1 || G < 1 || kind < kCausal ||
      kind > kBidirectional || (kind == kSliding && window < 1) ||
      (kind == kChunked && chunk < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (D) {
    case 16:
      return launch_flash<T, 16>(q, k, v, o, B, S, kv_len, Hkv, G, kind,
                                 window, chunk, stream);
    case 32:
      return launch_flash<T, 32>(q, k, v, o, B, S, kv_len, Hkv, G, kind,
                                 window, chunk, stream);
    case 64:
      return launch_flash<T, 64>(q, k, v, o, B, S, kv_len, Hkv, G, kind,
                                 window, chunk, stream);
    case 128:
      return launch_flash<T, 128>(q, k, v, o, B, S, kv_len, Hkv, G, kind,
                                  window, chunk, stream);
    case 256:
      return launch_flash<T, 256>(q, k, v, o, B, S, kv_len, Hkv, G, kind,
                                  window, chunk, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Each entry point launches on `stream` (PyTorch's current stream), does
// not synchronise, and returns the CUDA error of its launch (0 on success).
// q, o [B, S, Hkv * G, D] and k, v [B, kv_len, Hkv, D], contiguous and
// 16-byte aligned; D in {16, 32, 64, 128, 256}; kind 0 causal, 1 sliding
// (window >= 1), 2 chunked (chunk >= 1), 3 bidirectional.
extern "C" {

int flash_attention_f32(const float* q, const float* k, const float* v,
                        float* o, long long B, long long S, long long kv_len,
                        int Hkv, int G, int D, int kind, int window,
                        int chunk, void* stream) {
  return dispatch<float>(q, k, v, o, B, S, kv_len, Hkv, G, D, kind, window,
                         chunk, stream);
}

int flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, __nv_bfloat16* o,
                         long long B, long long S, long long kv_len, int Hkv,
                         int G, int D, int kind, int window, int chunk,
                         void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, B, S, kv_len, Hkv, G, D, kind,
                                 window, chunk, stream);
}

}  // extern "C"
