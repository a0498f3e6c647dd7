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
// accumulator acc in float32, p rounded to v's type before p @ v (bfloat16:
// __float2bfloat16_rn), and o = acc / max(l, 1e-30) rounded to q's type.
// kernels/ref.py:flash_attention is the same computation in torch.
//
// Bound: operations. The work is 4 * D operations per head for each
// ALLOWED (q, k) pair (2 * D for q . k and 2 * D for p @ v, a multiply-add
// counting two), 4 * B * Hq * D * pairs in all: at fedlm-100m's prefill
// [4, 2048, 10/5, 64], causal, 21.5 GFLOP, 0.32 ms at 67 TFLOP/s (float32
// outside the tensor cores); the bytes (q, k, v, o once each, 63 MB) take
// 0.019 ms. At qwen3-1.7b's [1, 8192, 16/8, 128], sliding 4096, 206 GFLOP,
// 3.08 ms (201 MB, 0.060 ms). In
// bfloat16 the bound is the same work over 989 TFLOP/s, which only the
// tensor cores reach; this first kernel does not use them.
//
// Design: one block of 128 threads per (row tile, KV head, batch), where a
// row is one (query position, query head of the group) pair: the block's
// BR rows are BR consecutive entries of the [S * G] row space of KV head h,
// so one K/V tile in shared memory serves all G query heads of the group
// (KV is never repeated to Hq) and any G works. Per kv tile of BK keys:
//
//  1. the K and V tiles are loaded into shared memory (16-byte loads,
//     converted to float32, rows padded by 4 floats against bank conflicts);
//  2. thread (tr, tc) = (tid / 8, tid % 8) computes the scores of rows
//     tr + 16 i and keys tc + 8 j with __fmaf_rn over D (explicit FMAs:
//     the library is built with --fmad=false, which the intrinsic
//     ignores), scales, masks and keeps them in registers;
//  3. the row max and row sum reduce over the 8 lanes tc of a row by warp
//     shuffles; m, l and the rescale of acc follow the reference's order
//     (l * alpha + sum p, acc * alpha + p @ v); p goes to shared memory;
//  4. thread (tr, tc) accumulates acc for its rows and D / 8 columns over
//     the tile's keys (acc[D] is split over 8 lanes, so it stays in
//     registers).
//
// Kv tiles that the mask rules out for every row of the block are skipped:
// the block visits keys [k_lo, k_hi] only (causal: k <= the block's last
// query; sliding: k > its first query - window; chunked: from its first
// query's chunk start). That is the reference's result: a tile it visits
// with every score masked adds exp(0) junk to a row whose allowed keys come
// later, and the first allowed tile's alpha = exp(-1e30 - m) = 0 wipes it;
// a row whose allowed keys came earlier gets p = exp(-1e30 - m) = 0. A row
// with no allowed key at all (only where kv_len != S: a chunk that starts
// at or after kv_len, a sliding row with qpos - window >= kv_len - 1) sees
// -1e30 in every tile the reference visits, pad keys (zero rows) included,
// so there p = exp(0) = 1 for all nk * kv_blk of its keys (kv_blk =
// min(256, kv_len), nk = ceil(kv_len / kv_blk)) and it returns
// sum_{t < kv_len} v_t / (nk * kv_blk). A block that holds such a row makes
// one more pass over all of V for it and writes that. Row tiles run last
// first, so the causal mask's longest blocks start first. Offsets are 64-bit.
//
// Tiles (BR rows, BK keys): D <= 64: 64 x 64; D = 128: 64 x 32; D = 256:
// 32 x 32; shared memory 34-105 KB, dynamic (above the 48 KB static
// limit for D >= 128). Head dims 16, 32, 64, 128 and 256 are built.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kFlashThreads = 128;
constexpr float kNegInf = -1e30f;

enum MaskKind { kCausal = 0, kSliding = 1, kChunked = 2, kBidirectional = 3 };

template <int D>
struct Tile {
  static constexpr int BR = D >= 256 ? 32 : 64;  // rows per block
  static constexpr int BK = D >= 128 ? 32 : 64;  // keys per kv tile
  static constexpr int LD = D + 4;               // Q/K/V tile row stride
  static constexpr int LDP = BK + 8;             // P tile row stride
  static constexpr int RPT = BR / 16;            // rows per thread
  static constexpr int KPT = BK / 8;             // keys per thread
  static constexpr int CPT = D / 8;              // output columns per thread
  static constexpr int VW = CPT < 4 ? CPT : 4;   // consecutive columns
  static constexpr size_t kSmem =
      sizeof(float) * (BR * LD + 2 * BK * LD + BR * LDP);
};

// 16 bytes of T, converted to float32 into shared memory.
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* src, float* dst) {
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* src, float* dst) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float f[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
    reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
};

__device__ __forceinline__ void zero4(float* dst, int n) {
  for (int i = 0; i < n; i += 4) {
    *reinterpret_cast<float4*>(dst + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// p as the PV product sees it: rounded to v's type (the reference's
// p.astype(v.dtype)).
__device__ __forceinline__ float round_p(float x, const float*) { return x; }
__device__ __forceinline__ float round_p(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool allowed(int kind, long long qp, long long kp,
                                        int window, int chunk) {
  if (kind == kBidirectional) return true;
  bool ok = kp <= qp;
  if (kind == kSliding) {
    ok = ok && kp > qp - window;
  } else if (kind == kChunked) {
    ok = ok && kp / chunk == qp / chunk;
  }
  return ok;
}

// Whether query qp has any allowed key in [0, kv_len).
__device__ __forceinline__ bool has_key(int kind, long long qp,
                                        long long kv_len, int window,
                                        int chunk) {
  if (kind == kSliding) return qp - window < kv_len - 1;
  if (kind == kChunked) return (qp / chunk) * chunk < kv_len;
  return true;  // causal (key 0) and bidirectional
}

// The reference kernel's kv tile (kernels/ref.py:flash_attention's kv_blk).
constexpr long long kRefKvBlock = 256;

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, long long S,
                     long long kv_len, int Hkv, int G, int kind, int window,
                     int chunk, int n_row_tiles) {
  using C = Tile<D>;
  constexpr int N = Pack<T>::N;
  constexpr int CH = D / N;  // 16-byte chunks per row
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + C::BR * C::LD;
  float* sV = sK + C::BK * C::LD;
  float* sP = sV + C::BK * C::LD;

  const int tid = threadIdx.x;
  const int tr = tid >> 3;
  const int tc = tid & 7;
  const long long tile = n_row_tiles - 1 - static_cast<long long>(blockIdx.x);
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long Hq = static_cast<long long>(Hkv) * G;
  const long long rows = S * G;
  const long long r0 = tile * C::BR;

  // Q tile: row j is (query r / G, head h*G + r % G) for r = r0 + j.
  for (int c = tid; c < C::BR * CH; c += kFlashThreads) {
    const int j = c / CH, col = (c % CH) * N;
    float* dst = sQ + j * C::LD + col;
    const long long r = r0 + j;
    if (r < rows) {
      Pack<T>::load(q + ((b * S + r / G) * Hq + h * G + r % G) * D + col,
                    dst);
    } else {
      zero4(dst, N);
    }
  }

  long long qpos[C::RPT];
#pragma unroll
  for (int i = 0; i < C::RPT; ++i) {
    const long long r = r0 + tr + 16 * i;
    qpos[i] = r < rows ? r / G : -1;
  }

  // The keys any row of the block may attend to.
  const long long q_lo = r0 / G;
  const long long r_hi = r0 + C::BR - 1 < rows ? r0 + C::BR - 1 : rows - 1;
  const long long q_hi = r_hi / G;
  long long k_lo = 0, k_hi = kv_len - 1;
  if (kind != kBidirectional && q_hi < k_hi) k_hi = q_hi;
  if (kind == kSliding && q_lo - window + 1 > k_lo) k_lo = q_lo - window + 1;
  if (kind == kChunked) k_lo = (q_lo / chunk) * chunk;

  float m[C::RPT], l[C::RPT], acc[C::RPT][C::CPT];
#pragma unroll
  for (int i = 0; i < C::RPT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::CPT; ++c) acc[i][c] = 0.f;
  }
  const float sqrt_d = sqrtf(static_cast<float>(D));

  for (long long kt = k_lo / C::BK; k_lo <= k_hi && kt <= k_hi / C::BK;
       ++kt) {
    const long long key0 = kt * C::BK;
    __syncthreads();  // the Q tile is in; the last tile's K, V, P are read
    for (int c = tid; c < C::BK * CH; c += kFlashThreads) {
      const int j = c / CH, col = (c % CH) * N;
      const long long key = key0 + j;
      float* dk = sK + j * C::LD + col;
      float* dv = sV + j * C::LD + col;
      if (key < kv_len) {
        const long long off = ((b * kv_len + key) * Hkv + h) * D + col;
        Pack<T>::load(k + off, dk);
        Pack<T>::load(v + off, dv);
      } else {
        zero4(dk, N);
        zero4(dv, N);
      }
    }
    __syncthreads();

    float s[C::RPT][C::KPT];
#pragma unroll
    for (int i = 0; i < C::RPT; ++i) {
#pragma unroll
      for (int j = 0; j < C::KPT; ++j) s[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[C::RPT], kv[C::KPT];
#pragma unroll
      for (int i = 0; i < C::RPT; ++i) {
        qv[i] = sQ[(tr + 16 * i) * C::LD + d];
      }
#pragma unroll
      for (int j = 0; j < C::KPT; ++j) kv[j] = sK[(tc + 8 * j) * C::LD + d];
#pragma unroll
      for (int i = 0; i < C::RPT; ++i) {
#pragma unroll
        for (int j = 0; j < C::KPT; ++j) {
          s[i][j] = __fmaf_rn(qv[i], kv[j], s[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < C::RPT; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < C::KPT; ++j) {
        const long long key = key0 + tc + 8 * j;
        const bool ok = qpos[i] >= 0 && key < kv_len &&
                        allowed(kind, qpos[i], key, window, chunk);
        s[i][j] = ok ? s[i][j] / sqrt_d : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      }
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < C::KPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sP[(tr + 16 * i) * C::LDP + tc + 8 * j] = round_p(p, v);
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      }
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C::CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < C::BK; ++kk) {
      float pv[C::RPT], vv[C::CPT];
#pragma unroll
      for (int i = 0; i < C::RPT; ++i) {
        pv[i] = sP[(tr + 16 * i) * C::LDP + kk];
      }
#pragma unroll
      for (int c = 0; c < C::CPT; ++c) {
        vv[c] = sV[kk * C::LD + (c / C::VW) * (8 * C::VW) + tc * C::VW +
                   c % C::VW];
      }
#pragma unroll
      for (int i = 0; i < C::RPT; ++i) {
#pragma unroll
        for (int c = 0; c < C::CPT; ++c) {
          acc[i][c] = __fmaf_rn(pv[i], vv[c], acc[i][c]);
        }
      }
    }
  }

  // Rows with no allowed key: sum all of V, over the reference's count.
  bool empty[C::RPT];
  int any_empty = 0;
#pragma unroll
  for (int i = 0; i < C::RPT; ++i) {
    empty[i] = qpos[i] >= 0 && !has_key(kind, qpos[i], kv_len, window, chunk);
    any_empty |= empty[i];
  }
  if (__syncthreads_or(any_empty)) {
    const long long ref_blk = kv_len < kRefKvBlock ? kv_len : kRefKvBlock;
    const float ref_keys = static_cast<float>(
        (kv_len + ref_blk - 1) / ref_blk * ref_blk);
#pragma unroll
    for (int i = 0; i < C::RPT; ++i) {
      if (!empty[i]) continue;
      l[i] = ref_keys;
#pragma unroll
      for (int c = 0; c < C::CPT; ++c) acc[i][c] = 0.f;
    }
    for (long long key0 = 0; key0 < kv_len; key0 += C::BK) {
      __syncthreads();  // the last tile's V is read
      for (int c = tid; c < C::BK * CH; c += kFlashThreads) {
        const int j = c / CH, col = (c % CH) * N;
        float* dv = sV + j * C::LD + col;
        if (key0 + j < kv_len) {
          Pack<T>::load(v + ((b * kv_len + key0 + j) * Hkv + h) * D + col, dv);
        } else {
          zero4(dv, N);
        }
      }
      __syncthreads();
      for (int kk = 0; kk < C::BK; ++kk) {
#pragma unroll
        for (int c = 0; c < C::CPT; ++c) {
          const float vv = sV[kk * C::LD + (c / C::VW) * (8 * C::VW) +
                              tc * C::VW + c % C::VW];
#pragma unroll
          for (int i = 0; i < C::RPT; ++i) {
            if (empty[i]) acc[i][c] += vv;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < C::RPT; ++i) {
    const long long r = r0 + tr + 16 * i;
    if (r >= rows) continue;
    T* dst = o + ((b * S + r / G) * Hq + h * G + r % G) * D;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < C::CPT; ++c) {
      put(dst + (c / C::VW) * (8 * C::VW) + tc * C::VW + c % C::VW,
          acc[i][c] / denom);
    }
  }
}

template <typename T, int D>
int launch_flash(const T* q, const T* k, const T* v, T* o, long long B,
                 long long S, long long kv_len, int Hkv, int G, int kind,
                 int window, int chunk, void* stream) {
  using C = Tile<D>;
  const long long n_row_tiles = (S * G + C::BR - 1) / C::BR;
  if (n_row_tiles > INT_MAX || Hkv > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(n_row_tiles),
                  static_cast<unsigned>(Hkv), static_cast<unsigned>(B));
  kern<<<grid, kFlashThreads, C::kSmem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, o, S, kv_len, Hkv, G, kind, window, chunk,
      static_cast<int>(n_row_tiles));
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
