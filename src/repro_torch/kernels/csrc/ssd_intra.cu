// Mamba2 SSD intra-chunk term, for Hopper (sm_90a), with a plain C interface
// that kernels/ssd_intra.py loads through ctypes.
//
// It replaces the TPU kernel ssd_intra (src/repro/kernels/ssd_intra.py,
// pallas_call :52, _ssd_intra_kernel :31): for x [B, Nc, Lc, H, P], dt and
// a_cs [B, Nc, Lc, H], Bm and Cm [B, Nc, Lc, N], in float32 or bfloat16,
//
//   y[b, c, i, h, :] = sum_{j <= i} (C_i . B_j) exp(a_cs_i - a_cs_j) dt_j x_j
//
// summed in float32 and rounded to x's type (bfloat16 operands are widened
// to float32 as they are loaded). kernels/ref.py:ssd_intra is the same
// computation in torch.
//
// Bound: operations. Per (batch, chunk) C B^T takes 2 Lc^2 N operations and,
// per head, W @ x 2 Lc^2 P: at mamba2-130m's prefill [4, 16, 128, 24, 64]
// with N = 128, 3.49 GFLOP (C B^T counted once per chunk, both products over
// the full Lc x Lc square), 0.052 ms at 67 TFLOP/s (float32 outside the
// tensor cores); the bytes (every operand read once, y written once,
// 110.6 MB) take 0.033 ms. The Pallas grid recomputes C B^T for every head
// (9.66 GFLOP); this kernel does not.
//
// Design: one block of 256 threads, 16 x 16 as (tr, tc), per (head group,
// chunk, batch). Thread (tr, tc) owns rows i = tr + 16 r (r < 8, so Lc <= 128)
// of every [Lc, *] product.
//
//  1. C B^T once per block: C and B are staged through shared memory 16
//     state columns at a time, the next 16 loaded into registers while the
//     current ones are multiplied; thread (tr, tc) accumulates the entries
//     (tr + 16 r, tc + 16 c) for c <= r only, the blocks of 16 x 16 that hold
//     a causal entry (36 of 64 accumulators), and writes them to sCB
//     [Lc][Lc + 1] in shared memory (66 KB in float32 at Lc = 128).
//  2. Per head of the group, in steps of 16 keys j: the block forms
//     W[i][j] = cb_ij * exp(a_cs_i - a_cs_j) * dt_j for j <= i (0 above the
//     diagonal) for the rows i >= the step's first key, stores x's 16 rows
//     (loaded into registers during the previous step, so the loads of one
//     step overlap the products of the last), and thread (tr, tc)
//     accumulates columns p = tc + 16 c of its rows with
//     explicit __fmaf_rn (the library is built with --fmad=false, which the
//     intrinsic ignores). Row blocks above the step are skipped, so the
//     upper triangle costs nothing. The difference a_cs_i - a_cs_j is taken
//     first and only a causal entry reaches expf: a_cs falls to ~-1e3 over a
//     chunk, so exp(a_cs_i) * exp(-a_cs_j) would overflow, and an acausal
//     difference is positive.
//
// Shared memory at Lc = 128: 84.5 KB (P <= 64), so two blocks share an SM
// (__launch_bounds__(256, 2)). B and C do not depend on the head, so a block
// owning more heads reuses C B^T more; the launch splits the H heads into
// as many groups as keep B * Nc * groups within one wave of two blocks per
// SM (mamba2-130m at batch 4, 2048 tokens: 64 chunks, 4 groups of 6 heads,
// 256 blocks on 132 SMs). Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kRowBlocks = 8;  // rows tr + 16 r, r < 8: Lc <= 128
constexpr int kMaxLc = 16 * kRowBlocks;
constexpr int kNK = 16;        // state columns staged per step of C B^T
constexpr int kJB = 16;        // keys per step of W @ x (one row block)

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Floats of shared memory: sCB [lc][lc + 1], a_cs and dt of one head [lc]
// each, then a stage used first by C and B [lc][kNK + 1] each, later by W
// [lc][kJB + 1] and x [kJB][16 * cpt].
__host__ __device__ inline int smem_floats(int lc, int cpt) {
  const int cb_stage = 2 * lc * (kNK + 1);
  const int wx_stage = lc * (kJB + 1) + kJB * 16 * cpt;
  return lc * (lc + 1) + 2 * lc + (cb_stage > wx_stage ? cb_stage : wx_stage);
}

template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_intra_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                     const T* __restrict__ acs, const T* __restrict__ bm,
                     const T* __restrict__ cm, T* __restrict__ y, int nc,
                     int lc, int H, int P, int N, int heads_per_block) {
  constexpr int LDX = 16 * CPT;  // x stage row stride, zero past P
  constexpr int kCBPer = kMaxLc * kNK / kThreads;  // C, B values a thread
  constexpr int kXPer = kJB * LDX / kThreads;      // stages, x values
  extern __shared__ float4 smem4[];
  float* sCB = reinterpret_cast<float*>(smem4);
  const int ldcb = lc + 1;
  float* sA = sCB + lc * ldcb;
  float* sD = sA + lc;
  float* stage = sD + lc;

  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;
  // the chunk's first row in the [B * Nc * Lc] row space
  const long long row0 =
      (static_cast<long long>(blockIdx.z) * nc + blockIdx.y) * lc;
  const int h_lo = blockIdx.x * heads_per_block;
  const int h_hi = min(H, h_lo + heads_per_block);

  // 1. C B^T, the blocks (r, c <= r) of 16 x 16. The next stage's C and B
  //    are loaded into registers while the current one is multiplied.
  {
    float* sC = stage;
    float* sB = stage + lc * (kNK + 1);
    float cr[kCBPer], br[kCBPer];
    auto load_cb = [&](int n0) {
#pragma unroll
      for (int k = 0; k < kCBPer; ++k) {
        const int e = tid + k * kThreads, i = e / kNK, n = n0 + e % kNK;
        const bool ok = i < lc && n < N;
        const long long off = (row0 + i) * N + n;
        cr[k] = ok ? widen(cm[off]) : 0.f;
        br[k] = ok ? widen(bm[off]) : 0.f;
      }
    };
    float acc[kRowBlocks][kRowBlocks];
#pragma unroll
    for (int r = 0; r < kRowBlocks; ++r) {
#pragma unroll
      for (int c = 0; c < kRowBlocks; ++c) acc[r][c] = 0.f;
    }
    int ri[kRowBlocks], ci[kRowBlocks];  // rows read, clamped into the chunk
#pragma unroll
    for (int r = 0; r < kRowBlocks; ++r) {
      ri[r] = min(tr + 16 * r, lc - 1) * (kNK + 1);
      ci[r] = min(tc + 16 * r, lc - 1) * (kNK + 1);
    }
    load_cb(0);
    for (int n0 = 0; n0 < N; n0 += kNK) {
      __syncthreads();  // the last stage is consumed
#pragma unroll
      for (int k = 0; k < kCBPer; ++k) {
        const int e = tid + k * kThreads, i = e / kNK, nn = e % kNK;
        if (i < lc) {
          sC[i * (kNK + 1) + nn] = cr[k];
          sB[i * (kNK + 1) + nn] = br[k];
        }
      }
      __syncthreads();
      if (n0 + kNK < N) load_cb(n0 + kNK);
#pragma unroll 4
      for (int nn = 0; nn < kNK; ++nn) {
        float cv[kRowBlocks], bv[kRowBlocks];
#pragma unroll
        for (int r = 0; r < kRowBlocks; ++r) {
          cv[r] = sC[ri[r] + nn];
          bv[r] = sB[ci[r] + nn];
        }
#pragma unroll
        for (int r = 0; r < kRowBlocks; ++r) {
          if (16 * r >= lc) continue;
#pragma unroll
          for (int c = 0; c <= r; ++c) {
            acc[r][c] = __fmaf_rn(cv[r], bv[c], acc[r][c]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowBlocks; ++r) {
      const int i = tr + 16 * r;
#pragma unroll
      for (int c = 0; c <= r; ++c) {
        const int j = tc + 16 * c;
        if (i < lc && j < lc) sCB[i * ldcb + j] = acc[r][c];
      }
    }
  }

  // 2. Per head: y = W @ x in steps of kJB keys, over the (head, step)
  //    pairs of the group; the next pair's x rows (and, at a head's first
  //    step, its a_cs and dt) are loaded into registers during the current
  //    pair's product.
  float* sW = stage;
  float* sX = stage + lc * (kJB + 1);
  const int n_steps = (lc + kJB - 1) / kJB;
  const int n_pairs = (h_hi - h_lo) * n_steps;
  int wi[kRowBlocks];  // W rows read, clamped into the chunk
#pragma unroll
  for (int r = 0; r < kRowBlocks; ++r) {
    wi[r] = min(tr + 16 * r, lc - 1) * (kJB + 1);
  }
  // thread tid < 128 carries a_cs of row tid, the others dt of row tid-128
  const int a_row = tid & (kMaxLc - 1);
  const T* a_src = tid < kMaxLc ? acs : dt;
  float* a_dst = tid < kMaxLc ? sA : sD;
  float xr[kXPer], ar = 0.f;
  auto load_pair = [&](int t) {
    const int h = h_lo + t / n_steps, j0 = (t % n_steps) * kJB;
#pragma unroll
    for (int k = 0; k < kXPer; ++k) {
      const int e = tid + k * kThreads, p = e % LDX, j = j0 + e / LDX;
      xr[k] = (j < lc && p < P) ? widen(x[((row0 + j) * H + h) * P + p])
                                : 0.f;
    }
    if (j0 == 0 && a_row < lc) ar = widen(a_src[(row0 + a_row) * H + h]);
  };
  if (n_pairs > 0) load_pair(0);
  float acc[kRowBlocks][CPT];
#pragma unroll
  for (int r = 0; r < kRowBlocks; ++r) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;
  }
  for (int t = 0; t < n_pairs; ++t) {
    const int h = h_lo + t / n_steps, step = t % n_steps, j0 = step * kJB;
    __syncthreads();  // sCB is written; the last pair's stage is consumed
    if (step == 0 && a_row < lc) a_dst[a_row] = ar;
#pragma unroll
    for (int k = 0; k < kXPer; ++k) sX[tid + k * kThreads] = xr[k];
    if (step == 0) __syncthreads();  // the head's a_cs and dt are in
    // W for the rows i >= j0 (the rows above have no key j <= i here).
    for (int e = tid; e < (lc - j0) * kJB; e += kThreads) {
      const int i = j0 + e / kJB, jj = e % kJB, j = j0 + jj;
      float w = 0.f;
      if (j <= i) w = sCB[i * ldcb + j] * expf(sA[i] - sA[j]) * sD[j];
      sW[i * (kJB + 1) + jj] = w;
    }
    __syncthreads();
    if (t + 1 < n_pairs) load_pair(t + 1);
#pragma unroll 4
    for (int jj = 0; jj < kJB; ++jj) {
      float xv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) xv[c] = sX[jj * LDX + tc + 16 * c];
#pragma unroll
      for (int r = 0; r < kRowBlocks; ++r) {
        if (r < step || 16 * r >= lc) continue;  // no causal key / no row
        const float w = sW[wi[r] + jj];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          acc[r][c] = __fmaf_rn(w, xv[c], acc[r][c]);
        }
      }
    }
    if (step == n_steps - 1) {  // the head is done: write y, restart
#pragma unroll
      for (int r = 0; r < kRowBlocks; ++r) {
        const int i = tr + 16 * r;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int p = tc + 16 * c;
          if (i < lc && p < P) put(y + ((row0 + i) * H + h) * P + p,
                                   acc[r][c]);
          acc[r][c] = 0.f;
        }
      }
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        sms <= 0) {
      sms = 132;
    }
  }
  return sms;
}

template <typename T, int CPT>
int launch_ssd(const T* x, const T* dt, const T* acs, const T* bm,
               const T* cm, T* y, long long B, int nc, int lc, int H, int P,
               int N, void* stream) {
  const size_t smem = sizeof(float) * smem_floats(lc, CPT);
  auto kern = ssd_intra_kernel<T, CPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // As many head groups as keep the grid within one wave of 2 blocks/SM.
  const long long chunks = B * nc;
  long long groups = 2LL * sm_count() / chunks;
  if (groups > H) groups = H;
  if (groups < 1) groups = 1;
  const int per_block = static_cast<int>((H + groups - 1) / groups);
  groups = (H + per_block - 1) / per_block;
  const dim3 grid(static_cast<unsigned>(groups), static_cast<unsigned>(nc),
                  static_cast<unsigned>(B));
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, dt, acs, bm, cm, y, nc, lc, H, P, N, per_block);
  return static_cast<int>(cudaGetLastError());
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
  if (P <= 16) return launch_ssd<T, 1>(x, dt, acs, bm, cm, y, B, nc, lc, H,
                                       P, N, stream);
  if (P <= 32) return launch_ssd<T, 2>(x, dt, acs, bm, cm, y, B, nc, lc, H,
                                       P, N, stream);
  if (P <= 64) return launch_ssd<T, 4>(x, dt, acs, bm, cm, y, B, nc, lc, H,
                                       P, N, stream);
  return launch_ssd<T, 8>(x, dt, acs, bm, cm, y, B, nc, lc, H, P, N, stream);
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
