// Helpers shared by the port's kernels: launch geometry, 16-byte vector
// loads and stores, the dithered quantizer code (fedcet_update.cu,
// quantize.cu, gossip_reduce.cu), asynchronous copies into shared memory
// (gossip_reduce.cu, flash_attention.cu, ssd_intra.cu) and the tensor-core
// products of flash_attention.cu and ssd_intra.cu.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace repro {

constexpr int kThreads = 256;

// W values of T in one aligned load or store (16 bytes when W = 16/sizeof(T),
// a plain scalar when W = 1).
template <typename T, int W>
struct alignas(sizeof(T) * W) Vec {
  T v[W];
};

template <typename T>
constexpr int kVecWidth = 16 / static_cast<int>(sizeof(T));

template <typename T, int W>
__device__ __forceinline__ Vec<T, W> load(const T* p, long long i) {
  return *reinterpret_cast<const Vec<T, W>*>(p + i);
}

template <typename T, int W>
__device__ __forceinline__ void store(T* p, long long i, const Vec<T, W>& x) {
  *reinterpret_cast<Vec<T, W>*>(p + i) = x;
}

// The card's streaming multiprocessors (132 on an H100 SXM where the
// query fails).
inline int sm_count() {
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

// A grid sized to the SMs (16 blocks each) for a grid-stride loop over
// `work` items.
inline int grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = 16LL * sm_count();
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<int>(blocks);
}

__device__ __forceinline__ float floor_of(float x) { return floorf(x); }
__device__ __forceinline__ double floor_of(double x) { return ::floor(x); }

// 1/s, or 0 for a zero scale (a constant-zero leaf quantizes to 0).
template <typename T>
__device__ __forceinline__ T inverse_scale(T s) {
  return s > T(0) ? T(1) / s : T(0);
}

// clip(floor(a*inv + u), -levels, levels): the dithered fixed-point code.
// The comparisons (not fmin/fmax) let a NaN through, as torch.clamp does.
template <typename T>
__device__ __forceinline__ T quant_code(T a, T inv, T u, T levels) {
  const T q = floor_of(a * inv + u);
  return q < -levels ? -levels : (q > levels ? levels : q);
}

template <typename T>
__host__ __device__ __forceinline__ T levels_of(int bits) {
  return static_cast<T>((1 << (bits - 1)) - 1);
}

// ------------------------------------------------ copies into shared memory
// N (4, 8 or 16) bytes from device memory to shared memory, left in flight;
// fill = false writes N zero bytes and reads nothing (src must still be a
// valid address). 16 bytes bypass L1 (.cg).
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
                 "l"(src), "r"(fill ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(s),
                 "l"(src), "n"(N), "r"(fill ? N : 0));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight;
// its own completed copies are then visible to it (to other threads only
// after a barrier).
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ------------------------------------------------------------ tensor cores
// v rounded to TF32 (10 mantissa bits) to nearest, ties away from zero:
// the value of cvt.rna.tf32.f32 for every finite v and for an infinity, in
// two integer operations (half a unit of the 13 dropped bits added to the
// magnitude, then the 13 bits cleared), which issue at several times the
// conversion instruction's rate on an H100. A NaN need not stay a NaN here
// (one whose payload lies only in the 13 low bits becomes an infinity; one
// whose 10 high payload bits are all set can carry into the sign and become
// a zero); split() keeps it a NaN in lo = v - hi, so every product of a NaN
// operand is still NaN.
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo, both TF32 values (hi rounded: an mma fed raw float32 bits
// would truncate them; lo = v - hi, which the mma reads to its 10 top
// mantissa bits); for a bfloat16 operand (exact) lo is 0.
template <bool kExact>
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  if (kExact) {
    hi = __float_as_uint(v);
    lo = 0u;
  } else {
    hi = tf32(v);
    lo = __float_as_uint(v - __uint_as_float(hi));
  }
}

// d += a b over one m16n8k8 TF32 tile, float32 accumulators. Fragments
// (g = lane / 4, t = lane % 4): a = (row g, k t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4); b = (k t, n g), (k t + 4, n g); d = (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mma_tf32 where `on` (warp-uniform): a predicated instruction, not a
// branch, so that a loop over tiles stays one block of independent products
// that the compiler can interleave (a branch per tile would leave a chain of
// three dependent products per block).
__device__ __forceinline__ void mma_if(bool on, float (&d)[4],
                                       const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %10, 0;\n\t"
      "@p mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(static_cast<int>(on)));
}

// d += a b over one m16n8k16 bfloat16 tile, float32 accumulators. Each
// register holds two bfloat16 values of consecutive k (the lower k in the
// low half): a = (row g, k 2t..2t+1), (g + 8, 2t..), (g, 2t+8..2t+9),
// (g + 8, 2t+8..); b = (k 2t..2t+1, n g), (k 2t+8..2t+9, n g); d as in
// mma_tf32.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 matrices of 16-bit values from shared memory, transposed:
// lane i gives the address of row i % 8 of matrix i / 8 (16 aligned bytes);
// register m of lane (g, t) receives rows 2t and 2t + 1 of column g of
// matrix m (the lower row in the low half).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

}  // namespace repro
