// Helpers shared by the port's elementwise kernels (fedcet_update.cu,
// quantize.cu): launch geometry, 16-byte vector loads and stores, and the
// dithered quantizer code.
#pragma once

#include <cuda_runtime.h>

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

// A grid sized to the SMs (16 blocks each) for a grid-stride loop over
// `work` items.
inline int grid_for(long long work) {
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
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = 16LL * sms;
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

}  // namespace repro
