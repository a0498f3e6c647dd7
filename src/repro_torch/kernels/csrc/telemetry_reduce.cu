// The telemetry client sketch for Hopper (sm_90a), with a plain C interface
// that kernels/telemetry_reduce.py loads through ctypes.
//
// It replaces the TPU kernel client_sketch_2d
// (src/repro/kernels/telemetry_reduce.py:82, pallas_call :93): per client,
// the squared L2 norm over the flattened client store, and a log10
// histogram of the norms,
//
//     sq[i]   = sum_j x[i, j]^2
//     v       = sqrt(sq[i])
//     logs    = v > 0 ? log10(v) : lo
//     idx     = clip(floor((logs - lo) * scale), 0, bins - 1)
//     hist[idx] += 1                       (scale = bins / (hi - lo))
//
// x is [n, d] (the arena's [clients, rows, 1024] data viewed flat), sq [n]
// in x's type, hist [bins] int32. Every client counts: the TPU kernel's
// 8-client and 1024-lane padding (and its n_valid mask) exist for its tiles
// only.
//
// Bound: device-memory bandwidth; the kernel must read n*d elements once
// (3.42 GB at [8, 107006976] float32, 1.02 ms at 3.35 TB/s). The sum order
// is fixed, so two runs agree bit for bit and kernels/ref.py:client_sketch
// repeats it with reshapes (built with --fmad=false, every product and sum
// rounds once, as in the plain version):
//
//  1. Pass 1 splits each client's row over nblk blocks (a power of two,
//     chosen by kernels/ref.py:sketch_geometry so that n*nblk is about 1024
//     blocks: at n = 8 one block per client would fill 8 of 132 SMs). With
//     W = 16 / sizeof(T) lanes and 256 threads, thread t of block b owns
//     the lanes p = k*S + (b*256 + t)*W + l, S = nblk*256*W, and adds
//     their squares in order of k into W accumulators, one per lane l
//     (elements past d add nothing: zero padding in the plain version).
//     The loop over k issues kUnroll streaming 16-byte loads (ld.global.cs:
//     the store is read once) before it adds the first of them, so a
//     thread keeps kUnroll loads in flight; the adds still run in order of
//     k. The W lanes then reduce by a halving tree, the 256 threads by a
//     halving tree in shared memory, and the block writes one partial
//     [n, nblk]. Block (0, 0) also zeroes the histogram.
//  2. Pass 2 (one block per client) reduces the nblk partials by a halving
//     tree, writes sq, takes sqrt and log10 in x's type and bins the norm
//     with an integer atomic add (exact: the counts are integers).
//
// Two launches a call and no memset. Folding pass 2 into pass 1 behind a
// last-block ticket would need a counter that is zero before every call:
// a memset again, or state kept in the library between calls.
//
// The lane layout does not depend on how elements are loaded: 16-byte
// vector loads run where x is 16-byte aligned and d is a multiple of W,
// scalar loads with a bounds test elsewhere, in the same order. Offsets are
// 64-bit (n*d passes 2^31 at 21 clients of fedlm-100m). No float atomics.

#include "common.cuh"

namespace {

constexpr int kMaxBlocks = 1024;  // nblk limit (pass 2's shared array)
constexpr int kUnroll = 8;        // pass 1's loads in flight per thread

__device__ __forceinline__ float sqrt_of(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_of(double x) { return ::sqrt(x); }
__device__ __forceinline__ float log10_of(float x) { return log10f(x); }
__device__ __forceinline__ double log10_of(double x) { return ::log10(x); }

__device__ __forceinline__ void load_cs(const float* p, float (&v)[4]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load_cs(const double* p, double (&v)[2]) {
  const double2 q = __ldcs(reinterpret_cast<const double2*>(p));
  v[0] = q.x;
  v[1] = q.y;
}

// The W lanes from p of a row of d values: one streaming 16-byte load, or
// W scalar loads with zeros past d.
template <typename T, int W, bool kVec>
__device__ __forceinline__ void load_lanes(const T* row, long long p,
                                           long long d, T (&v)[W]) {
  if (kVec) {
    load_cs(row + p, v);
  } else {
#pragma unroll
    for (int l = 0; l < W; ++l) v[l] = p + l < d ? __ldcs(row + p + l) : T(0);
  }
}

template <typename T, int W, bool kVec>
__global__ void sketch_partials_kernel(const T* __restrict__ x,
                                       T* __restrict__ part,
                                       int* __restrict__ hist, long long n,
                                       long long d, int nblk, int bins) {
  __shared__ T s[repro::kThreads];
  const long long stride =
      static_cast<long long>(nblk) * repro::kThreads * W;
  const long long first =
      (static_cast<long long>(blockIdx.x) * repro::kThreads + threadIdx.x) *
      W;
  if (blockIdx.x == 0 && blockIdx.y == 0) {
    for (int b = threadIdx.x; b < bins; b += repro::kThreads) hist[b] = 0;
  }
  // the k's of this thread: first + k*stride < d
  const long long steps = first < d ? (d - 1 - first) / stride + 1 : 0;
  for (long long i = blockIdx.y; i < n; i += gridDim.y) {
    const T* row = x + i * d;
    T acc[W];
#pragma unroll
    for (int l = 0; l < W; ++l) acc[l] = T(0);
    long long k = 0, p = first;
    for (; k + kUnroll <= steps; k += kUnroll, p += kUnroll * stride) {
      T v[kUnroll][W];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        load_lanes<T, W, kVec>(row, p + u * stride, d, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int l = 0; l < W; ++l) acc[l] = acc[l] + v[u][l] * v[u][l];
      }
    }
    for (; k < steps; ++k, p += stride) {
      T v[W];
      load_lanes<T, W, kVec>(row, p, d, v);
#pragma unroll
      for (int l = 0; l < W; ++l) acc[l] = acc[l] + v[l] * v[l];
    }
#pragma unroll
    for (int h = W / 2; h > 0; h /= 2) {
#pragma unroll
      for (int l = 0; l < h; ++l) acc[l] = acc[l] + acc[l + h];
    }
    __syncthreads();  // the previous client's tree no longer reads s
    s[threadIdx.x] = acc[0];
    __syncthreads();
    for (int h = repro::kThreads / 2; h > 0; h /= 2) {
      if (static_cast<int>(threadIdx.x) < h) {
        s[threadIdx.x] = s[threadIdx.x] + s[threadIdx.x + h];
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) part[i * nblk + blockIdx.x] = s[0];
  }
}

template <typename T>
__global__ void sketch_finish_kernel(const T* __restrict__ part,
                                     T* __restrict__ sq,
                                     int* __restrict__ hist, long long n,
                                     int nblk, int bins, T lo, T scale) {
  __shared__ T s[kMaxBlocks];
  for (long long i = blockIdx.x; i < n; i += gridDim.x) {
    __syncthreads();  // the previous client's tree no longer reads s
    for (int j = threadIdx.x; j < nblk; j += blockDim.x) {
      s[j] = part[i * nblk + j];
    }
    __syncthreads();
    for (int h = nblk / 2; h > 0; h /= 2) {
      for (int j = threadIdx.x; j < h; j += blockDim.x) s[j] = s[j] + s[j + h];
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      const T total = s[0];
      sq[i] = total;
      const T v = sqrt_of(total);
      const T logs = v > T(0) ? log10_of(v) : lo;
      const T f = repro::floor_of((logs - lo) * scale);
      const T top = static_cast<T>(bins - 1);
      // f is never NaN (a NaN norm fails v > 0 and takes lo); the form
      // still sends one to bin 0 rather than outside hist.
      const T c = f > top ? top : (f >= T(0) ? f : T(0));
      atomicAdd(hist + static_cast<int>(c), 1);
    }
  }
}

template <typename T>
int launch_sketch(const T* x, T* part, T* sq, int* hist, long long n,
                  long long d, int nblk, int bins, T lo, T scale, int vec,
                  void* stream) {
  constexpr int W = repro::kVecWidth<T>;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nblk < 1 || nblk > kMaxBlocks || (nblk & (nblk - 1)) != 0 || bins < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) {  // no client: only the zeroed histogram
    return static_cast<int>(cudaMemsetAsync(hist, 0, sizeof(int) * bins, s));
  }
  const unsigned ny = static_cast<unsigned>(n < 65535 ? n : 65535);
  const dim3 grid(static_cast<unsigned>(nblk), ny);
  if (vec) {
    sketch_partials_kernel<T, W, true><<<grid, repro::kThreads, 0, s>>>(
        x, part, hist, n, d, nblk, bins);
  } else {
    sketch_partials_kernel<T, W, false><<<grid, repro::kThreads, 0, s>>>(
        x, part, hist, n, d, nblk, bins);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned nx = static_cast<unsigned>(n < 65535 ? n : 65535);
  sketch_finish_kernel<T><<<nx, repro::kThreads, 0, s>>>(
      part, sq, hist, n, nblk, bins, lo, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point launches on `stream` (PyTorch's current stream), does
// not synchronise, and returns the first CUDA error of its launches (0 on
// success). part is [n, nblk] scratch; hist is zeroed here (by pass 1).
// nblk must be a power of two <= 1024; vec requires a 16-byte aligned x and
// d a multiple of the vector width.
extern "C" {

int telemetry_sketch_f32(const float* x, float* part, float* sq, int* hist,
                         long long n, long long d, int nblk, int bins,
                         float lo, float scale, int vec, void* stream) {
  return launch_sketch<float>(x, part, sq, hist, n, d, nblk, bins, lo, scale,
                              vec, stream);
}

int telemetry_sketch_f64(const double* x, double* part, double* sq,
                         int* hist, long long n, long long d, int nblk,
                         int bins, double lo, double scale, int vec,
                         void* stream) {
  return launch_sketch<double>(x, part, sq, hist, n, d, nblk, bins, lo,
                               scale, vec, stream);
}

}  // extern "C"
