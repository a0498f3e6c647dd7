// The gossip neighbor reduce for Hopper (sm_90a), with a plain C interface
// that kernels/gossip_reduce.py loads through ctypes.
//
// It replaces the TPU kernel segment_reduce_2d
// (src/repro/kernels/gossip_reduce.py:47, pallas_call :59), the fixed-slot
// segment sum of the sparse gossip lowering (src/repro/core/topology.py,
// Mixing._reduce_sparse). The reference first materializes the [n*S, D]
// contribution tensor (gather the S neighbor rows of each node, scale them
// by their weights) and the TPU kernel sums its S slots per node. This
// kernel computes the same function without the contribution tensor:
//
//     out[i, j] = (sum_{s=0..S-1} wgt[i, s] * src[idx[i, s], j]) / denom[i]
//
// src is [R, D], idx [n, S] (int64), wgt [n, S], denom [n] or null (no
// division), out [n, D]. Slots are summed in order 0..S-1 starting from the
// slot-0 product; built with --fmad=false, each product and sum rounds
// once, as in the plain PyTorch version, so the two agree bit for bit. The
// reference's contract (a segment sum over a [n*S, D] tensor) is this
// kernel with the identity table idx[i, s] = i*S + s and wgt = 1, which is
// exact (x * 1.0 == x).
//
// Bound: device-memory bandwidth. The least traffic reads each source row
// once and writes the output (2 n D elements when R = n). This simple
// design reads S rows per output element ((S + 1) n D elements): one thread
// owns a 16-byte vector of a column tile of one node and walks that node's
// S slots. A column-owning design that reads each source column once for
// all n nodes is left to a later change. What the design does keep: no
// [n*S, D] tensor is written or read (the reference's schedule moves
// ~2.5x more), the node's S indices and weights are read once per block
// into shared memory (from global memory when they do not fit in 48 KB),
// offsets are 64-bit (idx * D exceeds 2^31 at more than 20 clients of
// fedlm-100m), and 16-byte vector loads run only where every pointer is
// 16-byte aligned and D is a multiple of the vector width.

#include "common.cuh"

namespace {

using repro::Vec;

constexpr long long kSmemLimit = 48 * 1024;

template <typename T, int W>
__global__ void gossip_reduce_kernel(const T* __restrict__ src,
                                     const long long* __restrict__ idx,
                                     const T* __restrict__ wgt,
                                     const T* __restrict__ denom,
                                     T* __restrict__ out, long long n,
                                     long long slots, long long d,
                                     bool use_smem) {
  extern __shared__ long long smem[];
  long long* s_idx = smem;
  T* s_wgt = reinterpret_cast<T*>(smem + slots);
  const long long cols = d / W;
  const long long tid = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.y; i < n; i += gridDim.y) {
    const long long* ti = idx + i * slots;
    const T* tw = wgt + i * slots;
    if (use_smem) {
      __syncthreads();  // the previous node's table is no longer read
      for (long long s = threadIdx.x; s < slots; s += blockDim.x) {
        s_idx[s] = ti[s];
        s_wgt[s] = tw[s];
      }
      __syncthreads();
      ti = s_idx;
      tw = s_wgt;
    }
    const T den = denom == nullptr ? T(1) : denom[i];
    for (long long jv = tid; jv < cols; jv += stride) {
      const long long j = jv * W;
      const Vec<T, W> x0 = repro::load<T, W>(src, ti[0] * d + j);
      const T w0 = tw[0];
      Vec<T, W> acc;
#pragma unroll
      for (int l = 0; l < W; ++l) acc.v[l] = w0 * x0.v[l];
      for (long long s = 1; s < slots; ++s) {
        const Vec<T, W> xs = repro::load<T, W>(src, ti[s] * d + j);
        const T ws = tw[s];
#pragma unroll
        for (int l = 0; l < W; ++l) acc.v[l] = acc.v[l] + ws * xs.v[l];
      }
      if (denom != nullptr) {
#pragma unroll
        for (int l = 0; l < W; ++l) acc.v[l] = acc.v[l] / den;
      }
      repro::store<T, W>(out, i * d + j, acc);
    }
  }
}

template <typename T>
int launch_gossip_reduce(const T* src, const long long* idx, const T* wgt,
                         const T* denom, T* out, long long n, long long slots,
                         long long d, int vec, void* stream) {
  constexpr int W = repro::kVecWidth<T>;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long table = slots * static_cast<long long>(sizeof(long long) +
                                                         sizeof(T));
  const bool use_smem = table <= kSmemLimit;
  const size_t smem = use_smem ? static_cast<size_t>(table) : 0;
  const long long cols = vec ? d / W : d;
  // Spread the SM-sized grid over the nodes; the column loop strides.
  const long long ny = n < 65535 ? n : 65535;
  long long nx = repro::grid_for(cols);
  nx = (nx + ny - 1) / ny;
  const long long need = (cols + repro::kThreads - 1) / repro::kThreads;
  if (nx > need) nx = need;
  if (nx < 1) nx = 1;
  const dim3 grid(static_cast<unsigned>(nx), static_cast<unsigned>(ny));
  if (vec) {
    gossip_reduce_kernel<T, W><<<grid, repro::kThreads, smem, s>>>(
        src, idx, wgt, denom, out, n, slots, d, use_smem);
  } else {
    gossip_reduce_kernel<T, 1><<<grid, repro::kThreads, smem, s>>>(
        src, idx, wgt, denom, out, n, slots, d, use_smem);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point launches on `stream` (PyTorch's current stream), does
// not synchronise, and returns cudaGetLastError() of the launch. denom may
// be null (no division). idx must hold row indices of src in [0, R); vec
// requires 16-byte aligned src and out and d a multiple of the vector
// width.
extern "C" {

int gossip_reduce_f32(const float* src, const long long* idx,
                      const float* wgt, const float* denom, float* out,
                      long long n, long long slots, long long d, int vec,
                      void* stream) {
  return launch_gossip_reduce<float>(src, idx, wgt, denom, out, n, slots, d,
                                     vec, stream);
}

int gossip_reduce_f64(const double* src, const long long* idx,
                      const double* wgt, const double* denom, double* out,
                      long long n, long long slots, long long d, int vec,
                      void* stream) {
  return launch_gossip_reduce<double>(src, idx, wgt, denom, out, n, slots, d,
                                      vec, stream);
}

}  // extern "C"
