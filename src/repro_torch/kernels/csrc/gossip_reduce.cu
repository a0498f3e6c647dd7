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
// once and writes the output ((R + n) D elements): at path E's 8-client
// arena [8, 107006976] in float32, 6.85 GB, 2.044 ms at 3.35 TB/s.
//
// Two routes, chosen by shape in launch_gossip_reduce:
//
//  * Column-owning (where all R source rows of a column tile fit in shared
//    memory, as on the main path, R = n = 8): a block of 256 threads owns
//    a tile of 256 16-byte vectors of columns (scalars where the operands
//    are not 16-byte granular) and walks such tiles grid-stride. Each
//    thread copies its vector of all R rows into shared memory by cp.async
//    (R copies in flight), waits for its own copies, and then for every
//    node i in turn writes out[i, its columns] from the rows the node's
//    table names. So each source element is read once from device memory;
//    a thread reads only the columns it copied, so no barrier is needed
//    between tiles. The index, weight and denominator tables are read once
//    per block into shared memory.
//  * Node-owning (larger tables: many rows, or a table past shared
//    memory): one thread owns a 16-byte vector of a column tile of one
//    node and walks that node's S slots, reading S source rows per output
//    element ((S + 1) n D elements); the node's S indices and weights are
//    read once per block into shared memory (from global memory when they
//    do not fit in 48 KB).
//
// Both write no [n*S, D] contribution tensor (the reference's schedule
// moves ~2.5x more), use 64-bit offsets (idx * D exceeds 2^31 at more than
// 20 clients of fedlm-100m), and run 16-byte vector loads only where every
// pointer is 16-byte aligned and D is a multiple of the vector width.

#include "common.cuh"

namespace {

using repro::Vec;

constexpr long long kSmemLimit = 48 * 1024;
constexpr int kColThreads = 256;

// Bytes of shared memory the column-owning route needs: a tile of `rows`
// rows of kColThreads * w values, the weights and denominators, the
// indices (as int).
inline long long column_smem(long long n, long long slots, long long rows,
                             int size, int w) {
  return rows * kColThreads * w * size + (n * slots + n) * size +
         n * slots * static_cast<long long>(sizeof(int));
}

// The shared memory a block may use (232,448 bytes on an H100).
inline long long smem_optin() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess ||
        bytes <= 0) {
      bytes = 48 * 1024;
    }
  }
  return bytes;
}

// The most source rows the column-owning route takes for this table.
inline long long column_rows(long long n, long long slots, int size, int vec) {
  const int w = vec ? 16 / size : 1;
  const long long table = column_smem(n, slots, 0, size, w);
  const long long per_row = static_cast<long long>(kColThreads) * w * size;
  return smem_optin() > table ? (smem_optin() - table) / per_row : 0;
}

template <typename T, int W>
__global__ void __launch_bounds__(kColThreads)
    gossip_columns_kernel(const T* __restrict__ src,
                          const long long* __restrict__ idx,
                          const T* __restrict__ wgt,
                          const T* __restrict__ denom, T* __restrict__ out,
                          int n, int slots, int rows, long long d) {
  constexpr int TW = kColThreads * W;  // columns of a tile
  extern __shared__ float4 smem4[];
  T* tile = reinterpret_cast<T*>(smem4);  // [rows][TW]
  T* s_wgt = tile + static_cast<long long>(rows) * TW;
  T* s_den = s_wgt + n * slots;
  int* s_idx = reinterpret_cast<int*>(s_den + n);
  const int tid = threadIdx.x;
  for (int e = tid; e < n * slots; e += kColThreads) {
    s_idx[e] = static_cast<int>(idx[e]);
    s_wgt[e] = wgt[e];
  }
  for (int i = tid; i < n; i += kColThreads) {
    s_den[i] = denom == nullptr ? T(1) : denom[i];
  }
  __syncthreads();
  T* mine = tile + tid * W;
  const long long tiles = (d + TW - 1) / TW;
  for (long long tt = blockIdx.x; tt < tiles; tt += gridDim.x) {
    const long long j = tt * TW + static_cast<long long>(tid) * W;
    const bool in = j < d;  // W > 1: d is a multiple of W
    for (int r = 0; r < rows; ++r) {
      repro::cp_async<sizeof(T) * W>(mine + r * TW, in ? src + r * d + j : src,
                                     in);
    }
    repro::cp_async_commit();
    repro::cp_async_wait<0>();  // this thread's copies are in
    if (!in) continue;
    for (int i = 0; i < n; ++i) {
      const int* ti = s_idx + i * slots;
      const T* tw = s_wgt + i * slots;
      const Vec<T, W> x0 = *reinterpret_cast<const Vec<T, W>*>(mine +
                                                               ti[0] * TW);
      const T w0 = tw[0];
      Vec<T, W> acc;
#pragma unroll
      for (int l = 0; l < W; ++l) acc.v[l] = w0 * x0.v[l];
      for (int s = 1; s < slots; ++s) {
        const Vec<T, W> xs = *reinterpret_cast<const Vec<T, W>*>(
            mine + ti[s] * TW);
        const T ws = tw[s];
#pragma unroll
        for (int l = 0; l < W; ++l) acc.v[l] = acc.v[l] + ws * xs.v[l];
      }
      if (denom != nullptr) {
        const T den = s_den[i];
#pragma unroll
        for (int l = 0; l < W; ++l) acc.v[l] = acc.v[l] / den;
      }
      repro::store<T, W>(out, i * d + j, acc);
    }
  }
}

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

// Blocks of one instantiation an SM holds at `smem` bytes. The shared
// memory limit is raised once to what a block may use, and the occupancy
// kept for the last size asked (a run of rounds asks the same size again),
// so that a small call pays no host query.
template <typename T, int W>
cudaError_t columns_per_sm(long long smem, int* per_sm) {
  static const cudaError_t raised = cudaFuncSetAttribute(
      gossip_columns_kernel<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_optin()));
  static long long last_smem = -1;
  static int last_per_sm = 0;
  if (raised != cudaSuccess) return raised;
  if (smem != last_smem) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &last_per_sm, gossip_columns_kernel<T, W>, kColThreads, smem);
    if (err != cudaSuccess) return err;
    last_smem = smem;
  }
  *per_sm = last_per_sm;
  return cudaSuccess;
}

template <typename T, int W>
int launch_columns(const T* src, const long long* idx, const T* wgt,
                   const T* denom, T* out, long long n, long long slots,
                   long long rows, long long d, cudaStream_t s) {
  const long long smem = column_smem(n, slots, rows, sizeof(T), W);
  auto kern = gossip_columns_kernel<T, W>;
  int per_sm = 0;
  const cudaError_t err = columns_per_sm<T, W>(smem, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (d + kColThreads * W - 1) / (kColThreads * W);
  long long blocks = static_cast<long long>(per_sm > 0 ? per_sm : 1) *
                     repro::sm_count();
  if (blocks > tiles) blocks = tiles;
  kern<<<static_cast<unsigned>(blocks), kColThreads, smem, s>>>(
      src, idx, wgt, denom, out, static_cast<int>(n), static_cast<int>(slots),
      static_cast<int>(rows), d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gossip_reduce(const T* src, const long long* idx, const T* wgt,
                         const T* denom, T* out, long long n, long long slots,
                         long long rows, long long d, int vec, void* stream) {
  constexpr int W = repro::kVecWidth<T>;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= column_rows(n, slots, sizeof(T), vec)) {
    return vec ? launch_columns<T, W>(src, idx, wgt, denom, out, n, slots,
                                      rows, d, s)
               : launch_columns<T, 1>(src, idx, wgt, denom, out, n, slots,
                                      rows, d, s);
  }
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
// not synchronise, and returns cudaGetLastError() of the launch. src is
// [rows, d]; denom may be null (no division). idx must hold row indices of
// src in [0, rows); vec requires 16-byte aligned src and out and d a
// multiple of the vector width.
extern "C" {

int gossip_reduce_f32(const float* src, const long long* idx,
                      const float* wgt, const float* denom, float* out,
                      long long n, long long slots, long long rows,
                      long long d, int vec, void* stream) {
  return launch_gossip_reduce<float>(src, idx, wgt, denom, out, n, slots,
                                     rows, d, vec, stream);
}

int gossip_reduce_f64(const double* src, const long long* idx,
                      const double* wgt, const double* denom, double* out,
                      long long n, long long slots, long long rows,
                      long long d, int vec, void* stream) {
  return launch_gossip_reduce<double>(src, idx, wgt, denom, out, n, slots,
                                      rows, d, vec, stream);
}

// The most source rows for which an [n, slots] table of elements of `size`
// bytes takes the column-owning route (vec: 16-byte vectors).
long long gossip_reduce_column_rows(long long n, long long slots, int size,
                                    int vec) {
  return column_rows(n, slots, size, vec);
}

}  // extern "C"
