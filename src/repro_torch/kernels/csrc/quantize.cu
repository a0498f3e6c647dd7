// The dithered fixed-point quantize round-trip for Hopper (sm_90a), with a
// plain C interface that kernels/quantize.py loads through ctypes.
//
// stochastic_quantize replaces the TPU kernel stochastic_quantize_2d
// (src/repro/kernels/quantize.py:49, pallas_call :59): one scale per leaf.
// stochastic_quantize_rows replaces stochastic_quantize_rows_2d (:77,
// pallas_call :90): a scale per 1024-lane row of the packed arena. Both:
//     out = s * clip(floor(a * (s > 0 ? 1/s : 0) + u), -L, L),
//     L = 2^(bits-1) - 1.
//
// a and out are [C, P] (C clients of a stacked leaf or arena). The dither u
// is either client-shared, [P] (the default StochasticQuant), or
// per-client, [C, P] (pq<b>). The scale is a device pointer (never read
// back to the host): one value, or one per row of `lanes` columns.
//
// Bound: device-memory bandwidth. A few flops per element against a read
// and a write per client element plus one shared dither read per column:
// (2C + 1) P elements (3 C P with a per-client dither). The reference's
// wrapper materializes broadcast_to(u, a.shape) (compressors.py:356-357,
// :399-404), 3 C P; here each thread owns a column of the shared dither,
// loads it once and walks the C clients under it, so the broadcast is never
// written. 16-byte vector loads and stores where every pointer is aligned
// and the row length allows; a grid-stride loop over a grid sized to the
// SMs.
//
// Build with --fmad=false: a*inv + u then rounds twice, like the plain
// PyTorch expression, and the kernel agrees with it bit for bit.

#include "common.cuh"

namespace {

using repro::Vec;

template <typename T, int W>
__global__ void quantize_kernel(const T* __restrict__ a,
                                const T* __restrict__ u,
                                const T* __restrict__ scale,
                                T* __restrict__ out, T levels,
                                long long clients, long long p,
                                long long lanes, bool u_per_client) {
  const long long tid = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long columns = p / W;
  const T s_one = lanes == 0 ? scale[0] : T(0);
  for (long long jv = tid; jv < columns; jv += stride) {
    const long long j = jv * W;
    const T s = lanes == 0 ? s_one : scale[j / lanes];
    const T inv = repro::inverse_scale(s);
    Vec<T, W> uu;
    if (!u_per_client) uu = repro::load<T, W>(u, j);
    for (long long k = 0; k < clients; ++k) {
      const long long o = k * p + j;
      const Vec<T, W> aa = repro::load<T, W>(a, o);
      if (u_per_client) uu = repro::load<T, W>(u, o);
      Vec<T, W> oo;
#pragma unroll
      for (int l = 0; l < W; ++l) {
        oo.v[l] = repro::quant_code(aa.v[l], inv, uu.v[l], levels) * s;
      }
      repro::store<T, W>(out, o, oo);
    }
  }
}

template <typename T>
int launch_quantize(const T* a, const T* u, const T* scale, T* out, int bits,
                    long long clients, long long p, long long lanes,
                    int u_per_client, int vec, void* stream) {
  constexpr int W = repro::kVecWidth<T>;
  const T levels = repro::levels_of<T>(bits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    quantize_kernel<T, W><<<repro::grid_for(p / W), repro::kThreads, 0, s>>>(
        a, u, scale, out, levels, clients, p, lanes, u_per_client != 0);
  } else {
    quantize_kernel<T, 1><<<repro::grid_for(p), repro::kThreads, 0, s>>>(
        a, u, scale, out, levels, clients, p, lanes, u_per_client != 0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point launches on `stream` (PyTorch's current stream), does
// not synchronise, and returns cudaGetLastError() of the launch. lanes = 0
// selects the single scale; vec requires 16-byte aligned pointers and p
// (and lanes) a multiple of the vector width.
extern "C" {

int stochastic_quantize_f32(const float* a, const float* u, const float* scale,
                            float* out, int bits, long long clients,
                            long long p, long long lanes, int u_per_client,
                            int vec, void* stream) {
  return launch_quantize<float>(a, u, scale, out, bits, clients, p, lanes,
                                u_per_client, vec, stream);
}

int stochastic_quantize_f64(const double* a, const double* u,
                            const double* scale, double* out, int bits,
                            long long clients, long long p, long long lanes,
                            int u_per_client, int vec, void* stream) {
  return launch_quantize<double>(a, u, scale, out, bits, clients, p, lanes,
                                 u_per_client, vec, stream);
}

}  // extern "C"
