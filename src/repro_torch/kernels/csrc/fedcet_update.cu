// FedCET update kernels for Hopper (sm_90a), with a plain C interface that
// kernels/fedcet_update.py loads through ctypes.
//
// fedcet_v replaces the TPU kernel fedcet_v_2d
// (src/repro/kernels/fedcet_update.py:39, body :32):
//     v = x - alpha*g - alpha*d
// fedcet_comm replaces fedcet_comm_2d (:147, body :55) and, with a
// non-null v, fedcet_comm4_2d (:70, body :63):
//     delta = m - m_bar;  d' = d + c*delta;  x' = v - (c*alpha)*delta
// (the 3-operand form takes v = m).
//
// Both are bound by device-memory bandwidth: a few flops per element
// against 3 reads + 1 write (fedcet_v: 16 B/element in f32, 32 in f64)
// and 2 or 3 client-sized reads, one shared m_bar read and 2 writes
// (fedcet_comm: (4 + 1/C)*4 B or (5 + 1/C)*4 B per client element in
// f32). What the design does about it: one pass over flat memory,
// 16-byte vector loads and stores where every pointer is aligned, a
// grid-stride loop over a grid sized to the SMs, and in fedcet_comm each
// thread owns a column of m_bar and walks the C clients under it, so the
// broadcast [1, P] mean is read from device memory once, never expanded
// to [C, P]. The [rows, 1024] tiling of the TPU kernels existed for the
// TPU lanes and has no counterpart here.
//
// Build with --fmad=false: the kernels then round each product and each
// difference once, like the plain PyTorch expression, and agree with it
// bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// 16 bytes of T: one vector load or store.
template <typename T>
struct alignas(16) Pack {
  static constexpr int kWidth = 16 / sizeof(T);
  T v[kWidth];
};

int grid_for(long long work) {
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

template <typename T>
__global__ void fedcet_v_kernel(const T* __restrict__ x,
                                const T* __restrict__ g,
                                const T* __restrict__ d, T* __restrict__ out,
                                T alpha, long long n, bool vec) {
  using P = Pack<T>;
  constexpr int W = P::kWidth;
  const long long tid = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long head = 0;
  if (vec) {
    const long long nv = n / W;
    const P* xv = reinterpret_cast<const P*>(x);
    const P* gv = reinterpret_cast<const P*>(g);
    const P* dv = reinterpret_cast<const P*>(d);
    P* ov = reinterpret_cast<P*>(out);
    for (long long i = tid; i < nv; i += stride) {
      const P a = xv[i], b = gv[i], e = dv[i];
      P o;
#pragma unroll
      for (int k = 0; k < W; ++k) o.v[k] = a.v[k] - alpha * b.v[k] - alpha * e.v[k];
      ov[i] = o;
    }
    head = nv * W;
  }
  for (long long i = head + tid; i < n; i += stride) {
    out[i] = x[i] - alpha * g[i] - alpha * d[i];
  }
}

// d, m, v, d_out, x_out: [clients, p]; m_bar: [p].
template <typename T, bool kHasV>
__global__ void fedcet_comm_kernel(const T* __restrict__ d,
                                   const T* __restrict__ m,
                                   const T* __restrict__ m_bar,
                                   const T* __restrict__ v,
                                   T* __restrict__ d_out,
                                   T* __restrict__ x_out, T c, T ca,
                                   long long clients, long long p, bool vec) {
  using P = Pack<T>;
  constexpr int W = P::kWidth;
  const long long tid = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  if (vec) {
    const long long pv = p / W;
    for (long long j = tid; j < pv; j += stride) {
      const P mb = reinterpret_cast<const P*>(m_bar)[j];
      for (long long k = 0; k < clients; ++k) {
        const long long o = (k * p) / W + j;
        const P dd = reinterpret_cast<const P*>(d)[o];
        const P mm = reinterpret_cast<const P*>(m)[o];
        const P vv = kHasV ? reinterpret_cast<const P*>(v)[o] : mm;
        P od, ox;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const T delta = mm.v[w] - mb.v[w];
          od.v[w] = dd.v[w] + c * delta;
          ox.v[w] = vv.v[w] - ca * delta;
        }
        reinterpret_cast<P*>(d_out)[o] = od;
        reinterpret_cast<P*>(x_out)[o] = ox;
      }
    }
    return;
  }
  for (long long j = tid; j < p; j += stride) {
    const T mb = m_bar[j];
    for (long long k = 0; k < clients; ++k) {
      const long long o = k * p + j;
      const T delta = m[o] - mb;
      d_out[o] = d[o] + c * delta;
      x_out[o] = (kHasV ? v[o] : m[o]) - ca * delta;
    }
  }
}

template <typename T>
int launch_v(const T* x, const T* g, const T* d, T* out, T alpha, long long n,
             int vec, void* stream) {
  const long long work = vec ? n / Pack<T>::kWidth + n % Pack<T>::kWidth : n;
  fedcet_v_kernel<T><<<grid_for(work), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      x, g, d, out, alpha, n, vec != 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_comm(const T* d, const T* m, const T* m_bar, const T* v, T* d_out,
                T* x_out, T c, T ca, long long clients, long long p, int vec,
                void* stream) {
  const long long work = vec ? p / Pack<T>::kWidth : p;
  const int grid = grid_for(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v != nullptr) {
    fedcet_comm_kernel<T, true><<<grid, kThreads, 0, s>>>(
        d, m, m_bar, v, d_out, x_out, c, ca, clients, p, vec != 0);
  } else {
    fedcet_comm_kernel<T, false><<<grid, kThreads, 0, s>>>(
        d, m, m_bar, v, d_out, x_out, c, ca, clients, p, vec != 0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point launches on `stream` (PyTorch's current stream), does
// not synchronise, and returns cudaGetLastError() of the launch.
extern "C" {

int fedcet_v_f32(const float* x, const float* g, const float* d, float* out,
                 float alpha, long long n, int vec, void* stream) {
  return launch_v<float>(x, g, d, out, alpha, n, vec, stream);
}

int fedcet_v_f64(const double* x, const double* g, const double* d,
                 double* out, double alpha, long long n, int vec,
                 void* stream) {
  return launch_v<double>(x, g, d, out, alpha, n, vec, stream);
}

int fedcet_comm_f32(const float* d, const float* m, const float* m_bar,
                    const float* v, float* d_out, float* x_out, float c,
                    float ca, long long clients, long long p, int vec,
                    void* stream) {
  return launch_comm<float>(d, m, m_bar, v, d_out, x_out, c, ca, clients, p,
                            vec, stream);
}

int fedcet_comm_f64(const double* d, const double* m, const double* m_bar,
                    const double* v, double* d_out, double* x_out, double c,
                    double ca, long long clients, long long p, int vec,
                    void* stream) {
  return launch_comm<double>(d, m, m_bar, v, d_out, x_out, c, ca, clients, p,
                             vec, stream);
}

}  // extern "C"
