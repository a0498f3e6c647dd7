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
// fedcet_round_tail replaces fedcet_round_tail_3d (:112, pallas_call :136,
// body :91), the shift:q8 round tail over the packed arena:
//     q = clip(floor((v - h)*inv + u), -L, L);  recon = h + q*s
//     m_bar = sum_c(recon_c * w_c) / den
//     d' = d + c*(recon - m_bar);  x' = v - (c*alpha)*(recon - m_bar)
//     h' = h + beta*q*s
//
// All are bound by device-memory bandwidth: a few flops per element
// against 3 reads + 1 write (fedcet_v: 16 B/element in f32, 32 in f64),
// 2 or 3 client-sized reads, one shared m_bar read and 2 writes
// (fedcet_comm: (4 + 1/C)*4 B or (5 + 1/C)*4 B per client element in
// f32), and 3 client-sized reads, 3 writes and a shared dither read
// (fedcet_round_tail: (6 + 1/C)*4 B per client element in f32). What the
// design does about it: one pass over flat memory, 16-byte vector loads
// and stores where every pointer is aligned, a grid-stride loop over a
// grid sized to the SMs, and each thread owns a column of the shared
// operand (m_bar, or the dither and the row's scale) and walks the C
// clients under it, so nothing shared is expanded to [C, P].
//
// The round tail needs the client mean before it can write anything. The
// reduction runs over clients, inside the thread, so no block-to-block
// reduction exists: pass 1 walks the C clients to sum recon*w in client
// order (the plain version's fixed order, hence bitwise agreement), pass 2
// walks them again, recomputes the code and writes (d', x', h'). The codes
// are recomputed, not stored; pass 2's re-read of v and h comes from the
// L1/L2 lines pass 1 just brought in (a block's 256 columns x C clients x
// 2 operands x 16 B is 32 KB at C = 4). The [rows, 1024] tiling of the TPU
// kernels existed for the TPU lanes and has no counterpart here, except
// that the round tail's scale is indexed per row of `lanes` columns.
//
// Build with --fmad=false: the kernels then round each product and each
// sum once, like the plain PyTorch expression, and agree with it bit for
// bit.

#include "common.cuh"

namespace {

using repro::grid_for;
using repro::kThreads;
using repro::Vec;

template <typename T>
using Pack = Vec<T, repro::kVecWidth<T>>;

template <typename T>
__global__ void fedcet_v_kernel(const T* __restrict__ x,
                                const T* __restrict__ g,
                                const T* __restrict__ d, T* __restrict__ out,
                                T alpha, long long n, bool vec) {
  using P = Pack<T>;
  constexpr int W = repro::kVecWidth<T>;
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
  constexpr int W = repro::kVecWidth<T>;
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

// v, h, d, d_out, x_out, h_out: [clients, p]; u: [p]; scale: [p / lanes];
// w: [clients]; den: one value. Column j's scale is scale[j / lanes].
template <typename T, int W>
__global__ void round_tail_kernel(
    const T* __restrict__ v, const T* __restrict__ h, const T* __restrict__ d,
    const T* __restrict__ u, const T* __restrict__ scale,
    const T* __restrict__ w, const T* __restrict__ den, T* __restrict__ d_out,
    T* __restrict__ x_out, T* __restrict__ h_out, T c, T ca, T beta,
    T levels, long long clients, long long p, long long lanes) {
  const long long tid = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long columns = p / W;
  const T dn = *den;
  for (long long jv = tid; jv < columns; jv += stride) {
    const long long j = jv * W;
    const T s = scale[j / lanes];
    const T inv = repro::inverse_scale(s);
    const Vec<T, W> uu = repro::load<T, W>(u, j);
    // pass 1: the weighted client sum of the reconstructed message
    T acc[W] = {};
    for (long long k = 0; k < clients; ++k) {
      const long long o = k * p + j;
      const Vec<T, W> vv = repro::load<T, W>(v, o);
      const Vec<T, W> hh = repro::load<T, W>(h, o);
      const T wk = w[k];
#pragma unroll
      for (int l = 0; l < W; ++l) {
        const T q = repro::quant_code(vv.v[l] - hh.v[l], inv, uu.v[l], levels);
        const T prod = (hh.v[l] + q * s) * wk;
        acc[l] = k == 0 ? prod : acc[l] + prod;
      }
    }
    T m_bar[W];
#pragma unroll
    for (int l = 0; l < W; ++l) m_bar[l] = acc[l] / dn;
    // pass 2: recompute the codes and write (d', x', h')
    for (long long k = 0; k < clients; ++k) {
      const long long o = k * p + j;
      const Vec<T, W> vv = repro::load<T, W>(v, o);
      const Vec<T, W> hh = repro::load<T, W>(h, o);
      const Vec<T, W> dd = repro::load<T, W>(d, o);
      Vec<T, W> od, ox, oh;
#pragma unroll
      for (int l = 0; l < W; ++l) {
        const T q = repro::quant_code(vv.v[l] - hh.v[l], inv, uu.v[l], levels);
        const T qs = q * s;
        const T delta = (hh.v[l] + qs) - m_bar[l];
        od.v[l] = dd.v[l] + c * delta;
        ox.v[l] = vv.v[l] - ca * delta;
        oh.v[l] = hh.v[l] + beta * qs;
      }
      repro::store<T, W>(d_out, o, od);
      repro::store<T, W>(x_out, o, ox);
      repro::store<T, W>(h_out, o, oh);
    }
  }
}

template <typename T>
int launch_v(const T* x, const T* g, const T* d, T* out, T alpha, long long n,
             int vec, void* stream) {
  constexpr int W = repro::kVecWidth<T>;
  const long long work = vec ? n / W + n % W : n;
  fedcet_v_kernel<T><<<grid_for(work), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      x, g, d, out, alpha, n, vec != 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_comm(const T* d, const T* m, const T* m_bar, const T* v, T* d_out,
                T* x_out, T c, T ca, long long clients, long long p, int vec,
                void* stream) {
  const long long work = vec ? p / repro::kVecWidth<T> : p;
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

template <typename T>
int launch_round_tail(const T* v, const T* h, const T* d, const T* u,
                      const T* scale, const T* w, const T* den, T* d_out,
                      T* x_out, T* h_out, T c, T ca, T beta, int bits,
                      long long clients, long long p, long long lanes,
                      int vec, void* stream) {
  constexpr int W = repro::kVecWidth<T>;
  const T levels = repro::levels_of<T>(bits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    round_tail_kernel<T, W><<<grid_for(p / W), kThreads, 0, s>>>(
        v, h, d, u, scale, w, den, d_out, x_out, h_out, c, ca, beta, levels,
        clients, p, lanes);
  } else {
    round_tail_kernel<T, 1><<<grid_for(p), kThreads, 0, s>>>(
        v, h, d, u, scale, w, den, d_out, x_out, h_out, c, ca, beta, levels,
        clients, p, lanes);
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

int fedcet_round_tail_f32(const float* v, const float* h, const float* d,
                          const float* u, const float* scale, const float* w,
                          const float* den, float* d_out, float* x_out,
                          float* h_out, float c, float ca, float beta,
                          int bits, long long clients, long long p,
                          long long lanes, int vec, void* stream) {
  return launch_round_tail<float>(v, h, d, u, scale, w, den, d_out, x_out,
                                  h_out, c, ca, beta, bits, clients, p, lanes,
                                  vec, stream);
}

int fedcet_round_tail_f64(const double* v, const double* h, const double* d,
                          const double* u, const double* scale,
                          const double* w, const double* den, double* d_out,
                          double* x_out, double* h_out, double c, double ca,
                          double beta, int bits, long long clients,
                          long long p, long long lanes, int vec,
                          void* stream) {
  return launch_round_tail<double>(v, h, d, u, scale, w, den, d_out, x_out,
                                   h_out, c, ca, beta, bits, clients, p,
                                   lanes, vec, stream);
}

}  // extern "C"
