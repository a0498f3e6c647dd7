// The packed arena's dither for Hopper (sm_90a), with a plain C interface
// that kernels/threefry.py loads through ctypes.
//
// threefry_uniform_rows replaces no TPU kernel. The reference draws the
// arena's dither as one jax.random.uniform per leaf under fold_in(key, i)
// and packs the draws (src/repro/core/compressors.py:388-395); XLA fuses
// each draw's threefry into one loop. The port's eager draw
// (core/prng.py:uniform) has no fuser: it ran the 20 rounds as some 170
// int64 elementwise launches a leaf, then a copy into the arena. This
// kernel writes the whole packed dither, [planes, rows, 1024], in one
// launch, bit for bit what prng.uniform draws per leaf and
// core/arena.py:pack_rows packs:
//     (k0', k1') = threefry2x32(k0, k1, 0, ref_index)   (fold_in)
//     local = c * numel + (row - first_row) * 1024 + lane
//     (b1, b2) = threefry2x32(k0', k1', local >> 32, local & 0xFFFFFFFF)
//     float32: bits ((b1 ^ b2) >> 9) | 0x3F800000, minus 1
//     float64: bits (b1 << 20) | (b2 >> 12) | 0x3FF0000000000000, minus 1
// and 0 where the lane lies past the leaf (a pad). `local` is the row-major
// index into the leaf's (planes,) + shape draw: c is the client plane of a
// per-client dither, 0 for the client-shared one (planes = 1). The
// subtraction of 1 from a value in [1, 2) is exact, so the result does not
// depend on how it is rounded.
//
// Table (built once per layout and device, core/arena.py:leaf_table): per
// leaf in layout order its first row, its element count and its index in
// the reference's flatten order; with the row -> leaf map
// (ArenaLayout.row_segments) it is all the kernel reads besides the key,
// which comes as two 32-bit arguments, so a round copies nothing to the
// card and waits for nothing.
//
// Bound: the ALU pipe. One threefry2x32 is 20 rounds of add, rotate
// (one funnel shift) and xor, 5 key injections (one three-input add each
// word) and the key's first add: 72 32-bit operations, about 75 with the
// float. The compiler issues the shifts, the xors and some adds (about 53
// a coordinate) on the ALU pipe and the other adds as IMAD on the FMA
// pipe; each pipe takes 64 lanes a clock an SM, so 132 SMs at 1.98 GHz
// give ~3.2 ps a coordinate, against 1.2 ps (float32) or 2.4 ps (float64)
// to write it at 3.35 TB/s. What the design does about
// it: each thread owns 4 neighbouring lanes of a row, so it runs four
// independent hash chains for the schedulers to interleave, and writes
// them with one 16-byte store (two in float64); a block of 256 threads, one
// row at a time, walks a contiguous run of rows, so the leaf's key is recomputed
// only where the run crosses into another leaf, by every thread alike in
// registers: no shared memory, no barrier.

#include "common.cuh"

namespace {

using repro::Vec;

constexpr int kLanes = 1024;                  // kernels/threefry.py:LANES
constexpr int kPerThread = kLanes / repro::kThreads;  // 4
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

// The rotation of step j of round group i: (13, 15, 26, 6) in even groups,
// (17, 29, 16, 24) in odd ones; a constant once the loops are unrolled.
__host__ __device__ constexpr int rotation(int i, int j) {
  return i % 2 == 0 ? (j == 0 ? 13 : j == 1 ? 15 : j == 2 ? 26 : 6)
                    : (j == 0 ? 17 : j == 1 ? 29 : j == 2 ? 16 : 24);
}

// Threefry-2x32, 20 rounds (jax's _threefry2x32_lowering; core/prng.py).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rotation(i, j)) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

__device__ __forceinline__ float to_uniform(uint32_t b1, uint32_t b2,
                                            float) {
  return __uint_as_float(((b1 ^ b2) >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ double to_uniform(uint32_t b1, uint32_t b2,
                                             double) {
  const unsigned long long bits = (static_cast<unsigned long long>(b1) << 20) |
                                  (b2 >> 12) | 0x3FF0000000000000ull;
  return __longlong_as_double(static_cast<long long>(bits)) - 1.0;
}

template <typename T>
__global__ void threefry_uniform_rows_kernel(
    T* __restrict__ out, const long long* __restrict__ table,
    const long long* __restrict__ row_leaf, uint32_t k0, uint32_t k1,
    long long rows, long long total, long long run) {
  const long long first = blockIdx.x * run;
  const long long last = min(first + run, total);
  const int lane = threadIdx.x * kPerThread;
  long long leaf = -1, row0 = 0, numel = 0;
  uint32_t lk0 = 0, lk1 = 0;
  // the plane and the row within it, stepped (no division in the loop)
  long long c = first / rows, row = first - c * rows;
  for (long long r = first; r < last; ++r, ++row) {
    if (row == rows) {
      row = 0;
      ++c;
    }
    const long long l = row_leaf[row];
    if (l != leaf) {  // block-uniform: every thread takes it together
      leaf = l;
      row0 = table[3 * l];
      numel = table[3 * l + 1];
      lk0 = 0u;
      lk1 = static_cast<uint32_t>(table[3 * l + 2]);
      threefry2x32(k0, k1, lk0, lk1);
    }
    const long long within = (row - row0) * kLanes + lane;
    const unsigned long long local =
        static_cast<unsigned long long>(c * numel + within);
    Vec<T, kPerThread> v;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      uint32_t b1 = static_cast<uint32_t>((local + j) >> 32);
      uint32_t b2 = static_cast<uint32_t>(local + j);
      threefry2x32(lk0, lk1, b1, b2);
      v.v[j] = within + j < numel ? to_uniform(b1, b2, T(0)) : T(0);
    }
    repro::store<T, kPerThread>(out, r * kLanes + lane, v);
  }
}

template <typename T>
int launch_threefry(T* out, const long long* table, const long long* row_leaf,
                    uint32_t k0, uint32_t k1, long long rows, long long planes,
                    void* stream) {
  const long long total = rows * planes;
  if (total <= 0) return 0;
  // 32 blocks an SM, each a run of equal length: a short tail, and a run
  // seldom crosses into another leaf (one key hash a crossing).
  long long blocks = 32LL * repro::sm_count();
  if (blocks > total) blocks = total;
  const long long run = (total + blocks - 1) / blocks;
  blocks = (total + run - 1) / run;
  threefry_uniform_rows_kernel<T>
      <<<static_cast<int>(blocks), repro::kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(out, table, row_leaf, k0, k1,
                                               rows, total, run);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point launches on `stream` (PyTorch's current stream), does
// not synchronise, and returns cudaGetLastError() of the launch. out is
// [planes, rows, 1024], contiguous and 16-byte aligned; table [leaves, 3]
// and row_leaf [rows] are int64 on the same card.
extern "C" {

int threefry_uniform_rows_f32(float* out, const long long* table,
                              const long long* row_leaf, unsigned k0,
                              unsigned k1, long long rows, long long planes,
                              void* stream) {
  return launch_threefry<float>(out, table, row_leaf, k0, k1, rows, planes,
                                stream);
}

int threefry_uniform_rows_f64(double* out, const long long* table,
                              const long long* row_leaf, unsigned k0,
                              unsigned k1, long long rows, long long planes,
                              void* stream) {
  return launch_threefry<double>(out, table, row_leaf, k0, k1, rows, planes,
                                 stream);
}

}  // extern "C"
