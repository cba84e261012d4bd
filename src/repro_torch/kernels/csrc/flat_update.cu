// The flat-carry kernels of the federated loop for Hopper (sm_90a): the
// server average over agents and the fused local optimizer steps, each over
// a whole (m, n) buffer (m agents by n parameters) in one launch.
//
// Replace the Pallas TPU kernels of src/repro/kernels/flat_update.py:
//   * row_mean_kernel        <- row_mean_pallas        (:41, body :34)
//   * momentum_update_kernel <- momentum_update_pallas (:79, body :67)
//   * adam_update_kernel     <- adam_update_pallas     (:158, body :140)
// The JAX dispatch vmaps the two optimizer kernels over agents
// (dispatch.py:659-666, :695-703); here a row index takes that place, with
// the within-period weight w read per row.
//
// Numerics, as the JAX dispatch contract (dispatch.py:32-35): buffers are
// read as fp32 (fp32, bf16 or fp16 parameters and gradients; fp32 moments),
// all math is fp32, and only the parameter store rounds to its dtype. The
// arithmetic follows the jnp paths of repro.kernels.dispatch operation for
// operation (flat_opt_update, :645-690), spelled with the IEEE intrinsics so
// nothing contracts into an FMA; division and square root are the IEEE ones
// (no --use_fast_math). 1 - b1 and 1 - b2 arrive computed on the host, as
// the jnp path computes them from Python floats.
//
// Bounds (fp32 buffers): row_mean moves 4 B per element plus 4 B per column;
// momentum 20 B per element (read p, g, mu; write p, mu); Adam 28 B (read p,
// g, mu, nu; write p, mu, nu). All do a few FLOP per element: device-memory
// bandwidth bounds every one.
//
// Design. The optimizer steps are plain grid-stride passes, blockIdx.y the
// row (see flat_common.cuh); p_out / mu_out / nu_out may be the inputs (the
// in-place update of the training loop), since each element is read and then
// written by one thread.
//
// row_mean (redesigned for this card) is bound by device-memory bytes and,
// at the training path's m, by the latency of its few round trips. Above
// kMeanFewRows rows, row_mean_kernel: each block owns a tile of W columns
// (a multiple of the 16-byte vector's V elements) over all m rows, W sized
// so that the tiles come to about one a SM (n = 9,347: 130 tiles of 72
// columns), so no sum crosses blocks: no atomics, no second pass, no
// scratch, no cluster (rows split over a thread-block cluster and summed
// through distributed shared memory ran slower on the H100 at every m up
// to 1,024: its launch and sync cost more than the extra blocks gave). A
// row segment is W / V aligned 16-byte vectors plus one for the phase: n
// may be odd and g may start at any element, so row r starts at phase
// ph_r = (g's element offset + r * n) mod V inside a vector; the row
// groups are a multiple of 8, so all rows of one group
// share a phase, and each slot sums fixed columns in V fp32 accumulators
// (a vector at a tile's or a row's edge reads neighbouring elements of the
// same 16 bytes, which it drops). Each lane keeps 4 loads in flight (the
// last batch up to 7, padded with +0, which adds nothing); a block has up
// to 1,024 threads (48 row groups of 19 slots at n = 9,347) and only as
// many row groups as leave each lane one batch when m is small. The row
// groups' sums are added in a fixed order (chunks of 8 groups, then the
// chunks), and the total is divided by m once, at the end. Up to
// kMeanFewRows rows the work is one round trip and row_mean_kernel_rows,
// 4-byte loads on 32-column blocks (293 at n = 9,347), was the fastest.
// Both are deterministic: the same shape gives the same bits on every call.
// Neither is torch's or XLA's order of summation, so they match those to
// rounding, not bitwise.

#include <type_traits>

#include "flat_common.cuh"

namespace {

using namespace repro_flat;

constexpr int kMeanThreads = 1024;          // threads of a row_mean block
constexpr int kMeanAhead = 4;               // rows a lane has in flight
constexpr int kMeanMaxSlots = 64;           // vector slots of a row segment
constexpr int kMeanFewRows = 64;            // rows up to which ..._rows runs
constexpr int kMeanCols = 32;               // columns of a ..._rows block
constexpr int kMeanGroups = kThreads / kMeanCols;  // its row groups: 8

// acc[e] += the V elements of a 16-byte vector of T, in fp32.
template <typename T>
__device__ __forceinline__ void add16(float* acc, const uint4& q) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (sizeof(T) == 4) {
      acc[k] = __fadd_rn(acc[k], __uint_as_float(w[k]));
    } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      acc[2 * k] = __fadd_rn(acc[2 * k], __uint_as_float(w[k] << 16));
      acc[2 * k + 1] =
          __fadd_rn(acc[2 * k + 1], __uint_as_float(w[k] & 0xffff0000u));
    } else {
      acc[2 * k] = __fadd_rn(
          acc[2 * k], __half2float(__ushort_as_half((unsigned short)w[k])));
      acc[2 * k + 1] = __fadd_rn(
          acc[2 * k + 1],
          __half2float(__ushort_as_half((unsigned short)(w[k] >> 16))));
    }
  }
}

// One block per tile of W columns (a multiple of V) over all m rows.
// Thread t is vector slot t % slots (slots = W / V + 1, the last one for
// the phase) of row group t / slots; the block has `groups` row groups (a
// multiple of 8; threads past them idle), and row group q reads rows q,
// q + groups, q + 2 groups, ... Shared memory: part[groups][W].
template <typename T>
__global__ void __launch_bounds__(kMeanThreads)
row_mean_kernel(const T* __restrict__ g, T* __restrict__ out, int64_t m,
                int64_t n, int W, int slots, int groups) {
  constexpr int kV = 16 / sizeof(T);          // elements per vector
  extern __shared__ float part[];
  const int t = threadIdx.x;
  const int li = t % slots, rg = t / slots;
  const int64_t c0 = (int64_t)blockIdx.x * W;
  const int64_t c1 = c0 + W < n ? c0 + W : n;

  if (rg < groups) {
    // the phase of this group's rows (groups * n is a multiple of V, so
    // they share it), and the aligned vector of this slot
    const int64_t off = (int64_t)((reinterpret_cast<uintptr_t>(g) % 16) /
                                  sizeof(T));
    const int ph = (int)((off + (int64_t)(rg % kV) * (n % kV)) % kV);
    const int64_t a = c0 - ph + (int64_t)li * kV;    // its first column
    if (a < c1 && a + kV > c0) {
      float acc[kV];
#pragma unroll
      for (int e = 0; e < kV; ++e) acc[e] = 0.0f;
      // kMeanAhead rows at a time while more than 2 kMeanAhead - 1 are
      // left, then the rest (up to 2 kMeanAhead - 1 rows) as one batch
      // padded with rows of +0, which add nothing (acc starts at +0, so it
      // is never -0): no round trip for a short tail of its own
      const T* p = g + (int64_t)rg * n + a;          // 16-byte aligned
      const int64_t step = (int64_t)groups * n;
      int64_t r = rg;
      for (; r + (int64_t)(2 * kMeanAhead - 1) * groups < m;
           r += kMeanAhead * groups, p += kMeanAhead * step) {
        uint4 q[kMeanAhead];
#pragma unroll
        for (int u = 0; u < kMeanAhead; ++u)
          q[u] = __ldg(reinterpret_cast<const uint4*>(p + u * step));
#pragma unroll
        for (int u = 0; u < kMeanAhead; ++u) add16<T>(acc, q[u]);
      }
      if (r < m) {
        uint4 q[2 * kMeanAhead];
#pragma unroll
        for (int u = 0; u < 2 * kMeanAhead; ++u)
          q[u] = r + u * groups < m
                     ? __ldg(reinterpret_cast<const uint4*>(p + u * step))
                     : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int u = 0; u < 2 * kMeanAhead; ++u) add16<T>(acc, q[u]);
      }
#pragma unroll
      for (int e = 0; e < kV; ++e)
        if (a + e >= c0 && a + e < c1) part[rg * W + (a + e - c0)] = acc[e];
    }
  }
  __syncthreads();

  // each column's sum over the row groups that have rows (the others hold
  // +0 and are left out), in a fixed order: thread (k, j) adds groups
  // 8 k .. 8 k + 7 of column j into part[8 k][j], then the chunks in order
  const int used = m < groups ? (int)m : groups;
  const int chunks = (used + 7) / 8;
  if (t < chunks * W) {                 // chunks * W <= blockDim.x
    const int k = t / W, j = t % W;
    float s = part[8 * k * W + j];
#pragma unroll
    for (int q = 1; q < 8; ++q)
      if (8 * k + q < used) s = __fadd_rn(s, part[(8 * k + q) * W + j]);
    part[8 * k * W + j] = s;
  }
  __syncthreads();
  const int64_t col = c0 + t;
  if (t < W && col < c1) {
    float s = part[t];
    for (int k = 1; k < chunks; ++k) s = __fadd_rn(s, part[8 * k * W + t]);
    store_f32(out + col, __fdiv_rn(s, (float)m));
  }
}

// Few rows: one block per 32 columns, warp r sums rows r, r + 8, ... of its
// columns (4-byte loads), the 8 sums added in order 0..7.
template <typename T>
__global__ void __launch_bounds__(kThreads)
row_mean_kernel_rows(const T* __restrict__ g, T* __restrict__ out,
                     int64_t m, int64_t n) {
  __shared__ float part[kMeanGroups][kMeanCols];
  const int lane = threadIdx.x % kMeanCols;
  const int group = threadIdx.x / kMeanCols;
  const int64_t col = (int64_t)blockIdx.x * kMeanCols + lane;
  float s = 0.0f;
  if (col < n) {
#pragma unroll 4
    for (int64_t row = group; row < m; row += kMeanGroups)
      s = __fadd_rn(s, load_f32(g + row * n + col));
  }
  part[group][lane] = s;
  __syncthreads();
  if (group == 0 && col < n) {
    float t = part[0][lane];
    for (int r = 1; r < kMeanGroups; ++r) t = __fadd_rn(t, part[r][lane]);
    store_f32(out + col, __fdiv_rn(t, (float)m));
  }
}

template <typename T, bool kNesterov>
__global__ void __launch_bounds__(kThreads)
momentum_update_kernel(const T* p, const T* __restrict__ g, const float* mu,
                       T* p_out, float* mu_out, const float* __restrict__ w,
                       int64_t w_stride, float w_value, float lr, float beta,
                       int64_t m, int64_t n) {
  for (int64_t row = blockIdx.y; row < m; row += gridDim.y) {
    const float wr = row_coef(w, w_stride, w_value, row);
    const int64_t base = row * n;
    for (int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; col < n;
         col += (int64_t)gridDim.x * blockDim.x) {
      const int64_t i = base + col;
      const float wg = __fmul_rn(wr, load_f32(g + i));
      const float mu_new = __fadd_rn(__fmul_rn(beta, mu[i]), wg);
      const float upd =
          kNesterov ? __fadd_rn(__fmul_rn(beta, mu_new), wg) : mu_new;
      const float p_new = __fsub_rn(load_f32(p + i), __fmul_rn(lr, upd));
      mu_out[i] = mu_new;
      store_f32(p_out + i, p_new);
    }
  }
}

struct AdamScalars {
  float w_value, lr, b1, one_minus_b1, b2, one_minus_b2, eps, wd, bc1, bc2;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
adam_update_kernel(const T* p, const T* __restrict__ g, const float* mu,
                   const float* nu, T* p_out, float* mu_out, float* nu_out,
                   const float* __restrict__ w, int64_t w_stride, AdamScalars s,
                   int64_t m, int64_t n) {
  for (int64_t row = blockIdx.y; row < m; row += gridDim.y) {
    const float wr = row_coef(w, w_stride, s.w_value, row);
    const int64_t base = row * n;
    for (int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; col < n;
         col += (int64_t)gridDim.x * blockDim.x) {
      const int64_t i = base + col;
      const float wg = __fmul_rn(wr, load_f32(g + i));
      const float mu_new =
          __fadd_rn(__fmul_rn(s.b1, mu[i]), __fmul_rn(s.one_minus_b1, wg));
      const float nu_new = __fadd_rn(
          __fmul_rn(s.b2, nu[i]), __fmul_rn(s.one_minus_b2, __fmul_rn(wg, wg)));
      const float p32 = load_f32(p + i);
      float step = __fdiv_rn(
          __fdiv_rn(mu_new, s.bc1),
          __fadd_rn(__fsqrt_rn(__fdiv_rn(nu_new, s.bc2)), s.eps));
      step = __fadd_rn(step, __fmul_rn(s.wd, p32));
      mu_out[i] = mu_new;
      nu_out[i] = nu_new;
      store_f32(p_out + i, __fsub_rn(p32, __fmul_rn(s.lr, step)));
    }
  }
}

// Up to kMeanFewRows rows: row_mean_kernel_rows (latency-bound; its 293
// blocks of 32 columns were the fastest there). Above: row_mean_kernel, on
// tiles of W columns so that the tiles come to about one a SM (at most
// kMeanMaxSlots - 1 vectors, at least one), with as many row groups (a
// multiple of 8, so that each group's rows share a phase) as leave each
// lane one batch of rows, up to what kMeanThreads threads hold.
template <typename T>
int launch_row_mean(const void* g, void* out, int64_t m, int64_t n,
                    cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  if (m <= kMeanFewRows) {
    const int64_t blocks = (n + kMeanCols - 1) / kMeanCols;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    row_mean_kernel_rows<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(g), static_cast<T*>(out), m, n);
    return (int)cudaGetLastError();
  }
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) device = -1;
  const int sms_asked = sm_count(device);
  const int64_t sms = sms_asked > 0 ? sms_asked : 132;
  int64_t vecs = (n + sms * kV - 1) / (sms * kV);
  if (vecs > kMeanMaxSlots - 1) vecs = kMeanMaxSlots - 1;
  const int W = (int)vecs * kV, slots = (int)vecs + 1;
  const int64_t need = (m + kMeanAhead - 1) / kMeanAhead;   // one batch each
  int groups = kMeanThreads / slots / 8 * 8;
  if (need < groups) groups = (int)((need + 7) / 8 * 8);
  const int threads = (groups * slots + 31) / 32 * 32;
  const int64_t tiles = (n + W - 1) / W;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)groups * W * sizeof(float);
  row_mean_kernel<T><<<(unsigned)tiles, threads, smem, stream>>>(
      static_cast<const T*>(g), static_cast<T*>(out), m, n, W, slots, groups);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_momentum(const void* p, const void* g, const float* mu, void* p_out,
                    float* mu_out, const float* w, int64_t w_stride,
                    float w_value, float lr, float beta, int nesterov,
                    int64_t m, int64_t n, int device, cudaStream_t stream) {
  auto kernel = nesterov ? momentum_update_kernel<T, true>
                         : momentum_update_kernel<T, false>;
  kernel<<<rows_grid(m, n, device), kThreads, 0, stream>>>(
      static_cast<const T*>(p), static_cast<const T*>(g), mu,
      static_cast<T*>(p_out), mu_out, w, w_stride, w_value, lr, beta, m, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_adam(const void* p, const void* g, const float* mu, const float* nu,
                void* p_out, float* mu_out, float* nu_out, const float* w,
                int64_t w_stride, const AdamScalars& s, int64_t m, int64_t n,
                int device, cudaStream_t stream) {
  adam_update_kernel<T><<<rows_grid(m, n, device), kThreads, 0, stream>>>(
      static_cast<const T*>(p), static_cast<const T*>(g), mu, nu,
      static_cast<T*>(p_out), mu_out, nu_out, w, w_stride, s, m, n);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 float16; device (momentum, Adam): the
// buffers' CUDA device ordinal. Each returns 0 or a cudaError_t. An (n,)
// buffer is m = 1. The per-row weight is w[row * w_stride] when w is given,
// else w_value.

// out[j] = (sum_i g[i, j]) / m, summed in fp32.
extern "C" int repro_row_mean(const void* g, void* out, int64_t m, int64_t n,
                              int dtype, void* stream) {
  if (m <= 0 || n <= 0 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_row_mean<float>(g, out, m, n, s);
  if (dtype == 1) return launch_row_mean<__nv_bfloat16>(g, out, m, n, s);
  return launch_row_mean<__half>(g, out, m, n, s);
}

// mu <- beta * mu + w * g; p <- p - lr * (nesterov ? beta * mu + w * g : mu).
extern "C" int repro_momentum_update(const void* p, const void* g,
                                     const float* mu, void* p_out,
                                     float* mu_out, const float* w,
                                     int64_t w_stride, float w_value, float lr,
                                     float beta, int nesterov, int64_t m,
                                     int64_t n, int dtype, int device,
                                     void* stream) {
  if (m <= 0 || n <= 0 || dtype < 0 || dtype > 2 || w_stride < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_MOMENTUM(T)                                                    \
  return launch_momentum<T>(p, g, mu, p_out, mu_out, w, w_stride, w_value,   \
                            lr, beta, nesterov, m, n, device, s)
  if (dtype == 0) REPRO_MOMENTUM(float);
  if (dtype == 1) REPRO_MOMENTUM(__nv_bfloat16);
  REPRO_MOMENTUM(__half);
#undef REPRO_MOMENTUM
}

// wg = w * g; mu <- b1 * mu + (1 - b1) * wg; nu <- b2 * nu + (1 - b2) * wg^2;
// p <- p - lr * ((mu / bc1) / (sqrt(nu / bc2) + eps) + wd * p).
extern "C" int repro_adam_update(const void* p, const void* g, const float* mu,
                                 const float* nu, void* p_out, float* mu_out,
                                 float* nu_out, const float* w,
                                 int64_t w_stride, float w_value, float lr,
                                 float b1, float one_minus_b1, float b2,
                                 float one_minus_b2, float eps, float wd,
                                 float bc1, float bc2, int64_t m, int64_t n,
                                 int dtype, int device, void* stream) {
  if (m <= 0 || n <= 0 || dtype < 0 || dtype > 2 || w_stride < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AdamScalars s{w_value, lr, b1, one_minus_b1, b2, one_minus_b2,
                      eps, wd, bc1, bc2};
#define REPRO_ADAM(T)                                                         \
  return launch_adam<T>(p, g, mu, nu, p_out, mu_out, nu_out, w, w_stride, s, \
                        m, n, device, st)
  if (dtype == 0) REPRO_ADAM(float);
  if (dtype == 1) REPRO_ADAM(__nv_bfloat16);
  REPRO_ADAM(__half);
#undef REPRO_ADAM
}
