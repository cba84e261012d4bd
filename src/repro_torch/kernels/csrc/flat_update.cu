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
// written by one thread. row_mean gives each block 32 columns and 8 row
// groups: warp r sums rows r, r + 8, r + 16, ... of its 32 columns in fp32
// (one coalesced 128-byte read per row), the 8 partial sums are added in
// order 0..7 in shared memory, and the total is divided by m once, at the
// end. The order is fixed, so the result is deterministic; it is not the
// order of torch's or XLA's sum, so it matches them to rounding, not bitwise.

#include "flat_common.cuh"

namespace {

using namespace repro_flat;

constexpr int kMeanCols = 32;
constexpr int kMeanGroups = kThreads / kMeanCols;  // 8

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_mean_kernel(const T* __restrict__ g, T* __restrict__ out, int64_t m,
                int64_t n) {
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

template <typename T>
int launch_row_mean(const void* g, void* out, int64_t m, int64_t n,
                    cudaStream_t stream) {
  const int64_t blocks = (n + kMeanCols - 1) / kMeanCols;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  row_mean_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<T*>(out), m, n);
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
