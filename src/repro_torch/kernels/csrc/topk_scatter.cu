// Fused top-k select + server sum + error-feedback residual for Hopper
// (sm_90a), the compressed uplink's server reduction. From x (m, n) and the
// per-agent magnitude thresholds t (m,), fp32:
//     sent[i, j]     = |x[i, j]| >= t[i] ? x[i, j] : 0      (ties kept)
//     ssum[j]        = sum_i sent[i, j]                      (fp32)
//     residual[i, j] = x[i, j] - sent[i, j]
// ssum in x's dtype (n,), residual in x's dtype (m, n).
//
// Replaces the Pallas TPU kernel topk_scatter_pallas
// (src/repro/kernels/topk_scatter.py:37, body _topk_scatter_kernel at :26).
// The thresholds come from outside (topk_threshold, a torch.topk over |x|),
// just as lax.top_k runs outside the Pallas kernel.
//
// Numerics. x is read as fp32; the selection is an exact compare; the
// residual is one __fsub_rn (x - x = 0 or x - 0 = x, exact), so it is
// bitwise equal to the plain version's torch.where / subtraction. The sum
// over agents is fp32 in a fixed order (below), not torch's, so it matches
// the plain sum to rounding: within m * 2^-24 * sum_i |sent[i, j]|.
//
// Bound. One read of x and one write of the residual, plus the row: at
// (1024, 9347) fp32 that is 76.6 MB = 22.9 us at 3.35 TB/s; a few FLOP per
// element. Bandwidth-bound.
//
// Design. One pass, no atomics: row_mean's layout (csrc/flat_update.cu). A
// block owns 32 columns and 8 row groups; warp r walks rows r, r + 8, ...
// of its 32 columns (one coalesced 128-byte read and one residual write per
// row in fp32), keeps its partial sum in a register, and the 8 partial sums
// are added in order 0..7 in shared memory. A one-thread-per-column loop
// over all m rows would be a dependent chain of m loads per thread (the
// latency-bound shape PERF.md found for row_mean at m = 1024); eight
// independent chains per column keep eight times as many loads in flight.
//
// Runs. A sweep stacks S independent runs as an (S, m, n) x with (S, m)
// thresholds; blockIdx.y is the run, whose slice is reduced exactly as a
// launch on that slice alone would reduce it (the same blocks, the same
// order), into ssum[run] (n,) and residual[run] (m, n). One launch for all.

#include "flat_common.cuh"

namespace {

using namespace repro_flat;

constexpr int kCols = 32;
constexpr int kGroups = kThreads / kCols;  // 8

template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_scatter_kernel(const T* __restrict__ x, const float* __restrict__ t,
                    T* __restrict__ ssum, T* __restrict__ residual, int64_t m,
                    int64_t n) {
  __shared__ float part[kGroups][kCols];
  x += (int64_t)blockIdx.y * m * n;
  residual += (int64_t)blockIdx.y * m * n;
  t += (int64_t)blockIdx.y * m;
  ssum += (int64_t)blockIdx.y * n;
  const int lane = threadIdx.x % kCols;
  const int group = threadIdx.x / kCols;
  const int64_t col = (int64_t)blockIdx.x * kCols + lane;
  float s = -0.0f;
  if (col < n) {
#pragma unroll 4
    for (int64_t row = group; row < m; row += kGroups) {
      const int64_t i = row * n + col;
      const float v = load_f32(x + i);
      const float sent = fabsf(v) >= t[row] ? v : 0.0f;
      s = __fadd_rn(s, sent);
      store_f32(residual + i, __fsub_rn(v, sent));
    }
  }
  part[group][lane] = s;
  __syncthreads();
  if (group == 0 && col < n) {
    float total = part[0][lane];
    for (int r = 1; r < kGroups; ++r) total = __fadd_rn(total, part[r][lane]);
    store_f32(ssum + col, total);
  }
}

template <typename T>
int launch(const void* x, const float* t, void* ssum, void* residual,
           int64_t runs, int64_t m, int64_t n, cudaStream_t stream) {
  const int64_t blocks = (n + kCols - 1) / kCols;
  if (blocks > 0x7fffffff || runs > 65535) return (int)cudaErrorInvalidValue;
  topk_scatter_kernel<T>
      <<<dim3((unsigned)blocks, (unsigned)runs), kThreads, 0, stream>>>(
      static_cast<const T*>(x), t, static_cast<T*>(ssum),
      static_cast<T*>(residual), m, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Top-k select by per-row threshold t (runs, m) fp32 on a row-major
// (runs, m, n) x: ssum (runs, n) and residual (runs, m, n) in x's dtype
// (0 float32, 1 bfloat16, 2 float16). residual may not overlap x. Returns 0
// or a cudaError_t.
extern "C" int repro_topk_scatter(const void* x, const float* t, void* ssum,
                                  void* residual, int64_t runs, int64_t m,
                                  int64_t n, int dtype, void* stream) {
  if (runs <= 0 || m <= 0 || n <= 0 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, t, ssum, residual, runs, m, n, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, t, ssum, residual, runs, m, n, s);
  return launch<__half>(x, t, ssum, residual, runs, m, n, s);
}
